// K1 + K2: HiFi-GAN ResBlock chains of the NSF decoder, CUDA C++ for sm_90a.
//
// Replaces rvc_tpu/ops/pallas/resblock.py : fused_resblock_group (K1, kernel
// body _kernel_group :236-281, pallas_call :389) and fused_resblock (K2,
// _kernel :94-135, pallas_call :212). Both compute, per ResBlock chain,
//   for each dilation d:
//     cur += conv_k(bf16(lrelu(conv_{k,d}(bf16(lrelu(cur)), bf16(w1)) + b1)), bf16(w2)) + b2
// with every conv input zero outside [0, T); K1 then takes the mean over the
// stage's parallel chains (k = 3, 7, 11). This is the TPU kernel's own
// arithmetic: bf16 conv operands (the LReLU'd, boundary-zeroed inputs and the
// taps), float32 sums, biases, residual and stage mean.
//
// What bounds it on the H100: operations. A chain is 2 x T x C^2 x (sum of its
// six kernel sizes) FLOP: 808 GFLOP for the 48 kHz model's C = 128 stage of a
// 13.5 s clip, against 200 MB in and out. Both convolutions run on the tensor
// cores, mma.sync.m16n8k16 bf16 x bf16 -> f32, so the bound is the card's
// 989 TFLOP/s dense bf16 rate; the per-step launches move each stage's float32
// plane 9 times in and out (about 1.8 ms at 3.35 TB/s over K1's three calls),
// which a whole chain per launch would remove.
//
// Design: one launch per dilation step, with both convolutions, both LReLUs,
// both biases, the boundary zeroing and the residual fused; the last step of a
// chain also folds in the stage mean (y = alpha * result + beta * y). A block
// of 8 warps owns a time tile of TT = 16384 / C output rows of one batch row
// and all C output channels. Each conv is a GEMM over (tap, input channel):
//   out[r, n] = sum_{tau, ci} plane[r + tau * dil, ci] * W[n, tau * C + ci]
// Shared memory holds a bf16 activation plane, rows padded by 16 bytes so
// that the 8 rows of an ldmatrix fall on distinct banks at any row shift:
//   A  = bf16(lrelu(x)), zero outside [0, T), TT + 2 (h1 + h2) rows, then
//   Bf = bf16(lrelu(conv1(A) + b1)), zero outside [0, T), TT + 2 h2 rows
// (h1 = (k-1)/2 d, h2 = (k-1)/2). A tap at row shift tau * dil is an ldmatrix
// from rows r + tau * dil. The weights, bf16 (Cout, K * Cin) per conv from the
// wrapper, stream through shared memory in 16 KB chunks of whole rows,
// double-buffered with cp.async; conv2's first chunk loads while conv1 ends.
// Two blocks share an SM (MIN_BLOCKS). Each warp holds 32 output channels (4 n8
// tiles) of up to 5 m16 row tiles as float32 accumulators, so one k16 step is
// 2 ldmatrix.x4 of B, up to 5 of A and up to 20 mma. conv1 computes TT + 2 h2
// rows rounded up to 16 (A keeps 15 slack rows so the padded tile reads inside
// the plane); conv2 exactly TT. The tensor cores truncate as they accumulate:
// each row tile sums 2 k16 steps (32 products) in fresh registers and adds
// them to its float32 accumulators, which keeps the kernel as close to exact
// sums as a float32 FMA loop (conv_mma).
// Left for later: wgmma (64-row A tiles from swizzled shared memory, which
// arbitrary row shifts break), TMA, a persistent grid, a whole chain per launch.
//
// The partial-sum launch (tensor parallelism, rvc_resblock_step_partial): a rank
// of a model group of n holds C_M = C / n of the step's mid channels (conv1's
// outputs, conv2's inputs). The same kernel, instantiated on (C, C_M), runs
// conv1 on C_M outputs (C_M / 32 warps across channels, the rest across rows),
// the Bf plane on C_M channels, and conv2 from C_M inputs to all C outputs; it
// writes the rank's partial conv2 sum, plus x + b2 on the rank that carries the
// residual. The caller all-reduces the partial sums over the model group. Same
// arithmetic: bf16 operands, float32 sums, the 16-byte-padded shared planes,
// cp.async weight chunks. It bounds as the whole step does, on 1 / n of its
// operations.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stddef.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;             // 8 warps
constexpr int WARPS = THREADS / 32;
constexpr int NJ = 4;                    // n8 tiles per warp: 32 output channels
constexpr int MI = 5;                    // m16 tiles per warp, at most
constexpr int KG = 2;                    // k16 steps summed apart before acc
constexpr int PAD = 8;                   // bf16 padding of each shared row (16 bytes)
constexpr int MAX_SMEM = 232448;         // H100: 227 KB a block
constexpr int MAX_K = 17;                // conv1 needs at most TT / 16 + 1 row tiles
// Two blocks share an SM, so one's plane loads, epilogue and barriers overlap
// the other's mma: at most 128 registers a thread and 113 KB of shared memory
// a block (the A plane, which Bf then overwrites, and two 16 KB weight chunks:
// 112 KB at C = 256, k = 11, d = 5).
constexpr int MIN_BLOCKS = 2;
constexpr int CHUNK_BYTES = 16384;

// C: the step's input and output channels; CM: its mid channels (conv1's
// outputs, conv2's inputs), C for a whole step
template <int C, int CM> struct Cfg {
  static constexpr int TT = 16384 / C;          // 512, 256, 128, 64 output rows
  static constexpr int LD = C + PAD;            // A plane row stride (bf16)
  static constexpr int LDM = CM + PAD;          // Bf plane row stride (bf16)
  static constexpr int KCH = CHUNK_BYTES / 2 / C;  // weight columns a chunk
  static constexpr int WLD = KCH + PAD;         // weight row stride (bf16)
  static_assert(TT / 16 == 4 * (WARPS / (C / 32)), "conv2's row tiles split 4 per warp");
  static_assert(KCH % 32 == 0, "a chunk holds whole KG groups of k16 steps");
  static_assert(CM % 32 == 0 && CM <= C, "conv1's outputs split 32 per warp");
};

__device__ __forceinline__ float lrelu(float v, float slope) {
  return v > 0.f ? v : v * slope;
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void ldsm_x4(uint32_t& r0, uint32_t& r1, uint32_t& r2,
                                        uint32_t& r3, uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r0), "=r"(r1), "=r"(r2), "=r"(r3)
               : "r"(addr));
}

// d += a (16x16, row) * b (16x8, col): bf16 operands, float32 accumulators
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(dst), "l"(src));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

// Weight chunk q of the step (conv1's nchunk1 chunks of CM rows of K * C
// columns, then conv2's of C rows of K * CM columns) into buffer q & 1.
template <int C, int CM>
__device__ __forceinline__ void load_chunk(int q, int nchunk1, int K,
                                           const __nv_bfloat16* __restrict__ w1,
                                           const __nv_bfloat16* __restrict__ w2,
                                           __nv_bfloat16* wbuf) {
  using G = Cfg<C, CM>;
  const bool first = q < nchunk1;
  const __nv_bfloat16* wg = first ? w1 : w2;
  const int KC = K * (first ? C : CM), rows = first ? CM : C;
  const int k0 = (first ? q : q - nchunk1) * G::KCH;
  const int pieces = min(G::KCH, KC - k0) / 8;  // 16-byte pieces a row
  __nv_bfloat16* dst = wbuf + (q & 1) * C * G::WLD;
  for (int i = threadIdx.x; i < rows * pieces; i += THREADS) {
    const int n = i / pieces, j = i - n * pieces;
    cp_async16(smem_u32(dst + n * G::WLD + j * 8), wg + (size_t)n * KC + k0 + j * 8);
  }
  cp_async_commit();
}

// acc = sum over the conv's chunks q0 .. q0 + nchunk - 1 of plane x weights, for
// this warp's row tiles mt = wm + i * WM (< Mt) and channels n0 .. n0 + 31 of
// the conv's NOUT outputs (NOUT / 32 warps across channels, WM across rows), from
// CIN input channels a tap in rows of LDP bf16. Prefetches the step's next chunk
// (of nq in all) while it computes on this one.
// The tensor cores truncate as they accumulate, so one long chain of mma
// drifts: on k = 11, C = 256 chains on an H100, 1.4x as far from the float64
// sums as cuDNN's float32 convs. Each row tile sums KG k16 steps in fresh
// registers and adds them to acc in float32, which brings it to 0.75x.
template <int C, int CM, int NOUT, int CIN, int LDP>
__device__ __forceinline__ void conv_mma(float (&acc)[MI][NJ][4],
                                         const __nv_bfloat16* plane, int Mt, int dil,
                                         int q0, int nchunk, int KC, int nchunk1, int nq,
                                         int K, const __nv_bfloat16* __restrict__ w1,
                                         const __nv_bfloat16* __restrict__ w2,
                                         __nv_bfloat16* wbuf) {
  using G = Cfg<C, CM>;
  constexpr int WN = NOUT / 32, WM = WARPS / WN;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int wm = warp / WN, n0 = (warp % WN) * 32;
  // ldmatrix row addresses: A rows lane % 16 at k + (lane / 16) * 8; B rows
  // (channels) n0 + (lane / 16) * 8 + lane % 8 at k + ((lane / 8) % 2) * 8
  const uint32_t a_lane =
      smem_u32(plane) + 2 * ((lane & 15) * LDP + (lane >> 4) * 8 + wm * 16 * LDP);
  const int b_lane = 2 * ((n0 + ((lane >> 4) << 3) + (lane & 7)) * G::WLD + ((lane >> 3) & 1) * 8);
#pragma unroll
  for (int i = 0; i < MI; ++i)
#pragma unroll
    for (int j = 0; j < NJ; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.f;

  for (int c = 0; c < nchunk; ++c) {
    const int q = q0 + c;
    cp_async_wait_all();
    __syncthreads();  // chunk q and the plane are in; buffer (q + 1) & 1 is free
    if (q + 1 < nq) load_chunk<C, CM>(q + 1, nchunk1, K, w1, w2, wbuf);
    const uint32_t wsm = smem_u32(wbuf + (q & 1) * C * G::WLD) + b_lane;
    const int k0 = c * G::KCH;
    const int nk = min(G::KCH, KC - k0) / 16;  // even, as CIN / 16 and KCH / 16 are
    for (int ks = 0; ks < nk; ks += KG) {
      uint32_t b[KG][NJ][2];
      uint32_t a_k[KG];
#pragma unroll
      for (int s = 0; s < KG; ++s) {
        const int kk = k0 + (ks + s) * 16;
#pragma unroll
        for (int jp = 0; jp < NJ / 2; ++jp)
          ldsm_x4(b[s][2 * jp][0], b[s][2 * jp][1], b[s][2 * jp + 1][0], b[s][2 * jp + 1][1],
                  wsm + 2 * (16 * jp * G::WLD + (ks + s) * 16));
        a_k[s] = a_lane + 2 * ((kk / CIN) * dil * LDP + kk % CIN);
      }
#pragma unroll
      for (int i = 0; i < MI; ++i) {
        if (wm + i * WM < Mt) {
          float part[NJ][4] = {};
#pragma unroll
          for (int s = 0; s < KG; ++s) {
            uint32_t a[4];
            ldsm_x4(a[0], a[1], a[2], a[3], a_k[s] + 2 * (i * WM * 16 * LDP));
#pragma unroll
            for (int j = 0; j < NJ; ++j) mma_bf16(part[j], a, b[s][j][0], b[s][j][1]);
          }
#pragma unroll
          for (int j = 0; j < NJ; ++j)
#pragma unroll
            for (int e = 0; e < 4; ++e) acc[i][j][e] += part[j][e];
        }
      }
    }
  }
}

// One dilation step. CM == C: y = alpha * (x + conv2 + b2) + beta * y. CM < C
// (a rank's share of the mid channels): y = conv2 (+ x + b2 where residual), with
// alpha 1 and beta 0.
template <int C, int CM>
__global__ void __launch_bounds__(THREADS, MIN_BLOCKS) resblock_step_kernel(
    const float* __restrict__ x, float* __restrict__ y,
    const __nv_bfloat16* __restrict__ w1, const float* __restrict__ b1,
    const __nv_bfloat16* __restrict__ w2, const float* __restrict__ b2,
    int T, int K, int dil, float slope, float alpha, float beta, int residual) {
  using G = Cfg<C, CM>;
  constexpr int TT = G::TT, LD = G::LD, LDM = G::LDM;
  constexpr int WN1 = CM / 32, WM1 = WARPS / WN1;  // conv1: CM outputs
  constexpr int WN2 = C / 32, WM2 = WARPS / WN2;   // conv2: C outputs
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int h1 = (K - 1) / 2 * dil, h2 = (K - 1) / 2;
  const int W1 = TT + 2 * (h1 + h2), W2 = TT + 2 * h2;
  __nv_bfloat16* wbuf = reinterpret_cast<__nv_bfloat16*>(smem_raw);  // 2 chunks
  __nv_bfloat16* A = wbuf + 2 * C * G::WLD;                          // W1 + 15 rows
  __nv_bfloat16* Bf = A;  // W2 rows of CM channels, over A once conv1 has read it
  const int KC1 = K * C, KC2 = K * CM;
  const int nchunk1 = (KC1 + G::KCH - 1) / G::KCH, nchunk2 = (KC2 + G::KCH - 1) / G::KCH;

  load_chunk<C, CM>(0, nchunk1, K, w1, w2, wbuf);

  const int t0 = blockIdx.x * TT;
  const float* xb = x + (size_t)blockIdx.y * T * C;
  float* yb = y + (size_t)blockIdx.y * T * C;
  const int ta = t0 - h1 - h2;  // time of A's row 0
  constexpr int FILL = 4;  // float4 loads in flight a thread
  const int n_fill = (W1 + 15) * (C / 4);
  for (int i0 = threadIdx.x; i0 < n_fill; i0 += FILL * THREADS) {
    float4 v[FILL];
#pragma unroll
    for (int u = 0; u < FILL; ++u) {
      const int i = i0 + u * THREADS, r = i / (C / 4), t = ta + r;
      v[u] = make_float4(0.f, 0.f, 0.f, 0.f);
      if (i < n_fill && r < W1 && t >= 0 && t < T)
        v[u] = __ldg(reinterpret_cast<const float4*>(xb + (size_t)t * C + (i % (C / 4)) * 4));
    }
#pragma unroll
    for (int u = 0; u < FILL; ++u) {
      const int i = i0 + u * THREADS;
      if (i < n_fill) {
        __nv_bfloat162* dst =
            reinterpret_cast<__nv_bfloat162*>(A + (i / (C / 4)) * LD + (i % (C / 4)) * 4);
        dst[0] = __floats2bfloat162_rn(lrelu(v[u].x, slope), lrelu(v[u].y, slope));
        dst[1] = __floats2bfloat162_rn(lrelu(v[u].z, slope), lrelu(v[u].w, slope));
      }
    }
  }

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, t4 = lane & 3;  // accumulator row g (+8), columns 2 t4 (+1)
  float acc[MI][NJ][4];

  // conv1 on W2 rows rounded up to 16; its epilogue writes Bf's W2 rows
  conv_mma<C, CM, CM, C, LD>(acc, A, (W2 + 15) / 16, dil, 0, nchunk1, KC1, nchunk1,
                             nchunk1 + nchunk2, K, w1, w2, wbuf);
  __syncthreads();  // every warp is done reading A
  {
    const int wm = warp / WN1, n0 = (warp % WN1) * 32;
    const int tb = t0 - h2;  // time of Bf's row 0
#pragma unroll
    for (int j = 0; j < NJ; ++j) {
      const int n = n0 + 8 * j + 2 * t4;
      const float2 bb = *reinterpret_cast<const float2*>(b1 + n);
#pragma unroll
      for (int i = 0; i < MI; ++i) {
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int r = (wm + i * WM1) * 16 + g + 8 * h;
          if (r < W2) {
            const bool ok = tb + r >= 0 && tb + r < T;
            const float v0 = ok ? lrelu(acc[i][j][2 * h] + bb.x, slope) : 0.f;
            const float v1 = ok ? lrelu(acc[i][j][2 * h + 1] + bb.y, slope) : 0.f;
            *reinterpret_cast<__nv_bfloat162*>(Bf + r * LDM + n) =
                __floats2bfloat162_rn(v0, v1);
          }
        }
      }
    }
  }

  // conv2 on TT rows, then y = alpha * (x + conv2 + b2) + beta * y (x and b2
  // only where residual)
  conv_mma<C, CM, C, CM, LDM>(acc, Bf, TT / 16, 1, nchunk1, nchunk2, KC2, nchunk1,
                              nchunk1 + nchunk2, K, w1, w2, wbuf);
  const int wm = warp / WN2, n0 = (warp % WN2) * 32;
#pragma unroll
  for (int j = 0; j < NJ; ++j) {
    const int n = n0 + 8 * j + 2 * t4;
    const float2 bb = residual ? *reinterpret_cast<const float2*>(b2 + n) : make_float2(0.f, 0.f);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int t = t0 + (wm + i * WM2) * 16 + g + 8 * h;
        if (t < T) {
          const float2 xv = residual
              ? __ldg(reinterpret_cast<const float2*>(xb + (size_t)t * C + n))
              : make_float2(0.f, 0.f);
          float2* dst = reinterpret_cast<float2*>(yb + (size_t)t * C + n);
          float2 res = make_float2(alpha * (xv.x + acc[i][j][2 * h] + bb.x),
                                   alpha * (xv.y + acc[i][j][2 * h + 1] + bb.y));
          if (beta != 0.f) {
            const float2 old = *dst;
            res.x += beta * old.x;
            res.y += beta * old.y;
          }
          *dst = res;
        }
      }
    }
  }
}

template <int C, int CM>
int launch(const float* x, float* y, const __nv_bfloat16* w1, const float* b1,
           const __nv_bfloat16* w2, const float* b2, int B, int T, int K, int dil,
           float slope, float alpha, float beta, int residual, cudaStream_t stream) {
  using G = Cfg<C, CM>;
  // the opt-in shared memory limit, set once for this instantiation
  static const cudaError_t attr = cudaFuncSetAttribute(
      resblock_step_kernel<C, CM>, cudaFuncAttributeMaxDynamicSharedMemorySize, MAX_SMEM);
  if (attr != cudaSuccess) return (int)attr;
  const int h1 = (K - 1) / 2 * dil, h2 = (K - 1) / 2;
  const size_t rows = (size_t)(G::TT + 2 * (h1 + h2) + 15);
  const size_t smem = 2 * ((size_t)2 * C * G::WLD + rows * G::LD);
  if (K % 2 == 0 || K > MAX_K || dil < 1 || smem > (size_t)MAX_SMEM)
    return (int)cudaErrorInvalidValue;
  const dim3 grid((T + G::TT - 1) / G::TT, B);
  resblock_step_kernel<C, CM><<<grid, THREADS, smem, stream>>>(
      x, y, w1, b1, w2, b2, T, K, dil, slope, alpha, beta, residual);
  return (int)cudaGetLastError();
}

}  // namespace

// One dilation step of a ResBlock chain: y = alpha * (x + conv2(...)) + beta * y.
// x, y: (B, T, C) float32, distinct buffers; w1, w2: (C, K, C) bf16 as (out, tap,
// in); b1, b2: (C,) float32. K odd, at most 17. C in {32, 64, 128, 256}.
// beta == 0 never reads y. Returns cudaGetLastError() (cudaErrorInvalidValue for
// a shape the kernel does not take).
extern "C" int rvc_resblock_step(const float* x, float* y, const void* w1,
                                 const float* b1, const void* w2, const float* b2,
                                 int B, int T, int C, int K, int dil, float slope,
                                 float alpha, float beta, cudaStream_t stream) {
  const auto* v1 = static_cast<const __nv_bfloat16*>(w1);
  const auto* v2 = static_cast<const __nv_bfloat16*>(w2);
  switch (C) {
    case 32: return launch<32, 32>(x, y, v1, b1, v2, b2, B, T, K, dil, slope, alpha, beta, 1, stream);
    case 64: return launch<64, 64>(x, y, v1, b1, v2, b2, B, T, K, dil, slope, alpha, beta, 1, stream);
    case 128: return launch<128, 128>(x, y, v1, b1, v2, b2, B, T, K, dil, slope, alpha, beta, 1, stream);
    case 256: return launch<256, 256>(x, y, v1, b1, v2, b2, B, T, K, dil, slope, alpha, beta, 1, stream);
    default: return (int)cudaErrorInvalidValue;
  }
}

// The partial-sum launch of one dilation step on a tensor-parallel rank that holds
// CM of the step's C mid channels: y = conv2(lrelu(conv1(lrelu(x)) + b1)) over
// them, plus x + b2 where residual != 0 (one rank of the model group). x, y:
// (B, T, C) float32, distinct buffers; w1: (CM, K, C) and w2: (C, K, CM) bf16 as
// (out, tap, in); b1: (CM,), b2: (C,) float32. (C, CM) in {(128, 64), (128, 32),
// (256, 128), (256, 64)}; K odd, at most 17. Returns cudaGetLastError()
// (cudaErrorInvalidValue for a shape the kernel does not take).
extern "C" int rvc_resblock_step_partial(const float* x, float* y, const void* w1,
                                         const float* b1, const void* w2, const float* b2,
                                         int B, int T, int C, int CM, int K, int dil,
                                         float slope, int residual, cudaStream_t stream) {
  const auto* v1 = static_cast<const __nv_bfloat16*>(w1);
  const auto* v2 = static_cast<const __nv_bfloat16*>(w2);
  const int r = residual != 0;
  if (C == 128 && CM == 64)
    return launch<128, 64>(x, y, v1, b1, v2, b2, B, T, K, dil, slope, 1.f, 0.f, r, stream);
  if (C == 128 && CM == 32)
    return launch<128, 32>(x, y, v1, b1, v2, b2, B, T, K, dil, slope, 1.f, 0.f, r, stream);
  if (C == 256 && CM == 128)
    return launch<256, 128>(x, y, v1, b1, v2, b2, B, T, K, dil, slope, 1.f, 0.f, r, stream);
  if (C == 256 && CM == 64)
    return launch<256, 64>(x, y, v1, b1, v2, b2, B, T, K, dil, slope, 1.f, 0.f, r, stream);
  return (int)cudaErrorInvalidValue;
}
