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
// What bounds it on the H100: operations at every C. A chain is
// 2 x T x C^2 x (sum of its six kernel sizes) FLOP; the 48 kHz model's K1 call
// at C = 128 on a 13.5 s clip is 808 GFLOP against 200 MB in and out, and at
// C = 32 202 GFLOP against the same 200 MB (each stage's plane holds T x C =
// 25 M floats whatever C is). Both convolutions run on the tensor cores, so
// the bound is the card's 989 TFLOP/s dense bf16 rate. What kept the earlier
// design far from it was structure: one launch per dilation step moved each
// K1 stage's float32 plane 9 times in and out (about 2 GB a call, more time at
// 3.35 TB/s than the whole call's operations bound), and mma.sync on 64- to
// 512-row tiles streamed each step's weights from L2 for too few rows.
//
// Design (rvc_resblock_chains, chains_kernel): the TPU kernel's one pass.
// A block of three warpgroups owns a time tile of one batch row. Warpgroup 0
// streams the weights: one thread issues bulk copies (the TMA unit's
// cp.async.bulk) of 64-column weight chunks, in the order the convs use them,
// into a ring of shared-memory stages guarded by mbarriers (full: bytes
// landed; empty: both consumer warpgroups done). The chunks arrive as the
// wrapper lays them out once per weight version: per conv the (Cout, K * Cin)
// bf16 matrix, row n holding every tap's inputs of output channel n, cut into
// 64-column chunks of Cout rows x 128 bytes with the 128-byte swizzle that
// wgmma's shared-memory B operand reads. Warpgroups 1 and 2 compute: each conv
// is a GEMM over (tap, input channel),
//   out[r, n] = sum_{tau, ci} plane[r + tau * dil, ci] * W[n, tau * C + ci],
// by wgmma.m64nCk16 (bf16 x bf16 -> f32 in registers) with A from registers:
// each warp's 16 rows of a 64-row tile are an ldmatrix.x4 at the tap's row
// shift from a bf16 activation plane whose rows are padded by 16 bytes, so
// that any row shift reads without bank conflicts (a swizzled A tile would
// need 64-row-aligned shifts); B is the chunk in the ring. A warpgroup holds
// up to MT tiles of 64 rows (MT = 1, 2, 3, 5 at C = 256, 128, 64, 32: 128 floats
// of accumulators a thread). A conv of nt tiles gives each warpgroup
// ceil(nt / 2) tiles (for an odd nt one repeats the last tile's rows: the
// guards that would skip it are not uniform to ptxas and serialise wgmma);
// the last tile is shifted back to end on the conv's last row, and a tile
// writes only the rows no earlier tile wrote. Each chunk's four k16 steps on one tile (or one
// 64-channel part of it at C >= 128) sum into fresh registers that are added
// to the float32 accumulators while the next group runs: one long wgmma chain
// truncates past the float64 bar that these sums hold.
//   One-pass mode (K1, and K2 at C <= 128): the block owns `tile` output rows
// and reads `tile + 2 halo` rows of x once, halo the largest receptive field
// over the launch's chains (60 rows a side for k = 11, d = 1, 3, 5). The
// float32 residual `cur` of the window stays in shared memory; each chain
// reloads it from x (L2 serves the repeats) and runs its steps there, each
// conv on the rows still valid (the window shrinks by each conv's reach):
// A = bf16(lrelu(cur)), written with cur by the previous conv2's epilogue;
// Bf = bf16(lrelu(conv1 + b1)) over A; both zero outside [0, T). After a
// chain, y = alpha * cur (+ beta * y for the launch's first chain, + y for
// the others) on the tile's rows: the stage mean. Tiles: 512, 256, 128 rows
// at C = 32, 64, 128 (227 KB of shared memory at C = 128, with a ring of two
// 16 KB chunks); one block an SM. What bounds it then: at C = 128 the
// tensor cores (the shrinking windows compute ~1.5x the tile's rows), at
// C = 32 and 64 as much the epilogues as the wgmma, with 8 consumer warps an
// SM to hide their latency.
//   Step mode (C = 256: a 128-row tile's window cannot hold its float32
// residual beside its planes and ring): one launch per dilation
// step on 128 x MT - (k - 1) output rows a block, so that conv1's rows fill
// its 64-row tiles exactly; y = alpha * (x + conv2 + b2) + beta * y. Each
// weight byte from L2 serves 128 conv rows (the per-step kernel: 64). The grid
// is 156-166 blocks for 132 SMs at the main path's T = 19584: two waves.
// The host-side plan (tile, halo, stages, shared bytes, mode) is
// ops/kernels/resblock.py : launch_plan; this file checks it.
//
// The per-step kernel (resblock_step_kernel): the earlier design, one launch
// per dilation step on mma.sync.m16n8k16 with cp.async weight chunks, 8 warps
// on TT = 16384 / C rows, the Bf plane over the A plane; each row tile sums 2
// k16 steps in fresh registers before adding them to its float32 accumulators.
// It stays for the partial-sum launch alone.
//
// The partial-sum launch (tensor parallelism, rvc_resblock_step_partial): a rank
// of a model group of n holds C_M = C / n < C of the step's mid channels
// (conv1's outputs, conv2's inputs). The kernel, instantiated on (C, C_M), runs
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

// C: the step's input and output channels; CM < C: the rank's share of its mid
// channels (conv1's outputs, conv2's inputs)
template <int C, int CM> struct Cfg {
  static constexpr int TT = 16384 / C;          // 512, 256, 128, 64 output rows
  static constexpr int LD = C + PAD;            // A plane row stride (bf16)
  static constexpr int LDM = CM + PAD;          // Bf plane row stride (bf16)
  static constexpr int KCH = CHUNK_BYTES / 2 / C;  // weight columns a chunk
  static constexpr int WLD = KCH + PAD;         // weight row stride (bf16)
  static_assert(TT / 16 == 4 * (WARPS / (C / 32)), "conv2's row tiles split 4 per warp");
  static_assert(KCH % 32 == 0, "a chunk holds whole KG groups of k16 steps");
  static_assert(CM % 32 == 0 && CM < C, "conv1's outputs split 32 per warp");
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

// A rank's share of one dilation step (CM < C of its mid channels):
// y = conv2 (+ x + b2 where residual).
template <int C, int CM>
__global__ void __launch_bounds__(THREADS, MIN_BLOCKS) resblock_step_kernel(
    const float* __restrict__ x, float* __restrict__ y,
    const __nv_bfloat16* __restrict__ w1, const float* __restrict__ b1,
    const __nv_bfloat16* __restrict__ w2, const float* __restrict__ b2,
    int T, int K, int dil, float slope, int residual) {
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

  // conv2 on TT rows, then y = conv2 (+ x + b2 where residual)
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
          *reinterpret_cast<float2*>(yb + (size_t)t * C + n) =
              make_float2(xv.x + acc[i][j][2 * h] + bb.x, xv.y + acc[i][j][2 * h + 1] + bb.y);
        }
      }
    }
  }
}

template <int C, int CM>
int launch(const float* x, float* y, const __nv_bfloat16* w1, const float* b1,
           const __nv_bfloat16* w2, const float* b2, int B, int T, int K, int dil,
           float slope, int residual, cudaStream_t stream) {
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
      x, y, w1, b1, w2, b2, T, K, dil, slope, residual);
  return (int)cudaGetLastError();
}

}  // namespace

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
    return launch<128, 64>(x, y, v1, b1, v2, b2, B, T, K, dil, slope, r, stream);
  if (C == 128 && CM == 32)
    return launch<128, 32>(x, y, v1, b1, v2, b2, B, T, K, dil, slope, r, stream);
  if (C == 256 && CM == 128)
    return launch<256, 128>(x, y, v1, b1, v2, b2, B, T, K, dil, slope, r, stream);
  if (C == 256 && CM == 64)
    return launch<256, 64>(x, y, v1, b1, v2, b2, B, T, K, dil, slope, r, stream);
  return (int)cudaErrorInvalidValue;
}

// ---------------------------------------------------------------------------
// The one-pass kernel: wgmma on a bulk-copy weight ring (see the header).

namespace {
namespace wg {

constexpr int THREADS = 384;          // warpgroup 0 streams weights, 1 and 2 compute
constexpr int CONSUMERS = 256;
constexpr int CHUNK_K = 64;           // k columns a weight chunk (a 128-byte row)
constexpr int MAX_STAGES = 8;         // mbarrier slots reserved
constexpr int MAX_CHAINS = 4;
constexpr int MAX_STEPS = 8;
constexpr int APAD = 8;               // bf16 padding of an activation row (16 bytes)
constexpr int CPAD = 4;               // float padding of a residual row (16 bytes)
constexpr int ALIGN = 1024;           // the 128-byte swizzle repeats every 1024 bytes

template <int C> struct G {
  static constexpr int MT = C == 256 ? 1 : C == 128 ? 2 : C == 64 ? 3 : 5;  // tiles a warpgroup
  static constexpr int R = C / 2;           // accumulator floats a tile, a thread
  static constexpr int CB = CHUNK_K * C * 2;  // bytes a chunk
  static constexpr int LDA = C + APAD;
  static constexpr int LDC = C + CPAD;
  static_assert(MT * R <= 160, "accumulators of a warpgroup's tiles");
};

struct Chain {
  int K, S, dil[MAX_STEPS];
};

struct Params {
  const float* x;
  float* y;
  const unsigned char* w;    // the launch's chunks in the order the convs use them
  const float* bias;         // per chain, per step: b1 (C), b2 (C)
  int T, tile, halo, stages, n_chains, nq;
  float slope, alpha, beta;
  Chain chain[MAX_CHAINS];
};

__device__ __forceinline__ void mbar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_wait(uint32_t bar, int parity) {
  asm volatile(
      "{\n"
      ".reg .pred P1;\n"
      "LAB_WAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 P1, [%0], %1;\n"
      "@P1 bra DONE;\n"
      "bra LAB_WAIT;\n"
      "DONE:\n"
      "}\n" ::"r"(bar),
      "r"(parity)
      : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, int bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar), "r"(bytes)
               : "memory");
}

// `bytes` from global src to shared dst by the TMA unit; completes on bar
__device__ __forceinline__ void bulk_copy(uint32_t dst, const void* src, int bytes, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n" ::
          "r"(dst),
      "l"(src), "r"(bytes), "r"(bar)
      : "memory");
}

__device__ __forceinline__ void consumer_sync() {
  asm volatile("bar.sync 1, %0;\n" ::"n"(CONSUMERS) : "memory");
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_wait0() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_wait1() {
  asm volatile("wgmma.wait_group.sync.aligned 1;\n" ::: "memory");
}

// wgmma's shared-memory descriptor of a K-major B tile in the 128-byte swizzle:
// rows of 128 bytes, 8-row groups 1024 bytes apart (SBO), a k16 step 32 bytes on
// from the chunk's 1024-aligned start
__device__ __forceinline__ uint64_t b_desc(uint32_t addr) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)1 << 16) |
         ((uint64_t)(1024 >> 4) << 32) | ((uint64_t)1 << 62);
}

// d (64 x N, float32) = a (64 x 16, bf16, registers) * b (16 x N, bf16, shared
// memory) + (scale_d ? d : 0), N = 32 or 64; a is each warp's 16 rows in
// mma.m16n8k16's A layout
__device__ __forceinline__ void wgmma_rs(float (&d)[16], const uint32_t (&a)[4], uint64_t desc,
                                         int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15"
      "}, {%16, %17, %18, %19}, %20, p, 1, 1, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(scale_d));
}

__device__ __forceinline__ void wgmma_rs(float (&d)[32], const uint32_t (&a)[4], uint64_t desc,
                                         int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
      "}, {%32, %33, %34, %35}, %36, p, 1, 1, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(scale_d));
}

// The thread's share of a conv's accumulators plus the bias: for each of this
// warpgroup's tiles m = wgr + 2 i (of nt, over the output rows [lo, hi), the
// last shifted back to end at hi), the rows the tile owns, channel pair by
// channel pair: first ld(row, n) for every row (LOAD; loads in flight
// together), then st(row, n, loaded, v0, v1).
template <int C, bool LOAD, class Ld, class St>
__device__ __forceinline__ void epilogue(const float (&acc)[G<C>::MT][G<C>::R], int lo, int hi,
                                         int wgr, int warp, int lane, const float* bias, Ld ld,
                                         St st) {
  using g = G<C>;
  const int nt = (hi - lo + 63) / 64, gq = lane >> 2, t4 = lane & 3;
  int row[g::MT][2];
  bool mine[g::MT][2];
#pragma unroll
  for (int i = 0; i < g::MT; ++i) {
    const int m = wgr + 2 * i;
    const int start = min(lo + 64 * m, hi - 64), own = lo + 64 * m;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      row[i][h] = start + 16 * warp + gq + 8 * h;
      mine[i][h] = m < nt && row[i][h] >= own && row[i][h] < hi;
    }
  }
  constexpr int JB = C / 8 < 8 ? C / 8 : 8;  // bias pairs loaded together
#pragma unroll
  for (int j0 = 0; j0 < C / 8; j0 += JB) {
    float2 bb[JB];
#pragma unroll
    for (int jj = 0; jj < JB; ++jj)
      bb[jj] = __ldg(reinterpret_cast<const float2*>(bias + 8 * (j0 + jj) + 2 * t4));
#pragma unroll
    for (int jj = 0; jj < JB; ++jj) {
      const int j = j0 + jj, n = 8 * j + 2 * t4;
      const float2 b = bb[jj];
      float2 old[g::MT][2];
#pragma unroll
      for (int i = 0; i < g::MT; ++i)
#pragma unroll
        for (int h = 0; h < 2; ++h)
          old[i][h] = LOAD && mine[i][h] ? ld(row[i][h], n) : make_float2(0.f, 0.f);
#pragma unroll
      for (int i = 0; i < g::MT; ++i)
#pragma unroll
        for (int h = 0; h < 2; ++h)
          if (mine[i][h])
            st(row[i][h], n, old[i][h], acc[i][4 * j + 2 * h] + b.x, acc[i][4 * j + 2 * h + 1] + b.y);
    }
  }
}

// acc[0 .. NT) += the conv's sums on this warpgroup's NT tiles (A rows from
// arow, the tile's lane address at tap 0), consuming the conv's chunks from the
// ring (q counts the launch's chunks). The tensor cores truncate as they
// accumulate: each group of a chunk's four k16 steps (64 products) on one
// tile's (C <= 64) or one 64-channel part's (C >= 128) outputs sums into fresh
// registers, added to acc in float32 once the next group is issued (two in
// flight); that holds the sums within the float64 bar where one long wgmma
// chain misses it. The guards ptxas cannot prove uniform across a warpgroup
// serialise its wgmma, so there are none: both warpgroups run NT tiles (an
// odd count's extra one repeats the last tile's rows), and the zero columns
// that pad the last chunk multiply rows of the last tap.
template <int C, int NT>
__device__ __forceinline__ void conv_n(float (&acc)[G<C>::MT][G<C>::R],
                                       const uint32_t (&arow)[G<C>::MT], int K, int dil, int& q,
                                       int stages, uint32_t ring, uint32_t full0,
                                       uint32_t empty0, int lane) {
  using g = G<C>;
  constexpr int NP = C >= 128 ? C / 64 : 1, RP = g::R / NP;  // channel parts, their floats
  constexpr int NA = C <= 64 && NT > 1 ? 2 : 1;  // A fragment sets (two: one tile ahead)
  constexpr int PB = CHUNK_K * 2 * 64;           // bytes of 64 weight rows of a chunk
  const int nch = (K * C + CHUNK_K - 1) / CHUNK_K;
  for (int c = 0; c < nch; ++c, ++q) {
    const int st = q % stages;
    mbar_wait(full0 + 8 * st, (q / stages) & 1);
    const uint32_t wb = ring + st * g::CB;
    uint32_t koff[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int k = c * CHUNK_K + j * 16;
      koff[j] = 2 * (min(k / C, K - 1) * dil * g::LDA + k % C);
    }
    uint32_t a[NA][4][4];
    float part[2][RP];
#pragma unroll
    for (int i = 0; i < NT; ++i) {
#pragma unroll
      for (int j = 0; j < 4; ++j)
        ldsm_x4(a[i % NA][j][0], a[i % NA][j][1], a[i % NA][j][2], a[i % NA][j][3],
                arow[i] + koff[j]);
#pragma unroll
      for (int h = 0; h < NP; ++h) {
        const int gi = i * NP + h;
        wgmma_fence();
#pragma unroll
        for (int j = 0; j < 4; ++j)
          wgmma_rs(part[gi & 1], a[i % NA][j], b_desc(wb + h * PB + 32 * j), j);
        wgmma_commit();
        if (gi > 0) {
          wgmma_wait1();
          const int pg = gi - 1;
#pragma unroll
          for (int e = 0; e < RP; ++e) acc[pg / NP][(pg % NP) * RP + e] += part[pg & 1][e];
        }
      }
    }
    wgmma_wait0();
    constexpr int LAST = NT * NP - 1;
#pragma unroll
    for (int e = 0; e < RP; ++e) acc[LAST / NP][(LAST % NP) * RP + e] += part[LAST & 1][e];
    __syncwarp();
    if (lane == 0) mbar_arrive(empty0 + 8 * st);
  }
}

template <int C, int NT = G<C>::MT>
__device__ __forceinline__ void conv_tiles(int ntw, float (&acc)[G<C>::MT][G<C>::R],
                                           const uint32_t (&arow)[G<C>::MT], int K, int dil,
                                           int& q, int stages, uint32_t ring, uint32_t full0,
                                           uint32_t empty0, int lane) {
  if constexpr (NT > 1) {
    if (ntw < NT) {
      conv_tiles<C, NT - 1>(ntw, acc, arow, K, dil, q, stages, ring, full0, empty0, lane);
      return;
    }
  }
  conv_n<C, NT>(acc, arow, K, dil, q, stages, ring, full0, empty0, lane);
}

// acc = one conv's sums for this warpgroup's tiles of the output rows [lo, hi):
// output row r reads plane rows r + off + tau * dil, tau < K.
template <int C>
__device__ __forceinline__ void conv(float (&acc)[G<C>::MT][G<C>::R], uint32_t plane, int lo,
                                     int hi, int off, int dil, int K, int& q, int stages,
                                     uint32_t ring, uint32_t full0, uint32_t empty0, int wgr,
                                     int warp, int lane) {
  using g = G<C>;
  const int nt = (hi - lo + 63) / 64;
  uint32_t arow[g::MT];
#pragma unroll
  for (int i = 0; i < g::MT; ++i) {
    const int start = min(lo + 64 * (wgr + 2 * i), hi - 64);
    arow[i] = plane + 2 * ((start + 16 * warp + (lane & 15) + off) * g::LDA + (lane >> 4) * 8);
#pragma unroll
    for (int e = 0; e < g::R; ++e) acc[i][e] = 0.f;
  }
  conv_tiles<C>((nt + 1) / 2, acc, arow, K, dil, q, stages, ring, full0, empty0, lane);
}

__device__ __forceinline__ uint32_t bf16x2(float a, float b) {
  __nv_bfloat162 v = __floats2bfloat162_rn(a, b);
  return *reinterpret_cast<uint32_t*>(&v);
}

// f(row, column, x[tr + row][column .. column + 3]) for the rows [r0, r1) of
// x, zeros outside [0, T); FILL float4 loads in flight a thread.
template <int C, class F>
__device__ __forceinline__ void load_rows(const float* xb, int T, int tr, int r0, int r1, int ct,
                                          F f) {
  constexpr int Q = C / 4, FILL = 8;
  const int n = (r1 - r0) * Q;
  for (int i0 = ct; i0 < n; i0 += FILL * CONSUMERS) {
    float4 v[FILL];
#pragma unroll
    for (int u = 0; u < FILL; ++u) {
      const int i = i0 + u * CONSUMERS, t = tr + r0 + i / Q;
      v[u] = make_float4(0.f, 0.f, 0.f, 0.f);
      if (i < n && t >= 0 && t < T)
        v[u] = __ldg(reinterpret_cast<const float4*>(xb + (size_t)t * C + (i % Q) * 4));
    }
#pragma unroll
    for (int u = 0; u < FILL; ++u) {
      const int i = i0 + u * CONSUMERS;
      if (i < n) f(r0 + i / Q, (i % Q) * 4, v[u]);
    }
  }
}

template <int C, bool ONE_PASS>
__global__ void __launch_bounds__(THREADS, 1) chains_kernel(const __grid_constant__ Params p) {
  using g = G<C>;
  extern __shared__ unsigned char smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  unsigned char* sm = smem_raw + (((raw + ALIGN - 1) & ~(uint32_t)(ALIGN - 1)) - raw);
  const uint32_t ring = smem_u32(sm);
  const uint32_t full0 = ring + p.stages * g::CB, empty0 = full0 + 8 * MAX_STAGES;
  __nv_bfloat16* A = reinterpret_cast<__nv_bfloat16*>(sm + p.stages * g::CB + 16 * MAX_STAGES);
  const uint32_t Aaddr = smem_u32(A);
  const Chain& c0 = p.chain[0];
  const int rows_a = ONE_PASS ? p.tile + 2 * p.halo : 128 * g::MT + (c0.K - 1) * c0.dil[0];
  float* cur = reinterpret_cast<float*>(A + rows_a * g::LDA);  // one-pass mode only

  if (threadIdx.x == 0) {
    for (int s = 0; s < p.stages; ++s) {
      mbar_init(full0 + 8 * s, 1);
      mbar_init(empty0 + 8 * s, CONSUMERS / 32);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (threadIdx.x < 128) {  // the producer warpgroup: one thread streams every chunk
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n" ::: "memory");
    if (threadIdx.x == 0) {
      for (int q = 0; q < p.nq; ++q) {
        const int s = q % p.stages;
        if (q >= p.stages) mbar_wait(empty0 + 8 * s, ((q / p.stages) + 1) & 1);
        mbar_expect_tx(full0 + 8 * s, g::CB);
        bulk_copy(ring + s * g::CB, p.w + (size_t)q * g::CB, g::CB, full0 + 8 * s);
      }
    }
    return;
  }
  asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n" ::: "memory");

  const int ct = threadIdx.x - 128;  // 0 .. 255
  const int wgr = ct >> 7, warp = (ct >> 5) & 3, lane = ct & 31;
  const int T = p.T, t0 = blockIdx.x * p.tile;
  const float slope = p.slope;
  const float* xb = p.x + (size_t)blockIdx.y * T * C;
  float* yb = p.y + (size_t)blockIdx.y * T * C;
  int q = 0;
  float acc[g::MT][g::R];
  const auto no_load = [](int, int) { return make_float2(0.f, 0.f); };

  if (ONE_PASS) {
    const int H = p.halo, tr = t0 - H;  // tr: the time of the window's row 0
    const float* bias = p.bias;
    for (int chn = 0; chn < p.n_chains; ++chn) {
      const Chain& ch = p.chain[chn];
      const int K = ch.K, h2 = (K - 1) / 2;
      int reach = 0;
      for (int s = 0; s < ch.S; ++s) reach += h2 * ch.dil[s] + h2;
      int lo = H - reach, hi = H + p.tile + reach;
      consumer_sync();  // the last chain's epilogue is done with cur
      // cur = x on the chain's rows, A = bf16(lrelu(x)), both zero outside [0, T)
      load_rows<C>(xb, T, tr, lo, hi, ct, [&](int r, int c, float4 v) {
        *reinterpret_cast<float4*>(cur + r * g::LDC + c) = v;
        *reinterpret_cast<uint2*>(A + r * g::LDA + c) =
            make_uint2(bf16x2(lrelu(v.x, slope), lrelu(v.y, slope)),
                       bf16x2(lrelu(v.z, slope), lrelu(v.w, slope)));
      });
      for (int s = 0; s < ch.S; ++s) {
        const int d = ch.dil[s], h1 = h2 * d;
        const float* b1 = bias;
        const float* b2 = bias + C;
        bias += 2 * C;
        consumer_sync();  // A holds bf16(lrelu(cur)) on [lo, hi)
        conv<C>(acc, Aaddr, lo + h1, hi - h1, -h1, d, K, q, p.stages, ring, full0, empty0, wgr,
                warp, lane);
        lo += h1;
        hi -= h1;
        consumer_sync();  // both warpgroups are done reading A
        // Bf (over A) = bf16(lrelu(conv1 + b1)), zero outside [0, T)
        epilogue<C, false>(acc, lo, hi, wgr, warp, lane, b1, no_load,
                           [&](int r, int n, float2, float v0, float v1) {
          const int t = tr + r;
          *reinterpret_cast<uint32_t*>(A + r * g::LDA + n) =
              t >= 0 && t < T ? bf16x2(lrelu(v0, slope), lrelu(v1, slope)) : 0u;
        });
        consumer_sync();
        conv<C>(acc, Aaddr, lo + h2, hi - h2, -h2, 1, K, q, p.stages, ring, full0, empty0, wgr,
                warp, lane);
        lo += h2;
        hi -= h2;
        // cur += conv2 + b2; and, for the next step, A = bf16(lrelu(cur)) once
        // both warpgroups are done reading Bf
        const bool next = s + 1 < ch.S;
        if (next) consumer_sync();
        epilogue<C, true>(acc, lo, hi, wgr, warp, lane, b2,
                          [&](int r, int n) {
                            return *reinterpret_cast<const float2*>(cur + r * g::LDC + n);
                          },
                          [&](int r, int n, float2 u, float v0, float v1) {
          u.x += v0;
          u.y += v1;
          *reinterpret_cast<float2*>(cur + r * g::LDC + n) = u;
          if (next) {
            const int t = tr + r;
            *reinterpret_cast<uint32_t*>(A + r * g::LDA + n) =
                t >= 0 && t < T ? bf16x2(lrelu(u.x, slope), lrelu(u.y, slope)) : 0u;
          }
        });
      }
      // lo == H, hi == H + tile: y = alpha * cur (+ beta * y) on the tile's rows
      consumer_sync();
      const float alpha = p.alpha, beta = chn == 0 ? p.beta : 1.f;
      constexpr int Q = C / 4, FILL = 8;
      const int n = min(p.tile, T - t0) * Q;
      for (int i0 = ct; i0 < n; i0 += FILL * CONSUMERS) {
        float4 old[FILL];
#pragma unroll
        for (int u = 0; u < FILL; ++u) {
          const int i = i0 + u * CONSUMERS;
          old[u] = make_float4(0.f, 0.f, 0.f, 0.f);
          if (i < n && beta != 0.f)
            old[u] = *reinterpret_cast<const float4*>(yb + (size_t)(t0 + i / Q) * C + (i % Q) * 4);
        }
#pragma unroll
        for (int u = 0; u < FILL; ++u) {
          const int i = i0 + u * CONSUMERS;
          if (i < n) {
            const float4 c = *reinterpret_cast<const float4*>(cur + (H + i / Q) * g::LDC + (i % Q) * 4);
            *reinterpret_cast<float4*>(yb + (size_t)(t0 + i / Q) * C + (i % Q) * 4) =
                make_float4(alpha * c.x + beta * old[u].x, alpha * c.y + beta * old[u].y,
                            alpha * c.z + beta * old[u].z, alpha * c.w + beta * old[u].w);
          }
        }
      }
    }
  } else {
    // one dilation step: A's row 0 is time t0 - h1 - h2, Bf's t0 - h2
    const int K = c0.K, d = c0.dil[0], h2 = (K - 1) / 2, h1 = h2 * d;
    const int ta = t0 - h1 - h2, tb = t0 - h2;
    const float* b1 = p.bias;
    const float* b2 = p.bias + C;
    load_rows<C>(xb, T, ta, 0, rows_a, ct, [&](int r, int c, float4 u) {
      *reinterpret_cast<uint2*>(A + r * g::LDA + c) =
          make_uint2(bf16x2(lrelu(u.x, slope), lrelu(u.y, slope)),
                     bf16x2(lrelu(u.z, slope), lrelu(u.w, slope)));
    });
    consumer_sync();
    conv<C>(acc, Aaddr, 0, p.tile + 2 * h2, 0, d, K, q, p.stages, ring, full0, empty0, wgr, warp,
            lane);
    consumer_sync();  // both warpgroups are done reading A
    epilogue<C, false>(acc, 0, p.tile + 2 * h2, wgr, warp, lane, b1, no_load,
                       [&](int r, int n, float2, float v0, float v1) {
      const int t = tb + r;
      *reinterpret_cast<uint32_t*>(A + r * g::LDA + n) =
          t >= 0 && t < T ? bf16x2(lrelu(v0, slope), lrelu(v1, slope)) : 0u;
    });
    consumer_sync();
    conv<C>(acc, Aaddr, 0, p.tile, 0, 1, K, q, p.stages, ring, full0, empty0, wgr, warp, lane);
    // y = alpha * (x + conv2 + b2) + beta * y
    const float alpha = p.alpha, beta = p.beta;
    epilogue<C, true>(acc, 0, p.tile, wgr, warp, lane, b2,
                      [&](int r, int n) {
                        const int t = min(t0 + r, T - 1);
                        return __ldg(reinterpret_cast<const float2*>(xb + (size_t)t * C + n));
                      },
                      [&](int r, int n, float2 xv, float v0, float v1) {
      const int t = t0 + r;
      if (t < T) {
        float2* dst = reinterpret_cast<float2*>(yb + (size_t)t * C + n);
        float2 res = make_float2(alpha * (xv.x + v0), alpha * (xv.y + v1));
        if (beta != 0.f) {
          const float2 old = *dst;
          res.x += beta * old.x;
          res.y += beta * old.y;
        }
        *dst = res;
      }
    });
  }
}

// The shared bytes a launch needs: the 1024-byte alignment, the ring, the
// mbarriers, the A (and Bf) plane, and in one-pass mode the residual window.
template <int C>
size_t smem_bytes(bool one_pass, int tile, int halo, int stages, int K, int dil) {
  using g = G<C>;
  const size_t rows_a = one_pass ? tile + 2 * halo : 128 * g::MT + (K - 1) * dil;
  return ALIGN + (size_t)stages * g::CB + 16 * MAX_STAGES + rows_a * g::LDA * 2 +
         (one_pass ? rows_a * g::LDC * 4 : 0);
}

template <int C, bool ONE_PASS>
int launch_chains(const Params& p, int B, int smem, cudaStream_t stream) {
  static const cudaError_t attr = cudaFuncSetAttribute(
      chains_kernel<C, ONE_PASS>, cudaFuncAttributeMaxDynamicSharedMemorySize, MAX_SMEM);
  if (attr != cudaSuccess) return (int)attr;
  const dim3 grid((p.T + p.tile - 1) / p.tile, B);
  chains_kernel<C, ONE_PASS><<<grid, THREADS, smem, stream>>>(p);
  return (int)cudaGetLastError();
}

// Whether the plan is one the kernel takes: chunks, stages, the rows a
// warpgroup's tiles hold, the shared bytes.
template <int C>
bool plan_ok(const Params& p, bool one_pass, int smem) {
  using g = G<C>;
  if (p.stages < 2 || p.stages > MAX_STAGES || p.tile < 64 || p.T < 1) return false;
  int nq = 0;
  for (int i = 0; i < p.n_chains; ++i) {
    const Chain& ch = p.chain[i];
    if (ch.K < 1 || ch.K % 2 == 0 || ch.S < 1 || ch.S > MAX_STEPS) return false;
    const int h2 = (ch.K - 1) / 2;
    int reach = 0;
    for (int s = 0; s < ch.S; ++s) {
      if (ch.dil[s] < 1) return false;
      reach += h2 * ch.dil[s] + h2;
    }
    if (one_pass && (reach > p.halo || p.tile + 2 * reach - 2 * h2 * ch.dil[0] > 128 * g::MT))
      return false;
    nq += 2 * ch.S * ((ch.K * C + CHUNK_K - 1) / CHUNK_K);
  }
  if (!one_pass && (p.n_chains != 1 || p.chain[0].S != 1 ||
                    p.tile + 2 * ((p.chain[0].K - 1) / 2) != 128 * g::MT))
    return false;
  const Chain& c0 = p.chain[0];
  return nq == p.nq && smem <= MAX_SMEM &&
         (size_t)smem >= smem_bytes<C>(one_pass, p.tile, p.halo, p.stages, c0.K, c0.dil[0]);
}

template <int C>
int dispatch_chains(const Params& p, bool one_pass, int B, int smem, cudaStream_t stream) {
  if (!plan_ok<C>(p, one_pass, smem)) return (int)cudaErrorInvalidValue;
  // one-pass at C <= 128, one step at C = 256 (a 128-row tile's window cannot
  // hold its float32 residual)
  if (one_pass != (C != 256)) return (int)cudaErrorInvalidValue;
  return launch_chains<C, C != 256>(p, B, smem, stream);
}

}  // namespace wg
}  // namespace

// ResBlock chains in one launch (one_pass != 0: every step of n_chains chains,
// y = alpha * chain_0 + beta * y + alpha * (chain_1 + ...)) or one dilation
// step of one chain (one_pass == 0: y = alpha * (x + conv2 + b2) + beta * y).
// x, y: (B, T, C) float32, distinct, 16-byte aligned; w: the launch's nq weight
// chunks, each 64 k-columns x C output rows of bf16 in the 128-byte swizzle,
// conv1 then conv2 of each step of each chain in order; bias: b1 then b2 (C
// float32 each) of each step in the same order. ks, steps: each chain's kernel
// size and dilation count; dils: each chain's dilations, MAX_STEPS apart. tile,
// halo, stages, smem: the plan (ops/kernels/resblock.py : launch_plan). C in
// {32, 64, 128} one-pass, 256 one step. beta == 0 never reads y.
// Returns cudaGetLastError() (cudaErrorInvalidValue for a plan the kernel does
// not take).
extern "C" int rvc_resblock_chains(const float* x, float* y, const void* w, const float* bias,
                                   int B, int T, int C, int one_pass, int tile, int halo,
                                   int stages, int smem, int nq, int n_chains, const int* ks,
                                   const int* steps, const int* dils, float slope, float alpha,
                                   float beta, cudaStream_t stream) {
  using namespace wg;
  if (n_chains < 1 || n_chains > MAX_CHAINS || B < 1) return (int)cudaErrorInvalidValue;
  Params p;
  p.x = x;
  p.y = y;
  p.w = static_cast<const unsigned char*>(w);
  p.bias = bias;
  p.T = T;
  p.tile = tile;
  p.halo = halo;
  p.stages = stages;
  p.n_chains = n_chains;
  p.nq = nq;
  p.slope = slope;
  p.alpha = alpha;
  p.beta = beta;
  for (int i = 0; i < n_chains; ++i) {
    p.chain[i].K = ks[i];
    p.chain[i].S = steps[i];
    if (steps[i] < 1 || steps[i] > MAX_STEPS) return (int)cudaErrorInvalidValue;
    for (int s = 0; s < MAX_STEPS; ++s) p.chain[i].dil[s] = s < steps[i] ? dils[i * MAX_STEPS + s] : 1;
  }
  const bool op = one_pass != 0;
  switch (C) {
    case 32: return dispatch_chains<32>(p, op, B, smem, stream);
    case 64: return dispatch_chains<64>(p, op, B, smem, stream);
    case 128: return dispatch_chains<128>(p, op, B, smem, stream);
    case 256: return dispatch_chains<256>(p, op, B, smem, stream);
    default: return (int)cudaErrorInvalidValue;
  }
}
