// K3: VITS windowed relative-position attention, CUDA C++ for sm_90a.
//
// Replaces rvc_tpu/ops/pallas/attention.py : fused_rel_attention (kernel body
// _kernel :48-83, pallas_call :120, the band logits and rel-v term :103-106,
// :144-145). Per (batch, head, query row t), with qs = q / sqrt(D):
//   s[t, u] = qs[t] . k[u] + band[t, u - t + w]   band[t, j] = qs[t] . emb_rel_k[j]
//   s[t, u] = -1e4                                  for keys u >= length
//   p = softmax_u(s) (float32)
//   out[t] = sum_u p[t, u] v[u] + sum_j bw[t, j] emb_rel_v[j],  bw[t, j] = p[t, t + j - w]
// Rows at or past the length are garbage by design, as on the TPU.
//
// What bounds it on the H100: operations. One TextEncoder layer at the main
// path's shape (2 heads, T = 1,632, D = 96, 1,550 valid keys) is 4 x H x T x
// keys x D = 1.9 GFLOP of float32 FMA against 3 MB of q, k, v and out. The
// TPU kernel takes float32 operands, so this one stays in float32 FMA (67
// TFLOP/s); the tensor cores are an open question.
//
// Design: float32 flash attention with register micro-tiles.
//  - A block of 128 threads owns 64 query rows of one head and a contiguous
//    range of key tiles (a key split: blockIdx.z). Keys stream through shared
//    memory 32 at a time in a double-buffered cp.async ring, two barriers a
//    tile: tile kt + 1 loads while tile kt computes (K padded to D + 4
//    floats a row, so the float4 reads of 8 keys fall in 8 distinct bank
//    quads). Q, scaled, stays in shared memory.
//  - Scores: thread (rg, kg) holds rows rg + 16i and keys kg + 8j (4 x 4) and
//    reads one float4 of each per 4 dims: 16 FMAs per 2 shared loads. Row max
//    and sum come from shuffles among the 8 threads of a row; P goes to shared
//    memory transposed, the rescale factor of each row beside it.
//  - O += P V: thread (pr, dg) holds rows 4pr..4pr+3 and dims 4dg + 32c
//    (4 x D/8 accumulators): per key one float4 of P and D/32 float4 of V.
//  - The band: its logits band[t, j] are computed once per block from Q and
//    emb_rel_k in shared memory, and only by a block whose keys reach the
//    diagonal +-w; only the one or two key tiles that cross it add them. The
//    band weights need no rescaling: the block keeps the band's final logits
//    s[t, t + j - w], and bw = exp(s - m) / l once the row's max m and sum l
//    are known.
//  - Filling the card: T = 1,632 and 2 heads give 52 query tiles; the key
//    range is split so that the grid fills every SM's two block slots once
//    (5 splits, 260 blocks on 132 SMs). Each block writes its unnormalised
//    O, its (m, l) and its band logits; rel_attn_merge_kernel (one warp a row)
//    merges the splits by log-sum-exp, normalises, adds bw . emb_rel_v and
//    writes the output through its strides. This entry is two launches.
//  - Layout: q, k and v are contiguous (B, H, T, D) rows (the wrapper copies
//    the caller's head views there in one launch); out is a (B, H, T, D) view
//    of unit stride over D, written through its batch, head and row strides.
//    Key tiles at or past the length are skipped: their -1e4 scores underflow
//    to exactly 0 beside any valid key (the whole range runs when the length
//    is 0, as the plain version's uniform row).

#include <cuda_runtime.h>
#include <math.h>
#include <stddef.h>
#include <stdint.h>

namespace {

constexpr int BQ = 64;          // query rows per block
constexpr int BK = 32;          // keys per tile
constexpr int THREADS = 128;    // 16 row groups x 8 key (or dim) groups
constexpr int MIN_BLOCKS = 2;   // blocks an SM
constexpr int MAX_NW = 31;      // 2w + 1
constexpr int MAX_SPLITS = 32;  // one lane each in the merge
constexpr int PS = BQ + 4;      // P^T row stride (floats)
constexpr int MERGE_WARPS = 8;
constexpr unsigned FULL = 0xffffffffu;

struct Strides {
  long long b, h, t;
};

// shared floats: Q, K x 2, V x 2, P^T, alpha, band bias, band logits
__host__ __device__ constexpr size_t smem_floats(int D, int NW) {
  return (size_t)BQ * (D + 4) + 2 * BK * (D + 4) + 2 * BK * D + BK * PS + BQ +
         2 * BQ * NW;
}

__device__ __forceinline__ void cp_async16(float* dst, const float* src, bool pred) {
  const uint32_t d = (uint32_t)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d), "l"(src),
               "r"(pred ? 16 : 0));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ float group8_max(float x) {
#pragma unroll
  for (int o = 4; o > 0; o >>= 1) x = fmaxf(x, __shfl_xor_sync(FULL, x, o));
  return x;
}

__device__ __forceinline__ float group8_sum(float x) {
#pragma unroll
  for (int o = 4; o > 0; o >>= 1) x += __shfl_xor_sync(FULL, x, o);
  return x;
}

__device__ __forceinline__ float dot4(float4 a, float4 b, float acc) {
  acc = fmaf(a.x, b.x, acc);
  acc = fmaf(a.y, b.y, acc);
  acc = fmaf(a.z, b.z, acc);
  return fmaf(a.w, b.w, acc);
}

__device__ __forceinline__ void axpy4(float a, float4 x, float4& y) {
  y.x = fmaf(a, x.x, y.x);
  y.y = fmaf(a, x.y, y.y);
  y.z = fmaf(a, x.z, y.z);
  y.w = fmaf(a, x.w, y.w);
}

// One block: 64 query rows of head (b, h), key tiles [kt0, kt1) of its split.
// Writes part_o (S, BH, T, D) unnormalised, part_ml (S, BH, T, 2) = (m, l) and
// part_bl (S, BH, T, NW) = the band logits of its keys (-inf elsewhere).
template <int D>
__global__ void __launch_bounds__(THREADS, MIN_BLOCKS) rel_attn_split_kernel(
    const float* __restrict__ q, const float* __restrict__ k, const float* __restrict__ v,
    const float* __restrict__ ek,  // (HE, NW, D)
    int ek_head_stride,            // 0 when one table serves every head
    const int* __restrict__ lens,  // (B,)
    float* __restrict__ part_o, float* __restrict__ part_ml, float* __restrict__ part_bl,
    int H, int T, int w, int S, float scale) {
  constexpr int QS = D + 4;
  constexpr int D4 = D / 4;
  constexpr int DC = D / 32;  // float4 of O per thread and row
  extern __shared__ __align__(16) float smem[];
  float* Qs = smem;
  float* Ks = Qs + BQ * QS;
  float* Vs = Ks + 2 * BK * QS;
  float* Pt = Vs + 2 * BK * D;
  float* As = Pt + BK * PS;
  const int NW = 2 * w + 1;
  float* Bb = As + BQ;
  float* Bl = Bb + BQ * NW;

  const int tid = threadIdx.x;
  const int rg = tid / 8, kg = tid % 8;  // scores: rows rg + 16i, keys kg + 8j
  const int pr = tid / 8, dg = tid % 8;  // P V: rows 4pr + r, dims 4dg + 32c
  const int BH = gridDim.y;
  const int bh = blockIdx.y, b = bh / H, h = bh % H;
  const int q0 = blockIdx.x * BQ;
  const int split = blockIdx.z;
  const int L = lens[b];
  const int n_keys = L >= 1 ? min(L, T) : T;
  const int n_kt = (n_keys + BK - 1) / BK;
  const int per = (n_kt + S - 1) / S;
  const int kt0 = min(split * per, n_kt), kt1 = min(kt0 + per, n_kt);
  const size_t head = (size_t)bh * T * D;
  const float* qb = q + head;
  const float* kb = k + head;
  const float* vb = v + head;

  auto load_kv = [&](int kt, int buf) {
    const int k0 = kt * BK;
    float* Kd = Ks + buf * BK * QS;
    float* Vd = Vs + buf * BK * D;
    for (int i = tid; i < BK * D4; i += THREADS) {
      const int r = i / D4, c = (i % D4) * 4;
      const bool ok = k0 + r < T;
      const size_t u = ok ? k0 + r : 0;
      cp_async16(Kd + r * QS + c, kb + u * D + c, ok);
      cp_async16(Vd + r * D + c, vb + u * D + c, ok);
    }
    cp_async_commit();
  };
  if (kt0 < kt1) load_kv(kt0, 0);

  for (int i = tid; i < BQ * D4; i += THREADS) {
    const int r = i / D4, c = (i % D4) * 4;
    float4 x = make_float4(0.f, 0.f, 0.f, 0.f);
    if (q0 + r < T) x = __ldg(reinterpret_cast<const float4*>(qb + (size_t)(q0 + r) * D + c));
    x.x *= scale;
    x.y *= scale;
    x.z *= scale;
    x.w *= scale;
    *reinterpret_cast<float4*>(Qs + r * QS + c) = x;
  }
  for (int i = tid; i < BQ * NW; i += THREADS) Bl[i] = -INFINITY;
  // do this split's keys reach the band |u - t| <= w of the block's rows?
  const bool has_band =
      kt0 < kt1 && kt0 * BK <= q0 + BQ - 1 + w && kt1 * BK - 1 >= q0 - w;
  __syncthreads();
  if (has_band) {
    const float* e = ek + h * ek_head_stride;
    for (int i = tid; i < BQ * NW; i += THREADS) {
      const int r = i / NW, j = i % NW;
      const float* qr = Qs + r * QS;
      const float* ej = e + j * D;
      float acc[4] = {0.f, 0.f, 0.f, 0.f};  // four chains, not one of D FMAs
#pragma unroll
      for (int d = 0; d < D; d += 16)
#pragma unroll
        for (int c = 0; c < 4; ++c)
          acc[c] = dot4(*reinterpret_cast<const float4*>(qr + d + 4 * c),
                        __ldg(reinterpret_cast<const float4*>(ej + d + 4 * c)), acc[c]);
      Bb[i] = (acc[0] + acc[1]) + (acc[2] + acc[3]);
    }
  }

  float m[4], l[4];
  float4 o[4][DC];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = -INFINITY;
    l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < DC; ++c) o[i][c] = make_float4(0.f, 0.f, 0.f, 0.f);
  }

  for (int kt = kt0; kt < kt1; ++kt) {
    const int buf = (kt - kt0) & 1;
    cp_async_wait<0>();
    // tile kt (and, the first time, the band bias) in place; every warp is
    // done with tile kt - 1, so its buffers and P^T are free
    __syncthreads();
    if (kt + 1 < kt1) load_kv(kt + 1, buf ^ 1);
    const float* Kt = Ks + buf * BK * QS;
    const float* Vt = Vs + buf * BK * D;
    const int k0 = kt * BK;

    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
#pragma unroll 4
    for (int d = 0; d < D; d += 4) {
      float4 qv[4], kv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
        qv[i] = *reinterpret_cast<const float4*>(Qs + (rg + 16 * i) * QS + d);
#pragma unroll
      for (int j = 0; j < 4; ++j)
        kv[j] = *reinterpret_cast<const float4*>(Kt + (kg + 8 * j) * QS + d);
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) s[i][j] = dot4(qv[i], kv[j], s[i][j]);
    }

    const bool band_tile = k0 <= q0 + BQ - 1 + w && k0 + BK - 1 >= q0 - w;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = rg + 16 * i;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int u = k0 + kg + 8 * j;
        const int rel = u - (q0 + r) + w;
        const bool in_band = band_tile && rel >= 0 && rel < NW;
        float x = s[i][j];
        if (in_band) x += Bb[r * NW + rel];
        if (u >= L) x = -1e4f;  // a length of 0 masks every key, as the plain version
        if (u >= T) x = -INFINITY;
        if (in_band) Bl[r * NW + rel] = x;
        s[i][j] = x;
      }
      const float m_new =
          fmaxf(m[i], group8_max(fmaxf(fmaxf(s[i][0], s[i][1]), fmaxf(s[i][2], s[i][3]))));
      const float alpha = expf(m[i] - m_new);
      float ps = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float p = expf(s[i][j] - m_new);
        Pt[(kg + 8 * j) * PS + r] = p;
        ps += p;
      }
      l[i] = l[i] * alpha + group8_sum(ps);
      m[i] = m_new;
      if (kg == 0) As[r] = alpha;
    }
    __syncthreads();  // P and alpha in place

    const float4 a = *reinterpret_cast<const float4*>(As + 4 * pr);
    const float al[4] = {a.x, a.y, a.z, a.w};
#pragma unroll
    for (int r = 0; r < 4; ++r)
#pragma unroll
      for (int c = 0; c < DC; ++c) {
        o[r][c].x *= al[r];
        o[r][c].y *= al[r];
        o[r][c].z *= al[r];
        o[r][c].w *= al[r];
      }
#pragma unroll 8
    for (int kk = 0; kk < BK; ++kk) {
      const float4 p = *reinterpret_cast<const float4*>(Pt + kk * PS + 4 * pr);
#pragma unroll
      for (int c = 0; c < DC; ++c) {
        const float4 vv = *reinterpret_cast<const float4*>(Vt + kk * D + 4 * dg + 32 * c);
        axpy4(p.x, vv, o[0][c]);
        axpy4(p.y, vv, o[1][c]);
        axpy4(p.z, vv, o[2][c]);
        axpy4(p.w, vv, o[3][c]);
      }
    }
  }

  const size_t prow = ((size_t)split * BH + bh) * T;
  if (kg == 0) {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int t = q0 + rg + 16 * i;
      if (t < T) {
        part_ml[(prow + t) * 2] = m[i];
        part_ml[(prow + t) * 2 + 1] = l[i];
      }
    }
  }
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const int t = q0 + 4 * pr + r;
    if (t >= T) continue;
#pragma unroll
    for (int c = 0; c < DC; ++c)
      *reinterpret_cast<float4*>(part_o + (prow + t) * D + 4 * dg + 32 * c) = o[r][c];
  }
  __syncthreads();  // Bl complete (also when this split has no tile)
  for (int i = tid; i < BQ * NW; i += THREADS) {
    const int t = q0 + i / NW;
    if (t < T) part_bl[(prow + t) * NW + i % NW] = Bl[i];
  }
}

// One warp per (b, h, t): merge the S splits by log-sum-exp, normalise, add
// the band weights times emb_rel_v, write out through its strides.
template <int D>
__global__ void __launch_bounds__(MERGE_WARPS * 32) rel_attn_merge_kernel(
    const float* __restrict__ part_o, const float* __restrict__ part_ml,
    const float* __restrict__ part_bl,
    const float* __restrict__ ev,  // (HE, NW, D)
    int ev_head_stride, float* __restrict__ out, Strides os, int BH, int H, int T, int w,
    int S) {
  constexpr int DC = D / 32;
  const int lane = threadIdx.x % 32;
  const int row = blockIdx.x * MERGE_WARPS + threadIdx.x / 32;
  if (row >= BH * T) return;
  const int bh = row / T, t = row % T, b = bh / H, h = bh % H;
  const int NW = 2 * w + 1;
  const size_t split_rows = (size_t)BH * T;

  float ms = -INFINITY, ls = 0.f;
  if (lane < S) {
    ms = part_ml[(lane * split_rows + row) * 2];
    ls = part_ml[(lane * split_rows + row) * 2 + 1];
  }
  float M = ms;
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) M = fmaxf(M, __shfl_xor_sync(FULL, M, o));
  const float wgt = ls > 0.f ? expf(ms - M) : 0.f;
  float Lt = ls * wgt;
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) Lt += __shfl_xor_sync(FULL, Lt, o);
  const float inv = 1.f / Lt;

  float acc[DC];
#pragma unroll
  for (int c = 0; c < DC; ++c) acc[c] = 0.f;
  for (int s = 0; s < S; ++s) {
    const float ws = __shfl_sync(FULL, wgt, s);
    if (ws == 0.f) continue;
    const float* po = part_o + (s * split_rows + row) * D;
#pragma unroll
    for (int c = 0; c < DC; ++c) acc[c] = fmaf(ws, po[lane + 32 * c], acc[c]);
  }
  float bw = 0.f;
  if (lane < NW) {
    float bl = -INFINITY;
    for (int s = 0; s < S; ++s) bl = fmaxf(bl, part_bl[(s * split_rows + row) * NW + lane]);
    bw = expf(bl - M) * inv;
  }
  const float* e = ev + h * ev_head_stride;
  float* orow = out + b * os.b + h * os.h + t * os.t;
#pragma unroll
  for (int c = 0; c < DC; ++c) {
    float r = acc[c] * inv;
    for (int j = 0; j < NW; ++j)
      r = fmaf(__shfl_sync(FULL, bw, j), __ldg(e + j * D + lane + 32 * c), r);
    orow[lane + 32 * c] = r;
  }
}

struct Plan {
  int splits, blocks, blocks_per_sm, sms, smem_bytes;
};

// the opt-in shared memory limit, set once for each instantiation
template <int D>
cudaError_t smem_attr() {
  static const cudaError_t attr = cudaFuncSetAttribute(
      rel_attn_split_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)(smem_floats(D, MAX_NW) * sizeof(float)));
  return attr;
}

template <int D>
cudaError_t make_plan(int BH, int T, int w, Plan* p) {
  cudaError_t err = smem_attr<D>();
  int dev = 0;
  if (err == cudaSuccess) err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&p->sms, cudaDevAttrMultiProcessorCount, dev);
  p->smem_bytes = (int)(smem_floats(D, 2 * w + 1) * sizeof(float));
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&p->blocks_per_sm,
                                                        rel_attn_split_kernel<D>, THREADS,
                                                        p->smem_bytes);
  if (err != cudaSuccess) return err;
  // enough key splits to fill every block slot once, at least one tile each
  const int base = (T + BQ - 1) / BQ * BH;
  const int slots = p->sms * p->blocks_per_sm;
  int s = slots / base;
  s = s < 1 ? 1 : s;
  const int n_kt = (T + BK - 1) / BK;
  s = s > n_kt ? n_kt : s;
  p->splits = s > MAX_SPLITS ? MAX_SPLITS : s;
  p->blocks = base * p->splits;
  return cudaSuccess;
}

template <int D>
cudaError_t launch(const float* q, const float* k, const float* v, const float* ek,
                   const float* ev, int e_heads, const int* lens, float* out, float* work,
                   int B, int H, int T, int w, int S, const long long* ost,
                   cudaStream_t stream) {
  cudaError_t err = smem_attr<D>();
  if (err != cudaSuccess) return err;
  const int BH = B * H, NW = 2 * w + 1;
  const int smem = (int)(smem_floats(D, NW) * sizeof(float));
  const int e_stride = e_heads == 1 ? 0 : NW * D;
  float* part_o = work;
  float* part_ml = part_o + (size_t)S * BH * T * D;
  float* part_bl = part_ml + (size_t)S * BH * T * 2;
  const Strides os{ost[0], ost[1], ost[2]};
  const dim3 grid((T + BQ - 1) / BQ, BH, S);
  rel_attn_split_kernel<D><<<grid, THREADS, smem, stream>>>(
      q, k, v, ek, e_stride, lens, part_o, part_ml, part_bl, H, T, w, S,
      1.f / sqrtf((float)D));
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const int rows = BH * T;
  rel_attn_merge_kernel<D><<<(rows + MERGE_WARPS - 1) / MERGE_WARPS, MERGE_WARPS * 32, 0,
                             stream>>>(part_o, part_ml, part_bl, ev, e_stride, out, os, BH,
                                       H, T, w, S);
  return cudaGetLastError();
}

}  // namespace

// The launch plan for (B*H, T, D, w): plan = {splits, blocks, blocks per SM,
// SMs, shared bytes a block}. The wrapper sizes the scratch of rvc_rel_attention
// from splits: splits * BH * T * (D + 2 + 2w+1) floats. Returns a CUDA error
// (cudaErrorInvalidValue for a D or w the kernel does not take).
extern "C" int rvc_rel_attention_plan(int BH, int T, int D, int w, int* plan) {
  if (2 * w + 1 > MAX_NW || w < 0) return (int)cudaErrorInvalidValue;
  Plan p;
  cudaError_t err;
  switch (D) {
    case 32: err = make_plan<32>(BH, T, w, &p); break;
    case 64: err = make_plan<64>(BH, T, w, &p); break;
    case 96: err = make_plan<96>(BH, T, w, &p); break;
    case 128: err = make_plan<128>(BH, T, w, &p); break;
    default: return (int)cudaErrorInvalidValue;
  }
  if (err != cudaSuccess) return (int)err;
  plan[0] = p.splits;
  plan[1] = p.blocks;
  plan[2] = p.blocks_per_sm;
  plan[3] = p.sms;
  plan[4] = p.smem_bytes;
  return 0;
}

// q, k, v: contiguous (B, H, T, D) float32, 16-byte aligned. out: a (B, H, T,
// D) float32 view with unit stride over D and its batch, head and row strides
// (elements) in out_strides[0..2]. ek, ev: (e_heads, 2w+1,
// D) contiguous, e_heads 1 or H. lens: (B,) int32. work: the scratch sized by
// rvc_rel_attention_plan for these splits (1 to 32). D in {32, 64, 96, 128},
// 2w+1 <= 31. Two launches.
// Returns cudaGetLastError().
extern "C" int rvc_rel_attention(const float* q, const float* k, const float* v,
                                 const float* ek, const float* ev, const int* lens,
                                 float* out, float* work, int B, int H, int T, int D, int w,
                                 int e_heads, int splits, const long long* out_strides,
                                 cudaStream_t stream) {
  if (2 * w + 1 > MAX_NW || w < 0 || splits < 1 || splits > MAX_SPLITS)
    return (int)cudaErrorInvalidValue;
  switch (D) {
    case 32: return (int)launch<32>(q, k, v, ek, ev, e_heads, lens, out, work, B, H, T, w, splits, out_strides, stream);
    case 64: return (int)launch<64>(q, k, v, ek, ev, e_heads, lens, out, work, B, H, T, w, splits, out_strides, stream);
    case 96: return (int)launch<96>(q, k, v, ek, ev, e_heads, lens, out, work, B, H, T, w, splits, out_strides, stream);
    case 128: return (int)launch<128>(q, k, v, ek, ev, e_heads, lens, out, work, B, H, T, w, splits, out_strides, stream);
    default: return (int)cudaErrorInvalidValue;
  }
}
