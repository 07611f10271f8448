// K3: VITS windowed relative-position attention, CUDA C++ for sm_90a.
//
// Replaces rvc_tpu/ops/pallas/attention.py : fused_rel_attention (kernel body
// _kernel :48-83, pallas_call :120). Per (batch*head, query row t):
//   s[t, s] = q[t] . k[s] + band[t, s - t + w]   for |s - t| <= w
//   s[t, s] = -1e4                                 for keys s >= length
//   p = softmax_s(s)  (float32),   out[t] = sum_s p[t, s] v[s]
//   bw[t, j] = p[t, t + j - w]     (the 2w+1 band weights)
// q arrives pre-scaled by 1/sqrt(D). band = q . emb_rel_k^T and the final
// out += bw . emb_rel_v stay outside, in the wrapper, as on the TPU
// (attention.py:103-106,144-145): both are (T, 2w+1)-sized.
//
// What bounds it on the H100: operations. One TextEncoder layer at the main
// path's shape (2 heads, T = 1,632, D = 96) is 2 x 2 x T^2 x D = 2 GFLOP for
// 4 MB of q, k, v, band and outputs. No (T, T) plane ever reaches device
// memory (the TPU kernel's point, and the plain version's cost).
//
// Design: flash-style, one pass with an online softmax. A block of 4 warps
// owns 16 query rows of one head (4 per warp) and streams the keys through
// shared memory in tiles of 32 (K padded to D+1 floats a row, so the lanes'
// reads of 32 different keys fall in 32 different banks). Lane i scores key
// s0 + i for each of its warp's rows; warp shuffles give the row max and sum.
// The band bias is added inside the tile: lane j < 2w+1 holds band[t, j] and
// hands it to the lane whose key is t + j - w. Each lane keeps D/32 output
// dims and, for j < 2w+1, the running band weight of key t + j - w, rescaled
// with the output when the row max moves. Key tiles at or past the length
// are skipped: their -1e4 scores underflow to exactly 0 beside any valid
// key, so the result is the same (the whole range runs when length is 0).
// float32 FMA throughout; tensor cores are later work.

#include <cuda_runtime.h>
#include <math.h>
#include <stddef.h>

namespace {

constexpr int WARPS = 4;
constexpr int ROWS = 4;              // query rows per warp
constexpr int BQ = WARPS * ROWS;     // query rows per block
constexpr int BKEY = 32;             // keys per tile (one per lane)
constexpr int MAXD = 128;
constexpr int DPL = MAXD / 32;       // output dims per lane
constexpr unsigned FULL = 0xffffffffu;

__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x = fmaxf(x, __shfl_xor_sync(FULL, x, o));
  return x;
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(FULL, x, o);
  return x;
}

__global__ void __launch_bounds__(WARPS * 32) rel_attn_kernel(
    const float* __restrict__ q,     // (BH, T, D), pre-scaled
    const float* __restrict__ k,     // (BH, T, D)
    const float* __restrict__ v,     // (BH, T, D)
    const float* __restrict__ band,  // (BH, T, NW)
    const int* __restrict__ lens,    // (B,)
    float* __restrict__ out,         // (BH, T, D)
    float* __restrict__ bw,          // (BH, T, NW)
    int H, int T, int D, int w) {
  __shared__ float Qs[BQ][MAXD];
  __shared__ float Ks[BKEY][MAXD + 1];
  __shared__ float Vs[BKEY][MAXD];

  const int bh = blockIdx.y;
  const int q0 = blockIdx.x * BQ;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int NW = 2 * w + 1;
  const int L = lens[bh / H];
  const int n_keys = L >= 1 ? min(L, T) : T;
  const size_t base = (size_t)bh * T * D;

  for (int i = threadIdx.x; i < BQ * D; i += blockDim.x) {
    const int r = i / D, d = i % D;
    Qs[r][d] = q0 + r < T ? q[base + (size_t)(q0 + r) * D + d] : 0.f;
  }

  float m[ROWS], l[ROWS], acc[ROWS][DPL], bwacc[ROWS], bandv[ROWS];
  int t[ROWS];
#pragma unroll
  for (int r = 0; r < ROWS; ++r) {
    t[r] = q0 + warp * ROWS + r;
    m[r] = -INFINITY;
    l[r] = 0.f;
    bwacc[r] = 0.f;
#pragma unroll
    for (int j = 0; j < DPL; ++j) acc[r][j] = 0.f;
    bandv[r] = (lane < NW && t[r] < T) ? band[((size_t)bh * T + t[r]) * NW + lane] : 0.f;
  }

  for (int s0 = 0; s0 < n_keys; s0 += BKEY) {
    __syncthreads();  // Q loaded / previous tile consumed
    for (int i = threadIdx.x; i < BKEY * D; i += blockDim.x) {
      const int r = i / D, d = i % D;
      const bool ok = s0 + r < T;
      const size_t off = base + (size_t)(s0 + r) * D + d;
      Ks[r][d] = ok ? k[off] : 0.f;
      Vs[r][d] = ok ? v[off] : 0.f;
    }
    __syncthreads();

    const int s = s0 + lane;
#pragma unroll
    for (int r = 0; r < ROWS; ++r) {
      const float* qrow = Qs[warp * ROWS + r];
      float sc = 0.f;
      for (int d = 0; d < D; ++d) sc = fmaf(qrow[d], Ks[lane][d], sc);
      const int rel = s - t[r] + w;
      const bool in_band = rel >= 0 && rel < NW;
      const float bv = __shfl_sync(FULL, bandv[r], in_band ? rel : 0);
      if (in_band) sc += bv;
      if (s >= L) sc = -1e4f;
      const float x = s < T ? sc : -INFINITY;

      const float m_new = fmaxf(m[r], warp_max(x));
      const float alpha = expf(m[r] - m_new);
      const float p = s < T ? expf(x - m_new) : 0.f;
      l[r] = l[r] * alpha + warp_sum(p);
      m[r] = m_new;

#pragma unroll
      for (int j = 0; j < DPL; ++j) acc[r][j] *= alpha;
      for (int kk = 0; kk < BKEY; ++kk) {
        const float pk = __shfl_sync(FULL, p, kk);
#pragma unroll
        for (int j = 0; j < DPL; ++j) {
          const int d = lane + 32 * j;
          if (d < D) acc[r][j] = fmaf(pk, Vs[kk][d], acc[r][j]);
        }
      }

      // band weight of lane j: key t + j - w, held by lane (t + j - w - s0)
      const int src = t[r] + lane - w - s0;
      const bool here = src >= 0 && src < BKEY;
      const float pj = __shfl_sync(FULL, p, here ? src : 0);
      bwacc[r] = bwacc[r] * alpha + ((lane < NW && here) ? pj : 0.f);
    }
  }

#pragma unroll
  for (int r = 0; r < ROWS; ++r) {
    if (t[r] >= T) continue;
    const float inv = 1.f / l[r];
    const size_t row = (size_t)bh * T + t[r];
#pragma unroll
    for (int j = 0; j < DPL; ++j) {
      const int d = lane + 32 * j;
      if (d < D) out[row * D + d] = acc[r][j] * inv;
    }
    if (lane < NW) bw[row * NW + lane] = bwacc[r] * inv;
  }
}

}  // namespace

// q, k, v, out: (B*H, T, D); band, bw: (B*H, T, 2w+1); lens: (B,) int32.
// Requires D <= 128 and 2w+1 <= 32. Returns cudaGetLastError().
extern "C" int rvc_rel_attention(const float* q, const float* k, const float* v,
                                 const float* band, const int* lens, float* out,
                                 float* bw, int B, int H, int T, int D, int w,
                                 cudaStream_t stream) {
  const dim3 grid((T + BQ - 1) / BQ, B * H);
  rel_attn_kernel<<<grid, WARPS * 32, 0, stream>>>(q, k, v, band, lens, out, bw, H, T,
                                                   D, w);
  return (int)cudaGetLastError();
}
