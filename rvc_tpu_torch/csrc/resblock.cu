// K1 + K2: HiFi-GAN ResBlock chains of the NSF decoder, CUDA C++ for sm_90a.
//
// Replaces rvc_tpu/ops/pallas/resblock.py : fused_resblock_group (K1, kernel
// body _kernel_group :236-281, pallas_call :389) and fused_resblock (K2,
// _kernel :94-135, pallas_call :212). Both compute, per ResBlock chain,
//   for each dilation d:  cur += conv_k(lrelu(conv_{k,d}(lrelu(cur)) + b1) + b2
// with every conv input zero outside [0, T); K1 then takes the mean over the
// stage's parallel chains (k = 3, 7, 11).
//
// What bounds it on the H100: operations. A chain is 2 x T x C^2 x (sum of
// its six kernel sizes) FLOP: 808 GFLOP for the 48 kHz model's C = 128 stage
// of a 13.5 s clip against 200 MB in and out. This first version runs in
// float32 FMA (the TPU kernel fed bf16 taps to its MXU); its bound is the
// card's 67 TFLOP/s float32 peak. bf16 mma.sync / wgmma is later work.
//
// Design: one launch per dilation step, with both convolutions, both LReLUs,
// both biases, the boundary zeroing and the residual fused; the last step of a
// chain also folds in the stage mean (y = alpha * result + beta * y). A
// block owns a time tile of TT outputs of one batch row, channels last:
//   A  = lrelu(x) on TT + 2 (h1 + h2) rows    (h1 = (k-1)/2 d, h2 = (k-1)/2)
//   Bf = lrelu(conv1(A) + b1) on TT + 2 h2 rows
//   y  = x + conv2(Bf) + b2 on TT rows
// both staged in shared memory (rows padded to C + 1 floats, conflict-free).
// A whole chain in one pass (the TPU's design) needs three float32 planes of
// tile plus 120 halo rows, more than shared memory holds at a useful tile for
// C >= 128. Per-step launches move the C = 128 stage's 100 MB plane 9 times
// in and out (1.8 GB against 0.2 GB for one fused stage: about 0.5 ms more
// at 3.35 TB/s), small beside the 12 ms operation bound.
// Each conv is a product over (tap, input channel): a thread owns 4 output
// channels (a float4 of the (K, Cin, Cout) weights, read through L1/L2) for
// up to 12 rows, so one weight load feeds 48 FMAs and the A values are
// warp-wide broadcasts from shared memory.

#include <cuda_runtime.h>
#include <stddef.h>

namespace {

constexpr int THREADS = 256;
constexpr int RMAX = 12;  // rows per thread per pass

template <int C> struct Tile;
template <> struct Tile<32> { static constexpr int TT = 256; };
template <> struct Tile<64> { static constexpr int TT = 128; };
template <> struct Tile<128> { static constexpr int TT = 64; };
template <> struct Tile<256> { static constexpr int TT = 32; };

__device__ __forceinline__ float lrelu(float v, float slope) {
  return v > 0.f ? v : v * slope;
}

// out rows [0, n_out) of a conv over src (rows strided by C + 1): row r reads
// src rows r + tau * dil. epi(r, co, acc) gets 4 channels co..co+3 of row r.
template <int C, typename Epi>
__device__ __forceinline__ void conv_tile(const float* __restrict__ src, int n_out,
                                          int K, int dil, const float* __restrict__ w,
                                          const float* __restrict__ bias, Epi epi) {
  constexpr int LD = C + 1;
  constexpr int G = C / 4;          // threads covering one row's channels
  constexpr int NG = THREADS / G;   // row groups
  const int g = threadIdx.x / G;
  const int co = (threadIdx.x % G) * 4;
  const float4 b4 = __ldg(reinterpret_cast<const float4*>(bias + co));
  for (int r0 = g; r0 < n_out; r0 += NG * RMAX) {
    float4 acc[RMAX];
    int rowoff[RMAX];
#pragma unroll
    for (int i = 0; i < RMAX; ++i) {
      acc[i] = b4;
      rowoff[i] = min(r0 + i * NG, n_out - 1) * LD;  // clamp: stay in the buffer
    }
    for (int tau = 0; tau < K; ++tau) {
      const float* s = src + tau * dil * LD;
      const float4* wt = reinterpret_cast<const float4*>(w + (size_t)tau * C * C + co);
#pragma unroll 4
      for (int ci = 0; ci < C; ++ci) {
        const float4 wv = __ldg(wt + ci * (C / 4));
#pragma unroll
        for (int i = 0; i < RMAX; ++i) {
          const float a = s[rowoff[i] + ci];
          acc[i].x = fmaf(a, wv.x, acc[i].x);
          acc[i].y = fmaf(a, wv.y, acc[i].y);
          acc[i].z = fmaf(a, wv.z, acc[i].z);
          acc[i].w = fmaf(a, wv.w, acc[i].w);
        }
      }
    }
#pragma unroll
    for (int i = 0; i < RMAX; ++i) {
      const int r = r0 + i * NG;
      if (r < n_out) epi(r, co, acc[i]);
    }
  }
}

template <int C>
__global__ void __launch_bounds__(THREADS) resblock_step_kernel(
    const float* __restrict__ x, float* __restrict__ y,
    const float* __restrict__ w1, const float* __restrict__ b1,
    const float* __restrict__ w2, const float* __restrict__ b2,
    int T, int K, int dil, float slope, float alpha, float beta) {
  extern __shared__ float smem[];
  constexpr int LD = C + 1;
  constexpr int TT = Tile<C>::TT;
  const int h1 = (K - 1) / 2 * dil, h2 = (K - 1) / 2;
  const int W1 = TT + 2 * (h1 + h2), W2 = TT + 2 * h2;
  float* A = smem;             // W1 rows
  float* Bf = smem + W1 * LD;  // W2 rows
  const int t0 = blockIdx.x * TT;
  const float* xb = x + (size_t)blockIdx.y * T * C;
  float* yb = y + (size_t)blockIdx.y * T * C;

  const int ta = t0 - h1 - h2;  // time of A's row 0
  for (int i = threadIdx.x; i < W1 * (C / 4); i += THREADS) {
    const int r = i / (C / 4), c = (i % (C / 4)) * 4;
    const int t = ta + r;
    float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
    if (t >= 0 && t < T) v = *reinterpret_cast<const float4*>(xb + (size_t)t * C + c);
    float* dst = A + r * LD + c;
    dst[0] = lrelu(v.x, slope);
    dst[1] = lrelu(v.y, slope);
    dst[2] = lrelu(v.z, slope);
    dst[3] = lrelu(v.w, slope);
  }
  __syncthreads();

  const int tb = t0 - h2;  // time of Bf's row 0
  conv_tile<C>(A, W2, K, dil, w1, b1, [&](int r, int co, float4 acc) {
    const bool ok = tb + r >= 0 && tb + r < T;
    float* dst = Bf + r * LD + co;
    dst[0] = ok ? lrelu(acc.x, slope) : 0.f;
    dst[1] = ok ? lrelu(acc.y, slope) : 0.f;
    dst[2] = ok ? lrelu(acc.z, slope) : 0.f;
    dst[3] = ok ? lrelu(acc.w, slope) : 0.f;
  });
  __syncthreads();

  conv_tile<C>(Bf, TT, K, 1, w2, b2, [&](int r, int co, float4 acc) {
    const int t = t0 + r;
    if (t >= T) return;
    const float4 xv = *reinterpret_cast<const float4*>(xb + (size_t)t * C + co);
    float4 res = make_float4(alpha * (xv.x + acc.x), alpha * (xv.y + acc.y),
                             alpha * (xv.z + acc.z), alpha * (xv.w + acc.w));
    float4* dst = reinterpret_cast<float4*>(yb + (size_t)t * C + co);
    if (beta != 0.f) {
      const float4 old = *dst;
      res.x += beta * old.x;
      res.y += beta * old.y;
      res.z += beta * old.z;
      res.w += beta * old.w;
    }
    *dst = res;
  });
}

template <int C>
int launch(const float* x, float* y, const float* w1, const float* b1, const float* w2,
           const float* b2, int B, int T, int K, int dil, float slope, float alpha,
           float beta, cudaStream_t stream) {
  constexpr int TT = Tile<C>::TT;
  const int h1 = (K - 1) / 2 * dil, h2 = (K - 1) / 2;
  const size_t smem = (size_t)(2 * TT + 2 * h1 + 4 * h2) * (C + 1) * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      resblock_step_kernel<C>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((T + TT - 1) / TT, B);
  resblock_step_kernel<C><<<grid, THREADS, smem, stream>>>(x, y, w1, b1, w2, b2, T, K, dil,
                                                           slope, alpha, beta);
  return (int)cudaGetLastError();
}

}  // namespace

// One dilation step of a ResBlock chain: y = alpha * (x + conv2(...)) + beta * y.
// x, y: (B, T, C) float32, distinct buffers; w1, w2: (K, C, C) as (tap, in,
// out); b1, b2: (C,). K odd. C in {32, 64, 128, 256}. beta == 0 never reads y.
// Returns cudaGetLastError() (cudaErrorInvalidValue for another C).
extern "C" int rvc_resblock_step(const float* x, float* y, const float* w1,
                                 const float* b1, const float* w2, const float* b2,
                                 int B, int T, int C, int K, int dil, float slope,
                                 float alpha, float beta, cudaStream_t stream) {
  switch (C) {
    case 32: return launch<32>(x, y, w1, b1, w2, b2, B, T, K, dil, slope, alpha, beta, stream);
    case 64: return launch<64>(x, y, w1, b1, w2, b2, B, T, K, dil, slope, alpha, beta, stream);
    case 128: return launch<128>(x, y, w1, b1, w2, b2, B, T, K, dil, slope, alpha, beta, stream);
    case 256: return launch<256>(x, y, w1, b1, w2, b2, B, T, K, dil, slope, alpha, beta, stream);
    default: return (int)cudaErrorInvalidValue;
  }
}
