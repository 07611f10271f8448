// K4: RMVPE's log-mel front end, CUDA C++ for sm_90a.
//
// Replaces rvc_tpu/ops/pallas/melspec.py : pallas_log_mel (kernel body
// _mel_kernel :44-53, pallas_call :101). Same function: reflect pad n_fft/2,
// frames of n_fft every hop samples, periodic Hann window, the DFT as a
// product with cos and sin bases, magnitude, the (n_bins -> n_mels) mel
// filterbank, log(max(., clamp)).
//
// What bounds it on the H100: operations. A 13.5 s clip is 1,633 frames x
// 1,024 samples x 2 x 513 bins, about 3.4 GFLOP of DFT against about 1 MB
// of audio in and 0.8 MB of log-mel out, far above the card's ratio of
// operations to bytes. The TPU kernel ran at Precision.HIGHEST, so this one
// stays in float32 FMA (no TF32, no bf16), whose 67 TFLOP/s peak is the bound.
//
// Design: two kernels.
//  1. dft_mag_kernel: a tiled SGEMM of frames x [cos | sin]. A block owns
//     64 frames x 32 bins and walks the 1,024 samples in steps of 32. It reads
//     the audio directly: the reflect padding and the framing are index
//     arithmetic in the tile load, so the 6.7 MB frames tensor never exists.
//     The window is folded into the bases by the wrapper. The epilogue writes
//     the magnitude sqrt(re^2 + im^2); each thread keeps 4 frames x 2 bins of
//     both the real and the imaginary sum in registers.
//  2. mel_log_kernel: magnitude rows x filterbank (n_bins x n_mels, 0.2 GFLOP),
//     then the log clamp. A block stages 8 magnitude rows in shared memory;
//     each thread owns one mel bin.
// The magnitude (3.4 MB for the clip) makes one round trip through device
// memory between the two; it is small beside the product's time.

#include <cuda_runtime.h>
#include <math.h>
#include <stddef.h>

namespace {

constexpr int BM = 64;        // frames per block
constexpr int BN = 32;        // DFT bins per block (cos and sin each)
constexpr int BK = 32;        // samples per step
constexpr int THREADS = 256;  // 16 x 16: 4 frames x 2 bins each
constexpr int MEL_ROWS = 8;   // frames per block of the mel kernel
constexpr int MEL_THREADS = 128;

__global__ void __launch_bounds__(THREADS) dft_mag_kernel(
    const float* __restrict__ audio,  // (B, T)
    const float* __restrict__ cosb,   // (n_fft, n_bins), window folded in
    const float* __restrict__ sinb,   // (n_fft, n_bins)
    float* __restrict__ mag,          // (B * n_frames, n_bins)
    int T, int n_frames, int total_frames, int n_fft, int hop, int n_bins) {
  __shared__ __align__(16) float As[BK][BM + 4];
  __shared__ __align__(16) float Cs[BK][BN];
  __shared__ __align__(16) float Ss[BK][BN];

  const int tid = threadIdx.x;
  const int tx = tid % 16;  // bins n0 + 2*tx, +1
  const int ty = tid / 16;  // frames m0 + 4*ty .. +3
  const int m0 = blockIdx.y * BM;
  const int n0 = blockIdx.x * BN;
  const int pad = n_fft / 2;

  float re[4][2] = {};
  float im[4][2] = {};

  for (int k0 = 0; k0 < n_fft; k0 += BK) {
    // frames tile: consecutive threads read consecutive samples
    for (int i = tid; i < BK * BM; i += THREADS) {
      const int m = i / BK, k = i % BK;
      const int frame = m0 + m;
      float v = 0.f;
      if (frame < total_frames) {
        const int b = frame / n_frames, f = frame % n_frames;
        int s = f * hop + k0 + k - pad;  // index into the unpadded signal
        if (s < 0) s = -s;                // reflect (no edge repeat)
        if (s >= T) s = 2 * (T - 1) - s;
        v = audio[(size_t)b * T + s];
      }
      As[k][m] = v;
    }
    for (int i = tid; i < BK * BN; i += THREADS) {
      const int k = i / BN, n = i % BN;
      const int col = n0 + n;
      const size_t off = (size_t)(k0 + k) * n_bins + col;
      Cs[k][n] = col < n_bins ? cosb[off] : 0.f;
      Ss[k][n] = col < n_bins ? sinb[off] : 0.f;
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < BK; ++kk) {
      const float4 a4 = *reinterpret_cast<const float4*>(&As[kk][4 * ty]);
      const float2 c2 = *reinterpret_cast<const float2*>(&Cs[kk][2 * tx]);
      const float2 s2 = *reinterpret_cast<const float2*>(&Ss[kk][2 * tx]);
      const float a[4] = {a4.x, a4.y, a4.z, a4.w};
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        re[i][0] = fmaf(a[i], c2.x, re[i][0]);
        re[i][1] = fmaf(a[i], c2.y, re[i][1]);
        im[i][0] = fmaf(a[i], s2.x, im[i][0]);
        im[i][1] = fmaf(a[i], s2.y, im[i][1]);
      }
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int frame = m0 + 4 * ty + i;
    if (frame >= total_frames) continue;
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      const int col = n0 + 2 * tx + j;
      if (col < n_bins)
        mag[(size_t)frame * n_bins + col] =
            sqrtf(re[i][j] * re[i][j] + im[i][j] * im[i][j]);
    }
  }
}

__global__ void __launch_bounds__(MEL_THREADS) mel_log_kernel(
    const float* __restrict__ mag,  // (total_frames, n_bins)
    const float* __restrict__ fbT,  // (n_bins, n_mels)
    float* __restrict__ out,        // (total_frames, n_mels)
    int total_frames, int n_bins, int n_mels, float clamp) {
  extern __shared__ float rows[];  // MEL_ROWS x n_bins
  const int r0 = blockIdx.x * MEL_ROWS;
  for (int i = threadIdx.x; i < MEL_ROWS * n_bins; i += blockDim.x) {
    const int r = i / n_bins, k = i % n_bins;
    rows[i] = r0 + r < total_frames ? mag[(size_t)(r0 + r) * n_bins + k] : 0.f;
  }
  __syncthreads();
  for (int j = threadIdx.x; j < n_mels; j += blockDim.x) {
    float acc[MEL_ROWS] = {};
    for (int k = 0; k < n_bins; ++k) {
      const float w = fbT[(size_t)k * n_mels + j];
#pragma unroll
      for (int r = 0; r < MEL_ROWS; ++r) acc[r] = fmaf(rows[r * n_bins + k], w, acc[r]);
    }
#pragma unroll
    for (int r = 0; r < MEL_ROWS; ++r)
      if (r0 + r < total_frames)
        out[(size_t)(r0 + r) * n_mels + j] = logf(fmaxf(acc[r], clamp));
  }
}

}  // namespace

// audio (B, T) -> out (B, 1 + T / hop, n_mels). mag is scratch of
// (B * (1 + T / hop), n_bins) floats. Requires n_fft % 32 == 0 and
// T > n_fft / 2 (one reflection covers the pad). Returns cudaGetLastError().
extern "C" int rvc_log_mel(const float* audio, const float* cosb, const float* sinb,
                           const float* fbT, float* mag, float* out, int B, int T,
                           int n_fft, int hop, int n_bins, int n_mels, float clamp,
                           cudaStream_t stream) {
  const int n_frames = 1 + T / hop;
  const int total = B * n_frames;
  const dim3 grid((n_bins + BN - 1) / BN, (total + BM - 1) / BM);
  dft_mag_kernel<<<grid, THREADS, 0, stream>>>(audio, cosb, sinb, mag, T, n_frames,
                                               total, n_fft, hop, n_bins);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const size_t smem = (size_t)MEL_ROWS * n_bins * sizeof(float);
  mel_log_kernel<<<(total + MEL_ROWS - 1) / MEL_ROWS, MEL_THREADS, smem, stream>>>(
      mag, fbT, out, total, n_bins, n_mels, clamp);
  return (int)cudaGetLastError();
}
