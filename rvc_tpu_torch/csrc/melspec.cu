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
//  1. dft_mag_kernel: an SGEMM of frames x [cos | sin]. A block owns 64 frames
//     of one batch row and 64 bins. It reads its audio span once, (64 - 1) x hop
//     + n_fft samples, into shared memory with the reflect pad applied in that
//     load; a frame is then an offset into the span. The span is skewed by 4
//     floats every hop samples, so that frame f starts at f x (hop + 4) and the
//     float4 reads of neighbouring frames fall in distinct bank quads. The
//     windowed bases, laid out by the wrapper as (n_fft, bin tile, cos 64 |
//     sin 64), stream through a double-buffered cp.async ring, 32 samples a
//     stage, one barrier a stage (stage k + 1 loads while stage k computes).
//     Thread (fg, bg) holds frames fg + 16i and bins 4bg..4bg+3, re and im
//     of the same bins (32 accumulators): per 4 samples 4 float4 of audio
//     and 8 of bases for 128 FMAs. The epilogue writes the magnitude.
//  2. mel_log_kernel: magnitude x filterbank as a tiled GEMM, 64 frames x 32
//     mels a block, both operands through a double-buffered cp.async ring of
//     32-bin chunks; each block runs only the chunks where its 32 mels have a
//     nonzero weight (the wrapper's ranges), then the log clamp.
// The magnitude (3.8 MB for the clip, bins padded to the tile) makes one
// round trip through device memory between the two, about 2 us at 3.35 TB/s;
// fusing the mel product into the DFT kernel would leave one block per frame
// tile and most SMs idle.

#include <cuda_runtime.h>
#include <math.h>
#include <stddef.h>
#include <stdint.h>

namespace {

constexpr int FT = 64;        // frames per DFT block
constexpr int NT = 64;        // bins per DFT block (cos and sin each)
constexpr int KC = 32;        // samples per base stage
constexpr int THREADS = 256;  // 16 frame groups x 16 bin groups
constexpr int SKEW = 4;       // floats inserted after every hop samples of the span
constexpr int MF = 64;        // frames per mel block
constexpr int MM = 32;        // mels per mel block
constexpr int MK = 32;        // bins per mel stage
constexpr int MEL_THREADS = 128;  // 16 frame groups x 8 mel groups

__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool pred) {
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

__host__ __device__ inline int span_len(int n_fft, int hop) { return (FT - 1) * hop + n_fft; }

// shared bytes of dft_mag_kernel: bases x 2, the skewed span, the offset table
__host__ __device__ inline size_t dft_smem(int n_fft, int hop) {
  const int span = span_len(n_fft, hop);
  return sizeof(float) * (2 * KC * 2 * NT + span + SKEW * (span / hop) + SKEW) +
         sizeof(int) * (n_fft / 4);
}

__global__ void __launch_bounds__(THREADS, 2) dft_mag_kernel(
    const float* __restrict__ audio,  // (B, T)
    const float* __restrict__ W,      // (n_fft, n_tiles, 2 NT), window folded in
    float* __restrict__ mag,          // (B * n_frames, n_tiles * NT)
    int T, int n_frames, int n_fft, int hop, int n_tiles) {
  extern __shared__ __align__(16) float smem[];
  float* Ws = smem;                    // [2][KC][2 NT]
  float* span = Ws + 2 * KC * 2 * NT;  // skewed audio span
  const int slen = span_len(n_fft, hop);
  int* offs = reinterpret_cast<int*>(span + slen + SKEW * (slen / hop) + SKEW);

  const int tid = threadIdx.x;
  const int fg = tid / 16, bg = tid % 16;
  const int nt = blockIdx.x;
  const int tiles_f = (n_frames + FT - 1) / FT;
  const int b = blockIdx.y / tiles_f;
  const int f0 = (blockIdx.y % tiles_f) * FT;
  const size_t ldw = (size_t)n_tiles * 2 * NT;
  const float* Wt = W + nt * 2 * NT;

  auto load_w = [&](int k0, int buf) {
    float* dst = Ws + buf * KC * 2 * NT;
    for (int i = tid; i < KC * 2 * NT / 4; i += THREADS) {
      const int r = i / (2 * NT / 4), c = (i % (2 * NT / 4)) * 4;
      cp_async16(dst + r * 2 * NT + c, Wt + (k0 + r) * ldw + c, true);
    }
    cp_async_commit();
  };
  load_w(0, 0);

  // the span: positions f0 * hop .. + slen of the reflect-padded signal
  const int pad = n_fft / 2;
  const float* a = audio + (size_t)b * T;
  for (int i = tid; i < slen; i += THREADS) {
    const int p = f0 * hop + i;
    float x = 0.f;  // past the padded signal: only frames >= n_frames read it
    if (p < T + 2 * pad) {
      int s = p - pad;
      if (s < 0) s = -s;  // reflect (no edge repeat)
      if (s >= T) s = 2 * (T - 1) - s;
      x = __ldg(a + s);
    }
    span[i + SKEW * (i / hop)] = x;
  }
  // sample k of frame f0 + f sits at f (hop + SKEW) + offs[k / 4] + k % 4
  for (int g = tid; g < n_fft / 4; g += THREADS) offs[g] = 4 * g + SKEW * (4 * g / hop);

  float re[4][4], im[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) re[i][j] = im[i][j] = 0.f;

  const int stride_f = hop + SKEW;
  const int nk = n_fft / KC;
  for (int kc = 0; kc < nk; ++kc) {
    const int buf = kc & 1;
    cp_async_wait<0>();
    // stage kc (and, the first time, the span) in place; every warp is done
    // with stage kc - 1, so its buffer is free for stage kc + 1
    __syncthreads();
    if (kc + 1 < nk) load_w((kc + 1) * KC, buf ^ 1);
    const float* Wb = Ws + buf * KC * 2 * NT;
#pragma unroll
    for (int g = 0; g < KC / 4; ++g) {
      const int off = offs[kc * (KC / 4) + g];
      float4 av[4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
        av[i] = *reinterpret_cast<const float4*>(span + (fg + 16 * i) * stride_f + off);
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        const float4 c = *reinterpret_cast<const float4*>(Wb + (4 * g + kk) * 2 * NT + 4 * bg);
        const float4 s =
            *reinterpret_cast<const float4*>(Wb + (4 * g + kk) * 2 * NT + NT + 4 * bg);
        const float cv[4] = {c.x, c.y, c.z, c.w};
        const float sv[4] = {s.x, s.y, s.z, s.w};
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const float x = kk == 0 ? av[i].x : kk == 1 ? av[i].y : kk == 2 ? av[i].z : av[i].w;
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            re[i][j] = fmaf(x, cv[j], re[i][j]);
            im[i][j] = fmaf(x, sv[j], im[i][j]);
          }
        }
      }
    }
  }

  const size_t ldm = (size_t)n_tiles * NT;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int f = f0 + fg + 16 * i;
    if (f >= n_frames) continue;
    float4 m;
    m.x = sqrtf(re[i][0] * re[i][0] + im[i][0] * im[i][0]);
    m.y = sqrtf(re[i][1] * re[i][1] + im[i][1] * im[i][1]);
    m.z = sqrtf(re[i][2] * re[i][2] + im[i][2] * im[i][2]);
    m.w = sqrtf(re[i][3] * re[i][3] + im[i][3] * im[i][3]);
    *reinterpret_cast<float4*>(mag + ((size_t)b * n_frames + f) * ldm + nt * NT + 4 * bg) = m;
  }
}

__global__ void __launch_bounds__(MEL_THREADS) mel_log_kernel(
    const float* __restrict__ mag,    // (B * n_frames, ldm)
    const float* __restrict__ fbT,    // (ldm, n_mels), rows past n_bins zero
    const int* __restrict__ ranges,   // (n_mels / MM, 2): the chunks [c0, c1) to run
    float* __restrict__ out,          // (B * n_frames, n_mels)
    int n_frames, int ldm, int n_mels, float clamp) {
  __shared__ __align__(16) float Ms[2][MF][MK + 4];
  __shared__ __align__(16) float Fs[2][MK][MM];
  const int tid = threadIdx.x;
  const int fg = tid / 8, mg = tid % 8;  // frames fg + 16i, mels 4mg..4mg+3
  const int mt = blockIdx.x;
  const int tiles_f = (n_frames + MF - 1) / MF;
  const int b = blockIdx.y / tiles_f;
  const int f0 = (blockIdx.y % tiles_f) * MF;
  const int c0 = ranges[2 * mt], c1 = ranges[2 * mt + 1];
  const float* mrow = mag + (size_t)b * n_frames * ldm;

  auto load = [&](int c, int buf) {
    const int k0 = c * MK;
    for (int i = tid; i < MF * MK / 4; i += MEL_THREADS) {
      const int r = i / (MK / 4), cc = (i % (MK / 4)) * 4;
      const bool ok = f0 + r < n_frames;
      cp_async16(&Ms[buf][r][cc], mrow + (size_t)(ok ? f0 + r : 0) * ldm + k0 + cc, ok);
    }
    for (int i = tid; i < MK * MM / 4; i += MEL_THREADS) {
      const int r = i / (MM / 4), cc = (i % (MM / 4)) * 4;
      cp_async16(&Fs[buf][r][cc], fbT + (size_t)(k0 + r) * n_mels + mt * MM + cc, true);
    }
    cp_async_commit();
  };

  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;

  if (c0 < c1) load(c0, 0);
  for (int c = c0; c < c1; ++c) {
    const int buf = (c - c0) & 1;
    cp_async_wait<0>();
    __syncthreads();  // chunk c in place, chunk c - 1 consumed
    if (c + 1 < c1) load(c + 1, buf ^ 1);
#pragma unroll
    for (int k = 0; k < MK; k += 4) {
      float4 mv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) mv[i] = *reinterpret_cast<const float4*>(&Ms[buf][fg + 16 * i][k]);
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        const float4 f = *reinterpret_cast<const float4*>(&Fs[buf][k + kk][4 * mg]);
        const float fv[4] = {f.x, f.y, f.z, f.w};
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const float x = kk == 0 ? mv[i].x : kk == 1 ? mv[i].y : kk == 2 ? mv[i].z : mv[i].w;
#pragma unroll
          for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(x, fv[j], acc[i][j]);
        }
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int f = f0 + fg + 16 * i;
    if (f >= n_frames) continue;
    float4 o;
    o.x = logf(fmaxf(acc[i][0], clamp));
    o.y = logf(fmaxf(acc[i][1], clamp));
    o.z = logf(fmaxf(acc[i][2], clamp));
    o.w = logf(fmaxf(acc[i][3], clamp));
    *reinterpret_cast<float4*>(out + ((size_t)b * n_frames + f) * n_mels + mt * MM + 4 * mg) = o;
  }
}

// Both kernels' grids and the DFT kernel's shared bytes for audio (B, T):
// what rvc_log_mel launches and rvc_log_mel_plan reports.
struct Shape {
  int n_frames, n_tiles;
  dim3 dft_grid, mel_grid;
  size_t dft_smem;
};

Shape launch_shape(int B, int T, int n_fft, int hop, int n_mels) {
  Shape s;
  s.n_frames = 1 + T / hop;
  s.n_tiles = (n_fft / 2 + 1 + NT - 1) / NT;
  s.dft_grid = dim3(s.n_tiles, B * ((s.n_frames + FT - 1) / FT));
  s.mel_grid = dim3(n_mels / MM, B * ((s.n_frames + MF - 1) / MF));
  s.dft_smem = dft_smem(n_fft, hop);
  return s;
}

// the DFT kernel's shared memory limit raised to the card's opt-in maximum, once
cudaError_t smem_attr() {
  static const cudaError_t attr = [] {
    int dev = 0, optin = 0;
    cudaError_t err = cudaGetDevice(&dev);
    if (err == cudaSuccess)
      err = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
    if (err == cudaSuccess)
      err = cudaFuncSetAttribute(dft_mag_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                 optin);
    return err;
  }();
  return attr;
}

}  // namespace

// Grids for audio (B, T): plan = {DFT blocks, DFT blocks an SM, SMs, DFT
// shared bytes a block, mel blocks}. Returns a CUDA error.
extern "C" int rvc_log_mel_plan(int B, int T, int n_fft, int hop, int n_mels, int* plan) {
  const Shape s = launch_shape(B, T, n_fft, hop, n_mels);
  cudaError_t err = smem_attr();
  int dev = 0, sms = 0, per_sm = 0;
  if (err == cudaSuccess) err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, dft_mag_kernel, THREADS,
                                                        s.dft_smem);
  if (err != cudaSuccess) return (int)err;
  plan[0] = s.dft_grid.x * s.dft_grid.y;
  plan[1] = per_sm;
  plan[2] = sms;
  plan[3] = (int)s.dft_smem;
  plan[4] = s.mel_grid.x * s.mel_grid.y;
  return 0;
}

// audio (B, T) -> out (B, 1 + T / hop, n_mels). W: (n_fft, n_tiles, 128) with
// n_tiles = ceil((n_fft / 2 + 1) / 64); fbT: (64 n_tiles, n_mels); ranges:
// (n_mels / 32, 2) int32; mag: scratch of (B (1 + T / hop), 64 n_tiles)
// floats. Requires n_fft % 32 == 0, hop % 4 == 0, n_mels % 32 == 0 and
// T > n_fft / 2 (one reflection covers the pad). Returns cudaGetLastError().
extern "C" int rvc_log_mel(const float* audio, const float* W, const float* fbT,
                           const int* ranges, float* mag, float* out, int B, int T,
                           int n_fft, int hop, int n_mels, float clamp,
                           cudaStream_t stream) {
  if (n_fft % KC || hop % 4 || n_mels % MM || T <= n_fft / 2)
    return (int)cudaErrorInvalidValue;
  const Shape s = launch_shape(B, T, n_fft, hop, n_mels);
  cudaError_t err = smem_attr();
  if (err != cudaSuccess) return (int)err;
  dft_mag_kernel<<<s.dft_grid, THREADS, s.dft_smem, stream>>>(audio, W, mag, T, s.n_frames,
                                                              n_fft, hop, s.n_tiles);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  mel_log_kernel<<<s.mel_grid, MEL_THREADS, 0, stream>>>(mag, fbT, ranges, out, s.n_frames,
                                                         s.n_tiles * NT, n_mels, clamp);
  return (int)cudaGetLastError();
}
