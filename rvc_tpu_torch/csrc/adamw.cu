// The training step's AdamW, CUDA C++ for sm_90a: one optimizer's whole
// update (sanitize, global norm, clip, Adam's moments, decoupled decay, the
// staircase learning rate, the gated count) in two launches.
//
// Replaces no TPU kernel. The JAX package's optimizer is optax's chain
// clip_by_global_norm(1.0) -> adamw inside the jitted train step
// (rvc_tpu/train/train_step.py : make_optimizers, sanitize_grads), which XLA
// fuses into a few loops over every leaf. The port ran it eagerly, one tensor
// at a time: ~30 launches a tensor, ~16,700 a training step of the 40 kHz
// model (G 423 tensors, D 110), each over a tensor the card finishes in
// microseconds, so the host's launches set the time. This kernel is that
// update as one pass over a table of every tensor of the optimizer. The same
// kernel serves ZeRO-1's ranks (parallel/train.py : ShardedAdamW), which
// update a slice of each large tensor: there the norm covers every gradient
// whole and the update only the rank's slices.
//
// What bounds it on the H100: bytes. Per parameter, pass 1 reads the
// gradient (4 B) and pass 2 reads gradient, parameter, both moments and
// writes parameter and moments: 28 B with a bf16 first moment, 32 with a
// float32 one, at ~10 flops. The 40 kHz G and D (107.8 M parameters) read
// and write ~3.0 GB, ~0.9 ms at 3.35 TB/s.
//
// Design:
//  - The wrapper lays out, once per optimizer, a table of tensors and one or
//    two tables of chunks of CHUNK elements (tensor, start); only the
//    gradients' pointers change from step to step, and the wrapper uploads
//    them each step, asynchronously, on the kernel's stream.
//  - A tensor's row describes the part of it this optimizer updates, its
//    view: rows of row_len contiguous elements, row_stride apart, from the
//    view's first element (g_off elements into the whole tensor). A whole
//    tensor, or a slice along dim 0, is one row; a slice along dim d of a
//    contiguous tensor has prod(shape[:d]) rows of n * prod(shape[d+1:])
//    elements, shape[d] * prod(shape[d+1:]) apart. Parameters and gradients
//    are read and written through the view; the moments are the view's own
//    contiguous tensors. The gradient is whole (g_n elements).
//  - Two chunk tables: pass 1 reads every gradient whole by the first, pass
//    2 updates the views by the second. One optimizer of a single card, whose
//    views are whole, gives the same rows in both. On ZeRO-1's ranks every rank
//    holds the same all-reduced gradients and the same first table, so every
//    rank derives the same norm bit for bit. Where the norm needs a
//    collective (tensor parallelism) the wrapper gives it, and pass 1 only
//    derives the step's scalars from it.
//  - Pass 1 (norm_kernel), a persistent grid over the chunks: each block
//    reads a chunk's gradients (float4 where aligned, scalar tails),
//    sanitizes them (NaN -> 0, +-inf and beyond -> +-1e3) and writes the
//    chunk's float32 sum of squares. The last block to finish (an integer
//    ticket, no float atomics) sums the chunks' sums in a fixed order in
//    double, so a step is deterministic, and derives in float32, in
//    AdamW.step's order, the norm, the clip decision, the learning rate of
//    the count (floor(count / steps_per_epoch) decays), both bias
//    corrections of count + 1 and whether the gate lets the step through;
//    it advances the count (gated) and resets the ticket.
//  - Pass 2 (update_kernel), a persistent grid over the second table: each
//    block reads those scalars and, where the gate allows, updates its chunks in one read and one
//    write of parameter, first moment (bf16 or float32) and second moment,
//    re-sanitizing the gradient as it reads it (cheaper than writing it back
//    in pass 1). Four elements of a view go as one float4 wherever its rows
//    allow it (row_len and row_stride multiples of 4, the view aligned); a
//    view of several rows divides each element's index by row_len to find
//    its row. Every operation rounds as PyTorch's eager ops do (no fused
//    multiply-add: __fmul_rn / __fadd_rn), so the kernel gives the plain
//    version's numbers but for the order of the norm's sum.
// Nothing is read back to the host.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>
#include <string.h>

namespace {

constexpr int THREADS = 256;
constexpr float CLIP = 1e3f;  // sanitize_grads' bound

struct TensorRef {   // one optimizer tensor: the wrapper's table row (8 x int64)
  float* p;          // the view's first element
  void* mu;          // bf16 or float32, as the launch says; n contiguous elements
  float* nu;
  long long n;       // elements of the view
  long long row_len, row_stride;   // the view's rows (one row: row_len == n)
  long long g_off;   // the view's first element within the gradient
  long long g_n;     // elements of the (whole) gradient
};

struct Chunk {       // the wrapper's chunk table row (2 x int32)
  int tensor;
  int start;
};

struct Hyper {
  float lr, decay_rate, b1, b2, c1, c2, b1_mu, eps, weight_decay, max_norm;
  int steps_per_epoch, chunk;
};

// Pass 1 -> pass 2, in device memory.
enum { S_NORM, S_APPLY, S_KEEP, S_NEG_LR, S_BC1, S_BC2, N_SCALARS };

__device__ __forceinline__ float sanitize(float x) {
  return x != x ? 0.f : fminf(fmaxf(x, -CLIP), CLIP);
}

// Sum over the block in a fixed order; the result is valid in thread 0.
// `red` holds THREADS / 32 slots and is free again on return.
template <typename T>
__device__ __forceinline__ T block_sum(T v, T* red) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  if (lane == 0) red[warp] = v;
  __syncthreads();
  if (warp == 0) {
    v = lane < THREADS / 32 ? red[lane] : T(0);
    for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  }
  __syncthreads();
  return v;
}

__device__ __forceinline__ int chunk_len(const Chunk& c, long long n, int chunk) {
  return (int)min((long long)chunk, n - c.start);
}

__global__ void __launch_bounds__(THREADS)
norm_kernel(const TensorRef* __restrict__ tensors, const float* const* __restrict__ grads,
            const Chunk* __restrict__ chunks, int n_chunks, float* __restrict__ partials,
            unsigned* ticket, int* count, const bool* gate, const float* norm_in, Hyper h,
            float* scalars, float* norm_out) {
  __shared__ float red[THREADS / 32];
  __shared__ double red_d[THREADS / 32];
  __shared__ bool last;
  for (int c = blockIdx.x; c < n_chunks; c += gridDim.x) {
    const Chunk ck = chunks[c];
    const int len = chunk_len(ck, tensors[ck.tensor].g_n, h.chunk);
    const float* g = grads[ck.tensor] + ck.start;
    float acc = 0.f;
    int head = 0;
    if ((reinterpret_cast<uintptr_t>(g) & 15) == 0) {
      head = len & ~3;
      const float4* g4 = reinterpret_cast<const float4*>(g);
      for (int i = threadIdx.x; i < (len >> 2); i += THREADS) {
        const float4 x = g4[i];
        const float a = sanitize(x.x), b = sanitize(x.y), d = sanitize(x.z), e = sanitize(x.w);
        acc = fmaf(a, a, acc);
        acc = fmaf(b, b, acc);
        acc = fmaf(d, d, acc);
        acc = fmaf(e, e, acc);
      }
    }
    for (int i = head + threadIdx.x; i < len; i += THREADS) {
      const float a = sanitize(g[i]);
      acc = fmaf(a, a, acc);
    }
    acc = block_sum(acc, red);
    if (threadIdx.x == 0) partials[c] = acc;
  }
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0) last = atomicAdd(ticket, 1u) == gridDim.x - 1;
  __syncthreads();
  if (!last) return;
  __threadfence();
  double s = 0.0;
  for (int c = threadIdx.x; c < n_chunks; c += THREADS) s += (double)__ldcg(partials + c);
  s = block_sum(s, red_d);
  if (threadIdx.x != 0) return;
  // AdamW.step's scalars, float32, in its order
  const float norm = norm_in != nullptr ? *norm_in : sqrtf((float)s);
  const int c0 = *count;
  const float e = floorf(__fdiv_rn((float)c0, (float)h.steps_per_epoch));
  const float lr = c0 <= 0 ? h.lr : __fmul_rn(h.lr, powf(h.decay_rate, e));
  const float cn = (float)(c0 + 1);
  const bool apply = gate == nullptr || *gate;
  scalars[S_NORM] = norm;
  *norm_out = norm;
  scalars[S_APPLY] = apply ? 1.f : 0.f;
  scalars[S_KEEP] = norm < h.max_norm ? 1.f : 0.f;
  scalars[S_NEG_LR] = -lr;
  scalars[S_BC1] = __fsub_rn(1.f, powf(h.b1, cn));
  scalars[S_BC2] = __fsub_rn(1.f, powf(h.b2, cn));
  if (apply) *count = c0 + 1;
  *ticket = 0u;
}

__device__ __forceinline__ float4 load4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}
__device__ __forceinline__ float4 load4(const __nv_bfloat16* p) {
  const uint2 raw = *reinterpret_cast<const uint2*>(p);
  __nv_bfloat162 lo, hi;
  memcpy(&lo, &raw.x, 4);
  memcpy(&hi, &raw.y, 4);
  const float2 a = __bfloat1622float2(lo), b = __bfloat1622float2(hi);
  return make_float4(a.x, a.y, b.x, b.y);
}
__device__ __forceinline__ void store4(float* p, float4 v) {
  *reinterpret_cast<float4*>(p) = v;
}
__device__ __forceinline__ void store4(__nv_bfloat16* p, float4 v) {
  const __nv_bfloat162 lo = __floats2bfloat162_rn(v.x, v.y), hi = __floats2bfloat162_rn(v.z, v.w);
  uint2 raw;
  memcpy(&raw.x, &lo, 4);
  memcpy(&raw.y, &hi, 4);
  *reinterpret_cast<uint2*>(p) = raw;
}
__device__ __forceinline__ float load1(const float* p) { return *p; }
__device__ __forceinline__ float load1(const __nv_bfloat16* p) { return __bfloat162float(*p); }
__device__ __forceinline__ void store1(float* p, float v) { *p = v; }
__device__ __forceinline__ void store1(__nv_bfloat16* p, float v) { *p = __float2bfloat16_rn(v); }

struct Step {        // the scalars of this step, in registers
  float norm, neg_lr, bc1, bc2;
  bool keep;
};

// One element: AdamW.step's arithmetic on the sanitized gradient, rounding
// after every operation as the eager ops do. m and v come in as the stored
// moments and leave as the new ones.
__device__ __forceinline__ void update(float g, float& p, float& m, float& v, const Step& s,
                                       const Hyper& h) {
  g = sanitize(g);
  if (!s.keep) g = __fmul_rn(__fdiv_rn(g, s.norm), h.max_norm);
  m = __fadd_rn(__fmul_rn(h.c1, g), __fmul_rn(h.b1_mu, m));
  v = __fadd_rn(__fmul_rn(h.c2, __fmul_rn(g, g)), __fmul_rn(h.b2, v));
  const float den = __fadd_rn(__fsqrt_rn(__fdiv_rn(v, s.bc2)), h.eps);
  const float u = __fadd_rn(__fdiv_rn(__fdiv_rn(m, s.bc1), den), __fmul_rn(h.weight_decay, p));
  p = __fadd_rn(p, __fmul_rn(s.neg_lr, u));
}

// Elements [start, start + len) of a view: element j lies at j in the
// moments (mu, nu: the view's own) and, from the view's first element in the
// parameter and the gradient, at j in a one-row view, at (j / row_len) *
// row_stride + j % row_len in a view of several rows (STRIDED).
template <typename M, bool STRIDED>
__device__ __forceinline__ void update_span(const float* g, float* p, M* mu, float* nu,
                                            int start, int len, int row_len, int row_stride,
                                            const Step& s, const Hyper& h) {
  auto at = [&](int j) { return STRIDED ? j + (j / row_len) * (row_stride - row_len) : j; };
  mu += start;
  nu += start;
  int head = 0;
  if (((reinterpret_cast<uintptr_t>(g + at(start)) | reinterpret_cast<uintptr_t>(p + at(start)) |
        reinterpret_cast<uintptr_t>(nu)) & 15) == 0 &&
      (reinterpret_cast<uintptr_t>(mu) & (4 * sizeof(M) - 1)) == 0 &&
      (!STRIDED || ((row_len | row_stride) & 3) == 0)) {
    head = len & ~3;
    for (int i = 4 * threadIdx.x; i < head; i += 4 * THREADS) {
      const int o = at(start + i);   // four elements of one row
      const float4 gv = load4(g + o);
      float4 pv = load4(p + o), mv = load4(mu + i), vv = load4(nu + i);
      update(gv.x, pv.x, mv.x, vv.x, s, h);
      update(gv.y, pv.y, mv.y, vv.y, s, h);
      update(gv.z, pv.z, mv.z, vv.z, s, h);
      update(gv.w, pv.w, mv.w, vv.w, s, h);
      store4(p + o, pv);
      store4(mu + i, mv);
      store4(nu + i, vv);
    }
  }
  for (int i = head + threadIdx.x; i < len; i += THREADS) {
    const int o = at(start + i);
    float pv = p[o], mv = load1(mu + i), vv = nu[i];
    update(g[o], pv, mv, vv, s, h);
    p[o] = pv;
    store1(mu + i, mv);
    nu[i] = vv;
  }
}

template <typename M>
__global__ void __launch_bounds__(THREADS)
update_kernel(const TensorRef* __restrict__ tensors, const float* const* __restrict__ grads,
              const Chunk* __restrict__ chunks, int n_chunks, const float* __restrict__ scalars,
              Hyper h) {
  if (scalars[S_APPLY] == 0.f) return;
  const Step s{scalars[S_NORM], scalars[S_NEG_LR], scalars[S_BC1], scalars[S_BC2],
               scalars[S_KEEP] != 0.f};
  for (int c = blockIdx.x; c < n_chunks; c += gridDim.x) {
    const Chunk ck = chunks[c];
    const TensorRef t = tensors[ck.tensor];
    const int len = chunk_len(ck, t.n, h.chunk);
    const float* g = grads[ck.tensor] + t.g_off;
    M* mu = static_cast<M*>(t.mu);
    if (t.row_len == t.n)
      update_span<M, false>(g, t.p, mu, t.nu, ck.start, len, 0, 0, s, h);
    else
      update_span<M, true>(g, t.p, mu, t.nu, ck.start, len, (int)t.row_len, (int)t.row_stride,
                           s, h);
  }
}

// Blocks of a persistent grid over n_chunks: every SM's resident blocks of
// the kernel, at most one a chunk, at least one.
template <typename K>
cudaError_t grid_for(K kernel, int n_chunks, int* blocks) {
  int dev = 0, sms = 0, per_sm = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, THREADS, 0);
  if (err != cudaSuccess) return err;
  *blocks = max(1, min(n_chunks, sms * max(per_sm, 1)));
  return cudaSuccess;
}

template <typename M>
int run(const TensorRef* tensors, const float* const* grads, const Chunk* chunks, int n_chunks,
        const Chunk* update_chunks, int n_update_chunks, float* partials, unsigned* ticket,
        int* count, const bool* gate, const float* norm_in, float* scalars, float* norm_out,
        const Hyper& h, cudaStream_t stream) {
  if (norm_in != nullptr) n_chunks = 0;   // the norm is given: pass 1 reads no gradient
  int norm_blocks = 0, update_blocks = 0;
  cudaError_t err = grid_for(norm_kernel, n_chunks, &norm_blocks);
  if (err == cudaSuccess) err = grid_for(update_kernel<M>, n_update_chunks, &update_blocks);
  if (err != cudaSuccess) return (int)err;
  norm_kernel<<<norm_blocks, THREADS, 0, stream>>>(tensors, grads, chunks, n_chunks, partials,
                                                   ticket, count, gate, norm_in, h, scalars,
                                                   norm_out);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  update_kernel<M><<<update_blocks, THREADS, 0, stream>>>(tensors, grads, update_chunks,
                                                          n_update_chunks, scalars, h);
  return (int)cudaGetLastError();
}

}  // namespace

// One AdamW step of an optimizer's tensors. tensors: (n_tensors, 8) int64
// rows (parameter view's first element, first moment, second moment, the
// view's size, row_len, row_stride, the view's offset in the gradient, the
// gradient's size; see TensorRef), parameters and second moments float32,
// first moments bf16 if mu_bf16, else float32; grads: n_tensors pointers to
// contiguous float32 gradients, whole; chunks: (n_chunks, 2) int32 rows
// (tensor, start) over the gradients, start a multiple of `chunk` within
// its gradient (a multiple of 4); update_chunks: the same over the views
// (n_update_chunks rows);
// partials: n_chunks floats; ticket: one unsigned, 0 before the first
// launch (the kernel leaves it 0); count: the int32 step count, advanced
// where the gate allows; gate: a bool on the device, or null for none;
// norm_in: the global norm on the device, or null to compute it from the
// gradients; scalars: N_SCALARS floats of scratch; norm_out: one float, the
// norm. hyper (host): lr, decay_rate, b1, b2, 1 - b1, 1 - b2, b1 in the
// first moment's type, eps, weight decay, max norm. Two launches, no
// synchronisation. Returns cudaGetLastError().
extern "C" int rvc_adamw(const void* tensors, const void* grads, const void* chunks,
                         int n_chunks, const void* update_chunks, int n_update_chunks, int chunk,
                         float* partials, unsigned* ticket, int* count, const bool* gate,
                         const float* norm_in, float* scalars, float* norm_out, int mu_bf16,
                         int steps_per_epoch, const float* hyper, cudaStream_t stream) {
  if (chunk <= 0 || chunk % 4 || steps_per_epoch <= 0 || n_chunks < 0 || n_update_chunks < 0 ||
      update_chunks == nullptr)
    return (int)cudaErrorInvalidValue;
  const Hyper h{hyper[0], hyper[1], hyper[2], hyper[3], hyper[4], hyper[5], hyper[6],
                hyper[7], hyper[8], hyper[9], steps_per_epoch, chunk};
  const auto* t = static_cast<const TensorRef*>(tensors);
  const auto* g = static_cast<const float* const*>(grads);
  const auto* c = static_cast<const Chunk*>(chunks);
  const auto* u = static_cast<const Chunk*>(update_chunks);
  return mu_bf16 ? run<__nv_bfloat16>(t, g, c, n_chunks, u, n_update_chunks, partials, ticket,
                                      count, gate, norm_in, scalars, norm_out, h, stream)
                 : run<float>(t, g, c, n_chunks, u, n_update_chunks, partials, ticket, count,
                              gate, norm_in, scalars, norm_out, h, stream);
}
