// Fused DSSP delayed-gradient apply for Hopper.
//
// Replaces two TPU kernels of src/repro/kernels/fused_update.py:
// `_fused_update_kernel` (launched by `fused_update`)
//
//     m' = beta * m + scale * g        p' = p - lr * m'
//
// and `_fused_update_batched_kernel` (launched by `fused_update_batched`),
// which folds K gradients g_0..g_{K-1}, each with its own scale, through
// that step in enqueue order in one pass (see the batched kernel below).
//
// in f32 over f32 or bf16 storage, writing NEW output buffers (the server
// keeps pulled snapshots of the old ones).  `lr` and `scale` are kernel
// arguments, so changing them neither rebuilds nor changes the launch.
//
// Bound on the H100: memory.  Five accesses per element (read p, m, g;
// write p', m') against 4 flops, far below the card's ~295 flop/byte
// balance point, so the least time is bytes / 3.35 TB/s.  The design
// streams each element exactly once with 16-byte vector accesses in a
// grid-stride loop, and keeps nothing in shared memory.
//
// The arithmetic is written with __fmul_rn/__fadd_rn/__fsub_rn so nvcc
// cannot contract it into FMAs: the result is then bit for bit the
// uncontracted plain version (kernels/ref.py `fused_update_ref`), in f32
// and in bf16.

#include "common.cuh"

__device__ __forceinline__ void momentum_step(float& p, float& m, float g,
                                              float lr, float beta,
                                              float scale) {
  const float mf = __fadd_rn(__fmul_rn(beta, m), __fmul_rn(scale, g));
  p = __fsub_rn(p, __fmul_rn(lr, mf));
  m = mf;
}

template <typename T>
__global__ void fused_update_vec_kernel(const T* __restrict__ p,
                                        const T* __restrict__ m,
                                        const T* __restrict__ g,
                                        T* __restrict__ po,
                                        T* __restrict__ mo, int64_t nvec,
                                        float lr, float beta, float scale) {
  constexpr int N = Vec16<T>::N;
  const int64_t stride = (int64_t)gridDim.x * blockDim.x;
  for (int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; i < nvec;
       i += stride) {
    float pv[N], mv[N], gv[N];
    load16(p + i * N, pv);
    load16(m + i * N, mv);
    load16(g + i * N, gv);
#pragma unroll
    for (int k = 0; k < N; ++k) momentum_step(pv[k], mv[k], gv[k], lr, beta, scale);
    store16(po + i * N, pv);
    store16(mo + i * N, mv);
  }
}

template <typename T>
__global__ void fused_update_scalar_kernel(const T* __restrict__ p,
                                           const T* __restrict__ m,
                                           const T* __restrict__ g,
                                           T* __restrict__ po,
                                           T* __restrict__ mo, int64_t n,
                                           float lr, float beta,
                                           float scale) {
  const int64_t stride = (int64_t)gridDim.x * blockDim.x;
  for (int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; i < n;
       i += stride) {
    float pv = to_f32(p[i]), mv = to_f32(m[i]);
    momentum_step(pv, mv, to_f32(g[i]), lr, beta, scale);
    po[i] = from_f32<T>(pv);
    mo[i] = from_f32<T>(mv);
  }
}

template <typename T>
static cudaError_t launch_fused_update(const void* p, const void* m,
                                       const void* g, void* po, void* mo,
                                       int64_t n, float lr, float beta,
                                       float scale, cudaStream_t stream) {
  constexpr int kThreads = 256;
  constexpr int64_t kMaxBlocks = 132 * 16;  // a few waves of the 132 SMs
  constexpr int N = Vec16<T>::N;
  const bool vec = (n % N == 0) && aligned16(p) && aligned16(m) &&
                   aligned16(g) && aligned16(po) && aligned16(mo);
  const int64_t work = vec ? n / N : n;
  int64_t blocks = (work + kThreads - 1) / kThreads;
  if (blocks > kMaxBlocks) blocks = kMaxBlocks;
  if (vec) {
    fused_update_vec_kernel<T><<<(unsigned)blocks, kThreads, 0, stream>>>(
        (const T*)p, (const T*)m, (const T*)g, (T*)po, (T*)mo, work, lr, beta,
        scale);
  } else {
    fused_update_scalar_kernel<T><<<(unsigned)blocks, kThreads, 0, stream>>>(
        (const T*)p, (const T*)m, (const T*)g, (T*)po, (T*)mo, work, lr, beta,
        scale);
  }
  return cudaGetLastError();
}

// ---------------------------------------------------------------- batched
//
// The coalesced apply: K contributions of one server window fold in one
// launch.  Per element, for j = 0..K-1:
//
//     mf = beta * m + scale_j * g_j     p = round(p - lr * mf)
//     m  = round(mf)
//
// where round() narrows to the storage type and widens back: p is updated
// with the UNROUNDED f32 momentum, exactly as a standalone launch does,
// and only the carried p and m are rounded, as the store + reload between
// two launches would round them.  So the result is bit for bit K
// sequential `fused_update` launches (kernels/ref.py
// `fused_update_batched_ref`), in f32 and bf16.
//
// Bound: memory.  (2 + K) reads and 2 writes per element instead of the
// 5K of K launches.  The K gradient regions arrive as a pointer array
// (the server's queued regions, no stacked copy) with their scales in a
// kernel argument, so neither K's pointers nor the scales cost a copy to
// the device, and changing a scale or lr rebuilds nothing.

constexpr int kMaxBatch = 32;  // contributions per launch (wrapper chunks)

struct BatchArgs {
  const void* g[kMaxBatch];
  float scale[kMaxBatch];
  int k;
};

template <typename T>
__device__ __forceinline__ float round_to(float x) {
  return to_f32(from_f32<T>(x));
}

template <typename T>
__global__ void fused_update_batched_vec_kernel(const T* __restrict__ p,
                                                const T* __restrict__ m,
                                                T* __restrict__ po,
                                                T* __restrict__ mo,
                                                int64_t nvec, float lr,
                                                float beta, BatchArgs b) {
  constexpr int N = Vec16<T>::N;
  const int64_t stride = (int64_t)gridDim.x * blockDim.x;
  for (int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; i < nvec;
       i += stride) {
    float pv[N], mv[N], gv[N];
    load16(p + i * N, pv);
    load16(m + i * N, mv);
    // Unrolled over the static maximum so every pointer and scale is read
    // from the parameter space at a constant offset.
#pragma unroll
    for (int j = 0; j < kMaxBatch; ++j) {
      if (j >= b.k) break;
      load16(reinterpret_cast<const T*>(b.g[j]) + i * N, gv);
#pragma unroll
      for (int e = 0; e < N; ++e) {
        momentum_step(pv[e], mv[e], gv[e], lr, beta, b.scale[j]);
        pv[e] = round_to<T>(pv[e]);
        mv[e] = round_to<T>(mv[e]);
      }
    }
    store16(po + i * N, pv);
    store16(mo + i * N, mv);
  }
}

template <typename T>
__global__ void fused_update_batched_scalar_kernel(const T* __restrict__ p,
                                                   const T* __restrict__ m,
                                                   T* __restrict__ po,
                                                   T* __restrict__ mo,
                                                   int64_t n, float lr,
                                                   float beta, BatchArgs b) {
  const int64_t stride = (int64_t)gridDim.x * blockDim.x;
  for (int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; i < n;
       i += stride) {
    float pv = to_f32(p[i]), mv = to_f32(m[i]);
#pragma unroll
    for (int j = 0; j < kMaxBatch; ++j) {
      if (j >= b.k) break;
      momentum_step(pv, mv, to_f32(reinterpret_cast<const T*>(b.g[j])[i]),
                    lr, beta, b.scale[j]);
      pv = round_to<T>(pv);
      mv = round_to<T>(mv);
    }
    po[i] = from_f32<T>(pv);
    mo[i] = from_f32<T>(mv);
  }
}

template <typename T>
static cudaError_t launch_fused_update_batched(const void* p, const void* m,
                                               const BatchArgs& b, void* po,
                                               void* mo, int64_t n, float lr,
                                               float beta,
                                               cudaStream_t stream) {
  constexpr int kThreads = 256;
  constexpr int64_t kMaxBlocks = 132 * 16;
  constexpr int N = Vec16<T>::N;
  bool vec = (n % N == 0) && aligned16(p) && aligned16(m) && aligned16(po) &&
             aligned16(mo);
  for (int j = 0; j < b.k; ++j) vec = vec && aligned16(b.g[j]);
  const int64_t work = vec ? n / N : n;
  int64_t blocks = (work + kThreads - 1) / kThreads;
  if (blocks > kMaxBlocks) blocks = kMaxBlocks;
  if (vec) {
    fused_update_batched_vec_kernel<T><<<(unsigned)blocks, kThreads, 0,
                                         stream>>>(
        (const T*)p, (const T*)m, (T*)po, (T*)mo, work, lr, beta, b);
  } else {
    fused_update_batched_scalar_kernel<T><<<(unsigned)blocks, kThreads, 0,
                                            stream>>>(
        (const T*)p, (const T*)m, (T*)po, (T*)mo, work, lr, beta, b);
  }
  return cudaGetLastError();
}

// gs: host array of k device pointers; scales: host array of k floats.
extern "C" int repro_fused_update_batched(const void* p, const void* m,
                                          const void* const* gs,
                                          const float* scales, int k,
                                          void* po, void* mo, long long n,
                                          float lr, float beta, int dtype,
                                          int device, void* stream) {
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return (int)e;
  if (k < 1 || k > kMaxBatch) return (int)cudaErrorInvalidValue;
  if (n <= 0) return (int)cudaSuccess;
  BatchArgs b;
  b.k = k;
  for (int j = 0; j < k; ++j) {
    b.g[j] = gs[j];
    b.scale[j] = scales[j];
  }
  cudaStream_t s = (cudaStream_t)stream;
  switch (dtype) {
    case REPRO_F32:
      return (int)launch_fused_update_batched<float>(p, m, b, po, mo, n, lr,
                                                     beta, s);
    case REPRO_BF16:
      return (int)launch_fused_update_batched<__nv_bfloat16>(
          p, m, b, po, mo, n, lr, beta, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

extern "C" int repro_fused_update(const void* p, const void* m, const void* g,
                                  void* po, void* mo, long long n, float lr,
                                  float beta, float scale, int dtype,
                                  int device, void* stream) {
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return (int)e;
  if (n <= 0) return (int)cudaSuccess;
  cudaStream_t s = (cudaStream_t)stream;
  switch (dtype) {
    case REPRO_F32:
      return (int)launch_fused_update<float>(p, m, g, po, mo, n, lr, beta,
                                             scale, s);
    case REPRO_BF16:
      return (int)launch_fused_update<__nv_bfloat16>(p, m, g, po, mo, n, lr,
                                                     beta, scale, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}
