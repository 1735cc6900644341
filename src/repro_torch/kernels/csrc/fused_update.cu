// Fused DSSP delayed-gradient apply for Hopper.
//
// Replaces the TPU kernel src/repro/kernels/fused_update.py
// (`_fused_update_kernel`, launched by `fused_update`):
//
//     m' = beta * m + scale * g        p' = p - lr * m'
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
