// Fused RMSNorm for Hopper.
//
// Replaces the TPU kernel src/repro/kernels/rmsnorm.py (`_rmsnorm_kernel`,
// launched by `rmsnorm`):  out = x * (1 / sqrt(mean(x^2) + eps)) * w,
// row by row over a (rows, d) view, reducing in f32, stored in x's dtype.
//
// Bound on the H100: memory.  A handful of flops per element against one
// read of x and one write of out (w is d elements, read from cache), so
// the least time is (2 * rows * d + d) * bytes / 3.35 TB/s.  One warp
// owns one row: pass 1 streams the row with 16-byte loads and reduces
// the sum of squares with warp shuffles (no shared memory, no block
// barrier); pass 2 reads the row again -- it is at most a few KB, so it
// comes from L1/L2, not device memory -- and writes the normed row.  The
// inverse is 1 / sqrtf(...) with IEEE sqrt and division, not the
// approximate rsqrtf.  A row length that is not a whole number of
// 16-byte vectors, or a misaligned buffer, takes the scalar path.

#include "common.cuh"

constexpr int kRowsPerBlock = 8;  // one warp per row

template <typename T, bool VEC>
__global__ void rmsnorm_kernel(const T* __restrict__ x,
                               const T* __restrict__ w, T* __restrict__ out,
                               int64_t rows, int d, float eps) {
  constexpr int N = Vec16<T>::N;
  const int lane = threadIdx.x & 31;
  const int64_t row = (int64_t)blockIdx.x * kRowsPerBlock + (threadIdx.x >> 5);
  if (row >= rows) return;
  const T* xr = x + row * d;
  T* orow = out + row * d;

  float ss = 0.f;
  if (VEC) {
    for (int c = lane * N; c < d; c += 32 * N) {
      float a[N];
      load16(xr + c, a);
#pragma unroll
      for (int k = 0; k < N; ++k) ss += a[k] * a[k];
    }
  } else {
    for (int c = lane; c < d; c += 32) {
      const float a = to_f32(xr[c]);
      ss += a * a;
    }
  }
  ss = warp_sum(ss);
  const float inv = 1.0f / sqrtf(ss / (float)d + eps);

  if (VEC) {
    for (int c = lane * N; c < d; c += 32 * N) {
      float a[N], wv[N];
      load16(xr + c, a);
      load16(w + c, wv);
#pragma unroll
      for (int k = 0; k < N; ++k) a[k] = (a[k] * inv) * wv[k];
      store16(orow + c, a);
    }
  } else {
    for (int c = lane; c < d; c += 32)
      orow[c] = from_f32<T>((to_f32(xr[c]) * inv) * to_f32(w[c]));
  }
}

template <typename T>
static cudaError_t launch_rmsnorm(const void* x, const void* w, void* out,
                                  int64_t rows, int d, float eps,
                                  cudaStream_t stream) {
  const bool vec = (d % Vec16<T>::N == 0) && aligned16(x) && aligned16(w) &&
                   aligned16(out);
  const int64_t blocks = (rows + kRowsPerBlock - 1) / kRowsPerBlock;
  if (vec)
    rmsnorm_kernel<T, true><<<(unsigned)blocks, 32 * kRowsPerBlock, 0, stream>>>(
        (const T*)x, (const T*)w, (T*)out, rows, d, eps);
  else
    rmsnorm_kernel<T, false><<<(unsigned)blocks, 32 * kRowsPerBlock, 0, stream>>>(
        (const T*)x, (const T*)w, (T*)out, rows, d, eps);
  return cudaGetLastError();
}

extern "C" int repro_rmsnorm(const void* x, const void* w, void* out,
                             long long rows, int d, float eps, int dtype,
                             int device, void* stream) {
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return (int)e;
  if (rows <= 0 || d <= 0) return (int)cudaSuccess;
  cudaStream_t s = (cudaStream_t)stream;
  switch (dtype) {
    case REPRO_F32:
      return (int)launch_rmsnorm<float>(x, w, out, rows, d, eps, s);
    case REPRO_BF16:
      return (int)launch_rmsnorm<__nv_bfloat16>(x, w, out, rows, d, eps, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}
