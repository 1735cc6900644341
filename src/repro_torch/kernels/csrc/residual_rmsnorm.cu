// Fused residual-add + RMSNorm for Hopper.
//
// Replaces the TPU kernel src/repro/kernels/residual_rmsnorm.py
// (`_residual_rmsnorm_kernel`, launched by `residual_rmsnorm`):
//
//     s = x + res  (f32)      out = s * (1 / sqrt(mean(s^2) + eps)) * w
//
// returning (s, out), both stored in x's dtype; the norm is taken of the
// f32 sum, not of its rounded copy.
//
// Bound on the H100: memory.  Two reads (x, res) and two writes (s, out)
// per element, so the least time is (4 * rows * d + d) * bytes / 3.35
// TB/s.  Same structure as rmsnorm.cu: one warp per row, 16-byte loads,
// a shuffle reduction of the sum of squares.  Pass 1 writes s; pass 2
// re-reads x and res (a few KB per row, served from L1/L2) and rebuilds
// the identical f32 sum rather than reading back the rounded s.

#include "common.cuh"

constexpr int kRowsPerBlock = 8;  // one warp per row

template <typename T, bool VEC>
__global__ void residual_rmsnorm_kernel(const T* __restrict__ x,
                                        const T* __restrict__ res,
                                        const T* __restrict__ w,
                                        T* __restrict__ s_out,
                                        T* __restrict__ out, int64_t rows,
                                        int d, float eps) {
  constexpr int N = Vec16<T>::N;
  const int lane = threadIdx.x & 31;
  const int64_t row = (int64_t)blockIdx.x * kRowsPerBlock + (threadIdx.x >> 5);
  if (row >= rows) return;
  const int64_t base = row * d;

  float ss = 0.f;
  if (VEC) {
    for (int c = lane * N; c < d; c += 32 * N) {
      float a[N], r[N];
      load16(x + base + c, a);
      load16(res + base + c, r);
#pragma unroll
      for (int k = 0; k < N; ++k) {
        a[k] = a[k] + r[k];
        ss += a[k] * a[k];
      }
      store16(s_out + base + c, a);
    }
  } else {
    for (int c = lane; c < d; c += 32) {
      const float a = to_f32(x[base + c]) + to_f32(res[base + c]);
      ss += a * a;
      s_out[base + c] = from_f32<T>(a);
    }
  }
  ss = warp_sum(ss);
  const float inv = 1.0f / sqrtf(ss / (float)d + eps);

  if (VEC) {
    for (int c = lane * N; c < d; c += 32 * N) {
      float a[N], r[N], wv[N];
      load16(x + base + c, a);
      load16(res + base + c, r);
      load16(w + c, wv);
#pragma unroll
      for (int k = 0; k < N; ++k) a[k] = ((a[k] + r[k]) * inv) * wv[k];
      store16(out + base + c, a);
    }
  } else {
    for (int c = lane; c < d; c += 32) {
      const float a = to_f32(x[base + c]) + to_f32(res[base + c]);
      out[base + c] = from_f32<T>((a * inv) * to_f32(w[c]));
    }
  }
}

template <typename T>
static cudaError_t launch_residual_rmsnorm(const void* x, const void* res,
                                           const void* w, void* s_out,
                                           void* out, int64_t rows, int d,
                                           float eps, cudaStream_t stream) {
  const bool vec = (d % Vec16<T>::N == 0) && aligned16(x) && aligned16(res) &&
                   aligned16(w) && aligned16(s_out) && aligned16(out);
  const int64_t blocks = (rows + kRowsPerBlock - 1) / kRowsPerBlock;
  if (vec)
    residual_rmsnorm_kernel<T, true>
        <<<(unsigned)blocks, 32 * kRowsPerBlock, 0, stream>>>(
            (const T*)x, (const T*)res, (const T*)w, (T*)s_out, (T*)out, rows,
            d, eps);
  else
    residual_rmsnorm_kernel<T, false>
        <<<(unsigned)blocks, 32 * kRowsPerBlock, 0, stream>>>(
            (const T*)x, (const T*)res, (const T*)w, (T*)s_out, (T*)out, rows,
            d, eps);
  return cudaGetLastError();
}

extern "C" int repro_residual_rmsnorm(const void* x, const void* res,
                                      const void* w, void* s_out, void* out,
                                      long long rows, int d, float eps,
                                      int dtype, int device, void* stream) {
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return (int)e;
  if (rows <= 0 || d <= 0) return (int)cudaSuccess;
  cudaStream_t s = (cudaStream_t)stream;
  switch (dtype) {
    case REPRO_F32:
      return (int)launch_residual_rmsnorm<float>(x, res, w, s_out, out, rows,
                                                 d, eps, s);
    case REPRO_BF16:
      return (int)launch_residual_rmsnorm<__nv_bfloat16>(x, res, w, s_out, out,
                                                         rows, d, eps, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}
