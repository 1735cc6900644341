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
// per element, and w once: (4 * rows * d + d) * bytes / 3.35 TB/s.
//
// The register path (16-byte aligned buffers, d a whole number of 16-byte
// vectors, d within the instantiated widths) reads each row once: W warps
// own a row (W = 1, 2, 4 or 8, the fewest that leave each lane at most
// NV = 10 vectors), and lane l of warp w takes the row's 16-byte vectors
// v = i * 32W + 32w + l for i < NV.  All of a lane's loads of x and res
// are issued at once (2 NV in flight; 20 at d = 2560 bf16), the f32 sum
// s = x + res stays in registers (NV * 16 / size floats), s is written,
// the sum of squares is reduced (each lane in order of i and then of the
// vector's elements, by FMA; a shuffle butterfly over the warp; the W
// warp sums in order of w through shared memory), and out is computed
// from the same registers and written.  Nothing is read twice from
// memory: x and res are read once and s and out written once (4 * rows *
// d elements), and w (d elements) is read by every row but from L1/L2,
// so device memory moves (4 * rows * d + d) * size bytes, the bound's
// count.  NV is a template parameter, instantiated at 1, 2, 4, 8 and 10;
// a lane whose vector index passes the row's end is idle.  The widths the paths use land on:
//   d = 2560 bf16: W = 1, NV = 10      d = 2560 f32: W = 2, NV = 10
//   d = 4096 bf16: W = 2, NV = 8       d = 4096 f32: W = 4, NV = 8
//   d = 64 (the smoke configs) f32: W = 1, NV = 1 (16 of 32 lanes)
// Blocks hold 8 / W rows (256 threads).
//
// The loop path keeps the rest: a d that is not a whole number of 16-byte
// vectors or a misaligned buffer (one element a lane), and rows wider
// than 8 warps x 10 vectors (10,240 f32, 20,480 bf16; 16-byte vectors):
// one warp per row, pass 1 writes s and sums squares, pass 2 re-reads x
// and res (from L1/L2) and rebuilds the same f32 sum.

#include "common.cuh"

constexpr int kMaxNV = 10;      // 16-byte vectors a lane holds, at most
constexpr int kBlockThreads = 256;

// ---------------------------------------------------------- register path
template <typename T, int NV>
__global__ void __launch_bounds__(kBlockThreads)
    residual_rmsnorm_regs(const T* __restrict__ x, const T* __restrict__ res,
                          const T* __restrict__ w, T* __restrict__ s_out,
                          T* __restrict__ out, int64_t rows, int d, int W,
                          float eps) {
  constexpr int N = Vec16<T>::N;
  __shared__ float red[kBlockThreads / 32];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int rows_per_block = (kBlockThreads / 32) / W;
  const int wr = warp % W;               // this warp's place in its row
  const int rb = warp / W;               // this row's place in the block
  const int64_t row = (int64_t)blockIdx.x * rows_per_block + rb;
  const bool live_row = row < rows;
  const int nvec = d / N;
  const int64_t base = row * d;
  const int stride = 32 * W;             // vectors between a lane's loads
  const int v0 = wr * 32 + lane;

  // all loads first: x and res of every vector of this lane
  uint4 rx[NV], rr[NV];
#pragma unroll
  for (int i = 0; i < NV; ++i) {
    const int v = v0 + i * stride;
    if (live_row && v < nvec) {
      rx[i] = *reinterpret_cast<const uint4*>(x + base + (int64_t)v * N);
      rr[i] = *reinterpret_cast<const uint4*>(res + base + (int64_t)v * N);
    } else {
      rx[i] = rr[i] = make_uint4(0u, 0u, 0u, 0u);
    }
  }
  float sv[NV][N];
  float ss = 0.f;
#pragma unroll
  for (int i = 0; i < NV; ++i) {
    const T* a = reinterpret_cast<const T*>(&rx[i]);
    const T* r = reinterpret_cast<const T*>(&rr[i]);
#pragma unroll
    for (int k = 0; k < N; ++k) {
      sv[i][k] = __fadd_rn(to_f32(a[k]), to_f32(r[k]));
      ss = __fmaf_rn(sv[i][k], sv[i][k], ss);
    }
    const int v = v0 + i * stride;
    if (live_row && v < nvec) store16(s_out + base + (int64_t)v * N, sv[i]);
  }
  ss = warp_sum(ss);
  if (W > 1) {
    if (lane == 0) red[warp] = ss;
    __syncthreads();
    ss = 0.f;
    for (int j = 0; j < W; ++j) ss = __fadd_rn(ss, red[rb * W + j]);
  }
  const float inv = 1.0f / sqrtf(ss / (float)d + eps);
#pragma unroll
  for (int i = 0; i < NV; ++i) {
    const int v = v0 + i * stride;
    if (live_row && v < nvec) {
      float wv[N];
      load16(w + (int64_t)v * N, wv);
#pragma unroll
      for (int k = 0; k < N; ++k)
        sv[i][k] = __fmul_rn(__fmul_rn(sv[i][k], inv), wv[k]);
      store16(out + base + (int64_t)v * N, sv[i]);
    }
  }
}

// -------------------------------------------------------------- loop path
constexpr int kRowsPerBlock = 8;  // one warp per row

template <typename T, bool VEC>
__global__ void residual_rmsnorm_loop(const T* __restrict__ x,
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

template <typename T, int NV>
static cudaError_t launch_regs(const T* x, const T* res, const T* w, T* s_out,
                               T* out, int64_t rows, int d, int W, float eps,
                               cudaStream_t stream) {
  const int rows_per_block = (kBlockThreads / 32) / W;
  const int64_t blocks = (rows + rows_per_block - 1) / rows_per_block;
  residual_rmsnorm_regs<T, NV><<<(unsigned)blocks, kBlockThreads, 0, stream>>>(
      x, res, w, s_out, out, rows, d, W, eps);
  return cudaGetLastError();
}

template <typename T>
static cudaError_t launch_residual_rmsnorm(const void* xp, const void* resp,
                                           const void* wp, void* s_outp,
                                           void* outp, int64_t rows, int d,
                                           float eps, cudaStream_t stream) {
  const T *x = (const T*)xp, *res = (const T*)resp, *w = (const T*)wp;
  T *s_out = (T*)s_outp, *out = (T*)outp;
  constexpr int N = Vec16<T>::N;
  const bool vec = (d % N == 0) && aligned16(x) && aligned16(res) &&
                   aligned16(w) && aligned16(s_out) && aligned16(out);
  if (vec) {
    // the fewest warps a row that leave a lane at most kMaxNV vectors
    const int nvec = d / N;
    for (int W = 1; W <= kBlockThreads / 32; W *= 2) {
      const int need = (nvec + 32 * W - 1) / (32 * W);
      if (need > kMaxNV) continue;
      if (need <= 1) return launch_regs<T, 1>(x, res, w, s_out, out, rows, d, W, eps, stream);
      if (need <= 2) return launch_regs<T, 2>(x, res, w, s_out, out, rows, d, W, eps, stream);
      if (need <= 4) return launch_regs<T, 4>(x, res, w, s_out, out, rows, d, W, eps, stream);
      if (need <= 8) return launch_regs<T, 8>(x, res, w, s_out, out, rows, d, W, eps, stream);
      return launch_regs<T, 10>(x, res, w, s_out, out, rows, d, W, eps, stream);
    }
  }
  const int64_t blocks = (rows + kRowsPerBlock - 1) / kRowsPerBlock;
  if (vec)
    residual_rmsnorm_loop<T, true>
        <<<(unsigned)blocks, 32 * kRowsPerBlock, 0, stream>>>(
            x, res, w, s_out, out, rows, d, eps);
  else
    residual_rmsnorm_loop<T, false>
        <<<(unsigned)blocks, 32 * kRowsPerBlock, 0, stream>>>(
            x, res, w, s_out, out, rows, d, eps);
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
