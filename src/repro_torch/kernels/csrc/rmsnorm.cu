// Fused RMSNorm for Hopper.
//
// Replaces the TPU kernel src/repro/kernels/rmsnorm.py (`_rmsnorm_kernel`,
// launched by `rmsnorm`):  out = x * (1 / sqrt(mean(x^2) + eps)) * w,
// row by row over a (rows, d) view, reducing in f32, stored in x's dtype.
//
// Bound on the H100: memory.  A handful of flops per element against one
// read of x and one write of out (w is d elements, read from cache), so
// the least time is (2 * rows * d + d) * bytes / 3.35 TB/s.
//
// The register path (16-byte aligned buffers, d a whole number of 16-byte
// vectors, d within the instantiated widths) reads each row once, as
// csrc/residual_rmsnorm.cu does: W warps own a row, and lane l of warp w
// takes the row's 16-byte vectors v = i * 32W + 32w + l for i < NV.  All of
// a lane's loads of x are issued at once and held in registers as loaded
// (NV * 4 words); the sum of squares is reduced in a fixed order (each lane
// in order of i and then of the vector's elements, by FMA; a shuffle
// butterfly over the warp; the W warp sums in order of w through shared
// memory), and out is computed from the same registers and written.  x is
// read from device memory once and out written once; w (d elements) is
// read by every row, from L1/L2.
//
// W is the fewest warps (1, 2, 4 or 8) that leave each lane at most 4
// vectors; a row too wide for that (more than 1024 vectors) takes 8 warps
// and up to 10 vectors a lane.  Few vectors a lane keep a thread near 32
// registers, so 8 blocks of 256 threads fit an SM: one warp a row with 10
// vectors a lane (d = 2560 bf16, as the fused residual norm runs) takes 80
// registers a thread, so 3 blocks fit an SM, the dense step's 512 blocks
// need two waves, and that layout measured slower than a two-pass loop
// (PERF.md, the rmsnorm row).  NV is a template parameter, instantiated at 1, 2, 3,
// 4, 8 and 10; a lane whose vector index passes the row's end is idle.
// The widths the paths use land on:
//   d = 2560 bf16: W = 4, NV = 3       d = 2560 f32: W = 8, NV = 3
//   d = 4096 bf16: W = 4, NV = 4       d = 4096 f32: W = 8, NV = 4
//   d = 64 (the smoke configs) f32: W = 1, NV = 1 (16 of 32 lanes)
// Blocks hold 8 / W rows (256 threads).
//
// The loop path keeps the rest: a d that is not a whole number of 16-byte
// vectors or a misaligned buffer (one element a lane), and rows wider than
// 8 warps x 10 vectors (20,480 bf16, 10,240 f32): one warp per row, pass 1
// sums squares, pass 2 re-reads the row (from L1/L2) and writes out.
//
// On both paths the inverse is 1 / sqrtf(...) with IEEE sqrt and division,
// not the approximate rsqrtf.

#include "common.cuh"

constexpr int kLaneNV = 4;      // vectors a lane holds where 8 warps suffice
constexpr int kMaxNV = 10;      // vectors a lane holds, at most
constexpr int kBlockThreads = 256;

// ---------------------------------------------------------- register path
template <typename T, int NV>
__global__ void __launch_bounds__(kBlockThreads)
    rmsnorm_regs(const T* __restrict__ x, const T* __restrict__ w,
                 T* __restrict__ out, int64_t rows, int d, int W, float eps) {
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

  // all loads first: every vector of this lane, kept as loaded
  uint4 rx[NV];
#pragma unroll
  for (int i = 0; i < NV; ++i) {
    const int v = v0 + i * stride;
    rx[i] = live_row && v < nvec
                ? *reinterpret_cast<const uint4*>(x + base + (int64_t)v * N)
                : make_uint4(0u, 0u, 0u, 0u);
  }
  float ss = 0.f;
#pragma unroll
  for (int i = 0; i < NV; ++i) {
    const T* a = reinterpret_cast<const T*>(&rx[i]);
#pragma unroll
    for (int k = 0; k < N; ++k) {
      const float f = to_f32(a[k]);
      ss = __fmaf_rn(f, f, ss);
    }
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
      const T* a = reinterpret_cast<const T*>(&rx[i]);
      float wv[N], o[N];
      load16(w + (int64_t)v * N, wv);
#pragma unroll
      for (int k = 0; k < N; ++k)
        o[k] = __fmul_rn(__fmul_rn(to_f32(a[k]), inv), wv[k]);
      store16(out + base + (int64_t)v * N, o);
    }
  }
}

// -------------------------------------------------------------- loop path
constexpr int kRowsPerBlock = 8;  // one warp per row

template <typename T, bool VEC>
__global__ void rmsnorm_loop(const T* __restrict__ x,
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

template <typename T, int NV>
static cudaError_t launch_regs(const T* x, const T* w, T* out, int64_t rows,
                               int d, int W, float eps, cudaStream_t stream) {
  const int rows_per_block = (kBlockThreads / 32) / W;
  const int64_t blocks = (rows + rows_per_block - 1) / rows_per_block;
  rmsnorm_regs<T, NV><<<(unsigned)blocks, kBlockThreads, 0, stream>>>(
      x, w, out, rows, d, W, eps);
  return cudaGetLastError();
}

template <typename T>
static cudaError_t launch_rmsnorm(const void* xp, const void* wp, void* outp,
                                  int64_t rows, int d, float eps,
                                  cudaStream_t stream) {
  const T *x = (const T*)xp, *w = (const T*)wp;
  T* out = (T*)outp;
  constexpr int N = Vec16<T>::N;
  const bool vec = (d % N == 0) && aligned16(x) && aligned16(w) &&
                   aligned16(out);
  if (vec) {
    // the fewest warps a row that leave a lane at most kLaneNV vectors;
    // else 8 warps and at most kMaxNV
    const int nvec = d / N;
    constexpr int kWarps = kBlockThreads / 32;
    int W = 1;
    while (W < kWarps && nvec > 32 * W * kLaneNV) W *= 2;
    const int need = (nvec + 32 * W - 1) / (32 * W);
    if (need <= 1) return launch_regs<T, 1>(x, w, out, rows, d, W, eps, stream);
    if (need <= 2) return launch_regs<T, 2>(x, w, out, rows, d, W, eps, stream);
    if (need <= 3) return launch_regs<T, 3>(x, w, out, rows, d, W, eps, stream);
    if (need <= 4) return launch_regs<T, 4>(x, w, out, rows, d, W, eps, stream);
    if (need <= 8) return launch_regs<T, 8>(x, w, out, rows, d, W, eps, stream);
    if (need <= kMaxNV)
      return launch_regs<T, 10>(x, w, out, rows, d, W, eps, stream);
  }
  const int64_t blocks = (rows + kRowsPerBlock - 1) / kRowsPerBlock;
  if (vec)
    rmsnorm_loop<T, true><<<(unsigned)blocks, 32 * kRowsPerBlock, 0, stream>>>(
        x, w, out, rows, d, eps);
  else
    rmsnorm_loop<T, false><<<(unsigned)blocks, 32 * kRowsPerBlock, 0, stream>>>(
        x, w, out, rows, d, eps);
  return cudaGetLastError();
}

extern "C" int repro_rmsnorm(const void* x, const void* w, void* out,
                             long long rows, int d, float eps, int dtype,
                             int device, void* stream) {
  // the device is almost always current already: set it only when not
  int current = -1;
  cudaError_t e = cudaGetDevice(&current);
  if (e == cudaSuccess && current != device) e = cudaSetDevice(device);
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
