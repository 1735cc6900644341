// Fused wire compression with error feedback for Hopper.
//
// Replaces the two TPU kernels of src/repro/kernels/fused_compress.py:
// `_int8_ef_kernel` (launched by `fused_int8_ef`) and `_topk_ef_kernel`
// (launched by `fused_topk_ef`).  Both read a packed (rows, 512) gradient
// region g (f32 or bf16) and its f32 error-feedback state e, and write the
// decoded gradient g' (g's type) and the new error e' (f32), one scale or
// one threshold per (8, 512) tile — 4096 contiguous elements.
//
//   int8:  gf = g + e;  scale = max(max|gf|, 1e-12) / 127
//          q = clip(rint(gf / scale), -127, 127);  g' = q * scale;
//          e' = gf - g'
//   top-k: gf = g + e;  bisect 24 times on the count curve |{|gf| >= t}|
//          against target = float32(fraction * 4096) for a threshold lo;
//          g' = |gf| >= lo ? gf : 0;  e' = gf - g'
//
// Bound on the H100: memory.  12 bytes per element for bf16 (g 2 + e 4 in,
// g' 2 + e' 4 out), a few operations per byte for int8 and ~50 compares
// and adds per element for top-k, all far below the card's balance point.
// The design: one block per tile, 512 threads holding 8 elements each in
// registers, so every element is read once and written once however many
// passes the tile's reduction takes; the max is a warp shuffle plus a
// shared-memory step, and each bisection round's count is a warp
// __reduce_add_sync plus a double-buffered shared-memory step (one
// barrier per round).
//
// Bit for bit the plain versions (kernels/ref.py `fused_int8_ef_ref`,
// `fused_topk_ef_ref`): the max and the integer count do not depend on
// the order of the reduction, every other operation is one IEEE-rounded
// intrinsic (no contraction), and rintf rounds half to even as
// torch.round and jnp.round do.

#include "common.cuh"

namespace {

constexpr int kTile = 8 * 512;           // elements per (8, 512) tile
constexpr int kThreads = 512;
constexpr int kPer = kTile / kThreads;   // elements per thread (8)
constexpr int kWarps = kThreads / 32;
constexpr int kTopkIters = 24;

// Load this thread's 8 elements of the tile: gf = g + e in f32.
template <typename T>
__device__ __forceinline__ void load_gf(const T* g, const float* e,
                                        int64_t base, float (&gf)[kPer]) {
  const int64_t off = base + (int64_t)threadIdx.x * kPer;
  float gv[kPer];
  if constexpr (sizeof(T) == 2) {
    load16(g + off, gv);
  } else {
    load16(g + off, *reinterpret_cast<float(*)[4]>(&gv[0]));
    load16(g + off + 4, *reinterpret_cast<float(*)[4]>(&gv[4]));
  }
  float ev[kPer];
  load16(e + off, *reinterpret_cast<float(*)[4]>(&ev[0]));
  load16(e + off + 4, *reinterpret_cast<float(*)[4]>(&ev[4]));
#pragma unroll
  for (int i = 0; i < kPer; ++i) gf[i] = __fadd_rn(gv[i], ev[i]);
}

template <typename T>
__device__ __forceinline__ void store_out(T* dq, float* er, int64_t base,
                                          const float (&dv)[kPer],
                                          const float (&ev)[kPer]) {
  const int64_t off = base + (int64_t)threadIdx.x * kPer;
  if constexpr (sizeof(T) == 2) {
    store16(dq + off, dv);
  } else {
    store16(dq + off, *reinterpret_cast<const float(*)[4]>(&dv[0]));
    store16(dq + off + 4, *reinterpret_cast<const float(*)[4]>(&dv[4]));
  }
  store16(er + off, *reinterpret_cast<const float(*)[4]>(&ev[0]));
  store16(er + off + 4, *reinterpret_cast<const float(*)[4]>(&ev[4]));
}

// Block-wide max of non-negative values (every thread gets the result).
__device__ __forceinline__ float block_max(float x, float* red) {
  x = warp_max(x);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  if (lane == 0) red[warp] = x;
  __syncthreads();
  float m = red[0];
#pragma unroll
  for (int w = 1; w < kWarps; ++w) m = fmaxf(m, red[w]);
  return m;
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
int8_ef_kernel(const T* __restrict__ g, const float* __restrict__ e,
               T* __restrict__ dq, float* __restrict__ er) {
  __shared__ float red[kWarps];
  const int64_t base = (int64_t)blockIdx.x * kTile;
  float gf[kPer];
  load_gf(g, e, base, gf);
  float mx = 0.0f;
#pragma unroll
  for (int i = 0; i < kPer; ++i) mx = fmaxf(mx, fabsf(gf[i]));
  mx = block_max(mx, red);
  const float scale = __fdiv_rn(fmaxf(mx, 1e-12f), 127.0f);
  float dv[kPer], ev[kPer];
#pragma unroll
  for (int i = 0; i < kPer; ++i) {
    float q = rintf(__fdiv_rn(gf[i], scale));
    q = fminf(fmaxf(q, -127.0f), 127.0f);
    dv[i] = __fmul_rn(q, scale);
    ev[i] = __fsub_rn(gf[i], dv[i]);
  }
  store_out(dq, er, base, dv, ev);
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
topk_ef_kernel(const T* __restrict__ g, const float* __restrict__ e,
               T* __restrict__ dq, float* __restrict__ er, float target) {
  __shared__ float red[kWarps];
  __shared__ unsigned cnt[2][kWarps];
  const int64_t base = (int64_t)blockIdx.x * kTile;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  float gf[kPer], mag[kPer];
  load_gf(g, e, base, gf);
  float mx = 0.0f;
#pragma unroll
  for (int i = 0; i < kPer; ++i) {
    mag[i] = fabsf(gf[i]);
    mx = fmaxf(mx, mag[i]);
  }
  mx = block_max(mx, red);
  float lo = 0.0f;
  float hi = __fadd_rn(mx, 1e-12f);
  for (int it = 0; it < kTopkIters; ++it) {
    const float mid = __fmul_rn(0.5f, __fadd_rn(lo, hi));
    unsigned c = 0;
#pragma unroll
    for (int i = 0; i < kPer; ++i) c += mag[i] >= mid ? 1u : 0u;
    c = __reduce_add_sync(0xffffffffu, c);
    // Double-buffered: round it+1 writes the other row, so one barrier
    // per round keeps a slow reader of this round from seeing the next
    // round's counts.
    if (lane == 0) cnt[it & 1][warp] = c;
    __syncthreads();
    unsigned total = 0;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) total += cnt[it & 1][w];
    const bool take = (float)total >= target;  // exact: total <= 4096
    lo = take ? mid : lo;
    hi = take ? hi : mid;
  }
  float dv[kPer], ev[kPer];
#pragma unroll
  for (int i = 0; i < kPer; ++i) {
    dv[i] = mag[i] >= lo ? gf[i] : 0.0f;
    ev[i] = __fsub_rn(gf[i], dv[i]);
  }
  store_out(dq, er, base, dv, ev);
}

template <typename T>
cudaError_t launch(const void* g, const void* e, void* dq, void* er,
                   long long tiles, float target, bool topk,
                   cudaStream_t s) {
  if (topk) {
    topk_ef_kernel<T><<<(unsigned)tiles, kThreads, 0, s>>>(
        (const T*)g, (const float*)e, (T*)dq, (float*)er, target);
  } else {
    int8_ef_kernel<T><<<(unsigned)tiles, kThreads, 0, s>>>(
        (const T*)g, (const float*)e, (T*)dq, (float*)er);
  }
  return cudaGetLastError();
}

int dispatch(const void* g, const void* e, void* dq, void* er,
             long long tiles, float target, bool topk, int dtype,
             int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (tiles <= 0) return (int)cudaSuccess;
  if (tiles > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  // 16-byte vector accesses throughout
  if (!(aligned16(g) && aligned16(e) && aligned16(dq) && aligned16(er)))
    return (int)cudaErrorMisalignedAddress;
  cudaStream_t s = (cudaStream_t)stream;
  switch (dtype) {
    case REPRO_F32:
      return (int)launch<float>(g, e, dq, er, tiles, target, topk, s);
    case REPRO_BF16:
      return (int)launch<__nv_bfloat16>(g, e, dq, er, tiles, target, topk, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// g, dq: (tiles * 4096) elements of `dtype`; e, er: f32 of the same count.
extern "C" int repro_fused_int8_ef(const void* g, const void* e, void* dq,
                                   void* er, long long tiles, int dtype,
                                   int device, void* stream) {
  return dispatch(g, e, dq, er, tiles, 0.0f, false, dtype, device, stream);
}

extern "C" int repro_fused_topk_ef(const void* g, const void* e, void* dq,
                                   void* er, long long tiles, float target,
                                   int dtype, int device, void* stream) {
  return dispatch(g, e, dq, er, tiles, target, true, dtype, device, stream);
}
