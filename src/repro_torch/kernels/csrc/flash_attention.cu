// Flash attention forward for Hopper: causal / sliding-window / GQA.  The
// entry point of both kernels: f32 takes the scalar kernel below, bf16 the
// tensor-core kernel of flash_attention_sm90.cu (wgmma, TMA), and nothing
// else.
//
// Replaces the TPU kernel src/repro/kernels/flash_attention.py
// (`_flash_kernel`, launched by `flash_attention_fwd`).  q (b, lq, hq, d),
// k/v (b, lk, hkv, d) -> o (b, lq, hq, d).  Query i sits at absolute
// position lk - lq + i (end-aligned); q-head h reads kv-head
// h / (hq / hkv) with no broadcast copy; masked scores are -1e30 as in
// the reference, so rows and their softmax match it.
//
// Bound on the H100: operations.  4 * b * hq * d flops per unmasked
// (query, key) pair against one read of q, k, v and one write of o, so
// at the model's shapes the least time is the flops over the card's peak.
// This kernel runs the two products on the scalar f32 pipes: f32 inputs
// need f32 products (the card's tolerance is 2e-5), which neither bf16 nor
// TF32 tensor cores hold.
//
// Design (f32 only).  One block of 4 warps per (q-tile of 64 queries, q-head,
// batch); each warp owns 16 query rows.  The block walks the key tiles of
// 64 that its query range can see -- whole tiles that the causal or
// window mask hides are skipped, as `_flash_kernel` skips them -- and
// stages each K/V tile in shared memory as f32 (K rows padded by 4 floats
// so 16-byte reads by 8 lanes hit distinct banks).  The online softmax
// keeps the running max m, the normaliser l and the accumulator acc in
// f32 registers; a lane owns 2 of the 64 scores of a row and up to 4 of
// its d output columns (d <= 128, any multiple of 8: 80 included).  Keys
// past lk and queries past lq (a ragged last tile) are masked in the
// kernel, so every length takes the kernel.

#include <math.h>

#include "common.cuh"

constexpr int kBQ = 64;      // queries per block
constexpr int kBK = 64;      // keys per tile
constexpr int kWarps = 4;
constexpr int kRows = kBQ / kWarps;  // query rows per warp
constexpr float kNegBig = -1e30f;    // the reference's mask value

__host__ __device__ constexpr int k_stride(int d) { return d + 4; }

__host__ constexpr size_t flash_smem_floats(int d) {
  return (size_t)kBQ * d + (size_t)kBK * k_stride(d) + (size_t)kBK * d +
         (size_t)kWarps * kRows * kBK;
}

// Stage `nrows` rows of width d (row stride `src_stride` elements) into
// shared memory as f32; rows at or past `valid` are zero-filled.
__device__ __forceinline__ void stage_tile(float* dst, int dst_stride,
                                           const float* src,
                                           int64_t src_stride, int valid,
                                           int nrows, int d) {
  constexpr int N = Vec16<float>::N;
  const int per_row = d / N;
  for (int idx = threadIdx.x; idx < nrows * per_row; idx += blockDim.x) {
    const int r = idx / per_row;
    const int c = (idx - r * per_row) * N;
    float a[N];
    if (r < valid) {
      load16(src + (int64_t)r * src_stride + c, a);
    } else {
#pragma unroll
      for (int i = 0; i < N; ++i) a[i] = 0.f;
    }
#pragma unroll
    for (int i = 0; i < N; ++i) dst[r * dst_stride + c + i] = a[i];
  }
}

template <int NC>
__global__ void __launch_bounds__(kWarps * 32)
    flash_fwd_kernel(const float* __restrict__ q, const float* __restrict__ k,
                     const float* __restrict__ v, float* __restrict__ o, int LQ,
                     int LK, int HQ, int HKV, int D, int causal, int window,
                     float scale) {
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  const int KS = k_stride(D);
  float* Qs = smem;              // kBQ x D
  float* Ks = Qs + kBQ * D;      // kBK x KS
  float* Vs = Ks + kBK * KS;     // kBK x D
  float* Ps = Vs + kBK * D;      // kWarps x kRows x kBK

  const int q0 = blockIdx.x * kBQ;
  const int h = blockIdx.y;
  const int bi = blockIdx.z;
  const int hk = h / (HQ / HKV);
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int off = LK - LQ;

  const int64_t q_stride = (int64_t)HQ * D;
  const int64_t kv_stride = (int64_t)HKV * D;
  const float* qb = q + ((int64_t)bi * LQ + q0) * q_stride + (int64_t)h * D;
  const float* kb = k + (int64_t)bi * LK * kv_stride + (int64_t)hk * D;
  const float* vb = v + (int64_t)bi * LK * kv_stride + (int64_t)hk * D;

  stage_tile(Qs, D, qb, q_stride, LQ - q0, kBQ, D);

  // Key range this block's queries can see; whole tiles outside it are
  // skipped (causal: keys in the future of the last query; window: keys
  // before the first query's window).
  const int qmin = q0 + off;
  const int qmax = min(q0 + kBQ, LQ) - 1 + off;
  int k_lo = 0, k_hi = LK - 1;
  if (causal) k_hi = min(k_hi, qmax);
  if (window > 0) k_lo = max(k_lo, qmin - window + 1);

  float m_r[kRows], l_r[kRows], acc[kRows][NC];
#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    m_r[r] = kNegBig;
    l_r[r] = 0.f;
#pragma unroll
    for (int i = 0; i < NC; ++i) acc[r][i] = 0.f;
  }
  const float* Qw = Qs + warp * kRows * D;
  float* Pw = Ps + warp * kRows * kBK;
  const int row0 = q0 + warp * kRows;  // first query row of this warp

  const int kt_lo = k_lo / kBK;
  const int kt_hi = k_hi >= k_lo ? k_hi / kBK : kt_lo - 1;  // none visible
  for (int kt = kt_lo; kt <= kt_hi; ++kt) {
    const int k0 = kt * kBK;
    __syncthreads();  // every warp is done with the previous tile
    stage_tile(Ks, KS, kb + (int64_t)k0 * kv_stride, kv_stride, LK - k0, kBK, D);
    stage_tile(Vs, D, vb + (int64_t)k0 * kv_stride, kv_stride, LK - k0, kBK, D);
    __syncthreads();

    // S = Q K^T for this warp's 16 rows: lane owns keys lane, lane + 32.
    float s[kRows][2];
#pragma unroll
    for (int r = 0; r < kRows; ++r) s[r][0] = s[r][1] = 0.f;
    for (int c = 0; c < D; c += 4) {
      const float4 ka = *reinterpret_cast<const float4*>(&Ks[lane * KS + c]);
      const float4 kc =
          *reinterpret_cast<const float4*>(&Ks[(lane + 32) * KS + c]);
#pragma unroll
      for (int r = 0; r < kRows; ++r) {
        const float4 qa = *reinterpret_cast<const float4*>(&Qw[r * D + c]);
        s[r][0] += qa.x * ka.x + qa.y * ka.y + qa.z * ka.z + qa.w * ka.w;
        s[r][1] += qa.x * kc.x + qa.y * kc.y + qa.z * kc.z + qa.w * kc.w;
      }
    }

    // Mask, online softmax, P to shared memory.
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      const int qpos = row0 + r + off;
#pragma unroll
      for (int t = 0; t < 2; ++t) {
        const int kk = k0 + lane + 32 * t;
        const bool allowed = (!causal || kk <= qpos) &&
                             (window <= 0 || kk > qpos - window);
        const float sv = s[r][t] * scale;
        s[r][t] = kk >= LK ? -INFINITY : (allowed ? sv : kNegBig);
      }
      const float m_new = fmaxf(m_r[r], warp_max(fmaxf(s[r][0], s[r][1])));
      const float alpha = expf(m_r[r] - m_new);
      const float p0 = expf(s[r][0] - m_new);
      const float p1 = expf(s[r][1] - m_new);
      l_r[r] = l_r[r] * alpha + (p0 + p1);  // per-lane partial sum
      m_r[r] = m_new;
#pragma unroll
      for (int i = 0; i < NC; ++i) acc[r][i] *= alpha;
      Pw[r * kBK + lane] = p0;
      Pw[r * kBK + lane + 32] = p1;
    }
    __syncwarp();

    // acc += P V: lane owns output columns lane + 32 * i.
    for (int kk = 0; kk < kBK; kk += 4) {
      float vv[4][NC];
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int i = 0; i < NC; ++i) {
          const int c = lane + 32 * i;
          vv[j][i] = c < D ? Vs[(kk + j) * D + c] : 0.f;
        }
#pragma unroll
      for (int r = 0; r < kRows; ++r) {
        const float4 pp = *reinterpret_cast<const float4*>(&Pw[r * kBK + kk]);
#pragma unroll
        for (int i = 0; i < NC; ++i)
          acc[r][i] += pp.x * vv[0][i] + pp.y * vv[1][i] + pp.z * vv[2][i] +
                       pp.w * vv[3][i];
      }
    }
    __syncwarp();
  }

#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    const float l = fmaxf(warp_sum(l_r[r]), 1e-30f);
    const int qi = row0 + r;
    if (qi >= LQ) continue;
    float* orow = o + ((int64_t)bi * LQ + qi) * q_stride + (int64_t)h * D;
#pragma unroll
    for (int i = 0; i < NC; ++i) {
      const int c = lane + 32 * i;
      if (c < D) orow[c] = acc[r][i] / l;
    }
  }
}

template <int NC>
static cudaError_t launch_flash(const void* q, const void* k, const void* v,
                                void* o, int B, int LQ, int LK, int HQ,
                                int HKV, int D, int causal, int window,
                                float scale, cudaStream_t stream) {
  const size_t smem = flash_smem_floats(D) * sizeof(float);
  cudaError_t e = cudaFuncSetAttribute(
      flash_fwd_kernel<NC>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (e != cudaSuccess) return e;
  const dim3 grid((LQ + kBQ - 1) / kBQ, HQ, B);
  flash_fwd_kernel<NC><<<grid, kWarps * 32, smem, stream>>>(
      (const float*)q, (const float*)k, (const float*)v, (float*)o, LQ, LK, HQ,
      HKV, D, causal, window, scale);
  return cudaGetLastError();
}

static cudaError_t dispatch_flash(const void* q, const void* k, const void* v,
                                  void* o, int B, int LQ, int LK, int HQ,
                                  int HKV, int D, int causal, int window,
                                  float scale, cudaStream_t s) {
  switch ((D + 31) / 32) {
    case 1:
      return launch_flash<1>(q, k, v, o, B, LQ, LK, HQ, HKV, D, causal,
                                window, scale, s);
    case 2:
      return launch_flash<2>(q, k, v, o, B, LQ, LK, HQ, HKV, D, causal,
                                window, scale, s);
    case 3:
      return launch_flash<3>(q, k, v, o, B, LQ, LK, HQ, HKV, D, causal,
                                window, scale, s);
    case 4:
      return launch_flash<4>(q, k, v, o, B, LQ, LK, HQ, HKV, D, causal,
                                window, scale, s);
    default:
      return cudaErrorInvalidValue;
  }
}

cudaError_t flash_fwd_wgmma(const void* q, const void* k, const void* v,
                            void* o, int b, int lq, int lk, int hq, int hkv,
                            int d, int causal, int window, float scale,
                            cudaStream_t s);

// window <= 0 means no sliding window.  Requires d % 8 == 0, d <= 128,
// hq % hkv == 0 and 16-byte aligned q/k/v (the wrapper checks).
extern "C" int repro_flash_attention_fwd(const void* q, const void* k,
                                         const void* v, void* o, int b, int lq,
                                         int lk, int hq, int hkv, int d,
                                         int causal, int window, float scale,
                                         int dtype, int device, void* stream) {
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return (int)e;
  if (d % 8 != 0 || d > 128 || hkv <= 0 || hq % hkv != 0 ||
      !aligned16(q) || !aligned16(k) || !aligned16(v))
    return (int)cudaErrorInvalidValue;
  if (b <= 0 || lq <= 0 || lk <= 0 || d <= 0) return (int)cudaSuccess;
  cudaStream_t s = (cudaStream_t)stream;
  switch (dtype) {
    case REPRO_F32:
      return (int)dispatch_flash(q, k, v, o, b, lq, lk, hq, hkv, d, causal,
                                 window, scale, s);
    case REPRO_BF16:
      return (int)flash_fwd_wgmma(q, k, v, o, b, lq, lk, hq, hkv, d, causal,
                                  window, scale, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}
