// Flash attention forward in bf16 on Hopper's tensor cores: wgmma on bf16
// tiles, K/V fed by TMA through a ring of shared-memory stages.
//
// Replaces the TPU kernel src/repro/kernels/flash_attention.py
// (`_flash_kernel`, launched by `flash_attention_fwd`) for bf16 inputs;
// f32 inputs keep the scalar kernel of flash_attention.cu.  q (b, lq, hq,
// d), k/v (b, lk, hkv, d) -> o (b, lq, hq, d); query i sits at position
// lk - lq + i; q-head h reads kv-head h / (hq / hkv) with no broadcast
// copy; whole masked tiles are skipped; m, l and the accumulator are f32.
//
// Bound on the H100: operations.  4 * b * hq * pairs * d flops over the
// unmasked (query, key) pairs at 989 TFLOP/s; at the train step's shape
// (4, 1024, 32/8, 80, causal) that is 21.5 GFLOP, 0.0217 ms, against
// 0.0147 ms to read q, k, v and write o once.  The design keeps the tensor
// cores fed and hides the loads:
//   * S = Q K^T is `wgmma.mma_async` m64n64k16 with Q and K read from
//     shared memory in their natural K-major layout; O += P V takes P from
//     registers (the S accumulator split into two bf16 fragments, P_hi =
//     bf16(P) and P_lo = bf16(P - P_hi): the f32 accumulator fragment of a
//     row pair is the A fragment of the next product) and V from shared
//     memory MN-major (the transpose bit), n = the columns of each box; each
//     k-step issues P_hi V and P_lo V back to back into the same f32 O.  The
//     P V of tile i - 1 runs while the softmax of tile i does.
//   * One thread of a producer warpgroup issues TMA loads
//     (`cp.async.bulk.tensor`): each work item's Q into one of two Q
//     buffers, then K and V tiles of 64 keys into a ring of kStages stages,
//     each completed on an `mbarrier`; consumers release a stage (and a Q
//     buffer) on a second mbarrier.  `setmaxnreg` moves the producer's
//     registers to the consumers, so none spills at d = 128.
//   * Two consumer warpgroups of 64 query rows each (128 queries per work
//     item) share each K/V tile.  64 keys a tile keep the scalar kernel's
//     tile range (below) and S at 32 registers a thread.  Three ring
//     stages keep two tiles' loads in flight while the consumers work on
//     a third, in 161 KB of shared memory at d = 128.  The ring depth and
//     the number of consumer warpgroups were chosen in trial builds that
//     the repo does not keep, so no time is stated for the alternatives.
//   * The grid is persistent, one block per SM, each walking work items
//     x, x + gridDim.x, ...: the producer runs ahead into the next item
//     while the consumers finish this one, so a block's start-up latency
//     is paid once.  Items run longest first (the last q-tile: under a
//     causal mask it sees the most keys) with q-heads fastest, so the
//     hq / hkv q-heads of a kv-head run side by side and L2 serves their
//     repeated K/V reads.
//
// Layout of a head dim that is not a multiple of 64.  Rows are loaded as
// TMA boxes of 64 columns (128-byte rows, 128-byte swizzle) and one last
// box of 16, 32 or 64 columns with the swizzle of its width (32-, 64- or
// 128-byte), each with its own tensor map and descriptors.  d = 80 is a
// box of 64 and one of 16: 160 bytes a row, as in memory, where one
// 64-column box loaded twice would fill 48 zero columns (60% more bytes
// to move into shared memory and P V work to do).  A d that is not a
// multiple of 16 pads the contraction with TMA's zero fill.
//
// Masks.  Each consumer warpgroup walks the key-tile range that the scalar
// kernel's 64-query block walks (tiles past the causal edge or before the
// window are never loaded), and masks only a tile that needs it: the causal
// diagonal, the window's edge, a ragged last tile.  A masked score is
// -1e30 (the reference's NEG_INF), a key at or past lk is -inf, and l is
// clamped at 1e-30, as in the scalar kernel; the scores are in log2 units
// (below), where -1e30 masks as it does in natural ones.  Ragged lq/lk rely
// on TMA's zero fill out of bounds (the batch is a dimension of the tensor
// map, so a box never reads the next batch row) plus the mask.
//
// Rounding against the reference (which computes both products in f32):
// q, k and v enter as bf16, which the reference widens to f32 exactly; the
// products accumulate in f32 in another order; the softmax runs in log2
// units, P = 2^(s * scale * log2(e) - m) by one FMA and `ex2.approx`; and
// P enters P V as P_hi + P_lo, two bf16 operands whose sum is P to within
// 2^-18 of P (bf16 alone would be 2^-9), where the reference keeps P in
// f32; l sums the unrounded f32 P.  So P V is exact to about 2^-17 of each
// weight, at 1.5x the tensor-core work of bf16 P (P V is half of it).  The
// output is rounded to bf16 once, at the end.  tests/test_torch_flash.py
// emulates this arithmetic on the CPU and holds it, element by element, to
// one bf16 ulp of the reference (the ulp of the larger of the two values,
// counted at no less than that of 2^-8: below it the f32 sums' own error,
// about 1e-6, exceeds a bf16 ulp), as chip_smoke.py and the cuda tests hold
// the kernel to the plain version.

#include <cuda.h>  // CUtensorMap and its enums; the encoder comes from libcuda
#include <dlfcn.h>
#include <math.h>

#include "common.cuh"

namespace {

constexpr int kBK = 64;                      // keys per tile
constexpr int kStages = 3;                   // K/V ring depth
constexpr int kConsumers = 2;                // warpgroups of 64 query rows
constexpr int kBQ = 64 * kConsumers;         // queries per work item
constexpr int kThreads = (kConsumers + 1) * 128;  // + the producer's
// Registers a thread after setmaxnreg: the producer warpgroup gives up what
// it does not need so that each consumer can hold S, P_hi, P_lo and O (d =
// 128: 32 + 16 + 16 + 64) without spilling; 40 * 128 + 232 * 256 <= 65536.
constexpr int kProducerRegs = 40;
constexpr int kConsumerRegs = 232;
constexpr int kBox = 64;                     // bf16 columns of a full box
constexpr float kNegBig = -1e30f;            // the reference's mask value
constexpr long long kWaitClocks = 1ll << 33;  // mbar_wait's limit

// The columns of a head dim of KSTEPS k-steps (ceil(d / 16)), as TMA boxes:
// BOXES - 1 boxes of 64 columns (128-byte rows, 128-byte swizzle), then one
// of LAST columns: 16 (32-byte rows and swizzle), 32 (64-byte) or 64.  A
// region of R rows holds box c at c * R * 128 bytes, box after box.
template <int KSTEPS>
struct Cols {
  static constexpr int BOXES = (KSTEPS + 3) / 4;
  static constexpr int LAST_STEPS = KSTEPS - 4 * (BOXES - 1);  // 1..4
  static constexpr int LAST = LAST_STEPS == 3 ? 64 : 16 * LAST_STEPS;
  static constexpr uint32_t ROW = (BOXES - 1) * 128 + LAST * 2;  // bytes
  __host__ __device__ static constexpr uint32_t row_bytes(int c) {
    return c + 1 < BOXES ? 128 : LAST * 2;
  }
  __host__ __device__ static constexpr int cols(int c) {
    return c + 1 < BOXES ? kBox : LAST;
  }
};

template <int KSTEPS>
__host__ __device__ constexpr uint32_t smem_bytes() {
  // 1024 bytes of slack to align the tiles (a swizzle pattern repeats
  // every 1024 bytes at most), two Q buffers, the ring, then the ring's
  // 2 * kStages mbarriers and the Q buffers' 4.
  return 1024 + (2 * kBQ + kStages * 2 * kBK) * Cols<KSTEPS>::ROW +
         8 * (2 * kStages + 4);
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// ---------------------------------------------------------------- mbarrier
__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%1], %0;" ::"r"(count),
               "r"(bar));
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%1], %0;" ::"r"(
                   bytes),
               "r"(bar)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];" ::"r"(bar)
               : "memory");
}

// Wait until the phase of parity `parity` has completed.  A wait that
// outlasts kWaitClocks of the SM's clock (about 4 s) traps, so a fault in
// the pipeline stops the kernel instead of hanging the card.  A trap is a
// sticky error: it kills the process's CUDA context, and every later CUDA
// call of that process fails.  A run under a debugger or a sanitizer,
// which slows the kernel by orders of magnitude, must raise kWaitClocks.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  long long start = 0;
  for (int tries = 0;; ++tries) {
    uint32_t done;
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
    if (done) return;
    if (tries == 0) {
      start = clock64();
    } else if (clock64() - start > kWaitClocks) {
      __trap();
    }
  }
}

// ---------------------------------------------------------------- TMA
__device__ __forceinline__ void tma_load_4d(uint32_t dst,
                                            const CUtensorMap* map,
                                            uint32_t bar, int c0, int c1,
                                            int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4, %5, %6}], [%2];" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1),
      "r"(c2), "r"(c3)
      : "memory");
}

// ---------------------------------------------------------------- wgmma
// Shared-memory matrix descriptor for a tile of `row` byte rows (32, 64 or
// 128) written by TMA with the swizzle of that width: start address,
// leading and stride byte offsets (16-byte units), and the layout type in
// bits 62-63 (1: 128-byte swizzle, 2: 64-byte, 3: 32-byte).  The stride
// offset is the 8 rows between groups of 8 rows.  A K-major operand
// ignores the leading offset; an MN-major operand is n = row / 2 columns
// wide, one swizzle atom, so its leading offset (the stride between atoms
// along n) is never used either.
__device__ __forceinline__ uint64_t desc_swizzled(uint32_t addr, uint32_t row) {
  const uint64_t type = row == 128 ? 1 : row == 64 ? 2 : 3;
  return (uint64_t)((addr & 0x3FFFF) >> 4) | (1ull << 16) |
         ((uint64_t)(8 * row >> 4) << 32) | (type << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
}
// Wait until at most N committed groups are still running.
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;" ::"n"(N) : "memory");
}

// Keep the compiler from moving accumulator registers across the
// asynchronous products: the first n of r (all of them by default).
template <int N>
__device__ __forceinline__ void fence_regs(float (&r)[N], int n = N) {
#pragma unroll
  for (int i = 0; i < N; ++i)
    if (i < n) asm volatile("" : "+f"(r[i])::"memory");
}

// d (64 x 64, f32) (+)= A (64 x 16, smem, K-major) * B (16 x 64, smem,
// K-major); scale_d = 0 overwrites d.
__device__ __forceinline__ void wgmma_ss_m64n64k16(float (&d)[32],
                                                   uint64_t da, uint64_t db,
                                                   int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, "
      "%29, %30, %31}, %32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(scale_d));
}

// d (64 x N, f32: the first N / 2 of 32 registers) += A (64 x 16, bf16
// registers) * B (16 x N, smem, MN-major: the transpose bit).
template <int N>
__device__ __forceinline__ void wgmma_rs(float (&d)[32], const uint32_t (&a)[4],
                                         uint64_t db);

template <>
__device__ __forceinline__ void wgmma_rs<16>(float (&d)[32],
                                             const uint32_t (&a)[4],
                                             uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %13, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7}, "
      "{%8, %9, %10, %11}, %12, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

template <>
__device__ __forceinline__ void wgmma_rs<32>(float (&d)[32],
                                             const uint32_t (&a)[4],
                                             uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15}, "
      "{%16, %17, %18, %19}, %20, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

template <>
__device__ __forceinline__ void wgmma_rs<64>(float (&d)[32],
                                             const uint32_t (&a)[4],
                                             uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "
      "%28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// 2^x on the special function unit (approximate, denormals flushed).
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// S (64 x 64) = Q K^T over the k-steps of 16 columns, warpgroup wg's 64
// rows of the Q region sQ (kBQ rows) against the K tile sK (kBK rows).
template <int KSTEPS>
__device__ __forceinline__ void issue_s(float (&sacc)[32], uint32_t sQ,
                                        int wg, uint32_t sK) {
  using C = Cols<KSTEPS>;
#pragma unroll
  for (int ks = 0; ks < KSTEPS; ++ks) {
    const int c = ks >> 2;
    const uint32_t row = C::row_bytes(c);
    const uint32_t col = (ks & 3) * 32;  // 16 columns into the row
    wgmma_ss_m64n64k16(
        sacc, desc_swizzled(sQ + c * kBQ * 128 + wg * 64 * row + col, row),
        desc_swizzled(sK + c * kBK * 128 + col, row), ks > 0);
  }
}

// O += P_hi V + P_lo V: 4 k-steps of 16 keys, the two products of a k-step
// back to back against the same V descriptor; n = the columns of each box.
template <int KSTEPS>
__device__ __forceinline__ void issue_pv(
    float (&oacc)[Cols<KSTEPS>::BOXES][32], const uint32_t (&pa)[4][4],
    const uint32_t (&pl)[4][4], uint32_t sV) {
  using C = Cols<KSTEPS>;
#pragma unroll
  for (int c = 0; c < C::BOXES; ++c)
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const uint32_t row = C::row_bytes(c);
      const uint64_t db =
          desc_swizzled(sV + c * kBK * 128 + j * 16 * row, row);
      if (c + 1 < C::BOXES) {
        wgmma_rs<kBox>(oacc[c], pa[j], db);
        wgmma_rs<kBox>(oacc[c], pl[j], db);
      } else {
        wgmma_rs<C::LAST>(oacc[c], pa[j], db);
        wgmma_rs<C::LAST>(oacc[c], pl[j], db);
      }
    }
}

// P (f32) as two bf16 pairs: hi = bf16(P), lo = bf16(P - hi).  P - hi is
// exact in f32 (hi is P with its low mantissa bits rounded off).
__device__ __forceinline__ void split_bf16(float x, float y, uint32_t& hi,
                                           uint32_t& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(x, y);
  const float2 hf = __bfloat1622float2(h);
  hi = *reinterpret_cast<const uint32_t*>(&h);
  lo = pack_bf16(x - hf.x, y - hf.y);
}

// The S accumulator of keys 16j..16j+15, split into P_hi and P_lo, gives
// the two A fragments of k-step j of P V (the f32 accumulator and the
// 16-bit A operand share their layout of rows and column pairs).
__device__ __forceinline__ void pack_p(uint32_t (&pa)[4][4],
                                       uint32_t (&pl)[4][4],
                                       const float (&p)[32]) {
#pragma unroll
  for (int j = 0; j < 4; ++j)
#pragma unroll
    for (int r = 0; r < 4; ++r)
      split_bf16(p[8 * j + 2 * r], p[8 * j + 2 * r + 1], pa[j][r], pl[j][r]);
}

// Fold one tile of scores into the running max m and partial sums l of
// this thread's two rows (a, b: accumulator entries e with bit 1 clear,
// set), in log2 units: scale_log2 is the softmax scale times log2(e), so
// that P = 2^(s * scale_log2 - m) takes one FMA and one ex2.  A tile that
// needs a mask is scaled first and masked as the scalar kernel masks (-1e30
// for a masked score, -inf for a key past lk); one that does not is scaled
// inside the FMA.  Leaves P (f32) in s and the factor alpha by which the
// accumulator must be rescaled.
__device__ __forceinline__ void online_softmax(
    float (&s)[32], float (&m_r)[2], float (&l_r)[2], float (&alpha)[2],
    float scale_log2, bool need_mask, int k0, int LK, int qpos_a,
    int qpos_b, int col_t, int causal, int window) {
  if (need_mask) {
#pragma unroll
    for (int e = 0; e < 32; ++e) {
      const int kk = k0 + 8 * (e >> 2) + col_t + (e & 1);
      const int qpos = (e & 2) ? qpos_b : qpos_a;
      const bool allowed =
          (!causal || kk <= qpos) && (window <= 0 || kk > qpos - window);
      s[e] = kk >= LK ? -INFINITY
                      : (allowed ? s[e] * scale_log2 : kNegBig);
    }
  }
  const float mul = need_mask ? 1.f : scale_log2;  // what s still needs
  // row max over the 4 threads that share each row (mul > 0: the max of
  // the scaled scores is the scaled max, rounding included)
  float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
  for (int e = 0; e < 32; ++e)
    mx[(e >> 1) & 1] = fmaxf(mx[(e >> 1) & 1], s[e]);
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
    mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
    mx[r] = fmaxf(m_r[r], mx[r] * mul);
    alpha[r] = ex2(m_r[r] - mx[r]);
    m_r[r] = mx[r];
    l_r[r] *= alpha[r];
  }
#pragma unroll
  for (int e = 0; e < 32; ++e) {
    const int r = (e >> 1) & 1;
    s[e] = ex2(fmaf(s[e], mul, -mx[r]));
    l_r[r] += s[e];
  }
}

// Key-tile range [lo, hi] that the 64 queries from row r0 can see (the
// scalar kernel's block range); empty (hi < lo) for rows past lq.
__device__ __forceinline__ void tile_range(int r0, int LQ, int LK, int causal,
                                           int window, int& lo, int& hi) {
  if (r0 >= LQ) {
    lo = 0;
    hi = -1;
    return;
  }
  const int off = LK - LQ;
  const int qmin = r0 + off;
  const int qmax = min(r0 + 64, LQ) - 1 + off;
  int k_lo = 0, k_hi = LK - 1;
  if (causal) k_hi = min(k_hi, qmax);
  if (window > 0) k_lo = max(k_lo, qmin - window + 1);
  lo = k_lo / kBK;
  hi = k_hi >= k_lo ? k_hi / kBK : lo - 1;
}

// One work item: a q-tile of kBQ queries of one q-head of one batch row,
// and the key tiles [t_lo, t_lo + n_tiles) that any of its warpgroups
// needs; warpgroup wg computes on [my_lo, my_hi] (empty for the producer).
// Items are numbered longest first (the last q-tile: under a causal mask
// it sees the most keys), q-heads fastest, so that the hq / hkv q-heads of
// a kv-head run side by side and L2 serves their repeated K/V reads.
struct Item {
  int q0, h, bi, t_lo, n_tiles, my_lo, my_hi;
};

__device__ __forceinline__ Item make_item(int it, int n_qtiles, int HQ,
                                          int B, int LQ, int LK, int causal,
                                          int window, int wg) {
  Item w;
  w.q0 = (n_qtiles - 1 - it / (HQ * B)) * kBQ;
  w.bi = it % (HQ * B) / HQ;
  w.h = it % HQ;
  int t_hi = -1;
  w.t_lo = 0;
  w.my_lo = 0;
  w.my_hi = -1;
  for (int g = 0; g < kConsumers; ++g) {
    int lo, hi;
    tile_range(w.q0 + 64 * g, LQ, LK, causal, window, lo, hi);
    if (hi >= lo) {
      w.t_lo = t_hi >= w.t_lo ? min(w.t_lo, lo) : lo;
      t_hi = max(t_hi, hi);
    }
    if (g == wg) {
      w.my_lo = lo;
      w.my_hi = hi;
    }
  }
  w.n_tiles = max(0, t_hi - w.t_lo + 1);
  return w;
}

// KSTEPS = ceil(d / 16) k-steps of S; BOXES = ceil(d / 64) column boxes.
// A persistent grid: block x runs items x, x + gridDim.x, ...; the producer
// runs ahead into the next item (its Q goes to the other of two Q buffers,
// its K/V tiles continue the ring) while the consumers finish this one.
template <int KSTEPS>
__global__ void __launch_bounds__(kThreads, 1)
    flash_fwd_wgmma_kernel(const __grid_constant__ CUtensorMap tq,
                           const __grid_constant__ CUtensorMap tk,
                           const __grid_constant__ CUtensorMap tv,
                           const __grid_constant__ CUtensorMap tq_last,
                           const __grid_constant__ CUtensorMap tk_last,
                           const __grid_constant__ CUtensorMap tv_last,
                           __nv_bfloat16* __restrict__ o, int B, int LQ,
                           int LK, int HQ, int HKV, int D, int causal,
                           int window, float scale) {
  using C = Cols<KSTEPS>;
  constexpr int BOXES = C::BOXES;
  constexpr uint32_t kQBytes = kBQ * C::ROW;
  constexpr uint32_t kStageBytes = 2 * kBK * C::ROW;  // K then V
  extern __shared__ uint8_t smem_raw[];
  const uint32_t sQ0 = (smem_u32(smem_raw) + 1023u) & ~1023u;  // 2 buffers
  const uint32_t sRing = sQ0 + 2 * kQBytes;
  const uint32_t sBars = sRing + kStages * kStageBytes;
  auto full_bar = [&](int s) { return sBars + 8u * s; };
  auto empty_bar = [&](int s) { return sBars + 8u * (kStages + s); };
  auto q_full = [&](int b) { return sBars + 8u * (2 * kStages + b); };
  auto q_empty = [&](int b) { return sBars + 8u * (2 * kStages + 2 + b); };

  const int n_qtiles = (LQ + kBQ - 1) / kBQ;
  const int n_items = n_qtiles * HQ * B;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int wg = warp >> 2;  // the producer warpgroup has wg == kConsumers

  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages; ++s) {
      mbar_init(full_bar(s), 1);
      mbar_init(empty_bar(s), kConsumers * 4);  // one arrival per warp
    }
    for (int b = 0; b < 2; ++b) {
      mbar_init(q_full(b), 1);
      mbar_init(q_empty(b), kConsumers * 4);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  if (wg == kConsumers) {
    // ---- producer: one thread; per item, Q into its buffer, then K/V tiles
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;" ::"n"(kProducerRegs));
    if (warp == kConsumers * 4 && lane == 0) {
      int g = 0;  // tiles through the ring so far
      for (int it = blockIdx.x, n = 0; it < n_items; it += gridDim.x, ++n) {
        const Item w = make_item(it, n_qtiles, HQ, B, LQ, LK, causal, window,
                                 wg);
        const int qb = n & 1;
        if (n >= 2) mbar_wait(q_empty(qb), ((n >> 1) - 1) & 1);
        mbar_expect_tx(q_full(qb), kQBytes);
        for (int c = 0; c < BOXES; ++c)
          tma_load_4d(sQ0 + qb * kQBytes + c * kBQ * 128,
                      c + 1 < BOXES ? &tq : &tq_last, q_full(qb), c * kBox,
                      w.h, w.q0, w.bi);
        const int hk = w.h / (HQ / HKV);
        for (int i = 0; i < w.n_tiles; ++i, ++g) {
          const int s = g % kStages;
          if (g >= kStages) mbar_wait(empty_bar(s), ((g / kStages) - 1) & 1);
          mbar_expect_tx(full_bar(s), kStageBytes);
          const int k0 = (w.t_lo + i) * kBK;
          const uint32_t sK = sRing + s * kStageBytes;
          const uint32_t sV = sK + kBK * C::ROW;
          for (int c = 0; c < BOXES; ++c) {
            const bool full = c + 1 < BOXES;
            tma_load_4d(sK + c * kBK * 128, full ? &tk : &tk_last,
                        full_bar(s), c * kBox, hk, k0, w.bi);
            tma_load_4d(sV + c * kBK * 128, full ? &tv : &tv_last,
                        full_bar(s), c * kBox, hk, k0, w.bi);
          }
        }
      }
    }
    return;
  }

  // ---- consumers: warpgroup wg owns query rows q0 + 64 wg .. + 63
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;" ::"n"(kConsumerRegs));
  const int col_t = 2 * (lane & 3);  // first column of each 8-column block
  const int off = LK - LQ;
  const float scale_log2 = scale * 1.4426950408889634f;  // log2(e)
  float oacc[BOXES][32];
  float m_r[2], l_r[2];  // running max; per-thread partial sums of each row
  float sacc[32];        // S of one tile, then its P in f32
#pragma unroll
  for (int e = 0; e < 32; ++e) sacc[e] = 0.f;
  uint32_t pa[4][4];     // P_hi and P_lo in bf16: the A operands of P V
  uint32_t pl[4][4];

  int g = 0;  // tiles through the ring so far
  for (int it = blockIdx.x, n = 0; it < n_items; it += gridDim.x, ++n) {
    const Item w = make_item(it, n_qtiles, HQ, B, LQ, LK, causal, window, wg);
    const int qb = n & 1;
    const uint32_t sQ = sQ0 + qb * kQBytes;
    const int r0w = w.q0 + wg * 64;
    const int qmin = r0w + off;
    const int qmax = min(r0w + 64, LQ) - 1 + off;
    // this thread's two rows of every accumulator fragment
    const int row_a = r0w + (warp & 3) * 16 + (lane >> 2);
    const int row_b = row_a + 8;
#pragma unroll
    for (int c = 0; c < BOXES; ++c)
#pragma unroll
      for (int e = 0; e < 32; ++e) oacc[c][e] = 0.f;
    m_r[0] = m_r[1] = kNegBig;
    l_r[0] = l_r[1] = 0.f;

    auto stage_k = [&](int i) {
      return sRing + ((g + i) % kStages) * kStageBytes;
    };
    auto wait_tile = [&](int i) {
      mbar_wait(full_bar((g + i) % kStages), ((g + i) / kStages) & 1);
    };
    auto release = [&](int i) {  // one arrival per warp, its products ended
      __syncwarp();
      if (lane == 0) mbar_arrive(empty_bar((g + i) % kStages));
    };
    auto softmax = [&](int i, float (&alpha)[2]) {
      const int k0 = (w.t_lo + i) * kBK;
      const bool need_mask = k0 + kBK > LK ||
                             (causal && k0 + kBK - 1 > qmin) ||
                             (window > 0 && k0 <= qmax - window);
      online_softmax(sacc, m_r, l_r, alpha, scale_log2, need_mask, k0, LK,
                     row_a + off, row_b + off, col_t, causal, window);
    };

    mbar_wait(q_full(qb), (n >> 1) & 1);
    // Tiles [first, last] of the item are this warpgroup's; it waits for
    // and releases the others (a tile at each end, or all of them when its
    // rows lie past lq) without computing.
    const bool mine = w.my_hi >= w.my_lo;
    const int first = mine ? w.my_lo - w.t_lo : w.n_tiles;
    const int last = mine ? w.my_hi - w.t_lo : w.n_tiles - 1;
    for (int i = 0; i < first; ++i) {
      wait_tile(i);
      release(i);
    }
    if (mine) {
      float alpha[2];
      wait_tile(first);
      fence_regs(sacc);
      wgmma_fence();
      issue_s<KSTEPS>(sacc, sQ, wg, stage_k(first));
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(sacc);
      softmax(first, alpha);  // O is still zero: nothing to rescale
      pack_p(pa, pl, sacc);
      // Steady state: issue S of tile i and P V of tile i - 1 together,
      // run the softmax of tile i under P V, then rescale O, release i - 1.
      for (int i = first + 1; i <= last; ++i) {
        wait_tile(i);
        fence_regs(sacc);
#pragma unroll
        for (int c = 0; c < BOXES; ++c) fence_regs(oacc[c], C::cols(c) / 2);
        wgmma_fence();
        issue_s<KSTEPS>(sacc, sQ, wg, stage_k(i));
        wgmma_commit();
        issue_pv<KSTEPS>(oacc, pa, pl, stage_k(i - 1) + kBK * C::ROW);
        wgmma_commit();
        wgmma_wait<1>();  // S of tile i
        fence_regs(sacc);
        softmax(i, alpha);
        wgmma_wait<0>();  // P V of tile i - 1
#pragma unroll
        for (int c = 0; c < BOXES; ++c) fence_regs(oacc[c], C::cols(c) / 2);
        release(i - 1);
#pragma unroll
        for (int c = 0; c < BOXES; ++c)
#pragma unroll
          for (int e = 0; e < C::cols(c) / 2; ++e)
            oacc[c][e] *= alpha[(e >> 1) & 1];
        pack_p(pa, pl, sacc);
      }
#pragma unroll
      for (int c = 0; c < BOXES; ++c) fence_regs(oacc[c], C::cols(c) / 2);
      wgmma_fence();
      issue_pv<KSTEPS>(oacc, pa, pl, stage_k(last) + kBK * C::ROW);
      wgmma_commit();
      wgmma_wait<0>();
#pragma unroll
      for (int c = 0; c < BOXES; ++c) fence_regs(oacc[c], C::cols(c) / 2);
      release(last);
    }
    for (int i = last + 1; i < w.n_tiles; ++i) {
      wait_tile(i);
      release(i);
    }
    // this item's Q is read no more: its buffer takes the item after next
    __syncwarp();
    if (lane == 0) mbar_arrive(q_empty(qb));
    g += w.n_tiles;

    // ---- epilogue: O / l in bf16, straight from the fragments
    const int64_t q_stride = (int64_t)HQ * D;
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      float l = l_r[r];
      l += __shfl_xor_sync(0xffffffffu, l, 1);
      l += __shfl_xor_sync(0xffffffffu, l, 2);
      l = fmaxf(l, 1e-30f);
      const int qi = r ? row_b : row_a;
      if (qi >= LQ) continue;
      __nv_bfloat16* orow =
          o + ((int64_t)w.bi * LQ + qi) * q_stride + (int64_t)w.h * D;
#pragma unroll
      for (int c = 0; c < BOXES; ++c)
#pragma unroll
        for (int j = 0; j < C::cols(c) / 8; ++j) {
          const int col = c * kBox + 8 * j + col_t;
          if (col < D) {
            const __nv_bfloat162 v = __floats2bfloat162_rn(
                oacc[c][4 * j + 2 * r] / l, oacc[c][4 * j + 2 * r + 1] / l);
            *reinterpret_cast<__nv_bfloat162*>(orow + col) = v;
          }
        }
    }
  }
}

typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                void*, const cuuint64_t*, const cuuint64_t*,
                                const cuuint32_t*, const cuuint32_t*,
                                CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion,
                                CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled is a driver API: take it from libcuda (loaded by
// the CUDA runtime already) so the library links without -lcuda.
EncodeTiled encoder() {
  static const EncodeTiled fn = []() -> EncodeTiled {
    void* lib = dlopen("libcuda.so.1", RTLD_NOW | RTLD_NOLOAD);
    if (lib == nullptr) lib = dlopen("libcuda.so.1", RTLD_NOW);
    if (lib == nullptr) return nullptr;
    return reinterpret_cast<EncodeTiled>(dlsym(lib, "cuTensorMapEncodeTiled"));
  }();
  return fn;
}

// One 4-D map over (d, heads, len, batch) with boxes of (cols, 1, rows,
// 1), the swizzle of a cols-wide row (cols * 2 bytes) and zero fill out of
// bounds.
bool encode(EncodeTiled fn, CUtensorMap* map, const void* ptr, int d,
            int heads, int len, int batch, int rows, int cols) {
  const cuuint64_t dims[4] = {(cuuint64_t)d, (cuuint64_t)heads,
                              (cuuint64_t)len, (cuuint64_t)batch};
  const cuuint64_t row = (cuuint64_t)d * 2;
  const cuuint64_t strides[3] = {row, row * heads, row * heads * len};
  const cuuint32_t box[4] = {(cuuint32_t)cols, 1, (cuuint32_t)rows, 1};
  const cuuint32_t elem[4] = {1, 1, 1, 1};
  const CUtensorMapSwizzle swizzle = cols == 64   ? CU_TENSOR_MAP_SWIZZLE_128B
                                     : cols == 32 ? CU_TENSOR_MAP_SWIZZLE_64B
                                                  : CU_TENSOR_MAP_SWIZZLE_32B;
  return fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(ptr),
            dims, strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE, swizzle,
            CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <int KSTEPS>
cudaError_t launch(EncodeTiled fn, const void* q, const void* k,
                   const void* v, void* o, int B, int LQ, int LK, int HQ,
                   int HKV, int D, int causal, int window, float scale,
                   cudaStream_t stream) {
  using C = Cols<KSTEPS>;
  // maps[i]: the 64-column boxes of q, k, v; maps[3 + i]: their last box
  CUtensorMap maps[6];
  const void* ptrs[3] = {q, k, v};
  const int heads[3] = {HQ, HKV, HKV}, lens[3] = {LQ, LK, LK};
  const int rows[3] = {kBQ, kBK, kBK};
  for (int i = 0; i < 3; ++i) {
    if (!encode(fn, &maps[3 + i], ptrs[i], D, heads[i], lens[i], B, rows[i],
                C::LAST))
      return cudaErrorInvalidValue;
    if (C::BOXES == 1)
      maps[i] = maps[3 + i];  // no full box: never read
    else if (!encode(fn, &maps[i], ptrs[i], D, heads[i], lens[i], B, rows[i],
                     kBox))
      return cudaErrorInvalidValue;
  }
  const uint32_t smem = smem_bytes<KSTEPS>();
  cudaError_t e = cudaFuncSetAttribute(
      flash_fwd_wgmma_kernel<KSTEPS>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return e;
  // one block per SM, or fewer for few items
  int dev = 0, sms = 0;
  e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e != cudaSuccess) return e;
  const long long items = (long long)((LQ + kBQ - 1) / kBQ) * HQ * B;
  if (items >= (1ll << 31)) return cudaErrorInvalidValue;
  const int grid = (int)(items < sms ? items : sms);
  flash_fwd_wgmma_kernel<KSTEPS><<<grid, kThreads, smem, stream>>>(
      maps[0], maps[1], maps[2], maps[3], maps[4], maps[5],
      (__nv_bfloat16*)o, B, LQ, LK, HQ, HKV, D, causal, window, scale);
  return cudaGetLastError();
}

}  // namespace

// bf16 attention on the tensor cores; called by repro_flash_attention_fwd,
// which has checked d % 8 == 0, d <= 128, hq % hkv == 0, 16-byte aligned
// q/k/v and non-empty sizes.
cudaError_t flash_fwd_wgmma(const void* q, const void* k, const void* v,
                            void* o, int b, int lq, int lk, int hq, int hkv,
                            int d, int causal, int window, float scale,
                            cudaStream_t s) {
  const EncodeTiled fn = encoder();
  if (fn == nullptr) return cudaErrorSharedObjectInitFailed;
  switch ((d + 15) / 16) {
#define REPRO_FLASH_CASE(N)                                                  \
  case N:                                                                    \
    return launch<N>(fn, q, k, v, o, b, lq, lk, hq, hkv, d, causal, window,  \
                     scale, s);
    REPRO_FLASH_CASE(1)
    REPRO_FLASH_CASE(2)
    REPRO_FLASH_CASE(3)
    REPRO_FLASH_CASE(4)
    REPRO_FLASH_CASE(5)
    REPRO_FLASH_CASE(6)
    REPRO_FLASH_CASE(7)
    REPRO_FLASH_CASE(8)
#undef REPRO_FLASH_CASE
    default:
      return cudaErrorInvalidValue;
  }
}
