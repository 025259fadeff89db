// Causal grouped-query attention for Hopper (sm_90a) on wgmma, TMA and a
// warp-specialised pipeline, bf16 at head dims 64 and 128:
//
//     out[b, i, h, :] = sum_{j <= i} softmax_j(q[b, i, h] . k[b, j, g] / sqrt(Dh))
//                       * v[b, j, g, :],        g = h / (H / Hkv)
//
// q: [B, S, H, Dh]; k, v: [B, S, Hkv, Dh]; out: [B, S, H, Dh], all bf16 and
// row-major.  Scores, the running max, the denominator and the accumulator
// are fp32; a masked score takes no part in the softmax (the TPU kernel's
// -1e30 gives it weight 0 as well); the probabilities are cast to bf16
// before P.V, as the TPU kernel casts p to v's type; the final denominator
// is floored at 1e-30.  Any S is taken.  fp32, and bf16 at head dims 8, 16
// and 32, stay on flash_attention.cu (mma.sync), chosen by the wrapper.
//
// Replaces the TPU kernel src/repro/kernels/flash_attention/kernel.py
// (flash_attention_pallas, pl.pallas_call at line 86).
//
// What bounds it on an H100: operations.  At phi4-mini's prefill shape
// (B=4, S=2048, H=24, Hkv=8, Dh=128) the causal half of the two products is
// 1.03e11 FLOP: 0.104 ms at the data sheet's 989 TFLOP/s bf16 (H100 SXM,
// 700 W), against 0.040 ms for its 134 MB of q, k, v and out at 3.35 TB/s.
// What the design does about it:
//   - every product is a warpgroup wgmma.mma_async with fp32 accumulators
//     in registers: S = Q.K^T as m64n128k16 with Q and K both read from
//     shared memory (K-major, as stored), O += P.V as m64n{Dh}k16 with P
//     from registers after the bf16 cast and V from shared memory through
//     the transpose bit (V's [keys, Dh] tile is MN-major for B), so no
//     copy of V is transposed and the scores never leave registers;
//   - warp-specialised: a producer warpgroup, one thread of which issues
//     every TMA load (4-D tensor maps over (Dh, heads, S, B), 128-byte
//     swizzled boxes of 64 bf16, zero-filled past S) into two Q buffers
//     and a two-stage K/V ring guarded by full/empty mbarriers, and which
//     hands its registers to the two consumer warpgroups (setmaxnreg 24 /
//     240), each owning 64 of the item's 128 query rows;
//   - within a consumer, the next tile's S = Q.K^T and the last tile's P.V
//     are issued together and the softmax runs while P.V does; the two
//     consumers take turns at the tensor cores (named barriers), so one's
//     softmax also runs under the other's products;
//   - persistent: one CTA per SM walks the work items (128 query rows of
//     one (b, query head)) longest first, in snake order across the CTAs,
//     so causal work, which varies 16:1 between items at S = 2048, evens
//     out, and the next item's Q and first K/V tiles load under this
//     item's last products and stores;
//   - causal work: an item walks its kv tiles from the diagonal down,
//     masks only that first (diagonal, or ragged) tile and skips every
//     tile above it;
//   - deterministic: no atomics and no split over keys, so two launches on
//     the same inputs give the same bits.
#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int BM = 128;      // query rows per item, 64 per consumer warpgroup
constexpr int BN = 128;      // keys per K/V tile
constexpr int STAGES = 2;    // K/V ring depth
constexpr int THREADS = 384; // two consumer warpgroups, then the producer
constexpr int BOX = 64;      // bf16 per TMA box row: one 128-byte swizzle row
constexpr int ROW = 128;     // bytes per smem row of a box
constexpr unsigned FULL = 0xffffffffu;
constexpr float LOG2E = 1.4426950408889634f;

// Shared memory, from a 1024-byte aligned base (128-byte swizzle atoms):
// two Q buffers (items alternate between them) as DH/64 boxes of [BM][64]
// each, then each stage's K and V tiles as DH/64 boxes of [BN][64], then
// the mbarriers.
template <int DH>
struct Layout {
  static constexpr int BOXES = DH / BOX;
  static constexpr uint32_t Q_BYTES = BM * DH * 2;
  static constexpr uint32_t KV_BYTES = BN * DH * 2;
  static constexpr uint32_t K_OFF = 2 * Q_BYTES;
  static constexpr uint32_t V_OFF = K_OFF + STAGES * KV_BYTES;
  static constexpr uint32_t BAR_OFF = V_OFF + STAGES * KV_BYTES;
  // full_q[2], empty_q[2], full_k[STAGES], full_v[STAGES],
  // empty_k[STAGES], empty_v[STAGES]
  static constexpr uint32_t BARS = 4 + 4 * STAGES;
  static constexpr uint32_t BYTES = BAR_OFF + BARS * 8 + 1024;  // + alignment
};

// ---- mbarriers and TMA ------------------------------------------------------

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n"
               :: "r"(bar), "r"(count) : "memory");
}
__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
               :: "r"(bar), "r"(bytes) : "memory");
}
__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n"
               :: "r"(bar) : "memory");
}
__device__ __forceinline__ bool mbar_try_wait(uint32_t bar, uint32_t parity) {
  uint32_t ok;
  asm volatile(
      "{\n.reg .pred p;\n"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
      "selp.u32 %0, 1, 0, p;\n}\n"
      : "=r"(ok) : "r"(bar), "r"(parity) : "memory");
  return ok != 0;
}
// Wait for the phase of parity `parity` to complete.  (No trap on a long
// wait: a trap anywhere in the kernel keeps ptxas from giving the consumer
// warpgroups the registers setmaxnreg raises them to.)
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  while (!mbar_try_wait(bar, parity)) {
  }
}

// one box of a 4-D tensor map (Dh, heads, S, B) into shared memory
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map,
                                         uint32_t bar, int d, int head,
                                         int row, int b) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4, %5, %6}], [%2];\n"
      :: "r"(dst), "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(d),
         "r"(head), "r"(row), "r"(b)
      : "memory");
}

// ---- wgmma ------------------------------------------------------------------

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" :: "n"(N) : "memory");
}
// pins registers that an asynchronous wgmma reads or writes, so the
// compiler moves no access to them across the issue or the wait
template <int N>
__device__ __forceinline__ void reg_fence(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}
template <int N>
__device__ __forceinline__ void reg_fence(uint32_t (&r)[N][4]) {
#pragma unroll
  for (int i = 0; i < N; ++i) {
    asm volatile("" : "+r"(r[i][0]), "+r"(r[i][1]), "+r"(r[i][2]),
                 "+r"(r[i][3])::"memory");
  }
}

// The two consumer warpgroups take turns at the tensor cores: each issues
// its products between a sync on its own named barrier and an arrive on
// the other's, so one's softmax runs while the other's products do.
__device__ __forceinline__ void sched_sync(int c) {
  asm volatile("bar.sync %0, 256;\n" :: "r"(1 + c) : "memory");
}
__device__ __forceinline__ void sched_arrive(int c) {
  asm volatile("bar.arrive %0, 256;\n" :: "r"(2 - c) : "memory");
}

// Shared-memory matrix descriptor of a 128-byte swizzled operand: start
// address, leading and stride byte offsets (16-byte units), layout type 1.
// K-major (Q, K): rows of 64 bf16, 8-row groups 1024 bytes apart (stride
// offset); the leading offset is unused.  MN-major (V): the leading offset
// is the distance between 64-wide column boxes, the stride offset between
// 8-key groups.
__device__ __forceinline__ uint64_t sw128_desc(uint32_t addr, uint32_t lbo,
                                               uint32_t sbo) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)(lbo >> 4) << 16)
         | ((uint64_t)(sbo >> 4) << 32) | (1ull << 62);
}

#define D8(i)                                                          \
  "+f"(d[i]), "+f"(d[i + 1]), "+f"(d[i + 2]), "+f"(d[i + 3]),          \
      "+f"(d[i + 4]), "+f"(d[i + 5]), "+f"(d[i + 6]), "+f"(d[i + 7])

// d (64 x 128, fp32) = [d +] A (64 x 16) . B (128 x 16)^T, A and B in shared
// memory, both K-major; d is overwritten when scale_d is 0
__device__ __forceinline__ void wgmma_ss_n128(float (&d)[64], uint64_t da,
                                              uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63}, "
      "%64, %65, p, 1, 1, 0, 0;\n}\n"
      : D8(0), D8(8), D8(16), D8(24), D8(32), D8(40), D8(48), D8(56)
      : "l"(da), "l"(db), "r"(scale_d));
}

// d (64 x 128, fp32) += A (64 x 16, bf16 in registers) . B (16 x 128), B in
// shared memory, MN-major (transpose bit set)
__device__ __forceinline__ void wgmma_rs_n128(float (&d)[64],
                                              const uint32_t (&a)[4],
                                              uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63}, "
      "{%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : D8(0), D8(8), D8(16), D8(24), D8(32), D8(40), D8(48), D8(56)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// the same at N = 64 (head dim 64)
__device__ __forceinline__ void wgmma_rs_n64(float (&d)[32],
                                             const uint32_t (&a)[4],
                                             uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : D8(0), D8(8), D8(16), D8(24)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

#undef D8

// S = Q.K^T over the head dim: DH/16 k-steps, 32 bytes apart inside a
// 64-wide box, the next box BM (Q) or BN (K) rows on
template <int DH>
__device__ __forceinline__ void qk(float (&s)[64], uint32_t q, uint32_t k) {
#pragma unroll
  for (int kk = 0; kk < DH / 16; ++kk) {
    const uint32_t col = (kk % 4) * 32;
    wgmma_ss_n128(s, sw128_desc(q + (kk / 4) * BM * ROW + col, 16, 1024),
                  sw128_desc(k + (kk / 4) * BN * ROW + col, 16, 1024),
                  kk > 0);
  }
}

// O += P.V over the tile's keys: BN/16 k-steps of 16 keys (two 8-key
// swizzle groups, 2048 bytes) each
template <int DH>
__device__ __forceinline__ void pv(float (&o)[DH / 2],
                                   const uint32_t (&p)[BN / 16][4],
                                   uint32_t v) {
#pragma unroll
  for (int kk = 0; kk < BN / 16; ++kk) {
    const uint64_t db = sw128_desc(v + kk * 16 * ROW, BN * ROW, 1024);
    if constexpr (DH == 128) {
      wgmma_rs_n128(o, p[kk], db);
    } else {
      wgmma_rs_n64(o, p[kk], db);
    }
  }
}

// ---- softmax in registers ---------------------------------------------------
// A thread's accumulator elements: 8-column block j, element e -> row
// 16 * warp + lane / 4 + 8 * (e >= 2), column 8 * j + 2 * (lane % 4) + e % 2.

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);   // .x = lo, low half
  return *reinterpret_cast<uint32_t*>(&v);
}

// Online softmax of one tile of raw scores s (masked ones -inf) for the
// thread's two rows: s becomes p = exp(scale * (s - m_new)), m the new row
// max, l this thread's share of the running denominator; alpha = exp(scale
// * (m_old - m_new)) rescales what was accumulated.
__device__ __forceinline__ void online_softmax(float (&s)[64], float (&m)[2],
                                               float (&l)[2],
                                               float (&alpha)[2],
                                               float scale_log2) {
  float mx[2] = {m[0], m[1]};
#pragma unroll
  for (int j = 0; j < 16; ++j) {
    mx[0] = fmaxf(mx[0], fmaxf(s[4 * j], s[4 * j + 1]));
    mx[1] = fmaxf(mx[1], fmaxf(s[4 * j + 2], s[4 * j + 3]));
  }
  float ms[2], sum[2] = {0.f, 0.f};
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    mx[i] = fmaxf(mx[i], __shfl_xor_sync(FULL, mx[i], 1));
    mx[i] = fmaxf(mx[i], __shfl_xor_sync(FULL, mx[i], 2));
    alpha[i] = ex2((m[i] - mx[i]) * scale_log2);   // 0 on the first tile
    m[i] = mx[i];
    ms[i] = mx[i] * scale_log2;
  }
#pragma unroll
  for (int j = 0; j < 16; ++j) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      s[4 * j + e] = ex2(fmaf(s[4 * j + e], scale_log2, -ms[e >> 1]));
      sum[e >> 1] += s[4 * j + e];
    }
  }
  l[0] = l[0] * alpha[0] + sum[0];
  l[1] = l[1] * alpha[1] + sum[1];
}

// p (fp32) -> the A fragments of P.V: k-step kk covers blocks 2kk, 2kk+1
__device__ __forceinline__ void to_bf16(uint32_t (&p)[BN / 16][4],
                                        const float (&s)[64]) {
#pragma unroll
  for (int kk = 0; kk < BN / 16; ++kk) {
    p[kk][0] = pack_bf16(s[8 * kk], s[8 * kk + 1]);
    p[kk][1] = pack_bf16(s[8 * kk + 2], s[8 * kk + 3]);
    p[kk][2] = pack_bf16(s[8 * kk + 4], s[8 * kk + 5]);
    p[kk][3] = pack_bf16(s[8 * kk + 6], s[8 * kk + 7]);
  }
}

// O *= alpha, row by row
template <int N>
__device__ __forceinline__ void rescale(float (&o)[N],
                                        const float (&alpha)[2]) {
#pragma unroll
  for (int j = 0; j < N / 4; ++j) {
    o[4 * j] *= alpha[0];
    o[4 * j + 1] *= alpha[0];
    o[4 * j + 2] *= alpha[1];
    o[4 * j + 3] *= alpha[1];
  }
}

// The work items, longest first: item t is q tile n_qt - 1 - t / BH of
// (b, h) = divmod(t % BH, H).  A persistent CTA takes items r * G + c in
// even rounds r and r * G + G - 1 - c in odd ones (G CTAs, this one c), so
// long and short items pair up across the CTAs.
struct Item {
  int b, h, qt;
};
__device__ __forceinline__ int item_index(int r) {
  return r * gridDim.x
         + ((r & 1) ? gridDim.x - 1 - blockIdx.x : blockIdx.x);
}
__device__ __forceinline__ Item item(int t, int H, int BH, int n_qt) {
  const int bh = t % BH;
  return {bh / H, bh % H, n_qt - 1 - t / BH};
}

template <int DH>
__global__ void __launch_bounds__(THREADS, 1)
flash_kernel_sm90(const __grid_constant__ CUtensorMap tq,
                  const __grid_constant__ CUtensorMap tk,
                  const __grid_constant__ CUtensorMap tv,
                  __nv_bfloat16* __restrict__ out, int S, int H, int Hkv,
                  int BH, int n_qt, float scale_log2) {
  using L = Layout<DH>;
  extern __shared__ unsigned char smem_raw[];
  const uint32_t base =
      (static_cast<uint32_t>(__cvta_generic_to_shared(smem_raw)) + 1023)
      & ~1023u;
  const uint32_t q_smem = base, k_smem = base + L::K_OFF,
                 v_smem = base + L::V_OFF, bars = base + L::BAR_OFF;
  // item r reads Q buffer r % 2, in that buffer's round r / 2
  auto q_buf = [&](int r) { return q_smem + (r & 1) * L::Q_BYTES; };
  auto full_q = [&](int r) { return bars + 8 * (r & 1); };
  auto empty_q = [&](int r) { return bars + 8 * (2 + (r & 1)); };
  auto full_k = [&](int st) { return bars + 8 * (4 + st); };
  auto full_v = [&](int st) { return bars + 8 * (4 + STAGES + st); };
  auto empty_k = [&](int st) { return bars + 8 * (4 + 2 * STAGES + st); };
  auto empty_v = [&](int st) { return bars + 8 * (4 + 3 * STAGES + st); };
  const int items = BH * n_qt, rep = H / Hkv;

  if (threadIdx.x == 0) {
    for (int x = 0; x < 2; ++x) {
      mbar_init(full_q(x), 1);
      mbar_init(empty_q(x), 8);    // one arrival per consumer warp
    }
    for (int st = 0; st < STAGES; ++st) {
      mbar_init(full_k(st), 1);
      mbar_init(full_v(st), 1);
      mbar_init(empty_k(st), 8);
      mbar_init(empty_v(st), 8);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  // The K/V ring is one sequence over every item of this CTA: its j-th
  // tile sits in stage j % STAGES, in that stage's round j / STAGES.
  const int wg = threadIdx.x / 128;   // 0, 1: consumers; 2: the producer
  if (wg == 2) {
    // ---- producer: one thread issues every load --------------------------
    asm volatile("setmaxnreg.dec.sync.aligned.u32 24;\n");
    if (threadIdx.x == 256) {
      int j = 0;
      for (int r = 0;; ++r) {
        const int t = item_index(r);
        if (t >= items) break;
        const Item w = item(t, H, BH, n_qt);
        const int g = w.h / rep, n = w.qt + 1;
        mbar_wait(empty_q(r), ((r >> 1) & 1) ^ 1);
        mbar_expect_tx(full_q(r), L::Q_BYTES);
#pragma unroll
        for (int x = 0; x < L::BOXES; ++x) {
          tma_load(q_buf(r) + x * BM * ROW, &tq, full_q(r), x * BOX, w.h,
                   w.qt * BM, w.b);
        }
        // kv tiles from the diagonal down
        for (int i = 0; i < n; ++i, ++j) {
          const int st = j % STAGES, row = (n - 1 - i) * BN;
          const uint32_t ph = (j / STAGES) & 1;
          mbar_wait(empty_k(st), ph ^ 1);
          mbar_expect_tx(full_k(st), L::KV_BYTES);
#pragma unroll
          for (int x = 0; x < L::BOXES; ++x) {
            tma_load(k_smem + st * L::KV_BYTES + x * BN * ROW, &tk,
                     full_k(st), x * BOX, g, row, w.b);
          }
          mbar_wait(empty_v(st), ph ^ 1);
          mbar_expect_tx(full_v(st), L::KV_BYTES);
#pragma unroll
          for (int x = 0; x < L::BOXES; ++x) {
            tma_load(v_smem + st * L::KV_BYTES + x * BN * ROW, &tv,
                     full_v(st), x * BOX, g, row, w.b);
          }
        }
      }
    }
  } else {
    // ---- consumers: 64 query rows per warpgroup ---------------------------
    asm volatile("setmaxnreg.inc.sync.aligned.u32 240;\n");
    const int c = wg, t = threadIdx.x - 128 * wg;
    const int warp = t / 32, lane = t % 32;
    auto k_tile = [&](int j) { return k_smem + (j % STAGES) * L::KV_BYTES; };
    auto v_tile = [&](int j) { return v_smem + (j % STAGES) * L::KV_BYTES; };
    auto ring_phase = [&](int j) { return (uint32_t)(j / STAGES) & 1; };
    // release what the warp has read: one arrival per warp
    auto release = [&](uint32_t bar) {
      if (lane == 0) mbar_arrive(bar);
    };

    float o[DH / 2], s[64], m[2], l[2], alpha[2];
    uint32_t p[BN / 16][4];
    if (c == 1) sched_arrive(c);   // warpgroup 0 issues first
    int j = 0;
    for (int r = 0;; ++r) {
      const int ti = item_index(r);
      if (ti >= items) break;
      const Item w = item(ti, H, BH, n_qt);
      const int n = w.qt + 1;      // kv tiles up to and with the diagonal
      const int row0 = w.qt * BM + c * 64 + warp * 16 + lane / 4;
#pragma unroll
      for (int i = 0; i < DH / 2; ++i) o[i] = 0.f;
      m[0] = m[1] = -INFINITY;
      l[0] = l[1] = 0.f;

      // the diagonal tile (the only one masked): keys past the row or
      // past S
      const uint32_t q_wg = q_buf(r) + c * 64 * ROW;
      mbar_wait(full_q(r), (r >> 1) & 1);
      mbar_wait(full_k(j % STAGES), ring_phase(j));
      __syncwarp();
      sched_sync(c);
      reg_fence(s);
      wgmma_fence();
      qk<DH>(s, q_wg, k_tile(j));
      wgmma_commit();
      sched_arrive(c);
      wgmma_wait<0>();
      reg_fence(s);
      release(empty_k(j % STAGES));
      if (n == 1) release(empty_q(r));
      const int kv0 = (n - 1) * BN;
#pragma unroll
      for (int jj = 0; jj < 16; ++jj) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int key = kv0 + 8 * jj + 2 * (lane % 4) + (e & 1);
          const int row = row0 + 8 * (e >> 1);
          if (key > row || key >= S) s[4 * jj + e] = -INFINITY;
        }
      }
      online_softmax(s, m, l, alpha, scale_log2);
      to_bf16(p, s);

      // then the tiles below it: this tile's S = Q.K^T and the last
      // tile's P.V run while the other warpgroup's softmax does, and P.V
      // while this tile's softmax does; O takes the last softmax's
      // rescale in between
      for (int i = 1; i < n; ++i) {
        const int jk = j + i, jv = j + i - 1;
        mbar_wait(full_k(jk % STAGES), ring_phase(jk));
        __syncwarp();
        sched_sync(c);
        reg_fence(s);
        wgmma_fence();
        qk<DH>(s, q_wg, k_tile(jk));
        wgmma_commit();
        rescale(o, alpha);
        mbar_wait(full_v(jv % STAGES), ring_phase(jv));
        __syncwarp();
        reg_fence(o);
        reg_fence(p);
        wgmma_fence();
        pv<DH>(o, p, v_tile(jv));
        wgmma_commit();
        sched_arrive(c);
        wgmma_wait<1>();
        reg_fence(s);
        release(empty_k(jk % STAGES));
        if (i == n - 1) release(empty_q(r));   // the item's last Q.K^T
        online_softmax(s, m, l, alpha, scale_log2);
        wgmma_wait<0>();
        reg_fence(o);
        reg_fence(p);
        release(empty_v(jv % STAGES));
        to_bf16(p, s);
      }
      rescale(o, alpha);
      const int jv = j + n - 1;
      mbar_wait(full_v(jv % STAGES), ring_phase(jv));
      __syncwarp();
      reg_fence(o);
      reg_fence(p);
      wgmma_fence();
      pv<DH>(o, p, v_tile(jv));
      wgmma_commit();
      wgmma_wait<0>();
      reg_fence(o);
      release(empty_v(jv % STAGES));
      j += n;

      // the quad's denominators, then rows below S stored
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        l[i] += __shfl_xor_sync(FULL, l[i], 1);
        l[i] += __shfl_xor_sync(FULL, l[i], 2);
        const float inv = 1.f / fmaxf(l[i], 1e-30f);
        const int row = row0 + 8 * i;
        if (row < S) {
          __nv_bfloat16* dst = out + (((size_t)w.b * S + row) * H + w.h) * DH
                               + 2 * (lane % 4);
#pragma unroll
          for (int jj = 0; jj < DH / 8; ++jj) {
            *reinterpret_cast<uint32_t*>(dst + 8 * jj) = pack_bf16(
                o[4 * jj + 2 * i] * inv, o[4 * jj + 2 * i + 1] * inv);
          }
        }
      }
    }
  }
}

// ---- host side --------------------------------------------------------------

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                 void*, const cuuint64_t*, const cuuint64_t*,
                                 const cuuint32_t*, const cuuint32_t*,
                                 CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion,
                                 CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled lives in libcuda: fetched through the runtime's
// entry-point query, so the library links no -lcuda
EncodeTiled encode_fn() {
  static EncodeTiled fn = nullptr;
  if (!fn) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &found);
#else
    const cudaError_t err = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
    if (err == cudaSuccess && found == cudaDriverEntryPointSuccess) {
      fn = reinterpret_cast<EncodeTiled>(p);
    }
  }
  return fn;
}

// [B, S, heads, Dh] bf16 as a 4-D map (Dh, heads, S, B); boxes of 64 x 1 x
// 128 x 1 with 128-byte swizzle; rows past S read as zeros
CUresult make_map(CUtensorMap* map, EncodeTiled encode, const void* ptr,
                  int B, int S, int heads, int Dh) {
  const cuuint64_t dims[4] = {(cuuint64_t)Dh, (cuuint64_t)heads,
                              (cuuint64_t)S, (cuuint64_t)B};
  const cuuint64_t strides[3] = {(cuuint64_t)Dh * 2,
                                 (cuuint64_t)heads * Dh * 2,
                                 (cuuint64_t)S * heads * Dh * 2};
  const cuuint32_t box[4] = {BOX, 1, BM, 1};   // BM == BN
  const cuuint32_t elem[4] = {1, 1, 1, 1};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4,
                const_cast<void*>(ptr), dims, strides, box, elem,
                CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
}

template <int DH>
int launch(const void* q, const void* k, const void* v, void* out, int B,
           int S, int H, int Hkv, cudaStream_t stream) {
  static_assert(BM == BN, "one box shape serves q, k and v");
  static bool configured = false;
  if (!configured) {
    const cudaError_t err = cudaFuncSetAttribute(
        flash_kernel_sm90<DH>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)Layout<DH>::BYTES);
    if (err != cudaSuccess) return err;
    configured = true;
  }
  const EncodeTiled encode = encode_fn();
  if (!encode) return cudaErrorNotSupported;
  CUtensorMap tq, tk, tv;
  CUresult r = make_map(&tq, encode, q, B, S, H, DH);
  if (r == CUDA_SUCCESS) r = make_map(&tk, encode, k, B, S, Hkv, DH);
  if (r == CUDA_SUCCESS) r = make_map(&tv, encode, v, B, S, Hkv, DH);
  if (r != CUDA_SUCCESS) return -(int)r;   // a CUresult, negated
  int dev = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) {
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  }
  if (err != cudaSuccess) return err;
  const int n_qt = (S + BM - 1) / BM, items = B * H * n_qt;
  flash_kernel_sm90<DH>
      <<<items < sms ? items : sms, THREADS, Layout<DH>::BYTES, stream>>>(
          tq, tk, tv, static_cast<__nv_bfloat16*>(out), S, H, Hkv, B * H,
          n_qt, LOG2E / sqrtf((float)DH));
  return cudaGetLastError();
}

}  // namespace

// Returns 0 on success, a CUDA runtime error of the launch, or the
// CUresult of the tensor-map encoding negated; cudaErrorInvalidValue for
// shapes the kernel does not take.
extern "C" int flash_attention_sm90_launch(const void* q, const void* k,
                                           const void* v, void* out, int B,
                                           int S, int H, int Hkv, int Dh,
                                           void* stream) {
  if (B <= 0 || S <= 0 || Hkv <= 0 || H % Hkv != 0
      || (long long)B * H * ((S + BM - 1) / BM) > 0x7fffffffLL) {
    return cudaErrorInvalidValue;
  }
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (Dh) {
    case 64: return launch<64>(q, k, v, out, B, S, H, Hkv, st);
    case 128: return launch<128>(q, k, v, out, B, S, H, Hkv, st);
    default: return cudaErrorInvalidValue;
  }
}
