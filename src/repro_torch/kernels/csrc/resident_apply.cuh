// The resident hop apply shared by delta_apply.cu, extremum_apply.cu and
// mlp_apply.cu (sm_90a, plain fp32):
//
//     S' = fold(S, M, ...);   x = f(S');   h = act(x @ W + b)
//
// A row tile's inputs arrive in shared memory through bulk async copies
// (cp.async.bulk on an mbarrier); W stays resident in shared memory for
// the whole launch; a team of 4 warps folds the tile once (S' written
// once, x staged in shared memory) and multiplies x by W with fp32 FMAs
// in k order, TM rows x 8 columns a thread (Frag, team_product).
//
// What bounds such a product on an H100: its FMAs are fed from shared
// memory, whose 128 bytes a clock let a TM x 8 register tile reach at most
// 2 TM / (TM + 8) of the SM's FMA rate (2/3 at TM = 4); each quarter-warp
// reads its x rows as one broadcast float4 and 8 consecutive float4s of W.
//
// resident_kernel<TM, Fold> is the persistent loop of delta_apply and
// extremum_apply: a CTA of one or two teams sharing W walks row tiles
// (tile, tile + stride, ...), each team with one stage of inputs in
// flight under its FMAs.  The Fold functor is the elementwise part: from
// one float4 of S, M (and, masked, reagg and the mask) and the row's value
// (k, for delta_apply's mean) it returns S' and x.  mlp_apply.cu builds
// its own loop (two products over the staged tile) from the same parts.
#pragma once

#include <cstdint>
#include <cuda_runtime.h>

namespace resident {

constexpr int TEAM_THREADS = 128;  // a team: 4 warps, one per scheduler
constexpr int TN = 8;             // output columns a thread accumulates

__host__ __device__ constexpr size_t round16(size_t n) {
  return (n + 15) / 16 * 16;
}

// The shared memory of resident_kernel: W [Din][Dout], then for each team
// x [br][Din], a stage of `cell_bytes` a cell (S, M, ... planes of
// [br][Din]) and `row_bytes` a row (the tile's row values), then teams + 1
// mbarriers.  The 8 lanes of a quarter-warp share their x rows, so x
// needs no padding.
struct Plan {
  int br, teams;
  size_t plane, stage, team, bars, bytes;
  __host__ __device__ Plan(int Din, int Dout, int br_, int n_teams,
                           int cell_bytes, int row_bytes) {
    br = br_;
    teams = n_teams;
    plane = static_cast<size_t>(br) * Din * 4;
    stage = static_cast<size_t>(br) * Din * cell_bytes;
    team = plane + stage + round16(static_cast<size_t>(br) * row_bytes);
    bars = static_cast<size_t>(Din) * Dout * 4 + teams * team;
    bytes = bars + (teams + 1) * 8;
  }
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}
__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n"
               :: "r"(bar), "r"(count) : "memory");
}
__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
               :: "r"(bar), "r"(bytes) : "memory");
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
// Wait for the phase of parity `parity` to complete.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  while (!mbar_try_wait(bar, parity)) {
  }
}
// `bytes` (a multiple of 16) from global to shared memory, both 16-byte
// aligned, counted on the mbarrier at `bar`.
__device__ __forceinline__ void bulk_load(uint32_t dst, const void* src,
                                          uint32_t bytes, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n"
      :: "r"(dst), "l"(src), "r"(bytes), "r"(bar) : "memory");
}
// Order this thread's earlier shared-memory accesses before the bulk
// copies it issues next.
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

__device__ __forceinline__ float pick(const float4& v, int k) {
  return k == 0 ? v.x : k == 1 ? v.y : k == 2 ? v.z : v.w;
}

// One thread's operands for a block of 4 k: x of its TM rows (4 apart,
// rows of lda floats) and B of its 8 columns (two float4s 32 apart, rows
// of ldb floats) at each of the 4 k.
template <int TM>
struct Frag {
  float4 x[TM];
  float4 w[4][2];
  __device__ __forceinline__ void load(const float* xp, const float* wp,
                                       int lda, int ldb, int k) {
#pragma unroll
    for (int a = 0; a < TM; ++a)
      x[a] = *reinterpret_cast<const float4*>(xp + 4 * a * lda + k);
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      const float* wk = wp + static_cast<size_t>(k + kk) * ldb;
      w[kk][0] = *reinterpret_cast<const float4*>(wk);
      w[kk][1] = *reinterpret_cast<const float4*>(wk + 32);
    }
  }
  // acc[a][j] += x[a][kk] * w[kk][j], kk in order
  __device__ __forceinline__ void fma(float (&acc)[TM][TN]) const {
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
#pragma unroll
      for (int a = 0; a < TM; ++a) {
        const float xv = pick(x[a], kk);
        acc[a][0] = fmaf(xv, w[kk][0].x, acc[a][0]);
        acc[a][1] = fmaf(xv, w[kk][0].y, acc[a][1]);
        acc[a][2] = fmaf(xv, w[kk][0].z, acc[a][2]);
        acc[a][3] = fmaf(xv, w[kk][0].w, acc[a][3]);
        acc[a][4] = fmaf(xv, w[kk][1].x, acc[a][4]);
        acc[a][5] = fmaf(xv, w[kk][1].y, acc[a][5]);
        acc[a][6] = fmaf(xv, w[kk][1].z, acc[a][6]);
        acc[a][7] = fmaf(xv, w[kk][1].w, acc[a][7]);
      }
  }
};

// Named barrier of one team's 128 threads (barrier 0 is __syncthreads').
__device__ __forceinline__ void team_sync(int team) {
  asm volatile("bar.sync %0, 128;\n" :: "r"(team + 1) : "memory");
}

// A team's product out = A @ B over shared memory: A [br][K] (K a multiple
// of 8), B [K][ldb], `ncols` output columns.  The output is cut into units
// of 4 TM rows x 64 columns, the team's warps taking units in turn; in a
// unit a thread holds rows r0 + 4 a (a < TM) and columns c .. c + 3 and
// c + 32 .. c + 35, and hands them to epi(r0, c, acc) once its sums are
// complete.  Each sum runs over k in order from 0: the bits of an output
// do not depend on the tiling.  Blocks of 4 k alternate between two
// fragment sets: one block's operands load while the other's FMAs run.
// Columns past ncols read what follows them in B's rows (at most 63
// floats past B's end) and must not be stored.
template <int TM, class Epi>
__device__ __forceinline__ void team_product(const float* A, const float* B,
                                             int K, int ldb, int br,
                                             int ncols, int t, Epi&& epi) {
  const int warp = t / 32, lane = t % 32;
  const int cbs = (ncols + 63) / 64;
  const int units = br / (4 * TM) * cbs;
  for (int u = warp; u < units; u += TEAM_THREADS / 32) {
    const int r0 = (u / cbs) * 4 * TM + lane / 8;
    const int c = (u % cbs) * 64 + (lane % 8) * 4;
    float acc[TM][TN];
#pragma unroll
    for (int a = 0; a < TM; ++a)
#pragma unroll
      for (int j = 0; j < TN; ++j) acc[a][j] = 0.f;
    const float* xp = A + r0 * K;
    const float* wp = B + c;
    Frag<TM> fa, fb;
    fa.load(xp, wp, K, ldb, 0);
    for (int k = 0; k < K; k += 8) {
      fb.load(xp, wp, K, ldb, k + 4);
      fa.fma(acc);
      fa.load(xp, wp, K, ldb, min(k + 8, K - 4));
      fb.fma(acc);
    }
    epi(r0, c, acc);
  }
}

// h[row0 + r][c ..] = act(acc + b) for the rows below `rows` and the
// columns below `ncols` (ncols a multiple of 4) of one thread's unit.
template <int TM>
__device__ __forceinline__ void store_act(float* __restrict__ h,
                                          const float* __restrict__ b,
                                          int row0, int rows, int ncols,
                                          bool relu, int r0, int c,
                                          const float (&acc)[TM][TN]) {
#pragma unroll
  for (int g = 0; g < 2; ++g) {
    const int col = c + 32 * g;
    if (col >= ncols) continue;
    const float4 bv = *reinterpret_cast<const float4*>(b + col);
#pragma unroll
    for (int a = 0; a < TM; ++a) {
      const int r = r0 + 4 * a;
      if (r >= rows) continue;
      float4 v = make_float4(acc[a][4 * g] + bv.x, acc[a][4 * g + 1] + bv.y,
                             acc[a][4 * g + 2] + bv.z,
                             acc[a][4 * g + 3] + bv.w);
      if (relu)
        v = make_float4(fmaxf(v.x, 0.f), fmaxf(v.y, 0.f), fmaxf(v.z, 0.f),
                        fmaxf(v.w, 0.f));
      *reinterpret_cast<float4*>(
          h + static_cast<size_t>(row0 + r) * ncols + col) = v;
    }
  }
}

// The persistent loop.  Inputs: S, M [R][Din]; with `mask` set also
// reagg [R][Din] and the uint8 mask (Fold::MASKED only); with
// Fold::ROW_VALUES a value a row (`rowin` [R] or null for zeros, plain
// loads: R floats need not be a multiple of 16 bytes).  W [Din][Dout],
// b [Dout]; outputs S' [R][Din], h [R][Dout].  Tiles of `br` rows (a
// multiple of 4 TM); Din a multiple of 16 and Dout of 4, every operand
// 16-byte aligned.
template <int TM, class Fold>
__global__ void __launch_bounds__(2 * TEAM_THREADS, 1)
resident_kernel(const float* __restrict__ S, const float* __restrict__ M,
                const float* __restrict__ RG,
                const unsigned char* __restrict__ MK,
                const float* __restrict__ rowin,
                const float* __restrict__ W, const float* __restrict__ b,
                float* __restrict__ S_new, float* __restrict__ h, int R,
                int Din, int Dout, int br, int n_teams, Fold fold,
                bool relu) {
  extern __shared__ __align__(128) unsigned char smem[];
  const bool masked = Fold::MASKED && MK != nullptr;
  const Plan pl(Din, Dout, br, n_teams, masked ? 13 : 8,
                Fold::ROW_VALUES ? 4 : 0);
  const int tid = threadIdx.x;
  const int team = tid / TEAM_THREADS, t = tid % TEAM_THREADS;
  float* Ws = reinterpret_cast<float*>(smem);
  unsigned char* own = smem + static_cast<size_t>(Din) * Dout * 4;
  float* Xs = reinterpret_cast<float*>(own + team * pl.team);
  unsigned char* stage = reinterpret_cast<unsigned char*>(Xs) + pl.plane;
  float* rowv = reinterpret_cast<float*>(stage + pl.stage);
  uint64_t* bars = reinterpret_cast<uint64_t*>(smem + pl.bars);
  const uint32_t wbar = smem_u32(&bars[pl.teams]);
  const int n_tiles = (R + br - 1) / br;
  // a team's tiles: first, first + stride, ...
  const int stride = gridDim.x * pl.teams;
  const int first = blockIdx.x * pl.teams + team;

  // one tile's S, M (, reagg, mask) rows into the stage of team tm
  auto issue = [&](int tile, int tm) {
    const size_t row0 = static_cast<size_t>(tile) * br;
    const uint32_t cells = min(br, R - tile * br) * Din;
    unsigned char* base = own + tm * pl.team + pl.plane;
    const uint32_t bar = smem_u32(&bars[tm]);
    mbar_expect_tx(bar, cells * (masked ? 13u : 8u));
    bulk_load(smem_u32(base), S + row0 * Din, cells * 4, bar);
    bulk_load(smem_u32(base + pl.plane), M + row0 * Din, cells * 4, bar);
    if (masked) {
      bulk_load(smem_u32(base + 2 * pl.plane), RG + row0 * Din, cells * 4,
                bar);
      bulk_load(smem_u32(base + 3 * pl.plane), MK + row0 * Din, cells, bar);
    }
  };
  // this thread's row value of a tile (thread t holds row t)
  auto row_value = [&](int tile) {
    const int row = tile * br + t;
    return rowin != nullptr && t < br && tile < n_tiles && row < R
               ? rowin[row] : 0.f;
  };

  if (tid == 0) {
    for (int i = 0; i <= pl.teams; ++i) mbar_init(smem_u32(&bars[i]), 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    const uint32_t w_bytes = static_cast<uint32_t>(Din) * Dout * 4;
    mbar_expect_tx(wbar, w_bytes);
    bulk_load(smem_u32(Ws), W, w_bytes, wbar);
    for (int tm = 0; tm < pl.teams; ++tm)
      if (blockIdx.x * pl.teams + tm < n_tiles)
        issue(blockIdx.x * pl.teams + tm, tm);
  }
  float rv = 0.f;
  if (Fold::ROW_VALUES) rv = row_value(first);
  __syncthreads();   // the barriers are initialised

  const int n4 = Din / 4;
  int i = 0;
  for (int tile = first; tile < n_tiles; tile += stride, ++i) {
    const int row0 = tile * br;
    const int rows = min(br, R - row0);
    if (Fold::ROW_VALUES) {
      if (t < br) rowv[t] = rv;
      team_sync(team);
    }
    mbar_wait(smem_u32(&bars[team]), i & 1);

    // ---- fold, once per cell: S' to global, x to Xs -------------------
    // (cell quad q of the tile is at 4 q in each plane, in Xs and in S')
    const float* Ss = reinterpret_cast<const float*>(stage);
    const float* Ms = Ss + static_cast<size_t>(br) * Din;
    const float* RGs = Ms + static_cast<size_t>(br) * Din;
    const unsigned char* MKs =
        reinterpret_cast<const unsigned char*>(RGs + static_cast<size_t>(br) *
                                                         Din);
    float* Sn = S_new + static_cast<size_t>(row0) * Din;
#pragma unroll 4
    for (int q = t; q < br * n4; q += TEAM_THREADS) {
      const int r = q / n4, o = 4 * q;
      float4 x = make_float4(0.f, 0.f, 0.f, 0.f);
      if (r < rows) {
        const float4 s = *reinterpret_cast<const float4*>(Ss + o);
        const float4 m = *reinterpret_cast<const float4*>(Ms + o);
        float4 g = s;
        uchar4 k = make_uchar4(0, 0, 0, 0);
        if (masked) {
          g = *reinterpret_cast<const float4*>(RGs + o);
          k = *reinterpret_cast<const uchar4*>(MKs + o);
        }
        const float rvr = Fold::ROW_VALUES ? rowv[r] : 0.f;
        float4 f;
        fold(s, m, g, k, rvr, masked, f, x);
        *reinterpret_cast<float4*>(Sn + o) = f;
      }
      *reinterpret_cast<float4*>(Xs + o) = x;
    }
    team_sync(team);   // Xs complete; this stage is read
    if (t == 0 && tile + stride < n_tiles) {
      fence_proxy_async();
      issue(tile + stride, team);
    }
    if (Fold::ROW_VALUES) rv = row_value(tile + stride);
    if (i == 0) mbar_wait(wbar, 0);

    // ---- h = act(x @ W + b) ----------------------------------------------
    team_product<TM>(Xs, Ws, Din, Dout, br, Dout, t,
                     [&](int r0, int c, const float (&acc)[TM][TN]) {
                       store_act<TM>(h, b, row0, rows, Dout, relu, r0, c,
                                     acc);
                     });
    team_sync(team);   // Xs is free for the next tile
  }
}

// Launches resident_kernel<TM, Fold> on `grid` CTAs of `teams` (1 or 2)
// teams (at most one CTA per tile); returns the CUDA error of the
// attribute call or the launch.
template <int TM, class Fold>
int launch_resident(const float* S, const float* M, const float* RG,
                    const unsigned char* MK, const float* rowin,
                    const float* W, const float* b, float* S_new, float* h,
                    int R, int Din, int Dout, int br, int teams, int grid,
                    Fold fold, bool relu, cudaStream_t s) {
  if ((teams != 1 && teams != 2) || br < 4 * TM || br % (4 * TM) ||
      Din % 16 || Dout % 4)
    return static_cast<int>(cudaErrorInvalidValue);
  const bool masked = Fold::MASKED && MK != nullptr;
  const Plan pl(Din, Dout, br, teams, masked ? 13 : 8,
                Fold::ROW_VALUES ? 4 : 0);
  // every CTA owns a tile: one that owned none would leave with W's copy
  // in flight
  grid = min(grid, ((R + br - 1) / br + teams - 1) / teams);
  // the attribute belongs to the current device: set it at every launch
  // that needs more than the default 48 KB (the call is cheap)
  if (pl.bytes > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        resident_kernel<TM, Fold>,
        cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(pl.bytes));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  resident_kernel<TM, Fold><<<grid, teams * TEAM_THREADS, pl.bytes, s>>>(
      S, M, RG, MK, rowin, W, b, S_new, h, R, Din, Dout, br, teams, fold,
      relu);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace resident
