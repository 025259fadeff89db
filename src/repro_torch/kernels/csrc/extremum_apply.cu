// Fused monotonic (max/min) RIPPLE hop apply for Hopper (sm_90a), plain fp32:
//
//     base = mask ? reagg : S        (masked variant only)
//     S'   = max|min(base, M)
//     h    = act(finite(S') @ W + b)
//
// finite maps +/-inf (the aggregator identity in empty rows) to 0; act is
// relu when `relu` is set.  S, M, reagg: [R, Din] fp32; mask: [R, Din]
// uint8 (nonzero = the cell was re-aggregated); W: [Din, Dout]; b: [Dout];
// outputs S': [R, Din] and h: [R, Dout], all row-major.  The unmasked
// variant passes null reagg and mask pointers.
//
// Replaces the TPU kernel src/repro/kernels/extremum_apply/kernel.py
// (extremum_apply_pallas, pl.pallas_call at line 115; bodies _kernel and
// _kernel_masked), which tiles a (row, out, k) grid for the MXU and pads
// every dimension to 128, M with the aggregator identity.
//
// What bounds it on an H100: per row it does 2*Din*Dout flops against
// about 4*(3*Din + Dout) bytes it must move (base, M and S' per cell, plus
// h; the mask adds 1 byte per cell).  At Din = Dout = 128 that is ~3 KB per
// row for 32 K flops, 11 flops per byte, under the card's fp32 ridge of
// 67 TFLOP/s / 3.35 TB/s = 20: bound by bytes, but only by a factor of
// two, so the FMAs must overlap the loads.  And the FMAs must stay fp32
// FMAs in k order (no TF32, no tensor cores): h must hold a 1e-4 bar, and
// the monotonic engine's frontier filter compares h's bits, so its
// counters hold only if h's bits do.  Such FMAs are fed from shared
// memory, whose 128 bytes a clock let a TM x 8 register tile reach at
// most 2 TM / (TM + 8) of the SM's FMA rate (2/3 at TM = 4).  The hop's
// row counts run from 64 to 65,536, so at most shapes a launch is a single
// wave.  Two routes:
//
// The resident route (resident_kernel; Din a multiple of 16, Dout of 4, W
// and the staged tiles within shared memory, 16-byte aligned operands):
//   - one team of 4 warps owns a tile of `br` rows and all of Dout (in
//     passes of up to 128 columns over the same staged inputs), so S, M,
//     reagg and the mask are read once, the select-and-fold runs once and
//     S' is written once;
//   - W is loaded into shared memory once per CTA with a bulk async copy
//     (cp.async.bulk on an mbarrier), under the first tiles' loads;
//   - a tile's S, M, reagg and mask rows are contiguous, so each arrives
//     with one bulk copy apiece on the team's mbarrier;
//   - the CTAs are persistent (at most one per SM); where the tiles
//     outnumber the SMs, a CTA holds two teams that share W and take
//     turns at the FMA and shared-memory pipes: a team's next tile loads
//     under its own FMAs and the other team's, so two stages are in
//     flight a CTA.  Otherwise one team a CTA, and the tiles shrink to 8-32
//     rows so that the single wave spreads over the SMs
//     (ops.py::kernel_plan);
//   - each thread accumulates TM rows x 8 columns with fp32 FMAs, reading
//     x and W as float4 from shared memory, the next 4 k's operands loaded
//     under this 4 k's FMAs; a warp covers 4 TM rows x 64 columns, each of
//     its shared-memory reads one conflict-free wavefront a quarter-warp;
//   - bias and activation run in the epilogue.
// The K-chunked route (kchunk_kernel; every other shape): one block per
// (32-row tile, 64-column out tile), W staged in 32-row K-chunks.
// Both routes select with fmaxf/fminf, which is what torch.maximum and
// torch.minimum compute on the card for inputs without NaN, so S' is
// bit-equal to the plain version; the mask travels as one byte per cell and
// each cell reads either reagg or S, by the mask; ragged R, Din and Dout
// are masked, never padded in memory.
#include <cstdint>
#include <cuda_runtime.h>

namespace {

// ---- the resident route ------------------------------------------------

constexpr int TEAM_THREADS = 128;  // a team: 4 warps, one per scheduler
constexpr int TN = 8;             // output columns a thread accumulates

// The resident route's tiling, as ops.py::kernel_plan computes it: passes
// of `p` output columns (64 when Dout <= 64, else 128); the warps as
// (4 / (p / 64)) row blocks of 4 TM rows x (p / 64) column blocks of 64
// columns (a thread: TM rows 4 apart x 8 columns, as float4s 32 apart);
// shared memory W [Din][Dout], then for each team x [br][Din] and a stage
// of S, M (, reagg, mask) [br][Din], then teams + 1 mbarriers.  The 8
// lanes of a quarter-warp share their x rows, so x needs no padding.
struct Plan {
  int p, n_pass, cb, rb, br, teams;
  size_t plane, stage, team, bars, bytes;
  __host__ __device__ Plan(int Din, int Dout, int tm, int n_teams,
                           bool masked) {
    p = Dout <= 64 ? 64 : 128;
    n_pass = (Dout + p - 1) / p;
    cb = p / 64;
    rb = 4 / cb;
    br = rb * 4 * tm;
    teams = n_teams;
    plane = static_cast<size_t>(br) * Din * 4;
    stage = masked ? 3 * plane + plane / 4 : 2 * plane;
    team = plane + stage;
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

__device__ __forceinline__ float pick(const float4& v, int k) {
  return k == 0 ? v.x : k == 1 ? v.y : k == 2 ? v.z : v.w;
}

__device__ __forceinline__ float select_fold(float s, float m, float g,
                                             unsigned char k, bool masked,
                                             bool maximize) {
  if (masked && k) s = g;
  return maximize ? fmaxf(s, m) : fminf(s, m);
}

// One thread's operands for a block of 4 k: x of its TM rows (4 apart in
// Xs) and W of its 8 columns (two float4s 32 apart) at each of the 4 k.
template <int TM>
struct Frag {
  float4 x[TM];
  float4 w[4][2];
  __device__ __forceinline__ void load(const float* xp, const float* wp,
                                       int Din, int Dout, int k) {
#pragma unroll
    for (int a = 0; a < TM; ++a)
      x[a] = *reinterpret_cast<const float4*>(xp + 4 * a * Din + k);
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      const float* wk = wp + static_cast<size_t>(k + kk) * Dout;
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

// Named barrier of one team's 128 threads.
__device__ __forceinline__ void team_sync(int team) {
  asm volatile("bar.sync %0, 128;\n" :: "r"(team + 1) : "memory");
}

template <int TM>
__global__ void __launch_bounds__(2 * TEAM_THREADS, 1)
resident_kernel(const float* __restrict__ S, const float* __restrict__ M,
                const float* __restrict__ RG,
                const unsigned char* __restrict__ MK,
                const float* __restrict__ W, const float* __restrict__ b,
                float* __restrict__ S_new, float* __restrict__ h, int R,
                int Din, int Dout, int n_teams, bool maximize, bool relu) {
  extern __shared__ __align__(128) unsigned char smem[];
  const bool masked = MK != nullptr;
  const Plan pl(Din, Dout, TM, n_teams, masked);
  const int br = pl.br;
  const int tid = threadIdx.x;
  const int team = tid / TEAM_THREADS, t = tid % TEAM_THREADS;
  float* Ws = reinterpret_cast<float*>(smem);
  unsigned char* own = smem + static_cast<size_t>(Din) * Dout * 4;
  float* Xs = reinterpret_cast<float*>(own + team * pl.team);
  unsigned char* stage = reinterpret_cast<unsigned char*>(Xs) + pl.plane;
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
  __syncthreads();   // the barriers are initialised

  const int warp = t / 32, lane = tid % 32;
  const int r0 = (warp / pl.cb) * 4 * TM + lane / 8;   // rows r0 + 4 a
  const int c_loc = (warp % pl.cb) * 64 + (lane % 8) * 4;  // and c_loc + 32
  const int n4 = Din / 4;
  int i = 0;
  for (int tile = first; tile < n_tiles; tile += stride, ++i) {
    const int row0 = tile * br;
    const int rows = min(br, R - row0);
    mbar_wait(smem_u32(&bars[team]), i & 1);

    // ---- select and fold, once per cell: S' to global, x to Xs ---------
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
        const float4 f = make_float4(
            select_fold(s.x, m.x, g.x, k.x, masked, maximize),
            select_fold(s.y, m.y, g.y, k.y, masked, maximize),
            select_fold(s.z, m.z, g.z, k.z, masked, maximize),
            select_fold(s.w, m.w, g.w, k.w, masked, maximize));
        *reinterpret_cast<float4*>(Sn + o) = f;
        x = make_float4(isfinite(f.x) ? f.x : 0.f, isfinite(f.y) ? f.y : 0.f,
                        isfinite(f.z) ? f.z : 0.f, isfinite(f.w) ? f.w : 0.f);
      }
      *reinterpret_cast<float4*>(Xs + o) = x;
    }
    team_sync(team);   // Xs complete; this stage is read
    if (t == 0 && tile + stride < n_tiles) {
      asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
      issue(tile + stride, team);
    }
    if (i == 0) mbar_wait(wbar, 0);

    // ---- h = act(x @ W + b), a pass of p columns at a time --------------
    // Columns past Dout read what follows them in shared memory (the next
    // W row, or at most 127 floats of Xs past W's end) and are never
    // stored.
    for (int p = 0; p < pl.n_pass; ++p) {
      float acc[TM][TN];
#pragma unroll
      for (int a = 0; a < TM; ++a)
#pragma unroll
        for (int j = 0; j < TN; ++j) acc[a][j] = 0.f;
      // Blocks of 4 k alternate between two fragment sets, A and B: one
      // block's x and W fragments load while the other's FMAs run (Din is
      // a multiple of 16, so the blocks pair up).
      const float* wp = Ws + p * pl.p + c_loc;
      const float* xp = Xs + r0 * Din;
      Frag<TM> fa, fb;
      fa.load(xp, wp, Din, Dout, 0);
      for (int k = 0; k < Din; k += 8) {
        fb.load(xp, wp, Din, Dout, k + 4);
        fa.fma(acc);
        fa.load(xp, wp, Din, Dout, min(k + 8, Din - 4));
        fb.fma(acc);
      }
#pragma unroll
      for (int g = 0; g < 2; ++g) {
        const int c = p * pl.p + c_loc + 32 * g;
        if (c >= Dout) continue;
        const float4 bv = *reinterpret_cast<const float4*>(b + c);
#pragma unroll
        for (int a = 0; a < TM; ++a) {
          const int r = r0 + 4 * a;
          if (r >= rows) continue;
          float4 v = make_float4(
              acc[a][4 * g] + bv.x, acc[a][4 * g + 1] + bv.y,
              acc[a][4 * g + 2] + bv.z, acc[a][4 * g + 3] + bv.w);
          if (relu)
            v = make_float4(fmaxf(v.x, 0.f), fmaxf(v.y, 0.f),
                            fmaxf(v.z, 0.f), fmaxf(v.w, 0.f));
          *reinterpret_cast<float4*>(
              h + static_cast<size_t>(row0 + r) * Dout + c) = v;
        }
      }
    }
    team_sync(team);   // Xs is free for the next tile
  }
}

// ---- the K-chunked route -------------------------------------------------

constexpr int BR = 32;        // rows per block
constexpr int BO = 64;        // output columns per block
constexpr int BK = 32;        // K-chunk staged in shared memory
constexpr int THREADS = 256;  // 16 x 16 threads, each 2 rows x 4 columns

__global__ void __launch_bounds__(THREADS)
kchunk_kernel(const float* __restrict__ S, const float* __restrict__ M,
              const float* __restrict__ RG,
              const unsigned char* __restrict__ MK,
              const float* __restrict__ W, const float* __restrict__ b,
              float* __restrict__ S_new, float* __restrict__ h, int R,
              int Din, int Dout, int n_out_tiles, bool maximize, bool relu) {
  __shared__ float Xs[BR][BK + 1];  // +1: rows 2 apart hit other banks
  __shared__ __align__(16) float Ws[BK][BO];
  const int out_tile = blockIdx.x % n_out_tiles;
  const int row0 = (blockIdx.x / n_out_tiles) * BR;
  const int col0 = out_tile * BO;
  const int tid = threadIdx.x;
  const int tx = tid % 16;
  const int ty = tid / 16;
  const bool write_s = out_tile == 0;

  float acc[2][4] = {};
  for (int k0 = 0; k0 < Din; k0 += BK) {
    for (int e = tid; e < BR * BK; e += THREADS) {
      const int r = e / BK, c = e % BK;
      const int row = row0 + r, col = k0 + c;
      float x = 0.f;
      if (row < R && col < Din) {
        const size_t i = (size_t)row * Din + col;
        const float base = (MK != nullptr && MK[i]) ? RG[i] : S[i];
        const float s = maximize ? fmaxf(base, M[i]) : fminf(base, M[i]);
        if (write_s) S_new[i] = s;
        x = isfinite(s) ? s : 0.f;
      }
      Xs[r][c] = x;
    }
    for (int e = tid; e < BK * BO; e += THREADS) {
      const int r = e / BO, c = e % BO;
      const int kk = k0 + r, col = col0 + c;
      Ws[r][c] = (kk < Din && col < Dout) ? W[(size_t)kk * Dout + col] : 0.f;
    }
    __syncthreads();
#pragma unroll 8
    for (int kk = 0; kk < BK; ++kk) {
      const float a0 = Xs[ty * 2][kk];
      const float a1 = Xs[ty * 2 + 1][kk];
      const float4 w = *reinterpret_cast<const float4*>(&Ws[kk][tx * 4]);
      acc[0][0] += a0 * w.x; acc[0][1] += a0 * w.y;
      acc[0][2] += a0 * w.z; acc[0][3] += a0 * w.w;
      acc[1][0] += a1 * w.x; acc[1][1] += a1 * w.y;
      acc[1][2] += a1 * w.z; acc[1][3] += a1 * w.w;
    }
    __syncthreads();
  }

  for (int i = 0; i < 2; ++i) {
    const int row = row0 + ty * 2 + i;
    if (row >= R) continue;
    for (int j = 0; j < 4; ++j) {
      const int col = col0 + tx * 4 + j;
      if (col >= Dout) continue;
      float v = acc[i][j] + b[col];
      if (relu) v = fmaxf(v, 0.f);
      h[(size_t)row * Dout + col] = v;
    }
  }
}

template <int TM>
int launch_resident(const float* S, const float* M, const float* RG,
                    const unsigned char* MK, const float* W, const float* b,
                    float* S_new, float* h, int R, int Din, int Dout,
                    int teams, bool maximize, bool relu, int grid,
                    cudaStream_t s) {
  const Plan pl(Din, Dout, TM, teams, MK != nullptr);
  // every CTA owns a tile: one that owned none would leave with W's copy
  // in flight
  grid = min(grid, ((R + pl.br - 1) / pl.br + teams - 1) / teams);
  // the attribute belongs to the current device: set it at every launch
  // that needs more than the default 48 KB (the call is cheap)
  if (pl.bytes > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        resident_kernel<TM>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(pl.bytes));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  resident_kernel<TM><<<grid, teams * TEAM_THREADS, pl.bytes, s>>>(
      S, M, RG, MK, W, b, S_new, h, R, Din, Dout, teams, maximize, relu);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// The shared memory one block of `device` may opt in to, in bytes, or -1
// when the device cannot be queried.
extern "C" int extremum_apply_smem_optin(int device) {
  int bytes = 0;
  if (cudaDeviceGetAttribute(&bytes, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                             device) != cudaSuccess)
    return -1;
  return bytes;
}

// Launches on `stream`; returns the CUDA error of the launch (0 when it
// was accepted).  Requires R, Din, Dout >= 1; reagg and mask are both null
// or both set.  tm = 0 takes the K-chunked route; tm = 1, 2 or 4 the
// resident route with `grid` CTAs of `teams` (1 or 2) teams
// (ops.py::kernel_plan checks the shape, the alignment and the shared
// memory it needs).  Allocates nothing.
extern "C" int extremum_apply_launch(const float* S, const float* M,
                                     const float* reagg,
                                     const unsigned char* mask,
                                     const float* W, const float* b,
                                     float* S_new, float* h, int R, int Din,
                                     int Dout, int maximize, int relu, int tm,
                                     int teams, int grid, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool mx = maximize != 0, rl = relu != 0;
  if (tm != 0 && teams != 1 && teams != 2)
    return static_cast<int>(cudaErrorInvalidValue);
  switch (tm) {
    case 0: {
      const int n_out_tiles = (Dout + BO - 1) / BO;
      const int n_row_tiles = (R + BR - 1) / BR;
      kchunk_kernel<<<n_row_tiles * n_out_tiles, THREADS, 0, s>>>(
          S, M, reagg, mask, W, b, S_new, h, R, Din, Dout, n_out_tiles, mx,
          rl);
      return static_cast<int>(cudaGetLastError());
    }
    case 1:
      return launch_resident<1>(S, M, reagg, mask, W, b, S_new, h, R, Din,
                                Dout, teams, mx, rl, grid, s);
    case 2:
      return launch_resident<2>(S, M, reagg, mask, W, b, S_new, h, R, Din,
                                Dout, teams, mx, rl, grid, s);
    case 4:
      return launch_resident<4>(S, M, reagg, mask, W, b, S_new, h, R, Din,
                                Dout, teams, mx, rl, grid, s);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}
