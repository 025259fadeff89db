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
// The resident route (resident_apply.cuh's resident_kernel with the fold
// ExtremumFold; Din a multiple of 16, Dout of 4, W and the staged tiles
// within shared memory, 16-byte aligned operands):
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

#include "resident_apply.cuh"

namespace {

// ---- the resident route (resident_apply.cuh) ----------------------------

__device__ __forceinline__ float select_fold(float s, float m, float g,
                                             unsigned char k, bool masked,
                                             bool maximize) {
  if (masked && k) s = g;
  return maximize ? fmaxf(s, m) : fminf(s, m);
}

// S' = max|min(mask ? reagg : S, M) and x = finite(S'), a float4 of cells
// at a time.
struct ExtremumFold {
  static constexpr bool MASKED = true;
  static constexpr bool ROW_VALUES = false;
  bool maximize;
  __device__ __forceinline__ void operator()(const float4& s,
                                             const float4& m,
                                             const float4& g,
                                             const uchar4& k, float,
                                             bool masked, float4& f,
                                             float4& x) const {
    f = make_float4(select_fold(s.x, m.x, g.x, k.x, masked, maximize),
                    select_fold(s.y, m.y, g.y, k.y, masked, maximize),
                    select_fold(s.z, m.z, g.z, k.z, masked, maximize),
                    select_fold(s.w, m.w, g.w, k.w, masked, maximize));
    x = make_float4(isfinite(f.x) ? f.x : 0.f, isfinite(f.y) ? f.y : 0.f,
                    isfinite(f.z) ? f.z : 0.f, isfinite(f.w) ? f.w : 0.f);
  }
};

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

}  // namespace

// Launches on `stream`; returns the CUDA error of the launch (0 when it
// was accepted).  Requires R, Din, Dout >= 1; reagg and mask are both null
// or both set.  tm = 0 takes the K-chunked route; tm = 1, 2 or 4 the
// resident route with tiles of `br` rows (a multiple of 4 tm) and `grid`
// CTAs of `teams` (1 or 2) teams (ops.py::kernel_plan checks the shape,
// the alignment and the shared memory it needs).  Allocates nothing.
extern "C" int extremum_apply_launch(const float* S, const float* M,
                                     const float* reagg,
                                     const unsigned char* mask,
                                     const float* W, const float* b,
                                     float* S_new, float* h, int R, int Din,
                                     int Dout, int maximize, int relu, int tm,
                                     int br, int teams, int grid,
                                     void* stream) {
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
      return resident::launch_resident<1>(
          S, M, reagg, mask, nullptr, W, b, S_new, h, R, Din, Dout,
          br, teams, grid, ExtremumFold{mx}, rl, s);
    case 2:
      return resident::launch_resident<2>(
          S, M, reagg, mask, nullptr, W, b, S_new, h, R, Din, Dout,
          br, teams, grid, ExtremumFold{mx}, rl, s);
    case 4:
      return resident::launch_resident<4>(
          S, M, reagg, mask, nullptr, W, b, S_new, h, R, Din, Dout,
          br, teams, grid, ExtremumFold{mx}, rl, s);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}
