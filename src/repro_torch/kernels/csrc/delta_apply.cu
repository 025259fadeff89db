// Fused RIPPLE hop apply for Hopper (sm_90a), plain fp32:
//
//     S' = S + M;   h = act(norm(S', k) @ W + b)
//
// norm divides each row by max(k, 1) when `mean` is set; act is relu when
// `relu` is set.  S, M: [R, Din]; k: [R]; W: [Din, Dout]; b: [Dout];
// outputs S': [R, Din] and h: [R, Dout], all row-major fp32.
//
// Replaces the TPU kernel src/repro/kernels/delta_apply/kernel.py
// (delta_apply_pallas, pl.pallas_call at line 61), which tiles a
// (row, out, k) grid for the MXU and pads every dimension to 128.
//
// What bounds it on an H100: per row it does 2*Din*Dout flops against
// 4*(3*Din + Dout + 1) bytes it must move.  At the main path's widths
// (Din = 128, Dout = 128) that is 16 flops per byte, under the card's
// fp32 ridge of 67 TFLOP/s / 3.35 TB/s = 20: the kernel is bound by bytes,
// with the fp32 FMA rate close behind (at Dout = 40 it is bytes by far).
// What the design does about it:
//   - one block per (32-row tile, 64-column out tile); the K-chunks of
//     x = norm(S + M) for the row tile are staged through shared memory,
//     so S, M and k are read once per out tile, and S' is written once,
//     by the blocks of out tile 0;
//   - the out tiles of one row tile are consecutive block indices, so a
//     second out tile finds the row tile's S and M in L2;
//   - W's K-chunk is staged in shared memory and read as float4; each
//     thread accumulates a 2 x 4 register tile with fp32 FMAs (no TF32:
//     the result must hold a 1e-4 bar against the plain version);
//   - bias and activation run in the epilogue; ragged R, Din and Dout are
//     masked, never padded.
#include <cuda_runtime.h>

namespace {

constexpr int BR = 32;        // rows per block
constexpr int BO = 64;        // output columns per block
constexpr int BK = 32;        // K-chunk staged in shared memory
constexpr int THREADS = 256;  // 16 x 16 threads, each 2 rows x 4 columns

__global__ void __launch_bounds__(THREADS)
delta_apply_kernel(const float* __restrict__ S, const float* __restrict__ M,
                   const float* __restrict__ k, const float* __restrict__ W,
                   const float* __restrict__ b, float* __restrict__ S_new,
                   float* __restrict__ h, int R, int Din, int Dout,
                   int n_out_tiles, bool mean, bool relu) {
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
        const float s = S[i] + M[i];
        if (write_s) S_new[i] = s;
        x = mean ? s / fmaxf(k[row], 1.f) : s;
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

// Launches on `stream`; returns cudaGetLastError() after the launch.
// Requires R, Din, Dout >= 1; allocates nothing.
extern "C" int delta_apply_launch(const float* S, const float* M,
                                  const float* k, const float* W,
                                  const float* b, float* S_new, float* h,
                                  int R, int Din, int Dout, int mean,
                                  int relu, void* stream) {
  const int n_out_tiles = (Dout + BO - 1) / BO;
  const int n_row_tiles = (R + BR - 1) / BR;
  delta_apply_kernel<<<n_row_tiles * n_out_tiles, THREADS, 0,
                       static_cast<cudaStream_t>(stream)>>>(
      S, M, k, W, b, S_new, h, R, Din, Dout, n_out_tiles, mean != 0,
      relu != 0);
  return static_cast<int>(cudaGetLastError());
}
