// The monotonic hop's SHRINK pull for Hopper (sm_90a): every needed
// (row, dim) cell of a hop's recipients re-derived from the in-CSR, with its
// witness, in one launch.  For recipient slot r (vertex v = aff[r]) and dim
// j with need[r, j], over the in-edges u -> v:
//
//     x_u        = pos[u] >= 0 ? patch[pos[u], j] : H[u, j]
//     RG[r, j]   = the max (sign = +1) or the min (sign = -1) of x_u
//     C[r, j]    = the u that attains it, the largest u where several do
//
// with RG = sign * -inf and C = -1 where v has no in-edge; at every other
// cell RG is 0 and C is C_pre[r, j].  pull_total = the sum over the needed
// cells of v's in-degree.  The in-CSR is a slack pool: v's sources are
// col[start[v] .. start[v] + length[v]).  need: [R, d] bool (one byte a
// cell); aff [R], start and length [n], col [pool], pos [n + 1]: int64;
// H: [n + 1, d] fp32; patch: [P, d] fp32 (the previous hop's new rows, read
// where pos >= 0); C_pre and C: [R, d] int32; RG: [R, d] fp32; all
// row-major.
//
// Replaces no TPU kernel: the JAX package runs this step as jnp ops (the
// pair regime of src/repro/core/device_engine.py::_monotonic_hop).  It was
// added because on this card the step's cost was the host's: its plain
// version (kernels/shrink_pull/ref.py) is about 80 small torch calls a hop,
// each a launch the host enqueues, none of which waits on the device.
//
// What bounds it on an H100: bytes.  A needed cell reads one fp32 value a
// pulled in-edge; a needy row reads each in-edge's source id and patch
// slot once (16 bytes), and every cell of the [R, d] slab is read (need,
// C_pre: 5 bytes) and written (RG, C: 8 bytes) once.  What the design does
// about it:
//   - one warp a recipient slot, its lanes over the dims: lane l takes dims
//     l, l + 32, l + 64 and l + 96 of a pass of 128 (more passes for a
//     wider d), so a needed dim's reads of one source row coalesce;
//   - a ballot skips rows with no needed dim; such a row still writes RG
//     and C, so the wrapper launches nothing else;
//   - a needy row's warp reads its in-edges 32 at a time, one source id and
//     its patch slot a lane, and hands each to every lane by shuffles; a
//     lane reads its needed dims of BATCH sources, from the patch or from
//     H, before it folds them, so those loads are in flight together;
//   - the fold runs in max-space (sign * x): a strictly larger value wins
//     and an equal one keeps the larger source, so the result does not
//     depend on the order of the in-edges, and -0.0 equals 0.0 as in the
//     plain version's comparisons;
//   - pull_total is one atomicAdd a needy row pass, on an int64 the launch
//     zeroes first; no atomic touches a value, so results never vary from
//     run to run;
//   - a row of more than LONG in-edges (the cited degree law's largest
//     in-degree is 1,411) is split across its block: its warp writes the
//     cells not needed and leaves it to the block, whose 8 warps then walk
//     every 8th chunk of its in-edges each and fold their partials in shared
//     memory.  On one warp such a row set the kernel's time: the walk is a
//     chain of dependent loads, 8 in-edges a step.
#include <cuda_runtime.h>
#include <math_constants.h>

namespace {

constexpr int WARPS = 8;                 // recipient slots a block
constexpr int THREADS = 32 * WARPS;
constexpr int DPL = 4;                   // dims a lane holds in a pass
constexpr int PASS = 32 * DPL;           // dims a pass covers
constexpr int BATCH = 8;                 // sources whose values are in flight
constexpr int LONG = 64;                 // in-edges above which the block walks
constexpr unsigned FULL = 0xffffffffu;

struct Pull {                            // the operands, as the header says
  const unsigned char* need;
  const long long* aff;
  const long long* start;
  const long long* length;
  const long long* col;
  const float* H;
  const long long* pos;
  const float* patch;
  const int* C_pre;
  float* RG;
  int* C_out;
  unsigned long long* pull_total;
  int R, d;
  float sign;
};

// The max-space fold: a strictly larger value wins, an equal one keeps the
// larger source.
__device__ __forceinline__ void fold(float s, int u, bool on, float& best,
                                     int& who) {
  if (on && (s > best || (s == best && u > who))) {
    best = s;
    who = u;
  }
}

// The lane's need flags in the pass from dim j0; returns the row's needed
// cells in the pass (the same in every lane).
__device__ __forceinline__ int load_need(const Pull& p, long long cell0,
                                         int j0, int lane, bool (&nd)[DPL],
                                         float (&best)[DPL],
                                         int (&who)[DPL]) {
  int count = 0;
#pragma unroll
  for (int t = 0; t < DPL; ++t) {
    const int j = j0 + 32 * t + lane;
    nd[t] = j < p.d && p.need[cell0 + j] != 0;
    count += __popc(__ballot_sync(FULL, nd[t]));
    best[t] = -CUDART_INF_F;
    who[t] = -1;
  }
  return count;
}

// Folds the in-edges col[beg + c] for the chunks of 32 at c = first,
// first + step, ... below deg into the lane's needed dims of the pass.
__device__ __forceinline__ void walk(const Pull& p, long long beg, int deg,
                                     int first, int step, int j0, int lane,
                                     const bool (&nd)[DPL],
                                     float (&best)[DPL], int (&who)[DPL]) {
  for (int c = first; c < deg; c += step) {
    const int m = min(32, deg - c);
    long long u_l = 0, q_l = -1;
    if (lane < m) {
      u_l = p.col[beg + c + lane];
      q_l = p.pos[u_l];
    }
    for (int k = 0; k < m; k += BATCH) {
      float x[BATCH][DPL];
      int src[BATCH];
#pragma unroll
      for (int b = 0; b < BATCH; ++b) {
        const long long u = __shfl_sync(FULL, u_l, (k + b) & 31);
        const long long q = __shfl_sync(FULL, q_l, (k + b) & 31);
        const float* row = q >= 0 ? p.patch + q * p.d : p.H + u * p.d;
        src[b] = static_cast<int>(u);
#pragma unroll
        for (int t = 0; t < DPL; ++t)
          x[b][t] = (k + b < m && nd[t]) ? row[j0 + 32 * t + lane] : 0.f;
      }
#pragma unroll
      for (int b = 0; b < BATCH; ++b) {
        if (k + b < m) {
#pragma unroll
          for (int t = 0; t < DPL; ++t)
            fold(p.sign * x[b][t], src[b], nd[t], best[t], who[t]);
        }
      }
    }
  }
}

__global__ void __launch_bounds__(THREADS) shrink_pull_kernel(Pull p) {
  __shared__ float s_best[WARPS][PASS];
  __shared__ int s_who[WARPS][PASS];
  __shared__ bool s_long[WARPS];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int r = blockIdx.x * WARPS + warp;
  bool is_long = false;
  if (r < p.R) {
    const long long cell0 = static_cast<long long>(r) * p.d;
    for (int j0 = 0; j0 < p.d; j0 += PASS) {
      bool nd[DPL];
      float best[DPL];
      int who[DPL];
      const int count = load_need(p, cell0, j0, lane, nd, best, who);
      bool deferred = false;             // the block writes the needed cells
      if (count > 0) {
        const long long v = p.aff[r];
        const int deg = static_cast<int>(p.length[v]);
        if (lane == 0)
          atomicAdd(p.pull_total, static_cast<unsigned long long>(deg) *
                                      static_cast<unsigned long long>(count));
        deferred = deg > LONG;
        if (!deferred)
          walk(p, p.start[v], deg, 0, 32, j0, lane, nd, best, who);
      }
      is_long |= deferred;
#pragma unroll
      for (int t = 0; t < DPL; ++t) {
        const long long i = cell0 + j0 + 32 * t + lane;
        if (j0 + 32 * t + lane >= p.d) continue;
        if (!nd[t]) {
          p.RG[i] = 0.f;
          p.C_out[i] = p.C_pre[i];
        } else if (!deferred) {
          p.RG[i] = p.sign * best[t];
          p.C_out[i] = who[t];
        }
      }
    }
  }
  if (lane == 0) s_long[warp] = is_long;
  __syncthreads();
  // the block's long rows, one at a time, every warp on every 8th chunk
  for (int w = 0; w < WARPS; ++w) {
    if (!s_long[w]) continue;            // the same in every thread
    const int rl = blockIdx.x * WARPS + w;
    const long long cell0 = static_cast<long long>(rl) * p.d;
    const long long v = p.aff[rl];
    const long long beg = p.start[v];
    const int deg = static_cast<int>(p.length[v]);
    for (int j0 = 0; j0 < p.d; j0 += PASS) {
      bool nd[DPL];
      float best[DPL];
      int who[DPL];
      if (load_need(p, cell0, j0, lane, nd, best, who) == 0) continue;
      walk(p, beg, deg, 32 * warp, 32 * WARPS, j0, lane, nd, best, who);
#pragma unroll
      for (int t = 0; t < DPL; ++t) {
        s_best[warp][32 * t + lane] = best[t];
        s_who[warp][32 * t + lane] = who[t];
      }
      __syncthreads();
      if (warp == 0) {
#pragma unroll
        for (int t = 0; t < DPL; ++t) {
          if (!nd[t]) continue;
          for (int o = 1; o < WARPS; ++o)
            fold(s_best[o][32 * t + lane], s_who[o][32 * t + lane], true,
                 best[t], who[t]);
          const long long i = cell0 + j0 + 32 * t + lane;
          p.RG[i] = p.sign * best[t];
          p.C_out[i] = who[t];
        }
      }
      __syncthreads();
    }
  }
}

}  // namespace

// Launches on `stream`: zeroes pull_total, then one block of WARPS warps for
// every WARPS recipient slots.  Returns the CUDA error of the launches (0
// when they were accepted).  Requires sign = +1 or -1, source ids below
// 2^31 and the operands ops.py checks.  Allocates nothing.
extern "C" int shrink_pull_launch(const unsigned char* need,
                                  const long long* aff,
                                  const long long* start,
                                  const long long* length,
                                  const long long* col, const float* H,
                                  const long long* pos, const float* patch,
                                  const int* C_pre, float* RG, int* C_out,
                                  long long* pull_total, int R, int d,
                                  int sign, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err = cudaMemsetAsync(pull_total, 0, sizeof(long long), s);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (R > 0 && d > 0) {
    const Pull p{need, aff, start, length, col, H, pos, patch, C_pre, RG,
                 C_out, reinterpret_cast<unsigned long long*>(pull_total),
                 R, d, static_cast<float>(sign)};
    shrink_pull_kernel<<<(R + WARPS - 1) / WARPS, THREADS, 0, s>>>(p);
  }
  return static_cast<int>(cudaGetLastError());
}
