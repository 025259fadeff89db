// Fused GIN hop apply for Hopper (sm_90a), plain fp32:
//
//     S' = S + M;   z = (1 + eps) * h_prev + norm(S', k)
//     h  = act(relu(z @ W1 + b1) @ W2 + b2)
//
// norm divides each row by max(k, 1) when `mean` is set; act is relu when
// `relu` is set.  S, M, h_prev: [R, Din]; k: [R]; W1: [Din, Dh];
// b1: [Dh]; W2: [Dh, Dout]; b2: [Dout]; eps a host scalar.  Outputs
// S': [R, Din] and h: [R, Dout], all row-major fp32.
//
// Replaces the TPU kernel src/repro/kernels/mlp_apply/kernel.py
// (mlp_apply_pallas, pl.pallas_call at line 66), which keeps the hidden
// activation in VMEM over a (row, out) grid with 128-padded dimensions.
//
// What bounds it on an H100: per row it does 2*(Din*Dh + Dh*Dout) flops
// against 4*(4*Din + Dout + 1) bytes it must move.  At the main path's
// widths (Din = Dh = Dout = 128) that is 32 flops per byte, above the
// card's fp32 ridge of 67 TFLOP/s / 3.35 TB/s = 20: the kernel is bound by
// fp32 FMA operations (at Dout = 40, 26 flops per byte, still operations).
// But the sessions launch it at 256-2048 rows, where a launch is one short
// wave and its time is latency: the weights' load, the input round trip
// and two products of one tile in a row.  Two routes, chosen by
// ops.py::kernel_plan:
//
// The resident route (resident_kernel; Din a multiple of 16, Dh of 8,
// Dout of 4, 16-byte aligned operands, the weights and a tile within the
// opt-in shared memory):
//   - each CTA holds W1 and W2 resident in shared memory (128 KB at
//     128/128/128), loaded by two bulk copies under the first tile's;
//   - a row tile's S, M and h_prev arrive as one bulk copy each, so the
//     inputs are read once; k's values arrive with plain loads, a tile
//     ahead;
//   - the CTA forms z (writing S'), h1 = relu(z W1 + b1) into shared
//     memory, then h = act(h1 W2 + b2) straight from the second product;
//   - the kernel walks tiles persistently; the tiles shrink to 8-32 rows
//     so that a single wave spreads over the SMs, and where 32-row tiles
//     outnumber the SMs two stages of inputs are in flight.
// A 2-CTA cluster splitting Dh (multicast inputs, partials added through
// distributed shared memory) was built and measured within run-to-run
// spread of this route at its best shapes and slower past them; it was
// dropped (PERF.md).
// The tiled route (tiled_kernel, the design the resident route
// replaced; every other shape): one block per 32-row tile, both products
// staging their weights through shared memory in K-chunks, a 2 x 4 fp32
// FMA tile per thread.  The wrapper refuses widths whose z and h1 tiles
// do not fit in shared memory.
//
// Every route: fp32 FMAs (no TF32: h must hold a 1e-4 bar against the
// plain version), IEEE division; S' = S + M, one fp32 add, bit-equal to
// the plain version's; ragged R, Din, Dh and Dout masked, never padded in
// memory.  On the resident route each product runs over k in order
// (resident_apply.cuh's team_product), so reruns are bit-equal.
#include <cuda_runtime.h>

#include "resident_apply.cuh"

namespace {

using resident::TEAM_THREADS;
using resident::TN;

// ---- the resident route ---------------------------------------------------

// The shared memory of resident_kernel, by offset: W1 [Din][Dh], W2
// [Dh][Dout], `ns` stages of S, M and h_prev [br][Din] each, z [br][Din],
// h1 [br][Dh], k [br], then ns + 1 mbarriers.  Every product's columns
// past its width read at most 63 floats past B's end, which lands in the
// next region.
struct MlpPlan {
  size_t plane, w2, stage, zs, h1, ks, bars, bytes;
  __host__ __device__ MlpPlan(int Din, int Dh, int Dout, int br, int ns) {
    plane = static_cast<size_t>(br) * Din * 4;
    w2 = static_cast<size_t>(Din) * Dh * 4;
    stage = w2 + static_cast<size_t>(Dh) * Dout * 4;
    zs = stage + ns * 3 * plane;
    h1 = zs + plane;
    ks = h1 + static_cast<size_t>(br) * Dh * 4;
    bars = ks + resident::round16(static_cast<size_t>(br) * 4);
    bytes = bars + (ns + 1) * 8;
  }
};

template <int TM1, int TM2>
__global__ void __launch_bounds__(TEAM_THREADS, 1)
resident_kernel(const float* __restrict__ S, const float* __restrict__ M,
                const float* __restrict__ Hp, const float* __restrict__ k,
                const float* __restrict__ W1, const float* __restrict__ b1,
                const float* __restrict__ W2, const float* __restrict__ b2,
                float* __restrict__ S_new, float* __restrict__ h, int R,
                int Din, int Dh, int Dout, int br, int ns, float eps,
                bool mean, bool relu) {
  using namespace resident;
  extern __shared__ __align__(128) unsigned char buf[];
  const MlpPlan pl(Din, Dh, Dout, br, ns);
  const int t = threadIdx.x;
  float* W1s = reinterpret_cast<float*>(buf);
  float* W2s = reinterpret_cast<float*>(buf + pl.w2);
  float* Zs = reinterpret_cast<float*>(buf + pl.zs);
  float* H1s = reinterpret_cast<float*>(buf + pl.h1);
  float* ks = reinterpret_cast<float*>(buf + pl.ks);
  uint64_t* bars = reinterpret_cast<uint64_t*>(buf + pl.bars);
  const uint32_t wbar = smem_u32(&bars[ns]);
  const int n_tiles = (R + br - 1) / br;
  // this CTA's tiles: blockIdx.x, blockIdx.x + gridDim.x, ...
  const int first = blockIdx.x, stride = gridDim.x;

  // one tile's S, M and h_prev rows into stage s, on its barrier
  auto issue = [&](int tile, int s) {
    const size_t off = static_cast<size_t>(tile) * br * Din;
    const uint32_t cells = min(br, R - tile * br) * Din;
    const uint32_t bar = smem_u32(&bars[s]);
    const uint32_t dst = smem_u32(buf + pl.stage + s * 3 * pl.plane);
    const float* src[3] = {S, M, Hp};
    mbar_expect_tx(bar, cells * 12);
#pragma unroll
    for (int j = 0; j < 3; ++j)
      bulk_load(dst + j * pl.plane, src[j] + off, cells * 4, bar);
  };
  // this thread's k of a tile (thread t holds row t)
  auto k_value = [&](int tile) {
    const int row = tile * br + t;
    return mean && t < br && tile < n_tiles && row < R ? k[row] : 0.f;
  };

  if (t == 0) {
    for (int i = 0; i <= ns; ++i) mbar_init(smem_u32(&bars[i]), 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  // the weights, one bulk copy each, then the first tiles' inputs
  if (t == 0) {
    mbar_expect_tx(wbar, static_cast<uint32_t>(Din + Dout) * Dh * 4);
    bulk_load(smem_u32(W2s), W2, static_cast<uint32_t>(Dh) * Dout * 4, wbar);
    bulk_load(smem_u32(W1s), W1, static_cast<uint32_t>(Din) * Dh * 4, wbar);
    for (int s = 0; s < ns; ++s)
      if (first + s * stride < n_tiles) issue(first + s * stride, s);
  }
  float kv = k_value(first);

  const int n4 = Din / 4;
  const float e1 = 1.f + eps;
  int i = 0;
  for (int tile = first; tile < n_tiles; tile += stride, ++i) {
    const int s = i % ns;
    const int row0 = tile * br;
    const int rows = min(br, R - row0);
    if (mean) {
      if (t < br) ks[t] = kv;
      __syncthreads();
    }
    mbar_wait(smem_u32(&bars[s]), (i / ns) & 1);

    // ---- z = (1 + eps) h_prev + norm(S + M); S' ----------------------------
    const float* Ss =
        reinterpret_cast<const float*>(buf + pl.stage + s * 3 * pl.plane);
    const float* Ms = Ss + static_cast<size_t>(br) * Din;
    const float* Hs = Ms + static_cast<size_t>(br) * Din;
    float* Sn = S_new + static_cast<size_t>(row0) * Din;
#pragma unroll 4
    for (int q = t; q < br * n4; q += TEAM_THREADS) {
      const int r = q / n4, o = 4 * q;
      float4 z = make_float4(0.f, 0.f, 0.f, 0.f);
      if (r < rows) {
        const float4 a = *reinterpret_cast<const float4*>(Ss + o);
        const float4 m = *reinterpret_cast<const float4*>(Ms + o);
        const float4 hp = *reinterpret_cast<const float4*>(Hs + o);
        const float4 f = make_float4(a.x + m.x, a.y + m.y, a.z + m.z,
                                     a.w + m.w);
        *reinterpret_cast<float4*>(Sn + o) = f;
        float4 x = f;
        if (mean) {
          const float d = fmaxf(ks[r], 1.f);
          x = make_float4(f.x / d, f.y / d, f.z / d, f.w / d);
        }
        z = make_float4(e1 * hp.x + x.x, e1 * hp.y + x.y, e1 * hp.z + x.z,
                        e1 * hp.w + x.w);
      }
      *reinterpret_cast<float4*>(Zs + o) = z;
    }
    __syncthreads();   // z complete; the reads of stage s are done
    const int next = tile + ns * stride;
    if (t == 0 && next < n_tiles) {
      fence_proxy_async();
      issue(next, s);
    }
    kv = k_value(tile + stride);
    if (i == 0) mbar_wait(wbar, 0);

    // ---- h1 = relu(z W1 + b1) ----------------------------------------------
    team_product<TM1>(
        Zs, W1s, Din, Dh, br, Dh, t,
        [&](int r0, int c, const float (&acc)[TM1][TN]) {
#pragma unroll
          for (int g = 0; g < 2; ++g) {
            const int col = c + 32 * g;
            if (col >= Dh) continue;
            const float4 bv = *reinterpret_cast<const float4*>(b1 + col);
#pragma unroll
            for (int a = 0; a < TM1; ++a)
              *reinterpret_cast<float4*>(H1s + (r0 + 4 * a) * Dh + col) =
                  make_float4(fmaxf(acc[a][4 * g] + bv.x, 0.f),
                              fmaxf(acc[a][4 * g + 1] + bv.y, 0.f),
                              fmaxf(acc[a][4 * g + 2] + bv.z, 0.f),
                              fmaxf(acc[a][4 * g + 3] + bv.w, 0.f));
          }
        });
    __syncthreads();   // h1 complete

    // ---- h = act(h1 W2 + b2) -----------------------------------------------
    team_product<TM2>(H1s, W2s, Dh, Dout, br, Dout, t,
                      [&](int r0, int c, const float (&acc)[TM2][TN]) {
                        store_act<TM2>(h, b2, row0, rows, Dout, relu, r0, c,
                                       acc);
                      });
  }
}

template <int TM1, int TM2>
int launch_resident(const float* S, const float* M, const float* Hp,
                    const float* k, const float* W1, const float* b1,
                    const float* W2, const float* b2, float* S_new, float* h,
                    int R, int Din, int Dh, int Dout, int br, int ns,
                    int grid, float eps, bool mean, bool relu,
                    cudaStream_t s) {
  if (br % (4 * TM1) || br % (4 * TM2) || Din % 16 || Dh % 8 || Dout % 4 ||
      ns < 1 || ns > 2)
    return static_cast<int>(cudaErrorInvalidValue);
  const MlpPlan pl(Din, Dh, Dout, br, ns);
  auto* kernel = resident_kernel<TM1, TM2>;
  // the attribute belongs to the current device: set it at every launch
  // that needs more than the default 48 KB (the call is cheap)
  if (pl.bytes > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(pl.bytes));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  // each CTA owns a tile: one that owned none would leave with the
  // weights' copies in flight
  const int ctas = min(grid, (R + br - 1) / br);
  kernel<<<ctas, TEAM_THREADS, pl.bytes, s>>>(S, M, Hp, k, W1, b1, W2, b2,
                                              S_new, h, R, Din, Dh, Dout, br,
                                              ns, eps, mean, relu);
  return static_cast<int>(cudaGetLastError());
}

// ---- the tiled route --------------------------------------------------------

constexpr int BR = 32;        // rows per block
constexpr int BO = 64;        // output columns per product pass
constexpr int BK = 32;        // K-chunk of the weights staged in shared memory
constexpr int THREADS = 256;  // 16 x 16 threads, each 2 rows x 4 columns

// acc += A[ty*2 .. ty*2+1][0:K] @ W[0:K][c0 + tx*4 .. c0 + tx*4 + 3], with
// A in shared memory (row stride lda) and W [K, N] in device memory,
// staged through Ws one K-chunk at a time.
__device__ __forceinline__ void tile_mm(const float* As, int lda,
                                        const float* __restrict__ W, int K,
                                        int N, int c0, float (*Ws)[BO],
                                        float acc[2][4], int tid, int tx,
                                        int ty) {
  for (int k0 = 0; k0 < K; k0 += BK) {
    for (int e = tid; e < BK * BO; e += THREADS) {
      const int r = e / BO, c = e % BO;
      const int kk = k0 + r, col = c0 + c;
      Ws[r][c] = (kk < K && col < N) ? W[(size_t)kk * N + col] : 0.f;
    }
    __syncthreads();
    const int kn = min(BK, K - k0);
    const float* a0p = As + (ty * 2) * lda + k0;
    const float* a1p = a0p + lda;
    for (int kk = 0; kk < kn; ++kk) {
      const float a0 = a0p[kk];
      const float a1 = a1p[kk];
      const float4 w = *reinterpret_cast<const float4*>(&Ws[kk][tx * 4]);
      acc[0][0] += a0 * w.x; acc[0][1] += a0 * w.y;
      acc[0][2] += a0 * w.z; acc[0][3] += a0 * w.w;
      acc[1][0] += a1 * w.x; acc[1][1] += a1 * w.y;
      acc[1][2] += a1 * w.z; acc[1][3] += a1 * w.w;
    }
    __syncthreads();
  }
}

__global__ void __launch_bounds__(THREADS)
tiled_kernel(const float* __restrict__ S, const float* __restrict__ M,
             const float* __restrict__ Hp, const float* __restrict__ k,
             const float* __restrict__ W1, const float* __restrict__ b1,
             const float* __restrict__ W2, const float* __restrict__ b2,
             float* __restrict__ S_new, float* __restrict__ h, int R, int Din,
             int Dh, int Dout, float eps, bool mean, bool relu) {
  extern __shared__ __align__(16) float smem[];
  float (*Ws)[BO] = reinterpret_cast<float (*)[BO]>(smem);
  const int ldz = Din + 1;  // +1: rows 2 apart hit other banks
  const int ldh = Dh + 1;
  float* zs = smem + BK * BO;  // [BR][ldz]
  float* h1s = zs + BR * ldz;  // [BR][ldh]
  const int row0 = blockIdx.x * BR;
  const int tid = threadIdx.x;
  const int tx = tid % 16;
  const int ty = tid / 16;

  for (int e = tid; e < BR * Din; e += THREADS) {
    const int r = e / Din, c = e % Din;
    const int row = row0 + r;
    float z = 0.f;
    if (row < R) {
      const size_t i = (size_t)row * Din + c;
      const float s = S[i] + M[i];
      S_new[i] = s;
      const float x = mean ? s / fmaxf(k[row], 1.f) : s;
      z = (1.f + eps) * Hp[i] + x;
    }
    zs[r * ldz + c] = z;
  }
  __syncthreads();

  for (int c0 = 0; c0 < Dh; c0 += BO) {
    float acc[2][4] = {};
    tile_mm(zs, ldz, W1, Din, Dh, c0, Ws, acc, tid, tx, ty);
    for (int i = 0; i < 2; ++i)
      for (int j = 0; j < 4; ++j) {
        const int col = c0 + tx * 4 + j;
        if (col < Dh)
          h1s[(ty * 2 + i) * ldh + col] = fmaxf(acc[i][j] + b1[col], 0.f);
      }
  }
  __syncthreads();

  for (int c0 = 0; c0 < Dout; c0 += BO) {
    float acc[2][4] = {};
    tile_mm(h1s, ldh, W2, Dh, Dout, c0, Ws, acc, tid, tx, ty);
    for (int i = 0; i < 2; ++i) {
      const int row = row0 + ty * 2 + i;
      if (row >= R) continue;
      for (int j = 0; j < 4; ++j) {
        const int col = c0 + tx * 4 + j;
        if (col >= Dout) continue;
        float v = acc[i][j] + b2[col];
        if (relu) v = fmaxf(v, 0.f);
        h[(size_t)row * Dout + col] = v;
      }
    }
  }
}

}  // namespace

// Dynamic shared memory one block of the tiled route needs at these
// widths, in bytes.
extern "C" long long mlp_apply_smem_bytes(int Din, int Dh) {
  return 4LL * (BK * BO + BR * (Din + 1LL) + BR * (Dh + 1LL));
}

// Dynamic shared memory one CTA of the resident route needs, in bytes: what
// ops.py::resident_smem computes.
extern "C" long long mlp_apply_resident_smem(int Din, int Dh, int Dout,
                                             int br, int ns) {
  return static_cast<long long>(MlpPlan(Din, Dh, Dout, br, ns).bytes);
}

// Launches on `stream`; returns the first CUDA error of the attribute call
// or the launch (0 when it was accepted).  Requires R, Din, Dh, Dout >= 1.
// resident = 0 takes the tiled route (mlp_apply_smem_bytes(Din, Dh) within
// the device's opt-in shared memory); resident = 1 the resident route,
// with tiles of `br` rows, `ns` (1 or 2) stages, products of tm1 and tm2
// rows a thread (the pairs instantiated below), and at most `grid` CTAs
// (ops.py::kernel_plan checks the shape, the alignment and the shared
// memory they need).  Allocates nothing.
extern "C" int mlp_apply_launch(const float* S, const float* M,
                                const float* Hp, const float* k,
                                const float* W1, const float* b1,
                                const float* W2, const float* b2,
                                float* S_new, float* h, int R, int Din,
                                int Dh, int Dout, float eps, int mean,
                                int relu, int resident, int br, int tm1,
                                int tm2,
                                int ns, int grid, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool mn = mean != 0, rl = relu != 0;
  if (!resident) {
    const int smem = static_cast<int>(mlp_apply_smem_bytes(Din, Dh));
    if (smem > 48 * 1024) {
      const cudaError_t err = cudaFuncSetAttribute(
          tiled_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
      if (err != cudaSuccess) return static_cast<int>(err);
    }
    tiled_kernel<<<(R + BR - 1) / BR, THREADS, smem, s>>>(
        S, M, Hp, k, W1, b1, W2, b2, S_new, h, R, Din, Dh, Dout, eps, mn,
        rl);
    return static_cast<int>(cudaGetLastError());
  }
#define MLP_ROUTE(TM1, TM2)                                                   \
  if (tm1 == TM1 && tm2 == TM2)                                               \
    return launch_resident<TM1, TM2>(S, M, Hp, k, W1, b1, W2, b2, S_new, h,   \
                                     R, Din, Dh, Dout, br, ns, grid, eps, mn, \
                                     rl, s);
  // the pairs ops.py::thread_rows gives: 1-2 rows a thread in tiles of up
  // to 16 rows, 2-4 in tiles of 32
  MLP_ROUTE(1, 1) MLP_ROUTE(1, 2) MLP_ROUTE(2, 1) MLP_ROUTE(2, 2)
  MLP_ROUTE(2, 4) MLP_ROUTE(4, 2) MLP_ROUTE(4, 4)
#undef MLP_ROUTE
  return static_cast<int>(cudaErrorInvalidValue);
}
