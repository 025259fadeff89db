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
// What the design does about it:
//   - one block per 32-row tile; z is formed in shared memory and S' is
//     written once, so S, M, h_prev and k are read exactly once;
//   - h1 = relu(z @ W1 + b1) stays in shared memory (32 x 128 x 4 B =
//     16 KB at Dh = 128) and never touches device memory;
//   - both products stage their weights through shared memory in K-chunks
//     read as float4, with a 2 x 4 fp32 FMA register tile per thread (no
//     TF32: the result must hold a 1e-4 bar against the plain version);
//   - ragged R, Din, Dh and Dout are masked, never padded.  The wrapper
//     refuses widths whose z and h1 tiles do not fit in shared memory.
#include <cuda_runtime.h>

namespace {

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
mlp_apply_kernel(const float* __restrict__ S, const float* __restrict__ M,
                 const float* __restrict__ Hp, const float* __restrict__ k,
                 const float* __restrict__ W1, const float* __restrict__ b1,
                 const float* __restrict__ W2, const float* __restrict__ b2,
                 float* __restrict__ S_new, float* __restrict__ h, int R,
                 int Din, int Dh, int Dout, float eps, bool mean, bool relu) {
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

// Dynamic shared memory one block needs at these widths, in bytes.
extern "C" long long mlp_apply_smem_bytes(int Din, int Dh) {
  return 4LL * (BK * BO + BR * (Din + 1LL) + BR * (Dh + 1LL));
}

// Launches on `stream`; returns the first CUDA error of the attribute call
// or the launch (cudaGetLastError() after it).  Requires R, Din, Dh, Dout
// >= 1 and mlp_apply_smem_bytes(Din, Dh) within the device's opt-in
// shared-memory limit; allocates nothing.
extern "C" int mlp_apply_launch(const float* S, const float* M,
                                const float* Hp, const float* k,
                                const float* W1, const float* b1,
                                const float* W2, const float* b2,
                                float* S_new, float* h, int R, int Din,
                                int Dh, int Dout, float eps, int mean,
                                int relu, void* stream) {
  const int smem = static_cast<int>(mlp_apply_smem_bytes(Din, Dh));
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        mlp_apply_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  mlp_apply_kernel<<<(R + BR - 1) / BR, THREADS, smem,
                     static_cast<cudaStream_t>(stream)>>>(
      S, M, Hp, k, W1, b1, W2, b2, S_new, h, R, Din, Dh, Dout, eps,
      mean != 0, relu != 0);
  return static_cast<int>(cudaGetLastError());
}
