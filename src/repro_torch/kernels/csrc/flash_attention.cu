// Causal grouped-query attention with an online softmax for Hopper (sm_90a):
//
//     out[b, i, h, :] = sum_{j <= i} softmax_j(q[b, i, h] . k[b, j, g] / sqrt(Dh))
//                       * v[b, j, g, :],        g = h / (H / Hkv)
//
// q: [B, S, H, Dh]; k, v: [B, S, Hkv, Dh]; out: [B, S, H, Dh], all row-major
// and of one type, bf16 or fp32.  Scores, the running max, the denominator
// and the accumulator are fp32; a masked score is -1e30 and the final
// denominator is floored at 1e-30, as the TPU kernel does.  In bf16 the
// probabilities are cast to bf16 before P.V (the TPU kernel casts p to v's
// type); fp32 runs plain FMA throughout (no TF32).  Any S is taken (the
// ragged last tiles are masked); Dh is one of 8, 16, 32, 64, 128 in fp32
// and one of 8, 16, 32 in bf16 (flash_attention_sm90.cu takes bf16 at 64
// and 128).
//
// Replaces the TPU kernel src/repro/kernels/flash_attention/kernel.py
// (flash_attention_pallas, pl.pallas_call at line 86), whose grid walks
// (B*Hkv, q blocks, kv blocks) in order with the running state in VMEM
// scratch and folds the rep = H / Hkv query heads of a kv head into one
// block.  Here blocks run in parallel and in no order, so each block walks
// its own kv tiles in a loop and keeps the running state in registers.
//
// What bounds it on an H100: operations.  At the prefill shape of
// phi4-mini (B=4, S=2048, H=24, Hkv=8, Dh=128) the causal half of the two
// products is ~1.03e11 FLOP (0.104 ms at the data sheet's 989 TFLOP/s
// bf16 of an H100 SXM at 700 W) against 134 MB of q, k, v and out
// (0.040 ms at 3.35 TB/s).  What the design does:
//   - one block per (batch x kv head x group of query heads, q tile): the
//     block's warps cover up to 8 query heads of one kv head, 16 query rows
//     each, so every k/v tile staged in shared memory serves all of them
//     (3 heads x 32 rows for phi4-mini, 6 warps);
//   - bf16 products run on the tensor cores (mma.sync m16n8k16, fp32
//     accumulate); the score tile stays in registers and is reused as the
//     A operand of P.V, so scores never touch shared or device memory;
//   - k/v tiles of 64 keys are double-buffered with cp.async, the next
//     tile's copy overlapping the current tile's products; their fragments
//     come through ldmatrix (transposed for v), and rows are padded by 16
//     bytes so those reads are free of bank conflicts;
//   - causal skip: a block stops at its last row's tile, a warp skips the
//     tiles past its own last row, and only tiles that cross the diagonal
//     or the ragged end are masked; the q tiles with the most work launch
//     first.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr float NEG = -1e30f;
constexpr float LOG2E = 1.4426950408889634f;
constexpr int MAX_WARPS = 8;
constexpr unsigned FULL = 0xffffffffu;

template <typename T>
struct Tile;

template <>
struct Tile<__nv_bfloat16> {
  static constexpr int BKV = 64;     // keys per k/v tile
  static constexpr int PAD = 8;      // elements of padding per smem row
};

template <>
struct Tile<float> {
  static constexpr int BKV = 32;
  static constexpr int PAD = 4;
};

template <typename T, int DH>
struct Dims {
  static constexpr int BKV = Tile<T>::BKV;
  static constexpr int KD = DH < 16 ? 16 : DH;   // head dim, padded to k=16
  static constexpr int LD = KD + Tile<T>::PAD;   // smem row stride
  static constexpr int NT = BKV / 8;             // score n-tiles (8 keys)
  static constexpr int DT = DH / 8;              // output n-tiles (8 dims)
  static constexpr int KS = KD / 16;             // k-steps of q.k
  static constexpr int CHUNKS = DH * (int)sizeof(T) / 16;  // 16 B per row
  static constexpr int PLD = BKV + 4;            // fp32 P row stride
  static constexpr size_t KV_BYTES = 2ull * 2 * BKV * LD * sizeof(T);
  static constexpr size_t SMEM = KV_BYTES + (sizeof(T) == 4
      ? (size_t)MAX_WARPS * 16 * (LD + PLD) * sizeof(float) : 0);
};

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem,
                                           bool valid) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  const int n = valid ? 16 : 0;      // 0: zero-fill, read nothing
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(s), "l"(gmem), "r"(n));
}
__device__ __forceinline__ void cp_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
template <int N>
__device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);   // .x = lo, low half
  return *reinterpret_cast<uint32_t*>(&v);
}

// c += a (16x16, row) . b (16x8, col); bf16 in, fp32 accumulate
__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const void* p) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(p));
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]) : "r"(s));
}
__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4],
                                                  const void* p) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(p));
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]) : "r"(s));
}
__device__ __forceinline__ void ldmatrix_x2_trans(uint32_t (&r)[2],
                                                  const void* p) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(p));
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x2.trans.shared.b16 {%0,%1}, [%2];\n"
      : "=r"(r[0]), "=r"(r[1]) : "r"(s));
}

__device__ __forceinline__ void store2(__nv_bfloat16* p, float a, float b) {
  *reinterpret_cast<uint32_t*>(p) = pack_bf16(a, b);
}
__device__ __forceinline__ void store2(float* p, float a, float b) {
  *reinterpret_cast<float2*>(p) = make_float2(a, b);
}

// Per-warp operand state: the q rows in registers (bf16) or in the warp's
// shared-memory slab (fp32).
template <typename T, int DH>
struct QOperand;

template <int DH>
struct QOperand<__nv_bfloat16, DH> {
  using D = Dims<__nv_bfloat16, DH>;
  uint32_t a[D::KS][4];

  // the warp's 16 rows from row0 on (rows at row_stride), of which the
  // first n_valid exist; zero past them and past DH
  __device__ __forceinline__ void load(const __nv_bfloat16* row0,
                                       size_t row_stride, int n_valid,
                                       int gq, int c, float*) {
#pragma unroll
    for (int ks = 0; ks < D::KS; ++ks) {
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int r = gq + (i & 1) * 8;
        const int col = ks * 16 + 2 * c + (i >> 1) * 8;
        a[ks][i] = r < n_valid && col < DH
                       ? *reinterpret_cast<const uint32_t*>(
                             row0 + r * row_stride + col)
                       : 0u;
      }
    }
  }

  // s[j] = q . k[tile key j*8 .. j*8+7]^T; one ldmatrix.x4 brings the
  // B fragments of two n-tiles
  __device__ __forceinline__ void scores(const __nv_bfloat16* Ks,
                                         float (&s)[D::NT][4], int gq,
                                         int c, const float*) const {
    const int lane = gq * 4 + c;
#pragma unroll
    for (int j = 0; j < D::NT; ++j) {
      s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.f;
    }
#pragma unroll
    for (int ks = 0; ks < D::KS; ++ks) {
#pragma unroll
      for (int j = 0; j < D::NT; j += 2) {
        uint32_t b[4];
        ldmatrix_x4(b, Ks + ((j + (lane >> 4)) * 8 + (lane & 7)) * D::LD
                           + ks * 16 + ((lane >> 3) & 1) * 8);
        mma_bf16(s[j], a[ks], b[0], b[1]);
        mma_bf16(s[j + 1], a[ks], b[2], b[3]);
      }
    }
  }

  // o += bf16(p) . v over the tile's keys
  __device__ __forceinline__ void pv(const __nv_bfloat16* Vs,
                                     const float (&s)[D::NT][4],
                                     float (&o)[D::DT][4], int lane,
                                     float*) const {
#pragma unroll
    for (int kk = 0; kk < D::BKV / 16; ++kk) {
      const uint32_t pa[4] = {pack_bf16(s[2 * kk][0], s[2 * kk][1]),
                              pack_bf16(s[2 * kk][2], s[2 * kk][3]),
                              pack_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1]),
                              pack_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3])};
      const int krow = kk * 16 + (lane & 7) + ((lane >> 3) & 1) * 8;
#pragma unroll
      for (int dt = 0; dt + 1 < D::DT; dt += 2) {
        uint32_t b[4];
        ldmatrix_x4_trans(b, Vs + krow * D::LD + (dt + (lane >> 4)) * 8);
        mma_bf16(o[dt], pa, b[0], b[1]);
        mma_bf16(o[dt + 1], pa, b[2], b[3]);
      }
      if constexpr (D::DT & 1) {
        uint32_t b[2];
        ldmatrix_x2_trans(b, Vs + krow * D::LD + (D::DT - 1) * 8);
        mma_bf16(o[D::DT - 1], pa, b[0], b[1]);
      }
    }
  }
};

template <int DH>
struct QOperand<float, DH> {
  using D = Dims<float, DH>;

  __device__ __forceinline__ void load(const float* row0, size_t row_stride,
                                       int n_valid, int gq, int c,
                                       float* Qs) {
    for (int i = gq * 4 + c; i < 16 * DH; i += 32) {
      const int r = i / DH, d = i % DH;
      Qs[r * D::LD + d] = r < n_valid ? row0[r * row_stride + d] : 0.f;
    }
    __syncwarp();
  }

  __device__ __forceinline__ void scores(const float* Ks,
                                         float (&s)[D::NT][4], int gq,
                                         int c, const float* Qs) const {
#pragma unroll
    for (int j = 0; j < D::NT; ++j) {
      s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.f;
    }
    const float* q0 = Qs + gq * D::LD;
    const float* q1 = Qs + (gq + 8) * D::LD;
#pragma unroll 4
    for (int d = 0; d < DH; ++d) {
      const float a0 = q0[d], a1 = q1[d];
#pragma unroll
      for (int j = 0; j < D::NT; ++j) {
        const float k0 = Ks[(j * 8 + 2 * c) * D::LD + d];
        const float k1 = Ks[(j * 8 + 2 * c + 1) * D::LD + d];
        s[j][0] = fmaf(a0, k0, s[j][0]);
        s[j][1] = fmaf(a0, k1, s[j][1]);
        s[j][2] = fmaf(a1, k0, s[j][2]);
        s[j][3] = fmaf(a1, k1, s[j][3]);
      }
    }
  }

  __device__ __forceinline__ void pv(const float* Vs,
                                     const float (&s)[D::NT][4],
                                     float (&o)[D::DT][4], int lane,
                                     float* Ps) const {
    const int gq = lane >> 2, c = lane & 3;
#pragma unroll
    for (int j = 0; j < D::NT; ++j) {
      Ps[gq * D::PLD + j * 8 + 2 * c] = s[j][0];
      Ps[gq * D::PLD + j * 8 + 2 * c + 1] = s[j][1];
      Ps[(gq + 8) * D::PLD + j * 8 + 2 * c] = s[j][2];
      Ps[(gq + 8) * D::PLD + j * 8 + 2 * c + 1] = s[j][3];
    }
    __syncwarp();
#pragma unroll 4
    for (int key = 0; key < D::BKV; ++key) {
      const float p0 = Ps[gq * D::PLD + key];
      const float p1 = Ps[(gq + 8) * D::PLD + key];
#pragma unroll
      for (int dt = 0; dt < D::DT; ++dt) {
        const float2 v = *reinterpret_cast<const float2*>(
            Vs + key * D::LD + dt * 8 + 2 * c);
        o[dt][0] = fmaf(p0, v.x, o[dt][0]);
        o[dt][1] = fmaf(p0, v.y, o[dt][1]);
        o[dt][2] = fmaf(p1, v.x, o[dt][2]);
        o[dt][3] = fmaf(p1, v.y, o[dt][3]);
      }
    }
    __syncwarp();   // Ps is rewritten by the next tile
  }
};

// Grid: x = q tile (the last, longest first), y = (b, kv head g, head
// group).  Block: heads_per_block x slabs warps; warp w takes head
// g*rep + hg*heads_per_block + w / slabs and query rows
// qt*16*slabs + (w % slabs)*16 ... +15.
template <typename T, int DH>
__global__ void __launch_bounds__(32 * MAX_WARPS)
flash_kernel(const T* __restrict__ q, const T* __restrict__ k,
             const T* __restrict__ v, T* __restrict__ out, int S, int H,
             int Hkv, int heads_per_block, int slabs, float scale_log2) {
  using D = Dims<T, DH>;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* Ks = reinterpret_cast<T*>(smem_raw);               // [2][BKV][LD]
  T* Vs = Ks + 2 * D::BKV * D::LD;                       // [2][BKV][LD]
  float* Qs = reinterpret_cast<float*>(smem_raw + D::KV_BYTES);
  float* Ps = Qs + MAX_WARPS * 16 * D::LD;

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int gq = lane >> 2, c = lane & 3;
  const int rep = H / Hkv;
  const int groups = rep / heads_per_block;
  const int bq = 16 * slabs;
  const int qt = gridDim.x - 1 - blockIdx.x;
  const int hg = blockIdx.y % groups;
  const int g = (blockIdx.y / groups) % Hkv;
  const int b = blockIdx.y / (groups * Hkv);
  const int h = g * rep + hg * heads_per_block + warp / slabs;
  const int p0 = qt * bq;                         // block's first row
  const int pw = p0 + (warp % slabs) * 16;        // warp's first row
  const int p_end = min(p0 + bq, S);              // block's rows end
  const int n_tiles = (p_end + D::BKV - 1) / D::BKV;
  const int w_last = min(pw + 15, S - 1);         // warp's last row

  // zero the padding columns of both stages once (DH < 16 only); the
  // copies below never write them
  if constexpr (D::KD > DH) {
    constexpr int pad_bytes = (D::KD - DH) * (int)sizeof(T);
    for (int i = threadIdx.x; i < 4 * D::BKV * pad_bytes; i += blockDim.x) {
      // Ks and Vs are contiguous: 4 * BKV rows in all
      reinterpret_cast<unsigned char*>(Ks + (i / pad_bytes) * D::LD + DH)
          [i % pad_bytes] = 0;
    }
  }

  const size_t kv_row = (size_t)Hkv * DH;       // stride between keys
  const T* kbase = k + ((size_t)b * S * Hkv + g) * DH;
  const T* vbase = v + ((size_t)b * S * Hkv + g) * DH;
  auto load_tile = [&](int t, int stage) {
    T* kd = Ks + stage * D::BKV * D::LD;
    T* vd = Vs + stage * D::BKV * D::LD;
    for (int i = threadIdx.x; i < D::BKV * D::CHUNKS; i += blockDim.x) {
      const int r = i / D::CHUNKS, ch = i % D::CHUNKS;
      const int key = t * D::BKV + r;
      const bool ok = key < S;
      const size_t off = (ok ? (size_t)key * kv_row : 0) + ch * 16 / sizeof(T);
      cp_async16(kd + r * D::LD + ch * 16 / sizeof(T), kbase + off, ok);
      cp_async16(vd + r * D::LD + ch * 16 / sizeof(T), vbase + off, ok);
    }
  };
  load_tile(0, 0);
  cp_commit();

  QOperand<T, DH> qo;
  float* myQ = Qs + warp * 16 * D::LD;
  float* myP = Ps + warp * 16 * D::PLD;
  if (pw < S) {
    qo.load(q + (((size_t)b * S + pw) * H + h) * DH, (size_t)H * DH,
            min(16, S - pw), gq, c, myQ);
  }

  float o[D::DT][4];
#pragma unroll
  for (int dt = 0; dt < D::DT; ++dt) o[dt][0] = o[dt][1] = o[dt][2] = o[dt][3] = 0.f;
  float m0 = NEG, m1 = NEG, l0 = 0.f, l1 = 0.f;   // rows gq, gq + 8
  const int r0 = pw + gq, r1 = pw + gq + 8;

  for (int t = 0; t < n_tiles; ++t) {
    if (t + 1 < n_tiles) {
      load_tile(t + 1, (t + 1) & 1);
      cp_commit();
      cp_wait<1>();
    } else {
      cp_wait<0>();
    }
    __syncthreads();
    const int kv0 = t * D::BKV;
    if (pw < S && kv0 <= w_last) {
      const T* kt = Ks + (t & 1) * D::BKV * D::LD;
      const T* vt = Vs + (t & 1) * D::BKV * D::LD;
      float s[D::NT][4];
      qo.scores(kt, s, gq, c, myQ);
      const bool masked = kv0 + D::BKV - 1 > pw || kv0 + D::BKV > S;
      float mx0 = NEG, mx1 = NEG;
#pragma unroll
      for (int j = 0; j < D::NT; ++j) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          float x = s[j][e] * scale_log2;
          if (masked) {
            const int key = kv0 + j * 8 + 2 * c + (e & 1);
            const int row = e < 2 ? r0 : r1;
            if (key > row || key >= S) x = NEG;
          }
          s[j][e] = x;
        }
        mx0 = fmaxf(mx0, fmaxf(s[j][0], s[j][1]));
        mx1 = fmaxf(mx1, fmaxf(s[j][2], s[j][3]));
      }
      mx0 = fmaxf(mx0, __shfl_xor_sync(FULL, mx0, 1));
      mx0 = fmaxf(mx0, __shfl_xor_sync(FULL, mx0, 2));
      mx1 = fmaxf(mx1, __shfl_xor_sync(FULL, mx1, 1));
      mx1 = fmaxf(mx1, __shfl_xor_sync(FULL, mx1, 2));
      const float mn0 = fmaxf(m0, mx0), mn1 = fmaxf(m1, mx1);
      const float al0 = exp2f(m0 - mn0), al1 = exp2f(m1 - mn1);
      m0 = mn0;
      m1 = mn1;
      float sum0 = 0.f, sum1 = 0.f;
#pragma unroll
      for (int j = 0; j < D::NT; ++j) {
        s[j][0] = exp2f(s[j][0] - mn0);
        s[j][1] = exp2f(s[j][1] - mn0);
        s[j][2] = exp2f(s[j][2] - mn1);
        s[j][3] = exp2f(s[j][3] - mn1);
        sum0 += s[j][0] + s[j][1];
        sum1 += s[j][2] + s[j][3];
      }
      l0 = l0 * al0 + sum0;     // this lane's columns; the quad sums at the end
      l1 = l1 * al1 + sum1;
#pragma unroll
      for (int dt = 0; dt < D::DT; ++dt) {
        o[dt][0] *= al0;
        o[dt][1] *= al0;
        o[dt][2] *= al1;
        o[dt][3] *= al1;
      }
      qo.pv(vt, s, o, lane, myP);
    }
    __syncthreads();   // the stage read here is refilled next iteration
  }

  l0 += __shfl_xor_sync(FULL, l0, 1);
  l0 += __shfl_xor_sync(FULL, l0, 2);
  l1 += __shfl_xor_sync(FULL, l1, 1);
  l1 += __shfl_xor_sync(FULL, l1, 2);
  const float d0 = fmaxf(l0, 1e-30f), d1 = fmaxf(l1, 1e-30f);
  if (pw < S) {
#pragma unroll
    for (int dt = 0; dt < D::DT; ++dt) {
      const int col = dt * 8 + 2 * c;
      if (r0 < S) {
        store2(out + (((size_t)b * S + r0) * H + h) * DH + col,
               o[dt][0] / d0, o[dt][1] / d0);
      }
      if (r1 < S) {
        store2(out + (((size_t)b * S + r1) * H + h) * DH + col,
               o[dt][2] / d1, o[dt][3] / d1);
      }
    }
  }
}

template <typename T, int DH>
cudaError_t launch(const void* q, const void* k, const void* v, void* out,
                   int B, int S, int H, int Hkv, int heads_per_block,
                   int slabs, cudaStream_t stream) {
  using D = Dims<T, DH>;
  static bool configured = false;
  if (!configured) {
    const cudaError_t err = cudaFuncSetAttribute(
        flash_kernel<T, DH>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)D::SMEM);
    if (err != cudaSuccess) return err;
    configured = true;
  }
  const int bq = 16 * slabs;
  const long long blocks_y = (long long)B * H / heads_per_block;
  if (blocks_y > 65535) return cudaErrorInvalidValue;
  const dim3 grid((S + bq - 1) / bq, (unsigned)blocks_y);
  const dim3 block(32 * heads_per_block * slabs);
  const float scale_log2 = LOG2E / sqrtf((float)DH);
  flash_kernel<T, DH><<<grid, block, D::SMEM, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(out), S, H, Hkv,
      heads_per_block, slabs, scale_log2);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch(const void* q, const void* k, const void* v, void* out,
                     int B, int S, int H, int Hkv, int Dh, int hpb, int slabs,
                     cudaStream_t st) {
  switch (Dh) {
    case 8: return launch<T, 8>(q, k, v, out, B, S, H, Hkv, hpb, slabs, st);
    case 16: return launch<T, 16>(q, k, v, out, B, S, H, Hkv, hpb, slabs, st);
    case 32: return launch<T, 32>(q, k, v, out, B, S, H, Hkv, hpb, slabs, st);
    default: break;
  }
  if constexpr (sizeof(T) == 4) {   // fp32 only: bf16 takes the wgmma kernel
    switch (Dh) {
      case 64:
        return launch<T, 64>(q, k, v, out, B, S, H, Hkv, hpb, slabs, st);
      case 128:
        return launch<T, 128>(q, k, v, out, B, S, H, Hkv, hpb, slabs, st);
      default: break;
    }
  }
  return cudaErrorInvalidValue;
}

}  // namespace

// The block's query heads: the largest divisor of rep = H / Hkv that is at
// most 8, and 8 / that many 16-row slabs of each, so a block has at most
// 8 warps.  Returns the CUDA error of the launch (0 on success);
// cudaErrorInvalidValue for shapes the kernel does not take.
extern "C" int flash_attention_launch(const void* q, const void* k,
                                      const void* v, void* out, int B, int S,
                                      int H, int Hkv, int Dh, int bf16,
                                      void* stream) {
  if (B <= 0 || S <= 0 || Hkv <= 0 || H % Hkv != 0) {
    return cudaErrorInvalidValue;
  }
  const int rep = H / Hkv;
  int hpb = 1;
  for (int d = 1; d <= MAX_WARPS && d <= rep; ++d) {
    if (rep % d == 0) hpb = d;
  }
  const int slabs = MAX_WARPS / hpb;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  return bf16 ? dispatch<__nv_bfloat16>(q, k, v, out, B, S, H, Hkv, Dh, hpb,
                                        slabs, st)
              : dispatch<float>(q, k, v, out, B, S, H, Hkv, Dh, hpb, slabs,
                                st);
}
