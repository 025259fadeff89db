// Sum-mode EmbeddingBag for Hopper (sm_90a):
//
//     out[b, :] = sum_h table[idx[b, h], :]      (lanes == padding_idx skipped)
//
// idx: [B, hot] int32; table: [V, d] fp32 or bf16; out: [B, d] in the
// table's type, all row-major.  Sums run in fp32 (compensated, in lane
// order) and a bf16 result is rounded once (to nearest even) at the end.
// padding_idx < 0 means none.  An index outside [0, V) is never clamped:
// the kernel traps, which the caller sees as a CUDA error at its next
// synchronisation.
//
// Replaces the TPU kernel src/repro/kernels/embedding_bag/kernel.py
// (embedding_bag_pallas, pl.pallas_call at line 47), whose sequential
// (bag, hot, d_tile) grid DMAs one table row per step into an accumulating
// output block, driven by scalar-prefetched indices.
//
// What bounds it on an H100: one add per gathered element, so bytes: the
// index rectangle (4 B per lane), the rows it gathers (d elements per kept
// lane) and the output.  Two shapes meet here, and each has a route
// (kernels/embedding_bag/ops.py::kernel_plan picks it before the launch):
//
// "narrow": short bags, many to a block (DLRM's one-lane bags: 262,144 of
// them over a 2.56 GB table, each one random 256-byte row).  The bound is
// the rows themselves, read at random; what costs time besides is per-bag
// overhead (a block, a barrier, 4-byte loads).  So:
//   - a group of G threads (G = the row's 16-byte vectors, rounded up to a
//     power of two: 16 at fp32 d 64, 8 at bf16 d 64) reads a row as 16-byte
//     vectors, neighbouring threads on neighbouring addresses; a warp holds
//     32 / G groups, one bag each;
//   - a warp takes a tile of NB = 32 / G * u bags (u bags a group) and
//     reads the tile's ids with one coalesced 4-byte load per lane of the
//     warp (NB bags x 32 / NB lanes of each at a time, the next window's
//     load issued before this one's rows), handing each group its row ids
//     with __shfl_sync: no shared memory, no barrier;
//   - every thread issues the row loads of u bags x w lanes of each
//     before any add: 8 in all at fp32, 4 at bf16 (128 bytes a thread in
//     flight) for short bags (hot 1: u 8, w 1), and for a bag of hot >= 16
//     (8 at bf16) 16 of its lanes (8), so that even a small batch, whose
//     warps each walk their bags' lanes in turn, waits on few round trips;
//   - persistent blocks (3-4 a SM, as their registers allow) walk the
//     tiles;
//   - each bag is summed in fp32 in lane order with the compensated add of
//     the span route, so the two routes agree bit for bit on a bag of one
//     span, a rerun is bit-equal and a one-lane bag is its row.
//   Taken where a row is a multiple of 16 bytes and at most 512, table and
//   out start on 16-byte boundaries (ids need not) and hot is at most
//   ops.NARROW_MAX_HOT, the crossover of a sweep on the card (ops.py).
//
// "span": wide bags (the engine's PNA gather, where the rectangle is as
// wide as the largest in-degree among the bag rows, so one hub makes every
// bag that wide and most lanes are padding, while the hub's own bag holds
// a hundred thousand rows) and every shape the narrow route does not take.
// The bound is the index rectangle.  So:
//   - a bag's lanes are cut into spans of SPLIT lanes; one block sums one
//     (bag, span, 128-column tile), one column per thread, so a gathered
//     row is read as coalesced runs of d elements and the hub's bag is
//     spread over many blocks instead of serialising one;
//   - the block stages its span's indices 1024 at a time, each warp 256
//     consecutive lanes with 8 independent loads per thread in flight, and
//     compacts the lanes that are not padding into shared memory in lane
//     order (ballot + popc, per warp): a padding lane costs its 4 index
//     bytes and nothing else;
//   - the kept rows are summed in a fixed order with 8 loads in flight per
//     thread, into a compensated (Kahan) fp32 sum; with more than one span
//     the spans' sums go to an fp32 scratch [B * spans, d] that a second
//     kernel adds up in span order, so a result never varies from run to
//     run and no atomics are used;
//   - a ragged d is masked (threads past d only stage indices), not padded.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int THREADS = 128;                 // one column each
constexpr int WARPS = THREADS / 32;
constexpr int PER_THREAD = 8;                // lanes a thread stages a pass
constexpr int WARP_SPAN = 32 * PER_THREAD;   // lanes a warp stages a pass
constexpr int CHUNK = THREADS * PER_THREAD;  // lanes a block stages a pass
constexpr int SPLIT = 4 * CHUNK;             // lanes one block sums
constexpr int UNROLL = 8;                    // row loads in flight

constexpr int NARROW_THREADS = 128;          // 4 warps a block
constexpr int NARROW_BLOCKS_PER_SM = 4;      // 128 registers a thread

__device__ __forceinline__ float load(const float* p) { return __ldg(p); }
__device__ __forceinline__ float load(const __nv_bfloat16* p) {
  return __bfloat162float(*p);
}
__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16_rn(v);
}

// s + x with the lost low-order bits carried in c (Kahan).
__device__ __forceinline__ void kahan_add(float& s, float& c, float x) {
  const float y = x - c;
  const float t = s + y;
  c = (t - s) - y;
  s = t;
}

// One block: bag `bag`, lanes [split * SPLIT, +SPLIT) of it, columns
// [ctile * THREADS, +THREADS).  Writes the span's sum to `partial` row
// (bag * n_splits + split), or straight to `out` when the bag is one span.
template <typename T>
__global__ void __launch_bounds__(THREADS)
bag_span_kernel(const T* __restrict__ table, const int* __restrict__ idx,
                T* __restrict__ out, float* __restrict__ partial, int V,
                int d, int hot, int padding_idx, int n_splits, int n_ctiles) {
  __shared__ int rows[WARPS][WARP_SPAN];  // each warp's kept lanes, in order
  __shared__ int counts[WARPS];
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int ctile = blockIdx.x % n_ctiles;
  const int span = blockIdx.x / n_ctiles;  // bag * n_splits + split
  const int bag = span / n_splits;
  const int lo = (span % n_splits) * SPLIT;
  const int hi = min(hot, lo + SPLIT);
  const int col = ctile * THREADS + threadIdx.x;
  const bool has_col = col < d;
  const int* bag_idx = idx + (size_t)bag * hot;
  const T* tcol = table + (has_col ? col : 0);
  const unsigned below = (1u << lane) - 1u;

  float acc = 0.f, comp = 0.f;
  for (int base = lo; base < hi; base += CHUNK) {
    const int first = base + warp * WARP_SPAN + lane;
    int v[PER_THREAD];
#pragma unroll
    for (int k = 0; k < PER_THREAD; ++k) {
      const int h = first + k * 32;
      v[k] = h < hi ? __ldg(bag_idx + h) : padding_idx;
    }
    int kept = 0;
#pragma unroll
    for (int k = 0; k < PER_THREAD; ++k) {
      const bool in_span = first + k * 32 < hi;
      if (in_span && (v[k] < 0 || v[k] >= V)) __trap();
      const bool keep = in_span && v[k] != padding_idx;
      const unsigned m = __ballot_sync(0xffffffffu, keep);
      if (keep) rows[warp][kept + __popc(m & below)] = v[k];
      kept += __popc(m);
    }
    if (lane == 0) counts[warp] = kept;
    __syncthreads();
    if (has_col) {
      for (int w = 0; w < WARPS; ++w) {
        const int c = counts[w];
        const int* r = rows[w];
        int j = 0;
        for (; j + UNROLL <= c; j += UNROLL) {
          float a[UNROLL];
#pragma unroll
          for (int u = 0; u < UNROLL; ++u)
            a[u] = load(tcol + (size_t)r[j + u] * d);
#pragma unroll
          for (int u = 0; u < UNROLL; ++u) kahan_add(acc, comp, a[u]);
        }
        for (; j < c; ++j) kahan_add(acc, comp, load(tcol + (size_t)r[j] * d));
      }
    }
    __syncthreads();
  }
  if (!has_col) return;
  if (partial != nullptr)
    partial[(size_t)span * d + col] = acc;
  else
    store(out + (size_t)bag * d + col, acc);
}

// One block: bag `bag`, columns [ctile * THREADS, +THREADS): the spans'
// sums added in span order.
template <typename T>
__global__ void __launch_bounds__(THREADS)
bag_combine_kernel(const float* __restrict__ partial, T* __restrict__ out,
                   int d, int n_splits, int n_ctiles) {
  const int ctile = blockIdx.x % n_ctiles;
  const int bag = blockIdx.x / n_ctiles;
  const int col = ctile * THREADS + threadIdx.x;
  if (col >= d) return;
  const float* p = partial + (size_t)bag * n_splits * d + col;
  float acc = 0.f, comp = 0.f;
  for (int s = 0; s < n_splits; ++s) kahan_add(acc, comp, p[(size_t)s * d]);
  store(out + (size_t)bag * d + col, acc);
}

// ---- the narrow route -----------------------------------------------------

// Elements of T in a 16-byte vector (E), the vector's conversions, and the
// most bags a narrow group holds at once (U: U rows in flight a thread;
// bf16 keeps twice the elements a vector in registers, so half the bags).
template <typename T> struct Vec;
template <> struct Vec<float> {
  static constexpr int E = 4;
  static constexpr int U = 8;
  static __device__ __forceinline__ void unpack(const uint4& r, float* x) {
    x[0] = __uint_as_float(r.x);
    x[1] = __uint_as_float(r.y);
    x[2] = __uint_as_float(r.z);
    x[3] = __uint_as_float(r.w);
  }
  static __device__ __forceinline__ uint4 pack(const float* x) {
    return make_uint4(__float_as_uint(x[0]), __float_as_uint(x[1]),
                      __float_as_uint(x[2]), __float_as_uint(x[3]));
  }
};
template <> struct Vec<__nv_bfloat16> {
  static constexpr int E = 8;
  static constexpr int U = 4;
  static __device__ __forceinline__ float2 pair(unsigned w) {
    __nv_bfloat162 h;
    *reinterpret_cast<unsigned*>(&h) = w;
    return __bfloat1622float2(h);
  }
  static __device__ __forceinline__ unsigned word(float a, float b) {
    const __nv_bfloat162 h = __floats2bfloat162_rn(a, b);
    return *reinterpret_cast<const unsigned*>(&h);
  }
  static __device__ __forceinline__ void unpack(const uint4& r, float* x) {
    const unsigned w[4] = {r.x, r.y, r.z, r.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float2 f = pair(w[i]);
      x[2 * i] = f.x;
      x[2 * i + 1] = f.y;
    }
  }
  static __device__ __forceinline__ uint4 pack(const float* x) {
    return make_uint4(word(x[0], x[1]), word(x[2], x[3]), word(x[4], x[5]),
                      word(x[6], x[7]));
  }
};

// Blocks of NARROW_THREADS a SM that the narrow kernel's registers allow:
// 3 where a thread's sums (2 E UB floats), loads in flight (4 UB W words)
// and their row addresses (2 UB W) pass 96 registers (fp32 with 8 bags a
// group, or 16 lanes of one), else 4 (128 registers a thread).
template <typename T, int UB, int W>
struct Narrow {
  static constexpr int BLOCKS =
      2 * Vec<T>::E * UB + 6 * UB * W > 96 ? 3 : NARROW_BLOCKS_PER_SM;
};

// A warp sums tiles of nb = ng * u bags (u <= UB): group g (threads
// [g G, +G)) takes bags g, g + ng, ..., g + (u - 1) ng of the tile, thread
// p of it the row's 16-byte vector p (none past `vecs`).  Ids come a
// 32-lane window at a time: lane t of the warp loads lane h0 + t % hl of
// the tile's bag t / hl (hl = 32 / nb lanes of every bag a load), the next
// window's load issued before this one's rows.  A window's lanes are taken
// W at a time: UB x W row loads a thread in flight, then the adds in lane
// order.
template <typename T, int UB, int W>
__global__ void __launch_bounds__(NARROW_THREADS, (Narrow<T, UB, W>::BLOCKS))
bag_narrow_kernel(const uint4* __restrict__ table,
                  const int* __restrict__ idx, uint4* __restrict__ out,
                  int V, int hot, int padding_idx, long long B, int vecs,
                  int log2g, int u, long long n_tiles) {
  constexpr int E = Vec<T>::E;
  const int lane = threadIdx.x & 31;
  const int g = lane >> log2g;
  const int p = lane & ((1 << log2g) - 1);
  const int ng = 32 >> log2g;
  const int nb = ng * u;
  const int hl = 32 / nb;
  const bool has_vec = p < vecs;
  const int lj = lane / hl;   // the bag whose ids this lane loads
  const int lh = lane % hl;   // and its lane within a window
  const long long warps = (long long)gridDim.x * (NARROW_THREADS / 32);

  for (long long tile = ((long long)blockIdx.x * NARROW_THREADS +
                         threadIdx.x) / 32;
       tile < n_tiles; tile += warps) {
    const long long b0 = tile * nb;
    const long long bg = b0 + g;   // this group's bag k is bg + k ng
    bool live[UB];
#pragma unroll
    for (int k = 0; k < UB; ++k)
      live[k] = k < u && bg + k * ng < B && has_vec;
    float acc[UB][E], comp[UB][E];
#pragma unroll
    for (int k = 0; k < UB; ++k)
#pragma unroll
      for (int e = 0; e < E; ++e) acc[k][e] = comp[k][e] = 0.f;

    const bool loads = b0 + lj < B;
    const int* lids = idx + (size_t)(b0 + lj) * hot + lh;
    auto id_at = [&](int h0) {
      int v = padding_idx;
      if (loads && h0 + lh < hot) {
        v = __ldg(lids + h0);
        if (v < 0 || v >= V) __trap();
      }
      return v;
    };
    int v = id_at(0);
    for (int h0 = 0; h0 < hot; h0 += hl) {
      const int next = id_at(h0 + hl);
      const int hn = min(hl, hot - h0);
      for (int j0 = 0; j0 < hn; j0 += W) {
        int r[UB][W];
#pragma unroll
        for (int k = 0; k < UB; ++k)
#pragma unroll
          for (int j = 0; j < W; ++j)
            r[k][j] = __shfl_sync(0xffffffffu, v,
                                  ((k * ng + g) * hl + j0 + j) & 31);
        uint4 a[UB][W];
#pragma unroll
        for (int k = 0; k < UB; ++k)
#pragma unroll
          for (int j = 0; j < W; ++j)
            if (live[k] && j0 + j < hn && r[k][j] != padding_idx)
              a[k][j] = __ldg(table + (size_t)r[k][j] * vecs + p);
#pragma unroll
        for (int k = 0; k < UB; ++k) {
#pragma unroll
          for (int j = 0; j < W; ++j) {
            if (live[k] && j0 + j < hn && r[k][j] != padding_idx) {
              float x[E];
              Vec<T>::unpack(a[k][j], x);
#pragma unroll
              for (int e = 0; e < E; ++e)
                kahan_add(acc[k][e], comp[k][e], x[e]);
            }
          }
        }
      }
      v = next;
    }
#pragma unroll
    for (int k = 0; k < UB; ++k)
      if (live[k])
        out[(size_t)(bg + k * ng) * vecs + p] = Vec<T>::pack(acc[k]);
  }
}

template <typename T>
void launch_span(const void* table, const int* idx, void* out,
                 float* partial, int V, int d, int B, int hot,
                 int padding_idx, int n_splits, cudaStream_t s) {
  const int n_ctiles = (d + THREADS - 1) / THREADS;
  const T* t = static_cast<const T*>(table);
  T* o = static_cast<T*>(out);
  bag_span_kernel<T><<<B * n_splits * n_ctiles, THREADS, 0, s>>>(
      t, idx, o, n_splits > 1 ? partial : nullptr, V, d, hot, padding_idx,
      n_splits, n_ctiles);
  if (n_splits > 1)
    bag_combine_kernel<T><<<B * n_ctiles, THREADS, 0, s>>>(partial, o, d,
                                                          n_splits, n_ctiles);
}

template <typename T, int UB, int W>
void launch_narrow(const void* table, const int* idx, void* out, int V,
                   int hot, int padding_idx, int B, int vecs, int log2g,
                   int u, int grid, cudaStream_t s) {
  const int nb = (32 >> log2g) * u;
  const long long n_tiles = ((long long)B + nb - 1) / nb;
  bag_narrow_kernel<T, UB, W><<<grid, NARROW_THREADS, 0, s>>>(
      static_cast<const uint4*>(table), idx, static_cast<uint4*>(out), V, hot,
      padding_idx, B, vecs, log2g, u, n_tiles);
}

// The narrow variant of `w` lanes in flight a bag (a power of two up to
// 2 U: 16 fp32, 8 bf16), with max(1, U / w) bags a group at most.
template <typename T>
int narrow(const void* table, const int* idx, void* out, int V, int d,
           int B, int hot, int padding_idx, int log2g, int u, int w,
           int grid, cudaStream_t s) {
  constexpr int E = Vec<T>::E, U = Vec<T>::U;
  const int vecs = d / E;
  if (d % E || vecs > (1 << log2g) || log2g > 5 || w < 1 || w > 2 * U ||
      (w & (w - 1)) || u < 1 || u > max(1, U / w) ||
      (u << (5 - log2g)) > 32 || grid < 1 ||
      (reinterpret_cast<size_t>(table) | reinterpret_cast<size_t>(out)) % 16)
    return static_cast<int>(cudaErrorInvalidValue);
  auto go = [&](auto kernel) {
    kernel(table, idx, out, V, hot, padding_idx, B, vecs, log2g, u, grid, s);
    return 0;
  };
  switch (w) {
    case 1: return go(launch_narrow<T, U, 1>);
    case 2: return go(launch_narrow<T, U / 2, 2>);
    case 4: return go(launch_narrow<T, U / 4, 4>);
    case 2 * U: return go(launch_narrow<T, 1, 2 * U>);
  }
  if constexpr (U == 8) return go(launch_narrow<T, 1, 8>);   // fp32, w 8
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

// Launches on `stream`; returns cudaGetLastError() after the launches, or
// cudaErrorInvalidValue for a plan the route cannot take.  Requires
// B, d >= 1 (hot may be 0: the bags are then empty and sum to 0).
// route 0, span: `spans` = ceil(hot / 4096) (1 for hot <= 4096) and, with
// more than one, an fp32 scratch `partial` of [B * spans, d];
// B * spans * ceil(d / 128) < 2^31 (log2g, u, grid unused).
// route 1, narrow: groups of 2^log2g threads (one 16-byte vector of the row
// each: d * elem / 16 of them, at most 2^log2g <= 32), w lanes of a bag in
// flight (a power of two up to 16 fp32, 8 bf16), u bags a group (u * w at
// most 8 fp32, 4 bf16, or u = 1; u * 32 / 2^log2g <= 32), `grid` blocks
// of 128 threads; table and out on 16-byte boundaries (partial and spans
// unused).  Allocates nothing.
extern "C" int embedding_bag_launch(const void* table, const int* idx,
                                    void* out, float* partial, int V, int d,
                                    int B, int hot, int padding_idx, int bf16,
                                    int route, int spans, int log2g, int u,
                                    int w, int grid, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  int err = 0;
  if (route == 1) {
    err = bf16 ? narrow<__nv_bfloat16>(table, idx, out, V, d, B, hot,
                                       padding_idx, log2g, u, w, grid, s)
               : narrow<float>(table, idx, out, V, d, B, hot, padding_idx,
                               log2g, u, w, grid, s);
  } else if (route == 0) {
    const int n_splits = hot > SPLIT ? (hot + SPLIT - 1) / SPLIT : 1;
    if (spans != n_splits || (n_splits > 1 && partial == nullptr))
      return static_cast<int>(cudaErrorInvalidValue);
    if (bf16)
      launch_span<__nv_bfloat16>(table, idx, out, partial, V, d, B, hot,
                                 padding_idx, n_splits, s);
    else
      launch_span<float>(table, idx, out, partial, V, d, B, hot, padding_idx,
                         n_splits, s);
  } else {
    err = static_cast<int>(cudaErrorInvalidValue);
  }
  if (err) return err;
  return static_cast<int>(cudaGetLastError());
}
