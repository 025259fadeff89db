// Weighted message-passing SpMM over a dst-major CSR for Hopper (sm_90a):
//
//     out[v, :] = sum_{e in [rowptr[v], rowptr[v+1])} w[e] * x[col[e], :]
//
// col: [E] int32 source ids in [0, n_x); row: [E] int32 destination ids,
// sorted; w: [E] fp32; x: [n_x, d] fp32 or bf16; out: [n, d] in x's type,
// all row-major.  Sums run in fp32 and a bf16 result is rounded once (to
// nearest even) at the end.  A row with no edges gives 0.  A source id
// outside [0, n_x) is never clamped: the kernel traps, which the caller sees
// as a CUDA error at its next synchronisation.
//
// Replaces the TPU kernel src/repro/kernels/segment_mm/kernel.py (bsr_spmm,
// pl.pallas_call at line 74), which tiles the adjacency into BSR blocks so
// that every nonzero block is one MXU product.  That tiling is a TPU layout
// choice: here the sparse rows are gathered directly.
//
// What bounds it on an H100: one multiply-add per gathered element, so
// bytes, and of those the gathers: every edge reads its source row (512 B
// at fp32 d = 128), so at the paper's Arxiv scale (1,049,499 edges over
// 169,343 rows) the gathers are ~6x x itself, and x (87 MB at d = 128)
// does not fit the 50 MB L2.  The graphs are power-law: a mean in-degree of about 6 beside
// one vertex with 120,486 in-edges.  What the design does about it:
//   - edge-balanced work: ops.py::partition cuts the edges into items of
//     at most `budget` (128) edges, each a run of whole consecutive rows
//     or one budget-sized chunk of a longer row, longest first, so a lane
//     group never idles on a short row and the hub is spread over ~940
//     groups; two small kernels below decide and write the items (the
//     same work in plain torch ops costs more host time than the SpMM
//     saves);
//   - a lane group walks its item's edges in CSR order, across row
//     boundaries, with UNROLL source rows in flight a lane; a lane loads 16
//     bytes of a row at once (4 fp32 or 8 bf16), so a group of d / 4 lanes
//     reads a 512-byte fp32 row in one instruction, and a warp holds
//     floor(32 / group) groups (three at fp32 d = 40: 30 busy lanes where a
//     128-column tile kept 10);
//   - a d that is not a multiple of 16 bytes, or an x that is not 16-byte
//     aligned, runs the same code with masked scalar loads and stores; a
//     d above 32 lanes x 16 bytes runs in column tiles of that width;
//   - every sum runs in a fixed order, with no atomics, so a result never
//     varies from run to run: edges in CSR order within an item; a chunked
//     row's chunk sums (fp32 scratch) are added in chunk order by a second
//     kernel, whose loads are staged through shared memory by seven warps
//     while the eighth adds, since the hub's chunks make a long dependent
//     chain.
#include <climits>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int WARPS = 4;                 // warps per block
constexpr int THREADS = 32 * WARPS;
constexpr int UNROLL = 8;                // source rows in flight per lane
constexpr int CTHREADS = 256;            // combine: one adder warp, 7 loaders
constexpr int CT = 128;                  // combine: chunk sums per stage

// One element type of x: V elements fill 16 bytes (a uint4), element k in
// 32-bit word k / (4 / sizeof(T)); fp32 conversions.
template <typename T>
struct Elem;
template <>
struct Elem<float> {
  using Bits = unsigned int;
  static constexpr int V = 4;
  __device__ static float to_f(Bits b) { return __uint_as_float(b); }
  __device__ static Bits from_f(float f) { return __float_as_uint(f); }
};
template <>
struct Elem<__nv_bfloat16> {
  using Bits = unsigned short;
  static constexpr int V = 8;
  __device__ static float to_f(Bits b) {
    return __uint_as_float(static_cast<unsigned>(b) << 16);
  }
  __device__ static Bits from_f(float f) {
    return __bfloat16_as_ushort(__float2bfloat16_rn(f));
  }
};

__device__ __forceinline__ unsigned& word(uint4& u, int i) {
  return i == 0 ? u.x : i == 1 ? u.y : i == 2 ? u.z : u.w;
}
__device__ __forceinline__ unsigned word(const uint4& u, int i) {
  return i == 0 ? u.x : i == 1 ? u.y : i == 2 ? u.z : u.w;
}
// the bits of element k of a packed uint4 (k a compile-time index)
template <typename T>
__device__ __forceinline__ typename Elem<T>::Bits bits_of(const uint4& u,
                                                          int k) {
  constexpr int per = 4 / sizeof(typename Elem<T>::Bits);
  return static_cast<typename Elem<T>::Bits>(
      word(u, k / per) >> (32 / per * (k % per)));
}

// The V elements at p: one 16-byte load, or `valid` masked scalar loads
// (zeros past them).
template <typename T>
__device__ __forceinline__ uint4 load_pack(const typename Elem<T>::Bits* p,
                                           bool vec, int valid) {
  using Bits = typename Elem<T>::Bits;
  constexpr int per = 4 / sizeof(Bits);
  if (vec) return __ldg(reinterpret_cast<const uint4*>(p));
  uint4 r = make_uint4(0, 0, 0, 0);
#pragma unroll
  for (int k = 0; k < Elem<T>::V; ++k)
    if (k < valid)
      word(r, k / per) |= static_cast<unsigned>(__ldg(p + k))
                          << (32 / per * (k % per));
  return r;
}

template <typename T>
__device__ __forceinline__ void store_out(typename Elem<T>::Bits* p,
                                          const float (&acc)[Elem<T>::V],
                                          bool vec, int valid) {
  using Bits = typename Elem<T>::Bits;
  constexpr int per = 4 / sizeof(Bits);
  if (vec) {
    uint4 r = make_uint4(0, 0, 0, 0);
#pragma unroll
    for (int k = 0; k < Elem<T>::V; ++k)
      word(r, k / per) |= static_cast<unsigned>(Elem<T>::from_f(acc[k]))
                          << (32 / per * (k % per));
    *reinterpret_cast<uint4*>(p) = r;
  } else {
#pragma unroll
    for (int k = 0; k < Elem<T>::V; ++k)
      if (k < valid) p[k] = Elem<T>::from_f(acc[k]);
  }
}

template <int V>
__device__ __forceinline__ void store_partial(float* p, const float (&acc)[V],
                                              bool vec, int valid) {
  if (vec) {
#pragma unroll
    for (int k = 0; k < V; k += 4)
      *reinterpret_cast<float4*>(p + k) =
          make_float4(acc[k], acc[k + 1], acc[k + 2], acc[k + 3]);
  } else {
#pragma unroll
    for (int k = 0; k < V; ++k)
      if (k < valid) p[k] = acc[k];
  }
}

// One lane group of `nv` lanes per work item, over the columns [c0, c0 +
// 32 V) of this launch.  items[i] = (first row, end, first edge, end edge):
// a run of whole rows [first row, end) when end >= 0, whose sums go to
// out; or, when end < 0, one chunk of row `first row`, whose sum goes to
// partial row ~end.
template <typename T>
__global__ void __launch_bounds__(THREADS)
spmm_kernel(const int4* __restrict__ items, int n_items,
            const int* __restrict__ col, const float* __restrict__ w,
            const int* __restrict__ row, const T* __restrict__ x,
            T* __restrict__ out, float* __restrict__ partial, int n_x, int d,
            int c0, int nv, bool vec) {
  using E = Elem<T>;
  using Bits = typename E::Bits;
  constexpr int V = E::V;
  const int lane = threadIdx.x % 32;
  const int groups = 32 / nv;
  const int g = lane / nv;
  if (g >= groups) return;
  const int item = (blockIdx.x * WARPS + threadIdx.x / 32) * groups + g;
  if (item >= n_items) return;
  const int cc = c0 + (lane - g * nv) * V;   // this lane's first column
  const int valid = min(V, d - cc);
  const Bits* xc = reinterpret_cast<const Bits*>(x) + cc;
  Bits* oc = reinterpret_cast<Bits*>(out) + cc;
  const int4 it = items[item];
  int cur = it.x;                            // the row being summed
  float acc[V];
#pragma unroll
  for (int k = 0; k < V; ++k) acc[k] = 0.f;
  for (int e = it.z; e < it.w; e += UNROLL) {
    float wt[UNROLL];
    int rr[UNROLL];
    uint4 v[UNROLL];
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      wt[u] = 0.f;
      rr[u] = INT_MAX;
      v[u] = make_uint4(0, 0, 0, 0);
      if (e + u < it.w) {
        const int c = __ldg(col + e + u);
        if (c < 0 || c >= n_x) __trap();
        wt[u] = __ldg(w + e + u);
        rr[u] = __ldg(row + e + u);
        v[u] = load_pack<T>(xc + static_cast<size_t>(c) * d, vec, valid);
      }
    }
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      if (e + u < it.w) {
        for (; cur < rr[u]; ++cur) {         // the rows before this edge's
          store_out<T>(oc + static_cast<size_t>(cur) * d, acc, vec, valid);
#pragma unroll
          for (int k = 0; k < V; ++k) acc[k] = 0.f;
        }
#pragma unroll
        for (int k = 0; k < V; ++k)
          acc[k] = fmaf(wt[u], E::to_f(bits_of<T>(v[u], k)), acc[k]);
      }
    }
  }
  if (it.y < 0) {
    store_partial<V>(partial + static_cast<size_t>(~it.y) * d + cc, acc, vec,
                     valid);
  } else {
    for (; cur < it.y; ++cur) {              // the item's last rows
      store_out<T>(oc + static_cast<size_t>(cur) * d, acc, vec, valid);
#pragma unroll
      for (int k = 0; k < V; ++k) acc[k] = 0.f;
    }
  }
}

__device__ __forceinline__ void store_elem(float* p, float v) { *p = v; }
__device__ __forceinline__ void store_elem(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16_rn(v);
}

// One block per (chunked row j, 32 columns): the row's chunk sums
// [chunk_ptr[j], chunk_ptr[j+1]) added in chunk order.  Warp 0 adds from
// shared memory while warps 1-7 stage the next CT chunk sums.
template <typename T>
__global__ void __launch_bounds__(CTHREADS)
combine_kernel(const float* __restrict__ partial, T* __restrict__ out,
               const int* __restrict__ long_rows,
               const int* __restrict__ chunk_ptr, int d) {
  __shared__ float tile[2][CT][32];
  const int j = blockIdx.x;
  const int c0 = blockIdx.y * 32;
  const int s0 = chunk_ptr[j];
  const int n_s = chunk_ptr[j + 1] - s0;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  // chunk sums [t CT, t CT + CT) into buffer t % 2, by threads first.. end
  auto stage = [&](int t, int first) {
    for (int i = threadIdx.x - first; i < CT * 32; i += CTHREADS - first) {
      const int s = t * CT + i / 32, c = c0 + i % 32;
      tile[t & 1][i / 32][i % 32] =
          (s < n_s && c < d) ? partial[static_cast<size_t>(s0 + s) * d + c]
                             : 0.f;
    }
  };
  const int n_t = (n_s + CT - 1) / CT;
  stage(0, 0);
  __syncthreads();
  float acc = 0.f;
  for (int t = 0; t < n_t; ++t) {
    if (warp == 0) {
      const int m = min(CT, n_s - t * CT);
#pragma unroll 8
      for (int i = 0; i < m; ++i) acc += tile[t & 1][i][lane];
    } else if (t + 1 < n_t) {
      stage(t + 1, 32);
    }
    __syncthreads();
  }
  if (warp == 0 && c0 + lane < d)
    store_elem(out + static_cast<size_t>(long_rows[j]) * d + c0 + lane, acc);
}

template <typename T>
void launch(const int4* items, int n_items, const int* col, const float* w,
            const int* row, const void* x, void* out, float* partial,
            const int* long_rows, const int* chunk_ptr, int n_long, int n_x,
            int d, bool vec, cudaStream_t s) {
  constexpr int V = Elem<T>::V;
  const T* xt = static_cast<const T*>(x);
  T* o = static_cast<T*>(out);
  for (int c0 = 0; c0 < d; c0 += 32 * V) {
    const int nv = (min(32 * V, d - c0) + V - 1) / V;
    const int per_block = WARPS * (32 / nv);
    if (n_items > 0)
      spmm_kernel<T><<<(n_items + per_block - 1) / per_block, THREADS, 0,
                       s>>>(items, n_items, col, w, row, xt, o, partial, n_x,
                            d, c0, nv, vec);
  }
  if (n_long > 0)
    combine_kernel<T><<<dim3(n_long, (d + 31) / 32), CTHREADS, 0, s>>>(
        partial, o, long_rows, chunk_ptr, d);
}

// The work items of ops.py::partition, in two kernels around two scans.
// First, per row r of the CSR: whether an item starts at r (is_new), the
// items it opens (low 32 bits of opened: its chunks for a long row, else
// one, where an item starts) and its chunks (high 32 bits), and whether it
// is long (more than B edges).  An item starts at every B-th row, at a row
// whose first edge opens another window of B edges than its predecessor's,
// and at and after a row whose last edge lies past its first edge's window.
__global__ void partition_flags_kernel(const int* __restrict__ rowptr, int n,
                                       int B, unsigned char* __restrict__
                                       is_new, long long* __restrict__ opened,
                                       int* __restrict__ is_long) {
  const int r = blockIdx.x * blockDim.x + threadIdx.x;
  if (r >= n) return;
  const int s = rowptr[r], t = rowptr[r + 1];
  // (t - 1) / B truncates where t = 0, and is then 0 = s / B: no row past
  const bool alone = (t - 1) / B > s / B;
  bool starts = r % B == 0 || alone;
  if (r > 0) {
    const int sp = rowptr[r - 1];
    starts = starts || s / B != sp / B || (s - 1) / B > sp / B;
  }
  const bool lng = t - s > B;
  const long long chunks = lng ? (static_cast<long long>(t - s) + B - 1) / B
                               : 0;
  is_new[r] = starts;
  opened[r] = (starts ? (lng ? chunks : 1) : 0) | (chunks << 32);
  is_long[r] = lng;
}

// Then, per row r that starts an item, its items at the scanned offsets:
// a long row's chunks (and its entries of long_rows and chunk_ptr), or
// the run of rows up to the next row that starts an item; key is an
// item's negative length, for the sort longest first.
__global__ void partition_emit_kernel(
    const int* __restrict__ rowptr, int n, int B,
    const unsigned char* __restrict__ is_new,
    const long long* __restrict__ opened_incl,
    const long long* __restrict__ long_incl, int4* __restrict__ items,
    int* __restrict__ key, int* __restrict__ long_rows,
    int* __restrict__ chunk_ptr) {
  const int r = blockIdx.x * blockDim.x + threadIdx.x;
  if (r >= n || !is_new[r]) return;
  const int s = rowptr[r], t = rowptr[r + 1];
  const long long incl = opened_incl[r];
  if (t - s > B) {
    const int own = static_cast<int>((static_cast<long long>(t - s) + B - 1)
                                     / B);
    const int o = static_cast<int>(incl & 0xFFFFFFFFLL) - own;
    const int slot = static_cast<int>(incl >> 32) - own;
    const int j = static_cast<int>(long_incl[r]) - 1;
    long_rows[j] = r;
    chunk_ptr[j] = slot;
    for (int k = 0; k < own; ++k) {
      const int e0 = s + k * B, e1 = min(e0 + B, t);
      items[o + k] = make_int4(r, ~(slot + k), e0, e1);
      key[o + k] = e0 - e1;
    }
  } else {
    const int o = static_cast<int>(incl & 0xFFFFFFFFLL) - 1;
    int end = r + 1;                       // at most B rows on
    while (end < n && !is_new[end]) ++end;
    const int e1 = rowptr[end];
    items[o] = make_int4(r, end, s, e1);
    key[o] = s - e1;
  }
}

constexpr int PTHREADS = 256;              // partition: threads per block

}  // namespace

// The two kernels of ops.py::partition, on `stream`; each returns
// cudaGetLastError() after its launch.  rowptr [n + 1] int32; is_new [n]
// uint8, opened [n] int64 and is_long [n] int32 are written by the first
// and read by the second after the caller's inclusive scans of opened and
// is_long (long_incl).  items [I, 4] and key [I] int32, long_rows [n_long]
// and chunk_ptr [n_long + 1] are sized from the scans' totals, and
// chunk_ptr[n_long] is the caller's.  Allocates nothing.
extern "C" int segment_mm_partition_flags(const int* rowptr, int n, int B,
                                          unsigned char* is_new,
                                          long long* opened, int* is_long,
                                          void* stream) {
  if (n > 0)
    partition_flags_kernel<<<(n + PTHREADS - 1) / PTHREADS, PTHREADS, 0,
                             static_cast<cudaStream_t>(stream)>>>(
        rowptr, n, B, is_new, opened, is_long);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int segment_mm_partition_emit(const int* rowptr, int n, int B,
                                         const unsigned char* is_new,
                                         const long long* opened_incl,
                                         const long long* long_incl,
                                         int* items, int* key,
                                         int* long_rows, int* chunk_ptr,
                                         void* stream) {
  if (n > 0)
    partition_emit_kernel<<<(n + PTHREADS - 1) / PTHREADS, PTHREADS, 0,
                            static_cast<cudaStream_t>(stream)>>>(
        rowptr, n, B, is_new, opened_incl, long_incl,
        reinterpret_cast<int4*>(items), key, long_rows, chunk_ptr);
  return static_cast<int>(cudaGetLastError());
}

// Launches on `stream`; returns cudaGetLastError() after the launches.
// Requires n_x, d >= 1 and the tables the wrapper builds
// (ops.py::partition): items [n_items, 4] int32 (16-byte aligned), which
// cover every output row once; long_rows [n_long] the chunked rows and
// chunk_ptr [n_long + 1] their first chunks; partial an fp32 scratch
// [n_chunks, d] (null when there are no chunks).  vec: x is 16-byte
// aligned and a row is a multiple of 16 bytes.  Allocates nothing.
extern "C" int segment_mm_launch(const int* items, int n_items,
                                 const int* col, const float* w,
                                 const int* row, const void* x, void* out,
                                 float* partial, const int* long_rows,
                                 const int* chunk_ptr, int n_long,
                                 int n_chunks, int n_x, int d, int vec,
                                 int bf16, void* stream) {
  if (n_chunks > 0 && partial == nullptr)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int4* it = reinterpret_cast<const int4*>(items);
  if (bf16)
    launch<__nv_bfloat16>(it, n_items, col, w, row, x, out, partial,
                          long_rows, chunk_ptr, n_long, n_x, d, vec != 0, s);
  else
    launch<float>(it, n_items, col, w, row, x, out, partial, long_rows,
                  chunk_ptr, n_long, n_x, d, vec != 0, s);
  return static_cast<int>(cudaGetLastError());
}
