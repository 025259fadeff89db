// Sum-mode EmbeddingBag for Hopper (sm_90a):
//
//     out[b, :] = sum_h table[idx[b, h], :]      (lanes == padding_idx skipped)
//
// idx: [B, hot] int32; table: [V, d] fp32 or bf16; out: [B, d] in the
// table's type, all row-major.  Sums run in fp32 (compensated) and a bf16
// result is rounded once (to nearest even) at the end.  padding_idx < 0
// means none.  An index outside [0, V) is never clamped: the kernel traps,
// which the caller sees as a CUDA error at its next synchronisation.
//
// Replaces the TPU kernel src/repro/kernels/embedding_bag/kernel.py
// (embedding_bag_pallas, pl.pallas_call at line 47), whose sequential
// (bag, hot, d_tile) grid DMAs one table row per step into an accumulating
// output block, driven by scalar-prefetched indices.
//
// What bounds it on an H100: one add per gathered element, so bytes: the
// index rectangle (4 B per lane), the rows it gathers (d elements per kept
// lane) and the output.  In the engine's PNA gather the rectangle is as
// wide as the largest in-degree among the bag rows, so one hub makes every
// bag that wide and most lanes are padding, while the hub's own bag holds
// a hundred thousand rows.  What the design does about it:
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

template <typename T>
void launch(const void* table, const int* idx, void* out, float* partial,
            int V, int d, int B, int hot, int padding_idx, int n_splits,
            cudaStream_t s) {
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

}  // namespace

// Lanes of a bag one block sums: a bag of `hot` lanes is cut into
// ceil(hot / this) spans, and with more than one span the launch needs an
// fp32 scratch of [B * spans, d].
extern "C" int embedding_bag_lanes_per_block() { return SPLIT; }

// Launches on `stream`; returns cudaGetLastError() after the launches.
// Requires B, d >= 1 (hot may be 0: the bags are then empty and sum to 0)
// and B * spans * ceil(d / 128) < 2^31.  Allocates nothing.
extern "C" int embedding_bag_launch(const void* table, const int* idx,
                                    void* out, float* partial, int V, int d,
                                    int B, int hot, int padding_idx, int bf16,
                                    void* stream) {
  const int n_splits = hot > SPLIT ? (hot + SPLIT - 1) / SPLIT : 1;
  if (n_splits > 1 && partial == nullptr)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (bf16)
    launch<__nv_bfloat16>(table, idx, out, partial, V, d, B, hot, padding_idx,
                          n_splits, s);
  else
    launch<float>(table, idx, out, partial, V, d, B, hot, padding_idx,
                  n_splits, s);
  return static_cast<int>(cudaGetLastError());
}
