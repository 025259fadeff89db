// Weighted message-passing SpMM over a dst-major CSR for Hopper (sm_90a):
//
//     out[v, :] = sum_{e in [rowptr[v], rowptr[v+1])} w[e] * x[col[e], :]
//
// rowptr: [n+1] int32; col: [E] int32 source ids in [0, n_x); w: [E] fp32;
// x: [n_x, d] fp32 or bf16; out: [n, d] in x's type, all row-major.  Sums
// run in fp32 and a bf16 result is rounded once (to nearest even) at the
// end.  A row with no edges gives 0.  A source id outside [0, n_x) is
// never clamped: the kernel traps, which the caller sees as a CUDA error at
// its next synchronisation.
//
// Replaces the TPU kernel src/repro/kernels/segment_mm/kernel.py (bsr_spmm,
// pl.pallas_call at line 74), which tiles the adjacency into BSR blocks so
// that every nonzero block is one MXU product.  That tiling is a TPU layout
// choice: here the sparse rows are gathered directly.
//
// What bounds it on an H100: one multiply-add per gathered element, so
// bytes: x (each gathered row once per edge, d elements), the CSR (col, w:
// 8 B per edge), and the output.  The GNN graphs it runs on are power-law:
// at the paper's Arxiv scale one vertex has 120,809 in-edges beside a mean
// of about 6.  What the design does about it:
//   - one warp sums one row for one 128-column tile, four columns per lane,
//     so a gathered row is read as coalesced 128-byte runs; each lane loads
//     32 of the row's (col, w) pairs at once and the warp broadcasts them
//     with shuffles, 8 edges' rows in flight per lane;
//   - a row with more than `span` edges is cut into spans of `span` edges,
//     one warp each, whose fp32 sums go to a scratch [n_spans, d]; a second
//     kernel adds each long row's spans in span order, so the hub is spread
//     over hundreds of warps instead of setting the pace of the pass;
//   - every sum runs in a fixed order (edges in CSR order within a span,
//     spans in order), with no atomics: a result never varies from run to
//     run;
//   - a ragged d is masked, not padded.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int WARPS = 4;                 // warps per block
constexpr int THREADS = 32 * WARPS;
constexpr int COLS = 4;                  // columns per lane
constexpr int TILE = 32 * COLS;          // columns one warp covers
constexpr int UNROLL = 8;                // edges' rows in flight per lane
constexpr unsigned FULL = 0xffffffffu;

__device__ __forceinline__ float load(const float* p) { return __ldg(p); }
__device__ __forceinline__ float load(const __nv_bfloat16* p) {
  return __bfloat162float(*p);
}
__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16_rn(v);
}

// acc[k] += sum over edges [lo, hi) of w[e] * x[col[e], c0 + lane + 32k],
// edge by edge in order.  Called by a whole warp with warp-uniform lo, hi.
template <typename T>
__device__ __forceinline__ void span_sum(const int* __restrict__ col,
                                         const float* __restrict__ w,
                                         const T* __restrict__ x, int n_x,
                                         int d, int c0, int lo, int hi,
                                         float (&acc)[COLS]) {
  const int lane = threadIdx.x % 32;
  bool has[COLS];
  const T* xc[COLS];
#pragma unroll
  for (int k = 0; k < COLS; ++k) {
    const int c = c0 + lane + 32 * k;
    has[k] = c < d;
    xc[k] = x + (has[k] ? c : 0);
  }
  for (int base = lo; base < hi; base += 32) {
    const int e = base + lane;
    int my_c = 0;
    float my_w = 0.f;
    if (e < hi) {
      my_c = __ldg(col + e);
      my_w = __ldg(w + e);
      if (my_c < 0 || my_c >= n_x) __trap();
    }
    const int cnt = min(32, hi - base);
    int j = 0;
    for (; j + UNROLL <= cnt; j += UNROLL) {
      int cs[UNROLL];
      float ws[UNROLL];
      float v[UNROLL][COLS];
#pragma unroll
      for (int u = 0; u < UNROLL; ++u) {
        cs[u] = __shfl_sync(FULL, my_c, j + u);
        ws[u] = __shfl_sync(FULL, my_w, j + u);
      }
#pragma unroll
      for (int u = 0; u < UNROLL; ++u)
#pragma unroll
        for (int k = 0; k < COLS; ++k)
          v[u][k] = has[k] ? load(xc[k] + (size_t)cs[u] * d) : 0.f;
#pragma unroll
      for (int u = 0; u < UNROLL; ++u)
#pragma unroll
        for (int k = 0; k < COLS; ++k) acc[k] = fmaf(ws[u], v[u][k], acc[k]);
    }
    for (; j < cnt; ++j) {
      const int cj = __shfl_sync(FULL, my_c, j);
      const float wj = __shfl_sync(FULL, my_w, j);
#pragma unroll
      for (int k = 0; k < COLS; ++k)
        if (has[k]) acc[k] = fmaf(wj, load(xc[k] + (size_t)cj * d), acc[k]);
    }
  }
}

// One warp per task and 128-column tile (blockIdx.y).  Tasks [0, n) are the
// rows: a row of at most `span` edges is summed and written to out, a longer
// one is left to its spans.  Tasks [n, n + n_spans) are the long rows'
// spans: span s belongs to long row j = owner[s], is span (s - span_ptr[j])
// of row long_rows[j], and its sum goes to partial row s.
template <typename T>
__global__ void __launch_bounds__(THREADS)
spmm_kernel(const int* __restrict__ rowptr, const int* __restrict__ col,
            const float* __restrict__ w, const T* __restrict__ x,
            T* __restrict__ out, float* __restrict__ partial,
            const int* __restrict__ long_rows,
            const int* __restrict__ span_ptr, const int* __restrict__ owner,
            int n, int n_x, int d, int n_spans, int span) {
  const int task = blockIdx.x * WARPS + threadIdx.x / 32;
  if (task >= n + n_spans) return;
  const int lane = threadIdx.x % 32;
  const int c0 = blockIdx.y * TILE;
  float acc[COLS];
#pragma unroll
  for (int k = 0; k < COLS; ++k) acc[k] = 0.f;
  if (task < n) {
    const int lo = rowptr[task], hi = rowptr[task + 1];
    if (hi - lo > span) return;
    span_sum(col, w, x, n_x, d, c0, lo, hi, acc);
#pragma unroll
    for (int k = 0; k < COLS; ++k) {
      const int c = c0 + lane + 32 * k;
      if (c < d) store(out + (size_t)task * d + c, acc[k]);
    }
  } else {
    const int s = task - n;
    const int j = owner[s];
    const int r = long_rows[j];
    const int lo = rowptr[r] + (s - span_ptr[j]) * span;
    const int hi = min(rowptr[r + 1], lo + span);
    span_sum(col, w, x, n_x, d, c0, lo, hi, acc);
#pragma unroll
    for (int k = 0; k < COLS; ++k) {
      const int c = c0 + lane + 32 * k;
      if (c < d) partial[(size_t)s * d + c] = acc[k];
    }
  }
}

// One thread per (long row, column): the row's span sums added in order.
template <typename T>
__global__ void __launch_bounds__(256)
combine_kernel(const float* __restrict__ partial, T* __restrict__ out,
               const int* __restrict__ long_rows,
               const int* __restrict__ span_ptr, int n_long, int d) {
  const long long i = blockIdx.x * 256LL + threadIdx.x;
  if (i >= (long long)n_long * d) return;
  const int j = static_cast<int>(i / d);
  const int c = static_cast<int>(i % d);
  float acc = 0.f;
  for (int s = span_ptr[j]; s < span_ptr[j + 1]; ++s)
    acc += partial[(size_t)s * d + c];
  store(out + (size_t)long_rows[j] * d + c, acc);
}

template <typename T>
void launch(const int* rowptr, const int* col, const float* w,
            const void* x, void* out, float* partial, const int* long_rows,
            const int* span_ptr, const int* owner, int n, int n_x, int d,
            int n_long, int n_spans, int span, cudaStream_t s) {
  const T* xt = static_cast<const T*>(x);
  T* o = static_cast<T*>(out);
  const long long tasks = (long long)n + n_spans;
  const dim3 grid(static_cast<unsigned>((tasks + WARPS - 1) / WARPS),
                  static_cast<unsigned>((d + TILE - 1) / TILE));
  spmm_kernel<T><<<grid, THREADS, 0, s>>>(rowptr, col, w, xt, o, partial,
                                          long_rows, span_ptr, owner, n, n_x,
                                          d, n_spans, span);
  if (n_long > 0) {
    const long long cells = (long long)n_long * d;
    combine_kernel<T><<<static_cast<unsigned>((cells + 255) / 256), 256, 0,
                        s>>>(partial, o, long_rows, span_ptr, n_long, d);
  }
}

}  // namespace

// Launches on `stream`; returns cudaGetLastError() after the launches.
// Requires n, d >= 1, span >= 1, and the span tables the wrapper builds
// (ops.py::coo_to_csr): long_rows [n_long] the rows of more than `span`
// edges, span_ptr [n_long + 1] their first spans, owner [n_spans] each
// span's long row, partial an fp32 scratch [n_spans, d] (null when
// n_spans == 0).  Allocates nothing.
extern "C" int segment_mm_launch(const int* rowptr, const int* col,
                                 const float* w, const void* x, void* out,
                                 float* partial, const int* long_rows,
                                 const int* span_ptr, const int* owner, int n,
                                 int n_x, int d, int n_long, int n_spans,
                                 int span, int bf16, void* stream) {
  if (n_spans > 0 && partial == nullptr)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (bf16)
    launch<__nv_bfloat16>(rowptr, col, w, x, out, partial, long_rows,
                          span_ptr, owner, n, n_x, d, n_long, n_spans, span,
                          s);
  else
    launch<float>(rowptr, col, w, x, out, partial, long_rows, span_ptr,
                  owner, n, n_x, d, n_long, n_spans, span, s);
  return static_cast<int>(cudaGetLastError());
}
