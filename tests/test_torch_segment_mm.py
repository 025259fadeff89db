"""The port's message-passing SpMM (``kernels/segment_mm``) on the CPU:
its plain version, reached through the wrapper, against the JAX package's
Pallas ``segment_mm`` (interpret mode, as tests/test_kernels.py runs it)
and its ``segment_mm_ref``, at that file's shapes, dtypes and bars (2e-5 in
fp32, 2e-2 in bf16); the dst-major CSR that the kernel reads; and the full
pass, whose invertible branch now goes through it with its results
unchanged; and the kernel's work items (``partition``), whose walk in the
kernel's order is held to both references.  The CUDA kernel is held
against the same plain version on the card
(tests/test_torch_kernels_cuda.py and ``chip_smoke.py``)."""
import numpy as np
import pytest

import jax.numpy as jnp
import torch

from repro.core.graph import erdos_renyi
from repro.kernels.segment_mm import segment_mm as jax_segment_mm
from repro.kernels.segment_mm.ref import segment_mm_ref as jax_segment_mm_ref

from repro_torch.core.full import full_inference
from repro_torch.core.graph import powerlaw_graph
from repro_torch.core.workloads import INVERTIBLE_WORKLOAD_NAMES, make_workload
from repro_torch.kernels.segment_mm import coo_to_csr, segment_mm
from repro_torch.kernels.segment_mm.ops import EDGE_BUDGET, partition
from repro_torch.kernels.segment_mm.ref import segment_mm_ref

TOL = {torch.float32: dict(atol=2e-5, rtol=2e-5),
       torch.bfloat16: dict(atol=2e-2, rtol=2e-2)}
JNP = {torch.float32: jnp.float32, torch.bfloat16: jnp.bfloat16}


@pytest.mark.parametrize("n,m,d,blk", [(100, 400, 32, 32), (257, 1500, 64, 64),
                                       (64, 300, 128, 64), (300, 2000, 16, 128)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_segment_mm_matches_reference(n, m, d, blk, dtype):
    src, dst, w = erdos_renyi(n, m, seed=1, weighted=True)
    x_np = np.random.default_rng(0).normal(size=(n, d)).astype(np.float32)
    x = torch.as_tensor(x_np).to(dtype)
    before = segment_mm.launches
    out = segment_mm(src, dst, w, x, n)
    assert segment_mm.launches == before   # the CPU runs the plain version
    assert out.dtype == dtype and out.shape == (n, d)
    xj = jnp.asarray(x_np, JNP[dtype])
    pallas = jax_segment_mm(src, dst, w, xj, n, blk=blk)
    # the oracle takes the same input values and sums in fp32, as the
    # port's contract does: in bf16 the reference's jnp oracle accumulates
    # in bf16, and on this input it strays from its own Pallas kernel by
    # more than the bar (0.0051 over it at n = 257)
    ref = jax_segment_mm_ref(jnp.asarray(src), jnp.asarray(dst),
                             jnp.asarray(w), xj.astype(jnp.float32), n)
    got = out.float().numpy()
    for other in (pallas, ref):
        np.testing.assert_allclose(got, np.asarray(other, np.float32),
                                   **TOL[dtype])


def test_coo_to_csr_empty_rows_and_duplicates():
    """Rows without edges get empty ranges and sum to 0; a duplicated edge
    stays two entries, kept in edge order, and both count."""
    src = np.array([3, 0, 3, 1, 3, 0], dtype=np.int64)
    dst = np.array([2, 4, 2, 2, 0, 4], dtype=np.int64)
    w = np.array([1.0, 2.0, 3.0, 4.0, 5.0, 6.0], dtype=np.float32)
    csr = coo_to_csr(src, dst, w, 6, "cpu")
    assert csr.rowptr.tolist() == [0, 1, 1, 4, 4, 6, 6]
    assert csr.col.tolist() == [3, 3, 3, 1, 0, 0]
    assert csr.row.tolist() == [0, 2, 2, 2, 4, 4]
    assert csr.w.tolist() == [5.0, 1.0, 3.0, 4.0, 2.0, 6.0]
    assert csr.col.dtype == csr.rowptr.dtype == torch.int32
    assert csr.n_src == 4 and csr.n_chunks == 0
    assert csr.items is None   # the plain version reads no work items
    x = torch.arange(8, dtype=torch.float32).reshape(4, 2)
    out = segment_mm(src, dst, w, x, 6)
    expect = torch.zeros(6, 2)
    expect[0] = 5 * x[3]
    expect[2] = (1 + 3) * x[3] + 4 * x[1]
    expect[4] = (2 + 6) * x[0]
    torch.testing.assert_close(out, expect, atol=0, rtol=0)


def _degrees(case):
    """In-degree patterns the partition must cut: (counts, budget)."""
    rng = np.random.default_rng(7)
    b = 8
    return {
        "empty_rows": (np.zeros(21, np.int64), 4),
        "no_rows": (np.zeros(0, np.int64), 4),
        "budget_exactly": (np.array([b, 0, 1, b, b - 1, 2]), b),
        "budget_plus_one": (np.array([1, b + 1, 0, b + 1, b + 1]), b),
        "hub": (np.concatenate([rng.integers(0, 5, 300), [5000],
                                rng.integers(0, 5, 300)]), 64),
        "budget_one": (np.array([0, 1, 2, 0, 3, 1]), 1),
        "power_law": (np.minimum(rng.zipf(1.8, 2000), 3000), EDGE_BUDGET),
        "runs_capped_by_rows": (np.array([0] * 40 + [1] * 30 + [0] * 9), 8),
    }[case]


@pytest.mark.parametrize("case", ["empty_rows", "no_rows", "budget_exactly",
                                  "budget_plus_one", "hub", "budget_one",
                                  "power_law", "runs_capped_by_rows"])
def test_partition_covers_each_edge_once_in_csr_order(case):
    """The kernel's work items, longest first: every edge in exactly one
    item; every row in exactly one run or chunked; a run's edges in one
    budget-wide window; a chunked row's chunks consecutive, in edge order,
    budget-sized but the last; no item over the budget in edges or
    rows."""
    counts, budget = _degrees(case)
    n = counts.shape[0]
    rowptr = np.concatenate([[0], np.cumsum(counts)])
    items, long_rows, chunk_ptr, n_chunks = partition(rowptr, budget)
    assert items.dtype == long_rows.dtype == chunk_ptr.dtype == torch.int32
    items, long_rows, chunk_ptr = (t.numpy() for t in (items, long_rows,
                                                       chunk_ptr))
    assert items.shape[1] == 4
    sizes = items[:, 3] - items[:, 2]
    assert (np.diff(sizes) <= 0).all()          # longest first
    items = items[np.lexsort((items[:, 2], items[:, 0]))]   # CSR order
    first, end, e0, e1 = (items[:, j].astype(np.int64) for j in range(4))
    # the items' edge ranges tile [0, E) in order
    assert (e0 <= e1).all() and (e1 - e0 <= budget).all()
    assert e0.tolist() == [0] + e1[:-1].tolist() if len(items) else True
    assert (e1[-1] if len(items) else 0) == rowptr[-1]
    chunk = end < 0
    assert long_rows.tolist() == np.flatnonzero(counts > budget).tolist()
    # runs: whole rows, consecutive, within the budget of rows
    runs = ~chunk
    assert (end[runs] > first[runs]).all()
    assert (end[runs] - first[runs] <= budget).all()
    assert (e0[runs] == rowptr[first[runs]]).all()
    assert (e1[runs] == rowptr[end[runs]]).all()
    # a run's edges lie in one budget-wide window, but for a lone row's
    crossing = runs & (e1 > e0) & (e0 // budget != (e1 - 1) // budget)
    assert ((end - first)[crossing] == 1).all()
    covered = np.zeros(n, np.int64)
    for f, t in zip(first[runs], end[runs]):
        covered[f:t] += 1
    covered[long_rows] += 1
    assert (covered == 1).all()
    # chunks: slot order is edge order, a row's chunks are consecutive
    slots = ~end[chunk]
    assert slots.tolist() == list(range(int(chunk.sum())))
    assert chunk_ptr[0] == 0 and chunk_ptr[-1] == chunk.sum() == n_chunks
    for j, r in enumerate(long_rows):
        mine = np.flatnonzero(chunk & (first == r))
        assert (~end[mine]).tolist() == list(range(chunk_ptr[j],
                                                   chunk_ptr[j + 1]))
        assert np.all(np.diff(mine) == 1)
        sizes = (e1 - e0)[mine]
        assert (sizes[:-1] == budget).all() and 1 <= sizes[-1] <= budget
        assert e0[mine[0]] == rowptr[r] and e1[mine[-1]] == rowptr[r + 1]
    assert (counts[first[chunk]] > budget).all()


def _walk(csr, parts, x: np.ndarray) -> np.ndarray:
    """The kernel's order of summation over the work items ``parts``
    (:func:`partition`'s) of the CSR, in fp32: a run's rows edge by edge, a
    chunk's sum to its scratch row, then each chunked row's scratch rows
    added in chunk order."""
    items, long_rows, chunk_ptr, n_chunks = parts
    col, row, w = (t.numpy() for t in (csr.col, csr.row, csr.w))
    out = np.zeros((csr.n, x.shape[1]), np.float32)
    partial = np.zeros((n_chunks, x.shape[1]), np.float32)
    for first, end, e0, e1 in items.tolist():
        acc, cur = np.zeros(x.shape[1], np.float32), first
        for e in range(e0, e1):
            for cur in range(cur, row[e]):
                out[cur], acc = acc, np.zeros_like(acc)
            cur = row[e]
            acc = acc + w[e] * x[col[e]]
        if end < 0:
            partial[~end] = acc
        else:
            for cur in range(cur, end):
                out[cur], acc = acc, np.zeros_like(acc)
    for j, r in enumerate(long_rows.tolist()):
        acc = np.zeros(x.shape[1], np.float32)
        for slot in range(int(chunk_ptr[j]), int(chunk_ptr[j + 1])):
            acc = acc + partial[slot]
        out[r] = acc
    return out


@pytest.mark.parametrize("n,m,hub,d,budget", [(60, 300, 0, 8, 4),
                                              (800, 2000, 700, 16, 64),
                                              (150, 600, 129, 40,
                                               EDGE_BUDGET),
                                              (800, 2000, 700, 16,
                                               EDGE_BUDGET),
                                              (90, 0, 0, 4, 16)])
def test_partition_walk_matches_references(n, m, hub, d, budget):
    """A plain walk of the work items in the kernel's order (edges in CSR
    order within an item, chunk sums in chunk order) against the plain
    version and the JAX package's Pallas segment_mm (interpret mode), at
    2e-3.  The edges are distinct (src, dst) pairs: the reference's
    ``coo_to_bsr`` keeps one of a repeated pair's weights (numpy's ``+=``
    through repeated indices), where the port and ``segment_mm_ref`` add
    both (test_coo_to_csr_empty_rows_and_duplicates)."""
    rng = np.random.default_rng(n + m + hub)
    src = np.concatenate([rng.integers(0, n, m),
                          rng.choice(n, hub, replace=False)])
    dst = np.concatenate([rng.integers(0, n, m), np.full(hub, 3)])
    keep = np.sort(np.unique(src * n + dst, return_index=True)[1])
    src, dst = src[keep], dst[keep]
    w = rng.uniform(0.5, 1.5, src.shape[0]).astype(np.float32)
    x = rng.normal(size=(n, d)).astype(np.float32)
    csr = coo_to_csr(src, dst, w, n, "cpu")
    parts = partition(csr.rowptr, budget)
    assert parts[3] > 0 or (m == 0 and hub == 0)
    got = _walk(csr, parts, x)
    plain = segment_mm_ref(csr.col, csr.row, csr.w, torch.as_tensor(x), n)
    pallas = jax_segment_mm(src, dst, w, jnp.asarray(x), n, blk=32)
    for other in (plain.numpy(), np.asarray(pallas, np.float32)):
        np.testing.assert_allclose(got, other, atol=2e-3, rtol=2e-3)


def test_coo_to_csr_rejects_bad_ids():
    ok = np.array([0, 1])
    with pytest.raises(ValueError, match="dst"):
        coo_to_csr(ok, np.array([0, 3]), np.ones(2), 3, "cpu")
    with pytest.raises(ValueError, match="dst"):
        coo_to_csr(ok, np.array([-1, 0]), np.ones(2), 3, "cpu")
    with pytest.raises(ValueError, match="src"):
        coo_to_csr(np.array([0, -2]), ok, np.ones(2), 3, "cpu")
    with pytest.raises(ValueError, match="one length"):
        coo_to_csr(ok, ok, np.ones(3), 3, "cpu")
    empty = coo_to_csr(np.empty(0, np.int64), np.empty(0, np.int64),
                       np.empty(0, np.float32), 4, "cpu")
    assert empty.rowptr.tolist() == [0] * 5 and empty.n_src == 0
    out = segment_mm(np.empty(0, np.int64), np.empty(0, np.int64),
                     np.empty(0, np.float32), torch.ones(2, 3), 4)
    assert torch.equal(out, torch.zeros(4, 3))


@pytest.mark.parametrize("name", INVERTIBLE_WORKLOAD_NAMES)
def test_full_pass_unchanged_on_cpu(name):
    """The invertible full pass through segment_mm equals, bit for bit, the
    segment-sum it replaced (index_add_ over the edges in COO order)."""
    wl = make_workload(name, n_layers=2, d_in=8, d_hidden=12, n_classes=5)
    params = wl.init_params(torch.Generator().manual_seed(0), device="cpu")
    n = 300
    src, dst, w = powerlaw_graph(n, 2400, seed=0, weighted=wl.spec.weighted)
    x = torch.as_tensor(np.random.default_rng(1).normal(size=(n, 8))
                        .astype(np.float32))
    deg = np.bincount(dst, minlength=n).astype(np.float32)
    H, S = full_inference(wl, params, x, src, dst, w, deg)
    s_t, d_t = torch.as_tensor(src), torch.as_tensor(dst)
    w_t = torch.as_tensor(w) if wl.spec.weighted else torch.ones(len(src))
    h = x
    for l in range(2):
        s_l = torch.zeros(n, h.shape[1]).index_add_(0, d_t, h[s_t]
                                                    * w_t[:, None])
        assert torch.equal(S[l + 1], s_l)
        h = params[l](h, wl.normalize(s_l, torch.as_tensor(deg)))
        assert torch.equal(H[l + 1], h)
