"""The port's message-passing SpMM (``kernels/segment_mm``) on the CPU:
its plain version, reached through the wrapper, against the JAX package's
Pallas ``segment_mm`` (interpret mode, as tests/test_kernels.py runs it)
and its ``segment_mm_ref``, at that file's shapes, dtypes and bars (2e-5 in
fp32, 2e-2 in bf16); the dst-major CSR that the kernel reads; and the full
pass, whose invertible branch now goes through it with its results
unchanged.  The CUDA kernel is held against the same plain version on the
card (tests/test_torch_kernels_cuda.py and ``chip_smoke.py``)."""
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
from repro_torch.kernels.segment_mm.ops import SPAN_EDGES

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
    assert csr.n_src == 4 and csr.n_spans == 0
    x = torch.arange(8, dtype=torch.float32).reshape(4, 2)
    out = segment_mm(src, dst, w, x, 6)
    expect = torch.zeros(6, 2)
    expect[0] = 5 * x[3]
    expect[2] = (1 + 3) * x[3] + 4 * x[1]
    expect[4] = (2 + 6) * x[0]
    torch.testing.assert_close(out, expect, atol=0, rtol=0)


def test_coo_to_csr_spans_long_rows():
    """A row of more than SPAN_EDGES in-edges is cut into spans of that
    many edges (the hub's load balance on the card)."""
    long_deg = 2 * SPAN_EDGES + 7
    dst = np.concatenate([np.full(long_deg, 1), [0, 2, 2],
                          np.full(SPAN_EDGES, 3)])
    src = np.arange(dst.size) % 50
    csr = coo_to_csr(src, dst, np.ones(dst.size, np.float32), 5, "cpu")
    assert csr.long_rows.tolist() == [1]
    assert csr.span_ptr.tolist() == [0, 3]
    assert csr.owner.tolist() == [0, 0, 0]
    x = torch.randn(50, 3, generator=torch.Generator().manual_seed(0))
    out = segment_mm(src, dst, np.ones(dst.size, np.float32), x, 5)
    torch.testing.assert_close(out[1], x[src[:long_deg]].sum(0))
    torch.testing.assert_close(out[4], torch.zeros(3))


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
