"""The port's GNN models (``repro_torch.models.gnn``: SchNet, PNA, NequIP,
DimeNet, the neighbour sampler) against the reference's on the CPU, at
the configs' SMOKE widths: each forward on the same NumPy inputs
(``erdos_renyi`` graphs plus padded edges, positions for the molecular
archs) with the reference's parameters carried by ``params_from_numpy``,
at atol 1e-5 / rtol 1e-4.  Also the reference's own properties on the
port (rotation invariance, NequIP's per-path equivariance, PNA's
aggregators against direct computation, the Bessel roots), PNA's
gradient at tied maxima against JAX's, ``build_triplets`` and the
sampler's block equal to the reference's, and the port's init trees."""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro.configs.registry import get_arch as jax_get_arch
from repro.core.graph import erdos_renyi
from repro.models.gnn import common as jc
from repro.models.gnn import dimenet as jdim
from repro.models.gnn import nequip as jnq
from repro.models.gnn import sampler as jsamp
from repro_torch.ckpt.checkpoint import tree_flatten, tree_unflatten
from repro_torch.configs.registry import get_arch
from repro_torch.models.gnn import common as tc
from repro_torch.models.gnn import dimenet as tdim
from repro_torch.models.gnn import nequip as tnq
from repro_torch.models.gnn import sampler as tsamp
from repro_torch.models.gnn.convert import params_from_numpy

ARCHS = ["schnet", "pna", "nequip", "dimenet"]
MOLECULAR = {"schnet": True, "pna": False, "nequip": True, "dimenet": True}
TOL = dict(atol=1e-5, rtol=1e-4)


def _graph(seed=0, n=26, m=80, d=8, n_pad=6, dup=0):
    """NumPy inputs: an ``erdos_renyi`` graph, ``dup`` of its edges
    repeated (tied messages), ``n_pad`` padded edges (n-1 -> n-1, mask
    0), features and positions (N(0, 4) a coordinate)."""
    rng = np.random.default_rng(seed)
    src, dst, _ = erdos_renyi(n, m, seed=seed)
    if dup:
        src, dst = np.concatenate([src, src[:dup]]), np.concatenate(
            [dst, dst[:dup]])
    mask = np.concatenate([np.ones(src.shape[0], np.float32),
                           np.zeros(n_pad, np.float32)])
    src = np.concatenate([src, np.full(n_pad, n - 1)]).astype(np.int32)
    dst = np.concatenate([dst, np.full(n_pad, n - 1)]).astype(np.int32)
    return dict(x=rng.normal(size=(n, d)).astype(np.float32), src=src,
                dst=dst, mask=mask,
                pos=(rng.normal(size=(n, 3)) * 2).astype(np.float32), n=n)


def _batches(gr, molecular=True, graph_id=None):
    """The same graph as the reference's and the port's ``GraphBatch``."""
    j = jc.GraphBatch(node_feat=jnp.asarray(gr["x"]),
                      src=jnp.asarray(gr["src"]), dst=jnp.asarray(gr["dst"]),
                      edge_mask=jnp.asarray(gr["mask"]),
                      positions=jnp.asarray(gr["pos"]) if molecular else None,
                      graph_id=None if graph_id is None
                      else jnp.asarray(graph_id))
    t = tc.GraphBatch(node_feat=torch.as_tensor(gr["x"]),
                      src=torch.as_tensor(gr["src"]),
                      dst=torch.as_tensor(gr["dst"]),
                      edge_mask=torch.as_tensor(gr["mask"]),
                      positions=torch.as_tensor(gr["pos"]) if molecular
                      else None,
                      graph_id=None if graph_id is None
                      else torch.as_tensor(graph_id))
    return j, t


def _carried(arch, d_in=8, d_out=5, seed=0):
    pj = jax_get_arch(arch).SMOKE_INIT(jax.random.PRNGKey(seed), d_in=d_in,
                                       d_out=d_out)
    return pj, params_from_numpy(jax.tree.map(np.asarray, pj), "cpu")


def _triplets(gr):
    """Both packages' triplets of the graph (padded edges included)."""
    return (jdim.build_triplets(gr["src"], gr["dst"], gr["n"]),
            tdim.build_triplets(gr["src"], gr["dst"], gr["n"], device="cpu"))


def _forward(arch, pj, pt, gj, gt, trips=None):
    fj = jax.jit(jax_get_arch(arch).SMOKE_FORWARD)
    ft = get_arch(arch).SMOKE_FORWARD
    if arch == "dimenet":
        return fj(pj, gj, trips[0]), ft(pt, gt, trips[1])
    return fj(pj, gj), ft(pt, gt)


def _rotation(seed=0):
    rng = np.random.default_rng(seed)
    a, b, c = rng.uniform(0, 2 * np.pi, 3)
    Rz = np.array([[np.cos(a), -np.sin(a), 0], [np.sin(a), np.cos(a), 0],
                   [0, 0, 1]])
    Ry = np.array([[np.cos(b), 0, np.sin(b)], [0, 1, 0],
                   [-np.sin(b), 0, np.cos(b)]])
    Rx = np.array([[1, 0, 0], [0, np.cos(c), -np.sin(c)],
                   [0, np.sin(c), np.cos(c)]])
    return (Rz @ Ry @ Rx).astype(np.float32)


# ---------------------------------------------------------------------------
# forwards against the reference
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("seed", [0, 1])
def test_forward_matches_reference(arch, seed):
    gr = _graph(seed)
    pj, pt = _carried(arch, seed=seed)
    gj, gt = _batches(gr, MOLECULAR[arch])
    want, got = _forward(arch, pj, pt, gj, gt,
                         _triplets(gr) if arch == "dimenet" else None)
    assert tuple(got.shape) == tuple(want.shape) == (gr["n"], 5)
    assert torch.isfinite(got).all()
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_schnet_pieces_match_reference():
    from repro.models.gnn import schnet as js
    from repro_torch.models.gnn import schnet as ts
    x = np.linspace(-30, 30, 601, dtype=np.float32)
    np.testing.assert_allclose(ts.shifted_softplus(torch.as_tensor(x)),
                               np.asarray(js.shifted_softplus(x)),
                               atol=1e-6, rtol=1e-6)


@pytest.mark.parametrize("arch", ["schnet", "nequip", "dimenet"])
def test_rotation_invariance(arch):
    """Rotating every position leaves the node outputs unchanged."""
    gr = _graph(2)
    _, pt = _carried(arch)
    ft = get_arch(arch).SMOKE_FORWARD
    _, gt = _batches(gr)
    g_rot = gt._replace(positions=torch.as_tensor(gr["pos"] @ _rotation().T))
    extra = (_triplets(gr)[1],) if arch == "dimenet" else ()
    out, out_r = (ft(pt, g, *extra) for g in (gt, g_rot))
    np.testing.assert_allclose(out.numpy(), out_r.numpy(), atol=5e-5,
                               rtol=5e-4)


def test_nequip_tensor_product_equivariance():
    """Every Cartesian path commutes with rotations: path(R.x, R.y) ==
    R.path(x, y)."""
    rng = np.random.default_rng(3)
    R = torch.as_tensor(_rotation(3))
    m, C = 5, 4
    x = {0: torch.as_tensor(rng.normal(size=(m, C)), dtype=torch.float32),
         1: torch.as_tensor(rng.normal(size=(m, C, 3)), dtype=torch.float32),
         2: tnq._symtf(torch.as_tensor(rng.normal(size=(m, C, 3, 3)),
                                       dtype=torch.float32))}
    unit = torch.as_tensor(rng.normal(size=(m, 3)), dtype=torch.float32)
    unit = unit / unit.norm(dim=-1, keepdim=True)
    Y, Y_r = tnq.edge_sh(unit), tnq.edge_sh(unit @ R.T)

    def rot(feat, l):
        if l == 0:
            return feat
        if l == 1:
            return torch.einsum("ij,...j->...i", R, feat)
        return torch.einsum("ik,...kl,jl->...ij", R, feat, R)

    for (l1, l2, l3) in tnq.PATHS:
        out = tnq.tp_contract(l1, l2, l3, x[l1], Y[l2])
        out_r = tnq.tp_contract(l1, l2, l3, rot(x[l1], l1), Y_r[l2])
        np.testing.assert_allclose(rot(out, l3).numpy(), out_r.numpy(),
                                   atol=2e-5, rtol=2e-4,
                                   err_msg=f"path {(l1, l2, l3)}")


def test_nequip_paths_match_reference():
    """Each of the 15 paths and the edge harmonics, port against
    reference, on the same features."""
    rng = np.random.default_rng(4)
    m, C = 7, 3
    x = {0: rng.normal(size=(m, C)), 1: rng.normal(size=(m, C, 3)),
         2: rng.normal(size=(m, C, 3, 3))}
    x = {l: a.astype(np.float32) for l, a in x.items()}
    unit = rng.normal(size=(m, 3)).astype(np.float32)
    unit /= np.linalg.norm(unit, axis=-1, keepdims=True)
    Yj, Yt = jnq.edge_sh(jnp.asarray(unit)), tnq.edge_sh(torch.as_tensor(unit))
    for l in range(3):
        np.testing.assert_allclose(Yt[l].numpy(), np.asarray(Yj[l]), **TOL)
    assert np.array_equal(tnq.EPS3, np.asarray(jnq.EPS3))
    assert tnq.PATHS == jnq.PATHS
    for (l1, l2, l3) in tnq.PATHS:
        want = jnq.tp_contract(l1, l2, l3, jnp.asarray(x[l1]), Yj[l2])
        got = tnq.tp_contract(l1, l2, l3, torch.as_tensor(x[l1]), Yt[l2])
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL,
                                   err_msg=f"path {(l1, l2, l3)}")


def test_pna_aggregators_match_direct():
    rng = np.random.default_rng(0)
    n, m, d = 10, 40, 3
    dst = rng.integers(0, n, m).astype(np.int32)
    vals = rng.normal(size=(m, d)).astype(np.float32)
    mask = np.ones(m, np.float32)
    mask[:5] = 0.0
    v, ds, mk = map(torch.as_tensor, (vals, dst, mask))
    mean = tc.scatter_mean(v, ds, n, mk).numpy()
    mx = tc.scatter_max(v, ds, n, mk).numpy()
    mn = tc.scatter_min(v, ds, n, mk).numpy()
    for u in range(n):
        rows = vals[(dst == u) & (mask > 0)]
        if rows.size:
            np.testing.assert_allclose(mean[u], rows.mean(0), atol=1e-5)
            np.testing.assert_allclose(mx[u], rows.max(0), atol=1e-5)
            np.testing.assert_allclose(mn[u], rows.min(0), atol=1e-5)
        else:
            assert not mean[u].any() and not mx[u].any() and not mn[u].any()


@pytest.mark.parametrize("neg", [False, True])
def test_scatter_max_gradient_splits_ties_as_reference(neg):
    """Tied maxima (and minima) share the gradient evenly, as JAX's
    segment-max JVP does; masked candidates get none."""
    vals = np.array([[1.0, 2.0], [1.0, -1.0], [0.5, 2.0], [1.0, 2.0],
                     [3.0, 0.0], [3.0, 0.0]], np.float32)
    dst = np.array([0, 0, 0, 1, 2, 2], np.int32)
    mask = np.array([1, 1, 1, 1, 1, 0], np.float32)
    w = np.random.default_rng(5).normal(size=(4, 2)).astype(np.float32)
    jfn, tfn = (jc.scatter_min, tc.scatter_min) if neg else \
        (jc.scatter_max, tc.scatter_max)
    want = jax.grad(lambda v: jnp.sum(jfn(v, jnp.asarray(dst), 4,
                                          jnp.asarray(mask)) * w))(
        jnp.asarray(-vals if neg else vals))
    v = torch.as_tensor(-vals if neg else vals).requires_grad_()
    (tfn(v, torch.as_tensor(dst), 4, torch.as_tensor(mask))
     * torch.as_tensor(w)).sum().backward()
    np.testing.assert_allclose(v.grad.numpy(), np.asarray(want), atol=1e-7)
    assert v.grad[0, 0] == v.grad[1, 0] != 0      # a three-way tie, split


def _as64(tree):
    return tree_unflatten(tree, [p.double() for p in tree_flatten(tree)])


def fp32_grad_bar(want, exact) -> float:
    """The reference's own error: the largest of |fp32 gradient - fp64
    gradient| / the leaf's largest |fp64 gradient| over the leaves.  A bar
    of 3x this (at least 1e-6) admits the port's rounding of the same
    function and nothing of the size a wrong split of a gradient makes."""
    return max(float(np.abs(np.asarray(w) - e.numpy()).max()
                     / max(np.abs(e.numpy()).max(), 1e-30))
               for w, e in zip(want, exact))


def assert_grads_close(got, want, exact):
    """Each leaf of ``got`` within rtol 1e-4 and atol (bar x the leaf's
    scale) of ``want`` and of ``exact`` (an fp64 run)."""
    bar = max(1e-6, 3 * fp32_grad_bar(want, exact))
    for g, w, e in zip(got, want, exact):
        scale = float(np.abs(e.numpy()).max()) or 1.0
        for ref in (np.asarray(w), e.numpy()):
            np.testing.assert_allclose(g.numpy(), ref, rtol=1e-4,
                                       atol=bar * scale)
    return bar


def test_pna_gradients_at_tied_messages_match_reference():
    """Repeated edges send equal messages, so PNA's max and min tie there
    (ReLU-free, as PNA is); the parameters' gradients match JAX's.  The
    bar comes from the reference's own distance to an fp64 run (a vertex
    with no in-edge scales its aggregates by 2 / 1e-6, which amplifies
    fp32 rounding to ~4e-6 of a leaf's scale in both packages); a tie
    split otherwise than JAX's moves a gradient by O(its scale)."""
    gr = _graph(6, n=12, m=30, n_pad=3, dup=12)
    pj, pt = _carried("pna", seed=6)
    gj, gt = _batches(gr, molecular=False)
    fj, ft = jax_get_arch("pna").SMOKE_FORWARD, get_arch("pna").SMOKE_FORWARD
    want = jax.tree.leaves(jax.jit(jax.grad(
        lambda p: jnp.sum(fj(p, gj) ** 2)))(pj))

    def grads(params, g):
        leaves = [p.detach().requires_grad_() for p in tree_flatten(params)]
        (ft(tree_unflatten(params, leaves), g) ** 2).sum().backward()
        return [p.grad for p in leaves]

    exact = grads(_as64(pt), gt._replace(
        node_feat=gt.node_feat.double(), edge_mask=gt.edge_mask.double()))
    assert assert_grads_close(grads(pt, gt), want, exact) < 1e-4


# ---------------------------------------------------------------------------
# DimeNet's host side
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("n_l,n_n", [(4, 3), (4, 4), (7, 6)])
def test_bessel_zeros_bit_equal_and_roots(n_l, n_n):
    z = tdim.bessel_zeros(n_l, n_n)
    assert np.array_equal(z, jdim.bessel_zeros(n_l, n_n))
    for l in range(n_l):
        for k in range(n_n):
            assert abs(tdim._jl_np(l, np.array([z[l, k]]))[0]) < 1e-6
        assert np.all(np.diff(z[l]) > 1)   # distinct, increasing


def test_spherical_basis_matches_reference():
    """j_l's fp32 upward recurrence: the port's equals the reference's at
    TOL for x >= 2; below, the recurrence loses digits in both (at the
    5e-2 clamp the reference's j_6 is off by ~3e3 from its own float64
    ``_jl_np``), and there the port is held to no more than twice the
    reference's own distance from float64, l by l."""
    x = torch.linspace(-0.5, 12.0, 300, dtype=torch.float32)
    stable = x.numpy() >= 2.0
    exact_x = np.maximum(x.numpy().astype(np.float64), 5e-2)
    for l in range(7):
        got = tdim._jl_torch(l, x).numpy()
        want = np.asarray(jdim._jl_jax(l, x.numpy()))
        exact = jdim._jl_np(l, exact_x)
        np.testing.assert_allclose(got[stable], want[stable], **TOL,
                                   err_msg=f"l={l}")
        assert np.abs(got - exact).max() <= \
            2 * np.abs(want - exact).max() + 1e-6, f"l={l}"
    c = torch.linspace(-1, 1, 101)
    np.testing.assert_allclose(tdim._legendre(7, c).numpy(),
                               np.asarray(jdim._legendre(7, c.numpy())),
                               atol=1e-6)


@pytest.mark.parametrize("case", ["er", "dups_and_loops", "cap", "star",
                                  "one_edge", "empty"])
def test_build_triplets_equal_reference(case):
    """The port's vectorised lists are the reference's double loop, in its
    order, with its padding; ``k != i`` excluded."""
    rng = np.random.default_rng(7)
    n, cap = 20, None
    if case == "er":
        src, dst, _ = erdos_renyi(n, 70, seed=3)
    elif case == "dups_and_loops":
        src, dst = rng.integers(0, 8, 60), rng.integers(0, 8, 60)
    elif case == "cap":
        src, dst, _ = erdos_renyi(n, 40, seed=4)
        cap = 512
    elif case == "star":              # every in-edge of 0 feeds 0 -> j
        src = np.r_[np.arange(1, 10), np.zeros(9, np.int64)]
        dst = np.r_[np.zeros(9, np.int64), np.arange(1, 10)]
    elif case == "one_edge":
        src, dst = np.array([3]), np.array([5])
    else:
        src, dst, cap = np.zeros(0, np.int64), np.zeros(0, np.int64), 8
    want = jdim.build_triplets(src, dst, n, cap)
    got = tdim.build_triplets(src, dst, n, cap, device="cpu")
    for g, w in zip(got, want):
        assert g.dtype == torch.as_tensor(np.array(w)).dtype
        assert np.array_equal(g.numpy(), np.asarray(w))
    real = got.mask.numpy() > 0
    e_in, e_out = got.e_in.numpy()[real], got.e_out.numpy()[real]
    assert np.all(dst[e_in] == src[e_out])     # k->j feeds j->i
    assert np.all(src[e_in] != dst[e_out])     # k != i


def test_build_triplets_overflow_raises():
    src, dst, _ = erdos_renyi(20, 70, seed=3)
    with pytest.raises(ValueError, match="triplet overflow"):
        tdim.build_triplets(src, dst, 20, cap=4, device="cpu")


def test_dimenet_bilinear_matches_einsum():
    rng = np.random.default_rng(8)
    t, b, d, m = 50, 4, 6, 9
    sbf, x, w = (torch.as_tensor(rng.normal(size=s), dtype=torch.float32)
                 for s in ((t, b), (m, d), (b, d, d)))
    e_in = torch.as_tensor(rng.integers(0, m, t))
    want = torch.einsum("tb,ti,bij->tj", sbf, x[e_in], w)
    np.testing.assert_allclose(tdim.bilinear(sbf, x, e_in, w).numpy(),
                               want.numpy(), atol=1e-5, rtol=1e-5)


# ---------------------------------------------------------------------------
# the neighbour sampler
# ---------------------------------------------------------------------------
def _in_csr(n=200, m=2000, seed=0):
    src, dst, _ = erdos_renyi(n, m, seed=seed)
    order = np.argsort(dst)
    indptr = np.zeros(n + 1, dtype=np.int64)
    np.cumsum(np.bincount(dst, minlength=n), out=indptr[1:])
    return indptr, src[order]


@pytest.mark.parametrize("seed", [0, 5])
@pytest.mark.parametrize("fanouts", [(5, 3), (15, 10), (2,)])
def test_sampler_block_equals_reference(seed, fanouts):
    indptr, indices = _in_csr(seed=seed)
    seeds = np.random.default_rng(seed).permutation(200)[:8]
    n_cap, m_cap = tsamp.sampled_shape_caps(8, fanouts)
    assert (n_cap, m_cap) == jsamp.sampled_shape_caps(8, fanouts)
    want = jsamp.NeighborSampler(indptr, indices, seed=seed).sample_padded(
        seeds, fanouts, n_cap, m_cap)
    got = tsamp.NeighborSampler(indptr, indices, seed=seed).sample_padded(
        seeds, fanouts, n_cap, m_cap)
    assert got.n_nodes == want.n_nodes == n_cap and got.seeds == want.seeds
    for name in ("node_ids", "src", "dst", "edge_mask"):
        g, w = getattr(got, name), getattr(want, name)
        assert g.dtype == w.dtype and np.array_equal(g, w), name
    np.testing.assert_array_equal(got.node_ids[:8], seeds)   # seeds first
    real = int(got.edge_mask.sum())
    assert 0 < real <= m_cap
    assert np.all(got.src[real:] == n_cap - 1) and np.all(
        got.dst[real:] == n_cap - 1)
    # every real edge joins two real nodes, to a sampled destination
    ids = got.node_ids
    assert np.all(ids[got.src[:real]] >= 0) and np.all(ids[got.dst[:real]] >= 0)


def test_sampler_overflow_raises():
    indptr, indices = _in_csr()
    s = tsamp.NeighborSampler(indptr, indices)
    with pytest.raises(ValueError, match="sample overflow"):
        s.sample_padded(np.arange(8), (5, 3), 10, 10)


# ---------------------------------------------------------------------------
# init trees and the weight carry
# ---------------------------------------------------------------------------
def _structure(tree):
    if isinstance(tree, dict):
        return {k: _structure(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_structure(v) for v in tree]
    return (tuple(tree.shape), str(np.dtype(str(tree.dtype).replace(
        "torch.", ""))))


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("size", ["SMOKE_INIT", "INIT"])
def test_init_tree_matches_reference(arch, size):
    """The port's own init (published ``HP`` widths and SMOKE) has the
    reference's keys, list order, shapes and dtypes; biases 0; DimeNet's
    ``_zeros`` the reference's roots."""
    want = jax.eval_shape(lambda: getattr(jax_get_arch(arch), size)(
        jax.random.PRNGKey(0), d_in=10, d_out=5))
    got = getattr(get_arch(arch), size)(torch.Generator().manual_seed(0),
                                        d_in=10, d_out=5, device="cpu")
    assert _structure(got) == _structure(want)
    assert not got["embed"][0]["b"].any() if "embed" in got else True
    if arch == "dimenet":
        j = getattr(jax_get_arch(arch), size)(jax.random.PRNGKey(0),
                                              d_in=10, d_out=5)
        assert np.array_equal(got["_zeros"].numpy(), np.asarray(j["_zeros"]))


@pytest.mark.parametrize("arch", ARCHS)
def test_params_from_numpy_round_trips(arch):
    pj, pt = _carried(arch)
    assert _structure(pt) == _structure(jax.eval_shape(lambda: pj))
    for got, want in zip(tree_flatten(pt), jax.tree.leaves(pj)):
        assert np.array_equal(got.numpy(), np.asarray(want))
    back = params_from_numpy(jax.tree.map(lambda t: t.numpy(), pt,
                                          is_leaf=torch.is_tensor), "cpu")
    for a, b in zip(tree_flatten(back), tree_flatten(pt)):
        assert a.dtype == b.dtype and torch.equal(a, b)
    with pytest.raises(TypeError, match="not a float"):
        params_from_numpy({"w": np.zeros(3, np.int32)}, "cpu")
