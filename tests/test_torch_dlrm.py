"""The port's DLRM-RM2 (``repro_torch.models.recsys``) and GNN plumbing
(``repro_torch.models.gnn.common``) against the reference's on the CPU:
every function of ``models/gnn/common.py`` on the same seeded inputs,
``rm2_vocab_sizes`` bit for bit, the configs and model FLOPs, and
``dlrm_forward``, ``dlrm_loss`` and ``retrieval_scores`` at
``SMOKE_CONFIG`` (single- and multi-hot) with the reference's parameters
carried by ``params_from_numpy``, at atol/rtol 2e-3."""
import numpy as np
import pytest
import torch
import torch.nn.functional as F

import jax
import jax.numpy as jnp

from repro.configs import dlrm_rm2 as jax_cfgs
from repro.models.gnn import common as jc
from repro.models.recsys import dlrm as jd
from repro_torch.configs import dlrm_rm2 as cfgs
from repro_torch.configs.registry import get_arch
from repro_torch.kernels.embedding_bag.ref import embedding_bag_ref
from repro_torch.models.gnn import common as tc
from repro_torch.models.recsys import dlrm as td

TOL = dict(atol=2e-3, rtol=2e-3)


def _close(got, want, **tol):
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **(tol or TOL))


def _graph(seed, n=30, m=120, d=8, n_pad=10):
    """Features, edges (the last ``n_pad`` padding edges to n-1, mask 0;
    vertex 0 has no real in-edge) and positions."""
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(m, d)).astype(np.float32)
    src = rng.integers(0, n, size=m).astype(np.int32)
    dst = rng.integers(1, n, size=m).astype(np.int32)
    mask = np.ones(m, np.float32)
    src[-n_pad:], dst[-n_pad:], mask[-n_pad:] = n - 1, n - 1, 0.0
    pos = rng.normal(size=(n, 3)).astype(np.float32)
    return x, src, dst, mask, pos, n


def _t(*arrays):
    return [torch.as_tensor(a) for a in arrays]


@pytest.mark.parametrize("seed", [0, 1])
def test_scatter_family_matches_reference(seed):
    x, src, dst, mask, _, n = _graph(seed)
    xt, dt, mt = _t(x, dst, mask)
    _close(tc.scatter_sum(xt, dt, n), jc.scatter_sum(x, dst, n))
    _close(tc.scatter_mean(xt, dt, n, mt), jc.scatter_mean(x, dst, n, mask))
    for name in ("scatter_max", "scatter_min"):
        got = getattr(tc, name)(xt, dt, n, mt)
        _close(got, getattr(jc, name)(x, dst, n, mask), atol=0, rtol=0)
    assert not got[0].any()           # no real in-edge: 0
    _close(tc.in_degree(dt, mt, n), jc.in_degree(dst, mask, n))


@pytest.mark.parametrize("act", ["silu", "relu"])
def test_mlp_matches_reference(act):
    dims = [13, 32, 16, 4]
    pj = jc.init_mlp(jax.random.PRNGKey(0), dims)
    pt = [{k: torch.as_tensor(np.asarray(v)) for k, v in p.items()}
          for p in pj]
    x = np.random.default_rng(2).normal(size=(7, 13)).astype(np.float32)
    _close(tc.mlp(pt, torch.as_tensor(x), act=getattr(F, act)),
           jc.mlp(pj, jnp.asarray(x), act=getattr(jax.nn, act)))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_init_mlp_is_the_reference_tree(dtype):
    dims = [64, 512, 256]
    got = tc.init_mlp(torch.Generator().manual_seed(0), dims, dtype, "cpu")
    want = jax.eval_shape(lambda: jc.init_mlp(
        jax.random.PRNGKey(0), dims,
        jnp.float32 if dtype == torch.float32 else jnp.bfloat16))
    assert len(got) == len(want) == 2
    for g, w, fan_in in zip(got, want, dims):
        assert set(g) == set(w) == {"w", "b"}
        for k in g:
            assert tuple(g[k].shape) == w[k].shape and g[k].dtype == dtype
        assert not g["b"].any()
        assert abs(g["w"].float().std().item() * fan_in ** 0.5 - 1) < 0.05


def test_radial_bases_match_reference():
    d = np.abs(np.random.default_rng(3).normal(size=50) * 3).astype(
        np.float32)
    d[0] = 0.0                                    # the clamp of bessel_rbf
    dt = torch.as_tensor(d)
    _close(tc.gaussian_rbf(dt, 16, 5.0), jc.gaussian_rbf(d, 16, 5.0))
    _close(tc.bessel_rbf(dt, 8, 5.0), jc.bessel_rbf(d, 8, 5.0))
    _close(tc.cosine_cutoff(dt, 4.0), jc.cosine_cutoff(d, 4.0))
    for p in (5, 6):
        _close(tc.polynomial_envelope(dt, 4.0, p),
               jc.polynomial_envelope(d, 4.0, p))


def test_edge_vectors_match_reference():
    _, src, dst, _, pos, _ = _graph(4)
    src[0] = dst[0]                               # a zero-length edge
    unit, dist = tc.edge_vectors(*_t(pos, src, dst))
    want_unit, want_dist = jc.edge_vectors(pos, src, dst)
    _close(unit, want_unit)
    _close(dist, want_dist)
    assert torch.isfinite(unit).all()


def test_graph_batch_fields_match_reference():
    assert tc.GraphBatch._fields == jc.GraphBatch._fields
    x, src, dst, mask, _, _ = _graph(5)
    gb = tc.GraphBatch(*_t(x, src, dst, mask))
    assert gb.positions is None and gb.graph_id is None


@pytest.mark.parametrize("n_sparse,seed", [(26, 7), (26, 0), (8, 3)])
def test_rm2_vocab_sizes_equal(n_sparse, seed):
    assert td.rm2_vocab_sizes(n_sparse, seed) == jd.rm2_vocab_sizes(n_sparse,
                                                                    seed)


def test_configs_and_flops_match_reference():
    for name in ("CONFIG", "SMOKE_CONFIG"):
        assert tuple(getattr(cfgs, name)) == tuple(getattr(jax_cfgs, name))
    assert get_arch("dlrm-rm2") is cfgs
    assert sum(cfgs.CONFIG.vocab_sizes) == 49_888_768
    for batch, kind in ((512, "serve"), (262_144, "serve"), (65_536, "train")):
        assert cfgs.dlrm_model_flops(cfgs.CONFIG, batch, kind) == \
            jax_cfgs.dlrm_model_flops(jax_cfgs.CONFIG, batch, kind)


def _carried(cfg, seed=0):
    cfg_j = jd.DLRMConfig(*cfg)
    pj = jd.init_dlrm(jax.random.PRNGKey(seed), cfg_j)
    return cfg_j, pj, td.params_from_numpy(jax.tree.map(np.asarray, pj),
                                           cfg, "cpu")


def _inputs(cfg, B, seed=0):
    rng = np.random.default_rng(seed)
    dense = rng.normal(size=(B, cfg.n_dense)).astype(np.float32)
    sparse = np.stack([rng.integers(0, v, size=(B, cfg.multi_hot))
                       for v in cfg.vocab_sizes], axis=1).astype(np.int32)
    labels = rng.integers(0, 2, size=B).astype(np.float32)
    return dense, sparse, labels


@pytest.mark.parametrize("multi_hot", [1, 3])
@pytest.mark.parametrize("B", [1, 33])
def test_dlrm_forward_and_loss_match_reference(multi_hot, B):
    cfg = cfgs.SMOKE_CONFIG._replace(multi_hot=multi_hot)
    cfg_j, pj, pt = _carried(cfg, seed=B)
    dense, sparse, labels = _inputs(cfg, B, seed=B)
    want = jd.dlrm_forward(pj, cfg_j, jnp.asarray(dense), jnp.asarray(sparse))
    got = td.dlrm_forward(pt, cfg, *_t(dense, sparse))
    assert got.shape == (B,)
    _close(got, want)
    _close(td.dlrm_loss(pt, cfg, *_t(dense, sparse, labels)),
           jd.dlrm_loss(pj, cfg_j, jnp.asarray(dense), jnp.asarray(sparse),
                        jnp.asarray(labels)))


@pytest.mark.parametrize("multi_hot", [1, 2])
def test_retrieval_scores_match_reference(multi_hot):
    cfg = cfgs.SMOKE_CONFIG._replace(multi_hot=multi_hot)
    cfg_j, pj, pt = _carried(cfg, seed=5)
    dense, sparse, _ = _inputs(cfg, 1, seed=5)
    cand = np.random.default_rng(6).normal(
        size=(1000, cfg.embed_dim)).astype(np.float32)
    want = jd.retrieval_scores(pj, cfg_j, jnp.asarray(dense),
                               jnp.asarray(sparse), jnp.asarray(cand))
    got = td.retrieval_scores(pt, cfg, *_t(dense, sparse, cand))
    assert got.shape == (1000,) and got.dtype == torch.float32
    _close(got, want)


def test_every_field_is_one_bag_call_on_contiguous_int32():
    """26 calls at RM2's field count, each on its field's ids as the
    contiguous int32 ``[B, hot]`` the kernel takes; int64 ids go in too."""
    cfg = cfgs.CONFIG._replace(vocab_sizes=(50,) * 26)
    params = td.init_dlrm(torch.Generator().manual_seed(0), cfg,
                          device="cpu")
    dense, sparse, _ = _inputs(cfg._replace(multi_hot=2), 9)
    calls = []

    def bag(table, idx):
        calls.append(idx)
        return embedding_bag_ref(table, idx)

    sparse_t = torch.as_tensor(sparse).long()
    out = td.dlrm_forward(params, cfg, torch.as_tensor(dense), sparse_t,
                          bag=bag)
    assert len(calls) == 26 and out.shape == (9,)
    for f, idx in enumerate(calls):
        assert idx.dtype == torch.int32 and idx.is_contiguous()
        assert torch.equal(idx.long(), sparse_t[:, f])
    assert torch.equal(out, td.dlrm_forward(params, cfg,
                                            torch.as_tensor(dense), sparse_t))


def test_init_dlrm_tree_matches_reference():
    cfg = cfgs.SMOKE_CONFIG
    want = jax.eval_shape(lambda: jd.init_dlrm(jax.random.PRNGKey(0),
                                               jd.DLRMConfig(*cfg)))
    got = td.init_dlrm(torch.Generator().manual_seed(0), cfg, device="cpu")
    flat_w = jax.tree_util.tree_flatten_with_path(want)[0]
    flat_g = {jax.tree_util.keystr(p): v for p, v in
              jax.tree_util.tree_flatten_with_path(got)[0]}
    assert len(flat_w) == len(flat_g)
    for path, leaf in flat_w:
        t = flat_g[jax.tree_util.keystr(path)]
        assert tuple(t.shape) == leaf.shape and t.dtype == torch.float32
    big = td.init_dlrm(torch.Generator().manual_seed(0),
                       cfg._replace(vocab_sizes=(4000,) * 6),
                       device="cpu")["tables"][0]
    assert abs(big.std().item() * cfg.embed_dim ** 0.5 - 1) < 0.05


def test_params_from_numpy_checks_the_tree():
    cfg = cfgs.SMOKE_CONFIG
    _, pj, _ = _carried(cfg)
    tree = jax.tree.map(np.asarray, pj)
    bad = dict(tree, tables=tree["tables"][:-1])
    with pytest.raises(ValueError):
        td.params_from_numpy(bad, cfg, "cpu")
    bad = dict(tree, top=[dict(tree["top"][0], w=tree["top"][0]["w"][1:]),
                          tree["top"][1]])
    with pytest.raises(ValueError, match="top/0/w"):
        td.params_from_numpy(bad, cfg, "cpu")


@pytest.mark.parametrize("padding_idx", [None, 3])
def test_bag_custom_op_is_the_plain_bag_with_a_fake(padding_idx):
    """``torch.ops.repro_torch.embedding_bag`` on CPU tensors equals
    ``embedding_bag_ref`` (the kernel's plain version), bit for bit; its
    fake gives ``[B, d]`` in the table's dtype without running it."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    gen = torch.Generator().manual_seed(0)
    for dtype in (torch.float32, torch.bfloat16):
        table = torch.randn((40, 8), generator=gen).to(dtype)
        idx = torch.randint(0, 40, (7, 3), generator=gen, dtype=torch.int32)
        idx[0, :] = 3
        got = torch.ops.repro_torch.embedding_bag(table, idx, padding_idx)
        assert torch.equal(got, embedding_bag_ref(table, idx, padding_idx))
        with FakeTensorMode():
            fake = torch.ops.repro_torch.embedding_bag(
                torch.empty((40, 8), dtype=dtype),
                torch.empty((7, 3), dtype=torch.int32), padding_idx)
        assert fake.shape == (7, 8) and fake.dtype == dtype


@pytest.mark.parametrize("multi_hot", [1, 3])
def test_flop_counter_counts_each_bag_of_the_forward(multi_hot):
    """``FlopCounterMode`` around DLRM's SMOKE forward (and its gradient,
    where the bags go through ``EmbeddingBagFn``) counts B hot d for each
    field's bag through the custom op's formula."""
    from torch.utils.flop_counter import FlopCounterMode
    cfg = cfgs.SMOKE_CONFIG._replace(multi_hot=multi_hot)
    params = td.init_dlrm(torch.Generator().manual_seed(0), cfg,
                          device="cpu")
    dense, sparse, labels = _t(*_inputs(cfg, 5))
    want = cfg.n_sparse * 5 * multi_hot * cfg.embed_dim
    with FlopCounterMode(display=False) as counter:
        td.dlrm_forward(params, cfg, dense, sparse)
    counts = counter.get_flop_counts()["Global"]
    assert counts[torch.ops.repro_torch.embedding_bag] == want
    from repro_torch.train import value_and_grad
    with FlopCounterMode(display=False) as counter:
        value_and_grad(td.dlrm_loss)(params, cfg, dense, sparse, labels)
    counts = counter.get_flop_counts()["Global"]
    assert counts[torch.ops.repro_torch.embedding_bag] == want
