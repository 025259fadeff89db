"""The port's GNN train step (``repro_torch.configs.gnn_common``) against the
reference's on the CPU, per arch at SMOKE widths, for ``node_ce`` and for
``graph_mse`` (with a ``graph_id`` whose padded nodes carry the
out-of-range id ``n_graphs``): the loss at rtol 1e-5, the gradients
against a separate reference ``jax.value_and_grad`` (rtol 1e-4, atol a
fraction of each leaf's scale set from the reference's own distance to an
fp64 run, at least 1e-6), the parameters after one AdamW step at atol
1e-6 (where a gradient is below 1e-6, AdamW's direction is rounding:
there against the reference's update of the port's gradient).  Also
``gnn_model_flops``, ``split_params``, every cell's sizes
and model FLOPs against the reference's abstract cells, and the
materialising builders on small cuts."""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro.configs import gnn_common as jgc
from repro.configs.registry import get_arch as jax_get_arch
from repro.train import optim as jax_optim
from repro_torch.ckpt.checkpoint import tree_flatten, tree_unflatten
from repro_torch.configs import gnn_common as tgc
from repro_torch.configs.registry import get_arch
from repro_torch.train import adamw_init
from test_torch_gnn_models import (ARCHS, MOLECULAR, _as64, _batches,
                                   _carried, _graph, _triplets,
                                   assert_grads_close, fp32_grad_bar)

LOSS_REL = 1e-5
STEP_ATOL = 1e-6
NEAR_ZERO = 1e-6
N_GRAPHS = 3


def _inputs(arch, kind, seed):
    """Both packages' batch, labels and extra arguments."""
    gr = _graph(seed)
    rng = np.random.default_rng(seed + 100)
    n = gr["n"]
    graph_id = None
    if kind == "graph_mse":     # 8 nodes a graph; the last 2 are padding
        graph_id = np.minimum(np.arange(n) // 8, N_GRAPHS).astype(np.int32)
        labels = rng.normal(size=N_GRAPHS).astype(np.float32)
    else:
        labels = rng.integers(0, 5, n).astype(np.int32)
    gj, gt = _batches(gr, MOLECULAR[arch], graph_id)
    tj, tt = _triplets(gr) if arch == "dimenet" else ((), ())
    extra_j = (tj,) if arch == "dimenet" else ()
    extra_t = (tt,) if arch == "dimenet" else ()
    return (gj, jnp.asarray(labels), extra_j), (gt, torch.as_tensor(labels),
                                                extra_t)


def _batch64(g):
    return g._replace(node_feat=g.node_feat.double(),
                      edge_mask=g.edge_mask.double(),
                      positions=None if g.positions is None
                      else g.positions.double())


def _ref_loss(forward, kind):
    """The reference step's loss (src/repro/configs/gnn_common.py:69-79)."""
    def loss(train, aux, batch, labels, extra):
        out = forward({**train, **aux}, batch, *extra)
        if kind == "node_ce":
            logits = out.astype(jnp.float32)
            lse = jax.scipy.special.logsumexp(logits, axis=-1)
            gold = jnp.take_along_axis(logits, labels[:, None], axis=-1)[:, 0]
            return jnp.mean(lse - gold)
        energy = jax.ops.segment_sum(out[:, 0], batch.graph_id,
                                     num_segments=N_GRAPHS)
        return jnp.mean((energy - labels) ** 2)
    return loss


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("kind", ["node_ce", "graph_mse"])
def test_train_step_matches_reference(arch, kind):
    n_graphs = N_GRAPHS if kind == "graph_mse" else None
    (gj, lj, ej), (gt, lt, et) = _inputs(arch, kind, seed=3)
    pj, pt = _carried(arch, seed=3)
    fj, ft = jax_get_arch(arch).SMOKE_FORWARD, get_arch(arch).SMOKE_FORWARD

    # the reference's gradient, apart from its step
    train_j, aux_j = jgc.split_params(pj)
    want_loss, want_g = jax.jit(jax.value_and_grad(_ref_loss(fj, kind)))(
        train_j, aux_j, gj, lj, ej)
    # the port's, and an fp64 run of the port's code for the bar
    loss_fn = tgc.make_gnn_loss(ft, kind, n_graphs)
    train_t, aux_t = tgc.split_params(pt)

    def grads(train, aux, batch, labels, extra):
        leaves = [p.detach().requires_grad_() for p in tree_flatten(train)]
        loss = loss_fn({**tree_unflatten(train, leaves), **aux}, batch,
                       labels, *extra)
        return loss, torch.autograd.grad(loss, leaves, allow_unused=True,
                                         materialize_grads=True)

    got_loss, got_g = grads(train_t, aux_t, gt, lt, et)
    _, exact = grads(_as64(train_t), _as64(aux_t), _batch64(gt),
                     lt.double() if kind == "graph_mse" else lt,
                     tuple(t._replace(mask=t.mask.double()) for t in et))
    np.testing.assert_allclose(float(got_loss.detach()), float(want_loss),
                               rtol=LOSS_REL)
    assert_grads_close(got_g, jax.tree.leaves(want_g), exact)
    print(f"{arch} {kind}: the reference's fp32 gradients within "
          f"{fp32_grad_bar(jax.tree.leaves(want_g), exact)} of fp64, "
          f"the port's within {fp32_grad_bar(got_g, exact)} (worst leaf, "
          f"over its scale)")

    # one step of each package's train step
    step_j = jgc.make_gnn_train_step(fj, kind, n_graphs=n_graphs)
    pj2, oj2, lj2 = jax.jit(step_j)(pj, jax_optim.adamw_init(train_j), gj,
                                    lj, *ej)
    step_t = tgc.make_gnn_train_step(ft, kind, n_graphs=n_graphs)
    ot = adamw_init(train_t)
    pt2, ot2, lt2 = step_t(pt, ot, gt, lt, *et)
    assert pt2 is pt and ot2 is ot and lt2.dim() == 0
    np.testing.assert_allclose(float(lt2), float(lj2), rtol=LOSS_REL)
    assert int(ot.step) == 1
    # AdamW's first step moves a leaf by lr * g / (|g| + eps): where the
    # reference's |g| is below NEAR_ZERO its direction is rounding, so
    # there the port is held to the reference's update of the port's own
    # gradient (the same arithmetic, the same inputs)
    own = jax_optim.adamw_update(
        jax.tree.unflatten(jax.tree.structure(train_j),
                           [jnp.asarray(g.numpy()) for g in got_g]),
        jax_optim.adamw_init(train_j), train_j, lr=1e-3)[0]
    want_p, got_p = jax.tree.leaves(pj2), tree_flatten(pt2)
    assert len(want_p) == len(got_p)
    near = {id(p): np.abs(np.asarray(g)) < NEAR_ZERO
            for p, g in zip(tree_flatten(train_t), jax.tree.leaves(want_g))}
    for got, want, mine in zip(tree_flatten(train_t),
                               jax.tree.leaves(jgc.split_params(pj2)[0]),
                               jax.tree.leaves(own)):
        want = np.where(near[id(got)], np.asarray(mine), np.asarray(want))
        np.testing.assert_allclose(got.numpy(), want, atol=STEP_ATOL, rtol=0)
    for got, want in zip(got_p, want_p):      # the buffers too
        assert got.shape == want.shape
    if arch == "dimenet":       # the buffer is not trained
        assert torch.equal(pt2["_zeros"], torch.as_tensor(
            np.array(pj["_zeros"])))
        assert "_zeros" not in ot.mu


def test_graph_mse_drops_padded_nodes():
    """A node whose graph_id is n_graphs adds nothing to any graph."""
    out = torch.tensor([[1.0], [2.0], [4.0], [8.0]])
    batch = tgc.GraphBatch(node_feat=out, src=torch.zeros(1, dtype=torch.int32),
                           dst=torch.zeros(1, dtype=torch.int32),
                           edge_mask=torch.ones(1),
                           graph_id=torch.tensor([0, 1, 1, 2]))
    loss = tgc.make_gnn_loss(lambda p, b: b.node_feat, "graph_mse", 2)
    assert float(loss({}, batch, torch.tensor([1.0, 6.0]))) == 0.0


def test_model_flops_and_split_params_equal_reference():
    for arch in ("schnet", "pna", "nequip", "dimenet", "gcn"):
        for args in ((3072, 10752, 1433, 64, 3, "train", 65536),
                     (4096, 8192, 32, 128, 6, "serve", 0)):
            assert tgc.gnn_model_flops(arch, *args) == \
                jgc.gnn_model_flops(arch, *args)
    tree = {"a": 1, "_b": 2, "c": [3], "_zeros": 4}
    assert tgc.split_params(tree) == jgc.split_params(tree)
    assert tgc.SHAPES == jgc.SHAPES


@pytest.mark.parametrize("arch", ARCHS)
def test_cell_sizes_and_flops_match_reference_cells(arch):
    """Each of the four cells at cut 1: n, m, d, the label shape and
    DimeNet's triplet slots equal the reference's abstract cell (built on
    a one-device mesh), and so do the model FLOPs."""
    from repro.utils import make_mesh_compat
    mesh = make_mesh_compat((1,), ("data",))
    mod = get_arch(arch)
    for cell in jax_get_arch(arch).CELLS:
        built = cell.build(mesh)
        shape = tgc.SHAPES[cell.shape]
        sz = tgc.cell_sizes(shape)
        batch = built.args[2]
        assert batch.node_feat.shape == (sz["n"], shape["d"])
        assert batch.src.shape == (sz["m"],)
        assert built.args[3].shape == ((shape["n_graphs"],)
                                       if "n_graphs" in shape
                                       else (sz["n"],))
        t = built.args[4].e_in.shape[0] if arch == "dimenet" else 0
        if arch == "dimenet":
            assert t == sz["t"]
        assert tgc.gnn_model_flops(
            arch, sz["n"], sz["m"], shape["d"], mod.HP["d_hidden"],
            mod.N_LAYERS, "train", t) == built.model_flops


# shape -> the cut each builder runs at here (a few hundred edges, but
# molecule, which a cut would split into other graphs)
BUILD_CUTS = {"full_graph_sm": 16, "minibatch_lg": 256, "molecule": 1,
              "ogb_products": 65536}


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("shape", list(BUILD_CUTS))
def test_materialised_cell_takes_a_step(arch, shape):
    """``materialize_gnn_train`` with the arch's SMOKE widths at each
    shape: the synthetic batch (padded edges in range with mask 0, padded
    nodes zero, molecule's padded nodes in graph n_graphs; DimeNet's real
    triplets within the slots), one step that moves every trainable leaf
    with a finite loss."""
    mod = get_arch(arch)
    cut = BUILD_CUTS[shape]
    spec = tgc.SHAPES[shape]
    built = tgc.materialize_gnn_train(
        arch, mod.SMOKE_INIT, mod.SMOKE_FORWARD, spec,
        molecular=mod.MOLECULAR, with_triplets=mod.WITH_TRIPLETS,
        d_hidden=mod.HP["d_hidden"], n_layers=mod.N_LAYERS)(
            "cpu", seed=1, cut=cut)
    params, opt, batch, labels, *extra = built.args
    sz = built.sizes
    n, m = sz["n"], sz["m"]
    assert batch.node_feat.shape == (n, spec["d"]) and batch.src.shape == (m,)
    assert int(batch.src.max()) < n and int(batch.dst.max()) < n
    real = batch.edge_mask > 0
    assert int(real.sum()) == sz["m_real"] and not real[sz["m_real"]:].any()
    assert not batch.node_feat[sz["n_real"]:].any()
    assert (batch.positions is None) == (arch == "pna")
    assert bool(sz["reduced"]) == (cut > 1)
    if "n_graphs" in spec:
        assert int((batch.graph_id == spec["n_graphs"]).sum()) == n - sz[
            "n_real"]
    else:
        assert labels.shape == (n,)
    if arch == "dimenet":
        trip = extra[0]
        assert trip.e_in.shape == (sz["t"],) and 0 < sz["t_real"] <= sz["t"]
        assert int(trip.mask.sum()) == sz["t_real"]
    else:
        assert sz["t"] == 0 and not extra
    assert built.model_flops > 0
    before = [p.clone() for p in tree_flatten(tgc.split_params(params)[0])]
    _, _, loss = built.step(*built.args)
    assert torch.isfinite(loss)
    after = tree_flatten(tgc.split_params(params)[0])
    assert all(not torch.equal(a, b) for a, b in zip(before, after))
    assert int(opt.step) == 1


@pytest.mark.parametrize("arch", ARCHS)
def test_published_cells_build_and_step(arch):
    """``cells()`` has the four shapes; the published widths and depths
    take a step at a small ogb_products cut, their tree the reference's
    init's, and the FLOPs are the reference's formula at the sizes run."""
    from test_torch_gnn_models import _structure
    mod = get_arch(arch)
    cells = mod.cells()
    assert set(cells) == set(tgc.SHAPES)
    built = cells["ogb_products"]("cpu", seed=0, cut=65536)
    params = built.args[0]
    want = jax.eval_shape(lambda: jax_get_arch(arch).INIT(
        jax.random.PRNGKey(0), d_in=100, d_out=47))
    assert _structure(params) == _structure(want)
    sz = built.sizes
    assert built.model_flops == jgc.gnn_model_flops(
        arch, sz["n"], sz["m"], 100, mod.HP["d_hidden"], mod.N_LAYERS,
        "train", sz["t"])
    _, _, loss = built.step(*built.args)
    assert torch.isfinite(loss)


def test_minibatch_cell_is_the_samplers_block():
    """The minibatch cell's edges are a padded block of the port's
    ``NeighborSampler`` (seeds first, saturated fanouts)."""
    data = tgc.make_gnn_batch(tgc.SHAPES["minibatch_lg"], device="cpu",
                              seed=2, cut=64)
    sz = data.sizes
    seeds = sz["sampled_from"]["seeds"]
    assert seeds == 16 and sz["sampled_from"]["csr_m"] == 3640 * 492
    dst = data.batch.dst[data.batch.edge_mask > 0]
    counts = torch.bincount(dst.long(), minlength=sz["n"])
    # every seed got 15 in-edges (more if it was sampled again at hop 2)
    assert int(counts[:seeds].min()) >= 15
    assert sz["m_real"] == seeds * 15 + len(torch.unique(
        data.batch.src[:seeds * 15])) * 10
