"""Owner-partitioned SchNet (``repro_torch.models.gnn.partitioned``)
against the reference on the CPU.  The host preparation
(``partition_graph_for_push``, ``route_graph_for_push_v2``) and the
in-shard packing (``_pack_route``: drops, sentinel, overflow) equal the
reference's arrays; then tests/torch_part_ranks.py runs v1 and v2 on 4
gloo ranks in subprocesses, and their loss (rtol 1e-5), all-reduced
gradients (rtol 1e-4, atol 1e-6 of each leaf's scale) and parameters
after one AdamW step (atol 1e-6) are held against the reference's dense
``schnet_forward`` loss, ``jax.value_and_grad`` and ``adamw_update``.
An overflowing ``halo_cap`` sets the flag without an index error."""
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro.core.graph import erdos_renyi
from repro.models.gnn import partitioned as jpart
from repro.models.gnn.common import GraphBatch
from repro.models.gnn.schnet import init_schnet, schnet_forward
from repro.train import optim as jax_optim
from repro_torch.configs import schnet_part as tcfg
from repro_torch.models.gnn import partitioned as tpart

sys.path.insert(0, os.path.dirname(__file__))
import torch_part_ranks as tpr  # noqa: E402

RUNNER = os.path.join(os.path.dirname(__file__), "torch_part_ranks.py")
VERSIONS = ["v1", "v2"]


def _graph(n, m, seed=0):
    src, dst, _ = erdos_renyi(n, m, seed=seed)
    rng = np.random.default_rng(seed)
    pos = rng.normal(size=(n, 3)).astype(np.float32) * 2
    dist = np.sqrt(((pos[src] - pos[dst]) ** 2).sum(-1) + 1e-12).astype(
        np.float32)
    return src, dst, dist, pos, rng


@pytest.mark.parametrize("n_parts", [1, 3, 4, 8])
def test_host_preparation_equals_reference(n_parts):
    src, dst, dist, _, _ = _graph(50, 300, seed=n_parts)
    for name in ("partition_graph_for_push", "route_graph_for_push_v2"):
        want = getattr(jpart, name)(50, src, dst, dist, n_parts)
        got = getattr(tpart, name)(50, src, dst, dist, n_parts)
        assert got[1:] == want[1:], name          # n_local, e_cap / cap2
        for g, w, field in zip(got[0], want[0], got[0]._fields):
            w = np.asarray(w)
            assert g.dtype == w.dtype and np.array_equal(g, w), (name, field)


@pytest.mark.parametrize("cap", [3, 6, 40])
def test_pack_route_drops_as_reference(cap):
    """Per-owner packing: the sentinel destination and writes past the cap
    are dropped (here into a trash slot), the ids' empty slots hold
    n_local, and the flag says whether a cap overflowed."""
    rng = np.random.default_rng(cap)
    n_parts, n_local, e = 4, 5, 30
    dst = rng.integers(0, n_parts * n_local + 1, e).astype(np.int32)
    vals = rng.normal(size=(e, 3)).astype(np.float32)
    want = jpart._pack_route(n_parts, n_local, cap, jnp.asarray(dst),
                             jnp.asarray(vals))
    got = tpart._pack_route(n_parts, n_local, cap, torch.as_tensor(dst),
                            torch.as_tensor(vals))
    np.testing.assert_array_equal(got[0].numpy(), np.asarray(want[0]))
    np.testing.assert_array_equal(got[1].numpy(), np.asarray(want[1]))
    assert bool(got[2]) == bool(want[2]) == (cap < 10)


def test_capacities_match_reference_cell():
    """``capacities(1)`` against the reference's ``build`` and
    ``build_v2`` on a one-device mesh (their shapes and notes)."""
    from repro.configs import schnet_part as jcfg
    from repro.utils import make_mesh_compat
    mesh = make_mesh_compat((1,), ("data",))
    caps = tcfg.capacities(1)
    b1, b2 = jcfg.build(mesh), jcfg.build_v2(mesh)
    assert b1.args[2].shape == (1, caps["n_local"], tcfg.D)
    assert b1.args[3].src_local.shape == (1, caps["e_cap"])
    assert f"e_cap={caps['e_cap']} halo_cap={caps['halo_cap']}" in b1.notes
    assert b2.args[3].src_local.shape == (1, 1, caps["cap2"])
    assert (tcfg.N, tcfg.M, tcfg.D, tcfg.CLASSES) == (
        jcfg.N, jcfg.M, jcfg.D, jcfg.CLASSES)
    with pytest.raises(ValueError):
        tcfg.capacities(3)


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """The reference's dense loss, gradients and one AdamW step in this
    process; the port's v1 / v2 on 4 gloo ranks over the same inputs."""
    n, m, d_in, d_out = tpr.N, tpr.M, tpr.D_IN, tpr.D_OUT
    src, dst, dist, pos, rng = _graph(n, m)
    feat = rng.normal(size=(n, d_in)).astype(np.float32)
    labels = rng.integers(0, d_out, size=n).astype(np.int32)
    params = init_schnet(jax.random.PRNGKey(0), d_in=d_in, d_out=d_out,
                         **tpr.HP)
    g = GraphBatch(node_feat=jnp.asarray(feat), src=jnp.asarray(src, jnp.int32),
                   dst=jnp.asarray(dst, jnp.int32),
                   edge_mask=jnp.ones(src.shape[0]),
                   positions=jnp.asarray(pos))

    def loss_fn(p):
        logits = schnet_forward(p, g, n_rbf=tpr.HP["n_rbf"],
                                cutoff=tpr.HP["cutoff"]).astype(jnp.float32)
        lse = jax.scipy.special.logsumexp(logits, axis=-1)
        gold = jnp.take_along_axis(logits, jnp.asarray(labels)[:, None],
                                   axis=-1)[:, 0]
        return jnp.mean(lse - gold)

    loss, grads = jax.jit(jax.value_and_grad(loss_fn))(params)
    after, _ = jax_optim.adamw_update(grads, jax_optim.adamw_init(params),
                                      params, lr=1e-3)
    run_dir = str(tmp_path_factory.mktemp("part_ranks"))
    leaves = jax.tree.leaves(params)
    np.savez(os.path.join(run_dir, "inputs.npz"), src=src, dst=dst,
             dist=dist, feat=feat, labels=labels,
             **{f"p{i}": np.asarray(p) for i, p in enumerate(leaves)})
    env = {k: v for k, v in os.environ.items() if k != "XLA_FLAGS"}
    procs = [subprocess.Popen([sys.executable, RUNNER, str(r),
                               str(tpr.WORLD), run_dir], env=env,
                              stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for r in range(tpr.WORLD)]
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=300)[0])
    finally:
        for p in procs:
            p.kill()
    failed = [f"--- rank {i} (rc {p.returncode}):\n{out[-3000:]}"
              for i, (p, out) in enumerate(zip(procs, outs))
              if p.returncode != 0]
    assert not failed, "\n".join(failed)
    port = dict(np.load(os.path.join(run_dir, "port.npz")))
    return dict(port=port, loss=float(loss),
                grads=[np.asarray(x) for x in jax.tree.leaves(grads)],
                after=[np.asarray(x) for x in jax.tree.leaves(after)])


@pytest.mark.parametrize("version", VERSIONS)
def test_loss_matches_dense_reference(ranks, version):
    port = ranks["port"]
    assert port["ranks_agree"]
    assert port[f"{version}/no_overflow"]
    np.testing.assert_allclose(port[f"{version}/loss"], ranks["loss"],
                               rtol=1e-5)
    np.testing.assert_allclose(port[f"{version}/step_loss"], ranks["loss"],
                               rtol=1e-5)


@pytest.mark.parametrize("version", VERSIONS)
def test_gradients_match_dense_reference(ranks, version):
    """The all-reduced gradients are the dense loss's: neither P times
    them (an all-reduced loss differentiated on every rank) nor 1/P."""
    for i, want in enumerate(ranks["grads"]):
        got = ranks["port"][f"{version}/g{i}"]
        scale = float(np.abs(want).max()) or 1.0
        np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-6 * scale,
                                   err_msg=f"leaf {i}")


@pytest.mark.parametrize("version", VERSIONS)
def test_params_after_step_match_reference(ranks, version):
    for i, want in enumerate(ranks["after"]):
        np.testing.assert_allclose(ranks["port"][f"{version}/p{i}"], want,
                                   atol=1e-6, rtol=0, err_msg=f"leaf {i}")


def test_overflowing_halo_cap_sets_the_flag(ranks):
    """A halo_cap below a destination's message count drops the rest (as
    the reference's ``mode="drop"``) with no index error, and every rank
    reports the overflow; the loss stays finite."""
    port = ranks["port"]
    assert port["v1_small/overflow"]
    assert np.isfinite(port["v1_small/loss"])
    assert abs(float(port["v1_small/loss"]) - ranks["loss"]) > 1e-3
