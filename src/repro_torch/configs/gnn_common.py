"""The GNN train step and its cells, the port of ``repro``'s
``configs/gnn_common.py``.

Shapes (assigned):
  full_graph_sm  n=2,708  m=10,556   d=1,433  (full-batch train)
  minibatch_lg   n=232,965 m=114.6M  sampled: 1,024 seeds, fanout 15-10
  ogb_products   n=2,449,029 m=61.9M d=100    (full-batch-large train)
  molecule       30 nodes / 64 edges x batch 128 (graph-level regression)

Two builders of a cell.  :func:`build_gnn_train`, the reference's, describes
it for the dry-run: stand-ins padded to ``PAD``, node arrays ``Spec(all
axes, None)``, edge and triplet arrays ``Spec(all axes)`` (GNNs have no
tensor-parallel dim: every mesh axis flattened shards the rows), parameters
and AdamW state replicated, labels sharded for ``node_ce`` and replicated
for ``graph_mse``; its step runs per shard (``models/gnn/sharded.py``).
:func:`materialize_gnn_train` makes one on a device -- parameters, AdamW
state, a synthetic batch drawn from a seed -- with an optional ``cut`` of
n and m for a shape that does not fit one card.
"""
from __future__ import annotations

from typing import Callable, NamedTuple

import numpy as np
import torch
from torch.utils._pytree import tree_map

from repro_torch.models.gnn.common import GraphBatch, scatter_sum
from repro_torch.models.gnn.sampler import NeighborSampler, sampled_shape_caps
from repro_torch.train import (AdamWState, adamw_init, adamw_update,
                               value_and_grad)
from repro_torch.utils import is_dtensor, next_bucket

from .common import SDS, Built, Cell, Spec, axis_names, sds

SHAPES = {
    "full_graph_sm": dict(n=2708, m=10556, d=1433, classes=16, kind="train"),
    "minibatch_lg": dict(n=232965, m=114615892, d=602, classes=41,
                         batch_nodes=1024, fanout=(15, 10), kind="train"),
    "ogb_products": dict(n=2449029, m=61859140, d=100, classes=47,
                         kind="train"),
    "molecule": dict(n=30 * 128, m=64 * 128, d=32, n_graphs=128,
                     kind="train"),
}
PAD = 512          # the reference pads n and m to mesh-divisible sizes
MAX_TRIPLETS = 1 << 30


def gnn_model_flops(arch: str, n: int, m: int, d_in: int, d_hidden: int,
                    n_layers: int, kind: str, t: int = 0) -> float:
    """Analytic useful FLOPs: update matmuls + edge messages (x3 for train)."""
    per_layer = 2.0 * n * d_hidden * d_hidden + 2.0 * m * d_hidden
    if arch == "nequip":
        per_layer += 2.0 * m * 15 * d_hidden * 13     # 15 TP paths, <=9+3+1 comps
    if arch == "dimenet":
        per_layer += 2.0 * t * (42 * 8 + 8 * d_hidden * d_hidden / d_hidden)
        per_layer += 2.0 * t * d_hidden * 8           # bilinear
    emb = 2.0 * n * d_in * d_hidden
    total = emb + n_layers * per_layer
    return (3.0 if kind == "train" else 1.0) * total


def split_params(params: dict) -> tuple[dict, dict]:
    """(trainable, aux): keys starting with '_' are non-trainable buffers."""
    train = {k: v for k, v in params.items() if not k.startswith("_")}
    aux = {k: v for k, v in params.items() if k.startswith("_")}
    return train, aux


def node_ce_terms(out: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Each node's cross-entropy of its logits ``out``, taken in at least
    fp32 through logsumexp."""
    logits = out.to(torch.promote_types(out.dtype, torch.float32))
    lse = torch.logsumexp(logits, dim=-1)
    gold = logits.gather(-1, labels.long()[:, None])[:, 0]
    return lse - gold


def make_gnn_loss(forward_fn, loss_kind: str, n_graphs: int | None = None):
    """``(params, batch, labels, *extra) -> loss``, a 0-d tensor.
    ``"node_ce"``: the mean of :func:`node_ce_terms` over every node.
    ``"graph_mse"``: each graph's summed first output against its label; a
    node whose ``graph_id`` is ``n_graphs`` (padding) is left out, as the
    reference's segment sum drops that out-of-range id.  A batch of
    ``DTensor`` s (the dry-run's cells) goes through
    ``models/gnn/sharded.train_loss``."""

    def loss_fn(params, batch, labels, *extra):
        if is_dtensor(batch.node_feat):
            from repro_torch.models.gnn.sharded import train_loss
            return train_loss(forward_fn, loss_kind, n_graphs, params, batch,
                              labels, *extra)
        out = forward_fn(params, batch, *extra)
        if loss_kind == "node_ce":
            return node_ce_terms(out, labels).mean()
        energy = scatter_sum(out[:, 0], batch.graph_id, n_graphs + 1)
        return ((energy[:n_graphs] - labels) ** 2).mean()

    return loss_fn


def make_gnn_train_step(forward_fn, loss_kind: str, lr: float = 1e-3,
                        n_graphs: int | None = None):
    """Generic GNN train step: forward -> loss -> gradients of the
    trainable leaves (``split_params``) -> AdamW at ``lr``, in place.
    ``step(params, opt_state, batch, labels, *extra)`` returns (params,
    opt_state, loss): the same trees, updated."""
    loss_fn = make_gnn_loss(forward_fn, loss_kind, n_graphs)
    grad_fn = value_and_grad(
        lambda train, aux, *args: loss_fn({**train, **aux}, *args))

    def step(params, opt_state, batch, labels, *extra):
        train, aux = split_params(params)
        loss, grads = grad_fn(train, aux, batch, labels, *extra)
        adamw_update(grads, opt_state, train, lr=lr)
        return params, opt_state, loss

    return step


# ---------------------------------------------------------------------------
# materialised cells
# ---------------------------------------------------------------------------
class CellData(NamedTuple):
    """One cell's synthetic batch on a device, shared by every arch."""

    batch: GraphBatch
    labels: torch.Tensor
    triplets: object | None     # dimenet.Triplets, or None
    sizes: dict                 # n, m, t as run, real counts, the cuts


class Materialized(NamedTuple):
    step: Callable
    args: tuple                 # (params, opt_state, batch, labels, *extra)
    model_flops: float
    sizes: dict


def _rnd(v: int) -> int:
    return -(-v // PAD) * PAD


def triplet_slots(n: int, m: int) -> int:
    """The reference's triplet capacity of an n-node, m-edge cell."""
    avg_deg = max(int(round(m / max(n, 1))), 1)
    return min(next_bucket(m * min(avg_deg + 1, 32)), MAX_TRIPLETS)


def cell_sizes(shape: dict, cut: int = 1) -> dict:
    """n and m of a cell as run (padded to ``PAD``, then divided by
    ``cut``; a sampled shape's caps at ``batch_nodes // cut`` seeds), the
    real counts before padding, and DimeNet's triplet slots ``t``."""
    if "batch_nodes" in shape:
        n_seeds = shape["batch_nodes"] // cut
        n_real, m_real = sampled_shape_caps(n_seeds, shape["fanout"])
        n, m = _rnd(n_real), _rnd(m_real)
    else:
        n, m = (-(-_rnd(shape[k]) // cut) for k in ("n", "m"))
        n_real, m_real = (-(-shape[k] // cut) for k in ("n", "m"))
    return dict(n=n, m=m, t=triplet_slots(n, m), n_real=n_real,
                m_real=m_real)


def _random_edges(rng, n_real: int, m_real: int):
    """Uniform edges among ``n_real`` nodes, no self-loops."""
    src = rng.integers(0, n_real, m_real)
    dst = (src + 1 + rng.integers(0, n_real - 1, m_real)) % n_real
    return src, dst


def _sampled_edges(shape: dict, rng, seed: int, cut: int):
    """A block drawn by ``NeighborSampler`` from a synthetic in-CSR of
    ``shape``'s n nodes (cut) at a uniform in-degree of its m / n, which
    saturates every fanout; padded to the caps rounded to ``PAD``."""
    deg = int(round(shape["m"] / shape["n"]))
    csr_n = shape["n"] // cut
    indptr = np.arange(csr_n + 1, dtype=np.int64) * deg
    indices = rng.integers(0, csr_n, csr_n * deg, dtype=np.int32)
    n_seeds = shape["batch_nodes"] // cut
    seeds = rng.permutation(csr_n)[:n_seeds]
    caps = cell_sizes(shape, cut)
    blk = NeighborSampler(indptr, indices, seed=seed).sample_padded(
        seeds, shape["fanout"], caps["n"], caps["m"])
    return blk, dict(csr_n=csr_n, csr_m=csr_n * deg, seeds=n_seeds)


def make_gnn_batch(shape: dict, *, device="cuda", seed: int = 0,
                   cut: int = 1, triplets: bool = False) -> CellData:
    """The synthetic batch of one cell, drawn from ``seed``: edges (NumPy)
    uniform among the real nodes without self-loops, or sampled by
    ``NeighborSampler`` for a ``batch_nodes`` shape; features, positions
    (N(0, 1) a coordinate: an edge's length has mean 2.26, so ~99% of
    edges lie within a cutoff of 5) and labels drawn on ``device``.  n and
    m are padded to ``PAD`` as the reference's cells are, then divided by
    ``cut``; a padded edge is ``src = dst = n - 1`` with mask 0, a padded
    node has zero features (and ``graph_id = n_graphs``, which the loss
    leaves out).  With ``triplets`` the DimeNet lists, padded to the
    reference's slot count."""
    from repro_torch.models.gnn.dimenet import build_triplets
    rng = np.random.default_rng(seed)
    gen = torch.Generator(device=device).manual_seed(seed)
    sizes = {}
    if "batch_nodes" in shape:
        blk, sizes["sampled_from"] = _sampled_edges(shape, rng, seed, cut)
        n, m = blk.n_nodes, blk.src.shape[0]
        n_real = int((blk.node_ids >= 0).sum())
        m_real = int(blk.edge_mask.sum())
        src, dst, mask = blk.src, blk.dst, blk.edge_mask
    else:
        sz = cell_sizes(shape, cut)
        n, m, n_real, m_real = sz["n"], sz["m"], sz["n_real"], sz["m_real"]
        if "n_graphs" in shape:     # 128 graphs of 30 nodes and 64 edges
            g = shape["n_graphs"]
            per_n, per_m = n_real // g, m_real // g
            base = np.repeat(np.arange(g) * per_n, per_m)
            s, d_ = _random_edges(rng, per_n, g * per_m)
            src, dst = base + s, base + d_
        else:
            src, dst = _random_edges(rng, n_real, m_real)
        pad = m - m_real
        src = np.concatenate([src, np.full(pad, n - 1)])
        dst = np.concatenate([dst, np.full(pad, n - 1)])
        mask = np.concatenate([np.ones(m_real, np.float32),
                               np.zeros(pad, np.float32)])
    feat = torch.zeros((n, shape["d"]), device=device)
    feat[:n_real] = torch.randn((n_real, shape["d"]), generator=gen,
                                device=device)
    positions = torch.randn((n, 3), generator=gen, device=device)
    graph_id = None
    if "n_graphs" in shape:
        g = shape["n_graphs"]
        graph_id = torch.full((n,), g, dtype=torch.int32, device=device)
        graph_id[:n_real] = torch.arange(n_real, device=device) \
            // (n_real // g)
        labels = torch.randn((g,), generator=gen, device=device)
    else:
        labels = torch.randint(0, shape["classes"], (n,), generator=gen,
                               device=device, dtype=torch.int32)
    batch = GraphBatch(
        node_feat=feat,
        src=torch.as_tensor(src.astype(np.int32), device=device),
        dst=torch.as_tensor(dst.astype(np.int32), device=device),
        edge_mask=torch.as_tensor(mask, device=device),
        positions=positions, graph_id=graph_id)
    trip = None
    t = t_real = 0
    if triplets:
        t = triplet_slots(n, m)     # the real edges come first
        trip = build_triplets(src[:m_real], dst[:m_real], n, cap=t,
                              device=device)
        t_real = int(trip.mask.sum())
    sizes.update(n=n, m=m, t=t, n_real=n_real, m_real=m_real, t_real=t_real,
                 cut=cut, reduced=_reduced(shape, n, m, t, cut))
    return CellData(batch=batch, labels=labels, triplets=trip, sizes=sizes)


def _reduced(shape: dict, n: int, m: int, t: int, cut: int) -> dict:
    """Each size a cut changed, as ``"full -> run"``."""
    if cut == 1:
        return {}
    if "batch_nodes" in shape:
        return {"n": f"{shape['n']} -> {shape['n'] // cut} (in-CSR)",
                "batch_nodes": f"{shape['batch_nodes']} -> "
                               f"{shape['batch_nodes'] // cut}"}
    full_n, full_m = _rnd(shape["n"]), _rnd(shape["m"])
    out = {"n": f"{full_n} -> {n}", "m": f"{full_m} -> {m}"}
    if t:
        out["t"] = f"{triplet_slots(full_n, full_m)} -> {t}"
    return out


def materialize_gnn_train(arch: str, init_fn, forward_fn, shape: dict, *,
                          molecular: bool, with_triplets: bool = False,
                          d_hidden: int, n_layers: int):
    """Builder of one GNN cell, materialised: ``builder(device="cuda", *,
    seed=0, cut=1, data=None)`` returns the step, its arguments (params
    drawn from ``seed``, AdamW state, the batch, labels and DimeNet's
    triplets) and the model FLOPs at the sizes run.  ``data`` (a
    :func:`make_gnn_batch` of the same shape, seed and cut) shares one
    batch between archs; PNA's forward reads no positions."""

    def builder(device="cuda", *, seed: int = 0, cut: int = 1,
                data: CellData | None = None) -> Materialized:
        if data is None:
            data = make_gnn_batch(shape, device=device, seed=seed, cut=cut,
                                  triplets=with_triplets)
        n_graphs = shape.get("n_graphs")
        classes = shape.get("classes")
        d_out = classes if classes else 1
        gen = torch.Generator(device=device).manual_seed(seed)
        params = init_fn(gen, d_in=shape["d"], d_out=d_out, device=device)
        opt = adamw_init(split_params(params)[0])
        batch = data.batch if molecular else data.batch._replace(
            positions=None)
        extra = (data.triplets,) if with_triplets else ()
        step = make_gnn_train_step(
            forward_fn, "graph_mse" if n_graphs else "node_ce",
            n_graphs=n_graphs)
        sz = dict(data.sizes)
        if not with_triplets:       # a shared batch's triplets are unused
            sz.update(t=0, t_real=0, reduced={
                k: v for k, v in sz["reduced"].items() if k != "t"})
        flops = gnn_model_flops(arch, sz["n"], sz["m"], shape["d"], d_hidden,
                                n_layers, "train", sz["t"])
        return Materialized(step=step,
                            args=(params, opt, batch, data.labels, *extra),
                            model_flops=flops, sizes=sz)

    return builder


def cell_builders(arch: str, init_fn, forward_fn, *, molecular: bool,
                  with_triplets: bool = False, d_hidden: int,
                  n_layers: int) -> dict:
    """Every shape's materialising builder of ``arch``, by shape name."""
    return {name: materialize_gnn_train(arch, init_fn, forward_fn, shape,
                                        molecular=molecular,
                                        with_triplets=with_triplets,
                                        d_hidden=d_hidden, n_layers=n_layers)
            for name, shape in SHAPES.items()}


# ---------------------------------------------------------------------------
# the dry-run's cells
# ---------------------------------------------------------------------------
def all_axes(mesh) -> tuple:
    return axis_names(mesh)


def _graph_specs(mesh, *, molecular: bool, n_graphs: int | None = None):
    ax = all_axes(mesh)
    return GraphBatch(
        node_feat=Spec(ax, None), src=Spec(ax), dst=Spec(ax),
        edge_mask=Spec(ax), positions=Spec(ax, None) if molecular else None,
        graph_id=Spec(ax) if n_graphs else None)


def _graph_abstract(n, m, d, *, molecular, n_graphs=None):
    return GraphBatch(
        node_feat=sds((n, d)), src=sds((m,), torch.int32),
        dst=sds((m,), torch.int32), edge_mask=sds((m,)),
        positions=sds((n, 3)) if molecular else None,
        graph_id=sds((n,), torch.int32) if n_graphs else None)


def _map_sds(fn, tree):
    """``fn`` of each :class:`SDS` leaf of ``tree`` (a NamedTuple itself)."""
    return tree_map(fn, tree, is_leaf=lambda x: isinstance(x, SDS))


def abstract(tree):
    """The :class:`SDS` tree of a tree of tensors (``init_fn`` run on the
    meta device)."""
    return tree_map(lambda t: sds(t.shape, t.dtype), tree)


def adamw_abstract(train) -> AdamWState:
    """``adamw_init``'s stand-ins: a 0-d int32 step, fp32 moments."""
    def f32(a):
        return sds(a.shape)
    return AdamWState(step=sds((), torch.int32), mu=_map_sds(f32, train),
                      nu=_map_sds(f32, train))


def build_gnn_train(arch: str, init_fn, forward_fn, shape: dict, *,
                    molecular: bool, with_triplets: bool = False,
                    d_hidden: int, n_layers: int):
    """Builder closure for one GNN cell of the dry-run (``builder(mesh) ->
    Built``): the reference's stand-ins and specs (module docstring), n and
    m padded to ``PAD`` (a sampled shape's caps), DimeNet's triplets at
    :func:`triplet_slots`, model FLOPs at the padded sizes."""

    def builder(mesh):
        from repro_torch.models.gnn.dimenet import Triplets
        ax = all_axes(mesh)
        sz = cell_sizes(shape)
        n, m = sz["n"], sz["m"]
        d = shape["d"]
        n_graphs = shape.get("n_graphs")
        classes = shape.get("classes")
        params_a = abstract(init_fn(torch.Generator(), d_in=d,
                                    d_out=classes if classes else 1,
                                    device="meta"))
        opt_a = adamw_abstract(split_params(params_a)[0])
        batch_a = _graph_abstract(n, m, d, molecular=molecular,
                                  n_graphs=n_graphs)
        batch_s = _graph_specs(mesh, molecular=molecular, n_graphs=n_graphs)
        if n_graphs:
            labels_a, labels_s = sds((n_graphs,)), Spec()
            loss_kind = "graph_mse"
        else:
            labels_a, labels_s = sds((n,), torch.int32), Spec(ax)
            loss_kind = "node_ce"
        extra_a, extra_s = (), ()
        t = 0
        if with_triplets:
            t = sz["t"]
            extra_a = (Triplets(e_in=sds((t,), torch.int32),
                                e_out=sds((t,), torch.int32),
                                mask=sds((t,))),)
            extra_s = (Triplets(e_in=Spec(ax), e_out=Spec(ax),
                                mask=Spec(ax)),)
        fn = make_gnn_train_step(forward_fn, loss_kind, n_graphs=n_graphs)
        in_sh = (_map_sds(lambda _: Spec(), params_a),
                 _map_sds(lambda _: Spec(), opt_a), batch_s,
                 labels_s, *extra_s)
        flops = gnn_model_flops(arch, n, m, d, d_hidden, n_layers, "train",
                                t)
        return Built(fn=fn, args=(params_a, opt_a, batch_a, labels_a,
                                  *extra_a),
                     in_shardings=in_sh, model_flops=flops)

    return builder


def gnn_cells(arch: str, init_fn, forward_fn, *, molecular: bool,
              with_triplets: bool = False, d_hidden: int,
              n_layers: int) -> list[Cell]:
    """The dry-run's four cells of ``arch``, one a shape."""
    return [Cell(arch=arch, shape=name, kind="train",
                 builder=build_gnn_train(arch, init_fn, forward_fn, shape,
                                         molecular=molecular,
                                         with_triplets=with_triplets,
                                         d_hidden=d_hidden,
                                         n_layers=n_layers))
            for name, shape in SHAPES.items()]
