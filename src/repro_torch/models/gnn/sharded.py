"""The GNN train step on ``DTensor`` s, for the dry-run
(``launch/dryrun.py``): the layout of the reference's cells
(``configs/gnn_common.py``), node and edge (and triplet) arrays row-sharded
over every mesh axis flattened, parameters replicated.  Only
:func:`train_loss` enters these paths, and only ``make_gnn_loss`` calls it,
when the batch is made of ``DTensor`` s; every run on real tensors takes
the plain code of ``common.py`` and the models.

The loss runs per shard: one ``local_map`` around the forward and the loss,
each rank holding its rows.  Inside, :func:`active` is set, and the places
where a rank needs rows it does not hold run with the collectives GSPMD
inserts for this layout, over the flattened mesh's group:

- :func:`whole` (the gathers, ``edge_vectors``): a gather of rows by a
  sharded index all-gathers the rows, then indexes locally; its backward
  reduce-scatters the gathered rows' gradient;
- :func:`scatter_sum`: a local partial sum over all destination rows, then
  a reduce-scatter to the destination shards (backward: an all-gather);
- :func:`scatter_max`: the same with a max reduction; its backward gathers
  the maxima and the gradient and splits it over the tied elements of
  every rank (an all-reduce of the tie counts), as ``scatter_reduce_``
  "amax" splits it over one rank's;
- the loss: each rank's sum over its rows, all-reduced to the whole mean
  (:class:`_ReplicatedSum`: every rank then holds the same loss, so the
  backward moves nothing).

The parameters' gradients leave the ``local_map`` as partial sums over the
mesh, and ``train.value_and_grad`` all-reduces them onto the replicated
parameters.  On a group of one rank nothing is exchanged.
``tests/torch_sharded_ranks.py`` runs these paths on real tensors over
four ranks against the plain model.
"""
from __future__ import annotations

import torch
import torch.distributed as dist

# the flattened mesh's process group while a per-shard forward runs
_ACTIVE: list = [None]


def active():
    """The process group of the per-shard forward that is running, or
    None (every run on real tensors)."""
    return _ACTIVE[0]


def _size(group) -> int:
    return dist.get_world_size(group)


def _gather(x: torch.Tensor, group) -> torch.Tensor:
    """``x`` of every rank of ``group``, stacked along dim 0 in rank
    order (``x`` itself on one rank)."""
    if _size(group) == 1:
        return x
    out = x.new_empty((x.shape[0] * _size(group),) + tuple(x.shape[1:]))
    dist.all_gather_into_tensor(out, x.contiguous(), group=group)
    return out


def _reduce_scatter(x: torch.Tensor, group, op=dist.ReduceOp.SUM):
    """This rank's block of rows of ``x`` reduced over ``group`` (``x``
    itself on one rank)."""
    if _size(group) == 1:
        return x
    out = x.new_empty((x.shape[0] // _size(group),) + tuple(x.shape[1:]))
    dist.reduce_scatter_tensor(out, x.contiguous(), op=op, group=group)
    return out


class _GatherRows(torch.autograd.Function):
    """All-gather of row shards; backward: reduce-scatter."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return _gather(x, group)

    @staticmethod
    def backward(ctx, grad):
        return _reduce_scatter(grad, ctx.group), None


class _ScatterRows(torch.autograd.Function):
    """Reduce-scatter (sum) of a partial sum over all rows; backward:
    all-gather."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return _reduce_scatter(x, group)

    @staticmethod
    def backward(ctx, grad):
        return _gather(grad, ctx.group), None


class _ReplicatedSum(torch.autograd.Function):
    """``x`` summed over ``group`` (an all-reduce), the result held alike by
    every rank.  Each rank's loss is then the same function of it, so the
    gradient of each rank's part is the result's own gradient."""

    @staticmethod
    def forward(ctx, x, group):
        x = x.clone()
        if _size(group) > 1:
            dist.all_reduce(x, group=group)
        return x

    @staticmethod
    def backward(ctx, grad):
        return grad, None


class _ScatterMax(torch.autograd.Function):
    """``out[v] = max of v_e over the e with dst[e] == v`` over every rank's
    elements (a local max, then a reduce-scatter with max): this rank's
    rows.  The gradient of each row goes to the elements equal to its
    maximum, split evenly over all of them on every rank (the maxima and
    the gradient all-gathered, the tie counts all-reduced)."""

    @staticmethod
    def forward(ctx, v, dst, n, neutral, group):
        index = dst.view(-1, *(1,) * (v.dim() - 1)).expand_as(v)
        full = v.new_full((n * _size(group),) + tuple(v.shape[1:]), neutral)
        full.scatter_reduce_(0, index, v, "amax")
        out = _reduce_scatter(full, group, dist.ReduceOp.MAX)
        ctx.save_for_backward(v, index, out)
        ctx.group = group
        return out

    @staticmethod
    def backward(ctx, grad):
        v, index, out = ctx.saved_tensors
        top = _gather(out, ctx.group).gather(0, index)
        hit = (v == top).to(grad.dtype)
        count = torch.zeros((out.shape[0] * _size(ctx.group),)
                            + tuple(v.shape[1:]), dtype=grad.dtype,
                            device=grad.device).scatter_add_(0, index, hit)
        if _size(ctx.group) > 1:
            dist.all_reduce(count, group=ctx.group)
        share = _gather(grad, ctx.group) / count.clamp(min=1.0)
        return hit * share.gather(0, index), None, None, None, None


def whole(x: torch.Tensor) -> torch.Tensor:
    """Every rank's rows of ``x`` (an all-gather), for a gather by global
    ids."""
    group = active()
    return x if _size(group) == 1 else _GatherRows.apply(x, group)


def scatter_sum(values: torch.Tensor, dst: torch.Tensor,
                n: int) -> torch.Tensor:
    """``common.scatter_sum`` per shard: ``dst`` global ids of this rank's
    ``values``, ``n`` the rows a rank holds of the destination."""
    group = active()
    p = _size(group)
    full = values.new_zeros((n * p,) + tuple(values.shape[1:]))
    full = full.index_add_(0, dst.long(), values)
    return full if p == 1 else _ScatterRows.apply(full, group)


def scatter_max(values: torch.Tensor, dst: torch.Tensor, n: int,
                neutral: float) -> torch.Tensor:
    """The segment max of ``common.scatter_max`` per shard (``values``
    already masked to ``neutral``)."""
    return _ScatterMax.apply(values, dst.long(), n, neutral, active())


def _flat_group(mesh):
    """The process group of every rank of ``mesh``, in the order its row
    shards are laid out (mesh dims outermost first).  The flattened mesh
    is made (once; the mesh keeps it) from the mesh's rank tensor, outside
    any fake tensor mode a trace runs in."""
    from torch._subclasses.fake_tensor import unset_fake_temporarily
    if mesh.ndim == 1:
        return mesh.get_group(0)
    with unset_fake_temporarily():
        return mesh._flatten().get_group(0)


def train_loss(forward_fn, loss_kind: str, n_graphs, params, batch, labels,
               *extra):
    """``make_gnn_loss``'s loss of ``DTensor`` arguments laid out as the
    reference's cells lay them out, computed per shard (see the module
    docstring); a replicated 0-d ``DTensor``."""
    from torch.distributed.tensor import Partial, Replicate, Shard
    from torch.distributed.tensor.experimental import local_map
    from torch.utils._pytree import tree_flatten, tree_unflatten

    from repro_torch.configs.gnn_common import node_ce_terms
    from .common import scatter_sum as plain_scatter_sum

    mesh = batch.node_feat.device_mesh
    sizes = [mesh.size(i) for i in range(mesh.ndim)]
    rows = [Shard(0) if s > 1 else Replicate() for s in sizes]
    rep = [Replicate()] * mesh.ndim
    part = [Partial() if s > 1 else Replicate() for s in sizes]
    group = _flat_group(mesh)
    p_leaves, p_tree = tree_flatten(params)
    b_leaves = [t for t in batch if t is not None]
    e_leaves, e_tree = tree_flatten(list(extra))
    l_lay = rows if loss_kind == "node_ce" else rep
    n_p, n_b = len(p_leaves), len(b_leaves)

    def local(*ts):
        p = tree_unflatten(list(ts[:n_p]), p_tree)
        it = iter(ts[n_p:n_p + n_b])
        b = type(batch)(*(None if t is None else next(it) for t in batch))
        lab = ts[n_p + n_b]
        ex = tree_unflatten(list(ts[n_p + n_b + 1:]), e_tree)
        _ACTIVE[0] = group
        try:
            out = forward_fn(p, b, *ex)
        finally:
            _ACTIVE[0] = None
        if loss_kind == "node_ce":
            total = _ReplicatedSum.apply(node_ce_terms(out, lab).sum(), group)
            return total / (out.shape[0] * _size(group))
        energy = _ReplicatedSum.apply(
            plain_scatter_sum(out[:, 0], b.graph_id, n_graphs + 1), group)
        return ((energy[:n_graphs] - lab) ** 2).mean()

    lays = [rep] * n_p + [rows] * n_b + [l_lay] + [rows] * len(e_leaves)
    grads = [part] * n_p + lays[n_p:]
    return local_map(local, out_placements=rep, in_placements=tuple(lays),
                     in_grad_placements=tuple(grads), device_mesh=mesh,
                     redistribute_inputs=True)(*p_leaves, *b_leaves, labels,
                                               *e_leaves)
