"""Owner-partitioned message passing over ``torch.distributed``, the port
of ``repro``'s ``models/gnn/partitioned.py``: SchNet trained with
vertices OWNER-partitioned over the ranks of a process group, each edge's
message computed on its SOURCE owner and pushed to the destination owner
with ONE tiled ``all_to_all_single`` a layer.

The exchange carries gradients (``_Exchange``: its backward is the
reverse exchange, which for a tiled all_to_all is the same one).  Each
rank differentiates its *own* loss sum divided by ``P * n_local``, and
one SUM all-reduce of the gradients makes every rank's gradient the
whole loss's, as the reference's ``psum`` of the loss inside
``shard_map`` does.  Differentiating an all-reduced loss on every rank
instead would count every gradient P times.

Index semantics: the reference's packing drops out-of-range writes
(``.at[...].set(mode="drop")``) and its segment sums drop out-of-range
ids; here each such write goes to a trash slot past the buffer, so no
index leaves its tensor (an out-of-range index raises in PyTorch, and is
a device-side assert on a card).  ``overflow`` reports a ``halo_cap``
too small for a destination, as the reference computes it.

Host preparation (``partition_graph_for_push``, ``route_graph_for_push_v2``)
is NumPy and gives the reference's arrays; each rank takes its own row.
"""
from __future__ import annotations

from typing import Callable, NamedTuple

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.ckpt.checkpoint import tree_flatten, tree_unflatten
from repro_torch.train import adamw_update

from .common import cosine_cutoff, gaussian_rbf, mlp, scatter_sum
from .schnet import shifted_softplus


class PartEdges(NamedTuple):
    """Edges grouped by SOURCE owner: ``[P, e_cap]`` on the host, a rank's
    ``[e_cap]`` row on its device."""

    src_local: np.ndarray   # local src id (sentinel n_local)
    dst_global: np.ndarray  # partition-contiguous global dst (sentinel P*n_local)
    dist: np.ndarray        # edge length
    mask: np.ndarray


class RoutedEdges(NamedTuple):
    """Edges grouped ``[src_part, dst_part, cap2]`` on the host, a rank's
    ``[P, cap2]`` block on its device."""

    src_local: np.ndarray   # (sentinel n_local)
    dst_local: np.ndarray   # local id at the DESTINATION owner (sentinel n_local)
    dist: np.ndarray
    mask: np.ndarray


def partition_graph_for_push(n, src, dst, dist_, n_parts):
    """Contiguous ownership (``n_local = ceil(n / P)`` vertices a rank),
    edges grouped by src owner in their order, padded to the largest
    count.  Returns (PartEdges, n_local, e_cap)."""
    n_local = -(-n // n_parts)
    owner = src // n_local
    order = np.argsort(owner, kind="stable")
    src, dst, dist_ = src[order], dst[order], dist_[order]
    counts = np.bincount(owner[order], minlength=n_parts)
    e_cap = int(counts.max())
    sl = np.full((n_parts, e_cap), n_local, dtype=np.int32)
    dg = np.full((n_parts, e_cap), n_parts * n_local, dtype=np.int32)
    dd = np.zeros((n_parts, e_cap), dtype=np.float32)
    mk = np.zeros((n_parts, e_cap), dtype=np.float32)
    off = 0
    for p in range(n_parts):
        c = counts[p]
        sl[p, :c] = (src[off:off + c] - p * n_local)
        dg[p, :c] = dst[off:off + c]
        dd[p, :c] = dist_[off:off + c]
        mk[p, :c] = 1.0
        off += c
    return PartEdges(src_local=sl, dst_global=dg, dist=dd, mask=mk), \
        n_local, e_cap


def route_graph_for_push_v2(n, src, dst, dist_, n_parts):
    """Edges grouped by (src owner, dst owner), each group in edge order,
    padded to the largest group.  Returns (RoutedEdges, n_local, cap2)."""
    n_local = -(-n // n_parts)
    so, do = src // n_local, dst // n_local
    pair = so * n_parts + do
    counts = np.bincount(pair, minlength=n_parts * n_parts)
    cap2 = max(int(counts.max()), 1)
    order = np.argsort(pair, kind="stable")
    start = np.cumsum(counts) - counts
    slot = np.empty_like(order)
    slot[order] = np.arange(order.shape[0]) - start[pair[order]]
    sl = np.full((n_parts, n_parts, cap2), n_local, dtype=np.int32)
    dl = np.full((n_parts, n_parts, cap2), n_local, dtype=np.int32)
    dd = np.zeros((n_parts, n_parts, cap2), dtype=np.float32)
    mk = np.zeros((n_parts, n_parts, cap2), dtype=np.float32)
    sl[so, do, slot] = src - so * n_local
    dl[so, do, slot] = dst - do * n_local
    dd[so, do, slot] = dist_
    mk[so, do, slot] = 1.0
    return RoutedEdges(src_local=sl, dst_local=dl, dist=dd, mask=mk), \
        n_local, cap2


def rank_edges(edges, rank: int, device="cuda"):
    """Rank ``rank``'s row of host edges, as tensors on ``device``."""
    return type(edges)(*(torch.as_tensor(np.ascontiguousarray(a[rank]),
                                         device=device) for a in edges))


def _all_to_all(t: torch.Tensor, group) -> torch.Tensor:
    """Tiled all_to_all: block p of ``t`` (dim 0) goes to group rank p,
    block p of the result came from group rank p."""
    t = t.contiguous()
    out = torch.empty_like(t)
    dist.all_to_all_single(out, t, group=group)
    return out


class _Exchange(torch.autograd.Function):
    """The tiled all_to_all with its transpose as the backward: the
    gradient of block p of the result goes back to group rank p, which is
    the same exchange again."""

    @staticmethod
    def forward(ctx, t, group):
        ctx.group = group
        return _all_to_all(t, group)

    @staticmethod
    def backward(ctx, g):
        return _all_to_all(g, ctx.group), None


def _exchange(t: torch.Tensor, group, grad: bool) -> torch.Tensor:
    return _Exchange.apply(t, group) if grad else _all_to_all(t, group)


def _pack_route(n_parts, n_local, cap, dst_global, vals):
    """Route (global dst, value) -> ``[P, cap]`` per-owner buffers: the
    local id (sentinel n_local) and the value.  A write to the sentinel
    partition or past ``cap`` goes to a trash slot.  Returns (ids, buf,
    overflow)."""
    n_pad = n_parts * n_local
    dg = dst_global.long()
    part = torch.where(dg < n_pad, dg // n_local, n_parts)
    order = torch.argsort(part, stable=True)
    sp = part[order]
    first = torch.searchsorted(sp, sp, side="left")
    pos = torch.arange(sp.shape[0], device=sp.device) - first
    keep = (sp < n_parts) & (pos < cap)
    trash = n_parts * cap
    slot = torch.where(keep, sp * cap + pos, trash)
    ids = torch.full((trash + 1,), n_local, dtype=torch.int32,
                     device=vals.device)
    ids.index_copy_(0, slot, (dg % n_local)[order].to(torch.int32))
    buf = vals.new_zeros((trash + 1,) + tuple(vals.shape[1:]))
    buf = buf.index_copy(0, slot, vals.index_select(0, order))
    # each partition's count from the sorted ids (``bincount``'s output
    # size would depend on the data, which a fake tensor cannot trace)
    bounds = torch.searchsorted(sp, torch.arange(n_parts + 1,
                                                 device=sp.device))
    counts = bounds[1:] - bounds[:-1]
    return (ids[:trash].view(n_parts, cap),
            buf[:trash].view((n_parts, cap) + tuple(vals.shape[1:])),
            (counts > cap).any())


def _aggregate(n_parts, n_local, halo_cap, group, msgs, dst_global):
    """Push messages to their destination owners; returns the local
    aggregate ``[n_local, d]`` and the overflow flag."""
    ids, buf, ovf = _pack_route(n_parts, n_local, halo_cap, dst_global, msgs)
    rid = _exchange(ids, group, grad=False)
    rval = _exchange(buf, group, grad=True)
    flat_v = rval.reshape((-1,) + tuple(rval.shape[2:]))
    agg = scatter_sum(flat_v, rid.reshape(-1), n_local + 1)
    return agg[:n_local], ovf


def _ce_sum(out: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    logits = out.to(torch.promote_types(out.dtype, torch.float32))
    lse = torch.logsumexp(logits, dim=-1)
    gold = logits.gather(-1, labels.long()[:, None])[:, 0]
    return (lse - gold).sum()


class Partitioned(NamedTuple):
    """A partitioned model's step and its gradient alone."""

    train_step: Callable     # (params, opt_state, feat, edges, labels)
    loss_and_grads: Callable  # (params, feat, edges, labels)


def _steps(local_out, n_parts: int, n_local: int, group,
           lr: float) -> Partitioned:
    """The step shared by v1 and v2.  ``loss_and_grads`` differentiates
    this rank's CE sum over ``P * n_local`` (the exchanges' backwards run
    on every rank) and sums every gradient, the loss and the overflow flag
    over the ranks in one all-reduce of a flat buffer: (loss, gradient
    tree, overflow), the same on every rank.  ``train_step`` adds AdamW in
    place.  ``local_out(params, feat, edges) -> (logits, overflow)``."""

    def loss_and_grads(params, feat, edges, labels):
        leaves = [p.detach().requires_grad_() for p in tree_flatten(params)]
        with torch.enable_grad():
            out, ovf = local_out(tree_unflatten(params, leaves), feat, edges)
            loss = _ce_sum(out, labels) / (n_parts * n_local)
            grads = torch.autograd.grad(loss, leaves, allow_unused=True,
                                        materialize_grads=True)
        flat = torch.cat([g.reshape(-1) for g in grads]
                         + [loss.detach().reshape(1),
                            ovf.to(loss.dtype).reshape(1)])
        dist.all_reduce(flat, op=dist.ReduceOp.SUM, group=group)
        parts, off = [], 0
        for g in grads:
            parts.append(flat[off:off + g.numel()].view_as(g))
            off += g.numel()
        return flat[off], tree_unflatten(params, parts), flat[off + 1] > 0

    def train_step(params, opt_state, feat, edges, labels):
        loss, grads, ovf = loss_and_grads(params, feat, edges, labels)
        adamw_update(grads, opt_state, params, lr=lr)
        return params, opt_state, loss, ovf

    return Partitioned(train_step, loss_and_grads)


def make_partitioned_schnet(group=None, *, n_local: int, e_cap: int,
                            halo_cap: int, d_in: int, d_hidden: int = 64,
                            n_interactions: int = 3, n_rbf: int = 300,
                            cutoff: float = 10.0, d_out: int = 47,
                            lr: float = 1e-3):
    """SchNet's train step over ``group`` (default: the world), every
    rank one partition (a :class:`Partitioned`).  ``train_step(params,
    opt_state, feat, edges, labels)`` takes this rank's ``feat [n_local, d_in]``, its
    ``PartEdges`` row (:func:`rank_edges`) and ``labels [n_local]``, and
    returns (params, opt_state, loss, overflow): the parameters and state
    updated in place, the global mean CE before the step and whether any
    rank's ``halo_cap`` overflowed (its messages past the cap are
    dropped).  ``e_cap``, ``d_in`` and ``d_out`` are the rows' shapes;
    the parameters carry them too."""
    n_parts = dist.get_world_size(group)

    def local_out(params, feat, edges: PartEdges):
        h = mlp(params["embed"], feat)
        rbf = gaussian_rbf(edges.dist, n_rbf, cutoff)
        fcut = (cosine_cutoff(edges.dist, cutoff) * edges.mask)[:, None]
        ovf = torch.zeros((), dtype=torch.bool, device=feat.device)
        src_c = edges.src_local.long().clamp(max=n_local - 1)
        for blk in params["blocks"]:
            W = mlp(blk["filter"], rbf, act=shifted_softplus) * fcut
            x = mlp(blk["in_proj"], h)
            agg, o = _aggregate(n_parts, n_local, halo_cap, group,
                                x.index_select(0, src_c) * W,
                                edges.dst_global)
            ovf = ovf | o
            h = h + mlp(blk["out_proj"], agg, act=shifted_softplus)
        return mlp(params["out"], h, act=shifted_softplus), ovf

    return _steps(local_out, n_parts, n_local, group, lr)


def make_partitioned_schnet_v2(group=None, *, n_local: int, cap2: int,
                               d_in: int, d_hidden: int = 64,
                               n_interactions: int = 3, n_rbf: int = 300,
                               cutoff: float = 10.0, d_out: int = 47,
                               lr: float = 1e-3):
    """Pre-routed push: this rank's ``RoutedEdges`` block ``[P, cap2]``
    holds its edges grouped by destination owner, so a layer's messages
    are computed in place (no sort, no scatter) and exchanged with one
    all_to_all; the destination ids are exchanged once a step.  Same step
    signature and returns as :func:`make_partitioned_schnet` (overflow is
    always False: ``cap2`` fits every group)."""
    n_parts = dist.get_world_size(group)

    def local_out(params, feat, edges: RoutedEdges):
        h = mlp(params["embed"], feat)
        d = edges.dist.reshape(-1)
        rbf = gaussian_rbf(d, n_rbf, cutoff)
        fcut = (cosine_cutoff(d, cutoff) * edges.mask.reshape(-1))[:, None]
        src_c = edges.src_local.reshape(-1).long().clamp(max=n_local - 1)
        r_dst = _exchange(edges.dst_local, group, grad=False).reshape(-1)
        for blk in params["blocks"]:
            W = mlp(blk["filter"], rbf, act=shifted_softplus) * fcut
            x = mlp(blk["in_proj"], h)
            msgs = (x.index_select(0, src_c) * W).reshape(n_parts, cap2, -1)
            r_msgs = _exchange(msgs, group, grad=True)
            agg = scatter_sum(r_msgs.reshape(n_parts * cap2, -1), r_dst,
                              n_local + 1)[:n_local]
            h = h + mlp(blk["out_proj"], agg, act=shifted_softplus)
        out = mlp(params["out"], h, act=shifted_softplus)
        return out, torch.zeros((), dtype=torch.bool, device=feat.device)

    return _steps(local_out, n_parts, n_local, group, lr)
