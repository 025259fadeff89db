"""Distributed RIPPLE (paper §5) on a (data, model) mesh of
``torch.distributed`` ranks.

Mapping of the paper's MPI/BSP design onto ranks, as in the JAX package
(whose ``shard_map`` program each rank here runs its own block of):

 - Vertices are partitioned over the ``data`` axis (LDG partitioner +
   partition-contiguous relabeling, so owner(gid) = gid // n_local).
 - The feature dimension is sharded over the ``model`` axis: the UPDATE
   matmul runs row-parallel with a reduce-scatter epilogue over the
   product's *columns* (tensor parallelism).
 - Each BSP superstep (one hop): local frontier edge expansion -> pack
   per-destination-partition message buffers -> ``all_to_all_single`` halo
   exchange -> compact mailboxes -> local apply.  Messages carry *deltas*
   only -- the paper's communication reduction against the pull-based
   recompute baseline (:func:`make_rc_propagate`) with its
   request/response embedding pulls.
 - All buffers have static capacities, the same on every rank; overflow is
   detected exactly and the host retries on a larger rung (never silent
   truncation).

JAX -> torch.distributed: ``axis_index`` is this rank's place in the
axis's group; a tiled ``all_to_all`` is ``all_to_all_single`` with equal
splits; ``psum``/``pmax`` are ``all_reduce`` SUM/MAX; a reduction over
several axes runs over one group made of those axes.  :class:`MeshComm`
makes every group once, collectively, when an engine is built.

Warm-path contracts:

 - **One collective per hop.**  Destination ids ride the halo exchange as
   an extra float32 channel (exact below 2^24).
 - **Gated commit.**  A hop writes H[l+1] (and S, C), which later hops
   read, but the overflow verdict is global and known only after the last
   hop.  So no hop writes: each carries its new rows as an overlay that
   later hops read through (``device_engine._patched``), and one gate
   reduced over *all* axes (data AND model: a per-dim pull can overflow on
   one model shard only) then writes every overlay, or sends every write
   to the trash row ``n_local``.  On overflow H, S and C stay bit-equal to
   their values before the batch, so ``donate`` updates in place.
 - **Size feedback.**  Each hop reports its true needed sizes
   ``[rows, edges, halo, pull, pairs]`` (valid even when the attempt
   overflowed), max-reduced over every rank.
 - **One readback per batch.**  The overflow verdict, the sizes, the
   communication counters and the affected ids (all-gathered over the data
   ranks) come back in one int64 vector; the counters that are sums over
   ranks are reduced once per batch, not once per hop.
 - **Hierarchical multipod halo.**  With ``data_axes=("pod", "data")`` the
   invertible halo runs in two stages (intra-pod shuffle, combine of
   co-destined deltas, cross-pod exchange); ``xpod`` reports the slots
   crossing pods before/after.
"""
from __future__ import annotations

import math
from typing import NamedTuple

import torch
import torch.distributed as dist

from .aggregators import segment_extremum, segment_sum
from .device_engine import _patch_pos, _patched, _unique_recipients
from .ragged import _masked_pairs, _scatter_cells
from .workloads import Workload

_F32_EXACT = 1 << 24   # ids ride collectives as float32 below this

# the single-tensor collectives, under their newer names where this torch
# has them
_reduce_scatter = getattr(dist, "reduce_scatter_single", None) \
    or dist.reduce_scatter_tensor
_all_gather = getattr(dist, "all_gather_single", None) \
    or dist.all_gather_into_tensor

_GROUPS: dict = {}   # (id(mesh), axes) -> (mesh, group): made once


def _axes_group(mesh, axes: tuple):
    """The process group of ``axes`` of ``mesh`` holding this rank, its
    ranks in row-major order over ``axes`` (group rank == the JAX
    ``axis_index`` of that axis tuple).  Made once per (mesh, axes):
    creating a group is collective, and every rank takes the same path."""
    key = (id(mesh), tuple(axes))
    hit = _GROUPS.get(key)
    if hit is not None and hit[0] is mesh:
        return hit[1]
    names = tuple(mesh.mesh_dim_names)
    if len(axes) == 1:
        group = mesh.get_group(axes[0])
    else:
        dims = [names.index(a) for a in axes]
        rest = [i for i in range(len(names)) if i not in dims]
        ranks = mesh.mesh.permute(rest + dims).reshape(
            -1, math.prod(mesh.mesh.shape[i] for i in dims)).tolist()
        if any(r != sorted(r) for r in ranks):
            raise ValueError(f"axes {axes} must follow the mesh's dimension "
                             f"order {names}")
        group, _ = dist.new_subgroups_by_enumeration(ranks)
    _GROUPS[key] = (mesh, group)
    return group


class MeshComm:
    """This rank's place in a mesh and the collectives of its axes.

    ``data`` spans ``data_axes`` (the vertex partition; group rank ==
    partition id), ``model`` the feature shards, ``all`` both (reductions
    the JAX package runs over every mesh axis).  With two data axes the
    hierarchical halo also uses ``pod`` and ``leaf`` (the first and second
    data axis)."""

    def __init__(self, mesh, data_axes: tuple = ("data",)):
        names = tuple(mesh.mesh_dim_names or ())
        data_axes = tuple(data_axes)
        missing = [a for a in data_axes if a not in names]
        if missing or "model" not in names:
            raise ValueError(f"mesh axes {names} must include 'model' and "
                             f"data axes {data_axes}")
        shape = dict(zip(names, mesh.mesh.shape))
        self.mesh = mesh
        self.data_axes = data_axes
        self.n_parts = math.prod(shape[a] for a in data_axes)
        self.M = shape["model"]
        self.device = torch.device(mesh.device_type) \
            if mesh.device_type != "cuda" \
            else torch.device("cuda", torch.cuda.current_device())
        coord = dict(zip(names, mesh.get_coordinate()))
        self.me = 0
        for a in data_axes:
            self.me = self.me * shape[a] + coord[a]
        self.m = coord["model"]
        self.rank = dist.get_rank()
        self.data = _axes_group(mesh, data_axes)
        self.model = _axes_group(mesh, ("model",))
        self.all = _axes_group(mesh, data_axes + ("model",))
        self.world = _axes_group(mesh, names)
        self.hier = len(data_axes) == 2
        if self.hier:
            self.Np, self.Nd = shape[data_axes[0]], shape[data_axes[1]]
            self.me_p, self.me_d = coord[data_axes[0]], coord[data_axes[1]]
            self.pod = _axes_group(mesh, data_axes[:1])
            self.leaf = _axes_group(mesh, data_axes[1:])

    @property
    def writer(self) -> bool:
        """The mesh's first rank: the one that writes shared files."""
        return self.rank == int(self.mesh.mesh.flatten()[0])

    def barrier(self) -> None:
        dist.barrier(group=self.world)

    def psum(self, t: torch.Tensor, group) -> torch.Tensor:
        t = t.clone()
        dist.all_reduce(t, op=dist.ReduceOp.SUM, group=group)
        return t

    def pmax(self, t: torch.Tensor, group) -> torch.Tensor:
        t = t.clone()
        dist.all_reduce(t, op=dist.ReduceOp.MAX, group=group)
        return t

    def a2a(self, t: torch.Tensor, group) -> torch.Tensor:
        """Tiled all_to_all: block p of ``t`` (dim 0) goes to group rank p,
        and block p of the result came from group rank p."""
        t = t.contiguous()
        out = torch.empty_like(t)
        dist.all_to_all_single(out, t, group=group)
        return out

    def gather(self, t: torch.Tensor, group) -> torch.Tensor:
        """All-gather: ``[group size, *t.shape]`` in group rank order."""
        size = dist.get_world_size(group)
        out = t.new_empty((size * t.shape[0],) + tuple(t.shape[1:]))
        _all_gather(out, t.contiguous(), group=group)
        return out.view((size,) + tuple(t.shape))

    def reduce_scatter_cols(self, y: torch.Tensor) -> torch.Tensor:
        """``psum_scatter(y, "model", scatter_dimension=1, tiled=True)``:
        sum ``y [R, D]`` over the model ranks and keep this rank's block of
        D / M *columns*.  The collective scatters along dim 0, so the
        column blocks are laid out first as a contiguous ``[M, R, D/M]``
        (flattened to ``[M * R, D/M]``: block m is rows m*R..(m+1)*R)."""
        R, D = y.shape
        blocks = y.reshape(R, self.M, D // self.M).transpose(0, 1) \
            .reshape(self.M * R, D // self.M)
        out = y.new_empty((R, D // self.M))
        _reduce_scatter(out, blocks, group=self.model)
        return out


# ---------------------------------------------------------------------------
# Tensor-parallel UPDATE functions (row-parallel matmul + reduce-scatter)
# ---------------------------------------------------------------------------
def tp_update(comm: MeshComm, workload: Workload, params_l: dict, layer: int,
              h_prev: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """UPDATE with d_in sharded over the model ranks; returns this rank's
    d_out / M column shard."""
    last = layer == workload.spec.n_layers - 1
    fam = workload.family

    def rp_matmul(a, w):  # row-parallel: a [R, d_in/M] @ w [d_in/M, d_out]
        return comm.reduce_scatter_cols(a @ w)

    if fam == "gc":
        out = rp_matmul(x, params_l["w"]) + params_l["b"]
    elif fam == "sage":
        out = rp_matmul(h_prev, params_l["w_self"]) \
            + rp_matmul(x, params_l["w_nbr"]) + params_l["b"]
    elif fam == "gin":
        z = (1.0 + params_l["eps"]) * h_prev + x
        h1 = torch.relu(rp_matmul(z, params_l["w1"]) + params_l["b1"])
        out = rp_matmul(h1, params_l["w2"]) + params_l["b2"]
    else:
        raise ValueError(fam)
    return out if last else torch.relu(out)


def tp_param_shards(params_np: list[dict], M: int, m: int) -> list[dict]:
    """Model rank ``m``'s parameter shards (the JAX package's
    ``tp_param_specs``): weights row-sharded, biases column-sharded, GIN's
    eps replicated."""
    out = []
    for l, p in enumerate(params_np):
        shard = {}
        for k, v in p.items():
            if v.ndim and v.shape[0] % M:
                raise ValueError(f"layer {l} {k!r}: {v.shape[0]} rows do "
                                 f"not split over {M} model ranks")
            rows = v.shape[0] // M if v.ndim else 0
            shard[k] = v[rows * m: rows * (m + 1)] if v.ndim else v
        out.append(shard)
    return out


# ---------------------------------------------------------------------------
# Local primitives (no collectives)
# ---------------------------------------------------------------------------
def _pack_by_partition(n_parts: int, n_local: int, cap: int,
                       dst_global: torch.Tensor, vals: torch.Tensor):
    """Route a (global-dst, value) stream into [P, cap] per-owner buffers.

    Returns (ids [P, cap] local-sentinel-padded, vals [P, cap, ...],
    counts [P], overflow).  Sentinel dst (>= P * n_local) is dropped."""
    n_pad = n_parts * n_local
    part = torch.where(dst_global < n_pad, dst_global // n_local, n_parts)
    return _pack_buckets(n_parts, cap, part, dst_global % n_local, n_local,
                         vals)


def _scatter_buckets(n_buckets: int, cap: int, bucket: torch.Tensor,
                     pos: torch.Tensor, key: torch.Tensor,
                     key_sentinel: int, vals: torch.Tensor):
    """``[n_buckets, cap]`` key and value buffers with entry i at
    ``(bucket[i], pos[i])``; entries of bucket ``n_buckets`` or past ``cap``
    land in a trash row / column that is cut off (``mode="drop"``)."""
    at = (bucket, pos.clamp(max=cap))
    keys = torch.full((n_buckets + 1, cap + 1), key_sentinel,
                      dtype=torch.int64, device=key.device)
    keys[at] = key.to(torch.int64)
    buf = torch.zeros((n_buckets + 1, cap + 1) + tuple(vals.shape[1:]),
                      dtype=vals.dtype, device=vals.device)
    buf[at] = vals
    return keys[:n_buckets, :cap], buf[:n_buckets, :cap]


def _pack_buckets(n_buckets: int, cap: int, bucket: torch.Tensor,
                  key: torch.Tensor, key_sentinel: int, vals: torch.Tensor):
    """Route a (bucket, key, value) stream into ``[n_buckets, cap]`` buffers
    (``bucket == n_buckets`` drops the entry; key slots pad with
    ``key_sentinel``).

    The per-bucket slot of each entry is its running occurrence count,
    from one cumulative sum over the stream per bucket (the JAX package
    scans a one-hot ``[N, n_buckets + 1]`` matrix down its rows; on a card
    that scan runs one thread per column) -- no sort, and no permutation
    of the d-wide payload.  Entries keep stream order within a bucket, as
    a stable sort by bucket would; :func:`_pack_buckets_sorted` covers
    more than 64 buckets.  Returns (keys, vals, counts [n_buckets],
    overflow)."""
    if n_buckets > 64:
        return _pack_buckets_sorted(n_buckets, cap, bucket, key,
                                    key_sentinel, vals)
    pos = torch.zeros_like(bucket)
    counts = []
    for b in range(n_buckets):
        hit = bucket == b
        run = torch.cumsum(hit, 0)
        pos = torch.where(hit, run - 1, pos)
        counts.append(run[-1])
    counts = torch.stack(counts)
    keys, buf = _scatter_buckets(n_buckets, cap, bucket, pos, key,
                                 key_sentinel, vals)
    return keys, buf, counts, (counts > cap).any()


def _pack_buckets_sorted(n_buckets: int, cap: int, bucket: torch.Tensor,
                         key: torch.Tensor, key_sentinel: int,
                         vals: torch.Tensor):
    """Sort-based :func:`_pack_buckets` for bucket counts where the one-hot
    running-count matrix would dominate."""
    order = torch.sort(bucket, stable=True).indices
    sb, sk, sv = bucket[order], key[order], vals[order]
    first = torch.searchsorted(sb, sb, right=False)
    pos = torch.arange(sb.shape[0], device=sb.device) - first
    counts = torch.bincount(sb, minlength=n_buckets + 1)[:n_buckets]
    keys, buf = _scatter_buckets(n_buckets, cap, sb, pos, sk, key_sentinel,
                                 sv)
    return keys, buf, counts, (counts > cap).any()


def _compact(n: int, all_dst: torch.Tensor, all_val: torch.Tensor,
             r_cap: int):
    """Recipient compaction: (rec_idx [r_cap] ascending unique destinations,
    sentinel-n padded; mailbox [r_cap, ...] their summed values;
    n_recipients).  The regime follows the message count as in the JAX
    package: a presence mask over the n rows when there are at least n / 2
    messages, a sort below that (:func:`device_engine._unique_recipients`);
    the mailbox sums into r_cap rows either way."""
    rec_idx, pos, n_rec = _unique_recipients(n, all_dst, r_cap)
    mailbox = segment_sum(all_val, pos[all_dst.clamp(max=n)], r_cap)
    return rec_idx, mailbox, n_rec


def _per_hop(cap, n_hops: int) -> tuple:
    """Normalize a capacity knob (one int, or one per hop) to a tuple."""
    if isinstance(cap, (tuple, list)):
        if len(cap) != n_hops:
            raise ValueError(f"expected {n_hops} per-hop caps, got {cap}")
        return tuple(int(c) for c in cap)
    return (int(cap),) * n_hops


def _ragged(csum: torch.Tensor, degs: torch.Tensor, cap: int, n_rows: int):
    """Slot j of a ``cap`` bucket holds entry ``off[j]`` of row ``fid[j]``
    of a ragged expansion with per-row counts ``degs`` (running sum
    ``csum``); ``valid[j]`` while j < the total."""
    e = torch.arange(cap, device=csum.device, dtype=csum.dtype)
    fid = torch.searchsorted(csum, e, right=True).clamp(max=n_rows - 1)
    off = e - (csum[fid] - degs[fid])
    return fid, off, e < csum[-1]


def _local_frontier_messages(n_local: int, n_pad: int, h_pre: torch.Tensor,
                             col, w, start, length,
                             frontier: torch.Tensor, delta: torch.Tensor,
                             add_src, add_dst, add_w, del_src, del_dst, del_w,
                             *, weighted: bool, self_dep: bool, e_cap: int,
                             my_part: int):
    """Local-shard message stream (dsts in GLOBAL relabeled id space):
    frontier deltas along out-edges, plus the batch's edge adds (+h_old)
    and deletes (-h_old), plus zero self-messages for self-dependent
    workloads.

    ``h_pre`` is the layer's embedding before the batch, which is the
    h_old an add or delete carries.  (The JAX package passes the layer as
    written by the previous hop and subtracts the frontier's delta, the
    same rows up to rounding.)  Returns (dst [N], vals [N, d], edges
    needed)."""
    degs = torch.where(frontier < n_local,
                       length[frontier.clamp(max=n_local - 1)], 0)
    csum = torch.cumsum(degs, 0)
    fid, off, evalid = _ragged(csum, degs, e_cap, frontier.shape[0])
    vsrc = frontier[fid]
    flat = torch.where(evalid, start[vsrc.clamp(max=n_local - 1)] + off, 0)
    edst = torch.where(evalid, col[flat], n_pad)
    ew = w[flat] if weighted else torch.ones(e_cap, dtype=h_pre.dtype,
                                             device=h_pre.device)
    evals = delta[fid] * (ew * evalid)[:, None]

    def h_old(src):
        return h_pre[src.clamp(max=n_local - 1)]

    aw = add_w if weighted else torch.ones_like(add_w)
    dw = del_w if weighted else torch.ones_like(del_w)
    a_val = h_old(add_src) * aw[:, None] * (add_src < n_local)[:, None]
    d_val = -h_old(del_src) * dw[:, None] * (del_src < n_local)[:, None]

    dsts = [edst, add_dst, del_dst]
    vals = [evals, a_val, d_val]
    if self_dep:
        dsts.append(torch.where(frontier < n_local,
                                my_part * n_local + frontier, n_pad))
        vals.append(torch.zeros_like(delta))
    return torch.cat(dsts), torch.cat(vals), csum[-1]


# ---------------------------------------------------------------------------
# Collective primitives
# ---------------------------------------------------------------------------
def _exchange(comm: MeshComm, ids: torch.Tensor, vals: torch.Tensor, group):
    """BSP halo exchange: block p of my buffers goes to group rank p."""
    return comm.a2a(ids, group), comm.a2a(vals, group)


def _exchange_fused(comm: MeshComm, ids: torch.Tensor, vals: torch.Tensor,
                    group, fuse: bool):
    """Halo exchange as ONE collective: the id channel rides the value
    buffer as float32 (exact below 2^24 -- ``fuse`` is the static guard).
    Two collectives above the id bound."""
    if not fuse:
        return _exchange(comm, ids, vals, group)
    packed = torch.cat([ids[..., None].to(vals.dtype), vals], dim=2)
    r = comm.a2a(packed, group)
    return r[..., 0].to(torch.int64), r[..., 1:]


class DistCSR(NamedTuple):
    """This rank's block of a partitioned adjacency half."""

    col: torch.Tensor     # [pool] int64 global relabeled dst ids (n_pad pads)
    w: torch.Tensor       # [pool] f32
    start: torch.Tensor   # [n_local] int64
    length: torch.Tensor  # [n_local] int64


def _pull_in_neighbors(comm: MeshComm, n_local: int, n_pad: int, read_rows,
                       in_csr: DistCSR, aff_c: torch.Tensor,
                       degs: torch.Tensor, pull_cap: int, r_cap: int):
    """Ragged in-CSR expansion of the given rows + request/response pull of
    the (possibly remote) source embeddings -- RC's pull-everything
    re-aggregation and the monotonic rc baseline.

    ``aff_c [r_cap]`` are clamped local row ids, ``degs`` their pull counts
    (0 skips a row); ``read_rows(idx)`` reads this rank's current layer
    rows for the requests it answers.  The request ships (id, slot) fused,
    the response values only (the tiled round trip keeps block order, so
    reply row p aligns with the requests packed for owner p).  Returns
    (got [pull_cap, d], src_g, fid, evalid, ew, remote request slots of
    this rank, needed lane/bucket size, overflow)."""
    P = n_pad // n_local
    csum = torch.cumsum(degs, 0)
    total = csum[-1]
    fid, off, evalid = _ragged(csum, degs, pull_cap, r_cap)
    flat = torch.where(evalid, in_csr.start[aff_c[fid]] + off, 0)
    src_g = torch.where(evalid, in_csr.col[flat], n_pad)
    ew = in_csr.w[flat]

    lanes = torch.arange(pull_cap, device=degs.device,
                         dtype=torch.float32)[:, None]
    req_ids, req_slot, counts, ovf = _pack_by_partition(
        P, n_local, pull_cap, src_g, lanes)
    remote = counts.sum() - counts[comm.me]
    r_req, _ = _exchange_fused(comm, req_ids, req_slot, comm.data,
                               n_local < _F32_EXACT)
    vals_resp = read_rows(r_req.reshape(-1)).reshape(r_req.shape + (-1,)) \
        * (r_req < n_local)[..., None]
    back = comm.a2a(vals_resp, comm.data)
    slot = req_slot[..., 0].to(torch.int64).reshape(-1)
    filled = (req_ids < n_local).reshape(-1)
    got = torch.zeros((pull_cap + 1, back.shape[-1]), dtype=back.dtype,
                      device=back.device)
    got[torch.where(filled, slot, pull_cap)] = back.reshape(-1,
                                                            back.shape[-1])
    needed = torch.maximum(total, counts.max())
    return got[:pull_cap], src_g, fid, evalid, ew, remote, needed, \
        (total > pull_cap) | ovf


def _pull_in_neighbor_dims(comm: MeshComm, n_local: int, n_pad: int,
                           read_cells, in_csr: DistCSR,
                           rows_c: torch.Tensor, dims: torch.Tensor,
                           degs: torch.Tensor, pull_cap: int, pd_cap: int):
    """Per-(row, dim) SHRINK re-aggregation pull -- the dim-masked sibling
    of :func:`_pull_in_neighbors`.

    ``rows_c [pd_cap]`` are clamped local row ids of the (row, dim) pairs
    being re-derived, ``dims`` their local feature dims, ``degs`` the
    per-pair pull counts (0 skips a pair).  Each pulled lane requests ONE
    scalar ``H[src, dim]`` from the source's owner (``read_cells(idx,
    dim)``): the request carries (id, lane, dim), the response a single
    float32.  Returns (got [pull_cap], src_g, fid, evalid, remote request
    slots of this rank, needed lane/bucket size, overflow)."""
    P = n_pad // n_local
    csum = torch.cumsum(degs, 0)
    total = csum[-1]
    fid, off, evalid = _ragged(csum, degs, pull_cap, pd_cap)
    flat = torch.where(evalid, in_csr.start[rows_c[fid]] + off, 0)
    src_g = torch.where(evalid, in_csr.col[flat], n_pad)
    dim_e = dims[fid]

    payload = torch.stack([
        torch.arange(pull_cap, device=degs.device, dtype=torch.float32),
        dim_e.to(torch.float32)], dim=1)
    req_ids, req_pay, counts, ovf = _pack_by_partition(
        P, n_local, pull_cap, src_g, payload)
    remote = counts.sum() - counts[comm.me]
    r_req, r_pay = _exchange_fused(comm, req_ids, req_pay, comm.data,
                                   n_local < _F32_EXACT)
    scal = read_cells(r_req.reshape(-1),
                      r_pay[..., 1].to(torch.int64).reshape(-1)) \
        .reshape(r_req.shape) * (r_req < n_local)
    back = comm.a2a(scal[..., None], comm.data)
    slot = req_pay[..., 0].to(torch.int64).reshape(-1)
    filled = (req_ids < n_local).reshape(-1)
    got = torch.zeros(pull_cap + 1, dtype=back.dtype, device=back.device)
    got[torch.where(filled, slot, pull_cap)] = back.reshape(-1)
    needed = torch.maximum(total, counts.max())
    return got[:pull_cap], src_g, fid, evalid, remote, needed, \
        (total > pull_cap) | ovf


# ---------------------------------------------------------------------------
# Shared plumbing of the three propagates
# ---------------------------------------------------------------------------
class DistBatch(NamedTuple):
    """This rank's block of a routed batch; the index/weight channels
    travel packed ([5, cap] int64 / [2, cap] f32) and the fields are
    views."""

    ints: torch.Tensor      # feat_idx, add_src, add_dst, del_src, del_dst
    ws: torch.Tensor        # add_w, del_w
    feat_val: torch.Tensor  # [cap, d0 / M]

    @property
    def feat_idx(self):     # local ids (sentinel n_local)
        return self.ints[0]

    @property
    def add_src(self):      # local ids
        return self.ints[1]

    @property
    def add_dst(self):      # GLOBAL relabeled ids (sentinel n_pad)
        return self.ints[2]

    @property
    def del_src(self):
        return self.ints[3]

    @property
    def del_dst(self):
        return self.ints[4]

    @property
    def add_w(self):
        return self.ws[0]

    @property
    def del_w(self):
        return self.ws[1]


def _overlay_reader(n_local: int, base: torch.Tensor, patch):
    """Rows of ``base`` as the previous hop left them: its overlay
    ``patch = (ids, rows)`` read through, the state itself untouched."""
    pos = _patch_pos(n_local, patch[0])

    def rows(idx):
        return _patched(n_local, base, pos, patch[1], idx)

    def cells(idx, dim):
        idx_c = idx.clamp(max=n_local - 1)
        dim = dim.clamp(0, base.shape[1] - 1)
        slot = pos[idx_c]
        return torch.where(slot >= 0, patch[1][slot.clamp(min=0), dim],
                           base[idx_c, dim])
    return rows, cells


def _gated_commit(comm: MeshComm, n_local: int, overflow: torch.Tensor,
                  H: tuple, S: tuple, C: tuple | None, batch: DistBatch,
                  hops: list, frontier: torch.Tensor, donate: bool):
    """Write every hop's overlay when the verdict, reduced over every mesh
    axis, is "no overflow"; else send every write to the trash row, so H,
    S and C keep their pre-batch bits.  Returns (H, S, C, verdict [1],
    final affected local ids)."""
    ovf_g = comm.psum(overflow.to(torch.int64).view(1), comm.all)
    ok = ovf_g[0] == 0
    if not donate:
        H = tuple(h.clone() for h in H)
        S = tuple(s.clone() for s in S)
        C = None if C is None else tuple(c.clone() for c in C)

    def gate(idx):
        return torch.where(ok, idx, n_local)

    H[0].index_copy_(0, gate(batch.feat_idx), batch.feat_val)
    for l, hop in enumerate(hops):
        rec = gate(hop[0])
        S[l + 1].index_copy_(0, rec, hop[1])
        if C is not None:
            C[l + 1].index_copy_(0, rec, hop[2])
        H[l + 1].index_copy_(0, rec, hop[-1])
    return H, S, C, ovf_g, torch.where(ok, frontier, n_local)


# ---------------------------------------------------------------------------
# Distributed RIPPLE propagate (invertible family)
# ---------------------------------------------------------------------------
def make_ripple_propagate(comm: MeshComm, workload: Workload, n_local: int,
                          caps: tuple, halo_cap, *, donate: bool = False):
    """The distributed propagate for a fixed geometry and cap schedule.

    ``caps[l] = (rows, edges)`` per hop; ``halo_cap`` one capacity or one
    per hop.  With two data axes (and ids exact in float32) the halo runs
    hierarchically.  Returns ``fn(params, H, S, k, csr, batch) -> (H, S,
    report)`` with ``report`` the int64 vector ``[ovf, comm [L], sizes
    [L, 5], xpod [2], final [P, rows_L]]``."""
    n_parts = comm.n_parts
    n_pad = n_parts * n_local
    fuse = n_local < _F32_EXACT
    hier = comm.hier and n_pad < _F32_EXACT
    spec = workload.spec
    L = spec.n_layers
    halo_caps = _per_hop(halo_cap, L)

    def halo(dst_g, vals, hc):
        """One halo step at capacity ``hc``: (mdst local ids, mval, remote
        slots of this rank, xpod [before, after], needed bucket size,
        overflow)."""
        d = vals.shape[1:]
        if not hier:
            ids, buf, counts, ovf = _pack_by_partition(
                n_parts, n_local, hc, dst_g, vals)
            rid, rval = _exchange_fused(comm, ids, buf, comm.data, fuse)
            return (rid.reshape(-1), rval.reshape((-1,) + d),
                    counts.sum() - counts[comm.me],
                    torch.zeros(2, dtype=torch.int64, device=vals.device),
                    counts.max(), ovf)
        Np, Nd = comm.Np, comm.Nd
        valid = dst_g < n_pad
        part = torch.where(valid, dst_g // n_local, n_parts)
        cross_before = (valid & (part // Nd != comm.me_p)).sum()
        # stage 1: intra-pod shuffle to the destination's data slot
        b1 = torch.where(valid, part % Nd, Nd)
        k1, v1, c1, ovf = _pack_buckets(Nd, hc, b1, dst_g, n_pad, vals)
        r1, rv1 = _exchange_fused(comm, k1, v1, comm.leaf, True)
        # combine co-destined deltas before they cross pods
        g1, m1, n1 = _compact(n_pad, r1.reshape(-1), rv1.reshape((-1,) + d),
                              hc)
        ovf = ovf | (n1 > hc)
        # stage 2: cross-pod exchange to the destination's pod
        b2 = torch.where(g1 < n_pad, g1 // (n_local * Nd), Np)
        k2, v2, c2, ovf2 = _pack_buckets(Np, hc, b2, g1 % n_local, n_local,
                                         m1)
        r2, rv2 = _exchange_fused(comm, k2, v2, comm.pod, True)
        cross_after = c2.sum() - c2[comm.me_p]
        needed = torch.maximum(torch.maximum(c1.max(), n1), c2.max())
        return (r2.reshape(-1), rv2.reshape((-1,) + d),
                c1.sum() - c1[comm.me_d] + cross_after,
                torch.stack([cross_before, cross_after]), needed,
                ovf | ovf2)

    @torch.no_grad()
    def run(params, H, S, k, csr: DistCSR, batch: DistBatch):
        fv = batch.feat_idx
        old = H[0][fv.clamp(max=n_local - 1)]
        delta = (batch.feat_val - old) * (fv < n_local)[:, None]
        patch = (fv, batch.feat_val)
        frontier = fv
        overflow = torch.zeros((), dtype=torch.bool, device=fv.device)
        remote, sizes, hops = [], [], []
        xpod = torch.zeros(2, dtype=torch.int64, device=fv.device)
        for l in range(L):
            r_cap, e_cap = caps[l]
            dst_g, vals, needed = _local_frontier_messages(
                n_local, n_pad, H[l], csr.col, csr.w, csr.start, csr.length,
                frontier, delta, batch.add_src, batch.add_dst, batch.add_w,
                batch.del_src, batch.del_dst, batch.del_w,
                weighted=spec.weighted, self_dep=spec.self_dependent,
                e_cap=e_cap, my_part=comm.me)
            mdst, mval, rem, xp, h_need, ovf = halo(dst_g, vals,
                                                    halo_caps[l])
            xpod = xpod + xp
            remote.append(rem)
            rec_idx, mailbox, n_rec = _compact(n_local, mdst, mval, r_cap)
            overflow = overflow | (needed > e_cap) | ovf | (n_rec > r_cap)
            sizes.append(torch.stack([n_rec, needed, h_need,
                                      torch.zeros_like(n_rec),
                                      torch.zeros_like(n_rec)]))
            aff_c = rec_idx.clamp(max=n_local - 1)
            valid = (rec_idx < n_local)[:, None]
            S_rows = S[l + 1][aff_c] + mailbox
            x = S_rows / torch.clamp(k[aff_c], min=1.0)[:, None] \
                if spec.aggregator == "mean" else S_rows
            h_prev = _overlay_reader(n_local, H[l], patch)[0](rec_idx)
            h_new = tp_update(comm, workload, params[l], l, h_prev, x)
            delta = (h_new - H[l + 1][aff_c]) * valid
            hops.append((rec_idx, S_rows, h_new))
            patch = (rec_idx, h_new)
            frontier = rec_idx

        H, S, _, ovf_g, final = _gated_commit(
            comm, n_local, overflow, H, S, None, batch, hops, frontier,
            donate)
        sz = comm.pmax(torch.stack(sizes), comm.all)
        by_data = comm.psum(torch.cat([torch.stack(remote), xpod]),
                            comm.data)
        report = torch.cat([ovf_g, by_data[:L], sz.flatten(), by_data[L:],
                            comm.gather(final, comm.data).flatten()])
        return H, S, report

    return run


# ---------------------------------------------------------------------------
# Distributed monotonic (max/min) propagation: candidate-extremum mailboxes
# + SHRINK re-aggregation pulls (see core/aggregators.py for the algebra)
# ---------------------------------------------------------------------------
def make_monotonic_propagate(comm: MeshComm, workload: Workload,
                             n_local: int, caps: tuple, halo_cap,
                             pull_cap: int, pd_cap: int = 0, *,
                             rc: bool = False, donate: bool = False):
    """Distributed GROW/SHRINK propagation for max/min workloads.

    Mailboxes ship *candidate extrema* (value + global source id + delete
    flag) to each destination's owner, which classifies every message
    against its tracked (S, C) rows per (row, dim).  Shrunk cells first run
    the re-cover probe; the survivors re-aggregate through per-dim
    request/response pulls of ONE scalar each (``pd_cap`` pairs,
    ``pull_cap`` pulled elements).  The feature dims are sharded over the
    model ranks, so each re-derives its own shrunk dims; only the
    row-level propagation decision and the overflow gate cross the model
    axis.  ``rc=True`` is the unfiltered baseline: every affected row
    re-aggregates a full row through the row-sized pull path and the
    frontier never filters.

    Contributor ids ride the halo as float32, so the relabeled id space
    must stay below 2^24.  Returns ``fn(params, H, S, C, k, out_csr,
    in_csr, batch) -> (H, S, C, report)`` with ``report`` the int64 vector
    ``[ovf, comm [3L], sstats [4], sizes [L, 5], final [P, rows_L]]``;
    ``comm`` is per hop [halo slots, pull requests, pull response
    scalars], ``sstats`` (shrink_events, rows_reaggregated,
    dims_reaggregated, recover_hits)."""
    n_parts = comm.n_parts
    n_pad = n_parts * n_local
    if n_pad >= _F32_EXACT:
        raise ValueError(
            f"monotonic propagate: padded id space {n_pad} exceeds 2^24 -- "
            "contributor ids ride the halo as float32 and would lose "
            "exactness; shard the graph over more partitions")
    spec = workload.spec
    agg = workload.agg
    sign = agg.sign
    L = spec.n_layers
    halo_caps = _per_hop(halo_cap, L)

    def model_any(mask):
        """Rows where ANY of the full d dims (spread over the model
        ranks) is set."""
        return comm.psum(mask.to(torch.int32), comm.model) > 0

    @torch.no_grad()
    def run(params, H, S, C, k, out_csr: DistCSR, in_csr: DistCSR,
            batch: DistBatch):
        dev = H[0].device
        me = comm.me
        fv = batch.feat_idx
        old = H[0][fv.clamp(max=n_local - 1)]
        patch = (fv, batch.feat_val)
        if rc:
            frontier = fv
        else:   # no-op feature writes stop at hop 0
            changed0 = model_any((batch.feat_val != old).any(dim=1)
                                 & (fv < n_local))
            frontier = torch.where(changed0, fv, n_local)
        overflow = torch.zeros((), dtype=torch.bool, device=dev)
        zero = torch.zeros((), dtype=torch.int64, device=dev)
        halo_rem, pull_rem, sizes, hops = [], [], [], []
        # summed over the model ranks once, after the last hop: per-hop
        # message/row masks (shrink_events, rows_reaggregated) and counts
        shrink_masks, reagg_masks, model_counts = [], [], []
        rc_rows = zero

        for l in range(L):
            r_cap, e_cap = caps[l]
            d_loc = H[l].shape[1]
            read_rows, read_cells = _overlay_reader(n_local, H[l], patch)

            # ---- local frontier out-edge expansion (global dst ids) ------
            degs = torch.where(frontier < n_local, out_csr.length[
                frontier.clamp(max=n_local - 1)], 0)
            csum = torch.cumsum(degs, 0)
            total = csum[-1]
            fid, off, evalid = _ragged(csum, degs, e_cap, frontier.shape[0])
            vsrc = frontier[fid]
            flat = torch.where(evalid, out_csr.start[
                vsrc.clamp(max=n_local - 1)] + off, 0)
            edst_g = torch.where(evalid, out_csr.col[flat], n_pad)
            esrc_l = torch.where(evalid, vsrc, n_local)

            # ---- unified message stream (frontier + adds: candidates and
            #      probes; deletes: probes only), payload [val, src_g, del]
            dst_g = torch.cat([edst_g, batch.add_dst, batch.del_dst])
            src_l = torch.cat([esrc_l, batch.add_src, batch.del_src])
            n_cand = e_cap + batch.add_src.shape[0]
            is_del = (torch.arange(dst_g.shape[0], device=dev)
                      >= n_cand).to(torch.float32)
            mvalid = (src_l < n_local) & (dst_g < n_pad)
            src_g = torch.where(mvalid, me * n_local + src_l, n_pad)
            payload = torch.cat([read_rows(src_l),
                                 src_g[:, None].to(torch.float32),
                                 is_del[:, None]], dim=1)
            dst_g = torch.where(mvalid, dst_g, n_pad)

            ids, buf, counts, ovf = _pack_by_partition(
                n_parts, n_local, halo_caps[l], dst_g, payload)
            halo_rem.append(counts.sum() - counts[me])
            rid, rpay = _exchange_fused(comm, ids, buf, comm.data, True)
            mdst = rid.reshape(-1)
            rpay = rpay.reshape(-1, d_loc + 2)
            rval_ms = sign * rpay[:, :d_loc]
            rsrc_g = rpay[:, d_loc].to(torch.int64)
            rdel = rpay[:, d_loc + 1] > 0.5
            rvalid = mdst < n_local

            # ---- affected rows (+ frontier for self-dependence) ----------
            all_dst = torch.cat([mdst, frontier]) \
                if spec.self_dependent else mdst
            rec_idx, pos, n_rec = _unique_recipients(n_local, all_dst, r_cap)
            overflow = overflow | (total > e_cap) | ovf | (n_rec > r_cap)
            aff_c = rec_idx.clamp(max=n_local - 1)
            real_row = rec_idx < n_local
            slot = torch.where(rvalid, pos[mdst.clamp(max=n_local)], r_cap)

            # ---- per-(message, local dim) SHRINK classification ----------
            S_pre_rows = S[l + 1][aff_c]
            C_pre_rows = C[l + 1][aff_c]
            mdst_c = mdst.clamp(max=n_local - 1)
            covered = C[l + 1][mdst_c] == rsrc_g[:, None]
            gone = rdel[:, None] | (sign * S[l + 1][mdst_c] > rval_ms)
            dim_shrink = covered & gone & rvalid[:, None]
            shrink_masks.append(dim_shrink.any(dim=1))

            # ---- GROW candidate extremum + witnesses (feeds the probe) ---
            cslot = torch.where(rvalid & ~rdel, slot, r_cap)
            cand_S, cand_C = segment_extremum(agg, rpay[:, :d_loc], cslot,
                                              r_cap, rsrc_g)

            if rc:
                # unfiltered baseline: every affected row re-aggregates its
                # FULL row through the row-sized pull path
                pdegs = torch.where(real_row, in_csr.length[aff_c], 0)
                got, psrc_g, pfid, pvalid, _ew, rem, p_need, p_ovf = \
                    _pull_in_neighbors(comm, n_local, n_pad, read_rows,
                                       in_csr, aff_c, pdegs, pull_cap, r_cap)
                pd_need = zero
                S_sh, C_sh = segment_extremum(
                    agg, got, torch.where(pvalid, pfid, r_cap), r_cap,
                    psrc_g)
                base_S = torch.where(real_row[:, None], S_sh, S_pre_rows)
                base_C = torch.where(real_row[:, None], C_sh, C_pre_rows)
                n_rows = real_row.sum()
                rc_rows = rc_rows + n_rows
                # [dims gathered, recovered cells, pull requests]
                model_counts.append(torch.stack([n_rows * d_loc, zero, rem]))
            else:
                # each model rank owns its d_loc dims outright: the shrink
                # mask, probe and pulls are local to it
                row_dim = segment_sum(dim_shrink.to(torch.float32), slot,
                                      r_cap) > 0
                recovered = row_dim & (sign * cand_S >= sign * S_pre_rows)
                need = row_dim & ~recovered & real_row[:, None]
                n_pairs = need.sum()
                pd_need = n_pairs
                reagg_masks.append(need.any(dim=1))
                pr, pdim = _masked_pairs(need, pd_cap, r_cap)
                rows_pair = aff_c[pr.clamp(max=r_cap - 1)]
                pdegs = torch.where(pr < r_cap, in_csr.length[rows_pair], 0)
                got, psrc_g, pfid, pvalid, rem, p_need, p_ovf = \
                    _pull_in_neighbor_dims(comm, n_local, n_pad, read_cells,
                                           in_csr, rows_pair, pdim, pdegs,
                                           pull_cap, pd_cap)
                p_ovf = p_ovf | (n_pairs > pd_cap)
                S_pair, C_pair = segment_extremum(
                    agg, got, torch.where(pvalid, pfid, pd_cap), pd_cap,
                    psrc_g)
                base_S = _scatter_cells(S_pre_rows, pr, pdim, S_pair)
                base_C = _scatter_cells(C_pre_rows, pr, pdim, C_pair)
                model_counts.append(torch.stack([n_pairs, recovered.sum(),
                                                 rem]))
            overflow = overflow | p_ovf
            sizes.append(torch.stack([n_rec, total, counts.max(), p_need,
                                      pd_need]))

            # ---- GROW: fold the candidate extremum in (elementwise) ------
            cand_wins = (sign * cand_S >= sign * base_S) & (cand_C >= 0)
            S_new = torch.where(cand_wins, cand_S, base_S)
            C_new = torch.where(cand_wins, cand_C, base_C)

            # ---- apply + (filtered) propagation --------------------------
            x = agg.normalize(S_new, k[aff_c])
            h_new = tp_update(comm, workload, params[l], l,
                              read_rows(rec_idx), x)
            hops.append((rec_idx, S_new, C_new, h_new))
            patch = (rec_idx, h_new)
            if rc:
                frontier = rec_idx
            else:
                changed = model_any((h_new != H[l + 1][aff_c]).any(dim=1)
                                    & real_row)
                frontier = torch.where(changed, rec_idx, n_local)

        H, S, C, ovf_g, final = _gated_commit(
            comm, n_local, overflow, H, S, C, batch, hops, frontier, donate)
        sz = comm.pmax(torch.stack(sizes), comm.all)
        # sums over the model ranks, then over the data ranks
        masks = shrink_masks + reagg_masks
        summed = comm.psum(torch.cat([m.to(torch.int64) for m in masks]
                                     + [torch.stack(model_counts)
                                        .flatten()]), comm.model)
        parts = summed.split([m.shape[0] for m in masks] + [3 * L])
        n_shrink = sum((p > 0).sum() for p in parts[:L])
        n_reagg = rc_rows if rc else sum((p > 0).sum()
                                         for p in parts[L:2 * L])
        mc = parts[-1].reshape(L, 3)
        sstats = torch.stack([n_shrink, n_reagg, mc[:, 0].sum(),
                              mc[:, 1].sum()])
        by_data = comm.psum(torch.cat([torch.stack(halo_rem), mc[:, 2],
                                       sstats]), comm.data)
        req = by_data[L:2 * L]
        resp = req * torch.tensor([h.shape[1] for h in H[:L]],
                                  device=dev) if rc else req
        hop_comm = torch.stack([by_data[:L], req, resp], dim=1).flatten()
        report = torch.cat([ovf_g, hop_comm, by_data[2 * L:], sz.flatten(),
                            comm.gather(final, comm.data).flatten()])
        return H, S, C, report

    return run


# ---------------------------------------------------------------------------
# Distributed layer-wise recompute baseline ("RC", pull-based -- paper fig 12)
# ---------------------------------------------------------------------------
def make_rc_propagate(comm: MeshComm, workload: Workload, n_local: int,
                      caps: tuple, halo_cap, pull_cap: int, *,
                      donate: bool = False):
    """Distributed RC: frontier ids are exchanged, then every affected
    vertex PULLS all its in-neighbor embeddings (request/response
    all_to_all pair) -- the communication-heavy pattern the paper measures.

    Returns ``fn(params, H, S, k, out_csr, in_csr, batch) -> (H, S,
    report)`` with ``report`` the int64 vector ``[ovf, comm [L], sizes
    [L, 5], final [P, rows_L]]``."""
    n_parts = comm.n_parts
    n_pad = n_parts * n_local
    fuse = n_local < _F32_EXACT
    spec = workload.spec
    L = spec.n_layers
    halo_caps = _per_hop(halo_cap, L)

    @torch.no_grad()
    def run(params, H, S, k, out_csr: DistCSR, in_csr: DistCSR,
            batch: DistBatch):
        dev = H[0].device
        fv = batch.feat_idx
        patch = (fv, batch.feat_val)
        frontier = fv
        overflow = torch.zeros((), dtype=torch.bool, device=dev)
        remote, sizes, hops = [], [], []
        id_vals = torch.zeros((n_local + 1, 1), device=dev)
        no_w = torch.zeros_like(batch.add_w)

        for l in range(L):
            r_cap, e_cap = caps[l]
            read_rows, _ = _overlay_reader(n_local, H[l], patch)
            # --- frontier id expansion (no values) ------------------------
            dst_g, vals, needed = _local_frontier_messages(
                n_local, n_pad, id_vals, out_csr.col, out_csr.w,
                out_csr.start, out_csr.length, frontier,
                torch.zeros((frontier.shape[0], 1), device=dev),
                batch.add_src, batch.add_dst, no_w, batch.del_src,
                batch.del_dst, no_w, weighted=False,
                self_dep=spec.self_dependent, e_cap=e_cap,
                my_part=comm.me)
            ids, buf, counts, ovf = _pack_by_partition(
                n_parts, n_local, halo_caps[l], dst_g, vals)
            rid, _ = _exchange_fused(comm, ids, buf, comm.data, fuse)
            rec_idx, _, n_rec = _unique_recipients(n_local, rid.reshape(-1),
                                                   r_cap)

            # --- pull ALL in-neighbors of affected vertices ----------------
            aff_c = rec_idx.clamp(max=n_local - 1)
            degs = torch.where(rec_idx < n_local, in_csr.length[aff_c], 0)
            got, src_g, fid, evalid, ew, req, p_need, p_ovf = \
                _pull_in_neighbors(comm, n_local, n_pad, read_rows, in_csr,
                                   aff_c, degs, pull_cap, r_cap)
            overflow = overflow | (needed > e_cap) | ovf | (n_rec > r_cap) \
                | p_ovf
            # ids out, one request and one value back per pulled id
            remote.append(counts.sum() - counts[comm.me] + 2 * req)
            sizes.append(torch.stack([n_rec, needed, counts.max(), p_need,
                                      torch.zeros_like(n_rec)]))

            # segment-sum pulled values into S rows of affected vertices
            if not spec.weighted:
                ew = torch.ones_like(ew)
            S_rows = segment_sum(got * ew[:, None],
                                 torch.where(evalid, fid, r_cap), r_cap)
            x = S_rows / torch.clamp(k[aff_c], min=1.0)[:, None] \
                if spec.aggregator == "mean" else S_rows
            h_new = tp_update(comm, workload, params[l], l,
                              read_rows(rec_idx), x)
            hops.append((rec_idx, S_rows, h_new))
            patch = (rec_idx, h_new)
            frontier = rec_idx

        H, S, _, ovf_g, final = _gated_commit(
            comm, n_local, overflow, H, S, None, batch, hops, frontier,
            donate)
        sz = comm.pmax(torch.stack(sizes), comm.all)
        report = torch.cat([ovf_g, comm.psum(torch.stack(remote), comm.data),
                            sz.flatten(),
                            comm.gather(final, comm.data).flatten()])
        return H, S, report

    return run
