"""Device-resident incremental RIPPLE propagation (single replica),
invertible, monotonic and bounded-recompute families.

The host engines drive NumPy; this module keeps the whole L-hop
propagation of one update batch on the device, with *static bucket
capacities*, so the work stays proportional to the frontier size (the
paper's k'-incrementality), not to |V| or |E|, and the host waits for the
device once per batch:

 - the frontier is a padded index vector (sentinel = n) + aligned deltas;
 - frontier out-edges are expanded with a vectorized ragged gather
   (cumsum + searchsorted) into an edge bucket of static size E_cap;
 - recipients are compacted into R_cap rows (cumsum positions, no
   data-dependent shapes), and mailboxes are segment-summed into them;
 - self-dependent workloads (SAGE/GIN) inject zero-valued messages from
   the frontier to itself so "recipients" uniformly equals "affected";
 - the hop apply runs through the fused kernels (``delta_apply`` for
   GraphConv and SAGE's neighbour term, ``mlp_apply`` for GIN's MLP):
   the CUDA kernels on a card, their plain versions on the CPU.

Device residency: the adjacency lives in a persistent
:class:`DeviceCSRMirror` (slack-pool CSR maintained by touched-row
scatters, full re-upload only on slack overflow), the ``DeviceState``
tensors are updated in place (``donate=True``), and the in-degree vector
``k`` is maintained on the device from each batch's add/delete counts.

Every state tensor carries one trash row at index ``n``: the gated commit
sends the writes it must drop there, which stands in for the reference's
``mode="drop"`` scatters.  Reads clamp their indices to ``n - 1`` as the
reference does, so the trash row is never read, and ``sync``/``query``
never expose it.

To keep the commits-nothing-on-overflow contract with in-place updates,
the propagation is two-phase: phase 1 computes every hop's compact row
patches (reads only -- later hops read earlier hops' values through a
patch-gather), accumulating the exact overflow flag on the device; phase
2 writes all patches with indices gated on the flag (an overflowing
attempt sends every write to the trash row, so the state holds the
pre-batch values bit-exactly and the ladder can retry).

Monotonic workloads (max/min) run through :func:`propagate_monotonic`:
candidate extrema compact into per-row segment-max mailboxes; SHRINK cells
(tracked contributor lost, classified per ``(row, dim)``) first face the
re-cover probe, and the survivors are re-derived from a mirrored in-CSR;
the hop apply runs through ``extremum_apply``; the next frontier keeps
only rows whose embedding changed (filtered propagation).  See
core/aggregators.py for the algebra.

Bounded-recompute workloads (attention / top-k / PNA) run through
:func:`propagate_bounded`: every affected row re-aggregates over its
mirrored in-neighbourhood each hop (PNA's first moment through the
``embedding_bag`` kernel), the cached aux state ``A`` rides the gated
commit, and the frontier is filtered as for the monotonic family.  With
``tolerance > 0`` interior-layer writes within the certified deferral
budget are dropped.
"""
from __future__ import annotations

import copy
import time
from typing import NamedTuple

import numpy as np
import torch

from repro_torch.kernels.delta_apply import delta_apply
from repro_torch.kernels.embedding_bag import embedding_bag
from repro_torch.kernels.extremum_apply import extremum_apply
from repro_torch.kernels.mlp_apply import mlp_apply
from repro_torch.kernels.shrink_pull import shrink_pull
from repro_torch.tracing import span, spanned
from repro_torch.utils import next_bucket, pad_to, resolve_device

from .aggregators import (certified_error_bound, deferral_budgets,
                          segment_extremum, segment_sum)
from .graph import _GROW, _MIN_SLACK, DynamicGraph, flat_row_indices
from .ragged import _masked_pairs, _ragged_gather, _scatter_cells
from .state import params_to_numpy
from .workloads import Workload


def _upload(arr: np.ndarray, device: torch.device) -> torch.Tensor:
    """Host array -> device tensor; on a card through pinned memory and an
    asynchronous copy (the caching host allocator keeps the pinned block
    alive until the copy has run)."""
    t = torch.from_numpy(np.ascontiguousarray(arr))
    if device.type == "cuda":
        return t.pin_memory().to(device, non_blocking=True)
    return t.clone()


def _with_trash_row(arr: np.ndarray, device: torch.device,
                    fill=0) -> torch.Tensor:
    """``arr`` on the device with one ``fill`` row appended at index n."""
    out = np.full((arr.shape[0] + 1,) + arr.shape[1:], fill, dtype=arr.dtype)
    out[:-1] = arr
    return _upload(out, device)


class DeviceCSR(NamedTuple):
    """One adjacency half mirrored on device (slacked-CSR pool layout)."""

    col: torch.Tensor     # [pool] int64, -1 in slack slots
    w: torch.Tensor       # [pool] f32
    start: torch.Tensor   # [n] int64
    length: torch.Tensor  # [n] int64


class DeviceCSRMirror:
    """Persistent device-resident slack-pool CSR of one adjacency half.

    Rows own slack-padded slot ranges in a flat pool (power-of-two total
    size).  ``refresh_rows`` re-copies only the rows a batch touched -- a
    vectorized ragged gather on the host half followed by one upload and
    in-place device scatters, O(sum of touched row degrees) host->device
    traffic.  A full pool upload happens exactly once at construction and
    again only when a row outgrows its slack (``rebuilds``); the counters
    let tests assert the no-O(E)-per-batch contract.
    """

    def __init__(self, half, *, device, min_pool: int = 1024):
        self.half = half            # backing host _AdjHalf (authoritative)
        self.device = torch.device(device)
        self.min_pool = min_pool
        self.uploads = 0            # full-pool uploads (init + rebuilds)
        self.rebuilds = -1          # slack-overflow re-layouts
        self.row_refreshes = 0      # rows refreshed incrementally
        self._rebuild()

    def _rebuild(self) -> None:
        n = self.half.n
        deg = self.half.length.astype(np.int64)
        cap = np.maximum((deg * _GROW).astype(np.int64) + _MIN_SLACK, deg)
        start = np.zeros(n, dtype=np.int64)
        if n:
            np.cumsum(cap[:-1], out=start[1:])
        pool = next_bucket(int(start[-1] + cap[-1]) if n else 1,
                           minimum=self.min_pool)
        col = np.full(pool, -1, dtype=np.int64)
        w = np.zeros(pool, dtype=np.float32)
        if deg.sum():
            src_idx = flat_row_indices(self.half.start, deg)
            dst_idx = flat_row_indices(start, deg)
            col[dst_idx] = self.half.col[src_idx]
            w[dst_idx] = self.half.w[src_idx]
        self._start_h, self._cap_h = start, cap
        self.pool = pool
        self.col = _upload(col, self.device)
        self.w = _upload(w, self.device)
        self.start = _upload(start, self.device)
        self.length = _upload(deg, self.device)
        self.uploads += 1
        self.rebuilds += 1

    def refresh_rows(self, rows: np.ndarray) -> None:
        """Re-copy the given rows from the backing host half (the per-batch
        maintenance path after topology updates mutate the graph)."""
        rows = np.asarray(rows, dtype=np.int64)
        if rows.size == 0:
            return
        with span("DeviceCSRMirror.refresh"):
            deg = self.half.length[rows]
            if np.any(deg > self._cap_h[rows]):
                self._rebuild()         # some row outgrew its slack
                return
            src_idx = flat_row_indices(self.half.start[rows], deg)
            dst_idx = flat_row_indices(self._start_h[rows], deg)
            kb = int(dst_idx.size)
            # one packed upload: [slot_idx | slot_col | row_idx | row_len]
            ints = _upload(np.concatenate([dst_idx, self.half.col[src_idx],
                                           rows, deg]).astype(np.int64),
                           self.device)
            slot_w = _upload(self.half.w[src_idx].astype(np.float32),
                             self.device)
            slot_idx, slot_col = ints[:kb], ints[kb:2 * kb]
            row_idx, row_len = ints[2 * kb:].split(rows.size)
            self.col.index_copy_(0, slot_idx, slot_col)
            self.w.index_copy_(0, slot_idx, slot_w)
            self.length.index_copy_(0, row_idx, row_len)
            self.row_refreshes += int(rows.size)

    def csr(self) -> DeviceCSR:
        return DeviceCSR(col=self.col, w=self.w, start=self.start,
                         length=self.length)


class DeviceState(NamedTuple):
    H: tuple[torch.Tensor, ...]  # [n+1, d_l] per layer 0..L (row n: trash)
    S: tuple[torch.Tensor, ...]  # [n+1, d_{l-1}] per layer 1..L ([0] empty)
    k: torch.Tensor              # [n+1] in-degree (maintained on device)
    C: tuple[torch.Tensor, ...] = ()  # monotonic contributor refs, int32,
    #                                   index-aligned with S (() invertible)
    A: tuple[tuple[torch.Tensor, ...], ...] = ()  # bounded cached partial
    #   state: per layer a tuple in aux_names order ([0] empty)

    def clone(self) -> "DeviceState":
        return DeviceState(H=tuple(h.clone() for h in self.H),
                           S=tuple(s.clone() for s in self.S),
                           k=self.k.clone(),
                           C=tuple(c.clone() for c in self.C),
                           A=tuple(tuple(a.clone() for a in layer)
                                   for layer in self.A))


class BatchDev(NamedTuple):
    """A routed update batch in padded device form (sentinel index = n).

    The index/weight vectors travel packed ([5, cap] / [2, cap]) so a
    batch costs three host->device transfers instead of eight; the named
    accessors are views.
    """

    ints: torch.Tensor      # [5, cap] int64: feat/add_src/add_dst/del_src/del_dst
    ws: torch.Tensor        # [2, cap] f32: add_w, del_w
    feat_val: torch.Tensor  # [cap, d0]

    @property
    def feat_idx(self) -> torch.Tensor:
        return self.ints[0]

    @property
    def add_src(self) -> torch.Tensor:
        return self.ints[1]

    @property
    def add_dst(self) -> torch.Tensor:
        return self.ints[2]

    @property
    def del_src(self) -> torch.Tensor:
        return self.ints[3]

    @property
    def del_dst(self) -> torch.Tensor:
        return self.ints[4]

    @property
    def add_w(self) -> torch.Tensor:
        return self.ws[0]

    @property
    def del_w(self) -> torch.Tensor:
        return self.ws[1]


# ---------------------------------------------------------------------------
# Deferred-commit plumbing: later hops read earlier hops' (rec_idx, h_new)
# patches instead of written state, so all writes can be gated at the end
# ---------------------------------------------------------------------------
def _patch_pos(n: int, p_idx: torch.Tensor) -> torch.Tensor:
    """Vertex id -> patch slot map [n+1] (-1 where unpatched; sentinel ids
    land in slot n, which no read reaches).  Valid patch ids are unique."""
    pos = torch.full((n + 1,), -1, dtype=torch.int64, device=p_idx.device)
    return pos.scatter_(0, p_idx, torch.arange(p_idx.shape[0],
                                               device=p_idx.device))


def _patched(n: int, base: torch.Tensor, pos: torch.Tensor,
             p_val: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """Rows of ``base`` at ``idx`` as if the patch had been written."""
    idx_c = idx.clamp(max=n - 1)
    slot = pos[idx_c]
    return torch.where((slot >= 0)[:, None], p_val[slot.clamp(min=0)],
                       base[idx_c])


def _hop_messages(n: int, h_pre: torch.Tensor, csr: DeviceCSR,
                  frontier: torch.Tensor, delta: torch.Tensor,
                  batch: BatchDev, *, weighted: bool, self_dep: bool,
                  e_cap: int):
    """Build the (dst, value) message stream for hop l -> l+1.

    ``h_pre`` is the PRE-batch layer-l embedding (pristine in the
    deferred-commit scheme), which is exactly the ``h_old`` the add/delete
    retraction messages need.  Returns (all_dst [E_tot], all_val [E_tot, d],
    n_edges_needed) where E_tot = e_cap + A + D (+ F for self-dep).
    """
    degs = torch.where(frontier < n, csr.length[frontier.clamp(max=n - 1)], 0)
    # ragged expansion of frontier out-edges into the static edge bucket
    edst, flat, fid, evalid, total = _ragged_gather(
        n, csr.start, csr.col, frontier, degs, e_cap)
    ew = csr.w[flat] if weighted else torch.ones(e_cap, device=flat.device)
    evals = delta[fid] * (ew * evalid)[:, None]

    def h_old(src: torch.Tensor) -> torch.Tensor:
        return h_pre[src.clamp(max=n - 1)]

    a_valid = (batch.add_src < n)[:, None]
    aw = batch.add_w if weighted else torch.ones_like(batch.add_w)
    a_val = h_old(batch.add_src) * aw[:, None] * a_valid
    d_valid = (batch.del_src < n)[:, None]
    dw = batch.del_w if weighted else torch.ones_like(batch.del_w)
    d_val = -h_old(batch.del_src) * dw[:, None] * d_valid

    dsts = [edst, batch.add_dst, batch.del_dst]
    vals = [evals, a_val, d_val]
    if self_dep:
        dsts.append(frontier)
        vals.append(torch.zeros_like(delta))
    return torch.cat(dsts), torch.cat(vals), total


def _unique_recipients(n: int, all_dst: torch.Tensor, r_cap: int):
    """Recipient compaction: unique message destinations in ascending
    vertex order plus the vertex -> mailbox-slot map.

    Two regimes, chosen by shape: when the message bucket is at least half
    of |V|, a [n+1] presence mask is cheapest (O(n), no sort); when the
    bucket is small relative to the graph, a sort keeps the cost
    O(E log E), independent of |V|.  Both compact by cumsum positions into
    the fixed ``r_cap`` buffer (slot j holds the (j+1)-th recipient, found
    by ``searchsorted`` on the running count; slots past the count hold
    the sentinel n), so no shape depends on the data and nothing waits for
    the host.  Both give the same ascending order.

    Returns (rec_idx [r_cap] ascending + sentinel-n padded, pos [n+1]
    vertex -> mailbox slot map (r_cap for non-recipients and for the
    sentinel), n_recipients).
    """
    dev = all_dst.device
    slots = torch.arange(r_cap, device=dev)
    if all_dst.shape[0] >= n // 2:
        mask = torch.zeros(n + 1, dtype=torch.bool, device=dev)
        mask[all_dst.clamp(max=n)] = True
        count = torch.cumsum(mask[:n], 0)
        n_rec = count[-1]
        rec_idx = torch.searchsorted(count, slots, right=True)
    else:
        sd = torch.sort(all_dst).values  # sentinels (n) sort to the end
        newseg = torch.ones_like(sd, dtype=torch.bool)
        newseg[1:] = sd[1:] != sd[:-1]
        count = torch.cumsum(newseg & (sd < n), 0)
        n_rec = count[-1]
        at = torch.searchsorted(count, slots, right=True)
        rec_idx = torch.where(at < sd.shape[0],
                              sd[at.clamp(max=sd.shape[0] - 1)], n)
    valid = rec_idx < n
    pos = torch.full((n + 1,), r_cap, dtype=torch.int64, device=dev)
    pos.scatter_(0, torch.where(valid, rec_idx, n),
                 torch.where(valid, slots, r_cap))
    return rec_idx, pos, n_rec


def _k_rows(n: int, state: DeviceState, batch: BatchDev,
            rec_idx: torch.Tensor, pos_r: torch.Tensor,
            r_cap: int) -> torch.Tensor:
    """Post-batch in-degree at the affected rows, from the batch's add/del
    counts -- O(bucket) segment sums instead of materializing a full [n]
    updated-degree vector (the full vector is only written once, in the
    gated phase-2 commit)."""
    def cnt(dst: torch.Tensor) -> torch.Tensor:
        return segment_sum((dst < n).to(torch.float32),
                            pos_r[dst.clamp(max=n)], r_cap)
    return state.k[rec_idx.clamp(max=n - 1)] + cnt(batch.add_dst) \
        - cnt(batch.del_dst)


def _apply_hop(workload: Workload, params_l: dict, eps_l: float, layer: int,
               n: int, state: DeviceState, k_rows: torch.Tensor, patch,
               rec_idx: torch.Tensor, mailbox: torch.Tensor):
    """Compute hop layer+1's row patch (no writes); returns
    (S_rows, h_new, next delta)."""
    aff_c = rec_idx.clamp(max=n - 1)
    valid = (rec_idx < n)[:, None]
    S_base = state.S[layer + 1][aff_c]
    last = layer == workload.spec.n_layers - 1
    mean = workload.agg.by_degree
    if workload.spec.self_dependent:
        pos = _patch_pos(n, patch[0])
        h_prev = _patched(n, state.H[layer], pos, patch[1], rec_idx)
    if workload.family == "gc":
        S_rows, h_new = delta_apply(S_base, mailbox, k_rows, params_l["w"],
                                    params_l["b"], mean=mean, relu=not last)
    elif workload.family == "sage":
        # fused neighbour term; the self term stays a plain matmul
        S_rows, h_new = delta_apply(S_base, mailbox, k_rows,
                                    params_l["w_nbr"], params_l["b"],
                                    mean=mean, relu=False)
        h_new = h_new + h_prev @ params_l["w_self"]
        if not last:
            h_new = torch.relu(h_new)
    else:  # gin: fold + z-term + both MLP products in one pass
        S_rows, h_new = mlp_apply(S_base, mailbox, h_prev, k_rows, eps_l,
                                  params_l["w1"], params_l["b1"],
                                  params_l["w2"], params_l["b2"], mean=mean,
                                  relu=not last)
    delta = (h_new - state.H[layer + 1][aff_c]) * valid
    return S_rows, h_new, delta


@torch.no_grad()
def propagate(workload: Workload, n: int,
              caps: tuple[tuple[int, int], ...], params: list[dict],
              eps: list[float], state: DeviceState, csr: DeviceCSR,
              batch: BatchDev, *, donate: bool = True):
    """One full L-hop incremental propagation of a routed batch.

    caps[l] = (frontier_cap entering hop l+1 computation, edge_cap at hop
    l).  Returns (new_state, report) where ``report`` is one int64 device
    vector [overflow, sizes [L, 3] flattened, final affected idx]:
    ``sizes[l] = (recipients, edges, 0)`` actually needed at hop l, which
    the engine's adaptive cap schedule feeds on.  Reading it back is the
    batch's one wait for the device.  Phase 1 only reads; phase 2 writes
    with overflow-gated indices, so a failed attempt leaves the state's
    values bit-exactly as they were.  With ``donate`` the state tensors
    are updated in place; otherwise a copy is.
    """
    L = workload.spec.n_layers
    spec = workload.spec

    # ---- phase 1: per-hop row patches, reads only ------------------------
    fv = batch.feat_idx
    old0 = state.H[0][fv.clamp(max=n - 1)]
    delta = (batch.feat_val - old0) * (fv < n)[:, None]
    frontier = fv
    patch = (fv, batch.feat_val)
    overflow = torch.zeros((), dtype=torch.bool, device=fv.device)
    hops = []
    sizes = []
    for l in range(L):
        with span(f"DeviceEngine.hop{l}"):
            r_cap, e_cap = caps[l]
            with span("DeviceEngine.expand"):
                all_dst, all_val, needed = _hop_messages(
                    n, state.H[l], csr, frontier, delta, batch,
                    weighted=spec.weighted, self_dep=spec.self_dependent,
                    e_cap=e_cap)
                rec_idx, pos_r, n_rec = _unique_recipients(n, all_dst, r_cap)
            overflow = overflow | (needed > e_cap) | (n_rec > r_cap)
            sizes.append(torch.stack([n_rec, needed,
                                      torch.zeros_like(needed)]))
            with span("DeviceEngine.apply"):
                mailbox = segment_sum(all_val, pos_r[all_dst.clamp(max=n)],
                                      r_cap)
                k_rows = _k_rows(n, state, batch, rec_idx, pos_r, r_cap)
                S_rows, h_new, delta = _apply_hop(
                    workload, params[l], eps[l], l, n, state, k_rows, patch,
                    rec_idx, mailbox)
            hops.append((rec_idx, S_rows, h_new))
            patch = (rec_idx, h_new)
            frontier = rec_idx

    # ---- phase 2: overflow-gated commit (dropped writes hit row n) -------
    with span("DeviceEngine.commit"):
        if not donate:
            state = state.clone()
        ok = ~overflow

        def gate(idx: torch.Tensor) -> torch.Tensor:
            return torch.where(ok, idx, n)

        state.H[0].index_copy_(0, gate(fv), batch.feat_val)
        for l, (rec, S_rows, h_new) in enumerate(hops):
            state.S[l + 1].index_copy_(0, gate(rec), S_rows)
            state.H[l + 1].index_copy_(0, gate(rec), h_new)
        ones = torch.ones_like(batch.add_w)
        state.k.index_add_(0, gate(batch.add_dst), ones)
        state.k.index_add_(0, gate(batch.del_dst), -ones)
        report = torch.cat([overflow.view(1).to(torch.int64),
                            torch.stack(sizes).flatten(),
                            torch.where(ok, frontier, n)])
    return state, report


# ---------------------------------------------------------------------------
# Monotonic (max/min) propagation: GROW via candidate segment-extremum,
# SHRINK via in-neighborhood pulls, filtered frontier
# ---------------------------------------------------------------------------
def _expand_frontier_edges(n: int, csr: DeviceCSR, frontier: torch.Tensor,
                           e_cap: int):
    """Ragged gather of frontier out-edges into a static bucket.

    Returns (edst [e_cap], esrc [e_cap], n_edges_needed); sentinel n pads.
    """
    degs = torch.where(frontier < n, csr.length[frontier.clamp(max=n - 1)], 0)
    edst, _, fid, evalid, total = _ragged_gather(
        n, csr.start, csr.col, frontier, degs, e_cap)
    esrc = torch.where(evalid, frontier[fid], n)
    return edst, esrc, total


def _monotonic_hop(workload: Workload, params_l: dict, layer: int, n: int,
                   state: DeviceState, out_csr: DeviceCSR, in_csr: DeviceCSR,
                   batch: BatchDev, frontier: torch.Tensor, patch, *,
                   r_cap: int, e_cap: int, p_cap: int, pd_cap: int,
                   pull: str):
    """One GROW/SHRINK hop layer -> layer+1 (reads only); returns the hop
    patch (rec_idx, S_new, C_new, h_new), the filtered next frontier, the
    overflow flag, the needed sizes (recipients, edges, pulled, pairs) and
    the counters (shrink_events, rows_reaggregated, dims_reaggregated,
    recover_hits).

    SHRINK runs per ``(row, dim)``: classification gives an ``[r_cap, d]``
    mask (one cell per shrunk dim, deduplicated across the batch's
    messages), the re-cover probe drops every cell the batch's own
    candidate extremum already re-witnesses, and the survivors re-derive
    from the in-CSR.  ``pull`` picks how: ``"pairs"`` re-derives only the
    needed cells, through ``kernels/shrink_pull`` (one kernel launch on a
    card; on the CPU its plain version flattens the cells into (row, dim)
    pairs, static cap ``pd_cap``, and gathers single columns of their
    in-neighborhoods as element reads), so ``p_cap`` bounds pulled
    elements; ``"rows"`` re-derives every dim of
    each needy row with row gathers, so ``p_cap`` bounds their total
    in-degree.  The counters count cells in both.

    All extremum arithmetic runs in max-space (``sign * value``); the
    post-update layer-l values are read through the previous hop's patch.
    """
    agg = workload.agg
    sign = agg.sign
    H_pre, S_next, C_next = state.H[layer], state.S[layer + 1], \
        state.C[layer + 1]
    dev = frontier.device
    with span("DeviceEngine.expand"):
        pos_p = _patch_pos(n, patch[0])
        edst, esrc, needed = _expand_frontier_edges(n, out_csr, frontier,
                                                    e_cap)
        overflow = needed > e_cap

        # unified message stream: frontier edges + adds are candidates AND
        # probes; deletes are probes only (their value must never grow S)
        msg_dst = torch.cat([edst, batch.add_dst, batch.del_dst])
        msg_src = torch.cat([esrc, batch.add_src, batch.del_src])
        n_cand = edst.shape[0] + batch.add_dst.shape[0]
        is_del = torch.arange(msg_dst.shape[0], device=dev) >= n_cand
        valid = (msg_dst < n) & (msg_src < n)

        # affected rows = unique message dsts (+ frontier for
        # self-dependence)
        all_dst = msg_dst
        if workload.spec.self_dependent:
            all_dst = torch.cat([all_dst, frontier])
        rec_idx, pos, n_rec = _unique_recipients(n, all_dst, r_cap)
        overflow = overflow | (n_rec > r_cap)
        aff_c = rec_idx.clamp(max=n - 1)
        real_row = rec_idx < n
        slot = torch.where(valid, pos[msg_dst.clamp(max=n)], r_cap)

    with span("DeviceEngine.grow"):
        vals = _patched(n, H_pre, pos_p, patch[1], msg_src)  # post-update

        # ---- per-(message, dim) SHRINK classification, deduped per row ---
        dst_c = msg_dst.clamp(max=n - 1)
        covered = C_next[dst_c] == msg_src[:, None]
        gone = is_del[:, None] | (sign * S_next[dst_c] > sign * vals)
        dim_shrink = covered & gone & valid[:, None]
        n_shrink = dim_shrink.any(dim=1).sum()
        row_dim = segment_sum(dim_shrink.to(torch.float32), slot, r_cap) > 0

        # ---- GROW candidate extremum + witnesses (also feeds the probe) --
        cslot = torch.where(valid & ~is_del, slot, r_cap)
        cand_S, cand_C = segment_extremum(agg, vals, cslot, r_cap, msg_src)

        S_pre_rows = S_next[aff_c]
        C_pre_rows = C_next[aff_c]

        # ---- re-cover probe: candidate ties-or-beats the lost extremum ---
        recovered = row_dim & (sign * cand_S >= sign * S_pre_rows)
        need = row_dim & ~recovered & real_row[:, None]
        n_recover = recovered.sum()
        n_pairs = need.sum()
        n_reagg = need.any(dim=1).sum()

    # ---- surviving (row, dim) cells: re-derive from the in-CSR -----------
    with span("DeviceEngine.shrink"):
        if pull == "rows":
            row_need = need.any(dim=1)
            degs = torch.where(row_need, in_csr.length[aff_c], 0)
            psrc, _, fid, pvalid, pull_total = _ragged_gather(
                n, in_csr.start, in_csr.col, aff_c, degs, p_cap)
            overflow = overflow | (pull_total > p_cap)
            pvals = _patched(n, H_pre, pos_p, patch[1], psrc)
            S_sh, C_sh = segment_extremum(agg, pvals,
                                          torch.where(pvalid, fid, r_cap),
                                          r_cap, psrc)
            MK = row_need[:, None].expand_as(S_pre_rows).contiguous()
            RG = torch.where(MK, S_sh, 0.0)
            base_C = torch.where(MK, C_sh, C_pre_rows)
        elif pull == "pairs":
            MK, RG, base_C, pull_total = shrink_pull(
                need, aff_c, in_csr.start, in_csr.length, in_csr.col, H_pre,
                pos_p, patch[1], C_pre_rows, sign=sign, pd_cap=pd_cap,
                p_cap=p_cap)
            overflow = overflow | (n_pairs > pd_cap) | (pull_total > p_cap)
        else:
            raise ValueError(f"pull must be 'pairs' or 'rows', not {pull!r}")

    with span("DeviceEngine.apply"):
        # ---- GROW: the candidate's witness where it wins the fold --------
        base_S = torch.where(MK, RG, S_pre_rows)
        cand_wins = (sign * cand_S >= sign * base_S) & (cand_C >= 0)
        C_new = torch.where(cand_wins, cand_C, base_C)

        # ---- apply (fused select + fold + finite-mask + product) ---------
        last = layer == workload.spec.n_layers - 1
        maximize = sign > 0
        if workload.family == "gc":
            S_new, h_new = extremum_apply(S_pre_rows, cand_S, params_l["w"],
                                          params_l["b"], reagg=RG, mask=MK,
                                          maximize=maximize, relu=not last)
        elif workload.family == "sage":
            # fused neighbour term; the self term stays a plain matmul,
            # added in the reference's order (the frontier filter compares
            # bits)
            S_new, h_new = extremum_apply(S_pre_rows, cand_S,
                                          params_l["w_nbr"], params_l["b"],
                                          reagg=RG, mask=MK,
                                          maximize=maximize, relu=False)
            h_prev = _patched(n, H_pre, pos_p, patch[1], rec_idx)
            h_new = h_new + h_prev @ params_l["w_self"]
            if not last:
                h_new = torch.relu(h_new)
        else:
            raise ValueError(f"no monotonic hop apply for the "
                             f"{workload.family!r} family")

        # ---- filtered propagation: only rows whose embedding changed -----
        changed = (h_new != state.H[layer + 1][aff_c]).any(dim=1) & real_row
        frontier_next = torch.where(changed, rec_idx, n)
        sizes = torch.stack([n_rec, needed, pull_total, n_pairs])
        stats = torch.stack([n_shrink, n_reagg, n_pairs, n_recover])
    return (rec_idx, S_new, C_new, h_new), frontier_next, overflow, sizes, \
        stats


@torch.no_grad()
def propagate_monotonic(workload: Workload, n: int,
                        caps: tuple[tuple[int, int, int, int], ...],
                        params: list[dict], state: DeviceState,
                        out_csr: DeviceCSR, in_csr: DeviceCSR,
                        batch: BatchDev, *, pull: str, donate: bool = True):
    """L-hop monotonic (max/min) propagation of a routed batch.

    caps[l] = (row_cap, edge_cap, pull_cap, pair_cap) at hop l.  ``pull``
    is the SHRINK re-derivation regime of :func:`_monotonic_hop`
    (:class:`DeviceEngine` takes ``"pairs"`` on a card and ``"rows"`` on
    the CPU unless told otherwise).  Returns
    (new_state, report) where ``report`` is one int64 device vector
    [overflow, sizes [L, 4] flattened, counters [4] (shrink_events,
    rows_reaggregated, dims_reaggregated, recover_hits), final affected
    idx]; reading it back is the batch's one wait for the device.  Same
    two-phase gated commit of H, S, C and k as :func:`propagate`, so an
    overflowing attempt commits nothing, in place or not.
    """
    L = workload.spec.n_layers

    fv = batch.feat_idx
    old = state.H[0][fv.clamp(max=n - 1)]
    changed0 = (batch.feat_val != old).any(dim=1) & (fv < n)
    frontier = torch.where(changed0, fv, n)  # hop-0 filter: no-op writes stop
    patch = (fv, batch.feat_val)
    overflow = torch.zeros((), dtype=torch.bool, device=fv.device)
    stats = torch.zeros(4, dtype=torch.int64, device=fv.device)
    hops = []
    sizes = []
    for l in range(L):
        r_cap, e_cap, p_cap, pd_cap = caps[l]
        with span(f"DeviceEngine.hop{l}"):
            hop_patch, frontier, ovf, hop_sizes, hop_stats = _monotonic_hop(
                workload, params[l], l, n, state, out_csr, in_csr, batch,
                frontier, patch, r_cap=r_cap, e_cap=e_cap, p_cap=p_cap,
                pd_cap=pd_cap, pull=pull)
            overflow = overflow | ovf
            stats = stats + hop_stats
        hops.append(hop_patch)
        sizes.append(hop_sizes)
        patch = (hop_patch[0], hop_patch[3])

    # ---- phase 2: overflow-gated commit (dropped writes hit row n) -------
    with span("DeviceEngine.commit"):
        if not donate:
            state = state.clone()
        ok = ~overflow

        def gate(idx: torch.Tensor) -> torch.Tensor:
            return torch.where(ok, idx, n)

        state.H[0].index_copy_(0, gate(fv), batch.feat_val)
        for l, (rec, S_new, C_new, h_new) in enumerate(hops):
            state.S[l + 1].index_copy_(0, gate(rec), S_new)
            state.C[l + 1].index_copy_(0, gate(rec), C_new)
            state.H[l + 1].index_copy_(0, gate(rec), h_new)
        ones = torch.ones_like(batch.add_w)
        state.k.index_add_(0, gate(batch.add_dst), ones)
        state.k.index_add_(0, gate(batch.del_dst), -ones)
        report = torch.cat([overflow.view(1).to(torch.int64),
                            torch.stack(sizes).flatten(), stats,
                            torch.where(ok, frontier, n)])
    return state, report


# ---------------------------------------------------------------------------
# Bounded-recompute (attention / top-k / PNA) propagation: every affected
# row re-aggregates over its mirrored in-neighbourhood each hop (refresh-
# all, one uniform gather in place of the host's PATCH classification),
# the aux state rides the gated commit, and the frontier stays filtered.
# With tolerance > 0 the per-layer deferral budgets arrive as a device
# tensor ``taus``: interior-hop writes within budget are dropped (the stale
# store is exactly what downstream reads see), and the per-layer max
# deferred magnitude / max committed |h| travel back to the host, which
# owns the certified eps / M / kmax accounting.
# ---------------------------------------------------------------------------
def _bag_rectangle(n: int, degs: torch.Tensor, fid: torch.Tensor,
                   pvalid: torch.Tensor, psrc: torch.Tensor, r_cap: int,
                   h_cap: int) -> torch.Tensor:
    """The pull's ragged in-neighbourhoods as one ``[r_cap, h_cap]`` int32
    index rectangle: row r holds row r's in-neighbour ids left-packed in
    in-CSR order and the sentinel n elsewhere.  Invalid lanes, and lanes
    past ``h_cap`` (an attempt that overflows), are written to a trash row
    that is cut off again."""
    dev = psrc.device
    csum = torch.cumsum(degs, 0)
    off = torch.arange(psrc.shape[0], device=dev) - (csum[fid] - degs[fid])
    keep = pvalid & (off < h_cap)
    idx = torch.full((r_cap + 1, h_cap), n, dtype=torch.int32, device=dev)
    idx[torch.where(keep, fid, r_cap), torch.where(keep, off, 0)] = \
        psrc.to(torch.int32)
    return idx[:r_cap]


def _patched_table(n: int, H_pre: torch.Tensor, patch) -> torch.Tensor:
    """``[n + 2, d]``: H_pre's rows as if the patch had been written, a zero
    row n (the rectangle's sentinel) and a trash row n + 1 that takes the
    patch's padding."""
    table = torch.cat([H_pre[:n], H_pre.new_zeros((2, H_pre.shape[1]))])
    table[torch.where(patch[0] < n, patch[0], n + 1)] = patch[1]
    return table


def _bounded_hop(workload: Workload, layer_fn, layer: int, n: int,
                 state: DeviceState, out_csr: DeviceCSR, in_csr: DeviceCSR,
                 batch: BatchDev, frontier: torch.Tensor, patch,
                 tau: torch.Tensor, *, r_cap: int, e_cap: int, p_cap: int,
                 h_cap: int):
    """One bounded hop layer -> layer+1 (reads only); returns the hop patch
    (rec_idx, x_rows, aux tuple, h_out), the filtered next frontier, the
    overflow flag, the needed sizes (recipients, edges, pulled, max
    in-degree), the int counters (rows_reaggregated, deferred_rows,
    bound_violations) and the floats (max deferred b, max committed |h|).
    """
    agg = workload.agg
    H_pre = state.H[layer]
    with span("DeviceEngine.expand"):
        pos_p = _patch_pos(n, patch[0])
        edst, _, needed = _expand_frontier_edges(n, out_csr, frontier, e_cap)
        overflow = needed > e_cap
        dsts = [edst, batch.add_dst, batch.del_dst]
        if workload.spec.self_dependent:
            dsts.append(frontier)
        rec_idx, pos_r, n_rec = _unique_recipients(n, torch.cat(dsts), r_cap)
        overflow = overflow | (n_rec > r_cap)
        aff_c = rec_idx.clamp(max=n - 1)
        real_row = rec_idx < n
        k_rows = _k_rows(n, state, batch, rec_idx, pos_r, r_cap)

    # refresh-all pull: the affected rows' post-batch in-neighbourhoods,
    # post-update layer-l values read through the previous hop's patch
    with span("DeviceEngine.pull"):
        degs = torch.where(real_row, in_csr.length[aff_c], 0)
        psrc, _, fid, pvalid, pull_total = _ragged_gather(
            n, in_csr.start, in_csr.col, aff_c, degs, p_cap)
        overflow = overflow | (pull_total > p_cap)
        hmax = degs.max()
        pvals = _patched(n, H_pre, pos_p, patch[1], psrc)
        pseg = torch.where(pvalid, fid, r_cap)
        if agg.name == "pna":
            # the first moment is a bag sum over the [r_cap, h_cap]
            # rectangle of in-neighbour ids (embedding_bag); s2 and the max
            # with its witness stay segment ops over the same pull
            overflow = overflow | (hmax > h_cap)
            s1 = embedding_bag(_patched_table(n, H_pre, patch),
                               _bag_rectangle(n, degs, fid, pvalid, psrc,
                                              r_cap, h_cap),
                               padding_idx=n)
            s2, mx, mref = agg.moments(pvals, psrc, pseg, r_cap)
            x_rows = agg.tower(s1, s2, mx, k_rows)
            aux = (s1, s2, mx, mref)
        else:
            x_rows, aux = agg.reaggregate(pvals, psrc, pseg, r_cap, k_rows)

    # ---- apply + certified deferral + filtered propagation ---------------
    with span("DeviceEngine.apply"):
        h_prev = _patched(n, H_pre, pos_p, patch[1], rec_idx)
        h_new = layer_fn(h_prev, x_rows)   # S holds x: normalize is identity
        stored = state.H[layer + 1][aff_c]
        changed = (h_new != stored).any(dim=1) & real_row
        b = (h_new - stored).abs().amax(dim=1)
        defer = changed & (b <= tau)   # tau = 0 at the last hop: never defers
        write = changed & ~defer
        viol = write & (tau > 0)
        h_out = torch.where(write[:, None], h_new, stored)
        frontier_next = torch.where(write, rec_idx, n)
        i_stats = torch.stack([real_row.sum(), defer.sum(), viol.sum()])
        f_stats = torch.stack([torch.where(defer, b, 0.0).max(),
                               torch.where(write, h_new.abs().amax(dim=1),
                                           0.0).max()])
        sizes = torch.stack([n_rec, needed, pull_total, hmax])
    return (rec_idx, x_rows, aux, h_out), frontier_next, overflow, sizes, \
        i_stats, f_stats


@torch.no_grad()
def propagate_bounded(workload: Workload, n: int,
                      caps: tuple[tuple[int, int, int, int], ...],
                      layers: list, state: DeviceState, out_csr: DeviceCSR,
                      in_csr: DeviceCSR, batch: BatchDev,
                      taus: torch.Tensor, *, donate: bool = True):
    """L-hop bounded (attention / top-k / PNA) propagation of a routed
    batch.

    caps[l] = (row_cap, edge_cap, pull_cap, indeg_cap) at hop l: pull_cap
    bounds the affected rows' total in-degree, indeg_cap their largest
    in-degree (the width of PNA's bag rectangle).  ``layers`` are the
    UPDATE modules on the device; ``taus [L+1]`` the per-layer deferral
    budgets (zeros: exact).  Returns (new_state, report) where ``report``
    is one int64 device vector [overflow, sizes [L, 4] flattened, counters
    [3] (rows_reaggregated, deferred_rows, bound_violations), the float32
    bits of [L+1, 2] (max deferred b, max committed |h|) per layer, final
    affected idx]; reading it back is the batch's one wait for the device.
    Same two-phase gated commit as :func:`propagate` (H, S, every A tensor
    and k), so an overflowing attempt commits nothing, in place or not.
    """
    L = workload.spec.n_layers
    fv = batch.feat_idx
    old = state.H[0][fv.clamp(max=n - 1)]
    changed0 = (batch.feat_val != old).any(dim=1) & (fv < n)
    frontier = torch.where(changed0, fv, n)  # hop-0 filter: no-op writes stop
    patch = (fv, batch.feat_val)
    overflow = torch.zeros((), dtype=torch.bool, device=fv.device)
    i_stats = torch.zeros(3, dtype=torch.int64, device=fv.device)
    f_rows = [torch.stack([torch.zeros((), device=fv.device),
                           (batch.feat_val.abs()
                            * (fv < n)[:, None]).max()])]
    hops = []
    sizes = []
    for l in range(L):
        r_cap, e_cap, p_cap, h_cap = caps[l]
        with span(f"DeviceEngine.hop{l}"):
            hop_patch, frontier, ovf, hop_sizes, hop_i, hop_f = _bounded_hop(
                workload, layers[l], l, n, state, out_csr, in_csr, batch,
                frontier, patch, taus[l + 1], r_cap=r_cap, e_cap=e_cap,
                p_cap=p_cap, h_cap=h_cap)
            overflow = overflow | ovf
            i_stats = i_stats + hop_i
        hops.append(hop_patch)
        sizes.append(hop_sizes)
        f_rows.append(hop_f)
        patch = (hop_patch[0], hop_patch[3])

    # ---- phase 2: overflow-gated commit (dropped writes hit row n) -------
    with span("DeviceEngine.commit"):
        if not donate:
            state = state.clone()
        ok = ~overflow

        def gate(idx: torch.Tensor) -> torch.Tensor:
            return torch.where(ok, idx, n)

        state.H[0].index_copy_(0, gate(fv), batch.feat_val)
        for l, (rec, x_rows, aux, h_out) in enumerate(hops):
            state.S[l + 1].index_copy_(0, gate(rec), x_rows)
            state.H[l + 1].index_copy_(0, gate(rec), h_out)
            for a, v in zip(state.A[l + 1], aux):
                a.index_copy_(0, gate(rec), v)
        ones = torch.ones_like(batch.add_w)
        state.k.index_add_(0, gate(batch.add_dst), ones)
        state.k.index_add_(0, gate(batch.del_dst), -ones)
        # the floats travel as their bits: eps and M feed the certified bound
        f_bits = (torch.stack(f_rows) * ok).view(torch.int32).to(torch.int64)
        report = torch.cat([overflow.view(1).to(torch.int64),
                            torch.stack(sizes).flatten(), i_stats * ok,
                            f_bits.flatten(), torch.where(ok, frontier, n)])
    return state, report


class DeviceEngine:
    """Host-side engine around the device propagation, with a warm bucket
    ladder.

    Per-batch cost is frontier-proportional: the adjacency lives in a
    persistent :class:`DeviceCSRMirror` pool, the state tensors are updated
    in place (``donate=True``), ``k`` is maintained on the device, and the
    cap schedule is a sticky ladder (the rung that last fit is retried
    first).

    With ``async_dispatch=True`` the overflow flag of batch t is checked
    lazily: ``apply_batch(t)`` routes t on the host while the device still
    crunches batch t-1, resolves t-1 (retrying it on the next rung if it
    overflowed -- the gated commit guarantees the pre-batch values
    survived), then dispatches t and returns the *previous* batch's
    affected ids; ``flush()`` drains the pipeline.

    Monotonic workloads (max/min) also mirror the in-adjacency, carry the
    contributor refs ``C`` on the device, and report per batch the
    ``last_shrink_events`` / ``last_rows_reaggregated`` /
    ``last_dims_reaggregated`` / ``last_recover_hits`` counters; ``pull``
    picks their SHRINK re-derivation regime (see
    :func:`propagate_monotonic`; None: pairs on a card, rows on the CPU).

    Bounded workloads (attention / top-k / PNA) also mirror the
    in-adjacency and carry the aux state ``A``; per batch they report
    ``last_rows_reaggregated`` / ``last_deferred_rows`` /
    ``last_bound_violations`` (``last_patch_events`` stays 0: the device
    re-aggregates every affected row).  With ``tolerance > 0`` interior
    writes within the certified budget are deferred and
    :meth:`error_bound` gives the per-vertex bound on the published error;
    for the other families ``tolerance > 0`` raises.

    ``use_pallas`` is accepted so engine options move across from the JAX
    package, and is inert: the hop apply always runs through the fused
    kernels, and PNA's first moment always through ``embedding_bag``.
    """

    def __init__(self, workload: Workload, params: list,
                 graph: DynamicGraph, state_np, *, device="cuda",
                 min_bucket: int = 64, donate: bool = True,
                 use_pallas: bool = False, async_dispatch: bool = False,
                 debug_checks: bool = False, warm: bool = True,
                 tolerance: float = 0.0, pull: str | None = None):
        self.bounded = workload.agg.algebra == "bounded"
        self.tolerance = float(tolerance)
        if self.tolerance > 0 and not self.bounded:
            raise ValueError(
                f"tolerance > 0 requires a bounded-recompute workload; "
                f"{workload.spec.name!r} uses the "
                f"{workload.agg.algebra} family")
        self.device = resolve_device(device)
        self.workload = workload
        # the UPDATE modules on the device (copies: the caller's stay where
        # they are) and their tensors under the reference's dict keys
        self.layers = [copy.deepcopy(layer).to(self.device)
                       for layer in params]
        self.params = [{nm: p.detach() for nm, p in layer.named_parameters()}
                       for layer in self.layers]
        # GIN's eps read to the host once here, never per hop
        self.eps = [float(p["eps"]) if "eps" in p else 0.0
                    for p in self.params]
        self.graph = graph
        self.n = graph.n
        self.monotonic = workload.agg.algebra == "monotonic"
        with span("DeviceEngine.upload", setup=True):
            self.state = DeviceState(
                H=tuple(_with_trash_row(h, self.device) for h in state_np.H),
                S=(_upload(state_np.S[0], self.device),)
                + tuple(_with_trash_row(s, self.device)
                        for s in state_np.S[1:]),
                k=_with_trash_row(graph.in_degree, self.device),
                C=(_upload(state_np.C[0], self.device),)
                + tuple(_with_trash_row(c, self.device, fill=-1)
                        for c in state_np.C[1:]) if self.monotonic else (),
                A=self._device_aux(state_np.A) if self.bounded else ())
            self.out_mirror = DeviceCSRMirror(graph.out, device=self.device)
            self.in_mirror = DeviceCSRMirror(graph.inn, device=self.device) \
                if self.monotonic or self.bounded else None
        if self.bounded:
            # host-owned certified-bound accounting: eps is authoritative
            # state (it travels with InferenceState), M and kmax are bounds
            # grown per batch
            L = workload.spec.n_layers
            self._params_np = params_to_numpy(self.layers)
            self._eps = np.zeros(L + 1) if state_np.eps is None \
                else np.array(state_np.eps, dtype=np.float64)
            self._M = np.array([float(np.abs(h).max()) if h.size else 0.0
                                for h in state_np.H], dtype=np.float64)
            self._kmax = float(graph.in_degree.max()) if graph.n else 0.0
            self._zero_taus = torch.zeros(L + 1, device=self.device)
        self.min_bucket = min_bucket
        self.donate = donate
        self.async_dispatch = async_dispatch
        self.debug_checks = debug_checks
        if pull is None:
            pull = "pairs" if self.device.type == "cuda" else "rows"
        self.pull = pull
        self._bucket = min_bucket
        self._rung = 0          # transient retry boost (0 once sizes known)
        self._hw = None         # per-hop high-water marks: [L, 3] (r, e, 0)
        #                         invertible, [L, 4] (r, e, p, pd) monotonic,
        #                         [L, 4] (r, e, p, hmax) bounded
        self._notes = 0         # high-water adoptions (settle-phase counter)
        self.retries = 0        # overflow retries across the stream
        self._pending = None    # (report, batch, caps, k_check)
        self._commit_log = None   # serving: [(commit_idx, affected, rows)]
        self._commits = 0         # batches committed since the log was enabled
        self.commit_log_seconds = 0.0   # host clock in the log's gather + copy
        self._last_affected = np.empty(0, dtype=np.int64)
        self.last_shrink_events = 0
        self.last_rows_reaggregated = 0
        self.last_dims_reaggregated = 0
        self.last_recover_hits = 0
        self.last_patch_events = 0      # bounded: the device is refresh-all
        self.last_deferred_rows = 0
        self.last_bound_violations = 0
        # per-hop needed sizes summed over committed batches (the last
        # hop's recipients against the affected ids give the share of rows
        # the frontier filter passed)
        self.sizes_total = None
        if warm:
            self._warm()

    def _device_aux(self, A_np: list[dict]) -> tuple:
        """Host aux arrays -> per-layer device tuples in aux_names order,
        each with a trash row holding the empty-row value."""
        agg = self.workload.agg
        empty = {nm: a.reshape(-1)[0] for nm, a in agg.init_aux(1, 1).items()}
        return ((),) + tuple(
            tuple(_with_trash_row(np.asarray(a[nm]), self.device,
                                  fill=empty[nm]) for nm in agg.aux_names)
            for a in A_np[1:])

    def error_bound(self) -> np.ndarray:
        """Certified per-vertex inf-norm bound on the published H[L] against
        the full oracle (zeros unless deferrals have happened)."""
        if not self.bounded:
            return np.zeros(self.n, dtype=np.float32)
        E = certified_error_bound(self.workload, self._params_np, self._eps,
                                  self._M, self._kmax)
        return np.full(self.n, E[-1], dtype=np.float32)

    def _taus(self) -> torch.Tensor:
        """Per-layer deferral budgets for the next dispatch, as a device
        tensor (zeros at tolerance 0: the comparison never defers)."""
        if self.tolerance <= 0:
            return self._zero_taus
        t = deferral_budgets(self.workload, self._params_np, self._eps,
                             self._M, self._kmax, self.tolerance)
        return _upload(t.astype(np.float32), self.device)

    # -- cap schedule ------------------------------------------------------
    _HEADROOM = 1.25  # slack over the high-water mark before bucketing

    def _caps(self, rung: int) -> tuple:
        """The bucket capacities at retry rung ``rung``.

        Once a batch has run, the schedule is *adaptive*: each hop's caps
        are the power-of-two bucket over that hop's high-water needed sizes
        (reported back by the propagation), so buckets track the stream's
        actual frontier growth instead of a blind geometric ladder.  The
        first batch (and rung escalations when a retry's sizes were
        truncated) falls back to the geometric schedule.
        """
        nb = next_bucket
        e_max = nb(max(self.graph.num_edges, 1)) * 2
        n_b = nb(self.n)
        L = self.workload.spec.n_layers
        # per-dim shrink channels: pairs are bounded by every dim of every
        # row re-aggregating, pulled elements by every edge read once per
        # dim -- both ceilings must exceed e_max or a batch whose pull
        # volume tops the edge count can never fit and the ladder spins.
        # They are ceilings of the ladder, never allocated as such.
        max_d = nb(max(self.workload.spec.dims))
        pd_max = n_b * max_d
        p_max = e_max * max_d
        scale = 4 ** rung
        caps = []
        if self._hw is not None:
            for l in range(L):
                chans = [max(int(v * self._HEADROOM), 1) * scale
                         for v in self._hw[l]]
                cap_l = (min(nb(chans[0], minimum=self.min_bucket), n_b),
                         min(nb(chans[1], minimum=self.min_bucket), e_max))
                if self.monotonic:
                    cap_l += (min(nb(chans[2], minimum=self.min_bucket),
                                  p_max),
                              min(nb(chans[3], minimum=self.min_bucket),
                                  pd_max))
                elif self.bounded:
                    # pull channel: affected rows' total in-degree (<= |E|);
                    # indeg channel: their largest in-degree (<= n)
                    cap_l += (min(nb(chans[2], minimum=self.min_bucket),
                                  e_max),
                              min(nb(chans[3], minimum=self.min_bucket),
                                  n_b))
                caps.append(cap_l)
            return tuple(caps)
        r = min(nb(self._bucket * scale, minimum=self._bucket), n_b)
        e = min(nb(4 * r), e_max)
        for _ in range(L):
            if self.monotonic:
                caps.append((r, e, min(e, p_max), min(e, pd_max)))
            elif self.bounded:
                caps.append((r, e, min(e, e_max), min(e, n_b)))
            else:
                caps.append((r, e))
            r = min(nb(r * 4), n_b)
            e = min(nb(e * 4), e_max)
        return tuple(caps)

    def _bucketed(self, hw: np.ndarray) -> np.ndarray:
        """Elementwise power-of-two bucket of headroomed high-water marks."""
        v = np.maximum((hw * self._HEADROOM).astype(np.int64),
                       self.min_bucket)
        return 1 << np.ceil(np.log2(v)).astype(np.int64)

    _SETTLE_NOTES = 16  # high-water adoptions before drift-overshoot kicks in

    def _note_sizes(self, sizes: np.ndarray) -> None:
        """Fold one attempt's per-hop needed sizes into the high-water
        marks (an overflowed attempt's sizes aim the retry directly at
        fitting caps).  While the schedule settles, marks adopt the
        observed sizes plainly; once settled, a channel that outgrows its
        bucket gets one extra 2x of headroom, so a drifting stream changes
        caps at most once per doubling instead of once per crossing."""
        s = np.asarray(sizes, dtype=np.int64)
        self._notes += 1
        if self._hw is None:
            self._hw = s
            return
        grown = np.maximum(self._hw, s)
        if self._notes > self._SETTLE_NOTES:
            crossed = self._bucketed(grown) > self._bucketed(self._hw)
            grown = np.where(crossed, grown * 2, grown)
        self._hw = grown

    def _sentinel_batch(self) -> BatchDev:
        n, cap = self.n, self._bucket
        d0 = int(self.state.H[0].shape[1])
        dev = self.device
        return BatchDev(
            ints=torch.full((5, cap), n, dtype=torch.int64, device=dev),
            ws=torch.zeros((2, cap), dtype=torch.float32, device=dev),
            feat_val=torch.zeros((cap, d0), dtype=torch.float32, device=dev))

    @spanned("DeviceEngine.warm", setup=True)
    def _warm(self) -> None:
        """Run the rung-0 cap schedule once on a sentinel (all-padding)
        batch -- a bit-exact no-op on the state that loads the kernels and
        warms the allocator.  The sentinel must not seed the adaptive
        high-water marks (its needs are zero), so they are reset after."""
        self._dispatch(self._sentinel_batch())
        self._resolve()
        self._hw = None
        self._notes = 0
        self._rung = 0

    # -- routing -----------------------------------------------------------
    @spanned("DeviceEngine.route")
    def _route(self, batch):
        """Apply the batch's topology to the host graph and build the padded
        device batch + the mirror rows it touched.  Does NOT refresh the
        mirror (that happens after the previous batch resolves, so a retry
        of batch t-1 still sees t-1's adjacency)."""
        n = self.n
        d0 = int(self.state.H[0].shape[1])
        adds, dels = self.graph.apply_topology(batch.edges)
        # the mirror refreshes every row the batch touched; the monotonic
        # propagation takes each edge's net change, as a max would keep
        # the candidate of an edge added and deleted again
        touched = adds + dels
        if self.monotonic:
            adds, dels = self.graph.net_topology(adds, dels)
        if self.bounded and n:
            self._kmax = max(self._kmax, float(self.graph.in_degree.max()))
        fa = np.array([f.vertex for f in batch.features], dtype=np.int32)
        fx = (np.stack([f.value for f in batch.features]).astype(np.float32)
              if batch.features else np.zeros((0, d0), np.float32))
        # last-writer-wins for duplicate feature updates
        if fa.size:
            uniq, last = np.unique(fa[::-1], return_index=True)
            fa, fx = uniq.astype(np.int32), fx[::-1][last]
        if fa.size and (fa.min() < 0 or fa.max() >= n):
            raise IndexError(f"feature update for a vertex outside [0, {n})")
        need = max(len(fa), len(adds), len(dels), 1)
        if need > self._bucket:
            self._bucket = next_bucket(need, minimum=self.min_bucket)
        cap = self._bucket
        ints = np.full((5, cap), n, dtype=np.int32)
        ws = np.zeros((2, cap), dtype=np.float32)
        ints[0, :fa.size] = fa
        for row, vals in ((1, [e.src for e in adds]),
                          (2, [e.dst for e in adds]),
                          (3, [e.src for e in dels]),
                          (4, [e.dst for e in dels])):
            ints[row, :len(vals)] = vals
        ws[0, :len(adds)] = [e.weight for e in adds]
        ws[1, :len(dels)] = [e.weight for e in dels]
        # int32 on the wire, int64 on the device
        dev_batch = BatchDev(ints=_upload(ints, self.device).to(torch.int64),
                             ws=_upload(ws, self.device),
                             feat_val=_upload(pad_to(fx, cap), self.device))
        out_rows = np.unique(np.array([e.src for e in touched], np.int64)) \
            if touched else np.empty(0, np.int64)
        in_rows = np.unique(np.array([e.dst for e in touched], np.int64)) \
            if touched and self.in_mirror is not None \
            else np.empty(0, np.int64)
        return dev_batch, out_rows, in_rows

    # -- dispatch / resolve ------------------------------------------------
    @spanned("DeviceEngine.propagate")
    def _run(self, dev_batch: BatchDev, caps: tuple):
        if self.bounded:
            return propagate_bounded(
                self.workload, self.n, caps, self.layers, self.state,
                self.out_mirror.csr(), self.in_mirror.csr(), dev_batch,
                self._taus(), donate=self.donate)
        if self.monotonic:
            return propagate_monotonic(
                self.workload, self.n, caps, self.params, self.state,
                self.out_mirror.csr(), self.in_mirror.csr(), dev_batch,
                donate=self.donate, pull=self.pull)
        return propagate(self.workload, self.n, caps, self.params, self.eps,
                         self.state, self.out_mirror.csr(), dev_batch,
                         donate=self.donate)

    def _dispatch(self, dev_batch: BatchDev) -> None:
        if self._pending is not None:
            raise RuntimeError("a batch is already in flight")
        caps = self._caps(self._rung)
        # optimistic commit: on overflow the gated writes all went to the
        # trash row, so the state holds the pre-batch values and the retry
        # is safe
        self.state, report = self._run(dev_batch, caps)
        k_check = self.graph.in_degree.copy() if self.debug_checks else None
        self._pending = (report, dev_batch, caps, k_check)

    def _read(self, report: torch.Tensor):
        """(overflow, sizes [L, channels], counters, final ids) from one
        device report -- the batch's single wait for the device.  Counters:
        None (invertible), [4] (monotonic), or ([3] ints, [L+1, 2] floats)
        (bounded)."""
        L = self.workload.spec.n_layers
        with span("DeviceEngine.wait"):
            rep = report.cpu().numpy()
        ch = 3 if not (self.monotonic or self.bounded) else 4
        end = 1 + ch * L
        sizes = rep[1:end].reshape(L, ch)
        if self.monotonic:
            return bool(rep[0]), sizes, rep[end:end + 4], rep[end + 4:]
        if self.bounded:
            f_end = end + 3 + 2 * (L + 1)
            floats = rep[end + 3:f_end].astype(np.int32).view(np.float32)
            return bool(rep[0]), sizes, \
                (rep[end:end + 3], floats.reshape(L + 1, 2)), rep[f_end:]
        return bool(rep[0]), sizes, None, rep[end:]

    def _resolve(self) -> np.ndarray:
        """Check the in-flight batch's overflow flag, retrying it with
        fitting caps if needed; returns its affected vertex ids."""
        if self._pending is None:
            return self._last_affected
        report, dev_batch, caps, k_check = self._pending
        overflow, sizes, stats, final = self._read(report)
        while overflow:
            self.retries += 1
            # the failed attempt reported what it actually needed; aim the
            # retry straight at fitting caps (truncated attempts may still
            # under-report downstream hops -- the rung fallback guarantees
            # progress)
            self._note_sizes(sizes)
            new_caps = self._caps(0)
            if new_caps == caps:
                self._rung += 1
                new_caps = self._caps(self._rung)
                if new_caps == caps:
                    # leave the engine diagnosable: the batch is lost but
                    # the state still holds the pre-batch values
                    self._pending = None
                    raise RuntimeError("bucket ladder saturated while still "
                                       "overflowing -- graph inconsistency?")
            else:
                self._rung = 0
            with span("DeviceEngine.retry"):
                self.state, report = self._run(dev_batch, new_caps)
                overflow, sizes, stats, final = self._read(report)
            caps = new_caps
        self._note_sizes(sizes)
        self._rung = 0
        self._last_affected = final[final < self.n].astype(np.int64)
        self.sizes_total = sizes if self.sizes_total is None \
            else self.sizes_total + sizes
        if self.bounded:
            i_s, f_s = stats
            (self.last_rows_reaggregated, self.last_deferred_rows,
             self.last_bound_violations) = (int(v) for v in i_s)
            self._eps = np.maximum(self._eps, f_s[:, 0].astype(np.float64))
            self._M = np.maximum(self._M, f_s[:, 1].astype(np.float64))
        elif stats is not None:
            (self.last_shrink_events, self.last_rows_reaggregated,
             self.last_dims_reaggregated, self.last_recover_hits) = \
                (int(v) for v in stats)
        if k_check is not None:
            np.testing.assert_allclose(
                self.state.k[:self.n].cpu().numpy(), k_check,
                err_msg="device k drifted from host in-degree")
        if self._commit_log is not None:
            self._log_commit()
        self._pending = None
        return self._last_affected

    def _log_commit(self) -> None:
        """Record the batch that just committed: its final-layer rows,
        gathered on the device (the ids are < n, so the trash row is never
        read) and copied to the host.  The copy is a blocking one: the next
        dispatch writes H[-1] in place, and the serving layer publishes
        these rows from another thread, so they must be on the host before
        the tuple is logged."""
        t0 = time.perf_counter()
        self._commits += 1
        aff = self._last_affected
        H = self.state.H[-1]
        if aff.size:
            rows = H.index_select(
                0, torch.as_tensor(aff, device=self.device)).cpu().numpy()
        else:
            rows = np.zeros((0, int(H.shape[1])), np.float32)
        self._commit_log.append((self._commits, aff.copy(), rows))
        self.commit_log_seconds += time.perf_counter() - t0

    # -- main entry --------------------------------------------------------
    def apply_batch(self, batch) -> np.ndarray:
        """Apply one routed batch; returns final-hop affected vertex ids.

        Synchronous by default.  With ``async_dispatch`` the host routing
        of this batch overlaps the device compute of the previous one and
        the return value is the *previous* batch's affected ids (one batch
        of pipeline latency; ``flush()`` drains exactly).
        """
        dev_batch, out_rows, in_rows = self._route(batch)
        prev_affected = self._resolve()
        self.out_mirror.refresh_rows(out_rows)
        if self.in_mirror is not None:
            self.in_mirror.refresh_rows(in_rows)
        self._dispatch(dev_batch)
        if self.async_dispatch:
            return prev_affected
        return self._resolve()

    def flush(self) -> np.ndarray:
        """Drain the pipeline (resolve any in-flight batch)."""
        return self._resolve()

    # -- committed-snapshot handle (serving layer) -------------------------
    def enable_commit_log(self) -> None:
        """Start recording, per committed batch, the (affected ids, final-
        layer rows) patch -- captured at resolve time, the instant the
        gated commit is known to have landed, so the serving layer can
        publish snapshots that trail the async pipeline without ever
        observing a half-committed batch."""
        self._resolve()          # batches already in flight predate the log
        self._commit_log = []

    def drain_commits(self) -> list:
        """Return + clear the commits recorded since the last drain, in
        commit order: ``[(commit_idx, affected_ids, H_final_rows)]``.  Does
        not force the in-flight batch: an async engine's latest batch
        appears only after its resolve (or ``flush``)."""
        if self._commit_log is None:
            raise RuntimeError("enable_commit_log() first")
        out, self._commit_log = self._commit_log, []
        return out

    # -- host views --------------------------------------------------------
    def host_H(self) -> list[np.ndarray]:
        """Every layer's embeddings on the host (trash row excluded)."""
        self._resolve()
        return [h[:self.n].cpu().numpy().copy() for h in self.state.H]
