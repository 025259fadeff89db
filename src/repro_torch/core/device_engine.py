"""Device-resident incremental RIPPLE propagation (single replica),
invertible family.

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
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from repro_torch.kernels.delta_apply import delta_apply
from repro_torch.kernels.mlp_apply import mlp_apply
from repro_torch.utils import next_bucket, pad_to, resolve_device

from .graph import _GROW, _MIN_SLACK, DynamicGraph, flat_row_indices
from .workloads import Workload


def _upload(arr: np.ndarray, device: torch.device) -> torch.Tensor:
    """Host array -> device tensor; on a card through pinned memory and an
    asynchronous copy (the caching host allocator keeps the pinned block
    alive until the copy has run)."""
    t = torch.from_numpy(np.ascontiguousarray(arr))
    if device.type == "cuda":
        return t.pin_memory().to(device, non_blocking=True)
    return t.clone()


def _with_trash_row(arr: np.ndarray, device: torch.device) -> torch.Tensor:
    """``arr`` on the device with one zero row appended at index n."""
    out = np.zeros((arr.shape[0] + 1,) + arr.shape[1:], dtype=np.float32)
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
        slot_w = _upload(self.half.w[src_idx].astype(np.float32), self.device)
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

    def clone(self) -> "DeviceState":
        return DeviceState(H=tuple(h.clone() for h in self.H),
                           S=tuple(s.clone() for s in self.S),
                           k=self.k.clone())


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
    f_cap = frontier.shape[0]
    dev = frontier.device
    degs = torch.where(frontier < n, csr.length[frontier.clamp(max=n - 1)], 0)
    csum = torch.cumsum(degs, 0)
    total = csum[-1]

    # ragged expansion of frontier out-edges into the static edge bucket
    e = torch.arange(e_cap, device=dev)
    fid_c = torch.searchsorted(csum, e, right=True).clamp(max=f_cap - 1)
    off = e - (csum[fid_c] - degs[fid_c])
    vsrc = frontier[fid_c]
    evalid = e < total
    flat = torch.where(evalid, csr.start[vsrc.clamp(max=n - 1)] + off, 0)
    edst = torch.where(evalid, csr.col[flat], n)
    ew = csr.w[flat] if weighted else torch.ones(e_cap, device=dev)
    evals = delta[fid_c] * (ew * evalid)[:, None]

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


def _segment_sum(vals: torch.Tensor, seg: torch.Tensor,
                 r_cap: int) -> torch.Tensor:
    """Rows of ``vals`` summed by segment id into r_cap rows (id r_cap is
    the trash segment).  On a card the atomics make the order of the sum
    vary from run to run."""
    out = torch.zeros((r_cap + 1,) + vals.shape[1:], dtype=vals.dtype,
                      device=vals.device)
    return out.index_add_(0, seg, vals)[:r_cap]


def _k_rows(n: int, state: DeviceState, batch: BatchDev,
            rec_idx: torch.Tensor, pos_r: torch.Tensor,
            r_cap: int) -> torch.Tensor:
    """Post-batch in-degree at the affected rows, from the batch's add/del
    counts -- O(bucket) segment sums instead of materializing a full [n]
    updated-degree vector (the full vector is only written once, in the
    gated phase-2 commit)."""
    def cnt(dst: torch.Tensor) -> torch.Tensor:
        return _segment_sum((dst < n).to(torch.float32),
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
        r_cap, e_cap = caps[l]
        all_dst, all_val, needed = _hop_messages(
            n, state.H[l], csr, frontier, delta, batch,
            weighted=spec.weighted, self_dep=spec.self_dependent,
            e_cap=e_cap)
        rec_idx, pos_r, n_rec = _unique_recipients(n, all_dst, r_cap)
        overflow = overflow | (needed > e_cap) | (n_rec > r_cap)
        sizes.append(torch.stack([n_rec, needed, torch.zeros_like(needed)]))
        mailbox = _segment_sum(all_val, pos_r[all_dst.clamp(max=n)], r_cap)
        k_rows = _k_rows(n, state, batch, rec_idx, pos_r, r_cap)
        S_rows, h_new, delta = _apply_hop(
            workload, params[l], eps[l], l, n, state, k_rows, patch,
            rec_idx, mailbox)
        hops.append((rec_idx, S_rows, h_new))
        patch = (rec_idx, h_new)
        frontier = rec_idx

    # ---- phase 2: overflow-gated commit (dropped writes hit row n) -------
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

    ``use_pallas`` is accepted so engine options move across from the JAX
    package, and is inert: the hop apply always runs through the fused
    kernels.  ``tolerance`` belongs to the bounded family; > 0 raises.
    """

    def __init__(self, workload: Workload, params: list,
                 graph: DynamicGraph, state_np, *, device="cuda",
                 min_bucket: int = 64, donate: bool = True,
                 use_pallas: bool = False, async_dispatch: bool = False,
                 debug_checks: bool = False, warm: bool = True,
                 tolerance: float = 0.0):
        if float(tolerance) > 0:
            raise ValueError(
                f"tolerance > 0 requires a bounded-recompute workload; "
                f"{workload.spec.name!r} uses the "
                f"{workload.agg.algebra} family")
        self.device = resolve_device(device)
        self.workload = workload
        # per-layer parameter tensors under the reference's dict keys
        self.params = [{nm: p.detach().to(self.device)
                        for nm, p in layer.named_parameters()}
                       for layer in params]
        # GIN's eps read to the host once here, never per hop
        self.eps = [float(p["eps"]) if "eps" in p else 0.0
                    for p in self.params]
        self.graph = graph
        self.n = graph.n
        self.state = DeviceState(
            H=tuple(_with_trash_row(h, self.device) for h in state_np.H),
            S=(_upload(state_np.S[0], self.device),)
            + tuple(_with_trash_row(s, self.device) for s in state_np.S[1:]),
            k=_with_trash_row(graph.in_degree, self.device))
        self.min_bucket = min_bucket
        self.donate = donate
        self.async_dispatch = async_dispatch
        self.debug_checks = debug_checks
        self.out_mirror = DeviceCSRMirror(graph.out, device=self.device)
        self._bucket = min_bucket
        self._rung = 0          # transient retry boost (0 once sizes known)
        self._hw = None         # per-hop high-water marks: [L, 3] (r, e, 0)
        self._notes = 0         # high-water adoptions (settle-phase counter)
        self.retries = 0        # overflow retries across the stream
        self._pending = None    # (report, batch, caps, k_check)
        self._last_affected = np.empty(0, dtype=np.int64)
        if warm:
            self._warm()

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
        scale = 4 ** rung
        if self._hw is not None:
            caps = []
            for l in range(L):
                chans = [max(int(v * self._HEADROOM), 1) * scale
                         for v in self._hw[l]]
                caps.append((min(nb(chans[0], minimum=self.min_bucket), n_b),
                             min(nb(chans[1], minimum=self.min_bucket),
                                 e_max)))
            return tuple(caps)
        r = min(nb(self._bucket * scale, minimum=self._bucket), n_b)
        e = min(nb(4 * r), e_max)
        caps = []
        for _ in range(L):
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
    def _route(self, batch):
        """Apply the batch's topology to the host graph and build the padded
        device batch + the mirror rows it touched.  Does NOT refresh the
        mirror (that happens after the previous batch resolves, so a retry
        of batch t-1 still sees t-1's adjacency)."""
        n = self.n
        d0 = int(self.state.H[0].shape[1])
        adds, dels = self.graph.apply_topology(batch.edges)
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
        touched = adds + dels
        out_rows = np.unique(np.array([e.src for e in touched], np.int64)) \
            if touched else np.empty(0, np.int64)
        return dev_batch, out_rows

    # -- dispatch / resolve ------------------------------------------------
    def _run(self, dev_batch: BatchDev, caps: tuple):
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
        """(overflow, sizes [L, 3], final ids) from one device report --
        the batch's single wait for the device."""
        L = self.workload.spec.n_layers
        rep = report.cpu().numpy()
        return bool(rep[0]), rep[1:1 + 3 * L].reshape(L, 3), rep[1 + 3 * L:]

    def _resolve(self) -> np.ndarray:
        """Check the in-flight batch's overflow flag, retrying it with
        fitting caps if needed; returns its affected vertex ids."""
        if self._pending is None:
            return self._last_affected
        report, dev_batch, caps, k_check = self._pending
        overflow, sizes, final = self._read(report)
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
            self.state, report = self._run(dev_batch, new_caps)
            caps = new_caps
            overflow, sizes, final = self._read(report)
        self._note_sizes(sizes)
        self._rung = 0
        self._last_affected = final[final < self.n].astype(np.int64)
        if k_check is not None:
            np.testing.assert_allclose(
                self.state.k[:self.n].cpu().numpy(), k_check,
                err_msg="device k drifted from host in-degree")
        self._pending = None
        return self._last_affected

    # -- main entry --------------------------------------------------------
    def apply_batch(self, batch) -> np.ndarray:
        """Apply one routed batch; returns final-hop affected vertex ids.

        Synchronous by default.  With ``async_dispatch`` the host routing
        of this batch overlaps the device compute of the previous one and
        the return value is the *previous* batch's affected ids (one batch
        of pipeline latency; ``flush()`` drains exactly).
        """
        dev_batch, out_rows = self._route(batch)
        prev_affected = self._resolve()
        self.out_mirror.refresh_rows(out_rows)
        self._dispatch(dev_batch)
        if self.async_dispatch:
            return prev_affected
        return self._resolve()

    def flush(self) -> np.ndarray:
        """Drain the pipeline (resolve any in-flight batch)."""
        return self._resolve()

    def enable_commit_log(self) -> None:
        raise NotImplementedError(
            "the serving layer's commit log is not ported yet: ROADMAP.md "
            "Queue 1 item 9")

    # -- host views --------------------------------------------------------
    def host_H(self) -> list[np.ndarray]:
        """Every layer's embeddings on the host (trash row excluded)."""
        self._resolve()
        return [h[:self.n].cpu().numpy().copy() for h in self.state.H]
