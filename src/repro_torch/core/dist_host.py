"""Host driver for distributed RIPPLE: the paper's leader (§5.2), run on
every rank.

**Execution model: SPMD ranks, one process per rank.**  The JAX package
runs one host "leader" that drives a ``shard_map`` over a mesh inside one
process.  Torch has no such program inside one process, so here every rank
builds the same session from the same ``SessionConfig`` with the same
seeds, and runs the leader's host work itself on its own copy of the host
graph: partitioning, relabeling, routing, packing and the cap ladder.
That work is deterministic, so nothing is broadcast.  Each rank uploads
only its own block of every ``[P, ...]`` buffer (the state, the
partitioned CSR, the routed batch), and only the device collectives cross
ranks -- the paper's communication model, in which the leader's uploads
are not communication.  Results (``query``, ``gather_state``, the
affected ids, the counters) come back on every rank, and a call that
returns them is collective: every rank makes it.

Owns partitioning, relabeling, bootstrap scatter, per-batch update routing
(updates go to the owner of the hop-0 vertex; degree changes for cut edges
are the paper's "no-compute" topology sync, realized here as a per-batch
upload of the in-degree block), buffer packing, and the adaptive capacity
ladder.

State contract: the engine is built from the normalized ``(workload,
params, graph, state)`` signature -- the host ``InferenceState`` is
*scattered* onto the ranks (re-partition + relabel, no recomputation), and
``gather_state`` writes the ranks' state back into the same host arrays in
original vertex-id order, so hot-swapping host <-> mesh is exact.

Warm path:

 - **State lives on the ranks.**  H/S/C blocks (``[n_local + 1, d / M]``,
   one trash row) are placed once and, by default, updated in place
   through every dispatch; the gated commit leaves them bit-exact on
   overflow, so a ladder retry re-dispatches the same tensors.
 - **Resident partitioned CSR.**  The stacked ``[P, pool]`` host mirror
   stays authoritative; each rank keeps its own block on the device and
   per-batch maintenance copies only its touched rows there (a full upload
   happens only on ``rebuild``).
 - **Adaptive cap ladder.**  Capacities come from per-channel high-water
   marks (rows/edges/halo/pull/pairs, reported by the propagate itself,
   max-reduced over the ranks) bucketed with headroom, so every rank takes
   the same rung; overflow retries jump straight to fitting rungs because
   the size report is valid even on failed attempts.
 - **Async overlap.**  With ``async_dispatch=True``, ``apply_batch`` routes
   batch t+1 on the host while the device still computes batch t; the
   previous batch is resolved (its one readback) just before the next
   dispatch, and the CSR refresh happens between resolve and dispatch.

Monotonic workloads (max/min) also carry contributor refs ``C``
(relabeled ids; -1 kept) and the in-adjacency in every mode; like the
port's device engine they take each edge's net change per batch
(``DynamicGraph.net_topology``).
"""
from __future__ import annotations

import time

import numpy as np
import torch
from torch import nn

from repro_torch.utils import next_bucket

from .device_engine import _upload, _with_trash_row
from .distributed import (DistBatch, DistCSR, MeshComm,
                          make_monotonic_propagate, make_rc_propagate,
                          make_ripple_propagate, tp_param_shards)
from .graph import _GROW, _MIN_SLACK, DynamicGraph, UpdateBatch, \
    flat_row_indices
from .partition import ldg_partition
from .state import InferenceState, params_to_numpy
from .workloads import Workload

_HEADROOM = 1.25       # cap = next power of two above hw * headroom
_SETTLE_NOTES = 16     # after this many size reports, growth -> overshoot


class PartitionedCSR:
    """Stacked ``[P, pool]`` CSR mirror of one adjacency half, maintained
    incrementally across streaming updates, with this rank's block
    resident on its device.

    Rows are the ``n_local`` vertices of each partition; each row owns a
    slack-padded slot range inside its partition's pool (sentinel col =
    ``n_pad``).  ``refresh_rows`` re-copies only the rows a batch touched
    from the backing ``_AdjHalf`` -- on the host for every partition (every
    rank keeps the whole mirror, so all take the same rebuild decisions)
    and on the device for this rank's rows only, so a block is uploaded in
    full exactly once per ``rebuild`` (``uploads`` counts them).
    ``rebuild`` re-lays-out everything with fresh slack and a power-of-two
    pool, and runs only on row overflow.
    """

    def __init__(self, half, part, comm: MeshComm):
        self.half = half            # the relabeled graph's _AdjHalf
        self.part = part
        self.comm = comm
        self.rebuilds = 0
        self.row_refreshes = 0
        self.uploads = 0
        self.rebuild()

    def rebuild(self) -> None:
        P_, nl = self.part.n_parts, self.part.n_local
        deg = self.half.length.astype(np.int64)            # [n_pad]
        cap = np.maximum((deg * _GROW).astype(np.int64) + _MIN_SLACK, deg)
        cap2d = cap.reshape(P_, nl)
        start2d = np.zeros((P_, nl), dtype=np.int64)
        np.cumsum(cap2d[:, :-1], axis=1, out=start2d[:, 1:])
        pool = next_bucket(int((start2d[:, -1] + cap2d[:, -1]).max()) + 1)
        col = np.full((P_, pool), self.part.n_pad, dtype=np.int64)
        w = np.zeros((P_, pool), dtype=np.float32)
        row_base = np.arange(P_, dtype=np.int64).repeat(nl) * pool \
            + start2d.ravel()
        src_idx = flat_row_indices(self.half.start, deg)
        dst_idx = flat_row_indices(row_base, deg)
        col.ravel()[dst_idx] = self.half.col[src_idx]
        w.ravel()[dst_idx] = self.half.w[src_idx]
        self.pool = pool
        self.col, self.w = col, w
        self.start = start2d
        self.length = deg.reshape(P_, nl).copy()
        self.cap = cap2d
        self.rebuilds += 1
        me, dev = self.comm.me, self.comm.device
        self._dev = DistCSR(col=_upload(self.col[me], dev),
                            w=_upload(self.w[me], dev),
                            start=_upload(self.start[me], dev),
                            length=_upload(self.length[me], dev))
        self.uploads += 1

    def refresh_rows(self, rows: np.ndarray) -> None:
        """Re-copy the given (relabeled global id) rows from the backing
        half -- the per-batch path after topology updates mutate the graph.
        The caller must not have a propagate in flight that reads them."""
        rows = np.asarray(rows, dtype=np.int64)
        if rows.size == 0:
            return
        nl = self.part.n_local
        p, r = rows // nl, rows % nl
        deg = self.half.length[rows]
        if np.any(deg > self.cap[p, r]):
            self.rebuild()          # some row outgrew its slack
            return
        row_base = p * self.pool + self.start[p, r]
        src_idx = flat_row_indices(self.half.start[rows], deg)
        dst_idx = flat_row_indices(row_base, deg)
        self.col.ravel()[dst_idx] = self.half.col[src_idx]
        self.w.ravel()[dst_idx] = self.half.w[src_idx]
        self.length[p, r] = deg
        self.row_refreshes += int(rows.size)
        # ---- this rank's rows on its device: one packed upload ----------
        me = self.comm.me
        mine = p == me
        if not mine.any():
            return
        slot_mine = np.repeat(mine, deg)
        slots = dst_idx[slot_mine] - me * self.pool
        kb = int(slots.size)
        ints = _upload(np.concatenate([slots, self.half.col[src_idx][
            slot_mine], r[mine], deg[mine]]).astype(np.int64),
            self.comm.device)
        slot_w = _upload(self.half.w[src_idx][slot_mine].astype(np.float32),
                         self.comm.device)
        slot_idx, slot_col = ints[:kb], ints[kb:2 * kb]
        row_idx, row_len = ints[2 * kb:].split(int(mine.sum()))
        self._dev.col.index_copy_(0, slot_idx, slot_col)
        self._dev.w.index_copy_(0, slot_idx, slot_w)
        self._dev.length.index_copy_(0, row_idx, row_len)

    def device(self) -> DistCSR:
        return self._dev


class DistEngine:
    """Distributed incremental (or recompute-baseline) streaming engine;
    see the module docstring for how the ranks share the work."""

    def __init__(self, workload: Workload, params: list,
                 graph: DynamicGraph, state: InferenceState, mesh, *,
                 mode: str = "ripple", data_axes: tuple = ("data",),
                 seed: int = 0, min_bucket: int = 32, donate: bool = True,
                 async_dispatch: bool = False, warm: bool = True):
        if mode not in ("ripple", "rc"):
            raise ValueError(f"mode must be 'ripple' or 'rc', not {mode!r}")
        if workload.agg.algebra == "bounded":
            raise ValueError(
                f"{workload.spec.name!r}: the bounded family has no "
                "distributed propagation (the dist adapters declare a host "
                "fallback for it)")
        self.workload = workload
        self.mesh = mesh
        self.mode = mode
        self.min_bucket = min_bucket
        self.data_axes = tuple(data_axes)
        self.donate = donate
        self._async = async_dispatch
        # every process group this engine uses, made here, collectively
        self.comm = MeshComm(mesh, self.data_axes)
        self.n_parts = self.comm.n_parts
        self.M = self.comm.M
        self.device = self.comm.device

        # the session's graph stays authoritative in ORIGINAL ids; the
        # engine mirrors every effective update into its relabeled copy
        self.host_graph = graph
        src, dst, w = graph.coo()
        t0 = time.perf_counter()
        self.part = ldg_partition(graph.n, src, dst, self.n_parts, seed=seed)
        self.partition_seconds = time.perf_counter() - t0
        self.n_local = self.part.n_local
        n_pad = self.part.n_pad
        # relabeled graph over padded id space (pad vertices are isolated)
        self.g = DynamicGraph(n_pad, self.part.new_of_old[src],
                              self.part.new_of_old[dst], w)
        # host copies of the whole weights (elastic_resize passes them on)
        self.params = params_to_numpy(params) \
            if isinstance(params[0], nn.Module) else params
        self._params = [
            {k: torch.as_tensor(v, dtype=torch.float32, device=self.device)
             for k, v in p.items()}
            for p in tp_param_shards(self.params, self.M, self.comm.m)]
        self.monotonic = workload.agg.algebra == "monotonic"
        # scatter the host state onto this rank's block: a relabel, not a
        # recomputation, so host -> mesh swap is exact
        nl1 = self.n_local + 1
        self.H = tuple(self._scatter(h) for h in state.H)
        self.S = (torch.zeros((nl1, 1), device=self.device),) \
            + tuple(self._scatter(s) for s in state.S[1:])
        self.C = (torch.zeros((nl1, 1), dtype=torch.int32,
                              device=self.device),) \
            + tuple(self._scatter_ids(c) for c in state.C[1:]) \
            if self.monotonic else None
        self.out_csr = PartitionedCSR(self.g.out, self.part, self.comm)
        # the in-adjacency backs RC's pull-everything re-aggregation AND the
        # monotonic family's shrink re-aggregation requests
        self.in_csr = PartitionedCSR(self.g.inn, self.part, self.comm) \
            if (mode == "rc" or self.monotonic) else None
        self._d_max = max(workload.spec.dims)

        # warm-path machinery
        self._fn_cache: dict = {}
        self._dispatched: set = set()
        # Torch compiles nothing: ``compiles`` counts the distinct cap
        # configurations dispatched, which is what the JAX package's
        # compile cache was keyed on
        self.compiles = 0
        self.cap_transitions = 0   # dispatches whose caps differ from last
        self.retries = 0           # overflow re-dispatches
        self._last_capsx = None
        self._hw = None            # [L, 5] high-water marks
        self._notes = 0
        self._rung = 0
        self._bucket = min_bucket  # batch-buffer bucket
        self._pending = None
        self._last_affected = np.empty(0, dtype=np.int64)

        self.last_comm = None  # per-hop exchanged slot counts (paper fig12c)
        self.last_xpod = None  # hierarchical halo [cross_before, cross_after]
        self.last_host_seconds = 0.0   # routing + CSR maintenance per batch
        self.last_shrink_events = 0       # monotonic: SHRINK messages
        self.last_rows_reaggregated = 0   # monotonic: rows re-aggregated
        self.last_dims_reaggregated = 0   # monotonic: (row, dim) cells pulled
        self.last_recover_hits = 0        # monotonic: probe-recovered cells
        if warm:
            self._warm()

    @property
    def ladder_rungs(self) -> int:
        """Distinct cap configurations visited (transitions + the first)."""
        return self.cap_transitions + 1

    # -- layout transforms -------------------------------------------------
    def _mine(self, stacked: np.ndarray) -> np.ndarray:
        """``[P, rows, d]`` -> this rank's ``[rows, d / M]`` block: its
        partition, its model rank's columns."""
        d, M, m = stacked.shape[-1], self.M, self.comm.m
        if d % M:
            raise ValueError(f"width {d} does not split over {M} model "
                             f"ranks")
        return np.ascontiguousarray(
            stacked[self.comm.me][:, d // M * m: d // M * (m + 1)])

    def _scatter(self, arr: np.ndarray) -> torch.Tensor:
        """[n, d] host array in original id order -> this rank's block,
        with a zero trash row."""
        pad = np.zeros((self.part.n_pad, arr.shape[1]), dtype=np.float32)
        pad[self.part.new_of_old] = arr
        return _with_trash_row(
            self._mine(pad.reshape(self.n_parts, self.n_local, -1)),
            self.device)

    def _scatter_ids(self, arr: np.ndarray) -> torch.Tensor:
        """Contributor refs: [n, d] original-id refs -> this rank's block of
        relabeled refs (-1 kept; pad and trash rows are -1)."""
        relab = np.where(arr >= 0,
                         self.part.new_of_old[np.maximum(arr, 0)],
                         -1).astype(np.int32)
        pad = np.full((self.part.n_pad, arr.shape[1]), -1, dtype=np.int32)
        pad[self.part.new_of_old] = relab
        return _with_trash_row(
            self._mine(pad.reshape(self.n_parts, self.n_local, -1)),
            self.device, fill=-1)

    def _gather(self, t: torch.Tensor) -> np.ndarray:
        """Every rank's block of one layer -> [n, d] in original id order
        (an all-gather over the data ranks and the model column shards;
        collective)."""
        nl = self.n_local
        blocks = self.comm.gather(t[:nl], self.comm.all)  # [P*M, nl, d/M]
        full = blocks.reshape(self.n_parts, self.M, nl, -1) \
            .permute(0, 2, 1, 3).reshape(self.part.n_pad, -1)
        return full.cpu().numpy()[self.part.new_of_old]

    def gather_state(self, state: InferenceState) -> InferenceState:
        """Write the ranks' state back into ``state`` in place (original
        vertex-id order) -- the exit half of exact migration.
        Collective."""
        self._resolve()
        for l, h in enumerate(self.H):
            state.H[l][...] = self._gather(h)
        for l in range(1, len(self.S)):
            state.S[l][...] = self._gather(self.S[l])
        if self.monotonic and state.C is not None:
            for l in range(1, len(self.C)):
                relab = self._gather(self.C[l])
                state.C[l][...] = np.where(
                    relab >= 0, self.part.old_of_new[np.maximum(relab, 0)],
                    -1)
        state.k[...] = self.host_graph.in_degree
        return state

    def gather_H(self) -> list[np.ndarray]:
        """Embeddings back in ORIGINAL vertex id order.  Collective."""
        self._resolve()
        return [self._gather(h) for h in self.H]

    def query(self, vertices: np.ndarray) -> np.ndarray:
        """Final-layer rows for ``vertices``.  Collective."""
        vertices = np.asarray(vertices, dtype=np.int64)
        if vertices.size and (vertices.min() < 0
                              or vertices.max() >= self.part.n):
            raise IndexError(f"query vertices outside [0, {self.part.n})")
        self._resolve()
        return self._gather(self.H[-1])[vertices]

    # -- routing (host side; does NOT touch device buffers) ----------------
    def _route(self, batch: UpdateBatch):
        """Apply topology to both host graph mirrors and pack padded
        per-partition numpy buffers.  The device CSR refresh is left to
        the caller (it must not race an in-flight propagate).

        Returns ``(np_batch, out_rows, in_rows)`` where the row arrays are
        the relabeled global ids whose CSR rows the batch touched."""
        P_, nl, n_pad = self.n_parts, self.n_local, self.part.n_pad
        relabel = self.part.new_of_old
        adds, dels = self.host_graph.apply_topology(batch.edges)
        r_adds = [(int(relabel[e.src]), int(relabel[e.dst]), e.weight)
                  for e in adds]
        r_dels = [(int(relabel[e.src]), int(relabel[e.dst]), e.weight)
                  for e in dels]
        for s, d, wt in r_adds:
            self.g.add_edge(s, d, wt)
        for s, d, _ in r_dels:
            self.g.delete_edge(s, d)
        touched = r_adds + r_dels
        out_rows = np.unique([s for s, _, _ in touched]) if touched \
            else np.empty(0, np.int64)
        in_rows = np.unique([d for _, d, _ in touched]) if touched \
            else np.empty(0, np.int64)
        if self.monotonic:
            # each edge's net change: a max would keep the candidate of an
            # edge the batch added and deleted again
            adds, dels = self.host_graph.net_topology(adds, dels)
            r_adds = [(int(relabel[e.src]), int(relabel[e.dst]), e.weight)
                      for e in adds]
            r_dels = [(int(relabel[e.src]), int(relabel[e.dst]), e.weight)
                      for e in dels]

        feats: dict[int, dict] = {p: {} for p in range(P_)}
        n_feats = np.zeros(P_, dtype=np.int64)
        for f in batch.features:
            g_id = int(relabel[f.vertex])
            feats[g_id // nl][g_id % nl] = f.value   # last writer wins
            n_feats[g_id // nl] += 1
        radds: dict[int, list] = {p: [] for p in range(P_)}
        for s, d, wt in r_adds:
            radds[s // nl].append((s % nl, d, wt))
        rdels: dict[int, list] = {p: [] for p in range(P_)}
        for s, d, wt in r_dels:
            rdels[s // nl].append((s % nl, d, wt))

        # one monotonically-growing bucket for every batch channel -- cap
        # drift never mints a new shape once the stream settles
        need = max(int(n_feats.max()),
                   max(len(v) for v in radds.values()),
                   max(len(v) for v in rdels.values()), 1)
        b = max(self.min_bucket, next_bucket(need))
        if b > self._bucket:
            self._bucket = b
        cap = self._bucket
        d0 = int(self.workload.spec.dims[0])

        ints = np.empty((5, P_, cap), dtype=np.int32)
        ints[[0, 1, 3]] = nl
        ints[[2, 4]] = n_pad
        ws = np.zeros((2, P_, cap), dtype=np.float32)
        fval = np.zeros((P_, cap, d0), dtype=np.float32)
        for p in range(P_):
            for i, (lid, v) in enumerate(feats[p].items()):
                ints[0, p, i] = lid
                fval[p, i] = v
            for row, lst in ((1, radds[p]), (3, rdels[p])):
                for i, (ls, gd, wt) in enumerate(lst):
                    ints[row, p, i], ints[row + 1, p, i] = ls, gd
                    ws[row // 2, p, i] = wt
        return (ints, ws, fval), out_rows, in_rows

    def _upload_batch(self, np_b):
        """This rank's block of the packed batch + its in-degree block."""
        ints, ws, fval = np_b
        me = self.comm.me
        db = DistBatch(ints=_upload(np.ascontiguousarray(ints[:, me]),
                                    self.device).to(torch.int64),
                       ws=_upload(np.ascontiguousarray(ws[:, me]),
                                  self.device),
                       feat_val=_upload(self._mine(fval), self.device))
        k = _upload(self.g.in_degree.reshape(self.n_parts, self.n_local)[me]
                    .copy(), self.device)
        return db, k

    # -- adaptive cap ladder ----------------------------------------------
    def _caps(self, rung: int):
        """Capacity configuration for the given ladder rung: per-layer
        (rows, edges) plus per-layer halo and pull/pair channels.

        High-water driven once the first size report lands; a geometric
        fallback tied to the batch bucket covers the cold start.  Rung r
        scales everything by 4**r (the overflow-escalation safety valve --
        normally retries jump straight to fitting rungs because the size
        report is exact).  Capacities quantize to {2^k, 3*2^(k-1)}."""
        L = self.workload.spec.n_layers
        scale = 4 ** rung
        nl_b = next_bucket(self.n_local)
        e_max = max(next_bucket(max(self.g.num_edges, 1)) * 2,
                    self.min_bucket)
        dl = max(1, self._d_max // max(self.M, 1))
        pull_max = e_max * next_bucket(dl)
        pd_max = max(2 * e_max, next_bucket(nl_b * dl))

        def nb(v):
            v = max(int(v), 1)
            b = next_bucket(v)
            t = (b // 4) * 3     # the 3*2^(k-1) point below b
            return max(self.min_bucket, t if t >= v else b)

        if self._hw is None:
            r = nb(self._bucket * 2) * scale
            caps, rr, ee = [], r, 4 * r
            for _ in range(L):
                caps.append((int(min(rr, nl_b)), int(min(ee, e_max))))
                rr, ee = rr * 4, ee * 4
            halo = (int(min(4 * r, 2 * e_max)),) * L
            pull = int(min(8 * r, pull_max))
            pd = int(min(8 * r, pd_max))
            return tuple(caps), halo, pull, pd
        hw = self._hw
        caps, halo = [], []
        for l in range(L):
            caps.append((int(min(nb(hw[l, 0] * _HEADROOM) * scale, nl_b)),
                         int(min(nb(hw[l, 1] * _HEADROOM) * scale, e_max))))
            halo.append(int(min(nb(hw[l, 2] * _HEADROOM) * scale,
                                2 * e_max)))
        pull = int(min(nb(hw[:, 3].max() * _HEADROOM) * scale, pull_max))
        pd = int(min(nb(hw[:, 4].max() * _HEADROOM) * scale, pd_max))
        return tuple(caps), tuple(halo), pull, pd

    def _note_sizes(self, sizes) -> None:
        s = np.asarray(sizes).astype(np.int64)
        if self._hw is None:
            self._hw = s
            self._notes = 1
            return
        grew = s > self._hw
        if self._notes >= _SETTLE_NOTES and grew.any():
            # late growth means the stream drifted past the settled caps --
            # overshoot so the ladder converges in one step, not many
            self._hw = np.maximum(self._hw, s * 2)
        else:
            self._hw = np.maximum(self._hw, s)
        self._notes += 1

    # -- dispatch machinery ------------------------------------------------
    def _run(self, db: DistBatch, k, capsx):
        """One propagate attempt at the given capacity configuration;
        returns ((H, S, C), report)."""
        caps, halo, pull, pd = capsx
        kind = "mono" if self.monotonic else self.mode
        key = (kind, caps, halo, pull, pd, self.donate)
        fn = self._fn_cache.get(key)
        if fn is None:
            if self.monotonic:
                fn = make_monotonic_propagate(
                    self.comm, self.workload, self.n_local, caps, halo,
                    pull, pd, rc=self.mode == "rc", donate=self.donate)
            elif self.mode == "ripple":
                fn = make_ripple_propagate(
                    self.comm, self.workload, self.n_local, caps, halo,
                    donate=self.donate)
            else:
                fn = make_rc_propagate(
                    self.comm, self.workload, self.n_local, caps, halo, pull,
                    donate=self.donate)
            self._fn_cache[key] = fn
        dkey = key + (self._bucket, self.out_csr.pool,
                      self.in_csr.pool if self.in_csr is not None else 0)
        self._dispatched.add(dkey)
        self.compiles = len(self._dispatched)
        if self._last_capsx is not None and capsx != self._last_capsx:
            self.cap_transitions += 1
        self._last_capsx = capsx

        out_csr = self.out_csr.device()
        if self.monotonic:
            H, S, C, report = fn(self._params, self.H, self.S, self.C, k,
                                 out_csr, self.in_csr.device(), db)
            return (H, S, C), report
        if self.mode == "ripple":
            H, S, report = fn(self._params, self.H, self.S, k, out_csr, db)
        else:
            H, S, report = fn(self._params, self.H, self.S, k, out_csr,
                              self.in_csr.device(), db)
        return (H, S, None), report

    def _read(self, report: torch.Tensor, capsx):
        """(overflow, sizes [L, 5], comm, shrink stats, xpod, final ids
        [P, rows_L]) from one report -- the batch's single readback."""
        L = self.workload.spec.n_layers
        rep = report.cpu().numpy()
        n_comm = 3 * L if self.monotonic else L
        comm = rep[1:1 + n_comm]
        i = 1 + n_comm
        sstats = xpod = None
        if self.monotonic:
            sstats, i = rep[i:i + 4], i + 4
        sizes, i = rep[i:i + 5 * L].reshape(L, 5), i + 5 * L
        if not self.monotonic and self.mode == "ripple":
            xpod, i = rep[i:i + 2], i + 2
        final = rep[i:].reshape(self.n_parts, capsx[0][-1][0])
        return bool(rep[0]), sizes, comm, sstats, xpod, final

    def _commit_state(self, st) -> None:
        self.H, self.S = st[0], st[1]
        if st[2] is not None:
            self.C = st[2]

    def _dispatch(self, db: DistBatch, k) -> None:
        """Launch one batch without waiting for it.  State is committed
        optimistically: on overflow the gated commit left the tensors
        bit-exactly as they were, so a retry in ``_resolve`` starts from the
        right state."""
        if self._pending is not None:
            raise RuntimeError("dispatch with a batch still pending")
        capsx = self._caps(self._rung)
        st, report = self._run(db, k, capsx)
        self._commit_state(st)
        self._pending = (report, db, k, capsx)

    def _resolve(self) -> np.ndarray:
        """Block on the pending batch: check its overflow verdict, walk the
        cap ladder until the retry fits, capture stats, and return the
        affected vertex ids (ORIGINAL order)."""
        if self._pending is None:
            return self._last_affected
        report, db, k, capsx = self._pending
        ovf, sizes, comm, sstats, xpod, final = self._read(report, capsx)
        while ovf:
            self.retries += 1
            # the size report is exact even on overflow: aim the retry
            self._note_sizes(sizes)
            new = self._caps(0)
            if new == capsx:
                self._rung += 1
                new = self._caps(self._rung)
                if new == capsx:
                    self._pending = None
                    raise RuntimeError(
                        "distributed bucket ladder saturated while still "
                        "overflowing -- graph inconsistency?")
            else:
                self._rung = 0
            capsx = new
            st, report = self._run(db, k, capsx)
            self._commit_state(st)
            ovf, sizes, comm, sstats, xpod, final = self._read(report, capsx)
        self._note_sizes(sizes)
        self._rung = 0
        self._pending = None
        self.last_comm = comm
        if sstats is not None:
            (self.last_shrink_events, self.last_rows_reaggregated,
             self.last_dims_reaggregated, self.last_recover_hits) = \
                (int(v) for v in sstats)
        if xpod is not None:
            self.last_xpod = xpod
        offs = (np.arange(self.n_parts) * self.n_local)[:, None]
        f_global = np.where(final < self.n_local, final + offs, -1).ravel()
        orig = self.part.old_of_new[f_global[f_global >= 0]]
        self._last_affected = np.unique(orig[orig >= 0])
        return self._last_affected

    def flush(self) -> np.ndarray:
        """Resolve any in-flight batch (async mode); idempotent."""
        return self._resolve()

    def _warm(self) -> None:
        """Run the rung-0 cap schedule once on a sentinel no-op batch."""
        P_, nl, n_pad = self.n_parts, self.n_local, self.part.n_pad
        b = self._bucket
        ints = np.empty((5, P_, b), dtype=np.int32)
        ints[[0, 1, 3]] = nl
        ints[[2, 4]] = n_pad
        np_b = (ints, np.zeros((2, P_, b), np.float32),
                np.zeros((P_, b, self.workload.spec.dims[0]), np.float32))
        self._dispatch(*self._upload_batch(np_b))
        self._resolve()
        # the sentinel's zero sizes must not seed the high-water marks
        self._hw = None
        self._notes = 0
        self._rung = 0
        self._last_affected = np.empty(0, dtype=np.int64)

    # -- main entry --------------------------------------------------------
    def apply_batch(self, batch: UpdateBatch) -> np.ndarray:
        """Apply one batch; returns affected vertex ids in ORIGINAL order.
        Collective: every rank applies the same batch.

        Synchronous mode blocks on this batch.  With
        ``async_dispatch=True`` the call returns after launching this
        batch, reporting the PREVIOUS batch's affected set; the pipeline
        order (route -> resolve prev -> CSR refresh -> dispatch) keeps the
        CSR refresh off the in-flight propagate's tensors."""
        t0 = time.perf_counter()
        np_b, out_rows, in_rows = self._route(batch)
        t_route = time.perf_counter() - t0
        prev = self._resolve()
        t1 = time.perf_counter()
        self.out_csr.refresh_rows(out_rows)
        if self.in_csr is not None:
            self.in_csr.refresh_rows(in_rows)
        db, k = self._upload_batch(np_b)
        self.last_host_seconds = t_route + (time.perf_counter() - t1)
        self._dispatch(db, k)
        if self._async:
            return prev
        return self._resolve()
