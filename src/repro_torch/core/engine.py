"""RIPPLE single-machine incremental engine + layer-wise recompute baseline.

The incremental engine (``RippleEngine``) is the paper's §4.3: a strictly
look-forward propagation where each affected vertex applies *delta messages*
from only its changed in-neighbors, then emits deltas to its out-neighbors'
next-hop mailboxes.  The recompute engine (``RecomputeEngine``, the paper's
"RC") shares the identical frontier expansion but re-aggregates *every*
in-neighbor of each affected vertex at each hop — the k vs 2k' contrast the
paper quantifies in §4.3.3.

Message algebra — invertible family (exactness proof sketch, see
tests/test_engine_equivalence): at hop ``l`` with current adjacency A'
(topology updates already applied), the mailbox contribution to v is

    sum_{(u,v) in A', u in F_l}  alpha * Delta_l[u]          (persistent scan)
  + sum_{(u,v) added}            alpha * h_old_l[u]          (add correction)
  - sum_{(u,v) deleted}          alpha * h_old_l[u]          (delete correction)

with ``h_old = H_l[u] - Delta_l[u]``.  Summing cases shows S' = S + mailbox
equals the from-scratch aggregate over A' of the *new* h_l — exactly, for
every linear aggregator; ``mean`` stays exact because (S, k) are tracked
separately and k is updated with the topology.

Monotonic family (max/min): mailboxes carry *candidate extrema* instead of
deltas, and each message is classified GROW / SHRINK against the tracked
(extremum, contributor) state — GROW folds the candidate in with one
elementwise min/max, SHRINK re-aggregates exactly the touched row over its
current in-neighborhood.  Propagation is *filtered*: only rows whose
embedding actually changed enter the next frontier, so covered updates stop
dead instead of expanding the full k-hop neighborhood.  The algebra, the
invariant that makes classification exact, and the event taxonomy live in
core/aggregators.py.

Bounded-recompute family (attention / top-k / PNA): the mailboxes carry
each message's old -> new contribution, every touched row is a PATCH of
its cached partial state or a REFRESH over its in-neighbourhood, and with
``tolerance > 0`` interior-layer writes within the certified deferral
budget are skipped (see core/aggregators.py).

This engine is NumPy host-side, mirroring the paper's own implementation
(§6, "implemented natively in Python ... leverage NumPy").  Its state was
bootstrapped by the full pass on the session's device; the device engine
(device_engine.py) shares its semantics.
"""
from __future__ import annotations

import time
from dataclasses import dataclass, field

import numpy as np

from .aggregators import (certified_error_bound, deferral_budgets,
                          np_segment_extremum, np_shrink_dims)
from .graph import DynamicGraph, EdgeUpdate, UpdateBatch, flat_row_indices
from .state import InferenceState
from .workloads import Workload

_F = np.float32


@dataclass
class BatchStats:
    """Per-batch instrumentation (drives Fig. 2b / 9 / 11 benchmarks)."""

    affected_per_hop: list[int] = field(default_factory=list)
    messages_per_hop: list[int] = field(default_factory=list)
    numeric_ops: int = 0        # aggregation element-ops (paper's k vs 2k')
    wall_seconds: float = 0.0
    final_affected: np.ndarray | None = None
    shrink_events: int = 0      # monotonic: messages classified SHRINK
    rows_reaggregated: int = 0  # monotonic/bounded: rows re-aggregated
    dims_reaggregated: int = 0  # monotonic: (row, dim) cells gathered
    recover_hits: int = 0       # monotonic: shrunk dims re-covered probe-free
    patch_events: int = 0       # bounded: touched rows absorbed as O(1) PATCH
    bound_violations: int = 0   # bounded: deferral denied, force-propagated
    deferred_rows: int = 0      # bounded: writes deferred under tolerance

    @property
    def total_affected(self) -> int:
        return int(sum(self.affected_per_hop))


def _np_update(workload: Workload, params_np: list[dict], layer: int,
               h_prev: np.ndarray, x: np.ndarray) -> np.ndarray:
    """The workload's UPDATE over NumPy (``workloads.NP_UPDATE``)."""
    return workload.update_fn(layer)(params_np[layer], h_prev, x)


def _np_normalize(workload: Workload, S: np.ndarray, k: np.ndarray) -> np.ndarray:
    return workload.agg.np_normalize(S, k)


def _edge_arrays(edges: list[EdgeUpdate]) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    return (np.array([e.src for e in edges], dtype=np.int64),
            np.array([e.dst for e in edges], dtype=np.int64),
            np.array([e.weight for e in edges], dtype=_F))


class _EngineBase:
    def __init__(self, workload: Workload, params_np: list[dict],
                 graph: DynamicGraph, state: InferenceState, *,
                 tolerance: float = 0.0):
        self.workload = workload
        self.params = params_np
        self.graph = graph
        self.state = state
        self.tolerance = float(tolerance)
        if self.tolerance > 0 and not workload.agg.tracks_aux:
            raise ValueError(
                f"tolerance > 0 requires a bounded-recompute workload; "
                f"{workload.spec.name!r} uses the "
                f"{workload.agg.algebra} family")
        # dense vertex->frontier-slot map reused across hops (reset after use)
        self._pos = np.full(graph.n, -1, dtype=np.int64)
        if workload.agg.tracks_aux:
            # running bounds feeding the certified error recursion: max |H_l|
            # per layer and max in-degree (re-derived at construction — i.e.
            # at engine swap too — and grown monotonically per batch)
            self._M = np.array([float(np.abs(h).max()) if h.size else 0.0
                                for h in state.H], dtype=np.float64)
            self._kmax = float(graph.in_degree.max()) if graph.n else 0.0

    def error_bound(self) -> np.ndarray:
        """Certified per-vertex inf-norm bound on published H[L] vs the
        full oracle (zeros unless deferrals have happened)."""
        n = self.graph.n
        if not self.workload.agg.tracks_aux or self.state.eps is None:
            return np.zeros(n, dtype=_F)
        E = certified_error_bound(self.workload, self.params, self.state.eps,
                                  self._M, self._kmax)
        return np.full(n, E[-1], dtype=_F)

    # -- shared: apply feature updates at hop 0 ---------------------------
    def _apply_features(self, batch: UpdateBatch) -> tuple[np.ndarray, np.ndarray]:
        if not batch.features:
            d0 = self.state.H[0].shape[1]
            return np.empty(0, dtype=np.int64), np.empty((0, d0), dtype=_F)
        vs = np.array([f.vertex for f in batch.features], dtype=np.int64)
        vals = np.stack([np.asarray(f.value, dtype=_F) for f in batch.features])
        # multiple updates to the same vertex in one batch: last-writer-wins
        uniq, last_idx = np.unique(vs[::-1], return_index=True)
        vals = vals[::-1][last_idx]
        delta = vals - self.state.H[0][uniq]
        self.state.H[0][uniq] = vals
        return uniq, delta


class RippleEngine(_EngineBase):
    """The paper's incremental engine (single machine)."""

    def apply_batch(self, batch: UpdateBatch) -> BatchStats:
        algebra = self.workload.agg.algebra
        if algebra == "invertible":
            return self._apply_invertible(batch)
        if algebra == "bounded":
            return self._apply_bounded(batch)
        return self._apply_monotonic(batch)

    # -- invertible aggregators: delta mailboxes --------------------------
    def _apply_invertible(self, batch: UpdateBatch) -> BatchStats:
        t0 = time.perf_counter()
        stats = BatchStats()
        g, st, wl = self.graph, self.state, self.workload
        L = wl.spec.n_layers

        adds, dels = g.apply_topology(batch.edges)
        st.k = g.in_degree  # degree vector is shared with the graph store
        add_src, add_dst, add_w = _edge_arrays(adds)
        del_src, del_dst, del_w = _edge_arrays(dels)
        if not wl.spec.weighted:
            add_w = np.ones_like(add_w)
            del_w = np.ones_like(del_w)

        frontier, delta = self._apply_features(batch)
        stats.affected_per_hop.append(len(frontier))

        for l in range(L):
            # ---- compute messages into hop l+1 mailboxes -----------------
            # persistent scan: out-edges of frontier under CURRENT adjacency
            if frontier.size:
                degs = g.out.length[frontier]
                total = int(degs.sum())
                rep = np.repeat(np.arange(frontier.size), degs)
                flat = flat_row_indices(g.out.start[frontier], degs)
                m_dst = g.out.col[flat]
                m_w = g.out.w[flat] if wl.spec.weighted else np.ones(total, dtype=_F)
                m_val = delta[rep] * m_w[:, None]
            else:
                m_dst = np.empty(0, dtype=np.int64)
                m_val = np.empty((0, st.H[l].shape[1]), dtype=_F)

            # add/delete corrections use h_old = H_l - Delta_l
            self._pos[frontier] = np.arange(frontier.size)

            def h_old(us: np.ndarray) -> np.ndarray:
                h = st.H[l][us].copy()
                slot = self._pos[us]
                hit = slot >= 0
                if hit.any():
                    h[hit] -= delta[slot[hit]]
                return h

            corr_dst = [m_dst]
            corr_val = [m_val]
            if add_src.size:
                corr_dst.append(add_dst)
                corr_val.append(h_old(add_src) * add_w[:, None])
            if del_src.size:
                corr_dst.append(del_dst)
                corr_val.append(-h_old(del_src) * del_w[:, None])
            self._pos[frontier] = -1

            all_dst = np.concatenate(corr_dst)
            all_val = np.concatenate(corr_val)
            stats.messages_per_hop.append(int(all_dst.shape[0]))
            stats.numeric_ops += 2 * int(all_dst.shape[0])  # negate+aggregate

            # ---- accumulate mailboxes (segment-sum by destination) -------
            recipients, inv = np.unique(all_dst, return_inverse=True)
            mailbox = np.zeros((recipients.size, all_val.shape[1]), dtype=_F)
            np.add.at(mailbox, inv, all_val)

            # ---- apply phase at hop l+1 ----------------------------------
            if wl.spec.self_dependent and frontier.size:
                affected = np.union1d(recipients, frontier)
            else:
                affected = recipients
            if affected.size == 0:
                stats.affected_per_hop.append(0)
                frontier = affected
                delta = np.empty((0, st.H[l + 1].shape[1]), dtype=_F)
                continue

            # scatter mailbox into S[l+1] rows of affected vertices
            self._pos[affected] = np.arange(affected.size)
            slot = self._pos[recipients]
            S_rows = st.S[l + 1][affected]
            S_rows[slot] += mailbox
            st.S[l + 1][affected] = S_rows
            self._pos[affected] = -1

            x = _np_normalize(wl, S_rows, st.k[affected])
            h_new = _np_update(wl, self.params, l, st.H[l][affected], x)
            delta = h_new - st.H[l + 1][affected]
            st.H[l + 1][affected] = h_new
            frontier = affected
            stats.affected_per_hop.append(int(affected.size))

        stats.final_affected = frontier
        stats.wall_seconds = time.perf_counter() - t0
        return stats

    # -- monotonic aggregators: GROW/SHRINK filtered propagation ----------
    def _apply_monotonic(self, batch: UpdateBatch) -> BatchStats:
        """Exact incremental max/min (see module + aggregators docstrings).

        Per hop: the frontier's out-edges plus the batch's edge updates form
        one message stream (dst, src, is_del); each message is classified
        against the tracked (S, C) rows at per-dim granularity.  Shrunk
        (row, dim) cells first run the re-cover probe — a surviving GROW
        candidate that ties-or-beats the stored extremum re-witnesses the
        dim and the gather is skipped entirely; the remainder re-aggregate
        as pair-flattened single-column gathers over the row's current
        in-neighborhood (never the full row).  Candidate values strictly
        covered in every dim are dropped before the fold (they cannot grow
        a dim, cannot re-witness one, and re-aggregated dims see their
        value through the in-CSR), then the survivors fold in with one
        elementwise min/max.  Only rows whose embedding changed propagate.
        """
        t0 = time.perf_counter()
        stats = BatchStats()
        g, st, wl = self.graph, self.state, self.workload
        agg = wl.agg
        L = wl.spec.n_layers

        # a max would keep the candidate of an edge added and deleted again
        adds, dels = g.net_topology(*g.apply_topology(batch.edges))
        st.k = g.in_degree
        add_src, add_dst, _ = _edge_arrays(adds)
        del_src, del_dst, _ = _edge_arrays(dels)

        frontier, delta0 = self._apply_features(batch)
        if frontier.size:  # hop-0 filtering: no-op feature writes stop here
            frontier = frontier[np.any(delta0 != 0, axis=1)]
        stats.affected_per_hop.append(len(frontier))

        for l in range(L):
            H_l, S_next, C_next = st.H[l], st.S[l + 1], st.C[l + 1]

            # ---- unified message stream (dst, src, is_del) ---------------
            if frontier.size:
                degs = g.out.length[frontier]
                flat = flat_row_indices(g.out.start[frontier], degs)
                m_dst = g.out.col[flat]
                m_src = np.repeat(frontier, degs)
            else:
                m_dst = m_src = np.empty(0, dtype=np.int64)
            msg_dst = np.concatenate([m_dst, add_dst, del_dst])
            msg_src = np.concatenate([m_src, add_src, del_src])
            is_del = np.zeros(msg_dst.size, dtype=bool)
            is_del[m_dst.size + add_dst.size:] = True
            stats.messages_per_hop.append(int(msg_dst.size))

            affected = np.unique(msg_dst)
            if wl.spec.self_dependent and frontier.size:
                affected = np.union1d(affected, frontier)
            stats.affected_per_hop.append(int(affected.size))
            if affected.size == 0:
                frontier = affected
                continue

            self._pos[affected] = np.arange(affected.size)
            slot = self._pos[msg_dst]
            S_aff = S_next[affected].copy()
            C_aff = C_next[affected].copy()
            d = S_aff.shape[1]

            # ---- classify per-(message, dim); dedup into a row mask ------
            vals_all = H_l[msg_src]
            S_msg = S_next[msg_dst]
            dim_shrink = np_shrink_dims(agg, C_next[msg_dst], S_msg,
                                        msg_src, vals_all, is_del)
            shrink_any = dim_shrink.any(axis=1)
            stats.shrink_events += int(shrink_any.sum())
            row_dim = np.zeros((affected.size, d), dtype=bool)
            if shrink_any.any():
                np.logical_or.at(row_dim, slot[shrink_any],
                                 dim_shrink[shrink_any])

            # ---- candidates: strictly-covered ones drop before the fold --
            covered = agg.improves(S_msg, vals_all)
            keep = ~is_del & ~covered.all(axis=1)
            c_slot, c_src, c_val = slot[keep], msg_src[keep], vals_all[keep]
            cand_ext = np.full((affected.size, d), agg.identity, dtype=_F)
            agg.ufunc.at(cand_ext, c_slot, c_val)
            stats.numeric_ops += int(c_src.size)

            # ---- re-cover probe, then per-dim re-aggregation -------------
            if row_dim.any():
                recovered = row_dim & ~agg.improves(S_aff, cand_ext)
                stats.recover_hits += int(recovered.sum())
                pr, pd = np.nonzero(row_dim & ~recovered)
            else:
                pr = pd = np.empty(0, dtype=np.int64)
            if pr.size:
                rows = affected[pr]
                in_degs = g.inn.length[rows]
                flat_in = flat_row_indices(g.inn.start[rows], in_degs)
                nbr = g.inn.col[flat_in]
                seg = np.repeat(np.arange(pr.size), in_degs)
                dcol = np.repeat(pd, in_degs)
                S_re, C_re = np_segment_extremum(agg, H_l[nbr, dcol], seg,
                                                 pr.size, nbr)
                S_aff[pr, pd] = S_re
                C_aff[pr, pd] = C_re
                stats.numeric_ops += int(in_degs.sum())
                stats.dims_reaggregated += int(pr.size)
                stats.rows_reaggregated += int(np.unique(pr).size)

            # ---- GROW: fold surviving candidates + witness refs ----------
            S_aff = agg.ufunc(S_aff, cand_ext)
            if c_src.size:
                jj, dd = np.nonzero(c_val == S_aff[c_slot])
                C_aff[c_slot[jj], dd] = c_src[jj]
            self._pos[affected] = -1

            # ---- apply + filtered propagation ----------------------------
            x = _np_normalize(wl, S_aff, st.k[affected])
            h_new = _np_update(wl, self.params, l, H_l[affected], x)
            changed = np.any(h_new != st.H[l + 1][affected], axis=1)
            S_next[affected] = S_aff
            C_next[affected] = C_aff
            st.H[l + 1][affected] = h_new
            frontier = affected[changed]

        stats.final_affected = frontier
        stats.wall_seconds = time.perf_counter() - t0
        return stats

    # -- bounded aggregators: PATCH/REFRESH + certified deferral ----------
    def _apply_bounded(self, batch: UpdateBatch) -> BatchStats:
        """Incremental attention / top-k / PNA (see aggregators docstring).

        Per hop the frontier's out-edges under the current adjacency plus
        the batch's add/delete corrections form one TRUE message view
        ``(dst, src, has_old, has_new, val_old, val_new)``: each message
        states exactly how one in-neighbor contribution transitioned, with
        ``val_old`` taken from the pre-write frontier values (what the
        destination's cache actually aggregated) and newly-added edges
        flagged ``has_old=False`` even when their source sits in the
        frontier.  The aggregator classifies touched rows PATCH (O(1)
        cache absorb) vs REFRESH (re-aggregate over the row's current
        in-neighborhood); only rows whose embedding changed propagate.

        With ``tolerance > 0``, interior-layer writes whose magnitude fits
        the layer's certified deferral budget are skipped entirely (the
        stale store is exactly what downstream caches aggregated, so the
        caches stay exact and the next touch carries the accumulated
        correction); a changed row above the budget is a BOUND-VIOLATION
        and is force-written + propagated.  ``state.eps`` accumulates the
        certified staleness per layer for :meth:`error_bound`.
        """
        t0 = time.perf_counter()
        stats = BatchStats()
        g, st, wl = self.graph, self.state, self.workload
        agg = wl.agg
        L = wl.spec.n_layers

        # PNA's cached max would keep a transient edge's candidate
        adds, dels = g.net_topology(*g.apply_topology(batch.edges))
        st.k = g.in_degree
        add_src, add_dst, _ = _edge_arrays(adds)
        del_src, del_dst, _ = _edge_arrays(dels)
        if g.n:
            self._kmax = max(self._kmax, float(g.in_degree.max()))
        add_pair = add_src * g.n + add_dst

        frontier, delta0 = self._apply_features(batch)
        if frontier.size:  # hop-0 filtering: no-op feature writes stop here
            keep0 = np.any(delta0 != 0, axis=1)
            frontier, delta0 = frontier[keep0], delta0[keep0]
        front_old = st.H[0][frontier] - delta0
        if frontier.size:
            self._M[0] = max(self._M[0], float(np.abs(st.H[0][frontier]).max()))
        stats.affected_per_hop.append(len(frontier))

        taus = deferral_budgets(wl, self.params, st.eps, self._M, self._kmax,
                                self.tolerance) if self.tolerance > 0 else None

        for l in range(L):
            H_l = st.H[l]
            d = H_l.shape[1]

            # ---- TRUE message view (dst, src, old -> new transition) -----
            if frontier.size:
                degs = g.out.length[frontier]
                flat = flat_row_indices(g.out.start[frontier], degs)
                m_dst = g.out.col[flat]
                rep = np.repeat(np.arange(frontier.size), degs)
                m_src = frontier[rep]
                m_new = H_l[m_src]
                m_old = front_old[rep]
                # an edge added this batch never contributed val_old: the
                # destination cache was built under the old adjacency
                m_has_old = ~np.isin(m_src * g.n + m_dst, add_pair) \
                    if add_pair.size else np.ones(m_dst.size, dtype=bool)
            else:
                m_dst = m_src = np.empty(0, dtype=np.int64)
                m_new = m_old = np.empty((0, d), dtype=_F)
                m_has_old = np.empty(0, dtype=bool)

            self._pos[frontier] = np.arange(frontier.size)
            # add corrections for non-frontier sources (frontier sources'
            # added edges already ride the scan with has_old=False)
            if add_src.size:
                a_keep = self._pos[add_src] < 0
                a_src, a_dst = add_src[a_keep], add_dst[a_keep]
                a_new = H_l[a_src]
            else:
                a_src = a_dst = np.empty(0, dtype=np.int64)
                a_new = np.empty((0, d), dtype=_F)
            # delete corrections: retract what the cache aggregated — the
            # pre-write value for frontier sources
            if del_src.size:
                d_old = H_l[del_src].copy()
                dpos = self._pos[del_src]
                hit = dpos >= 0
                d_old[hit] = front_old[dpos[hit]]
            else:
                d_old = np.empty((0, d), dtype=_F)
            self._pos[frontier] = -1

            msg_dst = np.concatenate([m_dst, a_dst, del_dst])
            msg_src = np.concatenate([m_src, a_src, del_src])
            val_old = np.concatenate([m_old, np.zeros_like(a_new), d_old])
            val_new = np.concatenate([m_new, a_new, np.zeros_like(d_old)])
            has_old = np.concatenate([m_has_old,
                                      np.zeros(a_dst.size, dtype=bool),
                                      np.ones(del_dst.size, dtype=bool)])
            has_new = np.concatenate([np.ones(m_dst.size, dtype=bool),
                                      np.ones(a_dst.size, dtype=bool),
                                      np.zeros(del_dst.size, dtype=bool)])
            stats.messages_per_hop.append(int(msg_dst.size))

            affected = np.unique(msg_dst)
            if wl.spec.self_dependent and frontier.size:
                affected = np.union1d(affected, frontier)
            stats.affected_per_hop.append(int(affected.size))
            if affected.size == 0:
                frontier = affected
                front_old = np.empty((0, st.H[l + 1].shape[1]), dtype=_F)
                continue

            # ---- classify + patch the touched rows' cached state ---------
            self._pos[affected] = np.arange(affected.size)
            slot = self._pos[msg_dst]
            self._pos[affected] = -1
            x_rows = st.S[l + 1][affected]
            aux_rows = {nm: st.A[l + 1][nm][affected] for nm in agg.aux_names}
            k_rows = st.k[affected]
            touched = np.zeros(affected.size, dtype=bool)
            touched[slot] = True

            x2, aux2, refresh = agg.np_patch(x_rows, aux_rows, k_rows, slot,
                                             msg_src, val_old, val_new,
                                             has_old, has_new)
            stats.numeric_ops += int(msg_dst.size)
            # untouched rows (self-dependent union) keep their state
            # bit-identical — a patch round-trip may introduce float noise
            x_new = np.where(touched[:, None], x2, x_rows)
            aux_new = {}
            for nm in agg.aux_names:
                mask = touched if aux2[nm].ndim == 1 else touched[:, None]
                aux_new[nm] = np.where(mask, aux2[nm], aux_rows[nm])

            # ---- REFRESH: bounded recompute of cache-invalidated rows ----
            r_idx = np.nonzero(refresh)[0]
            stats.patch_events += int((touched & ~refresh).sum())
            if r_idx.size:
                rows = affected[r_idx]
                in_degs = g.inn.length[rows]
                flat_in = flat_row_indices(g.inn.start[rows], in_degs)
                nbr = g.inn.col[flat_in]
                seg = np.repeat(np.arange(r_idx.size), in_degs)
                x_re, aux_re = agg.np_reaggregate(H_l, nbr, seg, r_idx.size,
                                                  st.k[rows])
                x_new[r_idx] = x_re
                for nm in agg.aux_names:
                    aux_new[nm][r_idx] = aux_re[nm]
                stats.numeric_ops += int(in_degs.sum())
                stats.rows_reaggregated += int(r_idx.size)

            st.S[l + 1][affected] = x_new
            for nm in agg.aux_names:
                st.A[l + 1][nm][affected] = aux_new[nm]

            # ---- apply + certified deferral + filtered propagation -------
            h_new = _np_update(wl, self.params, l, H_l[affected], x_new)
            h_stored = st.H[l + 1][affected]
            changed = np.any(h_new != h_stored, axis=1)
            if taus is not None and l + 1 < L:
                b = np.max(np.abs(h_new - h_stored), axis=1)
                defer = changed & (b <= taus[l + 1])
                viol = changed & ~defer
                stats.deferred_rows += int(defer.sum())
                stats.bound_violations += int(viol.sum())
                if defer.any():
                    st.eps[l + 1] = max(float(st.eps[l + 1]),
                                        float(b[defer].max()))
            else:
                defer = np.zeros_like(changed)

            write = changed & ~defer
            front_old = h_stored[write]
            if write.any():
                st.H[l + 1][affected[write]] = h_new[write]
                self._M[l + 1] = max(self._M[l + 1],
                                     float(np.abs(h_new[write]).max()))
            frontier = affected[write]

        stats.final_affected = frontier
        stats.wall_seconds = time.perf_counter() - t0
        return stats


class RecomputeEngine(_EngineBase):
    """Layer-wise recompute scoped to the affected neighborhood ("RC", §4.2).

    Identical frontier expansion to RIPPLE, but every affected vertex
    re-aggregates ALL of its in-neighbors at each hop (the paper's k-ops
    baseline) — for monotonic aggregators too, which makes it the unfiltered
    re-aggregate-everything baseline that bench_single contrasts with
    RIPPLE's filtered propagation.  The mailbox machinery is unnecessary —
    only the affected sets propagate.
    """

    def apply_batch(self, batch: UpdateBatch) -> BatchStats:
        t0 = time.perf_counter()
        stats = BatchStats()
        g, st, wl = self.graph, self.state, self.workload
        agg = wl.agg
        L = wl.spec.n_layers

        adds, dels = g.apply_topology(batch.edges)
        st.k = g.in_degree
        touch_dst = np.array([e.dst for e in adds] + [e.dst for e in dels],
                             dtype=np.int64)

        frontier, _ = self._apply_features(batch)
        stats.affected_per_hop.append(len(frontier))

        for l in range(L):
            # affected at hop l+1: out-nbrs of frontier + dsts of edge
            # updates (which inject/remove a contribution at every hop)
            if frontier.size:
                flat = flat_row_indices(g.out.start[frontier], g.out.length[frontier])
                out_dst = g.out.col[flat]
            else:
                out_dst = np.empty(0, dtype=np.int64)
            affected = np.unique(np.concatenate([out_dst, touch_dst]))
            if wl.spec.self_dependent and frontier.size:
                affected = np.union1d(affected, frontier)
            stats.affected_per_hop.append(int(affected.size))
            if affected.size == 0:
                frontier = affected
                continue

            # full re-aggregation over ALL in-neighbors of affected vertices
            in_degs = g.inn.length[affected]
            total = int(in_degs.sum())
            flat = flat_row_indices(g.inn.start[affected], in_degs)
            nbr = g.inn.col[flat]
            seg = np.repeat(np.arange(affected.size), in_degs)
            if agg.algebra == "invertible":
                w = g.inn.w[flat] if wl.spec.weighted else np.ones(total, dtype=_F)
                S_rows = np.zeros((affected.size, st.H[l].shape[1]), dtype=_F)
                np.add.at(S_rows, seg, st.H[l][nbr] * w[:, None])
            elif agg.algebra == "bounded":
                S_rows, aux = agg.np_reaggregate(st.H[l], nbr, seg,
                                                 affected.size,
                                                 st.k[affected])
                for nm in agg.aux_names:
                    st.A[l + 1][nm][affected] = aux[nm]
                stats.rows_reaggregated += int(affected.size)
            else:
                S_rows, C_rows = np_segment_extremum(agg, st.H[l][nbr], seg,
                                                     affected.size, nbr)
                st.C[l + 1][affected] = C_rows
                stats.rows_reaggregated += int(affected.size)
            stats.numeric_ops += int(total)
            stats.messages_per_hop.append(int(total))
            st.S[l + 1][affected] = S_rows

            x = _np_normalize(wl, S_rows, st.k[affected])
            h_new = _np_update(wl, self.params, l, st.H[l][affected], x)
            st.H[l + 1][affected] = h_new
            frontier = affected

        stats.final_affected = frontier
        stats.wall_seconds = time.perf_counter() - t0
        return stats
