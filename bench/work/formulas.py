"""Peaks of the card, the least time a kernel call can take, and the model
FLOPs of an incremental step.

Every count is of the work the inputs need: rows are a hop's needed
recipients and lanes a bag's kept lanes, never the padded capacities the
program launches with.  Each input byte is read once and each output byte
written once.
"""
from __future__ import annotations

import numpy as np

_EMPTY = np.empty(0, np.int64)

# NVIDIA H100 SXM at the 700 W limit (NVIDIA's data sheet): HBM3 bandwidth
# and the dense fp32 rate (the cells run fp32 with TF32 off)
PEAK_BYTES_PER_S = 3.35e12
PEAK_FLOPS = 67e12


def bound_s(nbytes: float, flops: float) -> float:
    """The least time of a call: the larger of bytes over the memory
    bandwidth and operations over the fp32 peak rate."""
    return max(nbytes / PEAK_BYTES_PER_S, flops / PEAK_FLOPS)


def extremum_work(rows: int, d_in: int, d_out: int, launches: int
                  ) -> tuple[int, int]:
    """(bytes, flops) of ``extremum_apply`` over ``rows`` needed rows in
    ``launches`` calls.  Per row and input dim it reads the base (S or the
    re-aggregate, by the mask), the candidate and the one-byte mask, and
    writes S'; per row it writes h; per call it reads W and b."""
    per_cell = 4 + 4 + 4 + 1
    return (rows * (d_in * per_cell + 4 * d_out)
            + launches * 4 * (d_in * d_out + d_out),
            2 * rows * d_in * d_out)


def bag_work(bags: int, lanes: int, d: int, elem: int = 4
             ) -> tuple[int, int]:
    """(bytes, flops) of ``embedding_bag`` summing ``lanes`` kept lanes
    into ``bags`` needed bags of width ``d``: each kept lane's int32 id and
    table row read once, each bag written once; one add per element."""
    return 4 * lanes + elem * d * (lanes + bags), lanes * d


def layer_flops_per_row(update: str, aggregator: str, d_in: int,
                        d_out: int) -> int:
    """Model FLOPs of one row of a layer's UPDATE: 2 Din Dout per matrix
    product, with PNA's aggregate three times as wide as its input."""
    wide = 3 * d_in if aggregator == "pna" else d_in
    if update == "gc":
        return 2 * wide * d_out
    if update == "sage":
        return 2 * d_in * d_out + 2 * wide * d_out
    raise ValueError(f"no FLOP formula for the update {update!r}")


def _csr(n: int, src: np.ndarray, dst: np.ndarray):
    order = np.argsort(src, kind="stable")
    indptr = np.zeros(n + 1, np.int64)
    np.cumsum(np.bincount(src, minlength=n), out=indptr[1:])
    return indptr, dst[order]


def _out_nbrs(indptr, col, extra_src, extra_dst, gone, n: int,
              rows: np.ndarray) -> np.ndarray:
    """Distinct out-neighbours of ``rows`` on the final graph, less the
    edges in ``gone`` (packed src * n + dst), plus the ``extra`` edges."""
    deg = indptr[rows + 1] - indptr[rows]
    total = int(deg.sum())
    if total:
        offs = np.arange(total) - np.repeat(np.cumsum(deg) - deg, deg)
        src = np.repeat(rows, deg)
        dst = col[np.repeat(indptr[rows], deg) + offs]
        if gone.size:
            dst = dst[~np.isin(src * n + dst, gone)]
    else:
        dst = np.empty(0, np.int64)
    if extra_src.size:
        dst = np.concatenate([dst, extra_dst[np.isin(extra_src, rows)]])
    return np.unique(dst)


def lhop_rows(n: int, final_src: np.ndarray, final_dst: np.ndarray,
              batches: list, n_layers: int, self_dependent: bool
              ) -> np.ndarray:
    """``[len(batches), n_layers]``: for each batch, on the graph as it
    stood right after that batch, the rows each layer's UPDATE may have to
    recompute: layer 1's are the out-neighbours of the feature-updated
    vertices and the destinations of the batch's edge changes; layer l+1's
    the out-neighbours of layer l's rows and those destinations again; a
    self-dependent layer adds its input rows.  ``batches`` are the
    committed batches in order (``gen.stream.Batch``) and
    ``final_src/final_dst`` the edges after the last; the graph of each
    earlier batch is found by undoing the later ones."""
    indptr, col = _csr(n, final_src, final_dst)
    final = set((final_src * n + final_dst).tolist())
    gone: set = set()     # final edges absent at the batch
    extra: set = set()    # edges present at the batch, absent at the end
    out = np.zeros((len(batches), n_layers), np.int64)
    for i in range(len(batches) - 1, -1, -1):
        b = batches[i]
        gone_a = np.fromiter(gone, np.int64, len(gone))
        extra_a = np.fromiter(extra, np.int64, len(extra))
        ex_src, ex_dst = extra_a // n, extra_a % n
        edst = np.unique(np.concatenate([b.add_dst, b.del_dst]))
        rows = np.unique(b.feat_idx)
        for layer in range(n_layers):
            nxt = _out_nbrs(indptr, col, ex_src, ex_dst, gone_a, n, rows)
            parts = [nxt, edst] + ([rows] if self_dependent else [])
            rows = np.unique(np.concatenate(parts))
            out[i, layer] = rows.size
        # undo batch i: its additions leave, its deletions come back
        for e in (b.add_src * n + b.add_dst).tolist():
            if e in final:
                gone.add(e)
            else:
                extra.discard(e)
        for e in (b.del_src * n + b.del_dst).tolist():
            if e in final:
                gone.discard(e)
            else:
                extra.add(e)
    return out


def reached_rows(n: int, final_src: np.ndarray, final_dst: np.ndarray,
                 batches: list, n_layers: int, self_dependent: bool
                 ) -> np.ndarray:
    """``[n_layers, n]`` booleans: the rows that any of ``batches`` may
    have had each layer recompute, by ``lhop_rows``'s recursion from all
    the batches' touched vertices at once, on every edge the window held
    (the final edges and every edge a batch deleted).  A superset of the
    union of ``lhop_rows``'s rows over the batches."""
    del_src = np.concatenate([b.del_src for b in batches] or [_EMPTY])
    del_dst = np.concatenate([b.del_dst for b in batches] or [_EMPTY])
    src = np.concatenate([final_src, del_src])
    dst = np.concatenate([final_dst, del_dst])
    edst = np.concatenate([b.add_dst for b in batches] + [del_dst])
    rows = np.zeros(n, bool)
    rows[np.concatenate([b.feat_idx for b in batches] or [_EMPTY])] = True
    out = np.zeros((n_layers, n), bool)
    for layer in range(n_layers):
        nxt = rows.copy() if self_dependent else np.zeros(n, bool)
        nxt[dst[rows[src]]] = True
        nxt[edst] = True
        out[layer] = rows = nxt
    return out
