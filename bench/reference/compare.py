"""The comparison that decides ``correct``.

Each layer's embeddings are held against the reference's row by row: a
row's error is its largest absolute difference, over the larger of the
reference row's largest magnitude and the median of that over the layer's
rows that are not all zero (a row the reference leaves near zero is judged
on the layer's scale, not its own).  The compared numbers are the worst
row over layers 1..L (``h_err``), the worst row among the rows the
window's batches reached at each layer (``h_err_reached``: the rows the
program had to recompute incrementally, whatever error the bootstrap left
elsewhere), and the worst served answer of ``query()`` (``query_err``);
each must not exceed its limit.
"""
from __future__ import annotations

import math

import torch

NAMES = ("h_err", "h_err_reached", "query_err")


def row_rel_err(got: torch.Tensor, ref: torch.Tensor,
                rows: torch.Tensor | None = None) -> float:
    """The worst row's error, as above, over all rows or over the rows
    where the boolean ``rows`` is set; the layer's scale is taken over all
    rows either way (inf for a shape mismatch, and a non-finite value in
    ``got`` gives inf)."""
    if got.shape != ref.shape:
        return math.inf
    err = (got - ref).abs().amax(dim=1)
    err = torch.where(torch.isfinite(err), err, math.inf)
    scale = ref.abs().amax(dim=1)
    nz = scale[scale > 0]
    floor = nz.median() if nz.numel() else torch.ones((), device=ref.device)
    rel = err / torch.maximum(scale, floor)
    if rows is not None:
        rel = rel[rows]
    return float(rel.max()) if rel.numel() else 0.0


def readings(H_got: list, q_got, H_ref: list, reached=None) -> dict:
    """``{"h_err": .., "query_err": ..}`` for the program's layers 1..L
    and its query answers against the reference's layers, and
    ``"h_err_reached"`` where ``reached`` ([L, n] booleans: the rows the
    window reached at layers 1..L) is given."""
    dev = H_ref[0].device

    def on(t):
        return torch.as_tensor(t, device=dev)
    L = len(H_ref) - 1
    out = {"h_err": max(row_rel_err(on(H_got[l]), H_ref[l])
                        for l in range(1, L + 1)),
           "query_err": row_rel_err(on(q_got), H_ref[-1])}
    if reached is not None:
        out["h_err_reached"] = max(
            row_rel_err(on(H_got[l]), H_ref[l], on(reached[l - 1]))
            for l in range(1, L + 1))
    return out


def judge(values: dict, limits: dict) -> bool:
    """True when every compared number is within its limit."""
    return all(name in values and values[name] <= limits[name]
               for name in limits)
