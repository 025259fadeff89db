"""Static-shape gathers and scatters of the device engines' hops: CSR rows
expanded into one static bucket, a mask's cells flattened into (row, col)
pairs, and pairs written back into cells.  Shared by the device engine,
the distributed engine and the SHRINK pull's plain version
(``kernels/shrink_pull/ref.py``); imports nothing of either engine."""
from __future__ import annotations

import torch


def _ragged_gather(n: int, start: torch.Tensor, col: torch.Tensor,
                   rows: torch.Tensor, degs: torch.Tensor, cap: int):
    """Expand the CSR rows' adjacency lists into one static bucket.

    ``start [n]`` and ``col`` are a slacked-CSR pool's row starts and
    entries; ``rows [R]`` are vertex ids (sentinel n allowed) with per-row
    counts ``degs [R]`` (0 for rows to skip); slot j of the bucket holds
    entry ``j - csum[fid] + degs[fid]`` of row ``fid``, found by
    ``searchsorted`` on the running count.  Returns (cols [cap] sentinel-n
    padded, flat [cap] pool slots (0 where invalid), fid [cap] source row
    slot, valid [cap], total_needed).
    """
    r_cap = rows.shape[0]
    csum = torch.cumsum(degs, 0)
    total = csum[-1]
    e = torch.arange(cap, device=rows.device)
    fid = torch.searchsorted(csum, e, right=True).clamp(max=r_cap - 1)
    off = e - (csum[fid] - degs[fid])
    valid = e < total
    flat = torch.where(valid, start[rows[fid].clamp(max=n - 1)] + off, 0)
    cols = torch.where(valid, col[flat], n)
    return cols, flat, fid, valid, total


def _masked_pairs(mask: torch.Tensor, cap: int, fill_row: int):
    """Row-major (row, col) indices of the True cells of ``mask``, padded
    with ``(fill_row, 0)`` to the static ``cap``: one cumsum and one
    scatter into a ``[cap + 1]`` buffer whose last slot takes the padding
    and the cells beyond ``cap`` (callers detect those through their own
    ``mask.sum() > cap`` overflow check).  No ``nonzero``, so no wait for
    the host."""
    R, D = mask.shape
    flat = mask.reshape(-1)
    dest = torch.where(flat, torch.cumsum(flat, 0) - 1, cap).clamp(max=cap)
    lin = torch.full((cap + 1,), R * D, dtype=torch.int64,
                     device=mask.device)
    lin = lin.scatter_(0, dest, torch.arange(R * D, device=mask.device))[:cap]
    hit = lin < R * D
    return torch.where(hit, lin // D, fill_row), torch.where(hit, lin % D, 0)


def _scatter_cells(base: torch.Tensor, pr: torch.Tensor, pdim: torch.Tensor,
                   vals) -> torch.Tensor:
    """``base [R, d]`` with ``vals`` written at the (pr, pdim) cells; pr == R
    is the padding row, sent to a trash row that is cut off again."""
    out = torch.cat([base, base[:1]])
    out[pr, pdim] = vals
    return out[:-1]
