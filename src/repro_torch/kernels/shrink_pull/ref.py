"""Plain PyTorch version of the monotonic hop's SHRINK pull: the needed
(row, dim) cells flattened into pairs (static cap ``pd_cap``), the
single columns of their in-neighbourhoods gathered as element reads
(static cap ``p_cap``) through the previous hop's patch, and their
segment extremum with its witness written back into ``[R, d]`` cells."""
from types import SimpleNamespace

import torch

from repro_torch.core.aggregators import segment_extremum
from repro_torch.core.ragged import (_masked_pairs, _ragged_gather,
                                     _scatter_cells)


def shrink_pull_ref(need, aff_c, start, length, col, H_pre, pos_p, patch_val,
                    C_pre_rows, *, sign: float, pd_cap: int, p_cap: int):
    """Returns ``(MK, RG, base_C, pull_total)`` as ``ops.shrink_pull``
    does.  Pairs beyond ``pd_cap`` and lanes beyond ``p_cap`` are dropped:
    the caller's overflow check (``need.sum() > pd_cap``, ``pull_total >
    p_cap``) flags such an attempt, and ``pull_total`` then counts only the
    first ``pd_cap`` pairs' in-degrees."""
    n, r_cap = H_pre.shape[0] - 1, need.shape[0]
    pr, pdim = _masked_pairs(need, pd_cap, r_cap)
    rows_pair = aff_c[pr.clamp(max=r_cap - 1)]
    degs = torch.where(pr < r_cap, length[rows_pair], 0)
    psrc, _, fid, pvalid, pull_total = _ragged_gather(
        n, start, col, rows_pair, degs, p_cap)
    pdim_e = pdim[fid]
    psrc_c = psrc.clamp(max=n - 1)
    pslot = pos_p[psrc_c]
    pvals = torch.where(pslot >= 0,
                        patch_val[pslot.clamp(min=0), pdim_e],
                        H_pre[psrc_c, pdim_e])
    S_pair, C_pair = segment_extremum(SimpleNamespace(sign=sign), pvals,
                                      torch.where(pvalid, fid, pd_cap),
                                      pd_cap, psrc)
    MK = _scatter_cells(torch.zeros_like(need), pr, pdim, True)
    RG = _scatter_cells(torch.zeros((r_cap, need.shape[1]),
                                    dtype=H_pre.dtype, device=H_pre.device),
                        pr, pdim, S_pair)
    base_C = _scatter_cells(C_pre_rows, pr, pdim, C_pair)
    return MK, RG, base_C, pull_total
