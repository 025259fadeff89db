"""PNA, Principal Neighbourhood Aggregation (arXiv:2004.05718), in
PyTorch: the port of ``repro``'s ``models/gnn/pna.py``.

4 aggregators (mean/max/min/std) x 3 degree scalers (identity,
amplification, attenuation) concatenated -> linear tower.  Max and min
are ``scatter_reduce_`` "amax", whose gradient splits evenly over tied
maxima as the reference's segment max does.
"""
from __future__ import annotations

import torch

from .common import (GraphBatch, in_degree, init_mlp, mlp, scatter_max,
                     scatter_mean, scatter_min, whole)

N_AGG, N_SCALER = 4, 3


def init_pna(gen: torch.Generator, *, d_in: int, d_hidden: int = 75,
             n_layers: int = 4, d_out: int = 1, avg_log_deg: float = 2.0,
             device="cuda"):
    """The reference's tree: ``embed``, ``layers`` (``pre``, ``post``) and
    ``out``, drawn from ``gen`` (a generator of ``device``)."""
    params = {
        "embed": init_mlp(gen, [d_in, d_hidden], device=device),
        "layers": [],
        "out": init_mlp(gen, [d_hidden, d_hidden, d_out], device=device),
    }
    for _ in range(n_layers):
        params["layers"].append({
            "pre": init_mlp(gen, [2 * d_hidden, d_hidden], device=device),
            "post": init_mlp(gen, [N_AGG * N_SCALER * d_hidden + d_hidden,
                                   d_hidden], device=device),
        })
    return params


def pna_forward(params, g: GraphBatch, *, delta: float = 2.0) -> torch.Tensor:
    n = g.node_feat.shape[0]
    h = mlp(params["embed"], g.node_feat)
    deg = in_degree(g.dst, g.edge_mask, n)
    logd = torch.log1p(deg)[:, None]
    scalers = (torch.ones_like(logd), logd / delta,
               delta / logd.clamp(min=1e-6))
    src, dst = g.src.long(), g.dst.long()
    for lay in params["layers"]:
        hw = whole(h)
        msgs = mlp(lay["pre"], torch.cat([hw.index_select(0, dst),
                                         hw.index_select(0, src)], -1))
        mean = scatter_mean(msgs, dst, n, g.edge_mask)
        mx = scatter_max(msgs, dst, n, g.edge_mask)
        mn = scatter_min(msgs, dst, n, g.edge_mask)
        sq = scatter_mean(msgs * msgs, dst, n, g.edge_mask)
        var = sq - mean * mean
        std = torch.sqrt(torch.maximum(var, torch.zeros_like(var)) + 1e-5)
        aggs = [mean, mx, mn, std]
        combo = torch.cat([a * s for s in scalers for a in aggs], -1)
        h = h + mlp(lay["post"], torch.cat([combo, h], -1))
    return mlp(params["out"], h)
