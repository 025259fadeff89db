"""SchNet (arXiv:1706.08566) in PyTorch, the port of ``repro``'s
``models/gnn/schnet.py``: continuous-filter convolutions.

cfconv message: h_j * W_filter(rbf(d_ij)), a weighted-sum linear
aggregation in h_j summed into each destination with ``index_add_``.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from .common import (GraphBatch, cosine_cutoff, edge_vectors, gaussian_rbf,
                     init_mlp, mlp, scatter_sum, whole)


def shifted_softplus(x: torch.Tensor) -> torch.Tensor:
    return F.softplus(x) - math.log(2.0)


def init_schnet(gen: torch.Generator, *, d_in: int, d_hidden: int = 64,
                n_interactions: int = 3, n_rbf: int = 300,
                cutoff: float = 10.0, d_out: int = 1, device="cuda"):
    """The reference's tree: ``embed``, ``blocks`` (``filter``,
    ``in_proj``, ``out_proj`` MLPs a block) and ``out``, drawn from
    ``gen`` (a generator of ``device``)."""
    params = {
        "embed": init_mlp(gen, [d_in, d_hidden], device=device),
        "blocks": [],
        "out": init_mlp(gen, [d_hidden, d_hidden // 2, d_out],
                        device=device),
    }
    for _ in range(n_interactions):
        params["blocks"].append({
            "filter": init_mlp(gen, [n_rbf, d_hidden, d_hidden],
                               device=device),
            "in_proj": init_mlp(gen, [d_hidden, d_hidden], device=device),
            "out_proj": init_mlp(gen, [d_hidden, d_hidden, d_hidden],
                                 device=device),
        })
    return params


def schnet_forward(params, g: GraphBatch, *, n_rbf: int = 300,
                   cutoff: float = 10.0) -> torch.Tensor:
    """Node-level outputs [n, d_out]."""
    n = g.node_feat.shape[0]
    h = mlp(params["embed"], g.node_feat)
    _, d = edge_vectors(g.positions, g.src, g.dst)
    rbf = gaussian_rbf(d, n_rbf, cutoff)
    fcut = (cosine_cutoff(d, cutoff) * g.edge_mask)[:, None]
    src = g.src.long()
    for blk in params["blocks"]:
        W = mlp(blk["filter"], rbf, act=shifted_softplus) * fcut  # [m, dh]
        x = mlp(blk["in_proj"], h)
        agg = scatter_sum(whole(x).index_select(0, src) * W, g.dst, n)
        h = h + mlp(blk["out_proj"], agg, act=shifted_softplus)
    return mlp(params["out"], h, act=shifted_softplus)
