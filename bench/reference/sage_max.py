"""GraphSAGE with the max-pool aggregator (Hamilton et al. 2017,
arXiv:1706.02216), as the program's ``gs-max`` workload states it:

    x^l_v = max_{u -> v} h^{l-1}_u      per dim; 0 for a vertex with no
                                         in-neighbour
    h^l_v = act(h^{l-1}_v W_self + x^l_v W_nbr + b)

with act = relu on every layer but the last, which has none.
"""
from __future__ import annotations

import torch

from ._common import matmul, segment_reduce


def param_shapes(dims: tuple[int, ...]) -> list[dict]:
    return [{"w_self": (dims[l], dims[l + 1]),
             "w_nbr": (dims[l], dims[l + 1]), "b": (dims[l + 1],)}
            for l in range(len(dims) - 1)]


@torch.no_grad()
def forward(x: torch.Tensor, src: torch.Tensor, dst: torch.Tensor,
            params: list[dict], *, tf32: bool = False) -> list[torch.Tensor]:
    """Every layer's embeddings ``[x, h^1, ..., h^L]``."""
    n = x.shape[0]
    H = [x]
    for l, p in enumerate(params):
        h = H[-1]
        agg = segment_reduce(h, src, dst, n, "amax")
        agg = torch.where(torch.isinf(agg), 0.0, agg)
        out = matmul(h, p["w_self"], tf32) + matmul(agg, p["w_nbr"], tf32) \
            + p["b"]
        H.append(out if l == len(params) - 1 else torch.relu(out))
    return H
