"""GraphConv over a PNA tower (Corso et al. 2020, arXiv:2004.05718), as
the program's ``gp-m`` workload states it: for each input dim the
aggregate over a vertex's k in-neighbours is

    [log(1 + k) * mean, std, max],  std = sqrt(max(E[h^2] - mean^2, 0)),

with mean, std and max read as 0 where k = 0, so the layer input is three
times as wide as h, and

    h^l_v = act(x^l_v W + b)

with act = relu on every layer but the last, which has none.  The layer
has no self term: only the in-neighbourhood reaches h^l_v.
"""
from __future__ import annotations

import torch

from ._common import matmul, segment_reduce


def param_shapes(dims: tuple[int, ...]) -> list[dict]:
    return [{"w": (3 * dims[l], dims[l + 1]), "b": (dims[l + 1],)}
            for l in range(len(dims) - 1)]


def tower(h: torch.Tensor, src: torch.Tensor, dst: torch.Tensor
          ) -> torch.Tensor:
    """The aggregate ``[log(1 + k) * mean, std, max]``, worked out in
    float64 and rounded once to ``h``'s type."""
    n = h.shape[0]
    k = torch.bincount(dst, minlength=n).to(torch.float64)
    kk = k.clamp(min=1.0)[:, None]
    mean = segment_reduce(h, src, dst, n, "sum") / kk
    var = segment_reduce(h, src, dst, n, "sum_sq") / kk - mean * mean
    mx = segment_reduce(h, src, dst, n, "amax").double()
    mx = torch.where(torch.isinf(mx), 0.0, mx)
    return torch.cat([torch.log1p(k)[:, None] * mean,
                      torch.sqrt(var.clamp(min=0.0)), mx], dim=1).to(h.dtype)


@torch.no_grad()
def forward(x: torch.Tensor, src: torch.Tensor, dst: torch.Tensor,
            params: list[dict], *, tf32: bool = False) -> list[torch.Tensor]:
    """Every layer's embeddings ``[x, h^1, ..., h^L]``."""
    H = [x]
    for l, p in enumerate(params):
        out = matmul(tower(H[-1], src, dst), p["w"], tf32) + p["b"]
        H.append(out if l == len(params) - 1 else torch.relu(out))
    return H
