"""Shared GNN plumbing in PyTorch, the port of ``repro``'s
``models/gnn/common.py``: the padded graph batch, segment message passing
over an edge index, MLPs and the radial bases.  Message passing here is
``index_add_`` / ``scatter_reduce_`` over ``dst``; the ``segment_mm`` kernel
takes the same contract on a card for the streaming engines.  While a
per-shard forward of the dry-run runs (``sharded.active()``), the sums,
the maxima and :func:`whole` (which every gather by node or edge ids goes
through) take ``sharded.py``'s paths; otherwise they are the plain ops.
"""
from __future__ import annotations

import math
from typing import NamedTuple

import torch
import torch.nn.functional as F

from . import sharded


class GraphBatch(NamedTuple):
    """Padded, static-shape graph batch.

    Invalid (padding) edges carry ``src = dst = n_nodes - 1`` and
    ``edge_mask = 0`` so gathers stay in-bounds and scatters contribute 0.
    """

    node_feat: torch.Tensor                 # [n, d] (float)
    src: torch.Tensor                       # [m] int
    dst: torch.Tensor                       # [m] int
    edge_mask: torch.Tensor                 # [m] float (1 = real edge)
    positions: torch.Tensor | None = None   # [n, 3] molecular coords
    graph_id: torch.Tensor | None = None    # [n] for batched small graphs


def scatter_sum(values: torch.Tensor, dst: torch.Tensor,
                n: int) -> torch.Tensor:
    """``out[v] = sum of values[e] over the e with dst[e] == v``; ``[n, ...]``."""
    if sharded.active():
        return sharded.scatter_sum(values, dst, n)
    out = values.new_zeros((n, *values.shape[1:]))
    return out.index_add_(0, dst.long(), values)


def scatter_mean(values: torch.Tensor, dst: torch.Tensor, n: int,
                 mask: torch.Tensor) -> torch.Tensor:
    s = scatter_sum(values * mask[:, None], dst, n)
    cnt = scatter_sum(mask[:, None], dst, n)
    return s / cnt.clamp(min=1.0)


def scatter_max(values: torch.Tensor, dst: torch.Tensor, n: int,
                mask: torch.Tensor, neutral: float = -1e30) -> torch.Tensor:
    """Masked segment max; a vertex with no real in-edge gets 0."""
    v = torch.where(mask[:, None] > 0, values, neutral)
    if sharded.active():
        out = sharded.scatter_max(v, dst, n, neutral)
    else:
        out = values.new_full((n, *values.shape[1:]), neutral)
        index = dst.long().view(-1, *(1,) * (v.dim() - 1)).expand_as(v)
        out = out.scatter_reduce_(0, index, v, "amax")
    return torch.where(out <= neutral / 2, 0.0, out)


def scatter_min(values, dst, n, mask):
    return -scatter_max(-values, dst, n, mask)


def whole(x: torch.Tensor) -> torch.Tensor:
    """``x``, whose rows a gather by node or edge ids reads: on a per-shard
    forward every rank's rows (``sharded.whole``)."""
    return sharded.whole(x) if sharded.active() else x


def in_degree(dst: torch.Tensor, mask: torch.Tensor, n: int) -> torch.Tensor:
    return scatter_sum(mask, dst, n)


def mlp(params: list[dict], x: torch.Tensor, act=F.silu) -> torch.Tensor:
    for i, p in enumerate(params):
        x = x @ p["w"] + p["b"]
        if i < len(params) - 1:
            x = act(x)
    return x


def init_mlp(gen: torch.Generator, dims: list[int], dtype=torch.float32,
             device="cuda") -> list[dict]:
    """The reference's MLP: each ``w`` N(0, 1) / sqrt(fan-in) drawn in fp32
    from ``gen`` (a generator of ``device``), each ``b`` 0."""
    params = []
    for d_in, d_out in zip(dims, dims[1:]):
        w = torch.randn((d_in, d_out), generator=gen, dtype=torch.float32,
                        device=device) / math.sqrt(d_in)
        params.append({"w": w.to(dtype),
                       "b": torch.zeros((d_out,), dtype=dtype,
                                        device=device)})
    return params


# ---------------------------------------------------------------------------
# radial bases
# ---------------------------------------------------------------------------
def gaussian_rbf(d: torch.Tensor, n_rbf: int, cutoff: float) -> torch.Tensor:
    """SchNet's Gaussian radial basis. d [m] -> [m, n_rbf]."""
    centers = torch.linspace(0.0, cutoff, n_rbf, device=d.device)
    gamma = 1.0 / (centers[1] - centers[0]) ** 2
    return torch.exp(-gamma * (d[:, None] - centers[None, :]) ** 2)


def bessel_rbf(d: torch.Tensor, n_rbf: int, cutoff: float) -> torch.Tensor:
    """DimeNet/NequIP Bessel basis: sqrt(2/c) sin(n pi d / c) / d."""
    n = torch.arange(1, n_rbf + 1, dtype=torch.float32, device=d.device)
    dd = d.clamp(min=1e-6)[:, None]
    return math.sqrt(2.0 / cutoff) * torch.sin(n * math.pi * dd / cutoff) / dd


def cosine_cutoff(d: torch.Tensor, cutoff: float) -> torch.Tensor:
    return torch.where(d < cutoff,
                       0.5 * (torch.cos(math.pi * d / cutoff) + 1.0), 0.0)


def polynomial_envelope(d: torch.Tensor, cutoff: float,
                        p: int = 6) -> torch.Tensor:
    """DimeNet envelope u(d) (arXiv:2003.03123 eq. 8)."""
    x = (d / cutoff).clamp(0.0, 1.0)
    a = -(p + 1) * (p + 2) / 2.0
    b = p * (p + 2.0)
    c = -p * (p + 1) / 2.0
    return 1.0 + a * x ** p + b * x ** (p + 1) + c * x ** (p + 2)


def edge_vectors(positions: torch.Tensor, src: torch.Tensor,
                 dst: torch.Tensor):
    """Returns (unit vec [m,3], dist [m]) with safe normalization."""
    positions = whole(positions)
    vec = positions[src.long()] - positions[dst.long()]
    d = torch.sqrt((vec * vec).sum(-1) + 1e-12)
    return vec / d[:, None], d
