"""NequIP (arXiv:2101.03164) in PyTorch, l_max = 2: the port of
``repro``'s ``models/gnn/nequip.py``.

Features are Cartesian tensors -- l=0 scalars [n,C], l=1 vectors
[n,C,3], l=2 symmetric traceless matrices [n,C,3,3] -- and every
tensor-product path (l1 x l2 -> l3) is a dense delta/epsilon contraction
(dot, cross, symmetric-traceless outer, ...), exactly SO(3)-equivariant
by construction.  Messages are linear in the source features h_j.
"""
from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from .common import (GraphBatch, bessel_rbf, edge_vectors, init_mlp, mlp,
                     polynomial_envelope, scatter_sum, whole)

# EPS3[i, k, l] = epsilon_{ikl}
EPS3 = np.stack([np.cross(np.eye(3)[i], np.eye(3)) for i in range(3)])

PATHS: tuple[tuple[int, int, int], ...] = (
    (0, 0, 0), (0, 1, 1), (0, 2, 2),
    (1, 0, 1), (1, 1, 0), (1, 1, 1), (1, 1, 2), (1, 2, 1), (1, 2, 2),
    (2, 0, 2), (2, 1, 1), (2, 1, 2), (2, 2, 0), (2, 2, 1), (2, 2, 2),
)


def _eps3(like: torch.Tensor) -> torch.Tensor:
    return torch.as_tensor(EPS3, dtype=like.dtype, device=like.device)


def _symtf(m: torch.Tensor) -> torch.Tensor:
    """Symmetric traceless part of [..., 3, 3]."""
    s = 0.5 * (m + m.transpose(-1, -2))
    tr = torch.diagonal(s, dim1=-2, dim2=-1).sum(-1)[..., None, None]
    return s - tr * torch.eye(3, dtype=m.dtype, device=m.device) / 3.0


def tp_contract(l1: int, l2: int, l3: int, x: torch.Tensor,
                y: torch.Tensor) -> torch.Tensor:
    """x: edge-gathered feature [m, C, (3,)*l1]; y: edge SH [m, (3,)*l2]."""
    key = (l1, l2, l3)
    if key == (0, 0, 0):
        return x
    if key == (0, 1, 1):
        return x[..., None] * y[:, None, :]
    if key == (0, 2, 2):
        return x[..., None, None] * y[:, None, :, :]
    if key == (1, 0, 1):
        return x
    if key == (1, 1, 0):
        return torch.einsum("mci,mi->mc", x, y)
    if key == (1, 1, 1):
        return torch.linalg.cross(x, y[:, None, :].expand_as(x), dim=-1)
    if key == (1, 1, 2):
        return _symtf(torch.einsum("mci,mj->mcij", x, y))
    if key == (1, 2, 1):
        return torch.einsum("mcj,mij->mci", x, y)
    if key == (1, 2, 2):
        return _symtf(torch.einsum("ikl,mck,mlj->mcij", _eps3(x), x, y))
    if key == (2, 0, 2):
        return x
    if key == (2, 1, 1):
        return torch.einsum("mcij,mj->mci", x, y)
    if key == (2, 1, 2):
        return _symtf(torch.einsum("ikl,mk,mclj->mcij", _eps3(x), y, x))
    if key == (2, 2, 0):
        return torch.einsum("mcij,mij->mc", x, y)
    if key == (2, 2, 1):
        return torch.einsum("ijk,mcjl,mkl->mci", _eps3(x), x, y)
    if key == (2, 2, 2):
        return _symtf(torch.einsum("mcik,mkj->mcij", x, y))
    raise ValueError(key)


def edge_sh(unit: torch.Tensor) -> dict[int, torch.Tensor]:
    """Cartesian 'spherical harmonics' of the edge direction."""
    y2 = _symtf(torch.einsum("mi,mj->mij", unit, unit))
    return {0: torch.ones(unit.shape[0], dtype=unit.dtype,
                          device=unit.device), 1: unit, 2: y2}


def init_nequip(gen: torch.Generator, *, d_in: int, d_hidden: int = 32,
                n_layers: int = 5, l_max: int = 2, n_rbf: int = 8,
                cutoff: float = 5.0, d_out: int = 1, device="cuda"):
    """The reference's tree: ``embed``, ``layers`` (``radial`` MLP,
    ``lin`` w0-w2, ``gate`` g1-g2, ``bias0``) and ``out``, drawn from
    ``gen`` (a generator of ``device``)."""
    if l_max != 2:
        raise ValueError("the Cartesian path table is for l_max=2")
    C = d_hidden

    def square():
        return torch.randn((C, C), generator=gen, device=device) / np.sqrt(C)

    params = {"embed": init_mlp(gen, [d_in, C], device=device), "layers": [],
              "out": init_mlp(gen, [C, C, d_out], device=device)}
    for _ in range(n_layers):
        params["layers"].append({
            "radial": init_mlp(gen, [n_rbf, 2 * C, len(PATHS) * C],
                               device=device),
            "lin": {f"w{l}": square() for l in range(3)},
            "gate": {f"g{l}": square() for l in (1, 2)},
            "bias0": torch.zeros((C,), device=device),
        })
    return params


def nequip_forward(params, g: GraphBatch, *, n_rbf: int = 8,
                   cutoff: float = 5.0) -> torch.Tensor:
    C = params["layers"][0]["lin"]["w0"].shape[0]
    n = g.node_feat.shape[0]
    m = g.src.shape[0]
    unit, d = edge_vectors(g.positions, g.src, g.dst)
    Y = edge_sh(unit)
    env = (polynomial_envelope(d, cutoff) * g.edge_mask)[:, None]
    rbf = bessel_rbf(d, n_rbf, cutoff)
    src = g.src.long()

    h0 = mlp(params["embed"], g.node_feat)
    h = {0: h0, 1: h0.new_zeros((n, C, 3)), 2: h0.new_zeros((n, C, 3, 3))}
    for lay in params["layers"]:
        w = (mlp(lay["radial"], rbf) * env).reshape(m, len(PATHS), C)
        agg = {0: h0.new_zeros((n, C)), 1: h0.new_zeros((n, C, 3)),
               2: h0.new_zeros((n, C, 3, 3))}
        gathered = {l: whole(h[l]).index_select(0, src) for l in range(3)}
        for p, (l1, l2, l3) in enumerate(PATHS):
            msg = tp_contract(l1, l2, l3, gathered[l1], Y[l2])
            wp = w[:, p].reshape((m, C) + (1,) * l3)
            agg[l3] = agg[l3] + scatter_sum(msg * wp, g.dst, n)
        # self-interaction (channel mixing is equivariant) + gated
        # nonlinearity
        new = {}
        s0 = torch.einsum("nc,cd->nd", agg[0], lay["lin"]["w0"]) \
            + lay["bias0"]
        new[0] = h[0] + F.silu(s0)
        for l in (1, 2):
            sl = torch.einsum("nc...,cd->nd...", agg[l], lay["lin"][f"w{l}"])
            gate = torch.sigmoid(h[0] @ lay["gate"][f"g{l}"])
            new[l] = h[l] + sl * gate.reshape((n, C) + (1,) * l)
        h = new
    return mlp(params["out"], h[0])
