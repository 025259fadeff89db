"""DimeNet (arXiv:2003.03123) in PyTorch: directional message passing over
edges, the port of ``repro``'s ``models/gnn/dimenet.py``.

Messages live on *edges*; interaction blocks aggregate over triplets
(k -> j -> i) using a 2D spherical-Bessel/Legendre basis of (d_kj,
angle).  The triplet index lists are built on the host (NumPy), the
bases on the device.  The bilinear contraction ``"tb,ti,bij->tj"`` is
taken apart so that nothing larger than ``[t, n_bilinear * d]`` is
formed: each edge's ``x @ W_b`` for every b first (``[m, n_bilinear
* d]``), gathered by ``e_in``, then one batched product with the
triplet's ``n_bilinear`` weights.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch
import torch.nn.functional as F

from .common import (GraphBatch, bessel_rbf, edge_vectors, init_mlp, mlp,
                     polynomial_envelope, scatter_sum, sharded, whole)


# ---------------------------------------------------------------------------
# spherical Bessel basis machinery (zeros by bisection, host float64)
# ---------------------------------------------------------------------------
def _jl_np(l: int, x: np.ndarray) -> np.ndarray:
    """Spherical Bessel j_l via upward recurrence (float64, host)."""
    x = np.asarray(x, dtype=np.float64)
    x = np.where(np.abs(x) < 1e-8, 1e-8, x)
    j0 = np.sin(x) / x
    if l == 0:
        return j0
    j1 = np.sin(x) / x ** 2 - np.cos(x) / x
    jm, jc = j0, j1
    for ll in range(2, l + 1):
        jm, jc = jc, (2 * ll - 1) / x * jc - jm
    return jc if l >= 1 else j0


def bessel_zeros(n_l: int, n_n: int) -> np.ndarray:
    """First n_n positive zeros of j_l for l = 0..n_l-1 (bisection)."""
    zeros = np.zeros((n_l, n_n))
    for l in range(n_l):
        found, x = [], l + 1e-3  # j_l's first zero is > l
        step = 0.1
        prev = _jl_np(l, np.array([x]))[0]
        while len(found) < n_n:
            x2 = x + step
            cur = _jl_np(l, np.array([x2]))[0]
            if prev * cur < 0:
                a, b = x, x2
                for _ in range(60):
                    mid = 0.5 * (a + b)
                    fm = _jl_np(l, np.array([mid]))[0]
                    if prev * fm <= 0:
                        b = mid
                    else:
                        a, prev = mid, fm
                found.append(0.5 * (a + b))
                prev = cur
            else:
                prev = cur
            x = x2
        zeros[l] = found
    return zeros


def _legendre(n_l: int, c: torch.Tensor) -> torch.Tensor:
    """P_l(c) for l=0..n_l-1, stacked on the last axis."""
    outs = [torch.ones_like(c), c]
    for l in range(2, n_l):
        outs.append(((2 * l - 1) * c * outs[-1] - (l - 1) * outs[-2]) / l)
    return torch.stack(outs[:n_l], dim=-1)


def _jl_torch(l: int, x: torch.Tensor) -> torch.Tensor:
    x = torch.maximum(x, torch.full_like(x, 5e-2))  # clamp: a fixed basis
    j0 = torch.sin(x) / x
    if l == 0:
        return j0
    j1 = torch.sin(x) / x ** 2 - torch.cos(x) / x
    jm, jc = j0, j1
    for ll in range(2, l + 1):
        jm, jc = jc, (2 * ll - 1) / x * jc - jm
    return jc


class Triplets(NamedTuple):
    """Padded triplet lists: edge e_in=(k->j) feeding edge e_out=(j->i)."""

    e_in: torch.Tensor    # [t] int32 edge ids
    e_out: torch.Tensor   # [t]
    mask: torch.Tensor    # [t] float


def triplet_lists(src: np.ndarray, dst: np.ndarray
                  ) -> tuple[np.ndarray, np.ndarray]:
    """(e_in, e_out) of every triplet: for each edge e_out = (j->i) in
    edge order, each in-edge e_in = (k->j) of j in edge order, k != i --
    the reference's double loop, vectorised."""
    src, dst = np.asarray(src, np.int64), np.asarray(dst, np.int64)
    m = src.shape[0]
    n = int(max(src.max(initial=-1), dst.max(initial=-1))) + 1
    by_dst = np.argsort(dst, kind="stable")          # in-edges, edge order
    start = np.zeros(n + 1, np.int64)
    np.cumsum(np.bincount(dst, minlength=n), out=start[1:])
    lens = start[src + 1] - start[src]                # in-degree of each j
    e_out = np.repeat(np.arange(m, dtype=np.int64), lens)
    offset = np.arange(e_out.shape[0]) - np.repeat(np.cumsum(lens) - lens,
                                                   lens)
    e_in = by_dst[start[src[e_out]] + offset]
    keep = src[e_in] != dst[e_out]
    return e_in[keep], e_out[keep]


def build_triplets(src: np.ndarray, dst: np.ndarray, n: int,
                   cap: int | None = None, device="cuda") -> Triplets:
    """For each edge (j->i), pair with every in-edge (k->j), k != i;
    padded to ``cap`` slots (e_in = e_out = 0, mask 0), or to the count
    (at least one slot) without one.  The lists are the reference's, in
    its order; the tensors are made on ``device``."""
    t_in, t_out = triplet_lists(src, dst)
    t = t_in.shape[0]
    cap = cap or max(t, 1)
    if t > cap:
        raise ValueError(f"triplet overflow: {t} > {cap}")
    e_in = np.zeros(cap, np.int32)
    e_out = np.zeros(cap, np.int32)
    mask = np.zeros(cap, np.float32)
    e_in[:t], e_out[:t], mask[:t] = t_in, t_out, 1.0
    return Triplets(*(torch.as_tensor(a, device=device)
                      for a in (e_in, e_out, mask)))


def init_dimenet(gen: torch.Generator, *, d_in: int, d_hidden: int = 128,
                 n_blocks: int = 6, n_bilinear: int = 8,
                 n_spherical: int = 7, n_radial: int = 6,
                 cutoff: float = 5.0, d_out: int = 1, device="cuda"):
    """The reference's tree, drawn from ``gen`` (a generator of
    ``device``); ``"_zeros"`` holds the Bessel roots, a non-trainable
    buffer (``configs.gnn_common.split_params``)."""
    d = d_hidden

    def normal(*shape, scale):
        return torch.randn(shape, generator=gen, device=device) * scale

    params = {
        "embed_node": init_mlp(gen, [d_in, d_hidden], device=device),
        "embed_edge": init_mlp(gen, [2 * d_hidden + n_radial, d_hidden],
                               device=device),
        "blocks": [],
        "_zeros": torch.as_tensor(bessel_zeros(n_spherical, n_radial),
                                  dtype=torch.float32, device=device),
    }
    for _ in range(n_blocks):
        params["blocks"].append({
            "w_sbf": normal(n_spherical * n_radial, n_bilinear, scale=0.1),
            "w_msg": init_mlp(gen, [d, d], device=device),
            "bilinear": normal(n_bilinear, d, d, scale=1.0 / np.sqrt(d)),
            "update": init_mlp(gen, [d, d, d], device=device),
            "out_rbf": normal(n_radial, d, scale=0.1),
            "out": init_mlp(gen, [d, d], device=device),
        })
    params["head"] = init_mlp(gen, [d_hidden, d_hidden, d_out],
                              device=device)
    return params


def bilinear(sbf_p: torch.Tensor, x: torch.Tensor, e_in: torch.Tensor,
             w: torch.Tensor) -> torch.Tensor:
    """``einsum("tb,ti,bij->tj", sbf_p, x[e_in], w)`` without a ``[t, b,
    i, j]`` or ``[t, b, i]`` intermediate: ``x @ w_b`` for every b on the
    edges, gathered by ``e_in`` (``[t, b * d]``, the largest tensor),
    weighted by ``sbf_p`` in one batched product.  On a per-shard forward
    (``sharded.active()``) the edges' ``x`` is gathered, as the reference
    gathers ``x[e_in]``, and multiplied on the triplets: the ``[m, b * d]``
    product would be eight times the rows to gather."""
    t, b = sbf_p.shape
    d_in, d_out = w.shape[1], w.shape[2]
    w = w.permute(1, 0, 2).reshape(d_in, b * d_out)
    if sharded.active():
        g = (whole(x).index_select(0, e_in.long()) @ w).view(t, b, d_out)
    else:
        xw = x @ w                                           # [m, b * d]
        g = xw.index_select(0, e_in.long()).view(t, b, d_out)
    return torch.bmm(sbf_p[:, None, :], g)[:, 0]


def dimenet_forward(params, g: GraphBatch, trip: Triplets, *,
                    n_spherical: int = 7, n_radial: int = 6,
                    cutoff: float = 5.0) -> torch.Tensor:
    n, m = g.node_feat.shape[0], g.src.shape[0]
    d_hid = params["embed_node"][-1]["w"].shape[1]
    unit, dist = edge_vectors(g.positions, g.src, g.dst)
    env = (polynomial_envelope(dist, cutoff) * g.edge_mask)[:, None]
    rbf = bessel_rbf(dist, n_radial, cutoff) * env
    e_in, e_out = trip.e_in.long(), trip.e_out.long()

    # angle(k->j->i) between (x_k - x_j) and (x_i - x_j)
    unit_w, dist_w = whole(unit), whole(dist)
    v_out = unit_w.index_select(0, e_out)    # x_j - x_i direction
    v_in = unit_w.index_select(0, e_in)      # x_k - x_j direction
    c = -(v_in * v_out).sum(-1)
    one = torch.ones_like(c)
    cos_a = torch.minimum(torch.maximum(c, -one), one)   # jnp.clip's ties
    # 2D spherical basis: j_l(z_ln * d_kj / c) * P_l(cos angle)
    x_scaled = dist_w.index_select(0, e_in)[:, None, None] / cutoff \
        * params["_zeros"]
    jl = torch.stack([_jl_torch(l, x_scaled[:, l, :])
                      for l in range(n_spherical)], dim=1)
    pl = _legendre(n_spherical, cos_a)                    # [t, n_sph]
    sbf = (jl * pl[:, :, None]).reshape(jl.shape[0], -1)  # [t, n_sph*n_rad]
    sbf = sbf * trip.mask[:, None]

    h = mlp(params["embed_node"], g.node_feat)
    src, dst = g.src.long(), g.dst.long()
    h_w = whole(h)
    msg = mlp(params["embed_edge"],
              torch.cat([h_w.index_select(0, src), h_w.index_select(0, dst),
                         rbf], -1))                  # [m, d]

    node_out = h.new_zeros((n, d_hid))
    for blk in params["blocks"]:
        x = F.silu(mlp(blk["w_msg"][:1], msg))
        sbf_p = sbf @ blk["w_sbf"]                        # [t, n_bilinear]
        contrib = bilinear(sbf_p, x, e_in, blk["bilinear"])
        agg = scatter_sum(contrib * trip.mask[:, None], e_out, m)
        msg = msg + mlp(blk["update"], agg)
        node_out = node_out + scatter_sum(
            mlp(blk["out"], msg * (rbf @ blk["out_rbf"])), dst, n)
    return mlp(params["head"], node_out)
