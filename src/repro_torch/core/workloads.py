"""The GNN inference workloads: the paper's five invertible ones (§7.1.1)
and the two monotonic ones (max/min).

GC-S   GraphConv + sum            h^l = relu(W_l x^l + b_l)
GS-S   GraphSAGE + sum            h^l = relu(W_self h^{l-1} + W_nbr x^l + b_l)
GC-M   GraphConv + mean           x^l = S^l / k
GI-S   GINConv + sum              h^l = MLP_l((1+eps) h^{l-1} + x^l)
GC-W   GraphConv + weighted sum   x^l = sum_j alpha_ij h_j
GS-MAX GraphSAGE + max            x^l = max_j h_j (per dim)
GC-MIN GraphConv + min            x^l = min_j h_j (per dim)

where S^l is the *unnormalized* aggregate of h^{l-1} over in-neighbors and
x^l its normalized form.  Storing (S, k) instead of x keeps ``mean`` exact
under in-degree changes from streaming topology updates; for max/min, S^l
is the tracked extremum and an empty row reads as 0.

Each family's UPDATE is an ``nn.Module`` whose parameter names equal the
reference's parameter-dict keys, so weights made by either package load
into the other (:func:`params_from_numpy`).  ``WORKLOAD_NAMES`` keeps all
nine names of the reference; the two bounded ones (ga-s, gp-m) raise at
:func:`make_workload` until their family is ported.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch
from torch import nn

from .aggregators import Aggregator, get_aggregator


def _param(*shape: int) -> nn.Parameter:
    # inference only: parameters never take part in autograd
    return nn.Parameter(torch.zeros(shape), requires_grad=False)


class GraphConvLayer(nn.Module):
    """h = act(x @ w + b)."""

    def __init__(self, d_in: int, d_out: int, *, last: bool):
        super().__init__()
        self.last = last
        self.w = _param(d_in, d_out)
        self.b = _param(d_out)

    def forward(self, h_prev: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
        out = x @ self.w + self.b
        return out if self.last else torch.relu(out)


class SageLayer(nn.Module):
    """h = act(h_prev @ w_self + x @ w_nbr + b)."""

    def __init__(self, d_in: int, d_out: int, *, last: bool):
        super().__init__()
        self.last = last
        self.w_self = _param(d_in, d_out)
        self.w_nbr = _param(d_in, d_out)
        self.b = _param(d_out)

    def forward(self, h_prev: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
        out = h_prev @ self.w_self + x @ self.w_nbr + self.b
        return out if self.last else torch.relu(out)


class GinLayer(nn.Module):
    """h = act(relu(((1 + eps) h_prev + x) @ w1 + b1) @ w2 + b2)."""

    def __init__(self, d_in: int, d_out: int, *, last: bool):
        super().__init__()
        self.last = last
        self.eps = _param()
        self.w1 = _param(d_in, d_out)
        self.b1 = _param(d_out)
        self.w2 = _param(d_out, d_out)
        self.b2 = _param(d_out)

    def forward(self, h_prev: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
        z = (1.0 + self.eps) * h_prev + x
        out = torch.relu(z @ self.w1 + self.b1) @ self.w2 + self.b2
        return out if self.last else torch.relu(out)


# the one family table: every engine derives its UPDATE from these entries
FAMILY_UPDATE = {"gc": GraphConvLayer, "sage": SageLayer, "gin": GinLayer}
_FAMILY_SELF_DEP = {"gc": False, "sage": True, "gin": True}


@dataclass(frozen=True)
class WorkloadSpec:
    """A GNN inference workload: model family x aggregation function."""

    name: str
    aggregator: str  # "sum" | "mean" | "wsum" | "max" | "min"
    self_dependent: bool  # does h^l read h^{l-1}_self directly?
    n_layers: int
    dims: tuple[int, ...]  # (d0, d1, ..., dL)

    @property
    def weighted(self) -> bool:
        return get_aggregator(self.aggregator).weighted


@dataclass(frozen=True)
class Workload:
    spec: WorkloadSpec
    family: str

    @property
    def agg(self) -> Aggregator:
        """The aggregation algebra this workload runs on."""
        return get_aggregator(self.spec.aggregator)

    def make_layers(self, device="cuda") -> list[nn.Module]:
        """Zero-initialised UPDATE modules, one per layer."""
        dims, L = self.spec.dims, self.spec.n_layers
        cls = FAMILY_UPDATE[self.family]
        return [cls(dims[l], dims[l + 1], last=l == L - 1).to(device)
                for l in range(L)]

    def init_params(self, generator: torch.Generator,
                    device="cuda") -> list[nn.Module]:
        """Random layers from ``generator``, scaled like the reference's
        ``init_params``.  Torch's generator cannot reproduce the
        reference's random keys, so parity tests load the reference's
        weights through :func:`params_from_numpy` instead."""
        layers = self.make_layers("cpu")
        for layer in layers:
            for name, p in layer.named_parameters():
                if name.startswith("w"):
                    p.copy_(torch.randn(p.shape, generator=generator)
                            / np.sqrt(p.shape[0]))
        return [layer.to(device) for layer in layers]

    def normalize(self, S: torch.Tensor, k: torch.Tensor) -> torch.Tensor:
        """Aggregate normalization x = norm(S, k)."""
        return self.agg.normalize(S, k)


def params_from_numpy(workload: Workload, params_np: list[dict],
                      device="cuda") -> list[nn.Module]:
    """The port's layer modules holding the given NumPy weights
    (``list[dict[str, np.ndarray]]``, the reference's parameter layout)."""
    layers = workload.make_layers(device)
    if len(params_np) != len(layers):
        raise ValueError(f"{len(params_np)} parameter dicts for "
                         f"{len(layers)} layers")
    for l, (layer, p_np) in enumerate(zip(layers, params_np)):
        names = dict(layer.named_parameters())
        if set(p_np) != set(names):
            raise ValueError(f"layer {l}: keys {sorted(p_np)} != "
                             f"{sorted(names)}")
        for name, p in names.items():
            src = torch.from_numpy(np.array(p_np[name], dtype=np.float32))
            if tuple(src.shape) != tuple(p.shape):
                raise ValueError(f"layer {l} {name!r}: shape "
                                 f"{tuple(src.shape)} != {tuple(p.shape)}")
            p.copy_(src)
    return layers


_WORKLOAD_TABLE = {
    "gc-s": ("gc", "sum"),
    "gs-s": ("sage", "sum"),
    "gc-m": ("gc", "mean"),
    "gi-s": ("gin", "sum"),
    "gc-w": ("gc", "wsum"),
    "gs-max": ("sage", "max"),
    "gc-min": ("gc", "min"),
    "ga-s": ("sage", "attn"),
    "gp-m": ("gc", "pna"),
}


def make_workload(name: str, n_layers: int = 2, d_in: int = 32,
                  d_hidden: int = 32, n_classes: int = 8) -> Workload:
    """Factory for the paper's five invertible workloads (gc-s, gs-s, gc-m,
    gi-s, gc-w) and the two monotonic ones (gs-max, gc-min); the bounded
    names (ga-s, gp-m) raise ``NotImplementedError``."""
    name = name.lower()
    family, agg = _WORKLOAD_TABLE[name]
    get_aggregator(agg)  # raises for the families not ported yet
    dims = (d_in,) + (d_hidden,) * (n_layers - 1) + (n_classes,)
    spec = WorkloadSpec(name=name, aggregator=agg,
                        self_dependent=_FAMILY_SELF_DEP[family],
                        n_layers=n_layers, dims=dims)
    return Workload(spec=spec, family=family)


WORKLOAD_NAMES = tuple(_WORKLOAD_TABLE)
INVERTIBLE_WORKLOAD_NAMES = ("gc-s", "gs-s", "gc-m", "gi-s", "gc-w")
MONOTONIC_WORKLOAD_NAMES = ("gs-max", "gc-min")
