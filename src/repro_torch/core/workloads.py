"""The GNN inference workloads: the paper's five invertible ones (§7.1.1),
the two monotonic ones (max/min) and the two bounded-recompute ones.

GC-S   GraphConv + sum            h^l = relu(W_l x^l + b_l)
GS-S   GraphSAGE + sum            h^l = relu(W_self h^{l-1} + W_nbr x^l + b_l)
GC-M   GraphConv + mean           x^l = S^l / k
GI-S   GINConv + sum              h^l = MLP_l((1+eps) h^{l-1} + x^l)
GC-W   GraphConv + weighted sum   x^l = sum_j alpha_ij h_j
GS-MAX GraphSAGE + max            x^l = max_j h_j (per dim)
GC-MIN GraphConv + min            x^l = min_j h_j (per dim)
GA-S   GraphSAGE + attention      x^l = sum_j softmax_j(logit(h_j)) h_j
GP-M   GraphConv + PNA tower      x^l = [log1p(k)*mean_j, std_j, max_j] h_j

where S^l is the *unnormalized* aggregate of h^{l-1} over in-neighbors and
x^l its normalized form.  Storing (S, k) instead of x keeps ``mean`` exact
under in-degree changes from streaming topology updates; for max/min, S^l
is the tracked extremum and an empty row reads as 0; for the bounded pair,
S^l holds the normalized aggregate x^l itself.

Each family's UPDATE is an ``nn.Module`` whose parameter names equal the
reference's parameter-dict keys, so weights made by either package load
into the other (:func:`params_from_numpy`).  The weights that read x
(``w``, ``w_nbr``, ``w1``) are ``agg.x_multiplier`` times as wide as the
layer's input, as PNA's tower needs.  The host engines (``core/engine.py``)
run the same UPDATE bodies over NumPy on the parameter dicts of
``state.params_to_numpy`` (:data:`NP_UPDATE`, :meth:`Workload.update_fn`).
"""
from __future__ import annotations

from dataclasses import dataclass
from functools import partial

import numpy as np
import torch
from torch import nn

from .aggregators import Aggregator, get_aggregator


def _param(*shape: int) -> nn.Parameter:
    # inference only: parameters never take part in autograd
    return nn.Parameter(torch.zeros(shape), requires_grad=False)


class GraphConvLayer(nn.Module):
    """h = act(x @ w + b)."""

    def __init__(self, d_in: int, d_out: int, *, last: bool, mult: int = 1):
        super().__init__()
        self.last = last
        self.w = _param(d_in * mult, d_out)
        self.b = _param(d_out)

    def forward(self, h_prev: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
        out = x @ self.w + self.b
        return out if self.last else torch.relu(out)


class SageLayer(nn.Module):
    """h = act(h_prev @ w_self + x @ w_nbr + b)."""

    def __init__(self, d_in: int, d_out: int, *, last: bool, mult: int = 1):
        super().__init__()
        self.last = last
        self.w_self = _param(d_in, d_out)
        self.w_nbr = _param(d_in * mult, d_out)
        self.b = _param(d_out)

    def forward(self, h_prev: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
        out = h_prev @ self.w_self + x @ self.w_nbr + self.b
        return out if self.last else torch.relu(out)


class GinLayer(nn.Module):
    """h = act(relu(((1 + eps) h_prev + x) @ w1 + b1) @ w2 + b2)."""

    def __init__(self, d_in: int, d_out: int, *, last: bool, mult: int = 1):
        super().__init__()
        self.last = last
        self.eps = _param()
        self.w1 = _param(d_in * mult, d_out)
        self.b1 = _param(d_out)
        self.w2 = _param(d_out, d_out)
        self.b2 = _param(d_out)

    def forward(self, h_prev: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
        z = (1.0 + self.eps) * h_prev + x
        out = torch.relu(z @ self.w1 + self.b1) @ self.w2 + self.b2
        return out if self.last else torch.relu(out)


# the family table: the device engine and the full pass run these modules
FAMILY_UPDATE = {"gc": GraphConvLayer, "sage": SageLayer, "gin": GinLayer}
_FAMILY_SELF_DEP = {"gc": False, "sage": True, "gin": True}


def _gc_update(p, h_prev, x, *, last: bool):
    out = x @ p["w"] + p["b"]
    return out if last else np.maximum(out, 0.0)


def _sage_update(p, h_prev, x, *, last: bool):
    out = h_prev @ p["w_self"] + x @ p["w_nbr"] + p["b"]
    return out if last else np.maximum(out, 0.0)


def _gin_update(p, h_prev, x, *, last: bool):
    z = (1.0 + p["eps"]) * h_prev + x
    out = np.maximum(z @ p["w1"] + p["b1"], 0.0) @ p["w2"] + p["b2"]
    return out if last else np.maximum(out, 0.0)


# the same bodies over NumPy, for the host engines: (params_l, h_prev, x)
# -> h_l with params_l one dict of ``params_to_numpy``
NP_UPDATE = {"gc": _gc_update, "sage": _sage_update, "gin": _gin_update}


@dataclass(frozen=True)
class WorkloadSpec:
    """A GNN inference workload: model family x aggregation function."""

    name: str
    aggregator: str  # "sum" | "mean" | "wsum" | "max" | "min" | "attn"
    #                  | "topk" | "pna"
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
        return [cls(dims[l], dims[l + 1], last=l == L - 1,
                    mult=self.agg.x_multiplier).to(device)
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

    def update_fn(self, layer: int):
        """The layer's UPDATE over NumPy, ``(params_l, h_prev, x) -> h``,
        for the host engines (the device and the full pass run the layer
        modules)."""
        return partial(NP_UPDATE[self.family],
                       last=layer == self.spec.n_layers - 1)


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
    gi-s, gc-w), the two monotonic ones (gs-max, gc-min) and the two
    bounded-recompute ones (ga-s, gp-m)."""
    name = name.lower()
    family, agg = _WORKLOAD_TABLE[name]
    dims = (d_in,) + (d_hidden,) * (n_layers - 1) + (n_classes,)
    spec = WorkloadSpec(name=name, aggregator=agg,
                        self_dependent=_FAMILY_SELF_DEP[family],
                        n_layers=n_layers, dims=dims)
    return Workload(spec=spec, family=family)


WORKLOAD_NAMES = tuple(_WORKLOAD_TABLE)
INVERTIBLE_WORKLOAD_NAMES = ("gc-s", "gs-s", "gc-m", "gi-s", "gc-w")
MONOTONIC_WORKLOAD_NAMES = ("gs-max", "gc-min")
BOUNDED_WORKLOAD_NAMES = ("ga-s", "gp-m")
