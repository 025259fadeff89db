"""Optimizers in plain tensor code, the port of ``repro``'s
``train/optim.py``: AdamW, Adafactor (factored second moments, Shazeer &
Stern arXiv:1804.04235), global-norm clipping and the gradient-compression
hooks (int8 with a per-tensor scale; top-k with error feedback).

The arithmetic is the reference's: moments and updates in fp32 whatever
the parameter's dtype, the update cast once to it, the bias correction at
``t = step`` computed on the device in fp32.  Unlike the reference, the
updates work in place: each parameter and state tensor is overwritten
leaf by leaf, so the peak stays one leaf's fp32 temporaries, and the
returned trees are the ones passed in.  Parameter trees are the port's
nested dicts and lists of tensors; a state's trees follow the
parameters'.  ``torch.optim.AdamW`` is not used: it keeps a bf16
parameter's moments in bf16 and orders its step otherwise.
"""
from __future__ import annotations

from typing import Any, NamedTuple

import torch

from repro_torch.ckpt.checkpoint import tree_flatten, tree_unflatten

Pytree = Any


def tree_map(fn, tree, *rest) -> Pytree:
    """``fn`` over the leaves of ``tree`` (and of ``rest``, which share its
    structure), in ``tree_flatten`` order; the result has ``tree``'s
    structure."""
    leaves = zip(tree_flatten(tree), *(tree_flatten(r) for r in rest))
    return tree_unflatten(tree, [fn(*ls) for ls in leaves])


def _step_of(params) -> torch.Tensor:
    leaves = tree_flatten(params)
    device = leaves[0].device if leaves else "cpu"
    return torch.zeros((), dtype=torch.int32, device=device)


# ---------------------------------------------------------------------------
# AdamW
# ---------------------------------------------------------------------------
class AdamWState(NamedTuple):
    step: torch.Tensor   # 0-d int32, on the parameters' device
    mu: Pytree
    nu: Pytree


def adamw_init(params: Pytree) -> AdamWState:
    def zeros(p):
        return torch.zeros(p.shape, dtype=torch.float32, device=p.device)

    return AdamWState(step=_step_of(params), mu=tree_map(zeros, params),
                      nu=tree_map(zeros, params))


@torch.no_grad()
def adamw_update(grads: Pytree, state: AdamWState, params: Pytree, *,
                 lr: float, b1: float = 0.9, b2: float = 0.95,
                 eps: float = 1e-8, weight_decay: float = 0.1):
    """One AdamW step, in place: returns (params, state), the same trees
    with every leaf overwritten and ``state.step`` advanced."""
    state.step.add_(1)
    t = state.step.float()
    one = torch.ones((), dtype=torch.float32, device=t.device)
    bc1 = one - torch.full_like(t, b1) ** t
    bc2 = one - torch.full_like(t, b2) ** t
    for g, m, v, p in zip(tree_flatten(grads), tree_flatten(state.mu),
                          tree_flatten(state.nu), tree_flatten(params)):
        g = g.float()                  # g itself when it is fp32
        m.mul_(b1).add_(g * (1 - b1))
        v.mul_(b2).add_(g * (1 - b2) * g)
        upd = (v / bc2).sqrt_().add_(eps)
        upd = torch.div(m / bc1, upd, out=upd)
        p32 = p.float()
        upd.add_(p32 * weight_decay)
        if p32 is p:
            p.sub_(upd.mul_(lr))
        else:
            p.copy_(p32.sub_(upd.mul_(lr)))
    return params, state


# ---------------------------------------------------------------------------
# Adafactor (factored second moments; no first moment)
# ---------------------------------------------------------------------------
class AdafactorState(NamedTuple):
    step: torch.Tensor
    vr: Pytree   # row stats (or the full v of a tensor below 2-D)
    vc: Pytree   # column stats (a [1] placeholder below 2-D)


def _factored(p: torch.Tensor) -> bool:
    return p.dim() >= 2


def adafactor_init(params: Pytree) -> AdafactorState:
    def rows(p):
        return torch.zeros(p.shape[:-1] if _factored(p) else p.shape,
                           dtype=torch.float32, device=p.device)

    def cols(p):
        return torch.zeros(p.shape[:-2] + p.shape[-1:] if _factored(p)
                           else (1,), dtype=torch.float32, device=p.device)

    return AdafactorState(step=_step_of(params), vr=tree_map(rows, params),
                          vc=tree_map(cols, params))


@torch.no_grad()
def adafactor_update(grads: Pytree, state: AdafactorState, params: Pytree,
                     *, lr: float, decay: float = 0.8, eps: float = 1e-30,
                     clip_threshold: float = 1.0, weight_decay: float = 0.0):
    """One Adafactor step, in place: returns (params, state), the same
    trees with every leaf overwritten and ``state.step`` advanced."""
    state.step.add_(1)
    t = state.step.float()
    beta2 = 1.0 - t ** (-decay)
    for g, vr, vc, p in zip(tree_flatten(grads), tree_flatten(state.vr),
                            tree_flatten(state.vc), tree_flatten(params)):
        g = g.float()
        g2 = g * g + eps
        if _factored(p):
            vr.copy_(beta2 * vr + (1 - beta2) * g2.mean(dim=-1))
            vc.copy_(beta2 * vc + (1 - beta2) * g2.mean(dim=-2))
            r = vr / torch.clamp(vr.mean(dim=-1, keepdim=True), min=eps)
            u = g * torch.rsqrt(r)[..., None] * torch.rsqrt(vc)[..., None, :]
        else:
            vr.copy_(beta2 * vr + (1 - beta2) * g2)
            u = g * torch.rsqrt(vr)
        del g2
        # update clipping (RMS <= clip_threshold)
        rms = torch.sqrt(torch.mean(u * u) + eps)
        u = u / torch.clamp(rms / clip_threshold, min=1.0)
        p.copy_(p.float() * (1.0 - lr * weight_decay) - lr * u)
    return params, state


# ---------------------------------------------------------------------------
# shared utilities
# ---------------------------------------------------------------------------
@torch.no_grad()
def clip_by_global_norm(grads: Pytree, max_norm: float):
    """Scales every gradient, in place, by ``min(1, max_norm / norm)`` of
    the global L2 norm (in fp32, leaves summed in ``tree_flatten`` order);
    returns (grads, norm as a 0-d fp32 tensor)."""
    leaves = tree_flatten(grads)
    gn = torch.sqrt(sum(torch.sum(torch.square(g.float())) for g in leaves))
    scale = torch.clamp(max_norm / torch.clamp(gn, min=1e-9), max=1.0)
    for g in leaves:
        if g.dtype == torch.float32:
            g.mul_(scale)
        else:   # scaled in fp32 and rounded once, as the reference does
            g.copy_(g.float() * scale)
    return grads, gn


def make_optimizer(name: str):
    """Returns (init_fn, update_fn(grads, state, params, lr=))."""
    if name == "adamw":
        return adamw_init, adamw_update
    if name == "adafactor":
        return adafactor_init, adafactor_update
    raise ValueError(name)


# ---------------------------------------------------------------------------
# gradient compression (distributed-optimization hook)
# ---------------------------------------------------------------------------
class CompressionState(NamedTuple):
    error: Pytree   # error-feedback residual (top-k)


def compression_init(params: Pytree, method: str) -> CompressionState | None:
    if method == "topk":
        return CompressionState(error=tree_map(
            lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                  device=p.device), params))
    return None


@torch.no_grad()
def compress_grads(grads: Pytree, method: str,
                   comp_state: CompressionState | None = None,
                   topk_frac: float = 0.01):
    """Lossy-compress gradients before the data-parallel all-reduce;
    returns (new gradients, state).

    int8: per-tensor absmax int8 quantize/dequantize (8x wire reduction).
    topk: keep the top ``topk_frac`` |g| entries of ``g + error`` and keep
    the rest as the new error-feedback residual, written into
    ``comp_state`` in place (Stich et al., arXiv:1809.07599).  Top-k needs
    that state: without one it raises ``ValueError`` (the reference fails
    there too, on ``None.error``).
    """
    if method == "none":
        return grads, comp_state
    if method == "int8":
        def q(g):
            scale = torch.clamp(g.abs().max(), min=1e-9) / 127.0
            return torch.round(g / scale).to(torch.int8).to(g.dtype) * scale
        return tree_map(q, grads), comp_state
    if method == "topk":
        if comp_state is None:
            raise ValueError("top-k compression keeps an error-feedback "
                             "residual: pass compression_init(params, "
                             "'topk') as comp_state")

        def tk(g, e):
            gf = g.float() + e
            k = max(1, int(gf.numel() * topk_frac))
            thresh = torch.topk(gf.abs().reshape(-1), k).values[-1]
            sent = gf * (gf.abs() >= thresh)
            e.copy_(gf - sent)
            return sent.to(g.dtype)

        return tree_map(tk, grads, comp_state.error), comp_state
    raise ValueError(method)
