"""``value_and_grad`` over the port's parameter trees: JAX's
``jax.value_and_grad`` for the functions of this package, by autograd."""
from __future__ import annotations

import torch

from repro_torch.ckpt.checkpoint import tree_flatten, tree_unflatten


def value_and_grad(fn, has_aux: bool = False):
    """``fn(params, *args, **kwargs)`` -> a scalar (or ``(scalar, aux)``
    with ``has_aux``) becomes ``(params, *args, **kwargs)`` -> (its value,
    the gradient of the scalar against every leaf of ``params``), like
    ``jax.value_and_grad``.  ``fn`` sees detached aliases of the leaves
    that require a gradient, so the caller's tensors keep their flags and
    storage; a leaf the scalar does not reach gets zeros.  Gradients have
    their leaf's dtype (and a ``DTensor`` leaf's layout: a partial sum is
    reduced onto the leaf's shards) and the tree its structure; the
    values come back detached, so no graph outlives the call."""

    def wrapped(params, *args, **kwargs):
        leaves = [p.detach().requires_grad_() for p in tree_flatten(params)]
        with torch.enable_grad():
            out = fn(tree_unflatten(params, leaves), *args, **kwargs)
            value = out[0] if has_aux else out
            grads = torch.autograd.grad(value, leaves, allow_unused=True,
                                        materialize_grads=True)
        grads = [_like(g, p) for g, p in zip(grads, leaves)]
        if has_aux:
            out = (value.detach(), {k: v.detach() for k, v in out[1].items()})
        else:
            out = value.detach()
        return out, tree_unflatten(params, list(grads))

    return wrapped


def _like(g: torch.Tensor, p: torch.Tensor) -> torch.Tensor:
    """``g`` laid out as ``p`` when both are ``DTensor`` s (the gradient of
    a sharded parameter, reduce-scattered onto its shards); else ``g``."""
    placements = getattr(p, "placements", None)
    if placements is None or getattr(g, "placements", placements) \
            == placements:
        return g
    return g.redistribute(p.device_mesh, placements)
