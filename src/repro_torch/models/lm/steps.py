"""Train, prefill and decode steps for the LM architectures, with the
reference's signatures and outputs (``repro``'s ``models/lm/steps.py``)."""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.ckpt.checkpoint import tree_flatten
from repro_torch.train import (adafactor_init, adamw_init,
                               clip_by_global_norm, compress_grads,
                               make_optimizer, tree_map, value_and_grad)

from . import model as _model
from .config import LMConfig
from .model import forward, logits_fn, mtp_head, set_cache_pos

AUX_COEF = 0.01
MTP_COEF = 0.3


def cross_entropy(logits: torch.Tensor, targets: torch.Tensor) -> torch.Tensor:
    """Mean next-token cross-entropy in fp32 (stable logsumexp).  The gold
    logit is picked with ``gather``: the reference's one-hot contraction
    adds exact zeros to it, so this is the same number without a
    ``[B, S, V]`` one-hot (5 GB at qwen2's vocabulary and 4 x 2048
    tokens).  On ``DTensor`` s whose vocabulary is sharded it is
    ``sharded.cross_entropy``."""
    if _model._sharded(logits):
        from .sharded import cross_entropy as sharded_ce
        out = sharded_ce(logits, targets)
        if out is not None:
            return out
    logits = logits.float()
    lse = torch.logsumexp(logits, dim=-1)
    gold = logits.gather(-1, targets.long()[..., None])[..., 0]
    return torch.mean(lse - gold)


def loss_fn(params, cfg: LMConfig, tokens: torch.Tensor, *, attention=None):
    """(total, {"loss", "aux"}): next-token cross-entropy, plus MTP_COEF
    times the multi-token-prediction loss where the model has the head,
    plus AUX_COEF times the MoE load-balance loss.  ``attention`` replaces
    the GQA attention kernel (see :func:`model.forward`)."""
    hidden, aux, _ = forward(params, cfg, tokens, attention=attention,
                             keep_kv=False)
    logits = logits_fn(params, cfg, hidden)
    loss = cross_entropy(logits[:, :-1], tokens[:, 1:])
    del logits
    if cfg.mtp_depth:
        mtp_logits = mtp_head(params, cfg, hidden, tokens)
        loss = loss + MTP_COEF * cross_entropy(mtp_logits[:, :-1],
                                               tokens[:, 2:])
    total = loss + AUX_COEF * aux
    return total, {"loss": loss, "aux": aux}


def make_train_step(cfg: LMConfig, lr: float = 3e-4):
    """(params, opt_state, tokens ``[B, S]``) -> (params, opt_state,
    metrics): the gradient of :func:`loss_fn` (accumulated in fp32 zeros
    over ``cfg.microbatch`` equal slices of the batch when it is above 1,
    metrics averaged), clipped to global norm 1, compressed as
    ``cfg.grad_compression`` says, then one step of ``cfg.optimizer``.

    The parameter and optimizer-state tensors are updated in place and
    returned, as decode does with its caches: the trees passed in are
    the trees returned.  The metrics (``loss``, ``aux``, ``grad_norm``,
    ``total``) are 0-d tensors on the parameters' device; nothing in the
    step reads them back to the host.  ``"topk"`` compression raises
    (its error-feedback state has no place in this step's signature; the
    reference's step fails there too)."""
    _, update = make_optimizer(cfg.optimizer)
    grad_fn = value_and_grad(loss_fn, has_aux=True)

    def grads_of(params, tokens):
        n = cfg.microbatch
        if n <= 1:
            return grad_fn(params, cfg, tokens)
        # gradient accumulation: activations shrink by the microbatch
        # factor; gradients and metrics are averaged exactly
        B = tokens.shape[0]
        if B % n:
            raise ValueError(f"batch {B} does not split into {n} "
                             f"microbatches")
        acc = tree_map(lambda p: torch.zeros_like(p, dtype=torch.float32),
                       params)
        tot, mets = 0.0, {"loss": 0.0, "aux": 0.0}
        if _model._sharded(tokens):
            from .sharded import microbatches
            parts = microbatches(tokens, n)
        else:
            parts = tokens.reshape(n, B // n, -1)
        for toks in parts:
            (t, m), g = grad_fn(params, cfg, toks)
            for a, gi in zip(tree_flatten(acc), tree_flatten(g)):
                a.add_(gi)
            del g
            tot = tot + t
            mets = {k: mets[k] + m[k] for k in mets}
        return ((tot / n, {k: v / n for k, v in mets.items()}),
                tree_map(lambda a: a.div_(n), acc))

    def train_step(params, opt_state, tokens):
        (total, metrics), grads = grads_of(params, tokens)
        grads, gn = clip_by_global_norm(grads, 1.0)
        if cfg.grad_compression != "none":
            grads, _ = compress_grads(grads, cfg.grad_compression)
        params, opt_state = update(grads, opt_state, params, lr=lr)
        return params, opt_state, dict(metrics, grad_norm=gn, total=total)

    return train_step


def init_opt_state(cfg: LMConfig, params):
    return adamw_init(params) if cfg.optimizer == "adamw" \
        else adafactor_init(params)


def make_prefill_step(cfg: LMConfig, max_seq: int | None = None, *,
                      attention=None):
    """tokens ``[B,S]`` -> (last-position logits ``[B,1,V]``, caches filled
    to S and zero-padded to ``max_seq``), without autograd.  ``attention``
    replaces the prefill attention kernel (see :func:`model.forward`)."""

    @torch.no_grad()
    def prefill(params, tokens):
        B, S = tokens.shape
        hidden, _, kvs = forward(params, cfg, tokens, attention=attention)
        logits = logits_fn(params, cfg, hidden[:, -1:])
        smax = max_seq or S
        caches = {}
        for stack, (k, v) in kvs.items():  # k/v [L,B,S,...]
            if smax > S:
                pad = (0, 0) * (k.dim() - 3) + (0, smax - S)
                k, v = F.pad(k, pad), F.pad(v, pad)
            caches[stack] = (k, v, S)
        return logits, caches

    return prefill


def make_decode_step(cfg: LMConfig):
    """One token for every sequence in the batch, against a KV cache:
    (params, caches, last_tokens ``[B]``, pos) -> (logits ``[B,V]``,
    caches advanced to ``pos + 1``), without autograd.  The cache tensors
    are updated in place."""

    @torch.no_grad()
    def decode(params, caches, last_tokens, pos):
        B = last_tokens.shape[0]
        pos = int(pos)
        positions = torch.full((B, 1), pos, dtype=torch.long,
                               device=last_tokens.device)
        caches = set_cache_pos(caches, pos)
        hidden, _, caches = forward(params, cfg, last_tokens[:, None],
                                    caches=caches, positions=positions)
        logits = logits_fn(params, cfg, hidden[:, -1])
        return logits, set_cache_pos(caches, pos + 1)

    return decode
