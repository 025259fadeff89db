"""Prefill and decode steps for the LM architectures, with the reference's
signatures and outputs (``repro``'s ``models/lm/steps.py``; its train step
is not ported)."""
from __future__ import annotations

import torch
import torch.nn.functional as F

from .config import LMConfig
from .model import forward, logits_fn, set_cache_pos


def make_prefill_step(cfg: LMConfig, max_seq: int | None = None, *,
                      attention=None):
    """tokens ``[B,S]`` -> (last-position logits ``[B,1,V]``, caches filled
    to S and zero-padded to ``max_seq``).  ``attention`` replaces the
    prefill attention kernel (see :func:`model.forward`)."""

    def prefill(params, tokens):
        B, S = tokens.shape
        hidden, _, kvs = forward(params, cfg, tokens, attention=attention)
        logits = logits_fn(params, cfg, hidden[:, -1:])
        smax = max_seq or S
        caches = {}
        for stack, (k, v) in kvs.items():  # k/v [L,B,S,...]
            pad = (0, 0) * (k.dim() - 3) + (0, smax - S)
            caches[stack] = (F.pad(k, pad), F.pad(v, pad), S)
        return logits, caches

    return prefill


def make_decode_step(cfg: LMConfig):
    """One token for every sequence in the batch, against a KV cache:
    (params, caches, last_tokens ``[B]``, pos) -> (logits ``[B,V]``,
    caches advanced to ``pos + 1``).  The cache tensors are updated in
    place."""

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
