"""Plain PyTorch version of causal grouped-query attention: the oracle of
the CUDA kernel, computed as ``repro``'s kernel oracle computes it --
grouped scores, an fp32 softmax under the causal mask, the probabilities
cast to q's dtype, then P.V -- and the query-chunked form of it that the
kernel's backward differentiates."""
import math

import torch


def causal_rows(q, k, v, lo: int = 0):
    """Query positions ``lo .. lo + Sq - 1`` of causal attention: q
    ``[B,Sq,H,Dh]`` against the keys they may read, k/v ``[B,lo+Sq,Hkv,
    Dh]`` -> ``[B,Sq,H,Dh]``.  Query ``lo + i`` attends keys ``<= lo + i``
    (the keys past a chunk's last query would add exact zeros)."""
    B, Sq, H, Dh = q.shape
    Skv, Hkv = k.shape[1], k.shape[2]
    qg = q.reshape(B, Sq, Hkv, H // Hkv, Dh)
    scores = torch.einsum("bqhrd,bkhd->bhrqk", qg, k).float() / math.sqrt(Dh)
    mask = torch.ones((Sq, Skv), dtype=torch.bool,
                      device=q.device).tril(diagonal=lo)
    scores = scores.masked_fill(~mask, -1e30)
    p = torch.softmax(scores, dim=-1).to(q.dtype)
    ctx = torch.einsum("bhrqk,bkhd->bqhrd", p, v)
    return ctx.reshape(B, Sq, H, v.shape[-1])


def flash_attention_ref(q, k, v):
    """q ``[B,S,H,Dh]``; k/v ``[B,S,Hkv,Dh]`` -> ``[B,S,H,Dh]``, causal."""
    return causal_rows(q, k, v)


def attention_grads(q, k, v, grad_out, chunk: int):
    """The gradients (dq, dk, dv) of ``flash_attention_ref(q, k, v)``
    against ``grad_out``: autograd of :func:`causal_rows`, ``chunk``
    queries at a time (the reference's training attention is the same
    function over query chunks under ``jax.checkpoint``, model.py:228-282),
    so at most one chunk's ``[chunk, S]`` scores exist at once.  dk and dv
    sum the chunks' parts in fp32 and are rounded once to k's dtype."""
    S = q.shape[1]
    dq = torch.empty_like(q)
    dk = torch.zeros(k.shape, dtype=torch.float32, device=k.device)
    dv = torch.zeros(v.shape, dtype=torch.float32, device=v.device)
    for lo in range(0, S, chunk):
        hi = min(lo + chunk, S)
        with torch.enable_grad():
            qc, kc, vc = (t.detach().requires_grad_()
                          for t in (q[:, lo:hi], k[:, :hi], v[:, :hi]))
            gq, gk, gv = torch.autograd.grad(causal_rows(qc, kc, vc, lo),
                                             (qc, kc, vc), grad_out[:, lo:hi])
        dq[:, lo:hi] = gq
        dk[:, :hi] += gk
        dv[:, :hi] += gv
    return dq, dk.to(k.dtype), dv.to(v.dtype)
