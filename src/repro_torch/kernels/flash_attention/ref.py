"""Plain PyTorch version of causal grouped-query attention: the oracle of
the CUDA kernel, computed as ``repro``'s kernel oracle computes it --
grouped scores, an fp32 softmax under the causal mask, the probabilities
cast to q's dtype, then P.V."""
import math

import torch


def flash_attention_ref(q, k, v):
    """q ``[B,S,H,Dh]``; k/v ``[B,S,Hkv,Dh]`` -> ``[B,S,H,Dh]``, causal."""
    B, S, H, Dh = q.shape
    Hkv = k.shape[2]
    qg = q.reshape(B, S, Hkv, H // Hkv, Dh)
    scores = torch.einsum("bqhrd,bkhd->bhrqk", qg, k).float() / math.sqrt(Dh)
    mask = torch.ones((S, S), dtype=torch.bool, device=q.device).tril()
    scores = scores.masked_fill(~mask, -1e30)
    p = torch.softmax(scores, dim=-1).to(q.dtype)
    ctx = torch.einsum("bhrqk,bkhd->bqhrd", p, v)
    return ctx.reshape(B, S, H, Dh)
