"""Dense-GQA transformer LM in PyTorch: the dense half of ``repro``'s
``models/lm/model.py``, for inference.

Layouts are the reference's at every public function: activations
``[B, S, D]``, q/k/v ``[B, S, H, Dh]``, weights ``w_q [D, H, Dh]``,
``w_o [H, Dh, D]``, layer parameters stacked on a leading ``[L]`` axis
under ``params["dense_blocks"]``, and KV caches ``{stack: (k [L, B, Smax,
Hkv, Dh], v, pos)}``.  The layers run as a Python loop over the stack
(the reference's ``lax.scan``); there is no remat, since nothing here is
differentiated.

Prefill attention runs through the hand-written ``flash_attention``
kernel on a card (its plain version on the CPU); decode attends one query
against the whole cache in plain PyTorch, as the reference does outside
any kernel.  Decode writes the new k/v into the cache tensors in place
(the reference returns updated copies), so a cache is not reused after a
step.  The cache position is a Python int.

MoE, MLA and multi-token prediction are not ported: they raise
``NotImplementedError`` (ROADMAP.md Queue 1, item 5).
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from repro_torch.kernels.flash_attention import flash_attention

from .config import LMConfig

Params = dict
NOT_PORTED = "not ported yet (ROADMAP.md Queue 1, item 5)"
NEG = -1e30


def _dtype(cfg: LMConfig) -> torch.dtype:
    return getattr(torch, cfg.param_dtype)


def _cdtype(cfg: LMConfig) -> torch.dtype:
    return getattr(torch, cfg.compute_dtype)


def _check_dense(cfg: LMConfig) -> None:
    if cfg.attention != "gqa":
        raise NotImplementedError(f"{cfg.attention} attention is {NOT_PORTED}")
    if cfg.moe is not None:
        raise NotImplementedError(f"MoE layers are {NOT_PORTED}")
    if cfg.mtp_depth:
        raise NotImplementedError(f"multi-token prediction is {NOT_PORTED}")
    if cfg.param_dtype != cfg.compute_dtype:
        raise ValueError(f"param_dtype {cfg.param_dtype} and compute_dtype "
                         f"{cfg.compute_dtype} differ; the port runs one "
                         f"dtype throughout")


# ---------------------------------------------------------------------------
# primitives
# ---------------------------------------------------------------------------
def rms_norm(x: torch.Tensor, scale: torch.Tensor, eps: float) -> torch.Tensor:
    xf = x.float()
    var = xf.square().mean(dim=-1, keepdim=True)
    return (xf * torch.rsqrt(var + eps) * scale.float()).to(x.dtype)


def rope_freqs(d: int, theta: float, device=None) -> torch.Tensor:
    return 1.0 / (theta ** (torch.arange(0, d, 2, dtype=torch.float32,
                                         device=device) / d))


def apply_rope(x: torch.Tensor, positions: torch.Tensor,
               theta: float) -> torch.Tensor:
    """Half-rotation RoPE.  x ``[..., S, H, D]``, positions ``[..., S]``."""
    freqs = rope_freqs(x.shape[-1], theta, x.device)             # [D/2]
    ang = positions[..., :, None, None].float() * freqs          # [...,S,1,D/2]
    cos, sin = torch.cos(ang), torch.sin(ang)
    x1, x2 = x.float().chunk(2, dim=-1)
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin],
                     dim=-1).to(x.dtype)


def _act(name: str, x: torch.Tensor,
         gate: torch.Tensor | None = None) -> torch.Tensor:
    if name == "swiglu":
        return F.silu(gate) * x
    if name == "squared_relu":
        return F.relu(x).square()
    if name == "gelu":
        return F.gelu(x, approximate="tanh")   # jax.nn.gelu's default
    raise ValueError(name)


# ---------------------------------------------------------------------------
# parameter init
# ---------------------------------------------------------------------------
def init_params(gen: torch.Generator, cfg: LMConfig,
                device="cuda") -> Params:
    """The reference's parameter tree and shapes, drawn from ``gen`` (a
    generator of ``device``): each matrix N(0, 1) in fp32 times
    1/sqrt(fan-in) (``w_o`` 1/sqrt(D), ``embed`` 1), cast to
    ``cfg.param_dtype``; norms 1, biases 0."""
    _check_dense(cfg)
    dt, dev = _dtype(cfg), torch.device(device)
    D, H, Hkv, Dh = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    L, F_ = cfg.n_layers, cfg.d_ff

    def dense(shape, scale):
        w = torch.randn(shape, generator=gen, dtype=torch.float32,
                        device=dev)
        return w.mul_(scale).to(dt)

    def ones(*shape):
        return torch.ones(shape, dtype=dt, device=dev)

    attn = {"w_q": dense((L, D, H, Dh), D ** -0.5),
            "w_k": dense((L, D, Hkv, Dh), D ** -0.5),
            "w_v": dense((L, D, Hkv, Dh), D ** -0.5),
            "w_o": dense((L, H, Dh, D), D ** -0.5)}
    if cfg.qkv_bias:
        attn.update(b_q=torch.zeros((L, H, Dh), dtype=dt, device=dev),
                    b_k=torch.zeros((L, Hkv, Dh), dtype=dt, device=dev),
                    b_v=torch.zeros((L, Hkv, Dh), dtype=dt, device=dev))
    if cfg.activation == "swiglu":
        mlp = {"w_gate": dense((L, D, F_), D ** -0.5),
               "w_up": dense((L, D, F_), D ** -0.5),
               "w_down": dense((L, F_, D), F_ ** -0.5)}
    else:
        mlp = {"w_in": dense((L, D, F_), D ** -0.5),
               "w_out": dense((L, F_, D), F_ ** -0.5)}
    params = {"embed": dense((cfg.vocab, D), 1.0), "ln_f": ones(D)}
    if not cfg.tie_embeddings:
        params["lm_head"] = dense((D, cfg.vocab), D ** -0.5)
    params["dense_blocks"] = {"ln1": ones(L, D), "attn": attn,
                              "ln2": ones(L, D), "mlp": mlp}
    return params


def _layer(tree, l: int):
    """Layer ``l`` of a stacked parameter tree (views, no copies)."""
    if isinstance(tree, dict):
        return {k: _layer(v, l) for k, v in tree.items()}
    return tree[l]


# ---------------------------------------------------------------------------
# attention
# ---------------------------------------------------------------------------
def _gqa_scores_ctx(q, k, v, mask, scale):
    """q ``[B,Sq,H,Dh]`` grouped against k/v ``[B,Skv,Hkv,Dh]``; mask
    ``[Sq,Skv]``."""
    B, Sq, H, Dh = q.shape
    Hkv = k.shape[2]
    qg = q.reshape(B, Sq, Hkv, H // Hkv, Dh)
    scores = torch.einsum("bqhrd,bkhd->bhrqk", qg, k).float() * scale
    scores = scores.masked_fill(~mask, NEG)
    p = torch.softmax(scores, dim=-1).to(q.dtype)
    ctx = torch.einsum("bhrqk,bkhd->bqhrd", p, v)
    return ctx.reshape(B, Sq, H, v.shape[-1])


def causal_attention(q, k, v, cfg: LMConfig, q_offset: int = 0):
    """The reference's ``causal_attention``: q ``[B,S,H,Dh]`` against k/v
    ``[B,S,Hkv,Dh]``, query position i attending kv positions <= i, through
    the ``flash_attention`` kernel.  The kernel never materializes the
    ``[S, S]`` scores, so ``cfg.attn_chunk`` (the reference's memory bound)
    is not read.  It takes the square causal case, the only one the
    prefill makes: ``q_offset`` 0 and as many keys as queries."""
    if q_offset or k.shape[1] != q.shape[1]:
        raise NotImplementedError(
            f"causal attention with q_offset {q_offset} over {k.shape[1]} "
            f"keys for {q.shape[1]} queries: the prefill attends its own "
            f"positions only")
    return flash_attention(q, k, v)


def _proj(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``einsum("bsd,dhk->bshk", x, w)`` as one matrix product."""
    return (x @ w.reshape(w.shape[0], -1)).view(*x.shape[:-1], *w.shape[1:])


def gqa_attend(p, cfg: LMConfig, x, positions, *, cache=None,
               attention=None):
    """Returns (out ``[B,S,D]``, new cache k/v).  Without ``cache`` (prefill)
    the causal attention is ``attention`` (default: :func:`causal_attention`,
    the ``flash_attention`` kernel) and the new k/v are this call's; with
    ``cache = (ck, cv, pos)`` (decode) k/v are written into ``ck``/``cv`` at
    ``pos`` in place and the queries attend the whole cache under the mask
    ``key <= pos + i``."""
    B, S, D = x.shape
    q, k, v = _proj(x, p["w_q"]), _proj(x, p["w_k"]), _proj(x, p["w_v"])
    if cfg.qkv_bias:
        q, k, v = q + p["b_q"], k + p["b_k"], v + p["b_v"]
    q = apply_rope(q, positions, cfg.rope_theta)
    k = apply_rope(k, positions, cfg.rope_theta)

    if cache is None:
        ctx = (attention(q, k, v) if attention is not None
               else causal_attention(q, k, v, cfg))
        new_kv = (k, v)  # exposed so prefill fills the cache in ONE pass
    else:
        ck, cv, pos = cache  # ck/cv [B,Smax,Hkv,Dh]; pos an int
        pos = int(pos)
        if pos + S > ck.shape[1]:
            raise ValueError(f"the cache holds {ck.shape[1]} positions; "
                             f"writing {S} at {pos} overruns it")
        ck[:, pos:pos + S] = k.to(ck.dtype)
        cv[:, pos:pos + S] = v.to(cv.dtype)
        kv_pos = torch.arange(ck.shape[1], device=x.device)
        mask = kv_pos[None, :] <= (pos + torch.arange(S, device=x.device)
                                   )[:, None]
        ctx = _gqa_scores_ctx(q, ck, cv, mask, 1.0 / math.sqrt(cfg.head_dim))
        new_kv = (ck, cv)
    out = ctx.reshape(B, S, -1) @ p["w_o"].reshape(-1, D)
    return out, new_kv


def mla_attend(p, cfg: LMConfig, x, positions, *, cache=None,
               attention=None):
    raise NotImplementedError(f"MLA attention is {NOT_PORTED}")


# ---------------------------------------------------------------------------
# FFN
# ---------------------------------------------------------------------------
def dense_ffn(p, cfg: LMConfig, x):
    if cfg.activation == "swiglu":
        return _act("swiglu", x @ p["w_up"], x @ p["w_gate"]) @ p["w_down"]
    return _act(cfg.activation, x @ p["w_in"]) @ p["w_out"]


def moe_ffn(p, cfg: LMConfig, x):
    raise NotImplementedError(f"MoE layers are {NOT_PORTED}")


# ---------------------------------------------------------------------------
# blocks & model
# ---------------------------------------------------------------------------
def block_fn(p, cfg: LMConfig, moe: bool, x, positions, cache=None, *,
             attention=None):
    attend = mla_attend if cfg.attention == "mla" else gqa_attend
    a, new_kv = attend(p["attn"], cfg, rms_norm(x, p["ln1"], cfg.norm_eps),
                       positions, cache=cache, attention=attention)
    x = x + a
    h = rms_norm(x, p["ln2"], cfg.norm_eps)
    if moe:
        f, aux = moe_ffn(p["mlp"], cfg, h)
    else:
        f = dense_ffn(p["mlp"], cfg, h)
        aux = torch.zeros((), dtype=torch.float32, device=x.device)
    return x + f, aux, new_kv


@torch.no_grad()
def forward(params: Params, cfg: LMConfig, tokens: torch.Tensor, *,
            caches=None, positions=None, attention=None):
    """tokens ``[B,S]`` -> (hidden ``[B,S,D]``, aux_loss, new_caches).

    ``caches``: None for prefill (the new caches are each layer's k/v,
    stacked ``[L,B,S,Hkv,Dh]``), else the decode caches, updated in place.
    ``attention`` replaces the prefill attention kernel (the plain
    ``flash_attention_ref`` for a comparison)."""
    _check_dense(cfg)
    B, S = tokens.shape
    x = params["embed"][tokens].to(_cdtype(cfg))
    if positions is None:
        positions = torch.arange(S, device=tokens.device).expand(B, S)
    aux_total = torch.zeros((), dtype=torch.float32, device=x.device)
    stacked = params["dense_blocks"]
    L = stacked["ln1"].shape[0]
    if caches is None:
        ks, vs = [], []
        for l in range(L):
            x, aux, (k, v) = block_fn(_layer(stacked, l), cfg, False, x,
                                      positions, attention=attention)
            aux_total = aux_total + aux
            ks.append(k)
            vs.append(v)
        new_caches = {"dense_blocks": (torch.stack(ks), torch.stack(vs))}
    else:
        ck, cv, pos = caches["dense_blocks"]
        for l in range(L):
            x, aux, _ = block_fn(_layer(stacked, l), cfg, False, x,
                                 positions, cache=(ck[l], cv[l], pos))
            aux_total = aux_total + aux
        new_caches = {"dense_blocks": (ck, cv, pos)}
    x = rms_norm(x, params["ln_f"], cfg.norm_eps)
    return x, aux_total, new_caches


@torch.no_grad()
def logits_fn(params: Params, cfg: LMConfig,
              hidden: torch.Tensor) -> torch.Tensor:
    head = params["embed"].T if cfg.tie_embeddings else params["lm_head"]
    return hidden @ head


def mtp_head(params: Params, cfg: LMConfig, hidden, tokens):
    raise NotImplementedError(f"multi-token prediction is {NOT_PORTED}")


# ---------------------------------------------------------------------------
# KV cache plumbing
# ---------------------------------------------------------------------------
def init_cache(cfg: LMConfig, batch: int, max_seq: int, dtype=None,
               device="cuda") -> dict:
    _check_dense(cfg)
    shape = (cfg.n_layers, batch, max_seq, cfg.n_kv_heads, cfg.head_dim)
    k = torch.zeros(shape, dtype=dtype or _dtype(cfg), device=device)
    return {"dense_blocks": (k, torch.zeros_like(k), 0)}


def set_cache_pos(caches: dict, pos) -> dict:
    return {name: (c[0], c[1], int(pos)) for name, c in caches.items()}
