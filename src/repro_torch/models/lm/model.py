"""Transformer LM in PyTorch: ``repro``'s ``models/lm/model.py`` -- GQA
and MLA attention, dense and MoE FFNs, KV-cache decode and the
multi-token-prediction head, for serving and for training.

Layouts are the reference's at every public function: activations
``[B, S, D]``, q/k/v ``[B, S, H, Dh]``, weights ``w_q [D, H, Dh]``,
``w_o [H, Dh, D]``, layer parameters stacked on a leading ``[L]`` axis
under ``params["dense_blocks"]`` and ``params["moe_blocks"]`` (the first
``moe.first_k_dense`` layers dense, the rest MoE), and KV caches
``{stack: (k, v, pos)}``: GQA ``k``/``v [L, B, Smax, Hkv, Dh]``, MLA the
latent ``c_kv [L, B, Smax, r]`` and the rotary key ``k_pe [L, B, Smax,
dr]``.  The layers run as a Python loop over each stack (the reference's
``lax.scan``).  With grad mode on, each layer of the stacks runs under
``torch.utils.checkpoint`` as ``cfg.remat_policy`` says (the reference's
``_remat_wrap``); the serving steps run under ``torch.no_grad()``.

Prefill attention: GQA runs through the hand-written ``flash_attention``
kernel on a card (its plain version on the CPU), and its gradient through
the wrapper's ``FlashAttentionFn``.  MLA's q/k head dim
(``dn + dr``, 192 at deepseek-v3) differs from its v head dim (128),
which neither the TPU kernel nor ``flash_attention`` takes; the reference
computes it outside any kernel, and so does the port, in
:func:`chunked_attention`.  Decode attends the new queries against the
whole cache in plain PyTorch, as the reference does: MLA in the absorbed
form, in latent space.  Decode writes the new cache entries in place (the
reference returns updated copies), so a cache is not reused after a step.
The cache position is a Python int.

MoE layers dispatch by index (:func:`moe_ffn`): each kept assignment's
row is copied into its expert's slot of an ``[E, B*C, D]`` buffer, the
experts run as batched matrix products, and each token gathers its
experts' rows back.  :func:`moe_ffn_ref` is the reference's one-hot
formulation, kept for the tests and the card's check.
"""
from __future__ import annotations

import functools
import math
from typing import NamedTuple

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import (CheckpointPolicy, checkpoint,
                                    create_selective_checkpoint_contexts)

from repro_torch.kernels.flash_attention import flash_attention

from .config import LMConfig

Params = dict
NEG = -1e30
DRAW_CHUNK = 1 << 26   # elements drawn in fp32 at a time by init_params


# ---------------------------------------------------------------------------
# activation-sharding context: the dry-run's cell builders set it, and the
# model then runs on DTensors: the batch pinned after the embedding gather
# (the reference's constraint point), the residual stream's partial sums
# reduced, and the paths DTensor cannot shard as they are run per shard
# (``sharded.py``).  Without it (every run on real tensors) each of these
# points is a no-op.
# ---------------------------------------------------------------------------
_ACT_SHARDING: list = [None]  # (mesh, dp_axes) | None


class activation_sharding:
    """Inside, :func:`forward` runs on ``DTensor`` s of ``mesh``:
    activations are redistributed at the reference's constraint points
    (``with_sharding_constraint`` there), and the paths that DTensor
    cannot shard as they are run per shard (``sharded.py``).
    ``dp_axes``: the batch's mesh axes, ``"data"`` or ``("pod",
    "data")``."""

    def __init__(self, mesh, dp_axes):
        self.ctx = (mesh, dp_axes)

    def __enter__(self):
        _ACT_SHARDING[0] = self.ctx

    def __exit__(self, *exc):
        _ACT_SHARDING[0] = None


def _sharded(x) -> bool:
    """A mesh is set and ``x`` is a ``DTensor`` on it."""
    if _ACT_SHARDING[0] is None:
        return False
    from torch.distributed.tensor import DTensor
    return isinstance(x, DTensor)


def _reduced(x: torch.Tensor) -> torch.Tensor:
    """The residual stream with its partial sums reduced, on ``DTensor`` s
    (``sharded.reduced``); ``x`` itself otherwise."""
    if not _sharded(x):
        return x
    from . import sharded
    return sharded.reduced(x)


def _wsc_batch(x: torch.Tensor) -> torch.Tensor:
    """Constrain dim 0 (batch) to the dp axes if divisible (on
    ``DTensor`` s; ``x`` itself otherwise)."""
    if not _sharded(x):
        return x
    from . import sharded
    return sharded.batch(x)


def _embed(table: torch.Tensor, tokens: torch.Tensor) -> torch.Tensor:
    """``table[tokens]`` (``sharded.embed`` on ``DTensor`` s)."""
    if not _sharded(table):
        return table[tokens]
    from . import sharded
    return sharded.embed(table, tokens)


def _proj_out(ctx: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``einsum("bshk,hkd->bsd", ctx, w)`` as one matrix product (on
    ``DTensor`` s ``w`` laid out by ``sharded.flat_weight`` and the
    flattened ctx's gradient by ``sharded.grad_like``)."""
    B, S = ctx.shape[:2]
    flat = ctx.reshape(B, S, -1)
    if _sharded(w):
        from . import sharded
        flat = sharded.grad_like(flat)
        w = sharded.flat_weight(w, 2)
    return flat @ w.reshape(-1, w.shape[-1])


def _dtype(cfg: LMConfig) -> torch.dtype:
    return getattr(torch, cfg.param_dtype)


def _cdtype(cfg: LMConfig) -> torch.dtype:
    return getattr(torch, cfg.compute_dtype)


def _check_dtypes(cfg: LMConfig) -> None:
    if cfg.param_dtype != cfg.compute_dtype:
        raise ValueError(f"param_dtype {cfg.param_dtype} and compute_dtype "
                         f"{cfg.compute_dtype} differ; the port runs one "
                         f"dtype throughout")


def _layer_split(cfg: LMConfig) -> tuple[int, int]:
    """(# dense layers, # MoE layers)."""
    if cfg.moe is None:
        return cfg.n_layers, 0
    k = cfg.moe.first_k_dense
    return k, cfg.n_layers - k


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
def _tree(cfg: LMConfig, leaf) -> Params:
    """The reference's parameter tree (``init_params``), each leaf made by
    ``leaf(shape, init, dtype)``: ``init`` is the scale of an N(0, 1)
    matrix, or ``"ones"`` / ``"zeros"``.  A matrix's scale is the
    reference's: 1/sqrt of its first per-layer dimension unless given
    (so an expert stack ``[E, D, F]`` is drawn at 1/sqrt(E)).  The MoE
    router is fp32 whatever ``cfg.param_dtype`` is."""
    dt = _dtype(cfg)
    D, H, Hkv, Dh = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim

    def mat(lead, *shape, scale=None, dtype=dt):
        return leaf(lead + shape, scale or shape[0] ** -0.5, dtype)

    def ones(lead, d):
        return leaf(lead + (d,), "ones", dt)

    def attn(lead):
        if cfg.attention == "mla":
            m = cfg.mla
            return {
                "w_dq": mat(lead, D, m.q_lora_rank),
                "q_norm": ones(lead, m.q_lora_rank),
                "w_uq": mat(lead, m.q_lora_rank, H,
                            m.qk_nope_head_dim + m.qk_rope_head_dim),
                "w_dkv": mat(lead, D, m.kv_lora_rank + m.qk_rope_head_dim),
                "kv_norm": ones(lead, m.kv_lora_rank),
                "w_uk": mat(lead, m.kv_lora_rank, H, m.qk_nope_head_dim),
                "w_uv": mat(lead, m.kv_lora_rank, H, m.v_head_dim),
                "w_o": mat(lead, H, m.v_head_dim, D, scale=D ** -0.5)}
        p = {"w_q": mat(lead, D, H, Dh), "w_k": mat(lead, D, Hkv, Dh),
             "w_v": mat(lead, D, Hkv, Dh),
             "w_o": mat(lead, H, Dh, D, scale=D ** -0.5)}
        if cfg.qkv_bias:
            p.update(b_q=leaf(lead + (H, Dh), "zeros", dt),
                     b_k=leaf(lead + (Hkv, Dh), "zeros", dt),
                     b_v=leaf(lead + (Hkv, Dh), "zeros", dt))
        return p

    def ffn(lead, d_ff, *experts):
        if cfg.activation == "swiglu":
            return {"w_gate": mat(lead, *experts, D, d_ff),
                    "w_up": mat(lead, *experts, D, d_ff),
                    "w_down": mat(lead, *experts, d_ff, D)}
        return {"w_in": mat(lead, *experts, D, d_ff),
                "w_out": mat(lead, *experts, d_ff, D)}

    def moe(lead):
        m = cfg.moe
        p = {"router": mat(lead, D, m.n_experts, dtype=torch.float32),
             **ffn(lead, m.d_ff_expert, m.n_experts)}
        if m.n_shared:
            p["shared"] = ffn(lead, m.d_ff_expert * m.n_shared)
        return p

    def block(lead, is_moe):
        return {"ln1": ones(lead, D), "attn": attn(lead), "ln2": ones(lead, D),
                "mlp": moe(lead) if is_moe else ffn(lead, cfg.d_ff)}

    n_dense, n_moe = _layer_split(cfg)
    params = {"embed": mat((), cfg.vocab, D, scale=1.0),
              "ln_f": ones((), D)}
    if not cfg.tie_embeddings:
        params["lm_head"] = mat((), D, cfg.vocab)
    if n_dense:
        params["dense_blocks"] = block((n_dense,), False)
    if n_moe:
        params["moe_blocks"] = block((n_moe,), True)
    if cfg.mtp_depth:
        params["mtp"] = {"proj": mat((), 2 * D, D), "block": block((), False),
                         "ln": ones((), D)}
    return params


def param_shapes(cfg: LMConfig) -> Params:
    """The parameter tree of ``cfg`` with ``(shape, dtype)`` leaves."""
    _check_dtypes(cfg)
    return _tree(cfg, lambda shape, init, dtype: (shape, dtype))


def init_params(gen: torch.Generator, cfg: LMConfig,
                device="cuda") -> Params:
    """The reference's parameter tree and shapes, drawn from ``gen`` (a
    generator of ``device``): each matrix N(0, 1) times the reference's
    scale (see :func:`_tree`), in ``cfg.param_dtype`` (the router fp32);
    norms 1, biases 0.  Matrices are drawn in fp32 :data:`DRAW_CHUNK`
    elements at a time into the finished tensor, so no fp32 copy of a
    whole expert stack is ever made."""
    _check_dtypes(cfg)
    dev = torch.device(device)

    def leaf(shape, init, dtype):
        if init == "ones":
            return torch.ones(shape, dtype=dtype, device=dev)
        if init == "zeros":
            return torch.zeros(shape, dtype=dtype, device=dev)
        out = torch.empty(shape, dtype=dtype, device=dev)
        flat = out.view(-1)
        for i in range(0, flat.numel(), DRAW_CHUNK):
            n = min(DRAW_CHUNK, flat.numel() - i)
            flat[i:i + n] = torch.randn(n, generator=gen, dtype=torch.float32,
                                        device=dev).mul_(init)
        return out

    return _tree(cfg, leaf)


def _layer(tree, l: int):
    """Layer ``l`` of a stacked parameter tree (views, no copies)."""
    if isinstance(tree, dict):
        return {k: _layer(v, l) for k, v in tree.items()}
    return tree[l]


def _layers(tree, L: int) -> list:
    """Every layer of a stacked parameter tree, each leaf unbound once
    (views, no copies).  Its gradient is one stack of the layers' parts;
    indexing each layer apart makes a whole-stack gradient per layer, and
    the backward's bytes grow as the square of the depth."""
    if isinstance(tree, dict):
        parts = {k: _layers(v, L) for k, v in tree.items()}
        return [{k: v[l] for k, v in parts.items()} for l in range(L)]
    if _sharded(tree):
        from . import sharded
        tree = sharded.unstacked(tree)
    return list(torch.unbind(tree))


# ---------------------------------------------------------------------------
# attention
# ---------------------------------------------------------------------------
def _gqa_scores_ctx(q, k, v, mask, scale):
    """q ``[B,Sq,H,Dh]`` grouped against k/v ``[B,Skv,Hkv,Dh]``; mask
    ``[Sq,Skv]``.  v's head dim may differ from q's (MLA)."""
    B, Sq, H, Dh = q.shape
    Hkv = k.shape[2]
    qg = q.reshape(B, Sq, Hkv, H // Hkv, Dh)
    scores = torch.einsum("bqhrd,bkhd->bhrqk", qg, k).float() * scale
    scores = scores.masked_fill(~mask, NEG)
    p = torch.softmax(scores, dim=-1).to(q.dtype)
    ctx = torch.einsum("bhrqk,bkhd->bqhrd", p, v)
    return ctx.reshape(B, Sq, H, v.shape[-1])


def causal_attention(q, k, v, cfg: LMConfig, q_offset: int = 0):
    """The reference's ``causal_attention`` for GQA: q ``[B,S,H,Dh]``
    against k/v ``[B,S,Hkv,Dh]``, query position i attending kv positions
    <= i, through the ``flash_attention`` kernel.  The kernel never
    materializes the ``[S, S]`` scores; ``cfg.attn_chunk`` (the
    reference's memory bound) is the query chunk of its backward, which
    recomputes the scores.  It takes the square causal
    case, the only one the prefill makes: ``q_offset`` 0 and as many keys
    as queries."""
    if q_offset or k.shape[1] != q.shape[1]:
        raise NotImplementedError(
            f"causal attention with q_offset {q_offset} over {k.shape[1]} "
            f"keys for {q.shape[1]} queries: the prefill attends its own "
            f"positions only")
    return flash_attention(q, k, v, chunk=cfg.attn_chunk)


def chunked_attention(q, k, v, chunk: int):
    """Causal attention in plain PyTorch, ``chunk`` queries at a time, so
    the ``[S, S]`` scores never exist whole: q ``[B,S,H,Dq]``, k ``[B,S,
    Hkv,Dq]``, v ``[B,S,Hkv,Dv]`` -> ``[B,S,H,Dv]``, scaled by 1/sqrt(Dq).
    Query chunk i reads only the keys up to its last position (the masked
    ones would add exact zeros).  This is MLA's prefill attention, whose
    head dims no kernel takes (see the module docstring)."""
    B, S, H, Dq = q.shape
    scale = 1.0 / math.sqrt(Dq)
    pos = torch.arange(S, device=q.device)
    outs = []
    for lo in range(0, S, chunk):
        hi = min(lo + chunk, S)
        mask = pos[None, :hi] <= pos[lo:hi, None]
        outs.append(_gqa_scores_ctx(q[:, lo:hi], k[:, :hi], v[:, :hi], mask,
                                    scale))
    return torch.cat(outs, dim=1)


def _proj(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``einsum("bsd,dhk->bshk", x, w)`` as one matrix product
    (``sharded.project`` on ``DTensor`` s)."""
    if _sharded(w):
        from . import sharded
        return sharded.project(x, w)
    return (x @ w.reshape(w.shape[0], -1)).view(*x.shape[:-1], *w.shape[1:])


def _cache_write(cache: torch.Tensor, pos: int, new: torch.Tensor) -> None:
    """``cache[:, pos:pos + S] = new``, in place (per sequence block on a
    ``DTensor`` cache: ``sharded.cache_write``)."""
    if _sharded(cache):
        from . import sharded
        sharded.cache_write(cache, pos, new)
        return
    cache[:, pos:pos + new.shape[1]] = new


def _cache_slot(cache_len: int, pos: int, S: int) -> None:
    if pos + S > cache_len:
        raise ValueError(f"the cache holds {cache_len} positions; writing "
                         f"{S} at {pos} overruns it")


def gqa_attend(p, cfg: LMConfig, x, positions, *, cache=None,
               attention=None):
    """Returns (out ``[B,S,D]``, new cache k/v).  Without ``cache`` (prefill)
    the causal attention is ``attention`` (default: :func:`causal_attention`,
    the ``flash_attention`` kernel) and the new k/v are this call's; with
    ``cache = (ck, cv, pos)`` (decode) k/v are written into ``ck``/``cv`` at
    ``pos`` in place and the queries attend the whole cache under the mask
    ``key <= pos + i``."""
    B, S, _ = x.shape
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
        _cache_slot(ck.shape[1], pos, S)
        _cache_write(ck, pos, k.to(ck.dtype))
        _cache_write(cv, pos, v.to(cv.dtype))
        if _sharded(ck):
            from . import sharded
            ctx = sharded.gqa_decode(q, ck, cv, pos,
                                     1.0 / math.sqrt(cfg.head_dim))
        else:
            kv_pos = torch.arange(ck.shape[1], device=x.device)
            mask = kv_pos[None, :] <= (pos + torch.arange(
                S, device=x.device))[:, None]
            ctx = _gqa_scores_ctx(q, ck, cv, mask,
                                  1.0 / math.sqrt(cfg.head_dim))
        new_kv = (ck, cv)
    return _proj_out(ctx, p["w_o"]), new_kv


def mla_attend(p, cfg: LMConfig, x, positions, *, cache=None,
               attention=None):
    """Multi-head Latent Attention (deepseek-v3).  Returns (out ``[B,S,D]``,
    the new latent cache entries ``(c_kv [B,S,r], k_pe [B,S,dr])`` or the
    updated caches).

    Prefill expands the latent KV per head and attends through
    ``attention`` (default :func:`chunked_attention` at
    ``cfg.attn_chunk``).  Decode (``cache = (c_kv, k_pe, pos)``, written
    in place at ``pos``) takes the absorbed scores in latent space:
    ``q_nope W_uk`` against ``c_kv`` plus ``q_pe`` against ``k_pe``, and
    the context ``(P c_kv) W_uv``."""
    m = cfg.mla
    B, S, _ = x.shape
    H = cfg.n_heads
    dn, dr, r = m.qk_nope_head_dim, m.qk_rope_head_dim, m.kv_lora_rank
    scale = 1.0 / math.sqrt(dn + dr)

    cq = rms_norm(x @ p["w_dq"], p["q_norm"], cfg.norm_eps)    # [B,S,rq]
    q = _proj(cq, p["w_uq"])                                   # [B,S,H,dn+dr]
    q_nope = q[..., :dn]
    q_pe = apply_rope(q[..., dn:], positions, cfg.rope_theta)

    dkv = x @ p["w_dkv"]                                       # [B,S,r+dr]
    c_kv = rms_norm(dkv[..., :r], p["kv_norm"], cfg.norm_eps)
    k_pe = apply_rope(dkv[..., None, r:], positions, cfg.rope_theta)[:, :, 0]

    if cache is None:
        k_nope = _proj(c_kv, p["w_uk"])
        v = _proj(c_kv, p["w_uv"])
        k_pe_h = k_pe[:, :, None].expand(B, S, H, dr)
        if _sharded(k_nope):
            # the shared rotary key takes the heads' layout (a local slice
            # of a replicated tensor), so the concatenation gathers nothing
            k_pe_h = k_pe_h.redistribute(k_nope.device_mesh,
                                         k_nope.placements)
        k = torch.cat([k_nope, k_pe_h], dim=-1)
        qq = torch.cat([q_nope, q_pe], dim=-1)
        if attention is not None:
            ctx = attention(qq, k, v)
        elif _sharded(qq):
            from repro_torch.kernels.flash_attention.sharding import (
                attention_layout, per_shard)
            ctx = per_shard(functools.partial(chunked_attention,
                                              chunk=cfg.attn_chunk),
                            attention_layout(qq, k, v), 1)
        else:
            ctx = chunked_attention(qq, k, v, cfg.attn_chunk)
        new_kv = (c_kv, k_pe)   # the compressed cache entries
    else:
        cc, cpe, pos = cache    # cc [B,Smax,r], cpe [B,Smax,dr]
        pos = int(pos)
        _cache_slot(cc.shape[1], pos, S)
        _cache_write(cc, pos, c_kv.to(cc.dtype))
        _cache_write(cpe, pos, k_pe.to(cpe.dtype))
        q_abs = torch.einsum("bshk,rhk->bshr", q_nope, p["w_uk"])
        if _sharded(cc):
            from . import sharded
            ctx_lat = sharded.mla_decode(q_abs, q_pe, cc, cpe, pos, scale)
        else:
            s_lat = torch.einsum("bshr,btr->bhst", q_abs, cc)
            s_pe = torch.einsum("bshk,btk->bhst", q_pe, cpe)
            scores = (s_lat + s_pe).float() * scale
            kv_pos = torch.arange(cc.shape[1], device=x.device)
            mask = kv_pos[None, :] <= (pos + torch.arange(
                S, device=x.device))[:, None]
            pr = torch.softmax(scores.masked_fill(~mask, NEG),
                               dim=-1).to(x.dtype)
            ctx_lat = torch.einsum("bhst,btr->bshr", pr, cc)
        ctx = torch.einsum("bshr,rhk->bshk", ctx_lat, p["w_uv"])
        new_kv = (cc, cpe)
    return _proj_out(ctx, p["w_o"]), new_kv


# ---------------------------------------------------------------------------
# FFN / MoE
# ---------------------------------------------------------------------------
def dense_ffn(p, cfg: LMConfig, x):
    if cfg.activation == "swiglu":
        return _act("swiglu", x @ p["w_up"], x @ p["w_gate"]) @ p["w_down"]
    return _act(cfg.activation, x @ p["w_in"]) @ p["w_out"]


def capacity(cfg: LMConfig, S: int) -> int:
    """The reference's expert capacity of one sequence of ``S`` tokens."""
    m = cfg.moe
    C = int(math.ceil(S * m.top_k / m.n_experts * m.capacity_factor / 4.0)
            * 4)
    return min(C, S)


class Routing(NamedTuple):
    """One MoE layer's routing of ``x [B,S,D]``."""

    probs: torch.Tensor    # [B,S,E] fp32 router softmax
    gate: torch.Tensor     # [B,S,K] fp32, renormalized over the K
    expert: torch.Tensor   # [B,S,K] int64, best first (ties: lower index)
    pos: torch.Tensor      # [B,S,K] int64 place in its expert's queue
    keep: torch.Tensor     # [B,S,K] bool: pos < capacity (else dropped)
    capacity: int


def _router(p, cfg: LMConfig, x):
    """(probs, renormalized top-k gates, experts).  Top-k by a stable
    descending sort, so ties go to the lower expert index, as
    ``lax.top_k``'s."""
    probs = torch.softmax(x.float() @ p["router"], dim=-1)     # [B,S,E]
    vals, idx = probs.sort(dim=-1, descending=True, stable=True)
    K = cfg.moe.top_k
    gate, expert = vals[..., :K], idx[..., :K]
    return probs, gate / gate.sum(-1, keepdim=True).clamp(min=1e-9), expert


def place(probs, gate, expert, C: int) -> Routing:
    """The routing of the assignments ``expert [B,S,K]`` at capacity ``C``:
    an assignment's place in its expert counts the same sequence's earlier
    assignments to that expert in the flattened ``(s, k)`` order, and
    places at or past ``C`` are dropped.  The places come from a stable
    sort of the assignments by expert (each one's rank in its expert's
    run)."""
    B, S, K = expert.shape
    flat = expert.reshape(B, S * K)
    sorted_e, order = flat.sort(dim=1, stable=True)
    first = torch.searchsorted(sorted_e, sorted_e)             # run starts
    rank = torch.arange(S * K, device=expert.device) - first
    pos = torch.empty_like(flat).scatter_(1, order, rank).view(B, S, K)
    return Routing(probs, gate, expert, pos, pos < C, C)


def moe_route(p, cfg: LMConfig, x) -> Routing:
    """The reference's routing: top-k of the fp32 router softmax, gates
    renormalized over the K before any drop, placed by :func:`place` at
    the capacity of ``x``'s sequence length."""
    probs, gate, expert = _router(p, cfg, x)
    return place(probs, gate, expert, capacity(cfg, x.shape[1]))


def _aux_loss(cfg: LMConfig, probs, expert) -> torch.Tensor:
    """Switch load-balance loss E * sum_e f_e P_e / K, dropped assignments
    counted in f."""
    m = cfg.moe
    E, K = m.n_experts, m.top_k
    # counted by index_add_ into E slots: bincount sizes its output from
    # the ids' maximum, a readback to the host on a card
    ids = expert.reshape(-1)
    f = torch.zeros(E, dtype=torch.float32, device=ids.device).index_add_(
        0, ids, torch.ones(ids.shape, dtype=torch.float32,
                           device=ids.device)) * (K / expert.numel())
    return E * (f * probs.mean(dim=(0, 1))).sum() / K


def _experts(p, cfg: LMConfig, xe):
    """The expert FFNs on ``xe [E, N, D]`` as batched products."""
    if cfg.activation == "swiglu":
        h = _act("swiglu", torch.bmm(xe, p["w_up"]), torch.bmm(xe, p["w_gate"]))
        return torch.bmm(h, p["w_down"])
    return torch.bmm(_act(cfg.activation, torch.bmm(xe, p["w_in"])),
                     p["w_out"])


def moe_ffn(p, cfg: LMConfig, x, route: Routing | None = None):
    """GShard capacity-based MoE.  x ``[B,S,D]`` -> (y, aux_loss).

    Dispatch by index: the kept assignment (b, s, k) to expert e at place
    c copies row ``x[b, s]`` into row ``(e*B + b)*C + c`` of an
    ``[E*B*C + 1, D]`` buffer (dropped ones into the last, a trash row
    that the experts never read), the experts run on ``[E, B*C, D]``, and
    each token sums its K experts' output rows weighted by the gates (cast
    to x's dtype first, as the reference's combine is; a dropped
    assignment weighs 0).  ``route``: this layer's routing of ``x`` when
    the caller has it (:func:`moe_route`'s, or one :func:`place` made)."""
    if route is None and _sharded(x):
        from . import sharded
        return sharded.moe_ffn(p, cfg, x)
    m = cfg.moe
    B, S, D = x.shape
    E, K = m.n_experts, m.top_k
    r = route if route is not None else moe_route(p, cfg, x)
    C = r.capacity
    n = E * B * C
    b = torch.arange(B, device=x.device)[:, None, None]
    slot = torch.where(r.keep, (r.expert * B + b) * C + r.pos, n).view(-1)
    xe = x.new_zeros((n + 1, D))
    xe.index_copy_(0, slot, x.reshape(B * S, 1, D).expand(B * S, K, D)
                   .reshape(-1, D))
    ye = _experts(p, cfg, xe[:n].view(E, B * C, D)).view(n, D)
    w = torch.where(r.keep, r.gate, 0.0).to(x.dtype)
    # a dropped assignment weighs 0: any finite row may stand in for it
    y = torch.bmm(w.view(B * S, 1, K),
                  ye[slot.clamp(max=n - 1)].view(B * S, K, D))
    y = y.view(B, S, D)
    if m.n_shared:
        y = y + dense_ffn(p["shared"], cfg, x)
    return y, _aux_loss(cfg, r.probs, r.expert)


def moe_ffn_ref(p, cfg: LMConfig, x):
    """The reference's one-hot formulation of :func:`moe_ffn` (the plain
    version, for the tests and the card's check): places by a cumulative
    sum of one-hot assignments, dispatch and combine as ``[B,S,E,C]``
    einsums.  Returns (y, aux_loss, keep ``[B,S,K]``)."""
    m = cfg.moe
    B, S, D = x.shape
    E, K = m.n_experts, m.top_k
    C = capacity(cfg, S)
    probs, gate, idx = _router(p, cfg, x)
    onehot = F.one_hot(idx, E).float()                         # [B,S,K,E]
    flat = onehot.reshape(B, S * K, E)
    pos = ((flat.cumsum(1) - flat) * flat).sum(-1).reshape(B, S, K)
    keep = pos < C
    pos_oh = F.one_hot(pos.long().clamp(max=C), C + 1)[..., :C].float() \
        * keep[..., None]
    dispatch = torch.einsum("bske,bskc->bsec", onehot, pos_oh)
    combine = torch.einsum("bske,bskc,bsk->bsec", onehot, pos_oh, gate)
    xe = torch.einsum("bsec,bsd->ebcd", dispatch.to(x.dtype), x)
    if cfg.activation == "swiglu":
        h = _act("swiglu", torch.einsum("ebcd,edf->ebcf", xe, p["w_up"]),
                 torch.einsum("ebcd,edf->ebcf", xe, p["w_gate"]))
    else:
        h = _act(cfg.activation, torch.einsum("ebcd,edf->ebcf", xe,
                                              p["w_in"]))
    w_down = p["w_down"] if cfg.activation == "swiglu" else p["w_out"]
    ye = torch.einsum("ebcf,efd->ebcd", h, w_down)
    y = torch.einsum("bsec,ebcd->bsd", combine.to(x.dtype), ye)
    f = onehot.mean(dim=(0, 1, 2)) * K
    aux = E * (f * probs.mean(dim=(0, 1))).sum() / K
    if m.n_shared:
        y = y + dense_ffn(p["shared"], cfg, x)
    return y, aux, keep


# ---------------------------------------------------------------------------
# blocks & model
# ---------------------------------------------------------------------------
def block_fn(p, cfg: LMConfig, moe: bool, x, positions, cache=None, *,
             attention=None):
    attend = mla_attend if cfg.attention == "mla" else gqa_attend
    a, new_kv = attend(p["attn"], cfg, rms_norm(x, p["ln1"], cfg.norm_eps),
                       positions, cache=cache, attention=attention)
    x = _reduced(x + a)
    h = rms_norm(x, p["ln2"], cfg.norm_eps)
    if moe:
        f, aux = moe_ffn(p["mlp"], cfg, h)
    else:
        f = dense_ffn(p["mlp"], cfg, h)
        aux = torch.zeros((), dtype=torch.float32, device=x.device)
    return _reduced(x + f), aux, new_kv


STACKS = (("dense_blocks", False), ("moe_blocks", True))
# matrix products without batch dimensions (the projections): what the
# reference's dots_with_no_batch_dims_saveable keeps
_DOTS = (torch.ops.aten.mm.default, torch.ops.aten.addmm.default)


def _save_dots(ctx, op, *args, **kwargs):
    return (CheckpointPolicy.MUST_SAVE if op in _DOTS
            else CheckpointPolicy.PREFER_RECOMPUTE)


def _remat_wrap(cfg: LMConfig, fn):
    """``fn`` under ``torch.utils.checkpoint`` as ``cfg.remat_policy``
    says, the reference's ``_remat_wrap``: ``"nothing"`` saves nothing
    inside ``fn`` (its backward recomputes it whole), ``"dots"`` saves the
    outputs of the matrix products without batch dimensions, ``"full"``
    saves everything (no checkpoint).  Without grad mode, ``fn``."""
    policy = cfg.remat_policy
    if policy not in ("nothing", "dots", "full"):
        raise ValueError(f"remat_policy {policy!r}")
    if policy == "full" or not torch.is_grad_enabled():
        return fn
    # the blocks draw no random numbers: no RNG state to stash
    opts = dict(use_reentrant=False, preserve_rng_state=False)
    if policy == "dots":
        opts["context_fn"] = functools.partial(
            create_selective_checkpoint_contexts, _save_dots)
    return lambda *args: checkpoint(fn, *args, **opts)


def forward(params: Params, cfg: LMConfig, tokens: torch.Tensor, *,
            caches=None, positions=None, attention=None,
            keep_kv: bool = True):
    """tokens ``[B,S]`` -> (hidden ``[B,S,D]``, summed aux loss, new_caches).

    The dense stack runs first, then the MoE stack.  ``caches``: None for
    prefill and training (the new caches are each layer's k/v, or MLA's
    latent entries, stacked on a leading ``[L]``; ``{}`` with ``keep_kv``
    False, as the loss takes it), else the decode caches, updated in
    place.  ``attention`` replaces the prefill attention (the plain
    ``flash_attention_ref`` for a GQA comparison).  With grad mode on,
    each layer without caches runs under :func:`_remat_wrap`."""
    _check_dtypes(cfg)
    B, S = tokens.shape
    x = _wsc_batch(_embed(params["embed"], tokens).to(_cdtype(cfg)))
    if positions is None:
        positions = torch.arange(S, device=tokens.device).expand(B, S)
    aux_total = torch.zeros((), dtype=torch.float32, device=x.device)
    new_caches = {}
    for stack, moe in STACKS:
        if stack not in params:
            continue
        stacked = params[stack]
        L = stacked["ln1"].shape[0]
        if caches is None:
            # partial, not a closure: the remat recompute calls it later
            layer = _remat_wrap(cfg, functools.partial(
                _block_no_cache, cfg=cfg, moe=moe, positions=positions,
                attention=attention))
            ks, vs = [], []
            for p_l in _layers(stacked, L):
                x, aux, (k, v) = layer(p_l, x)
                aux_total = aux_total + aux
                if keep_kv:
                    ks.append(k)
                    vs.append(v)
            if keep_kv:
                new_caches[stack] = (torch.stack(ks), torch.stack(vs))
        else:
            ck, cv, pos = caches[stack]
            for l, p_l in enumerate(_layers(stacked, L)):
                x, aux, _ = block_fn(p_l, cfg, moe, x,
                                     positions, cache=(ck[l], cv[l], pos))
                aux_total = aux_total + aux
            new_caches[stack] = (ck, cv, pos)
    x = rms_norm(x, params["ln_f"], cfg.norm_eps)
    return x, aux_total, new_caches


def _block_no_cache(p, x, *, cfg, moe, positions, attention):
    """:func:`block_fn` without caches, as the layer loop calls it:
    (x, aux, (k, v))."""
    return block_fn(p, cfg, moe, x, positions, attention=attention)


def logits_fn(params: Params, cfg: LMConfig,
              hidden: torch.Tensor) -> torch.Tensor:
    head = params["embed"].T if cfg.tie_embeddings else params["lm_head"]
    return hidden @ head


def mtp_head(params: Params, cfg: LMConfig, hidden, tokens):
    """DeepSeek-V3 depth-1 multi-token prediction: predict t+2 from
    (h_t, emb(token_{t+1})).  hidden ``[B,S,D]`` (``forward``'s), tokens
    ``[B,S]`` -> logits ``[B,S-1,V]``."""
    p = params["mtp"]
    # pinned like forward's gather: DTensor propagates layouts forward
    # only, and the table's would replicate the batch (the reference's
    # partitioner takes it from ``hidden`` through the concatenation)
    emb_next = _wsc_batch(_embed(params["embed"], tokens[:, 1:])
                          .to(hidden.dtype))
    h = torch.cat([hidden[:, :-1], emb_next], dim=-1) @ p["proj"]
    B, Sm1, _ = h.shape
    pos = torch.arange(Sm1, device=h.device).expand(B, Sm1)
    h, _, _ = block_fn(p["block"], cfg, False, h, pos)
    h = rms_norm(h, p["ln"], cfg.norm_eps)
    return logits_fn(params, cfg, h)   # predicts tokens[:, 2:] shifted


# ---------------------------------------------------------------------------
# KV cache plumbing
# ---------------------------------------------------------------------------
def init_cache(cfg: LMConfig, batch: int, max_seq: int, dtype=None,
               device="cuda") -> dict:
    """Empty decode caches of each stack, at position 0."""
    _check_dtypes(cfg)
    dt = dtype or _dtype(cfg)
    caches = {}
    for (name, _), L in zip(STACKS, _layer_split(cfg)):
        if L == 0:
            continue
        if cfg.attention == "mla":
            m = cfg.mla
            k = torch.zeros((L, batch, max_seq, m.kv_lora_rank), dtype=dt,
                            device=device)
            v = torch.zeros((L, batch, max_seq, m.qk_rope_head_dim),
                            dtype=dt, device=device)
        else:
            k = torch.zeros((L, batch, max_seq, cfg.n_kv_heads,
                             cfg.head_dim), dtype=dt, device=device)
            v = torch.zeros_like(k)
        caches[name] = (k, v, 0)
    return caches


def set_cache_pos(caches: dict, pos) -> dict:
    return {name: (c[0], c[1], int(pos)) for name, c in caches.items()}
