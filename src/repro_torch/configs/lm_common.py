"""Shared cell builders for the five LM architectures: the port of
``repro``'s ``configs/lm_common.py``.

Shapes (assigned): train_4k (seq 4096, gbs 256, train_step);
prefill_32k (seq 32768, gbs 32); decode_32k (one token, KV cache 32768,
gbs 128); long_500k (one token, KV cache 524288, gbs 1 -- decode is O(S)
per token, so it runs for full-attention archs too).

A cell's function is the port's own step (``make_train_step``,
``make_prefill_step``, ``make_decode_step``) under the activation
context; its arguments are shape-and-dtype stand-ins with the sharding
rules' specs.  The port's layers are a Python loop, so the dry-run traces
each cell at full depth and needs no probes.
"""
from __future__ import annotations

import math

import torch

from repro_torch.models.lm.config import LMConfig
from repro_torch.models.lm.model import (_layer_split, activation_sharding,
                                         param_shapes)
from repro_torch.models.lm.sharding import (cache_specs, dp_axes,
                                            opt_state_specs, param_specs)
from repro_torch.models.lm.steps import (make_decode_step, make_prefill_step,
                                         make_train_step)
from repro_torch.train.optim import AdafactorState, AdamWState

from .common import Built, Cell, Spec, sds

SHAPES = {
    "train_4k": dict(seq=4096, batch=256, kind="train"),
    "prefill_32k": dict(seq=32768, batch=32, kind="prefill"),
    "decode_32k": dict(seq=32768, batch=128, kind="decode"),
    "long_500k": dict(seq=524288, batch=1, kind="decode"),
}
TOKENS = torch.int64     # the reference's tokens are int32


def _leaves(tree, path=()):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaves(v, path + (k,))
    else:
        yield path, tree


def n_params(cfg: LMConfig) -> tuple[float, float]:
    """(total, active) parameter counts, from ``param_shapes`` (nothing is
    allocated)."""
    total = 0
    dead = 0.0
    for path, (shape, _) in _leaves(param_shapes(cfg)):
        size = math.prod(shape)
        total += size
        if cfg.moe is not None and path[0] == "moe_blocks" \
                and path[1] == "mlp" and len(shape) == 4 and path[-1] in (
                    "w_gate", "w_up", "w_in", "w_down", "w_out"):
            dead += size * (1.0 - cfg.moe.top_k / cfg.moe.n_experts)
    return float(total), float(total - dead)


def model_flops(cfg: LMConfig, tokens: float, kind: str) -> float:
    """6ND train / 2ND forward (N = active params)."""
    total, active = n_params(cfg)
    coef = 6.0 if kind == "train" else 2.0
    return coef * active * tokens


def _layers(cfg: LMConfig) -> tuple[int, int]:
    if cfg.moe is None:
        return cfg.n_layers, 0
    return cfg.moe.first_k_dense, cfg.n_layers - cfg.moe.first_k_dense


def _params_abstract(cfg: LMConfig):
    def conv(tree):
        if isinstance(tree, dict):
            return {k: conv(v) for k, v in tree.items()}
        return sds(*tree)
    return conv(param_shapes(cfg))


def _opt_abstract(cfg: LMConfig, params_a):
    """The optimizer state's stand-ins, as ``adamw_init`` /
    ``adafactor_init`` make them: fp32 moments, an int32 step."""
    def walk(fn, tree):
        if isinstance(tree, dict):
            return {k: walk(fn, v) for k, v in tree.items()}
        return fn(tree)

    step = sds((), torch.int32)
    if cfg.optimizer == "adamw":
        def f32(p):
            return sds(p.shape, torch.float32)
        return AdamWState(step=step, mu=walk(f32, params_a),
                          nu=walk(f32, params_a))

    def rows(p):
        return sds(p.shape[:-1] if len(p.shape) >= 2 else p.shape,
                   torch.float32)

    def cols(p):
        return sds(p.shape[:-2] + p.shape[-1:] if len(p.shape) >= 2
                   else (1,), torch.float32)

    return AdafactorState(step=step, vr=walk(rows, params_a),
                          vc=walk(cols, params_a))


def _cache_abstract(cfg: LMConfig, batch: int, seq: int, pos: int):
    """``init_cache``'s stand-ins ``{stack: (k, v, pos)}``."""
    dt = getattr(torch, cfg.param_dtype)
    out = {}
    for name, L in zip(("dense_blocks", "moe_blocks"), _layer_split(cfg)):
        if L == 0:
            continue
        if cfg.attention == "mla":
            m = cfg.mla
            k = sds((L, batch, seq, m.kv_lora_rank), dt)
            v = sds((L, batch, seq, m.qk_rope_head_dim), dt)
        else:
            k = v = sds((L, batch, seq, cfg.n_kv_heads, cfg.head_dim), dt)
        out[name] = (k, v, pos)
    return out


def _mk_builder(cfg: LMConfig, shape_kind: str, seq: int, batch: int):
    """Returns builder(mesh) -> Built for one (cfg, kind) cell (no probes:
    the reference's ``with_probes`` has no counterpart)."""

    def builder(mesh):
        dp = dp_axes(mesh)
        params_a = _params_abstract(cfg)
        p_spec = param_specs(cfg)
        if shape_kind == "train":
            opt_a = _opt_abstract(cfg, params_a)
            o_spec = opt_state_specs(p_spec, cfg.optimizer,
                                     param_shapes(cfg))
            step = make_train_step(cfg)
            args = (params_a, opt_a, sds((batch, seq), TOKENS))
            in_sh = (p_spec, o_spec, Spec(dp, None))
        elif shape_kind == "prefill":
            step = make_prefill_step(cfg, max_seq=seq)
            args = (params_a, sds((batch, seq), TOKENS))
            in_sh = (p_spec, Spec(dp, None))
        else:
            # one token at the cache's last position
            step = make_decode_step(cfg)
            args = (params_a, _cache_abstract(cfg, batch, seq, seq - 1),
                    sds((batch,), TOKENS), seq - 1)
            in_sh = (p_spec, cache_specs(cfg, batch, mesh), Spec(None),
                     Spec())

        def fn(*a):
            with activation_sharding(mesh, dp):
                return step(*a)

        n_tok = batch * seq if shape_kind in ("train", "prefill") else batch
        kind = "train" if shape_kind == "train" else "serve"
        return Built(fn=fn, args=args, in_shardings=in_sh,
                     model_flops=model_flops(cfg, n_tok, kind))

    return builder


def lm_cells(arch: str, cfg: LMConfig) -> list[Cell]:
    cells = []
    for shape, s in SHAPES.items():
        b = _mk_builder(cfg, s["kind"], s["seq"], s["batch"])
        cells.append(Cell(arch=arch, shape=shape, kind=s["kind"], builder=b))
    return cells
