"""Parameter / optimizer-state / cache partition rules for the (pod, data,
model) mesh: the port of ``repro``'s ``models/lm/sharding.py``, rule for
rule, over the port's parameter tree (:func:`model.param_shapes`, the
reference's names and stacked ``[L, ...]`` leaves).

Strategy: FSDP shards parameter d_model/d_ff rows over ``data``; TP
shards heads / ff-columns / experts over ``model``; the batch is
data-parallel over (pod, data); pods replicate parameters.  Decode caches
shard batch over dp and sequence over ``model`` (sequence-parallel
attention).  The specs are :class:`configs.common.Spec` trees; the
dry-run sanitizes them against the shapes (``sanitize_spec``) and lays
them out as DTensor placements.
"""
from __future__ import annotations

from typing import Any

from repro_torch.configs.common import Spec, axis_names, mesh_shape
from repro_torch.train.optim import AdafactorState, AdamWState

from .config import LMConfig
from .model import _layer_split, param_shapes

P = Spec


def dp_axes(mesh) -> Any:
    return ("pod", "data") if "pod" in axis_names(mesh) else "data"


def _leaf_rule(path: tuple[str, ...], ndim: int) -> Spec:
    name = path[-1]
    stacked = any(s in ("dense_blocks", "moe_blocks") for s in path)
    inner_moe = "mlp" in path and any("moe" in s for s in path) \
        and "shared" not in path

    def spec(*dims):
        return P(*((None,) + dims if stacked else dims))

    if name in ("ln1", "ln2", "ln_f", "ln", "q_norm", "kv_norm", "b"):
        return spec(None)
    if name == "embed":
        return P("model", "data")
    if name == "lm_head":
        return P("data", "model")
    if name in ("w_q", "w_k", "w_v"):
        return spec("data", "model", None)
    if name in ("b_q", "b_k", "b_v"):
        return spec("model", None)
    if name == "w_o":
        return spec("model", None, "data")
    if name in ("w_dq", "w_dkv"):
        return spec("data", None)
    if name in ("w_uq", "w_uk", "w_uv"):
        return spec(None, "model", None)
    if name == "router":
        return spec("data", None)
    if name in ("w_gate", "w_up", "w_in"):
        if inner_moe and ndim - (1 if stacked else 0) == 3:  # [E, D, F]
            return spec("model", "data", None)
        return spec("data", "model")
    if name in ("w_down", "w_out"):
        if inner_moe and ndim - (1 if stacked else 0) == 3:  # [E, F, D]
            return spec("model", None, "data")
        return spec("model", "data")
    if name == "proj":  # mtp
        return spec("data", None)
    if name == "eps":
        return spec()
    # fallback: replicate
    return P(*(None,) * ndim)


def _map_with_path(fn, tree, path=()):
    """``fn(path, leaf)`` over a nested-dict parameter tree."""
    if isinstance(tree, dict):
        return {k: _map_with_path(fn, v, path + (k,)) for k, v in tree.items()}
    return fn(path, tree)


def param_specs(cfg: LMConfig):
    """Spec tree matching ``param_shapes(cfg)``.

    serving_shardings (decode): there is no optimizer state, so FSDP's
    per-step parameter all-gather over `data` is pure waste.  Non-expert
    params shard over `model` only (replicated over data); MoE experts go
    fully expert-parallel over (data x model) so weights stay put and only
    activations move."""

    def rule(names, leaf):
        ndim = len(leaf[0])
        spec = _leaf_rule(names, ndim)
        if cfg.serving_shardings:
            ent = list(tuple(spec))
            inner_moe = "mlp" in names and any("moe" in s for s in names) \
                and "shared" not in names
            expert_mat = (inner_moe and names[-1] in
                          ("w_gate", "w_up", "w_in", "w_down", "w_out")
                          and ndim >= 3)
            if expert_mat:
                # stacked [L, E, ., .]: expert dim over (data, model)
                ent = [None] * ndim
                ent[1 if ndim == 4 else 0] = ("data", "model")
                return P(*ent)
            return P(*[None if e == "data"
                       else (tuple(a for a in e if a != "data") or None)
                       if isinstance(e, tuple) else e
                       for e in ent])
        return spec

    return _map_with_path(rule, param_shapes(cfg))


def opt_state_specs(params_spec, opt_name: str, params_abstract):
    """Specs for the optimizer state (``repro_torch.train.optim``'s
    ``AdamWState`` / ``AdafactorState``) mirroring the param layout;
    ``params_abstract`` is ``param_shapes``' tree."""
    if opt_name == "adamw":
        return AdamWState(step=P(), mu=params_spec,
                          nu=_map_with_path(lambda _, s: s, params_spec))

    def vr_spec(s, p):
        return P(*s[:-1]) if len(p[0]) >= 2 else s

    def vc_spec(s, p):
        return P(*(s[:-2] + (s[-1],))) if len(p[0]) >= 2 else P(None)

    def zip_map(fn, specs, shapes):
        if isinstance(specs, dict):
            return {k: zip_map(fn, specs[k], shapes[k]) for k in specs}
        return fn(specs, shapes)

    return AdafactorState(step=P(),
                          vr=zip_map(vr_spec, params_spec, params_abstract),
                          vc=zip_map(vc_spec, params_spec, params_abstract))


def cache_specs(cfg: LMConfig, batch: int, mesh):
    """Decode-cache specs ``{stack: (k, v, pos)}``: batch over dp when
    divisible, sequence over model (sequence-parallel attention); small
    batches shard sequence over all axes.  ``mesh`` is a ``DeviceMesh`` or
    any object with ``shape`` and ``axis_names``."""
    dp = dp_axes(mesh)
    shape = mesh_shape(mesh)
    multi = "pod" in axis_names(mesh)
    dp_size = shape["pod"] * shape["data"] if multi else shape["data"]
    if batch % dp_size == 0 and batch >= dp_size:
        b_ax, s_ax = dp, "model"
    else:
        b_ax, s_ax = None, (("pod", "data", "model") if multi
                            else ("data", "model"))
    if cfg.attention == "mla" and cfg.cache_latent_tp:
        kv = (P(None, b_ax, None, "model"), P(None, b_ax, None, None), P())
    elif cfg.attention == "mla":
        kv = (P(None, b_ax, s_ax, None), P(None, b_ax, s_ax, None), P())
    else:
        kv = (P(None, b_ax, s_ax, None, None),
              P(None, b_ax, s_ax, None, None), P())
    n_dense, n_moe = _layer_split(cfg)
    out = {}
    if n_dense:
        out["dense_blocks"] = kv
    if n_moe:
        out["moe_blocks"] = kv
    return out
