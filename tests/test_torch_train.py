"""The port's training slice (``repro_torch.train``, the LM's ``loss_fn`` and
``make_train_step``, DLRM-RM2's train step, and the gradients of the
``flash_attention`` and ``embedding_bag`` wrappers) against the
reference's on the CPU, on the same seeded NumPy inputs, weights carried
by ``params_from_numpy``.

Bars: the optimizers, clipping and compression 1e-6 (fp32 arithmetic in
the same order; a bf16 parameter within one bf16 ulp, where the fp32
update may round either way); ``loss_fn`` 1e-5 relative and each
gradient leaf 1e-4 relative L2 for the five REDUCED archs in fp32 (the
two packages sum in different orders); parameters after one and three
steps at lr 1e-3 within rtol 1e-5 and atol 5e-5, 5% of one step (AdamW
divides each gradient by its own RMS, so an element whose gradient sits
at the summation-order noise, as a key bias's nearly does, moves by about
lr in both packages but not by the same amount); bf16 one step within
relative L2 2e-2 a leaf (one bf16 rounding of every activation).  The
autograd Functions' backwards are held to autograd of the plain versions
(1e-5 fp32, 2e-2 bf16) and to JAX's gradient of the reference's
formulation."""
import dataclasses
import functools
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro.configs.registry import get_arch as jax_get_arch
from repro.models.lm import model as jax_model
from repro.models.lm import steps as jax_steps
from repro.models.recsys import dlrm as jd
from repro.train import optim as jax_optim
from repro_torch.ckpt.checkpoint import tree_flatten
from repro_torch.configs import dlrm_rm2 as dlrm_cfgs
from repro_torch.configs.registry import get_arch
from repro_torch.kernels.embedding_bag import EmbeddingBagFn, embedding_bag
from repro_torch.kernels.embedding_bag.ref import embedding_bag_ref
from repro_torch.kernels.flash_attention import (FlashAttentionFn,
                                                 flash_attention)
from repro_torch.kernels.flash_attention.ref import flash_attention_ref
from repro_torch.models.lm import model, steps
from repro_torch.models.lm.convert import _tensor, params_from_numpy
from repro_torch.models.recsys import dlrm as td
from repro_torch.train import optim, value_and_grad

ROOT = Path(__file__).resolve().parents[1]
ARCHS = ["phi4-mini-3.8b", "qwen2-1.5b", "nemotron-4-15b", "olmoe-1b-7b",
         "deepseek-v3-671b"]
STEP_ARCHS = ["qwen2-1.5b", "olmoe-1b-7b", "deepseek-v3-671b"]
FP32 = dict(param_dtype="float32", compute_dtype="float32")
OPT_TOL = dict(atol=1e-6, rtol=1e-6)
LOSS_REL, GRAD_REL = 1e-5, 1e-4
STEP_TOL = dict(atol=5e-5, rtol=1e-5)
BF16_REL = 2e-2
B, S = 2, 40      # 40 tokens: two query chunks at the REDUCED attn_chunk 32


# ---------------------------------------------------------------------------
# helpers
# ---------------------------------------------------------------------------
def _np(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(jnp.asarray(x, jnp.float32))


def _rel_l2(got, want) -> float:
    got, want = _np(got), _np(want)
    return float(np.linalg.norm(got - want)
                 / max(np.linalg.norm(want), 1e-30))


def _to_torch(tree):
    """A JAX tree of dicts and lists as the port's tree of CPU tensors."""
    return jax.tree.map(lambda a: _tensor(np.asarray(a)), tree)


def _pairs(jax_tree, torch_tree):
    """The leaves of both trees, paired (both flatten dict keys sorted)."""
    want, got = jax.tree.leaves(jax_tree), tree_flatten(torch_tree)
    assert len(want) == len(got)
    return zip(got, want)


def _assert_tree_close(got_tree, want_tree, **tol):
    for got, want in _pairs(want_tree, got_tree):
        assert tuple(got.shape) == tuple(want.shape)
        np.testing.assert_allclose(_np(got), _np(want), **tol)


@functools.cache
def _jax_init(arch: str, over: tuple = ()):
    cfg = dataclasses.replace(jax_get_arch(arch).REDUCED, **dict(over))
    return cfg, jax.jit(jax_model.init_params, static_argnums=1)(
        jax.random.PRNGKey(0), cfg)


def _carried(arch: str, **over):
    """(reference config, reference params, port config, port params)."""
    cfg_j, pj = _jax_init(arch, tuple(sorted(over.items())))
    cfg_t = dataclasses.replace(get_arch(arch).REDUCED, **over)
    return cfg_j, pj, cfg_t, params_from_numpy(jax.tree.map(np.asarray, pj),
                                               cfg_t, "cpu")


def _tokens(cfg, seed=0, b=B, s=S):
    return np.random.default_rng(seed).integers(0, cfg.vocab, size=(b, s))


def _opt_tree(seed=0, dtype=np.float32):
    """A parameter-like tree: nested dicts and a list, leaves of 1-3 dims."""
    rng = np.random.default_rng(seed)

    def a(*shape):
        return rng.normal(size=shape).astype(dtype)

    return {"w": a(8, 6), "b": a(6), "blocks": [{"k": a(3, 4, 5)},
                                                {"k": a(3, 4, 5)}]}


def _grads_like(tree, seed):
    rng = np.random.default_rng(seed)
    return jax.tree.map(lambda p: (rng.normal(size=p.shape) * 0.3)
                        .astype(p.dtype), tree)


# ---------------------------------------------------------------------------
# optimizers, clipping, compression
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_adamw_matches_reference(dtype):
    """Three AdamW steps; moments fp32 whatever the parameter's dtype."""
    import ml_dtypes
    npdt = np.float32 if dtype == "float32" else ml_dtypes.bfloat16
    pj = jax.tree.map(jnp.asarray, _opt_tree(0, npdt))
    pt = _to_torch(pj)
    sj, st = jax_optim.adamw_init(pj), optim.adamw_init(pt)
    for i in range(3):
        gj = jax.tree.map(jnp.asarray, _grads_like(_opt_tree(0, npdt), i))
        pj, sj = jax_optim.adamw_update(gj, sj, pj, lr=1e-2)
        out, st = optim.adamw_update(_to_torch(gj), st, pt, lr=1e-2)
        assert out is pt
    assert int(st.step) == int(sj.step) == 3
    for leaf in tree_flatten(st.mu) + tree_flatten(st.nu):
        assert leaf.dtype == torch.float32
    _assert_tree_close(st.mu, sj.mu, **OPT_TOL)
    _assert_tree_close(st.nu, sj.nu, **OPT_TOL)
    for got, want in _pairs(pj, pt):
        assert got.dtype == getattr(torch, dtype)
        ulp = 0.0 if dtype == "float32" else 2.0 ** -8
        np.testing.assert_allclose(_np(got), _np(want), atol=1e-6,
                                   rtol=1e-6 + ulp)


@pytest.mark.parametrize("weight_decay", [0.0, 0.1])
def test_adafactor_matches_reference_factored_and_not(weight_decay):
    """1-D leaves keep a full v; 2-D and 3-D leaves row and column stats
    over the last two axes; three steps with update clipping."""
    pj = jax.tree.map(jnp.asarray, _opt_tree(1))
    pt = _to_torch(pj)
    sj, st = jax_optim.adafactor_init(pj), optim.adafactor_init(pt)
    assert tuple(st.vr["w"].shape) == (8,) and tuple(st.vc["w"].shape) == (6,)
    assert tuple(st.vr["b"].shape) == (6,) and tuple(st.vc["b"].shape) == (1,)
    assert tuple(st.vc["blocks"][0]["k"].shape) == (3, 5)
    for i in range(3):
        gj = jax.tree.map(jnp.asarray, _grads_like(_opt_tree(1), 10 + i))
        pj, sj = jax_optim.adafactor_update(gj, sj, pj, lr=1e-2,
                                            weight_decay=weight_decay)
        optim.adafactor_update(_to_torch(gj), st, pt, lr=1e-2,
                               weight_decay=weight_decay)
    _assert_tree_close(st.vr, sj.vr, **OPT_TOL)
    _assert_tree_close(st.vc, sj.vc, **OPT_TOL)
    _assert_tree_close(pt, pj, **OPT_TOL)


@pytest.mark.parametrize("scale", [0.01, 10.0])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_clip_by_global_norm_matches_reference(scale, dtype):
    """Below and above the norm 1; a bf16 gradient scaled in fp32 and
    rounded once."""
    import ml_dtypes
    npdt = np.float32 if dtype == "float32" else ml_dtypes.bfloat16
    gj = jax.tree.map(lambda a: jnp.asarray((a.astype(np.float32) * scale)
                                            .astype(npdt)), _opt_tree(2))
    cj, nj = jax_optim.clip_by_global_norm(gj, 1.0)
    ct, nt = optim.clip_by_global_norm(_to_torch(gj), 1.0)
    np.testing.assert_allclose(float(nt), float(nj), rtol=1e-6)
    for got, want in _pairs(cj, ct):
        assert got.dtype == getattr(torch, dtype)
        np.testing.assert_allclose(_np(got), _np(want), **OPT_TOL)


def test_int8_compression_matches_reference():
    gj = jax.tree.map(jnp.asarray, _grads_like(_opt_tree(3), 3))
    qj, _ = jax_optim.compress_grads(gj, "int8")
    qt, state = optim.compress_grads(_to_torch(gj), "int8")
    assert state is None
    _assert_tree_close(qt, qj, **OPT_TOL)


def test_topk_compression_with_error_feedback_matches_reference():
    """Three rounds: what is sent and the residual carried to the next."""
    pj = jax.tree.map(jnp.asarray, _opt_tree(4))
    sj = jax_optim.compression_init(pj, "topk")
    st = optim.compression_init(_to_torch(pj), "topk")
    for i in range(3):
        gj = jax.tree.map(jnp.asarray, _grads_like(_opt_tree(4), 20 + i))
        sent_j, sj = jax_optim.compress_grads(gj, "topk", sj, topk_frac=0.1)
        sent_t, st = optim.compress_grads(_to_torch(gj), "topk", st,
                                          topk_frac=0.1)
        _assert_tree_close(sent_t, sent_j, **OPT_TOL)
        _assert_tree_close(st.error, sj.error, **OPT_TOL)
    assert optim.compression_init(_to_torch(pj), "int8") is None


def test_topk_without_state_fails_on_both_sides():
    """The reference's train step calls compress_grads(grads, "topk")
    without a state and fails there; the port raises a clear error, in
    compress_grads and in the train step."""
    gj = jax.tree.map(jnp.asarray, _grads_like(_opt_tree(5), 5))
    with pytest.raises(AttributeError):
        jax_optim.compress_grads(gj, "topk")
    with pytest.raises(ValueError, match="error-feedback"):
        optim.compress_grads(_to_torch(gj), "topk")
    cfg_j, pj, cfg_t, pt = _carried("qwen2-1.5b", **FP32)
    cfg_j = dataclasses.replace(cfg_j, grad_compression="topk")
    cfg_t = dataclasses.replace(cfg_t, grad_compression="topk")
    toks = _tokens(cfg_j)
    with pytest.raises(AttributeError):
        jax.jit(jax_steps.make_train_step(cfg_j))(
            pj, jax_steps.init_opt_state(cfg_j, pj), jnp.asarray(toks))
    with pytest.raises(ValueError, match="error-feedback"):
        steps.make_train_step(cfg_t)(pt, steps.init_opt_state(cfg_t, pt),
                                     torch.as_tensor(toks))


def test_make_optimizer_names():
    assert optim.make_optimizer("adamw") == (optim.adamw_init,
                                             optim.adamw_update)
    assert optim.make_optimizer("adafactor") == (optim.adafactor_init,
                                                 optim.adafactor_update)
    with pytest.raises(ValueError):
        optim.make_optimizer("sgd")


# ---------------------------------------------------------------------------
# the LM: loss, gradients, train step
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("arch", ARCHS)
def test_loss_and_gradients_match_reference_fp32(arch):
    """``loss_fn`` (with the MoE aux and the MTP terms where the model has
    them) and the gradient of every leaf."""
    cfg_j, pj, cfg_t, pt = _carried(arch, **FP32)
    toks = _tokens(cfg_j, seed=1)
    (tj, mj), gj = jax.jit(jax.value_and_grad(jax_steps.loss_fn,
                                              has_aux=True),
                           static_argnums=1)(pj, cfg_j, jnp.asarray(toks))
    (tt, mt), gt = value_and_grad(steps.loss_fn, has_aux=True)(
        pt, cfg_t, torch.as_tensor(toks))
    for got, want in ((tt, tj), (mt["loss"], mj["loss"]),
                      (mt["aux"], mj["aux"])):
        assert got.dim() == 0 and not got.requires_grad
        assert abs(float(got) - float(want)) <= LOSS_REL * max(
            abs(float(want)), 1.0)
    assert (float(mt["aux"]) > 0) == (cfg_t.moe is not None)
    for got, want in _pairs(gj, gt):
        assert got.dtype == torch.float32
        assert _rel_l2(got, want) <= GRAD_REL
    assert all(p.grad is None and not p.requires_grad
               for p in tree_flatten(pt))


@pytest.mark.parametrize("arch", STEP_ARCHS)
def test_train_steps_match_reference_fp32(arch):
    """One and three steps of ``make_train_step`` (qwen2 AdamW with QKV
    bias and tied embeddings, olmoe MoE, deepseek-v3 Adafactor + MLA + MTP):
    metrics each step, parameters and state after the first and third."""
    cfg_j, pj, cfg_t, pt = _carried(arch, **FP32)
    step_j = jax.jit(jax_steps.make_train_step(cfg_j, lr=1e-3))
    step_t = steps.make_train_step(cfg_t, lr=1e-3)
    oj, ot = jax_steps.init_opt_state(cfg_j, pj), \
        steps.init_opt_state(cfg_t, pt)
    for i in range(3):
        toks = _tokens(cfg_j, seed=10 + i)
        pj, oj, mj = step_j(pj, oj, jnp.asarray(toks))
        out, ot, mt = step_t(pt, ot, torch.as_tensor(toks))
        assert out is pt
        assert set(mt) == {"loss", "aux", "grad_norm", "total"}
        for k in mt:
            assert mt[k].dim() == 0
            np.testing.assert_allclose(float(mt[k]), float(mj[k]),
                                       rtol=LOSS_REL, atol=LOSS_REL)
        if i in (0, 2):
            _assert_tree_close(pt, pj, **STEP_TOL)
            _assert_tree_close(tuple(ot)[1:], tuple(oj)[1:], **STEP_TOL)
    assert int(ot.step) == 3


@pytest.mark.parametrize("arch", ["qwen2-1.5b", "olmoe-1b-7b"])
def test_train_step_matches_reference_bf16(arch):
    """One bf16 step: the metrics within 2e-2 and every parameter within
    relative L2 2e-2 of the reference's (one bf16 rounding of every
    activation, in other places in the two frameworks).  A leaf that
    starts at zero (the QKV biases) holds only the step, about +-lr an
    element, whose sign follows gradients at bf16's noise for the key
    bias: each element within 2 lr of the reference's."""
    cfg_j, pj, cfg_t, pt = _carried(arch)
    assert cfg_t.param_dtype == "bfloat16"
    zero = [not float(np.abs(_np(w)).max()) for w in jax.tree.leaves(pj)]
    toks = _tokens(cfg_j, seed=3)
    pj, _, mj = jax.jit(jax_steps.make_train_step(cfg_j, lr=1e-3))(
        pj, jax_steps.init_opt_state(cfg_j, pj), jnp.asarray(toks))
    _, ot, mt = steps.make_train_step(cfg_t, lr=1e-3)(
        pt, steps.init_opt_state(cfg_t, pt), torch.as_tensor(toks))
    for k in ("loss", "grad_norm", "total"):
        np.testing.assert_allclose(float(mt[k]), float(mj[k]),
                                   rtol=BF16_REL)
    for (got, want), was_zero in zip(_pairs(pj, pt), zero):
        assert got.dtype == getattr(torch, str(want.dtype))
        if was_zero:
            assert np.abs(_np(got) - _np(want)).max() <= 2e-3
        else:
            assert _rel_l2(got, want) <= BF16_REL
    assert all(m.dtype == torch.float32 for m in tree_flatten(ot.mu))


def test_microbatch_two_equals_one():
    """microbatch 2 gives microbatch 1's step (the gradient of a mean loss
    is the mean of the halves' gradients) and the reference's microbatch-2
    step; its gradients accumulate in fp32."""
    cfg_j, pj, cfg_t, pt = _carried("qwen2-1.5b", **FP32)
    toks = _tokens(cfg_j, seed=4, b=4, s=16)
    outs = {}
    for mb in (1, 2):
        cfg = dataclasses.replace(cfg_t, microbatch=mb)
        params = jax.tree.map(lambda t: t.clone(), pt)
        p2, _, m = steps.make_train_step(cfg)(
            params, steps.init_opt_state(cfg, params), torch.as_tensor(toks))
        outs[mb] = (p2, float(m["loss"]))
    assert abs(outs[1][1] - outs[2][1]) < 1e-5
    for a, b in zip(tree_flatten(outs[1][0]), tree_flatten(outs[2][0])):
        np.testing.assert_allclose(_np(a), _np(b), atol=2e-5, rtol=2e-5)
    cfg_j2 = dataclasses.replace(cfg_j, microbatch=2)
    pj2, _, mj = jax.jit(jax_steps.make_train_step(cfg_j2))(
        pj, jax_steps.init_opt_state(cfg_j2, pj), jnp.asarray(toks))
    assert abs(float(mj["loss"]) - outs[2][1]) < 1e-5
    _assert_tree_close(outs[2][0], pj2, **STEP_TOL)


@pytest.mark.parametrize("arch", ["qwen2-1.5b", "olmoe-1b-7b",
                                  "deepseek-v3-671b"])
def test_remat_policies_give_the_same_gradients(arch, monkeypatch):
    """``nothing``, ``dots`` and ``full`` give the same loss and gradients;
    ``nothing`` and ``dots`` recompute each block in the backward, so a
    GQA model's attention runs twice a layer, once under ``full``."""
    _, _, cfg_t, pt = _carried(arch, **FP32)
    toks = torch.as_tensor(_tokens(cfg_t, seed=5))
    calls = []
    real = model.flash_attention

    def spy(q, k, v, chunk=None):
        calls.append(chunk)
        return real(q, k, v, chunk=chunk)

    monkeypatch.setattr(model, "flash_attention", spy)
    out = {}
    for policy in ("full", "nothing", "dots"):
        cfg = dataclasses.replace(cfg_t, remat_policy=policy)
        calls.clear()
        out[policy] = value_and_grad(steps.loss_fn, has_aux=True)(pt, cfg,
                                                                  toks)
        gqa = cfg.attention == "gqa"
        assert len(calls) == gqa * cfg.n_layers * (1 if policy == "full"
                                                   else 2)
        assert all(c == cfg.attn_chunk for c in calls)
    for policy in ("nothing", "dots"):
        assert float(out[policy][0][0]) == float(out["full"][0][0])
        for a, b in zip(tree_flatten(out[policy][1]),
                        tree_flatten(out["full"][1])):
            np.testing.assert_allclose(a.numpy(), b.numpy(), atol=1e-6,
                                       rtol=1e-6)
    with pytest.raises(ValueError, match="remat_policy"):
        value_and_grad(steps.loss_fn, has_aux=True)(
            pt, dataclasses.replace(cfg_t, remat_policy="some"), toks)


def test_cross_entropy_gather_equals_one_hot():
    rng = np.random.default_rng(6)
    logits = rng.normal(size=(2, 7, 50)).astype(np.float32) * 5
    targets = rng.integers(0, 50, size=(2, 7))
    want = jax_steps.cross_entropy(jnp.asarray(logits), jnp.asarray(targets))
    got = steps.cross_entropy(torch.as_tensor(logits),
                              torch.as_tensor(targets))
    np.testing.assert_allclose(float(got), float(want), rtol=1e-6)


# ---------------------------------------------------------------------------
# DLRM-RM2's train step
# ---------------------------------------------------------------------------
def _dlrm_inputs(cfg, b, seed):
    rng = np.random.default_rng(seed)
    dense = rng.normal(size=(b, cfg.n_dense)).astype(np.float32)
    sparse = np.stack([rng.integers(0, v, size=(b, cfg.multi_hot))
                       for v in cfg.vocab_sizes], axis=1).astype(np.int32)
    labels = rng.integers(0, 2, size=b).astype(np.float32)
    return dense, sparse, labels


@pytest.mark.parametrize("multi_hot", [1, 3])
def test_dlrm_train_step_matches_reference(multi_hot):
    """Three steps of ``configs.dlrm_rm2.make_train_step`` against the
    reference's ``value_and_grad(dlrm_loss)`` + ``adamw_update`` at lr 1e-3
    (its ``build_train`` step without the mesh): the loss each step, the
    dense gradient of every table (rows no bag read included) on the first,
    parameters and state after the third."""
    cfg = dlrm_cfgs.SMOKE_CONFIG._replace(multi_hot=multi_hot)
    pj = jd.init_dlrm(jax.random.PRNGKey(7), cfg)
    pt = td.params_from_numpy(jax.tree.map(np.asarray, pj), cfg, "cpu")
    oj = jax_optim.adamw_init(pj)
    ot = optim.adamw_init(pt)
    step_t = dlrm_cfgs.make_train_step(cfg)

    def step_j(params, opt_state, dense, sparse, labels):
        loss, grads = jax.value_and_grad(jd.dlrm_loss)(params, cfg, dense,
                                                       sparse, labels)
        params, opt_state = jax_optim.adamw_update(grads, opt_state, params,
                                                   lr=1e-3)
        return params, opt_state, loss

    for i in range(3):
        batch = _dlrm_inputs(cfg, 64, seed=30 + i)
        if i == 0:
            _, gt = value_and_grad(td.dlrm_loss)(
                pt, cfg, *(torch.as_tensor(a) for a in batch))
            _, gj = jax.value_and_grad(jd.dlrm_loss)(
                pj, cfg, *map(jnp.asarray, batch))
        pj, oj, lj = step_j(pj, oj, *map(jnp.asarray, batch))
        out, ot, lt = step_t(pt, ot, *(torch.as_tensor(a) for a in batch))
        assert out is pt and lt.dim() == 0
        np.testing.assert_allclose(float(lt), float(lj), rtol=LOSS_REL)
        if i == 0:
            for got, want in _pairs(gj, gt):
                assert got.shape == want.shape
                np.testing.assert_allclose(_np(got), _np(want), atol=1e-6,
                                           rtol=1e-5)
            f = int(np.argmax(cfg.vocab_sizes))
            unread = np.setdiff1d(np.arange(cfg.vocab_sizes[f]),
                                  batch[1][:, f].ravel())
            assert unread.size and not gt["tables"][f][unread].any()
    _assert_tree_close(pt, pj, **STEP_TOL)
    _assert_tree_close(ot.mu, oj.mu, **STEP_TOL)
    _assert_tree_close(ot.nu, oj.nu, **STEP_TOL)


def test_dlrm_jitted_reference_gradients_equal_unjitted(multi_hot=1):
    """The reference's DLRM step jitted with its gradients as an output
    beside the AdamW update, against its unjitted ``jax.value_and_grad``
    on the CPU, for three steps: the gradients agree (within 1e-6 of each
    leaf's norm; measured 2.6e-7 at most), and so do the port's
    (``value_and_grad`` of ``dlrm_loss``) at the existing test's bars.
    So ``test_dlrm_train_step_matches_reference``'s separate
    ``value_and_grad`` and unjitted steps are a choice, not a guard
    against a reference fault: the ~20% disagreement once reported at
    multi_hot 1 does not occur on this JAX."""
    cfg = dlrm_cfgs.SMOKE_CONFIG._replace(multi_hot=multi_hot)
    pj = jd.init_dlrm(jax.random.PRNGKey(7), cfg)
    oj = jax_optim.adamw_init(pj)

    def step_j(params, opt_state, dense, sparse, labels):
        loss, grads = jax.value_and_grad(jd.dlrm_loss)(params, cfg, dense,
                                                       sparse, labels)
        params, opt_state = jax_optim.adamw_update(grads, opt_state, params,
                                                   lr=1e-3)
        return params, opt_state, loss, grads

    jitted = jax.jit(step_j)
    for i in range(3):
        batch = _dlrm_inputs(cfg, 64, seed=30 + i)
        jb = tuple(map(jnp.asarray, batch))
        lu, gu = jax.value_and_grad(jd.dlrm_loss)(pj, cfg, *jb)
        _, _, lj, gj = jitted(pj, oj, *jb)
        pt = td.params_from_numpy(jax.tree.map(np.asarray, pj), cfg, "cpu")
        lt, gt = value_and_grad(td.dlrm_loss)(
            pt, cfg, *(torch.as_tensor(a) for a in batch))
        np.testing.assert_allclose(float(lj), float(lu), rtol=LOSS_REL)
        np.testing.assert_allclose(float(lt), float(lu), rtol=LOSS_REL)
        for x, y in zip(jax.tree.leaves(gj), jax.tree.leaves(gu)):
            assert _rel_l2(x, y) <= 1e-6
        for got, want in _pairs(gu, gt):
            np.testing.assert_allclose(_np(got), _np(want), atol=1e-6,
                                       rtol=1e-5)
        pj, oj, _ = step_j(pj, oj, *jb)[:3]


# ---------------------------------------------------------------------------
# the kernels' autograd Functions, through their plain forwards
# ---------------------------------------------------------------------------
def _qkv(seed, b, s, h, hkv, dh, dtype):
    rng = np.random.default_rng(seed)
    return [torch.as_tensor(rng.normal(size=(b, s, n, dh)).astype(np.float32)
                            ).to(dtype) for n in (h, hkv, hkv)]


@pytest.mark.parametrize("b,s,h,hkv,dh,chunk", [
    (2, 40, 4, 2, 16, 32), (1, 33, 12, 2, 8, 8), (2, 17, 4, 4, 16, 64),
    (1, 24, 6, 1, 32, 5)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_attention_fn_backward_matches_autograd_of_plain(
        b, s, h, hkv, dh, chunk, dtype):
    """``FlashAttentionFn`` (the wrapper with inputs that require a
    gradient) against autograd of ``flash_attention_ref``: the same output
    and the same dq, dk, dv, at chunks that split S unevenly, 6 query heads
    a kv head among them."""
    q, k, v = (t.requires_grad_() for t in _qkv(s, b, s, h, hkv, dh, dtype))
    g = torch.as_tensor(np.random.default_rng(1).normal(
        size=(b, s, h, dh)).astype(np.float32)).to(dtype)
    out = flash_attention(q, k, v, chunk=chunk)
    assert type(out.grad_fn).__name__ == "FlashAttentionFnBackward"
    got = torch.autograd.grad(out, (q, k, v), g)
    ref = flash_attention_ref(q, k, v)
    want = torch.autograd.grad(ref, (q, k, v), g)
    tol = dict(atol=1e-5, rtol=1e-5) if dtype == torch.float32 \
        else dict(atol=2e-2, rtol=2e-2)
    assert torch.equal(out, ref.detach())
    for a, w in zip(got, want):
        assert a.dtype == dtype
        torch.testing.assert_close(a, w, **tol)


def test_flash_attention_fn_matches_reference_gradient():
    """The backward against JAX's gradient of the reference's own training
    attention (``causal_attention``: query chunks under ``jax.checkpoint``)
    at qwen2's grouping of 6 query heads a kv head."""
    cfg_j = dataclasses.replace(jax_get_arch("qwen2-1.5b").REDUCED,
                                attn_chunk=16, **FP32)
    q, k, v = _qkv(2, 2, 40, 6, 1, 16, torch.float32)
    g = np.random.default_rng(3).normal(size=(2, 40, 6, 16)).astype(
        np.float32)
    _, vjp = jax.vjp(lambda *a: jax_model.causal_attention(*a, cfg_j),
                     *(jnp.asarray(t.numpy()) for t in (q, k, v)))
    want = vjp(jnp.asarray(g))
    got = torch.autograd.grad(
        FlashAttentionFn.apply(*(t.requires_grad_() for t in (q, k, v)), 16),
        (q, k, v), torch.as_tensor(g))
    for a, w in zip(got, want):
        np.testing.assert_allclose(a.numpy(), np.asarray(w), atol=1e-5,
                                   rtol=1e-4)


@pytest.mark.parametrize("V,b,hot,d,padding_idx", [
    (50, 16, 1, 8, None), (30, 9, 4, 16, None), (20, 12, 5, 8, 3),
    (7, 40, 3, 4, 0)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_embedding_bag_fn_backward_matches_autograd_of_plain(
        V, b, hot, d, padding_idx, dtype):
    """``EmbeddingBagFn`` against autograd of ``embedding_bag_ref``: a
    dense gradient in the table's dtype, padding lanes adding nothing,
    repeated rows summed, unread rows 0; idx gets none.  A bf16 table's
    gradient is summed in fp32 and rounded once, so it is held to autograd
    of the plain version in fp32, rounded (autograd of the bf16 plain
    version adds repeated rows in bf16), within one bf16 ulp."""
    rng = np.random.default_rng(V)
    table = torch.as_tensor(rng.normal(size=(V, d)).astype(np.float32)) \
        .to(dtype).requires_grad_()
    idx = torch.as_tensor(rng.integers(0, V, size=(b, hot)).astype(np.int32))
    g = torch.as_tensor(rng.normal(size=(b, d)).astype(np.float32)).to(dtype)
    out = embedding_bag(table, idx, padding_idx)
    assert type(out.grad_fn).__name__ == "EmbeddingBagFnBackward"
    (got,) = torch.autograd.grad(out, table, g)
    t32 = table.detach().float().requires_grad_()
    (want,) = torch.autograd.grad(embedding_bag_ref(t32, idx, padding_idx),
                                  t32, g.float())
    assert got.dtype == dtype and got.shape == table.shape
    tol = dict(atol=1e-6, rtol=1e-6) if dtype == torch.float32 \
        else dict(atol=1e-3, rtol=2.0 ** -8)
    torch.testing.assert_close(got, want.to(dtype), **tol)
    if padding_idx is not None:
        assert not got[padding_idx].any()
    unread = np.setdiff1d(np.arange(V), idx.numpy().ravel())
    assert not got[torch.as_tensor(unread, dtype=torch.long)].any()


def test_embedding_bag_fn_matches_reference_gradient():
    """The dense table gradient against JAX's gradient of the reference's
    bag (``take`` + sum)."""
    rng = np.random.default_rng(8)
    table = rng.normal(size=(40, 8)).astype(np.float32)
    idx = rng.integers(0, 40, size=(64, 3)).astype(np.int32)
    g = rng.normal(size=(64, 8)).astype(np.float32)
    _, vjp = jax.vjp(lambda t: jd.embedding_bag(t, jnp.asarray(idx)),
                     jnp.asarray(table))
    (want,) = vjp(jnp.asarray(g))
    t = torch.as_tensor(table).requires_grad_()
    (got,) = torch.autograd.grad(EmbeddingBagFn.apply(
        t, torch.as_tensor(idx), None), t, torch.as_tensor(g))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-6,
                               rtol=1e-6)


# ---------------------------------------------------------------------------
# serving builds no graph
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("arch", ["qwen2-1.5b", "deepseek-v3-671b"])
def test_serving_builds_no_graph(arch):
    """Prefill and decode run without autograd even when the parameters
    require a gradient; the kernel wrappers go through their Functions
    only when an input requires one."""
    cfg = dataclasses.replace(get_arch(arch).REDUCED, **FP32)
    params = model.init_params(torch.Generator().manual_seed(0), cfg, "cpu")
    for p in tree_flatten(params):
        p.requires_grad_()
    toks = torch.as_tensor(_tokens(cfg, b=2, s=12))
    logits, caches = steps.make_prefill_step(cfg, max_seq=14)(params, toks)
    lg, caches = steps.make_decode_step(cfg)(params, caches,
                                             logits[:, -1].argmax(-1), 12)
    for t in [logits, lg] + [c for cs in caches.values() for c in cs[:2]]:
        assert t.grad_fn is None and not t.requires_grad
    q, k, v = _qkv(0, 1, 8, 2, 1, 8, torch.float32)
    assert flash_attention(q, k, v).grad_fn is None
    table = torch.ones(5, 4)
    idx = torch.zeros(3, 2, dtype=torch.int32)
    assert embedding_bag(table, idx).grad_fn is None
    with torch.no_grad():
        assert embedding_bag(table.requires_grad_(), idx).grad_fn is None
    cfg_d = dlrm_cfgs.SMOKE_CONFIG
    pd = td.init_dlrm(torch.Generator().manual_seed(0), cfg_d, device="cpu")
    dense, sparse, _ = _dlrm_inputs(cfg_d, 8, 0)
    out = td.dlrm_forward(pd, cfg_d, torch.as_tensor(dense),
                          torch.as_tensor(sparse))
    assert out.grad_fn is None


# ---------------------------------------------------------------------------
# the CLI and the example
# ---------------------------------------------------------------------------
def _run(*args, timeout=240):
    env = {"PYTHONPATH": str(ROOT / "src"), "PATH": "/usr/bin:/bin",
           "JAX_PLATFORMS": "cpu", "OMP_NUM_THREADS": "2"}
    for key in ("HOME", "TMPDIR"):
        if key in os.environ:
            env[key] = os.environ[key]
    res = subprocess.run([sys.executable, *args], capture_output=True,
                         text=True, timeout=timeout, cwd=ROOT, env=env)
    assert res.returncode == 0, res.stderr[-3000:]
    return res.stdout


def test_train_cli_on_cpu(tmp_path):
    """``python -m repro_torch.launch.train --device cpu``: three steps of
    the REDUCED qwen2-1.5b, checkpointed at step 0, tokens/s on the named
    device."""
    out = _run("-m", "repro_torch.launch.train", "--device", "cpu",
               "--arch", "qwen2-1.5b", "--steps", "3", "--ckpt-dir",
               str(tmp_path))
    lines = out.strip().splitlines()
    assert lines[0].startswith("training qwen2-1.5b: 2L d=64")
    assert sum(line.startswith("step ") for line in lines) == 3
    assert "tokens/s on cpu" in lines[-1]
    assert (tmp_path / "step_00000000" / "_COMMITTED").exists()


def test_train_lm_example_on_cpu():
    """The ported example at a few steps: its ~100M qwen2-family model
    learns the Zipf-plus-copy corpus (its own "must decrease" check)."""
    out = _run("-m", "repro_torch.examples.train_lm", "--device", "cpu",
               "--steps", "12", "--batch", "2", "--seq", "32")
    assert "model: " in out and "(must decrease)" in out
