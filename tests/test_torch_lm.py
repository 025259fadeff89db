"""The port's dense-GQA LM serving path (``repro_torch.models.lm``) against
the reference's (``repro.models.lm``) on the CPU, for the REDUCED
phi4-mini-3.8b, qwen2-1.5b and nemotron-4-15b: the reference's
``init_params`` tree goes through ``params_from_numpy``, then both
packages run ``forward`` and ``gqa_attend``, prefill the same prompts and
decode greedily.  In fp32 the hidden states, the prefill logits, the
caches and the logits of 6 decode steps match at atol/rtol 2e-3 and the
greedy tokens are equal; in bf16 the logits stay
within relative L2 2e-2 (the reference's bf16 bar), fed the same tokens,
since bf16 flips near-tied argmaxes.  Also: the configs and registry, the
init tree, the CLI, and that no module of the port imports JAX or the
reference."""
import dataclasses
import re
from pathlib import Path

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro.configs.registry import get_arch as jax_get_arch
from repro.models.lm import model as jax_model
from repro.models.lm import steps as jax_steps
from repro_torch.configs.registry import ARCHS, get_arch
from repro_torch.kernels.flash_attention.ref import flash_attention_ref
from repro_torch.launch import lm_serve
from repro_torch.models.lm import model
from repro_torch.models.lm.convert import params_from_numpy
from repro_torch.models.lm.steps import make_decode_step, make_prefill_step

ROOT = Path(__file__).resolve().parents[1]
DENSE = ["phi4-mini-3.8b", "qwen2-1.5b", "nemotron-4-15b"]
FP32 = dict(param_dtype="float32", compute_dtype="float32")
TOL = dict(atol=2e-3, rtol=2e-3)
N_DECODE = 6


def _cfgs(arch: str, **over):
    """(reference config, port config), REDUCED, with ``over`` applied."""
    return (dataclasses.replace(jax_get_arch(arch).REDUCED, **over),
            dataclasses.replace(get_arch(arch).REDUCED, **over))


def _carried(cfg_j, cfg_t, seed=0):
    """The reference's params and the port's copy of them."""
    pj = jax_model.init_params(jax.random.PRNGKey(seed), cfg_j)
    return pj, params_from_numpy(jax.tree.map(np.asarray, pj), cfg_t, "cpu")


def _np(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(jnp.asarray(x, jnp.float32))


def _rel_l2(a, b) -> float:
    a, b = _np(a), _np(b)
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


def _prompts(cfg, B, S, seed=0):
    return np.random.default_rng(seed).integers(0, cfg.vocab, size=(B, S))


def _serve(arch, S, B=2, over=FP32, feed=None):
    """Prefill + N_DECODE greedy steps in both packages; returns per step
    (reference logits, port logits, reference caches, port caches) and the
    greedy tokens of each.  ``feed='ref'`` feeds the reference's tokens to
    both, for a comparison where argmaxes may flip."""
    cfg_j, cfg_t = _cfgs(arch, **over)
    pj, pt = _carried(cfg_j, cfg_t)
    prompts = _prompts(cfg_j, B, S)
    smax = S + N_DECODE
    lj, cj = jax.jit(jax_steps.make_prefill_step(cfg_j, max_seq=smax))(
        pj, jnp.asarray(prompts, jnp.int32))
    lt, ct = make_prefill_step(cfg_t, max_seq=smax)(pt, torch.as_tensor(
        prompts))
    # decode writes the port's caches in place: keep the prefill's apart
    steps = [(lj, lt, cj, {n: (c[0].clone(), c[1].clone(), c[2])
                           for n, c in ct.items()})]
    dec_j = jax.jit(jax_steps.make_decode_step(cfg_j))
    dec_t = make_decode_step(cfg_t)
    tok_j, tok_t = jnp.argmax(lj[:, -1], -1), lt[:, -1].argmax(-1)
    toks_j, toks_t = [np.asarray(tok_j)], [tok_t.numpy()]
    for i in range(N_DECODE):
        if feed == "ref":
            tok_t = torch.as_tensor(np.array(tok_j))
        lj, cj = dec_j(pj, cj, tok_j, jnp.asarray(S + i, jnp.int32))
        lt, ct = dec_t(pt, ct, tok_t, S + i)
        steps.append((lj, lt, cj, ct))
        tok_j, tok_t = jnp.argmax(lj, -1), lt.argmax(-1)
        toks_j.append(np.asarray(tok_j))
        toks_t.append(tok_t.numpy())
    return steps, np.stack(toks_j, 1), np.stack(toks_t, 1)


@pytest.mark.parametrize("arch", DENSE)
def test_forward_matches_reference_fp32(arch):
    """``forward`` without caches: the final hidden states and each
    layer's k/v (the prefill's caches) of both packages."""
    cfg_j, cfg_t = _cfgs(arch, **FP32)
    pj, pt = _carried(cfg_j, cfg_t, seed=4)
    tokens = _prompts(cfg_j, 2, 20, seed=4)
    hj, aux_j, kvj = jax_model.forward(pj, cfg_j, jnp.asarray(tokens))
    ht, aux_t, kvt = model.forward(pt, cfg_t, torch.as_tensor(tokens))
    np.testing.assert_allclose(_np(ht), _np(hj), **TOL)
    assert float(aux_t) == float(aux_j) == 0.0
    for want, got in zip(kvj["dense_blocks"], kvt["dense_blocks"]):
        assert tuple(got.shape) == tuple(want.shape)
        np.testing.assert_allclose(_np(got), _np(want), **TOL)


@pytest.mark.parametrize("arch", DENSE)
def test_gqa_attend_matches_reference_fp32(arch):
    """One layer's ``gqa_attend``: the prefill (the causal attention of
    model.py:243 through the kernel wrapper) and a decode step of 3
    queries against a cache written at position 5."""
    cfg_j, cfg_t = _cfgs(arch, **FP32)
    pj, pt = _carried(cfg_j, cfg_t, seed=5)
    lj = jax.tree.map(lambda a: a[0], pj["dense_blocks"]["attn"])
    lt = {k: v[0] for k, v in pt["dense_blocks"]["attn"].items()}
    rng = np.random.default_rng(5)
    B, S, smax = 2, 9, 12
    x = rng.normal(size=(B, S, cfg_t.d_model)).astype(np.float32)
    pos = np.tile(np.arange(S), (B, 1))
    oj, (kj, vj) = jax_model.gqa_attend(lj, cfg_j, jnp.asarray(x),
                                        jnp.asarray(pos))
    ot, (kt, vt) = model.gqa_attend(lt, cfg_t, torch.as_tensor(x),
                                    torch.as_tensor(pos))
    for got, want in ((ot, oj), (kt, kj), (vt, vj)):
        np.testing.assert_allclose(_np(got), _np(want), **TOL)

    shape = (B, smax, cfg_t.n_kv_heads, cfg_t.head_dim)
    ck, cv = (rng.normal(size=shape).astype(np.float32) for _ in range(2))
    x3, pos3 = x[:, :3], np.tile(np.arange(5, 8), (B, 1))
    oj, (ckj, cvj) = jax_model.gqa_attend(
        lj, cfg_j, jnp.asarray(x3), jnp.asarray(pos3),
        cache=(jnp.asarray(ck), jnp.asarray(cv), jnp.asarray(5, jnp.int32)))
    ot, (ckt, cvt) = model.gqa_attend(
        lt, cfg_t, torch.as_tensor(x3), torch.as_tensor(pos3),
        cache=(torch.as_tensor(ck.copy()), torch.as_tensor(cv.copy()), 5))
    for got, want in ((ot, oj), (ckt, ckj), (cvt, cvj)):
        np.testing.assert_allclose(_np(got), _np(want), **TOL)


@pytest.mark.parametrize("arch", DENSE)
@pytest.mark.parametrize("S", [32, 24])   # a multiple of attn_chunk; ragged
def test_prefill_and_decode_match_reference_fp32(arch, S):
    steps, toks_j, toks_t = _serve(arch, S)
    lj, lt, cj, ct = steps[0]
    assert lt.shape == (2, 1, get_arch(arch).REDUCED.vocab)
    np.testing.assert_allclose(_np(lt), _np(lj), **TOL)
    (kj, vj, pos_j), (kt, vt, pos_t) = (cj["dense_blocks"],
                                        ct["dense_blocks"])
    assert int(pos_j) == pos_t == S
    assert tuple(kt.shape) == tuple(kj.shape)
    np.testing.assert_allclose(_np(kt[:, :, :S]), _np(kj[:, :, :S]), **TOL)
    np.testing.assert_allclose(_np(vt[:, :, :S]), _np(vj[:, :, :S]), **TOL)
    assert not kt[:, :, S:].any() and not vt[:, :, S:].any()
    for i, (lj, lt, cj, ct) in enumerate(steps[1:]):
        np.testing.assert_allclose(_np(lt), _np(lj), **TOL,
                                   err_msg=f"decode step {i}")
        assert ct["dense_blocks"][2] == S + i + 1
    np.testing.assert_allclose(_np(ct["dense_blocks"][0]),
                               _np(cj["dense_blocks"][0]), **TOL)
    np.testing.assert_array_equal(toks_t, toks_j)


def test_prefill_and_decode_match_reference_bf16():
    """The configs' own dtype (bf16): logits within relative L2 2e-2 of the
    reference's, fed the reference's tokens."""
    steps, _, _ = _serve("phi4-mini-3.8b", 32, over={}, feed="ref")
    assert steps[0][1].dtype == torch.bfloat16
    for i, (lj, lt, _, _) in enumerate(steps):
        assert _rel_l2(lt, lj) <= 2e-2, f"step {i}"


def test_decode_matches_reprefill():
    """The logits of decode step t equal a fresh prefill of the prompt and
    the tokens generated so far (fp32)."""
    _, cfg = _cfgs("phi4-mini-3.8b", **FP32)
    params = model.init_params(torch.Generator().manual_seed(1), cfg, "cpu")
    prompts = torch.as_tensor(_prompts(cfg, 2, 20, seed=1))
    logits, caches = make_prefill_step(cfg, max_seq=24)(params, prompts)
    seq, decode = prompts, make_decode_step(cfg)
    for i in range(4):
        tok = logits.reshape(2, -1).argmax(-1)
        seq = torch.cat([seq, tok[:, None]], dim=1)
        logits, caches = decode(params, caches, tok, 20 + i)
        again, _ = make_prefill_step(cfg)(params, seq)
        torch.testing.assert_close(logits, again[:, -1], **TOL)


def test_decode_from_an_empty_cache_matches_prefill():
    """Token by token from ``init_cache``, decode reaches the prefill's
    last logits and caches (fp32)."""
    _, cfg = _cfgs("qwen2-1.5b", **FP32)
    params = model.init_params(torch.Generator().manual_seed(2), cfg, "cpu")
    prompts = torch.as_tensor(_prompts(cfg, 2, 10, seed=2))
    want, want_caches = make_prefill_step(cfg, max_seq=12)(params, prompts)
    caches = model.init_cache(cfg, 2, 12, device="cpu")
    assert caches["dense_blocks"][0].shape == (cfg.n_layers, 2, 12,
                                               cfg.n_kv_heads, cfg.head_dim)
    decode = make_decode_step(cfg)
    for i in range(10):
        logits, caches = decode(params, caches, prompts[:, i], i)
    torch.testing.assert_close(logits, want[:, -1], **TOL)
    assert caches["dense_blocks"][2] == want_caches["dense_blocks"][2] == 10
    torch.testing.assert_close(caches["dense_blocks"][0],
                               want_caches["dense_blocks"][0], **TOL)
    with pytest.raises(ValueError):      # writing past the cache's end
        decode(params, model.set_cache_pos(caches, 12), prompts[:, 0], 12)


def test_prefill_attention_goes_through_the_kernel_wrapper(monkeypatch):
    """Every layer's prefill attention is one call of the kernel wrapper;
    ``attention=`` swaps in another function."""
    _, cfg = _cfgs("nemotron-4-15b", **FP32)
    params = model.init_params(torch.Generator().manual_seed(0), cfg, "cpu")
    calls = []

    def spy(q, k, v, chunk=None):
        calls.append(q.shape)
        return flash_attention_ref(q, k, v)

    monkeypatch.setattr(model, "flash_attention", spy)
    tokens = torch.as_tensor(_prompts(cfg, 2, 16))
    logits, _ = make_prefill_step(cfg)(params, tokens)
    assert len(calls) == cfg.n_layers
    assert calls[0] == (2, 16, cfg.n_heads, cfg.head_dim)
    plain, _ = make_prefill_step(cfg, attention=flash_attention_ref)(params,
                                                                      tokens)
    assert len(calls) == cfg.n_layers
    assert torch.equal(plain, logits)


@pytest.mark.parametrize("arch", DENSE)
def test_init_params_tree_matches_reference(arch):
    """Same keys, shapes and dtype as the reference's tree; matrices drawn
    at the reference's scale."""
    cfg_j, cfg_t = _cfgs(arch)
    want = jax.eval_shape(lambda: jax_model.init_params(
        jax.random.PRNGKey(0), cfg_j))
    got = model.init_params(torch.Generator().manual_seed(0), cfg_t, "cpu")
    flat_w = jax.tree_util.tree_flatten_with_path(want)[0]
    flat_g = {jax.tree_util.keystr(p): v for p, v in
              jax.tree_util.tree_flatten_with_path(got)[0]}
    assert len(flat_w) == len(flat_g)
    for path, leaf in flat_w:
        t = flat_g[jax.tree_util.keystr(path)]
        assert tuple(t.shape) == leaf.shape, path
        assert t.dtype == torch.bfloat16 and leaf.dtype == jnp.bfloat16
    w_q = got["dense_blocks"]["attn"]["w_q"].float()
    assert abs(w_q.std().item() * cfg_t.d_model ** 0.5 - 1.0) < 0.05


def test_params_from_numpy_takes_bf16_and_checks_shapes():
    cfg_j, cfg_t = _cfgs("qwen2-1.5b")
    tree = jax.tree.map(np.asarray, jax_model.init_params(
        jax.random.PRNGKey(3), cfg_j))
    assert tree["embed"].dtype.name == "bfloat16"
    params = params_from_numpy(tree, cfg_t, "cpu")
    assert params["embed"].dtype == torch.bfloat16
    np.testing.assert_array_equal(params["embed"].float().numpy(),
                                  tree["embed"].astype(np.float32))
    assert "lm_head" not in params   # tied embeddings
    with pytest.raises(ValueError):
        params_from_numpy(tree, _cfgs("phi4-mini-3.8b")[1], "cpu")


@pytest.mark.parametrize("arch", DENSE)
def test_configs_match_reference(arch):
    for attr in ("CONFIG", "REDUCED"):
        assert dataclasses.asdict(getattr(get_arch(arch), attr)) == \
            dataclasses.asdict(getattr(jax_get_arch(arch), attr))


def test_registry_raises_for_what_is_not_ported():
    from repro.configs.registry import ARCHS as JAX_ARCHS
    # every arch of the reference is ported: nothing is refused by name
    assert set(ARCHS) == set(JAX_ARCHS)
    assert get_arch("deepseek-v3-opt").__name__ == \
        "repro_torch.configs.deepseek_v3_opt"
    assert get_arch("ripple-papers").__name__ == \
        "repro_torch.configs.ripple_stream"
    with pytest.raises(KeyError):
        get_arch("no-such-arch")
    for name in ("olmoe-1b-7b", "deepseek-v3-671b", "dlrm-rm2"):
        assert repr(get_arch(name).CONFIG) == repr(jax_get_arch(name).CONFIG)
    mixed = dataclasses.replace(get_arch("phi4-mini-3.8b").REDUCED,
                                compute_dtype="float32")
    with pytest.raises(ValueError):
        model.init_params(torch.Generator(), mixed, "cpu")


def test_lm_serve_cli_on_cpu(capsys):
    toks = lm_serve.main(["--device", "cpu", "--arch", "qwen2-1.5b",
                          "--batch", "2", "--prompt-len", "12",
                          "--tokens", "5"])
    assert tuple(toks.shape) == (2, 5)
    assert "qwen2-1.5b: generated (2, 5)" in capsys.readouterr().out


def test_port_imports_neither_jax_nor_the_reference():
    pattern = re.compile(r"^\s*(import|from)\s+(jax|repro)\b", re.M)
    files = sorted((ROOT / "src" / "repro_torch").rglob("*.py")) \
        + [ROOT / "chip_smoke.py"]
    assert len(files) > 40
    for path in files:
        assert not pattern.search(path.read_text()), path
