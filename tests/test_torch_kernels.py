"""The port's kernel wrappers against the JAX package's Pallas kernels (run
in interpret mode, as tests/test_kernels.py runs them), at that file's
shapes and bars: 1e-5 on S', 1e-4 on h, and a bit-equal S' for
extremum_apply.

On the CPU a wrapper takes its kernel's plain version, so these tests
check the arithmetic every kernel must reproduce; the CUDA kernels are
held against the same plain versions on the card
(tests/test_torch_kernels_cuda.py and ``chip_smoke.py``)."""
import numpy as np
import pytest

import jax.numpy as jnp
import torch

from repro.kernels.delta_apply import delta_apply as jax_delta_apply
from repro.kernels.extremum_apply import extremum_apply as jax_extremum_apply
from repro.kernels.mlp_apply import mlp_apply as jax_mlp_apply

from repro_torch.kernels.delta_apply import delta_apply
from repro_torch.kernels.extremum_apply import extremum_apply
from repro_torch.kernels.mlp_apply import mlp_apply

S_TOL = dict(atol=1e-5, rtol=1e-5)
H_TOL = dict(atol=1e-4, rtol=1e-4)
DELTA_SHAPES = [(64, 32, 16), (128, 128, 128), (33, 48, 7), (256, 64, 200)]
MLP_SHAPES = [(64, 32, 32, 16), (128, 128, 128, 128), (33, 48, 20, 7)]
EXTREMUM_SHAPES = DELTA_SHAPES


def _delta_inputs(R, Din, Dout, seed=0):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(R, Din)).astype(np.float32),
            rng.normal(size=(R, Din)).astype(np.float32),
            rng.integers(0, 6, size=R).astype(np.float32),
            rng.normal(size=(Din, Dout)).astype(np.float32),
            rng.normal(size=Dout).astype(np.float32))


def _mlp_inputs(R, Din, Dh, Dout, seed=0):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(R, Din)).astype(np.float32),
            rng.normal(size=(R, Din)).astype(np.float32),
            rng.normal(size=(R, Din)).astype(np.float32),
            rng.integers(0, 6, size=R).astype(np.float32),
            0.37,
            rng.normal(size=(Din, Dh)).astype(np.float32),
            rng.normal(size=Dh).astype(np.float32),
            rng.normal(size=(Dh, Dout)).astype(np.float32),
            rng.normal(size=Dout).astype(np.float32))


def _torch(args, device="cpu"):
    return [torch.as_tensor(a, device=device) if isinstance(a, np.ndarray)
            else a for a in args]


@pytest.mark.parametrize("R,Din,Dout", DELTA_SHAPES)
@pytest.mark.parametrize("mean,relu", [(False, True), (True, False),
                                       (True, True)])
def test_delta_apply_matches_pallas(R, Din, Dout, mean, relu):
    args = _delta_inputs(R, Din, Dout)
    Sj, hj = jax_delta_apply(*[jnp.asarray(a) for a in args], mean=mean,
                             relu=relu)
    before = delta_apply.launches
    St, ht = delta_apply(*_torch(args), mean=mean, relu=relu)
    assert delta_apply.launches == before  # CPU tensors: plain version
    np.testing.assert_allclose(St.numpy(), np.asarray(Sj), **S_TOL)
    np.testing.assert_allclose(ht.numpy(), np.asarray(hj), **H_TOL)


@pytest.mark.parametrize("R,Din,Dh,Dout", MLP_SHAPES)
@pytest.mark.parametrize("mean,relu", [(False, True), (True, False)])
def test_mlp_apply_matches_pallas(R, Din, Dh, Dout, mean, relu):
    args = _mlp_inputs(R, Din, Dh, Dout)
    Sj, hj = jax_mlp_apply(*[jnp.asarray(a) for a in args], mean=mean,
                           relu=relu)
    before = mlp_apply.launches
    St, ht = mlp_apply(*_torch(args), mean=mean, relu=relu)
    assert mlp_apply.launches == before  # CPU tensors: plain version
    np.testing.assert_allclose(St.numpy(), np.asarray(Sj), **S_TOL)
    np.testing.assert_allclose(ht.numpy(), np.asarray(hj), **H_TOL)


def _extremum_inputs(R, Din, Dout, maximize, masked, seed=0):
    """Identity (+/-inf) rows in S (empty tracked rows) and in M (rows with
    no candidates), as tests/test_kernels.py puts them; with ``masked`` a
    sparse fp32 shrink mask and its re-aggregated cells."""
    rng = np.random.default_rng(seed)
    ident = -np.inf if maximize else np.inf
    S = rng.normal(size=(R, Din)).astype(np.float32)
    S[rng.choice(R, size=R // 8, replace=False)] = ident
    M = rng.normal(size=(R, Din)).astype(np.float32)
    M[rng.choice(R, size=R // 4, replace=False)] = ident
    W = rng.normal(size=(Din, Dout)).astype(np.float32)
    b = rng.normal(size=Dout).astype(np.float32)
    kw = {}
    if masked:
        mask = (rng.random((R, Din)) < 0.07).astype(np.float32)
        kw = dict(reagg=rng.normal(size=(R, Din)).astype(np.float32) * mask,
                  mask=mask)
    return (S, M, W, b), kw


@pytest.mark.parametrize("R,Din,Dout", EXTREMUM_SHAPES)
@pytest.mark.parametrize("maximize,relu", [(True, True), (False, True),
                                           (True, False)])
@pytest.mark.parametrize("masked", [False, True])
def test_extremum_apply_matches_pallas(R, Din, Dout, maximize, relu, masked):
    args, kw = _extremum_inputs(R, Din, Dout, maximize, masked)
    Sj, hj = jax_extremum_apply(*[jnp.asarray(a) for a in args],
                                **{k: jnp.asarray(v) for k, v in kw.items()},
                                maximize=maximize, relu=relu)
    before = extremum_apply.launches
    St, ht = extremum_apply(*_torch(args), **dict(zip(kw, _torch(kw.values()))),
                            maximize=maximize, relu=relu)
    assert extremum_apply.launches == before  # CPU tensors: plain version
    np.testing.assert_array_equal(St.numpy(), np.asarray(Sj))
    np.testing.assert_allclose(ht.numpy(), np.asarray(hj), **H_TOL)
    if masked:   # a bool mask is the same function as the fp32 one
        kw["mask"] = kw["mask"] != 0
        Sb, hb = extremum_apply(*_torch(args),
                                **dict(zip(kw, _torch(kw.values()))),
                                maximize=maximize, relu=relu)
        assert torch.equal(Sb, St) and torch.equal(hb, ht)


def test_wrappers_refuse_non_cpu_non_cuda_tensors():
    """Operands neither all on the CPU nor on a CUDA device are refused,
    never silently computed."""
    S, M, k, W, b = _torch(_delta_inputs(8, 4, 3), device="meta")
    with pytest.raises(ValueError, match="CUDA"):
        delta_apply(S, M, k, W, b)
    args = _torch(_mlp_inputs(8, 4, 5, 3), device="meta")
    with pytest.raises(ValueError, match="CUDA"):
        mlp_apply(*args)
    (S, M, W, b), _ = _extremum_inputs(8, 4, 3, True, False)
    with pytest.raises(ValueError, match="CUDA"):
        extremum_apply(*_torch((S, M, W, b), device="meta"))
    with pytest.raises(ValueError, match="together"):
        extremum_apply(*_torch((S, M, W, b)), reagg=_torch((S,))[0])
    assert delta_apply.launches == 0 and mlp_apply.launches == 0
    assert extremum_apply.launches == 0
