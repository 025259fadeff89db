"""The port's kernel wrappers against the JAX package's Pallas kernels (run
in interpret mode, as tests/test_kernels.py runs them), at that file's
shapes and bars: 1e-5 on S', 1e-4 on h.

On the CPU a wrapper takes its kernel's plain version, so these tests
check the arithmetic every kernel must reproduce; the CUDA kernels are
held against the same plain versions on the card
(tests/test_torch_kernels_cuda.py and ``chip_smoke.py``)."""
import numpy as np
import pytest

import jax.numpy as jnp
import torch

from repro.kernels.delta_apply import delta_apply as jax_delta_apply
from repro.kernels.mlp_apply import mlp_apply as jax_mlp_apply

from repro_torch.kernels.delta_apply import delta_apply
from repro_torch.kernels.mlp_apply import mlp_apply

S_TOL = dict(atol=1e-5, rtol=1e-5)
H_TOL = dict(atol=1e-4, rtol=1e-4)
DELTA_SHAPES = [(64, 32, 16), (128, 128, 128), (33, 48, 7), (256, 64, 200)]
MLP_SHAPES = [(64, 32, 32, 16), (128, 128, 128, 128), (33, 48, 20, 7)]


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


def test_wrappers_refuse_non_cpu_non_cuda_tensors():
    """Operands neither all on the CPU nor on a CUDA device are refused,
    never silently computed."""
    S, M, k, W, b = _torch(_delta_inputs(8, 4, 3), device="meta")
    with pytest.raises(ValueError, match="CUDA"):
        delta_apply(S, M, k, W, b)
    args = _torch(_mlp_inputs(8, 4, 5, 3), device="meta")
    with pytest.raises(ValueError, match="CUDA"):
        mlp_apply(*args)
    assert delta_apply.launches == 0 and mlp_apply.launches == 0
