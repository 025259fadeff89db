"""The port's CUDA kernels against their plain PyTorch versions on a card,
at the shapes of tests/test_kernels.py plus a main-path shape, with its
bars (1e-5 on S', 1e-4 on h).  Imports no JAX, so it runs where only
PyTorch is installed:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_kernels_cuda.py

Without a card every test skips: a CUDA kernel has no CPU mode."""
import numpy as np
import pytest
import torch

from repro_torch.kernels.delta_apply import delta_apply
from repro_torch.kernels.delta_apply.ref import delta_apply_ref
from repro_torch.kernels.mlp_apply import mlp_apply
from repro_torch.kernels.mlp_apply.ref import mlp_apply_ref

S_TOL = dict(atol=1e-5, rtol=1e-5)
H_TOL = dict(atol=1e-4, rtol=1e-4)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    return torch.device("cuda")


def _rand(rng, *shape):
    return rng.normal(size=shape).astype(np.float32)


@pytest.mark.cuda
@pytest.mark.parametrize("R,Din,Dout", [(64, 32, 16), (128, 128, 128),
                                        (33, 48, 7), (256, 64, 200),
                                        (4096, 128, 40)])
@pytest.mark.parametrize("mean,relu", [(False, True), (True, False)])
def test_delta_apply_kernel_on_card(cuda, R, Din, Dout, mean, relu):
    rng = np.random.default_rng(0)
    args = [torch.as_tensor(a, device=cuda) for a in (
        _rand(rng, R, Din), _rand(rng, R, Din),
        rng.integers(0, 6, size=R).astype(np.float32),
        _rand(rng, Din, Dout), _rand(rng, Dout))]
    before = delta_apply.launches
    Sk, hk = delta_apply(*args, mean=mean, relu=relu)
    Sr, hr = delta_apply_ref(*args, mean=mean, relu=relu)
    torch.cuda.synchronize()
    assert delta_apply.launches == before + 1
    torch.testing.assert_close(Sk, Sr, **S_TOL)
    torch.testing.assert_close(hk, hr, **H_TOL)


@pytest.mark.cuda
@pytest.mark.parametrize("R,Din,Dh,Dout", [(64, 32, 32, 16),
                                           (128, 128, 128, 128),
                                           (33, 48, 20, 7),
                                           (4096, 128, 40, 40)])
@pytest.mark.parametrize("mean,relu", [(False, True), (True, False)])
def test_mlp_apply_kernel_on_card(cuda, R, Din, Dh, Dout, mean, relu):
    rng = np.random.default_rng(0)
    t = [torch.as_tensor(a, device=cuda) for a in (
        _rand(rng, R, Din), _rand(rng, R, Din), _rand(rng, R, Din),
        rng.integers(0, 6, size=R).astype(np.float32),
        _rand(rng, Din, Dh), _rand(rng, Dh), _rand(rng, Dh, Dout),
        _rand(rng, Dout))]
    args = t[:4] + [0.37] + t[4:]
    before = mlp_apply.launches
    Sk, hk = mlp_apply(*args, mean=mean, relu=relu)
    Sr, hr = mlp_apply_ref(*args, mean=mean, relu=relu)
    torch.cuda.synchronize()
    assert mlp_apply.launches == before + 1
    torch.testing.assert_close(Sk, Sr, **S_TOL)
    torch.testing.assert_close(hk, hr, **H_TOL)


@pytest.mark.cuda
def test_mlp_apply_refuses_widths_beyond_shared_memory(cuda):
    R, Din, Dh = 32, 1024, 1024   # z + h1 tiles: 32 x 2049 x 4 B > 227 KB
    z = torch.zeros(R, Din, device=cuda)
    k = torch.zeros(R, device=cuda)
    W1 = torch.zeros(Din, Dh, device=cuda)
    b1 = torch.zeros(Dh, device=cuda)
    with pytest.raises(ValueError, match="shared memory"):
        mlp_apply(z, z, z, k, 0.0, W1, b1, W1, b1)
