"""The port's causal grouped-query attention (``repro_torch.kernels.
flash_attention``) against the reference's: its plain version against the
JAX Pallas kernel (interpret mode) on the shapes and bars of
tests/test_kernels.py (bf16 atol/rtol 2e-2; fp32 atol 1e-5, rtol 1e-4)
and at prompt lengths that are no multiple of the CUDA kernel's tiles;
the port's ``models.lm.model.causal_attention`` against the reference's
chunked one; the CPU route of the wrapper; and the route function that
picks, before any launch, which of the two CUDA kernels a CUDA call takes.
The CUDA kernels themselves are held to this plain version on a card
(tests/test_torch_kernels_cuda.py)."""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from repro.kernels.flash_attention import flash_attention as jax_flash
from repro.models.lm.config import LMConfig as JaxLMConfig
from repro.models.lm.model import causal_attention as jax_causal_attention
from repro_torch.kernels.flash_attention import flash_attention
from repro_torch.kernels.flash_attention.ops import kernel_route
from repro_torch.kernels.flash_attention.ref import flash_attention_ref
from repro_torch.models.lm.config import LMConfig
from repro_torch.models.lm.model import causal_attention

BARS = {"float32": dict(atol=1e-5, rtol=1e-4),
        "bfloat16": dict(atol=2e-2, rtol=2e-2)}
# tests/test_kernels.py's shapes, then prompt lengths that are no multiple
# of the CUDA kernel's 16-row and 32/64-key tiles (the Pallas kernel takes
# them as one block of 100, or as blocks of 40)
SHAPES = [(2, 64, 4, 2, 16, 16, 16), (1, 128, 8, 8, 32, 32, 64),
          (2, 96, 6, 2, 8, 32, 32), (1, 256, 4, 1, 64, 64, 128),
          (1, 100, 6, 2, 32, 128, 128), (2, 200, 4, 2, 16, 40, 40)]


def _qkv(seed, B, S, H, Hkv, Dh):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(B, S, H, Dh)).astype(np.float32),
            rng.normal(size=(B, S, Hkv, Dh)).astype(np.float32),
            rng.normal(size=(B, S, Hkv, Dh)).astype(np.float32))


def _f32(x) -> np.ndarray:
    return np.asarray(x.float() if isinstance(x, torch.Tensor) else x,
                      np.float32)


@pytest.mark.parametrize("B,S,H,Hkv,Dh,bq,bkv", SHAPES)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_ref_matches_pallas_kernel(B, S, H, Hkv, Dh, bq, bkv, dtype):
    arrays = _qkv(S + Dh, B, S, H, Hkv, Dh)
    want = jax_flash(*(jnp.asarray(a, getattr(jnp, dtype)) for a in arrays),
                     bq=bq, bkv=bkv)
    got = flash_attention_ref(*(torch.as_tensor(a).to(getattr(torch, dtype))
                                for a in arrays))
    assert got.dtype == getattr(torch, dtype)
    np.testing.assert_allclose(_f32(got), _f32(want), **BARS[dtype])


@pytest.mark.parametrize("S,H,Hkv,Dh,chunk", [(64, 4, 2, 16, 32),
                                               (24, 6, 2, 8, 16),
                                               (33, 6, 2, 8, 16)])
def test_causal_attention_matches_model_attention(S, H, Hkv, Dh, chunk):
    """tests/test_kernels.py::test_flash_matches_model_attention with the
    port's ``causal_attention`` (the kernel wrapper, so its plain version
    on the CPU) in place of the kernel, and at sequences that are no
    multiple of the chunk, which the reference pads to whole chunks."""
    fields = dict(name="t", n_layers=1, d_model=64, n_heads=H, n_kv_heads=Hkv,
                  d_ff=64, vocab=32, d_head=Dh, attn_chunk=chunk)
    q, k, v = _qkv(S, 2, S, H, Hkv, Dh)
    want = jax_causal_attention(jnp.asarray(q), jnp.asarray(k),
                                jnp.asarray(v), JaxLMConfig(**fields))
    got = causal_attention(*map(torch.as_tensor, (q, k, v)),
                           LMConfig(**fields))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5,
                               rtol=1e-4)


def test_causal_attention_takes_the_square_case_only():
    cfg = LMConfig(name="t", n_layers=1, d_model=64, n_heads=4, n_kv_heads=2,
                   d_ff=64, vocab=32, d_head=16)
    q, k, v = map(torch.as_tensor, _qkv(1, 1, 8, 4, 2, 16))
    with pytest.raises(NotImplementedError):
        causal_attention(q, k, v, cfg, q_offset=2)
    with pytest.raises(NotImplementedError):
        causal_attention(q[:, :4], k, v, cfg)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_cpu_wrapper_routes_to_ref(dtype):
    q, k, v = (torch.as_tensor(a).to(dtype) for a in _qkv(3, 2, 40, 6, 3, 16))
    before = flash_attention.launches
    out = flash_attention(q, k, v)
    assert flash_attention.launches == before   # a CPU call launches nothing
    assert torch.equal(out, flash_attention_ref(q, k, v))


def test_ref_is_causal():
    """Changing a later key or value leaves every earlier row unchanged."""
    q, k, v = map(torch.as_tensor, _qkv(5, 1, 32, 4, 2, 16))
    base = flash_attention_ref(q, k, v)
    k2, v2 = k.clone(), v.clone()
    k2[:, 20:] += 1.0
    v2[:, 20:] -= 2.0
    moved = flash_attention_ref(q, k2, v2)
    assert torch.equal(moved[:, :20], base[:, :20])
    assert not torch.equal(moved[:, 20:], base[:, 20:])


@pytest.mark.parametrize("Dh", [64, 128])
def test_cpu_wrapper_routes_to_ref_at_wgmma_head_dims(Dh):
    """bf16 at the head dims whose CUDA route is the wgmma kernel: on the
    CPU the wrapper still takes the plain version and launches nothing."""
    q, k, v = (torch.as_tensor(a).to(torch.bfloat16)
               for a in _qkv(4, 1, 70, 6, 2, Dh))
    launches = flash_attention.launches
    by_route = dict(flash_attention.launches_by_route)
    out = flash_attention(q, k, v)
    assert flash_attention.launches == launches
    assert flash_attention.launches_by_route == by_route
    assert torch.equal(out, flash_attention_ref(q, k, v))


# (H, Hkv): rep = H / Hkv of 1, 2, 3, 4 and 8, then query heads that do not
# group over the kv heads
GROUPS = [(8, 8), (8, 4), (24, 8), (8, 2), (16, 2), (6, 4), (4, 0)]


@pytest.mark.parametrize("H,Hkv", GROUPS)
@pytest.mark.parametrize("Dh", [8, 16, 24, 32, 48, 64, 128, 256])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16,
                                   torch.float16])
def test_kernel_route(dtype, Dh, H, Hkv):
    """bf16 at head dims 64 and 128 takes the wgmma kernel; fp32 at every
    head dim of 8, 16, 32, 64, 128 and bf16 at 8, 16, 32 the mma kernel;
    any other dtype, head dim or grouping is refused before a launch."""
    if dtype not in (torch.float32, torch.bfloat16):
        with pytest.raises(TypeError):
            kernel_route(dtype, Dh, H, Hkv)
    elif Dh not in (8, 16, 32, 64, 128) or Hkv == 0 or H % Hkv:
        with pytest.raises(ValueError):
            kernel_route(dtype, Dh, H, Hkv)
    else:
        wgmma = dtype == torch.bfloat16 and Dh in (64, 128)
        assert kernel_route(dtype, Dh, H, Hkv) == ("wgmma" if wgmma
                                                   else "mma")
