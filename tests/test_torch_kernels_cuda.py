"""The port's CUDA kernels against their plain PyTorch versions on a card,
at the shapes of tests/test_kernels.py plus a main-path shape, with its
bars (1e-5 on S', 1e-4 on h; extremum_apply's S' bit-equal; embedding_bag
1e-5 in fp32, 2e-2 in bf16; segment_mm 2e-5 in fp32, 2e-2 in bf16, and
1e-5 of the sum of the terms' magnitudes on a hub row; flash_attention
atol 1e-5 / rtol 1e-4 in fp32, 2e-2 in bf16, also at phi4-mini's prefill
shape and at ragged sequence lengths, on both of its routes: the wgmma
kernel bit-equal across launches).  Imports no JAX, so it runs where only
PyTorch is installed:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_kernels_cuda.py

Without a card every test skips: a CUDA kernel has no CPU mode."""
import numpy as np
import pytest
import torch

from repro_torch.kernels.delta_apply import delta_apply
from repro_torch.kernels.delta_apply.ref import delta_apply_ref
from repro_torch.kernels.embedding_bag import embedding_bag
from repro_torch.kernels.embedding_bag.ref import embedding_bag_ref
from repro_torch.kernels.extremum_apply import extremum_apply
from repro_torch.kernels.flash_attention import flash_attention
from repro_torch.kernels.flash_attention.ref import flash_attention_ref
from repro_torch.kernels.extremum_apply.ref import extremum_apply_ref
from repro_torch.kernels.mlp_apply import mlp_apply
from repro_torch.kernels.mlp_apply.ref import mlp_apply_ref
from repro_torch.kernels.segment_mm import (coo_to_csr, segment_mm,
                                            segment_mm_csr)
from repro_torch.kernels.segment_mm.ref import segment_mm_ref

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


@pytest.mark.cuda
@pytest.mark.parametrize("R,Din,Dout", [(64, 32, 16), (128, 128, 128),
                                        (33, 48, 7), (256, 64, 200),
                                        (4096, 128, 40)])
@pytest.mark.parametrize("maximize", [True, False])
@pytest.mark.parametrize("masked", [False, True])
def test_extremum_apply_kernel_on_card(cuda, R, Din, Dout, maximize, masked):
    """Identity (+/-inf) rows in S and M, as tests/test_kernels.py puts
    them; S' must be bit-equal to the plain version."""
    rng = np.random.default_rng(0)
    ident = -np.inf if maximize else np.inf
    S, M = _rand(rng, R, Din), _rand(rng, R, Din)
    S[rng.choice(R, size=max(R // 8, 1), replace=False)] = ident
    M[rng.choice(R, size=max(R // 4, 1), replace=False)] = ident
    W, b = _rand(rng, Din, Dout), _rand(rng, Dout)
    args = [torch.as_tensor(a, device=cuda) for a in (S, M, W, b)]
    kw = {}
    if masked:
        mask = rng.random((R, Din)) < 0.07
        RG = _rand(rng, R, Din) * mask
        kw = dict(reagg=torch.as_tensor(RG, device=cuda),
                  mask=torch.as_tensor(mask, device=cuda))
    before = extremum_apply.launches
    Sk, hk = extremum_apply(*args, **kw, maximize=maximize, relu=True)
    Sr, hr = extremum_apply_ref(*args, **kw, maximize=maximize, relu=True)
    torch.cuda.synchronize()
    assert extremum_apply.launches == before + 1
    assert torch.equal(Sk, Sr)
    torch.testing.assert_close(hk, hr, **H_TOL)
    if masked:   # the reference's fp32 mask form gives the same result
        kw["mask"] = kw["mask"].to(torch.float32)
        Sf, hf = extremum_apply(*args, **kw, maximize=maximize, relu=True)
        assert torch.equal(Sf, Sk) and torch.equal(hf, hk)


@pytest.mark.cuda
@pytest.mark.parametrize("V,B,hot,d", [(100, 8, 1, 16), (1000, 32, 4, 64),
                                       (5000, 16, 8, 128),
                                       (3000, 64, 4096, 128)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_embedding_bag_kernel_on_card(cuda, V, B, hot, d, dtype):
    """Long bags gather a relu'd table, as the engine gathers embeddings:
    a sum of thousands of signed terms can land near 0, where fp32
    rounding in any summation order exceeds a 1e-5 bar."""
    rng = np.random.default_rng(0)
    table = _rand(rng, V, d)
    if hot > 8:
        table = np.maximum(table, 0.0)
    table = torch.as_tensor(table, device=cuda).to(dtype)
    idx = torch.as_tensor(rng.integers(0, V, size=(B, hot)).astype(np.int32),
                          device=cuda)
    before = embedding_bag.launches
    out = embedding_bag(table, idx)
    ref = embedding_bag_ref(table, idx)
    torch.cuda.synchronize()
    assert embedding_bag.launches == before + 1
    assert out.dtype == dtype
    tol = 2e-2 if dtype == torch.bfloat16 else 1e-5
    torch.testing.assert_close(out.float(), ref.float(), atol=tol, rtol=tol)


@pytest.mark.cuda
@pytest.mark.parametrize("V,R,hot,d", [(64, 16, 8, 16), (200, 48, 12, 32),
                                       (1000, 33, 1500, 40)])
def test_embedding_bag_engine_pattern_on_card(cuda, V, R, hot, d):
    """Left-packed bags padded with sentinel V (a zero row) over a relu'd
    table: with and without padding_idx the kernel matches the plain
    version (1e-5)."""
    rng = np.random.default_rng(1)
    table = np.concatenate([np.maximum(_rand(rng, V, d), 0.0),
                            np.zeros((1, d), np.float32)])
    idx = np.full((R, hot), V, dtype=np.int32)
    for r, deg in enumerate(rng.integers(0, hot + 1, size=R)):
        idx[r, :deg] = rng.integers(0, V, size=deg)
    t, i = torch.as_tensor(table, device=cuda), torch.as_tensor(idx,
                                                                device=cuda)
    plain = embedding_bag_ref(t, i)
    outs = [embedding_bag(t, i, padding_idx=pad) for pad in (None, V)]
    torch.cuda.synchronize()
    for out in outs:
        torch.testing.assert_close(out, plain, atol=1e-5, rtol=1e-5)


@pytest.mark.cuda
def test_embedding_bag_refuses_what_the_kernel_does_not_take(cuda):
    """A CUDA operand of the wrong dtype, shape, layout or device raises;
    nothing falls back to the plain version."""
    table = torch.zeros(10, 8, device=cuda)
    idx = torch.zeros(4, 3, dtype=torch.int32, device=cuda)
    before = embedding_bag.launches
    with pytest.raises(TypeError):
        embedding_bag(table, idx.long())
    with pytest.raises(TypeError):
        embedding_bag(table.half(), idx)
    with pytest.raises(ValueError):
        embedding_bag(table, idx.reshape(-1))
    with pytest.raises(ValueError):
        embedding_bag(table.t(), idx)
    with pytest.raises(ValueError):
        embedding_bag(table.cpu(), idx)
    with pytest.raises(ValueError):
        embedding_bag(table, idx, padding_idx=10)
    assert embedding_bag.launches == before


def _graph(rng, n, m, hub=0):
    """m random edges over n vertices (some rows empty, some edges
    repeated), plus ``hub`` more into vertex 0."""
    src = rng.integers(0, n, size=m + hub)
    dst = np.concatenate([rng.integers(1, n, size=m), np.zeros(hub, int)])
    w = rng.uniform(0.5, 1.5, size=m + hub).astype(np.float32)
    return src, dst, w


@pytest.mark.cuda
@pytest.mark.parametrize("n,m,d", [(100, 400, 32), (257, 1500, 64),
                                   (64, 300, 128), (300, 2000, 16),
                                   (1000, 5000, 40)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_segment_mm_kernel_on_card(cuda, n, m, d, dtype):
    rng = np.random.default_rng(0)
    src, dst, w = _graph(rng, n, m)
    x = torch.as_tensor(_rand(rng, n, d), device=cuda).to(dtype)
    csr = coo_to_csr(src, dst, w, n, cuda)
    before = segment_mm.launches
    out = segment_mm_csr(csr, x)
    ref = segment_mm_ref(csr.col, csr.row, csr.w, x, n)
    again = segment_mm(src, dst, w, x, n)
    torch.cuda.synchronize()
    assert segment_mm.launches == before + 2
    assert out.dtype == dtype and torch.equal(out, again)
    assert torch.equal(out[0], torch.zeros_like(out[0]))   # no in-edges
    tol = 2e-2 if dtype == torch.bfloat16 else 2e-5
    torch.testing.assert_close(out.float(), ref.float(), atol=tol, rtol=tol)


@pytest.mark.cuda
@pytest.mark.parametrize("d", [128, 40])
def test_segment_mm_hub_row_on_card(cuda, d):
    """A row of 120,000 in-edges (the arxiv-scale hub) summed in spans:
    within 1e-5 of the sum of its terms' magnitudes, per cell, of the plain
    version, and the same bits in every run."""
    rng = np.random.default_rng(2)
    n = 5000
    src, dst, w = _graph(rng, n, 20000, hub=120_000)
    x = torch.as_tensor(_rand(rng, n, d), device=cuda)
    csr = coo_to_csr(src, dst, w, n, cuda)
    assert csr.long_rows.tolist() == [0] and csr.n_spans > 100
    out = segment_mm_csr(csr, x)
    ref = segment_mm_ref(csr.col, csr.row, csr.w, x, n)
    mag = segment_mm_ref(csr.col, csr.row, csr.w.abs(), x.abs(), n)
    torch.cuda.synchronize()
    assert bool(((out - ref).abs() <= 1e-5 * mag + 1e-30).all())
    assert torch.equal(segment_mm_csr(csr, x), out)


@pytest.mark.cuda
def test_segment_mm_refuses_what_the_kernel_does_not_take(cuda):
    rng = np.random.default_rng(3)
    src, dst, w = _graph(rng, 50, 200)
    csr = coo_to_csr(src, dst, w, 50, cuda)
    x = torch.zeros(50, 8, device=cuda)
    before = segment_mm.launches
    with pytest.raises(TypeError):
        segment_mm_csr(csr, x.half())
    with pytest.raises(ValueError):
        segment_mm_csr(csr, x.t())
    with pytest.raises(ValueError):
        segment_mm_csr(csr, x[:10])
    with pytest.raises(ValueError):
        segment_mm_csr(csr, x.cpu())
    with pytest.raises(ValueError):
        segment_mm_csr(coo_to_csr(src, dst, w, 50, "cpu"), x)
    assert segment_mm.launches == before


FLASH_TOL = {torch.float32: dict(atol=1e-5, rtol=1e-4),
             torch.bfloat16: dict(atol=2e-2, rtol=2e-2)}


@pytest.mark.cuda
@pytest.mark.parametrize("B,S,H,Hkv,Dh", [(2, 64, 4, 2, 16), (1, 128, 8, 8, 32),
                                          (2, 96, 6, 2, 8), (1, 256, 4, 1, 64),
                                          (2, 97, 6, 2, 16), (1, 200, 12, 2, 128),
                                          (4, 2048, 24, 8, 128),
                                          (4, 2079, 24, 8, 128)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_attention_kernel_on_card(cuda, B, S, H, Hkv, Dh, dtype):
    g = torch.Generator(device=cuda).manual_seed(S + Dh)
    q = torch.randn((B, S, H, Dh), generator=g, device=cuda).to(dtype)
    k = torch.randn((B, S, Hkv, Dh), generator=g, device=cuda).to(dtype)
    v = torch.randn((B, S, Hkv, Dh), generator=g, device=cuda).to(dtype)
    before = flash_attention.launches
    out = flash_attention(q, k, v)
    ref = flash_attention_ref(q, k, v)
    torch.cuda.synchronize()
    assert flash_attention.launches == before + 1
    assert out.dtype == dtype and out.shape == q.shape
    torch.testing.assert_close(out.float(), ref.float(), **FLASH_TOL[dtype])


@pytest.mark.cuda
def test_flash_attention_refuses_what_the_kernel_does_not_take(cuda):
    q = torch.zeros(1, 32, 4, 16, device=cuda)
    k = torch.zeros(1, 32, 2, 16, device=cuda)
    before = flash_attention.launches
    with pytest.raises(ValueError):            # not contiguous
        flash_attention(q.transpose(1, 2).contiguous().transpose(1, 2), k, k)
    with pytest.raises(TypeError):             # dtypes differ
        flash_attention(q, k.bfloat16(), k)
    with pytest.raises(TypeError):             # fp16 is not taken
        flash_attention(q.half(), k.half(), k.half())
    with pytest.raises(ValueError):            # head dim 24
        flash_attention(torch.zeros(1, 32, 4, 24, device=cuda),
                        torch.zeros(1, 32, 2, 24, device=cuda),
                        torch.zeros(1, 32, 2, 24, device=cuda))
    with pytest.raises(ValueError):            # 4 heads over 3 kv heads
        flash_attention(q, torch.zeros(1, 32, 3, 16, device=cuda),
                        torch.zeros(1, 32, 3, 16, device=cuda))
    with pytest.raises(ValueError):            # k on the CPU
        flash_attention(q, k.cpu(), k)
    assert flash_attention.launches == before


def _flash_inputs(cuda, seed, B, S, H, Hkv, Dh, dtype):
    g = torch.Generator(device=cuda).manual_seed(seed)
    return [torch.randn(shape, generator=g, device=cuda).to(dtype)
            for shape in ((B, S, H, Dh), (B, S, Hkv, Dh), (B, S, Hkv, Dh))]


@pytest.mark.cuda
@pytest.mark.parametrize("S", [1, 63, 65, 129, 2048, 2079])
@pytest.mark.parametrize("rep", [1, 2, 3, 4, 8])
@pytest.mark.parametrize("Dh", [64, 128])
def test_flash_attention_wgmma_route_on_card(cuda, S, rep, Dh):
    """bf16 at head dims 64 and 128 takes the wgmma kernel
    (flash_attention_sm90.cu): within FLASH_TOL of the plain version and
    the same bits in two launches.  More work items (128 query rows of one
    (b, head)) than the card has SMs, so persistent CTAs take several."""
    B, H = (1, 24) if S > 1024 else (2, 72)
    q, k, v = _flash_inputs(cuda, S + rep + Dh, B, S, H, H // rep, Dh,
                            torch.bfloat16)
    before = dict(flash_attention.launches_by_route)
    out, again = flash_attention(q, k, v), flash_attention(q, k, v)
    ref = flash_attention_ref(q, k, v)
    torch.cuda.synchronize()
    assert flash_attention.launches_by_route == {
        "wgmma": before["wgmma"] + 2, "mma": before["mma"]}
    assert B * H * -(-S // 128) > torch.cuda.get_device_properties(
        cuda).multi_processor_count
    assert torch.equal(out, again)
    torch.testing.assert_close(out.float(), ref.float(),
                               **FLASH_TOL[torch.bfloat16])


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,Dh", [(torch.bfloat16, 32),
                                      (torch.bfloat16, 8),
                                      (torch.float32, 128)])
def test_flash_attention_mma_route_on_card(cuda, dtype, Dh):
    """fp32, and bf16 below head dim 64, take the mma.sync / FMA kernel
    (flash_attention.cu), unchanged."""
    q, k, v = _flash_inputs(cuda, Dh, 2, 200, 6, 2, Dh, dtype)
    before = dict(flash_attention.launches_by_route)
    out = flash_attention(q, k, v)
    ref = flash_attention_ref(q, k, v)
    torch.cuda.synchronize()
    assert flash_attention.launches_by_route == {
        "wgmma": before["wgmma"], "mma": before["mma"] + 1}
    torch.testing.assert_close(out.float(), ref.float(), **FLASH_TOL[dtype])
