"""The port's CUDA kernels against their plain PyTorch versions on a card,
at the shapes of tests/test_kernels.py plus main-path shapes, with its
bars: 1e-5 on S' and 1e-4 on h; extremum_apply's S' bit-equal, on both of
its routes; embedding_bag 1e-5 in fp32 and 2e-2 in bf16; segment_mm 2e-5
in fp32 and 2e-2 in bf16, 1e-5 of the sum of the terms' magnitudes on a
hub row, bit-equal reruns, and its partition kernels equal to the plain
partition; flash_attention atol 1e-5 / rtol 1e-4 in fp32
and 2e-2 in bf16, also at phi4-mini's prefill shape and at ragged
sequence lengths, on both of its routes (the wgmma kernel bit-equal
across launches).  Imports no JAX, so it runs where only PyTorch is
installed:

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
from repro_torch.kernels.extremum_apply.ops import device_limits, kernel_plan
from repro_torch.kernels.flash_attention import flash_attention
from repro_torch.kernels.flash_attention.ref import flash_attention_ref
from repro_torch.kernels.extremum_apply.ref import extremum_apply_ref
from repro_torch.kernels.mlp_apply import mlp_apply
from repro_torch.kernels.mlp_apply.ref import mlp_apply_ref
from repro_torch.kernels.segment_mm import (coo_to_csr, segment_mm,
                                            segment_mm_csr)
from repro_torch.kernels.segment_mm.ops import EDGE_BUDGET, partition
from repro_torch.kernels.segment_mm.ref import partition_ref, segment_mm_ref

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
@pytest.mark.parametrize("R", [1, 33, 256, 4096, 65536])
@pytest.mark.parametrize("Din,Dout", [(48, 7), (48, 40), (48, 128), (48, 200),
                                      (512, 256)])
@pytest.mark.parametrize("masked", [True, False])
def test_extremum_apply_routes_on_card(cuda, R, Din, Dout, masked):
    """Both routes at the sessions' rungs and past them: one team or two,
    ragged tiles, passes of 128 columns (Dout 200), the K-chunked route
    for Dout 7 and for a W (512 x 256) that leaves no room beside a tile;
    the route taken is kernel_plan's.  S' bit-equal, h within 1e-4."""
    rng = np.random.default_rng(R + Din + Dout)
    S, M = _rand(rng, R, Din), _rand(rng, R, Din)
    S[rng.random(R) < 0.125] = -np.inf
    M[rng.random(R) < 0.25] = -np.inf
    W, b = _rand(rng, Din, Dout) / Din ** 0.5, _rand(rng, Dout)
    args = [torch.as_tensor(a, device=cuda) for a in (S, M, W, b)]
    kw = {}
    if masked:
        mask = rng.random((R, Din)) < 0.07
        kw = dict(reagg=torch.as_tensor(_rand(rng, R, Din) * mask,
                                        device=cuda),
                  mask=torch.as_tensor(mask, device=cuda))
    route = kernel_plan(R, Din, Dout, masked,
                        *device_limits(cuda.index or 0))["route"]
    before = dict(extremum_apply.launches_by_route)
    Sk, hk = extremum_apply(*args, **kw, maximize=True, relu=True)
    Sr, hr = extremum_apply_ref(*args, **kw, maximize=True, relu=True)
    torch.cuda.synchronize()
    assert {r: n - before[r] for r, n in
            extremum_apply.launches_by_route.items() if n != before[r]} \
        == {route: 1}
    assert route == ("kchunk" if Dout % 4 or Din * Dout > 100_000
                     else "resident")
    assert torch.equal(Sk, Sr)
    torch.testing.assert_close(hk, hr, **H_TOL)


@pytest.mark.cuda
def test_extremum_apply_unaligned_operand_takes_kchunk_on_card(cuda):
    """An operand that is not 16-byte aligned (a view one float in) cannot
    be bulk-copied: the K-chunked route takes it, with the same bits."""
    rng = np.random.default_rng(4)
    R, Din, Dout = 4096, 128, 128
    S, M = _rand(rng, R, Din), _rand(rng, R, Din)
    W, b = _rand(rng, Din, Dout) / Din ** 0.5, _rand(rng, Dout)
    args = [torch.as_tensor(a, device=cuda) for a in (S, M, W, b)]
    shifted = torch.empty(R * Din + 1, device=cuda)[1:].view(R, Din)
    shifted.copy_(args[0])
    before = dict(extremum_apply.launches_by_route)
    Sa, ha = extremum_apply(*args, maximize=False, relu=False)
    Sb, hb = extremum_apply(shifted, *args[1:], maximize=False, relu=False)
    torch.cuda.synchronize()
    assert extremum_apply.launches_by_route["resident"] \
        == before["resident"] + 1
    assert extremum_apply.launches_by_route["kchunk"] == before["kchunk"] + 1
    assert torch.equal(Sa, Sb) and torch.equal(ha, hb)


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
    """A row of 120,000 in-edges (the arxiv-scale hub) summed in chunks:
    within 1e-5 of the sum of its terms' magnitudes, per cell, of the plain
    version, and the same bits in every run."""
    rng = np.random.default_rng(2)
    n = 5000
    src, dst, w = _graph(rng, n, 20000, hub=120_000)
    x = torch.as_tensor(_rand(rng, n, d), device=cuda)
    csr = coo_to_csr(src, dst, w, n, cuda)
    assert csr.long_rows.tolist() == [0] and csr.n_chunks > 100
    out = segment_mm_csr(csr, x)
    ref = segment_mm_ref(csr.col, csr.row, csr.w, x, n)
    mag = segment_mm_ref(csr.col, csr.row, csr.w.abs(), x.abs(), n)
    torch.cuda.synchronize()
    assert bool(((out - ref).abs() <= 1e-5 * mag + 1e-30).all())
    assert torch.equal(segment_mm_csr(csr, x), out)


@pytest.mark.cuda
@pytest.mark.parametrize("d", [4, 40, 128, 130])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_segment_mm_lane_groups_and_budget_rows_on_card(cuda, d, dtype):
    """Rows of budget - 1, budget, budget + 1 and 2 budget + 1 edges, empty
    rows and a hub, at widths that fill lane groups of 1, 10 and 32 lanes
    (fp32; bf16 halves them) and a ragged one (130: masked scalar loads, a
    second column tile): against the plain version, the same bits in a
    rerun, and the same bits again from an x that is not 16-byte aligned
    (the scalar path sums in the same order).  Bars: bf16 2e-2; fp32 1e-5
    of the sum of the terms' magnitudes, as for the hub row."""
    rng = np.random.default_rng(d)
    n, budget = 700, EDGE_BUDGET
    degs = rng.integers(0, 9, n)
    degs[[5, 6, 7, 8, 9]] = [budget - 1, budget, budget + 1, 2 * budget + 1,
                             0]
    degs[100] = 5000
    dst = np.repeat(np.arange(n), degs)
    src = rng.integers(0, n, dst.size)
    perm = rng.permutation(dst.size)
    src, dst = src[perm], dst[perm]
    w = rng.uniform(0.5, 1.5, dst.size).astype(np.float32)
    x = torch.as_tensor(_rand(rng, n, d), device=cuda).to(dtype)
    csr = coo_to_csr(src, dst, w, n, cuda)
    assert csr.long_rows.tolist() == [7, 8, 100]
    out, again = segment_mm_csr(csr, x), segment_mm_csr(csr, x)
    shifted = torch.empty(n * d + 1, dtype=dtype, device=cuda)[1:].view(n, d)
    shifted.copy_(x)
    scalar = segment_mm_csr(csr, shifted)
    ref = segment_mm_ref(csr.col, csr.row, csr.w, x, n)
    torch.cuda.synchronize()
    assert torch.equal(out, again) and torch.equal(out, scalar)
    assert torch.equal(out[9], torch.zeros_like(out[9]))
    if dtype == torch.bfloat16:
        torch.testing.assert_close(out.float(), ref.float(), atol=2e-2,
                                   rtol=2e-2)
    else:   # the hub's 5,000 terms: the reordered-sum bar of the hub test
        mag = segment_mm_ref(csr.col, csr.row, csr.w.abs(), x.abs(), n)
        assert bool(((out - ref).abs() <= 1e-5 * mag + 1e-30).all())


def _in_degrees(case):
    """In-degree patterns the partition must cut: (counts, budget)."""
    rng = np.random.default_rng(7)
    b = 8
    return {
        "empty_rows": (np.zeros(21, np.int64), 4),
        "no_rows": (np.zeros(0, np.int64), 4),
        "budget_exactly": (np.array([b, 0, 1, b, b - 1, 2]), b),
        "budget_plus_one": (np.array([1, b + 1, 0, b + 1, b + 1]), b),
        "hub": (np.concatenate([rng.integers(0, 5, 300), [5000],
                                rng.integers(0, 5, 300)]), 64),
        "budget_one": (np.array([0, 1, 2, 0, 3, 1]), 1),
        "runs_capped_by_rows": (np.array([0] * 40 + [1] * 30 + [0] * 9), 8),
        "arxiv_like": (np.minimum(rng.zipf(1.8, 169_343), 120_486),
                       EDGE_BUDGET),
    }[case]


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["empty_rows", "no_rows", "budget_exactly",
                                  "budget_plus_one", "hub", "budget_one",
                                  "runs_capped_by_rows", "arxiv_like"])
def test_partition_kernels_match_plain_on_card(cuda, case):
    """The partition's two kernels give the plain version's work items,
    entry for entry and in its order, and count one call."""
    counts, budget = _in_degrees(case)
    rowptr = torch.as_tensor(np.concatenate([[0], np.cumsum(counts)]))
    before = partition.launches
    got = partition(rowptr.to(cuda), budget)
    want = partition_ref(rowptr, budget)
    assert partition.launches == before + 1
    assert got[3] == want[3]
    for g, r in zip(got[:3], want[:3]):
        assert g.device.type == "cuda" and g.dtype == torch.int32
        assert torch.equal(g.cpu(), r)


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
