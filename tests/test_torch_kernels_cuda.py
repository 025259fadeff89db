"""The port's CUDA kernels against their plain PyTorch versions on a card,
at the shapes of tests/test_kernels.py plus main-path shapes, with its
bars: 1e-5 on S' and 1e-4 on h; extremum_apply's S' bit-equal, on both of
its routes; delta_apply's and mlp_apply's S' bit-equal and reruns
bit-equal on both routes (resident and tiled), at ragged row counts;
embedding_bag 1e-5 in fp32 and 2e-2 in bf16 on both routes (narrow and
span), reruns and the two routes bit-equal on bags of one span, a
one-lane bag bit-equal to its row, each route counted; segment_mm 2e-5
in fp32 and 2e-2 in bf16, 1e-5 of the sum of the terms' magnitudes on a
hub row, bit-equal reruns, and its partition kernels equal to the plain
partition; embedding_bag's one-lane bags over DLRM-sized tables (past
2^23 rows) equal to the plain version; flash_attention atol 1e-5 / rtol
1e-4 in fp32 and 2e-2 in bf16, also at phi4-mini's prefill shape, at
olmoe's MHA grouping and at ragged sequence lengths, on both of its
routes (the wgmma kernel bit-equal across launches); the gradients of
``FlashAttentionFn`` (6 query heads a kv head among the shapes) and
``EmbeddingBagFn`` against autograd of the plain versions; the
``embedding_bag`` custom op launching the kernel, its FLOPs counted; and a
small ``dist`` session at world size 1 over NCCL against the full pass.  Imports no JAX, so it runs where only PyTorch is
installed:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_kernels_cuda.py

Without a card every test skips: a CUDA kernel has no CPU mode."""
import numpy as np
import pytest
import torch

from repro_torch.kernels.delta_apply import delta_apply
from repro_torch.kernels.delta_apply import ops as delta_ops
from repro_torch.kernels.delta_apply.ref import delta_apply_ref
from repro_torch.kernels.embedding_bag import embedding_bag
from repro_torch.kernels.embedding_bag import ops as bag_ops
from repro_torch.kernels.embedding_bag.ref import embedding_bag_ref
from repro_torch.kernels.extremum_apply import extremum_apply
from repro_torch.kernels.extremum_apply.ops import device_limits, kernel_plan
from repro_torch.kernels.flash_attention import flash_attention
from repro_torch.kernels.flash_attention.ref import flash_attention_ref
from repro_torch.kernels.extremum_apply.ref import extremum_apply_ref
from repro_torch.kernels.mlp_apply import mlp_apply
from repro_torch.kernels.mlp_apply import ops as mlp_ops
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


def _counted(counts: dict, before: dict) -> dict:
    return {r: n - before[r] for r, n in counts.items() if n != before[r]}


def _held(fn, S_ref, h_ref):
    """Run ``fn`` (which returns S', h) twice: S' bit-equal to the plain
    version, h within 1e-4, the second run bit-equal to the first."""
    S1, h1 = fn()
    S2, h2 = fn()
    torch.cuda.synchronize()
    assert torch.equal(S1, S_ref)
    torch.testing.assert_close(h1, h_ref, **H_TOL)
    assert torch.equal(S1, S2) and torch.equal(h1, h2)


MEAN_RELU = [(False, True), (True, False), (True, True), (False, False)]


@pytest.mark.cuda
@pytest.mark.parametrize("R", [1, 33, 257, 4097])
@pytest.mark.parametrize("Dout", [40, 128])
@pytest.mark.parametrize("mean,relu", MEAN_RELU)
def test_delta_apply_routes_on_card(cuda, R, Dout, mean, relu):
    """The wrapper takes kernel_plan's route (resident at these widths) and
    counts it; then each route is launched on its own (ops.launch, the
    tiled route forced).  Every route: S' bit-equal, h within 1e-4, reruns
    bit-equal."""
    rng = np.random.default_rng(R + Dout)
    Din = 128
    k = rng.integers(0, 6, size=R).astype(np.float32)
    args = [torch.as_tensor(a, device=cuda) for a in (
        _rand(rng, R, Din), _rand(rng, R, Din), k,
        _rand(rng, Din, Dout) / Din ** 0.5, _rand(rng, Dout))]
    Sr, hr = delta_apply_ref(*args, mean=mean, relu=relu)
    plan = delta_ops.kernel_plan(R, Din, Dout,
                                 *delta_ops.device_limits(cuda.index or 0))
    assert plan["route"] == "resident"
    before = dict(delta_apply.launches_by_route)
    _held(lambda: delta_apply(*args, mean=mean, relu=relu), Sr, hr)
    assert _counted(delta_apply.launches_by_route, before) \
        == {plan["route"]: 2}
    for forced in (plan, {"route": "tiled"}):
        def run():
            S_new = torch.empty_like(args[0])
            h = torch.empty((R, Dout), device=cuda)
            delta_ops.launch(forced, *args, S_new, h, mean=mean, relu=relu)
            return S_new, h
        _held(run, Sr, hr)


@pytest.mark.cuda
@pytest.mark.parametrize("R", [1, 33, 257, 4097])
@pytest.mark.parametrize("Dh,Dout", [(40, 40), (128, 40), (128, 128)])
@pytest.mark.parametrize("mean,relu", MEAN_RELU)
def test_mlp_apply_routes_on_card(cuda, R, Dh, Dout, mean, relu):
    """The wrapper takes kernel_plan's route (resident at these widths)
    and counts it; then each route is launched on its own (ops.launch, the
    tiled route forced).  Every route: S' bit-equal, h within 1e-4, reruns
    bit-equal."""
    rng = np.random.default_rng(R + Dh + Dout)
    Din = 128
    t = [torch.as_tensor(a, device=cuda) for a in (
        _rand(rng, R, Din), _rand(rng, R, Din), _rand(rng, R, Din),
        rng.integers(0, 6, size=R).astype(np.float32),
        _rand(rng, Din, Dh) / Din ** 0.5, _rand(rng, Dh),
        _rand(rng, Dh, Dout) / Dh ** 0.5, _rand(rng, Dout))]
    args = t[:4] + [0.37] + t[4:]
    Sr, hr = mlp_apply_ref(*args, mean=mean, relu=relu)
    index = cuda.index or 0
    plan = mlp_ops.kernel_plan(R, Din, Dh, Dout,
                               *mlp_ops.device_limits(index))
    assert plan["route"] == "resident"
    before = dict(mlp_apply.launches_by_route)
    _held(lambda: mlp_apply(*args, mean=mean, relu=relu), Sr, hr)
    assert _counted(mlp_apply.launches_by_route, before) \
        == {plan["route"]: 2}
    for forced in (plan, {"route": "tiled"}):
        def run():
            S_new = torch.empty_like(t[0])
            h = torch.empty((R, Dout), device=cuda)
            mlp_ops.launch(forced, *args, S_new, h, mean=mean, relu=relu)
            return S_new, h
        _held(run, Sr, hr)


@pytest.mark.cuda
def test_hop_kernels_unaligned_operand_takes_tiled_on_card(cuda):
    """An operand that is not 16-byte aligned (a view one float in) cannot
    be bulk-copied: delta_apply and mlp_apply take their tiled routes,
    S' with the same bits as on the aligned operands' resident routes."""
    rng = np.random.default_rng(5)
    R, Din, D = 257, 128, 128
    S, M, hp = (torch.as_tensor(_rand(rng, R, Din), device=cuda)
                for _ in range(3))
    k = torch.as_tensor(rng.integers(0, 6, size=R).astype(np.float32),
                        device=cuda)
    W = torch.as_tensor(_rand(rng, Din, D) / Din ** 0.5, device=cuda)
    b = torch.as_tensor(_rand(rng, D), device=cuda)
    shifted = torch.empty(R * Din + 1, device=cuda)[1:].view(R, Din)
    shifted.copy_(S)
    for fn, args in ((delta_apply, (M, k, W, b)),
                     (mlp_apply, (M, hp, k, 0.37, W, b, W, b))):
        before = dict(fn.launches_by_route)
        Sa, ha = fn(S, *args, mean=True, relu=True)
        Sb, hb = fn(shifted, *args, mean=True, relu=True)
        torch.cuda.synchronize()
        moved = _counted(fn.launches_by_route, before)
        assert moved["tiled"] == 1 and sum(moved.values()) == 2
        assert torch.equal(Sa, Sb)
        torch.testing.assert_close(hb, ha, **H_TOL)


@pytest.mark.cuda
@pytest.mark.parametrize("R", [65536])
@pytest.mark.parametrize("Dh,Dout", [(40, 40), (128, 128)])
def test_hop_kernels_many_tiles_on_card(cuda, R, Dh, Dout):
    """Past one wave: delta_apply's two teams a CTA and mlp_apply's two
    stages a CTA, persistent over many tiles; bit-equal S', reruns
    bit-equal."""
    rng = np.random.default_rng(Dh)
    Din = 128
    S, M, hp = (torch.as_tensor(_rand(rng, R, Din), device=cuda)
                for _ in range(3))
    k = torch.as_tensor(rng.integers(0, 6, size=R).astype(np.float32),
                        device=cuda)
    W = torch.as_tensor(_rand(rng, Din, Dout) / Din ** 0.5, device=cuda)
    b = torch.as_tensor(_rand(rng, Dout), device=cuda)
    Sr, hr = delta_apply_ref(S, M, k, W, b, mean=True, relu=True)
    _held(lambda: delta_apply(S, M, k, W, b, mean=True, relu=True), Sr, hr)
    W1 = torch.as_tensor(_rand(rng, Din, Dh) / Din ** 0.5, device=cuda)
    b1 = torch.as_tensor(_rand(rng, Dh), device=cuda)
    W2 = torch.as_tensor(_rand(rng, Dh, Dout) / Dh ** 0.5, device=cuda)
    args = (S, M, hp, k, 0.37, W1, b1, W2, b)
    Sr, hr = mlp_apply_ref(*args, mean=True, relu=True)
    _held(lambda: mlp_apply(*args, mean=True, relu=True), Sr, hr)


@pytest.mark.cuda
@pytest.mark.parametrize("Din,Dh,Dout", [(128, 128, 128), (128, 40, 40),
                                         (48, 200, 7), (64, 96, 200)])
@pytest.mark.parametrize("rows,ns", [(8, 1), (16, 2), (32, 2)])
def test_mlp_apply_shared_memory_plan_matches_kernel_on_card(cuda, Din, Dh,
                                                              Dout, rows, ns):
    """ops.resident_smem, which kernel_plan tiles with, is what the
    kernel's MlpPlan lays out."""
    assert mlp_ops.resident_smem(Din, Dh, Dout, rows, ns) \
        == mlp_ops._lib().mlp_apply_resident_smem(Din, Dh, Dout, rows, ns)


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
@pytest.mark.parametrize("padding_idx", [None, 7])
def test_embedding_bag_custom_op_launches_the_kernel_on_card(cuda,
                                                             padding_idx):
    """``torch.ops.repro_torch.embedding_bag`` on CUDA tensors launches the
    kernel once (its narrow route at one lane a bag, DLRM's) and equals
    the plain version; ``FlopCounterMode`` counts its formula, B hot d."""
    from torch.utils.flop_counter import FlopCounterMode
    rng = np.random.default_rng(2)
    table = torch.as_tensor(_rand(rng, 1000, 64), device=cuda)
    idx = torch.as_tensor(rng.integers(0, 1000, size=(512, 1))
                          .astype(np.int32), device=cuda)
    idx[:3] = 7
    before = embedding_bag.launches
    narrow = embedding_bag.launches_by_route["narrow"]
    with FlopCounterMode(display=False) as counter:
        out = torch.ops.repro_torch.embedding_bag(table, idx, padding_idx)
    torch.cuda.synchronize()
    assert embedding_bag.launches == before + 1
    assert embedding_bag.launches_by_route["narrow"] == narrow + 1
    assert counter.get_total_flops() == 512 * 1 * 64
    torch.testing.assert_close(out, embedding_bag_ref(table, idx,
                                                      padding_idx),
                               atol=1e-5, rtol=1e-5)


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
@pytest.mark.parametrize("V,B", [(10_000_128, 4096), ((1 << 23) + 5, 512)])
def test_embedding_bag_one_lane_over_a_large_table_on_card(cuda, V, B):
    """DLRM's bags: one lane each, over tables past 2^23 rows (RM2's
    largest holds 10,000,128), ids reaching both ends of the table: equal
    to the plain version, which is one row each."""
    g = torch.Generator(device=cuda).manual_seed(V)
    table = torch.randn((V, 64), generator=g, device=cuda)
    idx = torch.randint(0, V, (B, 1), generator=g, device=cuda,
                        dtype=torch.int32)
    idx[0, 0], idx[1, 0] = 0, V - 1
    before = embedding_bag.launches
    out = embedding_bag(table, idx)
    ref = embedding_bag_ref(table, idx)
    torch.cuda.synchronize()
    assert embedding_bag.launches == before + 1
    assert torch.equal(out, ref)
    assert torch.equal(out[1], table[V - 1])


def _bag_case(rng, cuda, V, B, hot, d, dtype, pad_share=0.0):
    """A table and [B, hot] ids; with pad_share, that share of the lanes
    is the padding row V (a zero row appended to the table)."""
    table = np.concatenate([_rand(rng, V, d), np.zeros((1, d), np.float32)])
    idx = rng.integers(0, V, size=(B, hot)).astype(np.int32)
    idx[rng.random((B, hot)) < pad_share] = V
    return (torch.as_tensor(table, device=cuda).to(dtype),
            torch.as_tensor(idx, device=cuda))


def _bag_held(table, idx, pad, route, plan):
    """The wrapper takes ``route`` (kernel_plan's) and counts it; within
    1e-5 (fp32) or 2e-2 (bf16) of the plain version, a rerun bit-equal,
    and ``plan`` launched through ops.launch bit-equal to the wrapper
    (both routes sum a bag of one span in the same order)."""
    before = dict(embedding_bag.launches_by_route)
    out = embedding_bag(table, idx, padding_idx=pad)
    again = embedding_bag(table, idx, padding_idx=pad)
    forced = torch.empty_like(out)
    bag_ops.launch(plan, table, idx, forced, pad)
    ref = embedding_bag_ref(table, idx, pad)
    torch.cuda.synchronize()
    assert _counted(embedding_bag.launches_by_route, before) == {route: 2}
    tol = 2e-2 if table.dtype == torch.bfloat16 else 1e-5
    torch.testing.assert_close(out.float(), ref.float(), atol=tol, rtol=tol)
    assert torch.equal(out, again) and torch.equal(out, forced)
    return out


@pytest.mark.cuda
@pytest.mark.parametrize("hot", [0, 1, 2, 3, 5, 8, 16])
@pytest.mark.parametrize("d", [8, 40, 64, 128])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_embedding_bag_narrow_route_on_card(cuda, hot, d, dtype):
    """Short bags take the narrow route (B 1001 leaves the last warp tile
    part-filled), equal bit for bit to the span route; a one-lane bag is
    its row, bit for bit."""
    rng = np.random.default_rng(hot * 1000 + d)
    V, B = 5000, 1001
    table, idx = _bag_case(rng, cuda, V, B, hot, d, dtype)
    bf16 = dtype == torch.bfloat16
    n_sm = device_limits(cuda.index or 0)[0]
    plan = bag_ops.kernel_plan(B, hot, d, bf16, n_sm)
    assert plan["route"] == "narrow"
    out = _bag_held(table, idx, None, "narrow", bag_ops.span_plan(hot))
    if hot == 1:
        assert torch.equal(out, table[idx[:, 0].long()])
    if hot == 0:
        assert not out.any()


@pytest.mark.cuda
@pytest.mark.parametrize("hot", [4, 16])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_embedding_bag_narrow_route_padding_on_card(cuda, hot, dtype):
    """Half the lanes padding (the zero row V): skipped as padding_idx or
    summed, the narrow route matches the plain version and the span
    route."""
    rng = np.random.default_rng(hot)
    V, B, d = 3000, 777, 64
    table, idx = _bag_case(rng, cuda, V, B, hot, d, dtype, pad_share=0.5)
    span = bag_ops.span_plan(hot)
    for pad in (V, None):
        _bag_held(table, idx, pad, "narrow", span)


@pytest.mark.cuda
@pytest.mark.parametrize("B,hot,d,dtype,shift", [
    (300, 4, 5, torch.float32, 0),       # a row of 20 bytes
    (300, 4, 12, torch.bfloat16, 0),     # a row of 24 bytes
    (300, 4, 256, torch.float32, 0),     # a row of 1024 bytes
    (300, 4, 64, torch.float32, 1),      # the table 4 bytes off 16
    (300, bag_ops.NARROW_MAX_HOT + 1, 64, torch.float32, 0),
    (40, 5000, 64, torch.bfloat16, 0)])  # two spans
def test_embedding_bag_span_route_on_card(cuda, B, hot, d, dtype, shift):
    """What the narrow route does not take goes to the span route, counted
    there, against the plain version (a bag of two spans to 1e-5 of its
    plain sum, so only rerun- and route-equal where it is one span)."""
    rng = np.random.default_rng(B + hot + d)
    table, idx = _bag_case(rng, cuda, 2000, B, hot, d, dtype)
    if shift:
        store = torch.empty(table.numel() + shift, dtype=dtype, device=cuda)
        store[shift:].copy_(table.flatten())
        table = store[shift:].view(table.shape)
    plan = bag_ops.kernel_plan(B, hot, d, dtype == torch.bfloat16,
                               device_limits(cuda.index or 0)[0],
                               table.data_ptr() % 16 == 0)
    assert plan["route"] == "span"
    if plan["spans"] == 1:
        _bag_held(table, idx, None, "span", plan)
        return
    before = dict(embedding_bag.launches_by_route)
    out = embedding_bag(table, idx)
    torch.cuda.synchronize()
    assert _counted(embedding_bag.launches_by_route, before) == {"span": 1}
    torch.testing.assert_close(out.float(),
                               embedding_bag_ref(table, idx).float(),
                               atol=2e-2, rtol=2e-2)


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
def test_flash_attention_mha_on_the_wgmma_route_on_card(cuda):
    """olmoe-1b-7b's grouping: 16 query heads over 16 kv heads of 128 in
    bf16 (MHA) takes the wgmma kernel, within FLASH_TOL of the plain
    version and the same bits in two launches."""
    q, k, v = _flash_inputs(cuda, 16, 1, 256, 16, 16, 128, torch.bfloat16)
    before = dict(flash_attention.launches_by_route)
    out, again = flash_attention(q, k, v), flash_attention(q, k, v)
    ref = flash_attention_ref(q, k, v)
    torch.cuda.synchronize()
    assert flash_attention.launches_by_route == {
        "wgmma": before["wgmma"] + 2, "mma": before["mma"]}
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


GRAD_TOL = {torch.float32: dict(atol=1e-5, rtol=1e-4),
            torch.bfloat16: dict(atol=2e-2, rtol=2e-2)}


@pytest.mark.cuda
@pytest.mark.parametrize("B,S,H,Hkv,Dh,chunk", [
    (2, 256, 12, 2, 128, 128), (1, 300, 6, 1, 64, 128),
    (2, 129, 16, 16, 128, 1024), (1, 77, 8, 2, 32, 32)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_attention_fn_gradients_on_card(cuda, B, S, H, Hkv, Dh, chunk,
                                              dtype):
    """``FlashAttentionFn`` on the card: one kernel launch forward (its
    route), then the chunked plain backward, against autograd of
    ``flash_attention_ref``, 6 query heads a kv head among the shapes
    (qwen2's grouping)."""
    from repro_torch.kernels.flash_attention.ops import kernel_route
    g = torch.Generator(device=cuda).manual_seed(S + H)
    q, k, v = (torch.randn((B, S, n, Dh), generator=g, device=cuda)
               .to(dtype).requires_grad_() for n in (H, Hkv, Hkv))
    grad = torch.randn((B, S, H, Dh), generator=g, device=cuda).to(dtype)
    route = kernel_route(dtype, Dh, H, Hkv)
    before = flash_attention.launches_by_route[route]
    out = flash_attention(q, k, v, chunk=chunk)
    assert type(out.grad_fn).__name__ == "FlashAttentionFnBackward"
    got = torch.autograd.grad(out, (q, k, v), grad)
    ref = flash_attention_ref(q, k, v)
    want = torch.autograd.grad(ref, (q, k, v), grad)
    torch.cuda.synchronize()
    assert flash_attention.launches_by_route[route] == before + 1
    torch.testing.assert_close(out.float(), ref.float(), **FLASH_TOL[dtype])
    for a, w in zip(got, want):
        assert a.dtype == dtype
        torch.testing.assert_close(a.float(), w.float(), **GRAD_TOL[dtype])


@pytest.mark.cuda
@pytest.mark.parametrize("V,B,hot,d,padding_idx", [
    (10_000, 4096, 1, 64, None), (500, 1024, 4, 64, None),
    (300, 512, 8, 32, 7), (1000, 256, 64, 128, None)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_embedding_bag_fn_gradients_on_card(cuda, V, B, hot, d, padding_idx,
                                            dtype):
    """``EmbeddingBagFn`` on the card: one kernel launch forward (narrow or
    span, as kernel_plan says), then the dense index_add_ backward against
    autograd of ``embedding_bag_ref`` on the fp32 table, rounded once to
    the table's dtype (the Function sums in fp32)."""
    g = torch.Generator(device=cuda).manual_seed(V + hot)
    table = torch.randn((V, d), generator=g, device=cuda).to(dtype) \
        .requires_grad_()
    idx = torch.randint(0, V, (B, hot), generator=g, device=cuda,
                        dtype=torch.int32)
    grad = torch.randn((B, d), generator=g, device=cuda).to(dtype)
    before = embedding_bag.launches
    out = embedding_bag(table, idx, padding_idx)
    assert type(out.grad_fn).__name__ == "EmbeddingBagFnBackward"
    (got,) = torch.autograd.grad(out, table, grad)
    t32 = table.detach().float().requires_grad_()
    (want,) = torch.autograd.grad(embedding_bag_ref(t32, idx, padding_idx),
                                  t32, grad.float())
    torch.cuda.synchronize()
    assert embedding_bag.launches == before + 1
    torch.testing.assert_close(
        out.float(), embedding_bag_ref(table.detach(), idx,
                                       padding_idx).float(),
        **(S_TOL if dtype == torch.float32 else GRAD_TOL[dtype]))
    assert got.dtype == dtype and got.shape == table.shape
    tol = S_TOL if dtype == torch.float32 else dict(atol=1e-3,
                                                    rtol=2.0 ** -8)
    torch.testing.assert_close(got, want.to(dtype), **tol)
    if padding_idx is not None:
        assert not got[padding_idx].any()


@pytest.mark.cuda
@pytest.mark.parametrize("name,engine", [("gc-s", "dist"), ("gs-max", "dist"),
                                         ("gi-s", "dist-rc")])
def test_dist_session_world_size_1_on_card(cuda, name, engine):
    """A small ``dist`` session at world size 1 over NCCL (the mesh of a
    one-rank group on the card): exact against the full pass, which
    bootstraps it through segment_mm."""
    import torch.distributed as dist
    from repro_torch.api import InferenceSession, SessionConfig
    from repro_torch.core.full import full_inference

    s = InferenceSession.build(SessionConfig(
        workload=name, engine=engine, graph="powerlaw", n=2000, m=8000,
        n_layers=2, d_in=32, d_hidden=32, n_classes=8, device="cuda"))
    eng = s.engine.impl
    assert eng.device.type == "cuda" and dist.get_backend() == "nccl"
    assert (eng.n_parts, eng.M) == (1, 1)
    s.ingest(s.make_stream(300, seed=1), batch_size=100)
    st = s.sync()
    H, _ = full_inference(s.workload, s.params,
                          torch.as_tensor(st.H[0], device=cuda),
                          *s.graph.coo(), s.graph.in_degree)
    for l in range(1, len(H)):
        torch.testing.assert_close(torch.as_tensor(st.H[l], device=cuda),
                                   H[l], atol=2e-3, rtol=2e-3)
    torch.testing.assert_close(torch.as_tensor(s.query(), device=cuda),
                               H[-1], atol=2e-3, rtol=2e-3)
