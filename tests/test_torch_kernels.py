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
EXTREMUM_SHAPES = [(64, 32, 16), (128, 128, 128), (33, 48, 7), (256, 64, 200)]
# and two rungs the arxiv sessions launch (R 256 at Dout 128, R 2048 at 40)
DELTA_SHAPES = EXTREMUM_SHAPES + [(256, 128, 128), (2048, 128, 40)]
MLP_SHAPES = [(64, 32, 32, 16), (128, 128, 128, 128), (33, 48, 20, 7),
              (256, 128, 128, 128), (2048, 128, 40, 40)]


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


H100_SMEM = 232_448   # the shared memory an H100's block may opt in to
# (R, Din, Dout, masked) -> (teams, rows a tile) of the resident route;
# the arxiv sessions' rungs (R 256-65536 at Din 128, Dout 128 and 40)
# first, then the card tests' ragged shapes
PLANS = [((256, 128, 128, True), (1, 8)), ((1024, 128, 128, True), (1, 8)),
         ((2048, 128, 128, True), (1, 16)), ((4096, 128, 128, True), (1, 32)),
         ((4096, 128, 40, True), (1, 32)), ((65536, 128, 128, True), (2, 32)),
         ((65536, 128, 40, False), (2, 32)), ((1, 48, 200, True), (1, 8)),
         ((33, 48, 40, False), (1, 16)), ((65536, 128, 200, True), (2, 16))]


@pytest.mark.parametrize("shape,want", PLANS)
def test_extremum_kernel_plan_tiles_the_rows(shape, want):
    """The resident route's tiling: every row in one tile, at most one
    CTA per SM, shared memory within a block's 227 KB, tiles of 8-32
    rows; two teams a CTA only where 32-row tiles outnumber the SMs (an
    H100: 132 SMs, 227 KB a block)."""
    from repro_torch.kernels.extremum_apply.ops import kernel_plan
    R, Din, Dout, masked = shape
    plan = kernel_plan(R, Din, Dout, masked, n_sm=132, smem_limit=H100_SMEM)
    assert plan["route"] == "resident"
    assert (plan["teams"], plan["rows"]) == want
    tiles = -(-R // plan["rows"])
    assert plan["smem"] <= H100_SMEM
    assert plan["grid"] == min(132, -(-tiles // plan["teams"]))


@pytest.mark.parametrize("R,Din,Dout", [(64, 32, 15), (33, 48, 7),
                                        (256, 45, 128), (4096, 512, 256)])
def test_extremum_kernel_plan_k_chunks_the_rest(R, Din, Dout):
    """Din not a multiple of 16, Dout not of 4, or a W that does not fit
    shared memory beside a tile: the K-chunked route, which takes every
    shape."""
    from repro_torch.kernels.extremum_apply.ops import kernel_plan
    assert kernel_plan(R, Din, Dout, True, n_sm=132,
                       smem_limit=H100_SMEM) == {"route": "kchunk"}


# The shapes the arxiv sessions launch delta_apply and mlp_apply at (R
# 64-2048 at Din 128, Dout 128 and 40; PERF.md's by-rung table), and R =
# 65536, the cap ladder's top rung
HOP_RUNGS = [(64, 128), (256, 128), (512, 128), (1024, 40), (1024, 128),
             (2048, 40), (2048, 128), (4096, 40), (65536, 40), (65536, 128)]


@pytest.mark.parametrize("R,Dout", HOP_RUNGS)
def test_delta_kernel_plan_resident_at_the_rungs(R, Dout):
    """delta_apply's resident tiling at every rung on an H100 (132 SMs,
    227 KB a block): tiles of 8-32 rows, a multiple of 4 rows a thread,
    enough tiles for R and at most one CTA per SM, each team with at least
    one; shared memory within the block's."""
    from repro_torch.kernels.delta_apply.ops import kernel_plan
    plan = kernel_plan(R, 128, Dout, n_sm=132, smem_limit=H100_SMEM)
    assert plan["route"] == "resident"
    rows, teams = plan["rows"], plan["teams"]
    assert rows in (8, 16, 32) and rows % (4 * plan["tm"]) == 0
    tiles = -(-R // rows)
    assert plan["grid"] == min(132, -(-tiles // teams)) <= 132
    assert teams == (2 if tiles > 132 else 1)
    assert plan["smem"] == (4 * 128 * Dout
                            + teams * (rows * 128 * 12 + -(-rows * 4 // 16)
                                       * 16) + (teams + 1) * 8)
    assert plan["smem"] <= H100_SMEM


# (SMs, opt-in shared memory a block) of an H100 SXM and an H100 PCIe
CARDS = [(132, H100_SMEM), (114, H100_SMEM)]


@pytest.mark.parametrize("R,Dout", HOP_RUNGS)
@pytest.mark.parametrize("n_sm,smem_limit", CARDS)
def test_mlp_kernel_plan_resident_at_the_rungs(R, Dout, n_sm, smem_limit):
    """mlp_apply's tiling at every rung (Dh = Dout, as the sessions run it)
    on an H100: the resident route, with the smallest tiles of 8-32 rows
    that cover R in one wave, or 32 rows and two stages (where they fit)
    past that; at most one CTA per SM; shared memory within the block's."""
    from repro_torch.kernels.mlp_apply.ops import kernel_plan, resident_smem
    plan = kernel_plan(R, 128, Dout, Dout, n_sm=n_sm, smem_limit=smem_limit)
    assert plan["route"] == "resident"
    rows = plan["rows"]
    assert rows in (8, 16, 32)
    assert rows % (4 * plan["tm1"]) == 0 and rows % (4 * plan["tm2"]) == 0
    tiles = -(-R // rows)
    assert plan["grid"] == min(tiles, n_sm) <= n_sm
    if tiles <= n_sm:
        assert plan["ns"] == 1
        if rows > 8:   # the smallest tiles of one wave
            assert -(-R // (rows // 2)) > n_sm
    else:
        assert rows == 32
        if plan["ns"] == 1:   # two stages do not fit
            assert resident_smem(128, Dout, Dout, rows, 2) > smem_limit
    assert plan["smem"] == resident_smem(128, Dout, Dout, rows,
                                         plan["ns"]) <= smem_limit


@pytest.mark.parametrize("Din,Dh,Dout,rows,ns,want", [
    (128, 128, 128, 8, 1, 4 * 128 * 256 + 4 * 8 * 128 * 5 + 32 + 16),
    (128, 40, 40, 32, 2, 4 * 40 * 168 + 4 * 32 * (128 * 7 + 40) + 128
     + 24)])
def test_mlp_resident_smem_lays_out_the_plan(Din, Dh, Dout, rows, ns, want):
    """resident_smem counts W1 and W2, ns stages of S, M and h_prev, z,
    h1, k (rounded up to 16 bytes) and ns + 1 mbarriers of 8 bytes."""
    from repro_torch.kernels.mlp_apply.ops import resident_smem
    assert resident_smem(Din, Dh, Dout, rows, ns) == want


@pytest.mark.parametrize("R,Din,Dh,Dout", [(33, 48, 20, 7), (64, 32, 36, 16),
                                           (33, 48, 20, 40), (256, 45, 128, 128),
                                           (256, 128, 128, 42),
                                           (32, 1024, 1024, 1024)])
def test_hop_kernel_plans_take_tiled_for_the_rest(R, Din, Dh, Dout):
    """Din not a multiple of 16, Dh not of 8, Dout not of 4, or weights
    that leave no room beside a tile: the tiled route, which takes every
    shape (mlp_apply's up to its z and h1 tiles)."""
    from repro_torch.kernels.delta_apply.ops import kernel_plan as delta_plan
    from repro_torch.kernels.mlp_apply.ops import kernel_plan as mlp_plan
    assert mlp_plan(R, Din, Dh, Dout, n_sm=132,
                    smem_limit=H100_SMEM) == {"route": "tiled"}
    if Din % 16 or Dout % 4 or Din * Dout > 50_000:
        assert delta_plan(R, Din, Dout, n_sm=132,
                          smem_limit=H100_SMEM) == {"route": "tiled"}


# embedding_bag's routes on an H100 (132 SMs): DLRM-RM2's three cells
# (B 262,144, 512 and 1; hot 1, d 64 fp32) and short bags of both dtypes
# take the narrow route; gp-m's hub-wide rectangles, rows not a multiple of
# 16 bytes or over 512, unaligned operands and bags past NARROW_MAX_HOT
# take the span route
@pytest.mark.parametrize("B,hot,d,bf16,want", [
    (262_144, 1, 64, False, dict(group=16, bags=8, lanes=1, tile=16,
                                 grid=396)),
    (512, 1, 64, False, dict(group=16, bags=8, lanes=1, tile=16, grid=8)),
    (1, 1, 64, False, dict(group=16, bags=8, lanes=1, tile=16, grid=1)),
    (1001, 0, 64, False, dict(group=16, bags=8, lanes=1, tile=16, grid=16)),
    (262_144, 1, 64, True, dict(group=8, bags=4, lanes=1, tile=16,
                                grid=528)),
    (1001, 16, 64, True, dict(group=8, bags=1, lanes=8, tile=4, grid=63)),
    (2048, 4, 128, False, dict(group=32, bags=2, lanes=4, tile=2, grid=256)),
    (2048, 4, 128, True, dict(group=16, bags=1, lanes=4, tile=2, grid=256)),
    (1001, 3, 40, False, dict(group=16, bags=2, lanes=4, tile=4, grid=63)),
    (100, 2, 4, False, dict(group=1, bags=1, lanes=2, tile=32, grid=1))])
def test_embedding_bag_kernel_plan_narrow(B, hot, d, bf16, want):
    from repro_torch.kernels.embedding_bag.ops import kernel_plan
    assert kernel_plan(B, hot, d, bf16, n_sm=132) == dict(route="narrow",
                                                          **want)


@pytest.mark.parametrize("B,hot,d,bf16,aligned,spans", [
    (2048, 262_144, 128, False, True, 64),   # gp-m's largest rectangle
    (2048, 4096, 128, False, True, 1),
    (16, 1, 5, False, True, 1),              # a row of 20 bytes
    (16, 1, 12, True, True, 1),              # a row of 24 bytes
    (16, 1, 256, False, True, 1),            # a row of 1024 bytes
    (262_144, 1, 64, False, False, 1),       # operands not 16-byte aligned
    (16, 4097, 64, False, True, 2)])
def test_embedding_bag_kernel_plan_span(B, hot, d, bf16, aligned, spans):
    from repro_torch.kernels.embedding_bag.ops import kernel_plan
    assert kernel_plan(B, hot, d, bf16, n_sm=132, aligned=aligned) \
        == {"route": "span", "spans": spans}


def test_embedding_bag_kernel_plan_bounds_hot():
    """Bags up to NARROW_MAX_HOT lanes take the narrow route, one lane more
    the span route."""
    from repro_torch.kernels.embedding_bag import ops
    top = ops.NARROW_MAX_HOT
    assert ops.kernel_plan(4096, top, 64, False, n_sm=132)["route"] \
        == "narrow"
    assert ops.kernel_plan(4096, top + 1, 64, False, n_sm=132)["route"] \
        == "span"


# every row of 16-512 bytes in steps of 16 that fp32 d 4-128 and bf16 d
# 8-256 give, a few of each: ragged vector counts (3, 5, 10, 25) included
NARROW_ROWS = [(d, False) for d in (4, 8, 12, 16, 20, 40, 64, 100, 128)] \
    + [(d, True) for d in (8, 16, 24, 40, 64, 200, 256)]


@pytest.mark.parametrize("d,bf16", NARROW_ROWS)
@pytest.mark.parametrize("B", [1, 33, 1001, 262_144])
@pytest.mark.parametrize("hot", [0, 1, 3, 8, 256])
def test_embedding_bag_narrow_plan_covers_rows_and_bags(d, bf16, B, hot):
    """A group holds the row's 16-byte vectors (a power of two, at most a
    warp); a thread keeps the lanes of a bag in flight up to NARROW_LANES
    and NARROW_LOADS row loads in all over several bags; a warp tile holds
    at most 32 bags; the grid's warps cover every tile or fill 3-4 blocks
    on every SM."""
    from repro_torch.kernels.embedding_bag import ops
    row = d * (2 if bf16 else 4)
    assert row % 16 == 0 and 16 <= row <= 512
    plan = ops.narrow_plan(B, hot, d, bf16, n_sm=132)
    G, u, w, tile, grid = (plan[k] for k in ("group", "bags", "lanes",
                                             "tile", "grid"))
    loads, lanes = ops.NARROW_LOADS[bf16], ops.NARROW_LANES[bf16]
    assert G & (G - 1) == 0 and G <= 32 and G * 16 >= row > G * 8
    assert w & (w - 1) == 0 and w == min(lanes, max(hot, 1)) \
        or hot == 3 and w == 4
    assert 1 <= u and (u * w <= loads or u == 1)
    assert tile == 32 // G * u <= 32
    assert 1 <= grid <= 132 * ops.NARROW_BLOCKS_PER_SM
    assert grid * ops.NARROW_WARPS * tile >= B or grid >= 132 * 3


def test_embedding_bag_refuses_non_cpu_non_cuda_tensors():
    """Operands neither all on the CPU nor on a CUDA device are refused and
    counted on no route."""
    from repro_torch.kernels.embedding_bag import embedding_bag
    before = dict(embedding_bag.launches_by_route)
    with pytest.raises(ValueError, match="CUDA"):
        embedding_bag(torch.zeros(10, 8, device="meta"),
                      torch.zeros(4, 1, dtype=torch.int32, device="meta"))
    assert embedding_bag.launches_by_route == before
