#!/usr/bin/env python3
"""Smoke run of the PyTorch port (``src/repro_torch``) on one CUDA card.

    python3 chip_smoke.py

Phase 1 builds the hand-written CUDA kernels from this checkout's sources
with nvcc (into build/kernels/), one nvcc per source, all at once.
Phase 2 holds each kernel against its plain PyTorch version at the main
path's shapes and at the ragged shapes of tests/test_kernels.py, and times
both (embedding_bag also against F.embedding_bag, segment_mm against
torch.sparse.mm over the same CSR at d = 128 and 40, flash_attention
against F.scaled_dot_product_attention: library yardsticks, the backend
SDPA took printed); flash_attention is also timed at phi4-mini's prefill
shape in bf16 (its wgmma route) and fp32 (its mma route), extremum_apply
in turns with its K-chunked route (the design its resident route
replaced, ``prev_ms``), and every row names the route it took.
Phase 3 drives the port's main paths, one ``device``-engine session each
-- gc-s (delta_apply), gi-s (mlp_apply), the monotonic gs-max and gc-min
(extremum_apply), and the bounded-recompute gp-m (embedding_bag) and ga-s
(no kernel of its own) -- over a synthetic power-law graph at the paper's
Arxiv scale (169,343 vertices, 1,166,243 edges), 3 layers of 128 features
and 40 classes, ingesting a 3000-update paper-protocol stream in batches
of 100 (the last 5 batches under torch.profiler, for the device's busy
share).  Every launch count is set to 0 just before a session and read
just after it; each session with a kernel must have launched it on every
hop of every batch, and every session holds every layer against the
port's own full-inference oracle.  The monotonic sessions also hold S[1]
bit-equal to the oracle's and the witness invariant
S[l][v,d] == H[l-1][C[l][v,d], d] exactly, on the device, and report
their SHRINK counters and filter pass share; the bounded ones hold their
aux state A to a fresh reaggregation of the final state (sums within
2e-3, maxima bit-equal, PNA's max witnesses exact) and report the pull
and PNA's bag rectangle per hop.  The bootstrap of every session is the
full pass, whose invertible aggregation is segment_mm: each invertible
session's bootstrap must launch it once per layer.  Then a ga-s run in
approximate mode (tolerance 0.1) over 10 batches of feature jitter holds
every published row within its certified bound; two ``full``-engine
sessions (gc-s, and gc-w for weights other than 1) run the first 5
batches of the stream, launching segment_mm once per layer per batch, and
hold their final H against a ``device``-engine session over the same
batches; and a ``ripple``-engine gc-s session (host NumPy, bootstrapped on
the card) runs 10 batches against the oracle, its rates labelled as the
host's.  Then the hop kernels (delta_apply, mlp_apply, extremum_apply)
are timed at every shape the sessions launched them at, from their
launch counts by shape: a ``kernel_rung`` line each, with its launches,
and a ``rungs`` line of launches x (ms - bound) summed per kernel.  Every
extremum_apply launch of the sessions must take its resident route.
Phase 4 serves a language model: phi4-mini-3.8b at its published width
and depth (32 layers, d_model 3072, 24 query and 8 kv heads of 128, d_ff
8192, vocab 200064; 4.45 B parameters in bf16, random from a seed)
answers 4 prompts of 2048 tokens with 32 greedy tokens each, through
``make_prefill_step``/``make_decode_step``, twice (a warm-up, then timed).
Every prefill layer's attention is the flash_attention kernel: its launch
count, set to 0 before the two requests and read after, must be 32 per
prefill, all on the wgmma route (flash_attention_sm90.cu).  One prefill
and 4 decode steps run under torch.profiler (device busy share, attention
share of the prefill).  Then, in fp32 (17.8 GB of
parameters), the prefill logits with the kernel must be within relative
L2 1e-5 of the same model with the plain attention, and the logits of
decode step 4 within 1e-5 of a re-prefill of the prompt and the tokens
generated so far; in bf16 both must be within 5e-2 (LM_BARS).

Any fault ends the run with a traceback and a non-zero exit; nothing is
caught.  Without a CUDA card, or without the repository beside this file,
it exits non-zero before printing any result.  Output ends with the card
line (nvidia-smi's name and power limit), the kernels JSON line and the
device JSON line.

Precision: TF32 is off for matmuls and cuDNN, so the SAGE self term, the
bootstrap, the oracle and the LM's fp32 checks run in full fp32, as the
2e-3, 1e-4 and 1e-5 bars need.
"""
from __future__ import annotations

import functools
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parent

PEAK_BYTES_PER_S = 3.35e12   # H100 SXM HBM3
PEAK_FP32_FLOPS = 67e12      # H100 SXM fp32 outside the tensor cores
PEAK_BF16_FLOPS = 989e12     # H100 SXM bf16 tensor cores, dense
S_TOL = dict(atol=1e-5, rtol=1e-5)   # tests/test_kernels.py bars (extremum
#                                      S' is held bit-equal instead)
H_TOL = dict(atol=1e-4, rtol=1e-4)
ORACLE_TOL = dict(atol=2e-3, rtol=2e-3)

DEVICE = "cuda"
MAIN_R = (64, 4096, 65536)   # cap-ladder rungs the arxiv-scale hops use
BAG_TOL = {torch.float32: dict(atol=1e-5, rtol=1e-5),   # tests/test_kernels.py
           torch.bfloat16: dict(atol=2e-2, rtol=2e-2)}
ARXIV = dict(n=169_343, m=1_166_243, n_layers=3, d_in=128, d_hidden=128,
             n_classes=40)
N_UPDATES, BATCH = 3000, 100
N_PROFILED = 500             # the stream's last 5 batches run under the profiler
N_FULL_BATCHES = 5           # batches of the full-engine sessions
N_RIPPLE_BATCHES = 10        # batches of the host ripple session
SEG_TOL = {torch.float32: dict(atol=2e-5, rtol=2e-5),   # tests/test_kernels.py
           torch.bfloat16: dict(atol=2e-2, rtol=2e-2)}
FLASH_TOL = {torch.float32: dict(atol=1e-5, rtol=1e-4),  # tests/test_kernels.py
             torch.bfloat16: dict(atol=2e-2, rtol=2e-2)}
# phi4-mini's prefill attention: batch 4, prompt 2048, 24 query heads over
# 8 kv heads of 128
PREFILL = dict(B=4, S=2048, H=24, Hkv=8, Dh=128)
LM = dict(arch="phi4-mini-3.8b", batch=4, prompt=2048, tokens=32,
          checked_steps=4)
# relative L2 bars of the LM's logits, kernel against plain attention and
# decode against a re-prefill.  fp32: the two attentions compute one
# function, so what is left is summation order.  bf16: the same function
# rounded to bf16 (2^-8) at every layer of 32; on an NVIDIA H100 80GB HBM3
# (700 W) it measures 0.023, and the bar is about twice that.
LM_BARS = {"float32": 1e-5, "bfloat16": 5e-2}


def log(*parts) -> None:
    print(*parts, flush=True)


def reset_counts(counters: dict) -> None:
    """Every kernel's launch count to 0, with its counts by route and by
    shape where it keeps them."""
    for fn in counters.values():
        fn.launches = 0
        if hasattr(fn, "launches_by_route"):
            fn.launches_by_route = dict.fromkeys(fn.launches_by_route, 0)
        if hasattr(fn, "launches_by_shape"):
            fn.launches_by_shape = {}


def device_ms(fn, iters: int = 25, warmup: int = 3) -> float:
    """Median device time of one call of ``fn``, in ms.  The calls queue
    up behind a device-side sleep, so the gaps between their events are
    device time, not host launch time."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    events = [torch.cuda.Event(enable_timing=True) for _ in range(iters + 1)]
    torch.cuda._sleep(200_000_000)
    events[0].record()
    for i in range(iters):
        fn()
        events[i + 1].record()
    torch.cuda.synchronize()
    return statistics.median(events[i].elapsed_time(events[i + 1])
                             for i in range(iters))


def host_ms(fn, iters: int = 25, warmup: int = 3) -> float:
    """Median host-clock time of one call of ``fn`` between two
    synchronisations, in ms: for work that reads back from the card."""
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(iters):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(times)


def bound_ms(nbytes: float, flops: float,
             peak_flops: float = PEAK_FP32_FLOPS) -> tuple[float, str]:
    t_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
    t_ops = flops / peak_flops * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def delta_work(R: int, Din: int, Dout: int) -> tuple[int, int]:
    """(bytes, flops): reads S, M, k, W, b once; writes S', h once."""
    return (4 * (R * (3 * Din + Dout + 1) + Din * Dout + Dout),
            2 * R * Din * Dout)


def mlp_work(R: int, Din: int, Dh: int, Dout: int) -> tuple[int, int]:
    """(bytes, flops): reads S, M, h_prev, k and the weights; writes S', h."""
    return (4 * (R * (4 * Din + Dout + 1) + Din * Dh + Dh + Dh * Dout + Dout),
            2 * R * (Din * Dh + Dh * Dout))


def _inputs(gen: torch.Generator, R: int, Din: int, dims: tuple[int, ...]):
    dev = torch.device(DEVICE)

    def rand(*shape):
        return torch.randn(shape, generator=gen).to(dev)

    S, M, hp = rand(R, Din), rand(R, Din), rand(R, Din)
    k = torch.randint(0, 6, (R,), generator=gen).float().to(dev)
    ws = []
    for d_in, d_out in zip((Din,) + dims[:-1], dims):
        ws += [rand(d_in, d_out) / d_in ** 0.5, rand(d_out)]
    return S, M, hp, k, ws


def check_delta(gen, R, Din, Dout, mean, relu, *, timed: bool) -> dict:
    from repro_torch.kernels.delta_apply import delta_apply
    from repro_torch.kernels.delta_apply.ref import delta_apply_ref
    S, M, _, k, (W, b) = _inputs(gen, R, Din, (Dout,))
    Sk, hk = delta_apply(S, M, k, W, b, mean=mean, relu=relu)
    Sr, hr = delta_apply_ref(S, M, k, W, b, mean=mean, relu=relu)
    torch.cuda.synchronize()
    torch.testing.assert_close(Sk, Sr, **S_TOL)
    torch.testing.assert_close(hk, hr, **H_TOL)
    row = dict(kernel="delta_apply", R=R, Din=Din, Dout=Dout, mean=mean,
               relu=relu, err_S=(Sk - Sr).abs().max().item(),
               max_abs_err=(hk - hr).abs().max().item())
    if timed:
        x = S + M
        if mean:
            x = x / k.clamp(min=1.0)[:, None]
        nbytes, flops = delta_work(R, Din, Dout)
        b_ms, b_by = bound_ms(nbytes, flops)
        row.update(
            ms=device_ms(lambda: delta_apply(S, M, k, W, b, mean=mean,
                                             relu=relu)),
            plain_ms=device_ms(lambda: delta_apply_ref(S, M, k, W, b,
                                                       mean=mean, relu=relu)),
            addmm_matmul_only_ms=device_ms(lambda: torch.addmm(b, x, W)),
            bound_ms=b_ms, bound_by=b_by)
    return row


def extremum_work(R: int, Din: int, Dout: int,
                  masked: bool) -> tuple[int, int]:
    """(bytes, flops): reads base (S or reagg, by the mask), M, the uint8
    mask when masked, W and b once; writes S', h once."""
    per_cell = 4 + 4 + 4 + (1 if masked else 0)
    return (R * Din * per_cell + 4 * (R * Dout + Din * Dout + Dout),
            2 * R * Din * Dout)


def check_extremum(gen, R, Din, Dout, maximize, masked, *,
                   timed: bool) -> dict:
    """Identity (+/-inf) rows in S and M, as tests/test_kernels.py puts
    them; with ``masked`` a ~7% shrink mask (bool, as the engine passes
    it) and its re-aggregated cells.  The row names the route the wrapper
    took; timed, it also times the K-chunked route at the same shape
    (``prev_ms``: the design the resident route replaced, launched through
    the kernel's C entry, uncounted, and held to the same bars)."""
    from repro_torch.kernels.extremum_apply import extremum_apply, ops
    from repro_torch.kernels.extremum_apply.ref import extremum_apply_ref
    dev = torch.device(DEVICE)
    ident = -float("inf") if maximize else float("inf")
    S = torch.randn((R, Din), generator=gen)
    M = torch.randn((R, Din), generator=gen)
    S[torch.randperm(R, generator=gen)[:max(R // 8, 1)]] = ident
    M[torch.randperm(R, generator=gen)[:max(R // 4, 1)]] = ident
    W = torch.randn((Din, Dout), generator=gen) / Din ** 0.5
    b = torch.randn((Dout,), generator=gen)
    args = [t.to(dev) for t in (S, M, W, b)]
    kw = {}
    if masked:
        mask = torch.rand((R, Din), generator=gen) < 0.07
        kw = dict(reagg=(torch.randn((R, Din), generator=gen)
                         * mask).to(dev), mask=mask.to(dev))

    def kernel():
        return extremum_apply(*args, **kw, maximize=maximize, relu=True)

    def plain():
        return extremum_apply_ref(*args, **kw, maximize=maximize, relu=True)

    before = dict(extremum_apply.launches_by_route)
    Sk, hk = kernel()
    Sr, hr = plain()
    torch.cuda.synchronize()
    route = next(r for r, n in extremum_apply.launches_by_route.items()
                 if n != before[r])
    if not torch.equal(Sk, Sr):
        raise AssertionError(f"extremum_apply S' differs from the plain "
                             f"version at R={R} Din={Din} Dout={Dout} "
                             f"maximize={maximize} masked={masked}")
    torch.testing.assert_close(hk, hr, **H_TOL)
    row = dict(kernel="extremum_apply", route=route, R=R, Din=Din, Dout=Dout,
               maximize=maximize, masked=masked, err_S=0.0,
               max_abs_err=(hk - hr).abs().max().item())
    if timed:
        Sc, hc = torch.empty_like(Sk), torch.empty_like(hk)
        ptrs = [t.data_ptr() for t in args] + [Sc.data_ptr(), hc.data_ptr()]
        mk = [kw["reagg"].data_ptr(), kw["mask"].data_ptr()] if masked \
            else [None, None]
        stream = torch.cuda.current_stream().cuda_stream

        def kchunk():
            err = ops._launcher()(ptrs[0], ptrs[1], *mk, *ptrs[2:], R, Din,
                                  Dout, int(maximize), 1, 0, 0, 0, stream)
            if err:
                raise RuntimeError(f"extremum_apply K-chunked launch: CUDA "
                                   f"error {err}")

        kchunk()
        torch.cuda.synchronize()
        if not torch.equal(Sc, Sr):
            raise AssertionError("extremum_apply's K-chunked route: S' "
                                 "differs from the plain version")
        torch.testing.assert_close(hc, hr, **H_TOL)
        nbytes, flops = extremum_work(R, Din, Dout, masked)
        b_ms, b_by = bound_ms(nbytes, flops)
        # new and replaced design in turns: new, replaced, replaced, new
        ms, prev = device_ms(kernel), device_ms(kchunk)
        prev2, ms2 = device_ms(kchunk), device_ms(kernel)
        row.update(ms=statistics.median([ms, ms2]), ms_turns=[ms, ms2],
                   prev_ms=statistics.median([prev, prev2]),
                   prev_ms_turns=[prev, prev2], plain_ms=device_ms(plain),
                   bound_ms=b_ms, bound_by=b_by)
    return row


def check_mlp(gen, R, Din, Dh, Dout, mean, relu, *, timed: bool) -> dict:
    from repro_torch.kernels.mlp_apply import mlp_apply
    from repro_torch.kernels.mlp_apply.ref import mlp_apply_ref
    S, M, hp, k, (W1, b1, W2, b2) = _inputs(gen, R, Din, (Dh, Dout))
    eps = 0.37
    args = (S, M, hp, k, eps, W1, b1, W2, b2)
    Sk, hk = mlp_apply(*args, mean=mean, relu=relu)
    Sr, hr = mlp_apply_ref(*args, mean=mean, relu=relu)
    torch.cuda.synchronize()
    torch.testing.assert_close(Sk, Sr, **S_TOL)
    torch.testing.assert_close(hk, hr, **H_TOL)
    row = dict(kernel="mlp_apply", R=R, Din=Din, Dh=Dh, Dout=Dout,
               mean=mean, relu=relu, err_S=(Sk - Sr).abs().max().item(),
               max_abs_err=(hk - hr).abs().max().item())
    if timed:
        x = S + M
        if mean:
            x = x / k.clamp(min=1.0)[:, None]
        z = (1.0 + eps) * hp + x
        nbytes, flops = mlp_work(R, Din, Dh, Dout)
        b_ms, b_by = bound_ms(nbytes, flops)
        row.update(
            ms=device_ms(lambda: mlp_apply(*args, mean=mean, relu=relu)),
            plain_ms=device_ms(lambda: mlp_apply_ref(*args, mean=mean,
                                                     relu=relu)),
            addmm_matmul_only_ms=device_ms(
                lambda: torch.addmm(b2, torch.addmm(b1, z, W1), W2)),
            bound_ms=b_ms, bound_by=b_by)
    return row


def bag_work(B: int, hot: int, d: int, kept: int,
             elem: int) -> tuple[int, int]:
    """(bytes, flops): reads the int32 index rectangle once and each kept
    lane's table row once (padding lanes read no row), writes the output
    once; one add per gathered element."""
    return 4 * B * hot + elem * d * (kept + B), kept * d


@functools.cache
def arxiv_in_degrees():
    """In-degrees of the sessions' arxiv-scale power-law graph (seed 0)."""
    from repro_torch.core.graph import powerlaw_graph
    _, dst, _ = powerlaw_graph(ARXIV["n"], ARXIV["m"], seed=0)
    return torch.bincount(torch.as_tensor(dst), minlength=ARXIV["n"])


@functools.cache
def arxiv_coo():
    """The edges of the sessions' arxiv-scale graph after the 10% hold-out
    (seed 0), with weights drawn as gc-w draws them."""
    from repro_torch.core.graph import powerlaw_graph
    from repro_torch.data.streams import snapshot_split
    src, dst, w = powerlaw_graph(ARXIV["n"], ARXIV["m"], seed=0,
                                 weighted=True)
    return snapshot_split(src, dst, w, 0.1, seed=0)[0]


def segment_mm_work(n: int, E: int, d: int, elem: int) -> tuple[int, int]:
    """(bytes, flops): reads x [n, d] and the CSR (rowptr, an int32 id and
    an fp32 weight per edge) once, writes out [n, d] once; one multiply-add
    per gathered element."""
    return elem * d * 2 * n + 8 * E + 4 * (n + 1), 2 * E * d


def check_segment_mm(seed: int, src, dst, w, n: int, d: int,
                     dtype=torch.float32, *, timed: bool) -> dict:
    """segment_mm against its plain version (index_add_ in fp32) on
    x ~ N(0, 1), and against itself run twice (bit-equal).  Untimed:
    tests/test_kernels.py's bars.  Timed (the arxiv graph): each cell
    within 1e-5 of the sum of its terms' magnitudes (a reordered fp32
    sum's bar), with torch.sparse.mm over the same CSR as the library
    yardstick."""
    from repro_torch.kernels.segment_mm import coo_to_csr, segment_mm_csr
    from repro_torch.kernels.segment_mm.ops import EDGE_BUDGET, partition
    from repro_torch.kernels.segment_mm.ref import (partition_ref,
                                                    segment_mm_ref)
    g = torch.Generator(device=DEVICE).manual_seed(seed)
    x = torch.randn((n, d), generator=g, device=DEVICE).to(dtype)
    csr = coo_to_csr(src, dst, w, n, DEVICE)
    # the CSR's work items (the partition kernels) are the plain version's
    want = partition_ref(csr.rowptr.cpu(), EDGE_BUDGET)
    if csr.n_chunks != want[3] or not all(
            torch.equal(got.cpu(), ref) for got, ref in
            zip((csr.items, csr.long_rows, csr.chunk_ptr), want[:3])):
        raise AssertionError(f"the partition kernels disagree with the "
                             f"plain partition at n={n}")

    def kernel():
        return segment_mm_csr(csr, x)

    def plain():
        return segment_mm_ref(csr.col, csr.row, csr.w, x, n)

    out, ref = kernel(), plain()
    mag = segment_mm_ref(csr.col, csr.row, csr.w.abs(), x.abs(), n).float()
    again = kernel()
    torch.cuda.synchronize()
    if not torch.equal(again, out):
        raise AssertionError("segment_mm differs between two runs")
    err = (out.float() - ref.float()).abs()
    if timed:
        if not bool((err <= 1e-5 * mag).all()):
            raise AssertionError(f"segment_mm exceeds 1e-5 of its terms' "
                                 f"magnitude at n={n} d={d}")
    else:
        torch.testing.assert_close(out.float(), ref.float(), **SEG_TOL[dtype])
    row = dict(kernel="segment_mm", n=n, E=len(src), d=d, dtype=str(dtype),
               budget=EDGE_BUDGET, items=int(csr.items.shape[0]),
               long_rows=int(csr.long_rows.shape[0]), chunks=csr.n_chunks,
               max_in_degree=int((csr.rowptr[1:] - csr.rowptr[:-1]).max()),
               max_abs_err=err.max().item(),
               max_err_over_magnitude=(err / mag.clamp(min=1e-30))
               .max().item())
    if timed:
        A = torch.sparse_csr_tensor(csr.rowptr, csr.col, csr.w, size=(n, n))
        # the yardstick computes the same function, to the same bar
        if not bool(((torch.sparse.mm(A, x) - ref).abs()
                     <= 1e-5 * mag).all()):
            raise AssertionError("torch.sparse.mm disagrees with the plain "
                                 "version")
        nbytes, flops = segment_mm_work(n, len(src), d, x.element_size())
        b_ms, b_by = bound_ms(nbytes, flops)
        row.update(
            partition_ms=host_ms(lambda: partition(csr.rowptr)),
            partition_plain_ms=host_ms(
                lambda: partition_ref(csr.rowptr, EDGE_BUDGET)),
            ms=device_ms(kernel), plain_ms=device_ms(plain),
            library_ms=device_ms(lambda: torch.sparse.mm(A, x)),
            bound_ms=b_ms, bound_by=b_by,
            # every edge's source row read once, with no reuse
            gather_bound_ms=bound_ms(nbytes + x.element_size() * d
                                     * (len(src) - n), flops)[0])
    return row


def check_embedding_bag(seed: int, V: int, B: int, hot: int, d: int,
                        dtype=torch.float32, degs=None, *,
                        timed: bool) -> dict:
    """Without ``degs``: ids drawn over the whole table, as
    tests/test_kernels.py draws them.  With ``degs``: the engine's pattern
    -- bag r holds min(degs[r], hot) ids left-packed, the sentinel V (a
    zero row appended to the table, plus the engine's trash row) pads the
    rest, and the kernel skips it as padding_idx, as the engine calls it;
    the table is relu'd like the embeddings it gathers."""
    import torch.nn.functional as F
    from repro_torch.kernels.embedding_bag import embedding_bag
    from repro_torch.kernels.embedding_bag.ref import embedding_bag_ref
    g = torch.Generator(device=DEVICE).manual_seed(seed)
    table = torch.randn((V, d), generator=g, device=DEVICE)
    ids = torch.randint(0, V, (B, hot), generator=g, device=DEVICE,
                        dtype=torch.int32)
    pad = None
    kept = B * hot
    if degs is not None:
        table = torch.cat([table.relu(), table.new_zeros((2, d))])
        lens = torch.as_tensor(degs, device=DEVICE).clamp(max=hot)
        ids = torch.where(torch.arange(hot, device=DEVICE)[None, :]
                          < lens[:, None], ids, V)
        pad = V
        kept = int(lens.sum())
    table = table.to(dtype)

    def kernel():
        return embedding_bag(table, ids, padding_idx=pad)

    def plain():
        return embedding_bag_ref(table, ids, padding_idx=pad)

    out, ref = kernel(), plain()
    torch.cuda.synchronize()
    torch.testing.assert_close(out.float(), ref.float(), **BAG_TOL[dtype])
    row = dict(kernel="embedding_bag", V=table.shape[0], B=B, hot=hot, d=d,
               dtype=str(dtype), kept_lanes=kept, padding_idx=pad,
               max_abs_err=(out.float() - ref.float()).abs().max().item())
    if pad is not None:
        # the sentinel row is zero: skipping it changes nothing
        torch.testing.assert_close(embedding_bag(table, ids), out,
                                   **BAG_TOL[dtype])
    if timed:
        nbytes, flops = bag_work(B, hot, d, kept, table.element_size())
        b_ms, b_by = bound_ms(nbytes, flops)
        slow = B * hot * d > 1 << 30   # the plain version's gather is huge
        row.update(
            ms=device_ms(kernel), rect_bytes=4 * B * hot,
            plain_ms=device_ms(plain, iters=5 if slow else 25,
                               warmup=1 if slow else 3),
            library_ms=device_ms(lambda: F.embedding_bag(
                ids, table, mode="sum", padding_idx=pad)),
            bound_ms=b_ms, bound_by=b_by)
    return row


def flash_work(B: int, S: int, H: int, Hkv: int, Dh: int,
               elem: int) -> tuple[int, int]:
    """(bytes, flops): reads q, k, v once and writes out once; two products
    of 2*Dh flops over the S(S+1)/2 causal (query, key) pairs of each query
    head."""
    return (elem * 2 * B * S * Dh * (H + Hkv),
            4 * B * H * Dh * (S * (S + 1) // 2))


def rel_l2(a: torch.Tensor, b: torch.Tensor) -> float:
    a, b = a.double(), b.double()
    return ((a - b).norm() / b.norm()).item()


def sdpa_kernels(fn) -> list[str]:
    """The device kernels one call of ``fn`` (an SDPA call) ran, from
    torch.profiler: which backend SDPA took (cuDNN, flash or efficient)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    return sorted({e.key for e in prof.key_averages()
                   if e.device_type == DeviceType.CUDA})


def sdpa_backend(kernels: list[str]) -> str:
    names = " ".join(kernels).lower()
    for backend, marks in (("cudnn", ("cudnn",)), ("flash", ("flash",)),
                           ("efficient", ("fmha", "efficient", "cutlass"))):
        if any(m in names for m in marks):
            return backend
    return "math"


def check_flash(seed: int, B: int, S: int, H: int, Hkv: int, Dh: int,
                dtype, *, timed: bool) -> dict:
    """flash_attention against its plain version on N(0, 1) inputs at
    tests/test_kernels.py's bars, the route it took (the route function's,
    which the per-route launch counts must confirm) and, for the wgmma
    route, bit-equal to a second launch.  Timed: with the library
    yardstick, F.scaled_dot_product_attention(is_causal=True,
    enable_gqa=True) on the same inputs in its [B, H, S, Dh] layout, held
    to the plain version at relative L2 2e-2 (it computes the same
    function), and the backend it took."""
    import torch.nn.functional as F
    from repro_torch.kernels.flash_attention import flash_attention
    from repro_torch.kernels.flash_attention.ops import kernel_route
    from repro_torch.kernels.flash_attention.ref import flash_attention_ref
    g = torch.Generator(device=DEVICE).manual_seed(seed)
    q = torch.randn((B, S, H, Dh), generator=g, device=DEVICE).to(dtype)
    k = torch.randn((B, S, Hkv, Dh), generator=g, device=DEVICE).to(dtype)
    v = torch.randn((B, S, Hkv, Dh), generator=g, device=DEVICE).to(dtype)

    def kernel():
        return flash_attention(q, k, v)

    def plain():
        return flash_attention_ref(q, k, v)

    route = kernel_route(dtype, Dh, H, Hkv)
    before = dict(flash_attention.launches_by_route)
    out, again, ref = kernel(), kernel(), plain()
    torch.cuda.synchronize()
    took = {r: n - before[r] for r, n in
            flash_attention.launches_by_route.items() if n != before[r]}
    if took != {route: 2}:
        raise AssertionError(f"flash_attention {B, S, H, Hkv, Dh} {dtype}: "
                             f"launches {took}, expected 2 on {route}")
    torch.testing.assert_close(out.float(), ref.float(), **FLASH_TOL[dtype])
    same = torch.equal(out, again)
    if route == "wgmma" and not same:
        raise AssertionError(f"flash_attention {B, S, H, Hkv, Dh}: two "
                             f"launches differ")
    row = dict(kernel="flash_attention", route=route, B=B, S=S, H=H,
               Hkv=Hkv, Dh=Dh, dtype=str(dtype),
               max_abs_err=(out.float() - ref.float()).abs().max().item(),
               rel_l2=rel_l2(out, ref), bit_equal_rerun=same)
    if timed:
        qt, kt, vt = (x.transpose(1, 2).contiguous() for x in (q, k, v))

        def library():
            return F.scaled_dot_product_attention(qt, kt, vt, is_causal=True,
                                                  enable_gqa=True)

        lib_err = rel_l2(library().transpose(1, 2), ref)
        if lib_err > 2e-2:
            raise AssertionError(f"the SDPA yardstick differs from the plain "
                                 f"version by relative L2 {lib_err}")
        lib_kernels = sdpa_kernels(library)
        nbytes, flops = flash_work(B, S, H, Hkv, Dh, q.element_size())
        b_ms, b_by = bound_ms(nbytes, flops, PEAK_BF16_FLOPS
                              if dtype == torch.bfloat16 else PEAK_FP32_FLOPS)
        # kernel and library in turns: kernel, library, library, kernel
        ms, lib_ms = device_ms(kernel), device_ms(library)
        lib_ms2, ms2 = device_ms(library), device_ms(kernel)
        row.update(ms=statistics.median([ms, ms2]), ms_turns=[ms, ms2],
                   plain_ms=device_ms(plain, iters=10),
                   library_ms=statistics.median([lib_ms, lib_ms2]),
                   library_ms_turns=[lib_ms, lib_ms2], library_rel_l2=lib_err,
                   library_backend=sdpa_backend(lib_kernels),
                   library_kernels=[k[:120] for k in lib_kernels],
                   bound_ms=b_ms, bound_by=b_by, flops=flops, bytes=nbytes)
    return row


def phase_flash() -> list[dict]:
    """flash_attention against its plain version: tests/test_kernels.py's
    shapes and a ragged one in both dtypes, the wgmma route at S of 1, 63
    and 129, then timed at the prefill shape (bf16 and fp32), at a ragged
    S, at one query head per kv head and at head dim 64."""
    rows = []
    for B, S, H, Hkv, Dh in ((2, 64, 4, 2, 16), (1, 128, 8, 8, 32),
                             (2, 96, 6, 2, 8), (1, 256, 4, 1, 64),
                             (2, 97, 6, 2, 16)):
        for dtype in (torch.float32, torch.bfloat16):
            rows.append(check_flash(len(rows), B, S, H, Hkv, Dh, dtype,
                                    timed=False))
    for S in (1, 63, 129):
        for H, Hkv, Dh in ((24, 8, 128), (6, 2, 64)):
            rows.append(check_flash(len(rows), 2, S, H, Hkv, Dh,
                                    torch.bfloat16, timed=False))
    P = PREFILL
    for dtype in (torch.bfloat16, torch.float32):
        rows.append(check_flash(len(rows), *P.values(), dtype, timed=True))
    rows.append(check_flash(len(rows), P["B"], P["S"] + 31, P["H"], P["Hkv"],
                            P["Dh"], torch.bfloat16, timed=True))
    rows.append(check_flash(len(rows), P["B"], P["S"], P["Hkv"], P["Hkv"],
                            P["Dh"], torch.bfloat16, timed=True))
    rows.append(check_flash(len(rows), P["B"], P["S"], P["H"], P["Hkv"], 64,
                            torch.bfloat16, timed=True))
    for row in rows:
        log("kernel_check", json.dumps(row))
    main = next(r for r in rows if "ms" in r and r["route"] == "wgmma")
    log(f"sdpa backend: {main['library_backend']} "
        f"({', '.join(main['library_kernels'])})")
    return rows


def phase_kernels() -> list[dict]:
    """Every kernel against its plain version; main-path shapes timed."""
    from repro_torch.core.graph import erdos_renyi
    gen = torch.Generator().manual_seed(0)
    rows = []
    for n, m, d in ((100, 400, 32), (257, 1500, 64), (64, 300, 128),
                    (300, 2000, 16)):
        src, dst, w = erdos_renyi(n, m, seed=1, weighted=True)
        for dtype in (torch.float32, torch.bfloat16):
            rows.append(check_segment_mm(len(rows), src, dst, w, n, d, dtype,
                                         timed=False))
    # the main path's shape: the full pass over the arxiv session graph
    src, dst, w = arxiv_coo()
    for d in (128, 40):
        rows.append(check_segment_mm(len(rows), src, dst, w, ARXIV["n"], d,
                                     timed=True))
    for V, B, hot, d in ((100, 8, 1, 16), (1000, 32, 4, 64),
                         (5000, 16, 8, 128)):
        for dtype in (torch.float32, torch.bfloat16):
            rows.append(check_embedding_bag(len(rows), V, B, hot, d, dtype,
                                            timed=False))
    for V, B, hot, d in ((64, 16, 8, 16), (200, 48, 12, 32)):
        degs = torch.randint(0, hot + 1, (B,), generator=gen)
        rows.append(check_embedding_bag(len(rows), V, B, hot, d, degs=degs,
                                        timed=False))
    # the main path's shapes: bags of arxiv in-degrees, the hub's first
    indeg = arxiv_in_degrees()
    for B in (64, 2048):
        degs = indeg[torch.randint(0, ARXIV["n"], (B,), generator=gen)]
        degs[0] = indeg.max()
        for hot in (64, 4096, 262144):
            rows.append(check_embedding_bag(len(rows), ARXIV["n"], B, hot,
                                            128, degs=degs, timed=True))
    for R in MAIN_R:
        for Dout in (128, 40):
            rows.append(check_delta(gen, R, 128, Dout, False, True,
                                    timed=True))
            rows.append(check_mlp(gen, R, 128, Dout, Dout, False, True,
                                  timed=True))
            for maximize in (True, False):
                for masked in (True, False):
                    rows.append(check_extremum(gen, R, 128, Dout, maximize,
                                               masked, timed=True))
    for R, Din, Dout in ((64, 32, 16), (128, 128, 128), (33, 48, 7),
                         (256, 64, 200)):
        for maximize in (True, False):
            for masked in (True, False):
                rows.append(check_extremum(gen, R, Din, Dout, maximize,
                                           masked, timed=False))
    for R, Din, Dout in ((64, 32, 16), (128, 128, 128), (33, 48, 7),
                         (256, 64, 200)):
        for mean, relu in ((False, True), (True, False), (True, True)):
            rows.append(check_delta(gen, R, Din, Dout, mean, relu,
                                    timed=False))
    for R, Din, Dh, Dout in ((64, 32, 32, 16), (128, 128, 128, 128),
                             (33, 48, 20, 7)):
        for mean, relu in ((False, True), (True, False)):
            rows.append(check_mlp(gen, R, Din, Dh, Dout, mean, relu,
                                  timed=False))
    for row in rows:
        log("kernel_check", json.dumps(row))
    return rows


def profile_window(session, updates):
    """A few batches under torch.profiler: the device's busy share (its
    kernels' and copies' device time over the window's wall time, which
    the profiler's own host cost inflates), device operations per batch,
    and the largest device-time entries.  Returns (summary, report)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        report = session.ingest(updates, batch_size=BATCH)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    dev = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA]
    busy_us = sum(e.self_device_time_total for e in dev)
    top = sorted(dev, key=lambda e: -e.self_device_time_total)[:8]
    return dict(
        batches=report.n_batches, wall_ms=wall * 1e3,
        device_busy_ms=busy_us / 1e3 if dev else None,
        device_busy_share=busy_us * 1e-6 / wall if dev else None,
        device_ops_per_batch=sum(e.count for e in dev) / report.n_batches,
        top=[[e.key[:60], e.self_device_time_total / 1e3, e.count]
             for e in top]), report


def check_witnesses(eng) -> int:
    """S[l][v,d] == H[l-1][C[l][v,d], d] exactly, on the device, wherever
    C >= 0, and the identity (+/-inf) wherever C == -1; returns the number
    of witnessed cells checked."""
    n, checked = eng.n, 0
    for l in range(1, len(eng.state.S)):
        C = eng.state.C[l][:n].long()
        S = eng.state.S[l][:n]
        has = C >= 0
        got = eng.state.H[l - 1][:n].gather(0, C.clamp(min=0))
        if not torch.equal(got[has], S[has]):
            raise AssertionError(f"layer {l}: a witness does not attain "
                                 f"its extremum")
        if torch.isfinite(S[~has]).any():
            raise AssertionError(f"layer {l}: an empty cell is finite")
        checked += int(has.sum())
    return checked


def check_bounded_aux(session) -> dict:
    """The engine's aux state A against a fresh reaggregation of the final
    state on the device: sums (s1, s2, z) within 2e-3, maxima (m, mx, theta)
    bit-equal, and PNA's witnesses exact: H[l-1][mref[v,d], d] == mx[v,d]
    wherever mref >= 0, -inf wherever it is -1."""
    from repro_torch.core.full import bounded_aux
    eng = session.engine.impl
    n = eng.n
    src, dst, _ = session.graph.coo()
    fresh = bounded_aux(session.workload, [h[:n] for h in eng.state.H], src,
                        dst)
    names = session.workload.agg.aux_names
    out = dict(aux_max_err={}, witnesses_checked=0)
    for l in range(1, len(eng.state.H)):
        got = dict(zip(names, (a[:n] for a in eng.state.A[l])))
        for nm, ref in fresh[l].items():
            if nm in ("m", "mx", "theta"):
                if not torch.equal(got[nm], ref):
                    raise AssertionError(f"A[{l}][{nm}] differs from a "
                                         f"fresh reaggregation")
            elif nm != "mref":
                torch.testing.assert_close(got[nm], ref, **ORACLE_TOL)
                out["aux_max_err"][f"{l}.{nm}"] = \
                    (got[nm] - ref).abs().max().item()
        if "mref" in got:
            mref, mx = got["mref"].long(), got["mx"]
            has = mref >= 0
            hit = eng.state.H[l - 1][:n].gather(0, mref.clamp(min=0))
            if not torch.equal(hit[has], mx[has]) \
                    or torch.isfinite(mx[~has]).any():
                raise AssertionError(f"layer {l}: a PNA max witness does "
                                     f"not attain its max")
            out["witnesses_checked"] += int(has.sum())
    return out


def build_session(workload: str, engine: str, counters: dict, **options):
    """An arxiv-scale session, bootstrapped by one full pass on the card.
    The launch counts are set to 0 just before the build and read just
    after: the full pass of an invertible workload is segment_mm, once per
    layer (a device engine's warm-up batch adds its hop kernels).  Returns
    (session, build seconds, segment_mm's bootstrap launches)."""
    from repro_torch.api import InferenceSession, SessionConfig
    from repro_torch.kernels.segment_mm.ops import partition
    reset_counts(counters)
    partitions = partition.launches
    t0 = time.perf_counter()
    session = InferenceSession.build(SessionConfig(
        workload=workload, engine=engine, graph="powerlaw",
        holdout_frac=0.1, seed=0, device=DEVICE, **options, **ARXIV))
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    boot = {name: fn.launches for name, fn in counters.items()}
    want = ARXIV["n_layers"] \
        if session.workload.agg.algebra == "invertible" else 0
    if boot["segment_mm"] != want:
        raise AssertionError(f"{workload}/{engine}: the bootstrap launched "
                             f"{boot}, expected segment_mm {want} times")
    # the full pass's CSR: its work items by the partition kernels, once
    if partition.launches - partitions != (want > 0):
        raise AssertionError(f"{workload}/{engine}: the bootstrap ran the "
                             f"partition {partition.launches - partitions} "
                             f"times")
    return session, build_s, boot["segment_mm"]


def hold_close(got: torch.Tensor, ref: torch.Tensor, label: str) -> dict:
    """``got`` against ``ref`` at atol/rtol 2e-3 per element, where fp32
    can resolve that: an element left small by cancellation in a row whose
    values reach 1e4-1e5 (gc-s's last layer at this scale) carries more
    rounding than that in any fp32 evaluation (``last_f64_bar_use`` of a
    full session measures both engines against a float64 pass), and is
    held to 2e-3 of its row's largest value instead.  Returns the largest
    error, the largest share of the per-element bar used, and how many
    elements were over it."""
    err = (got - ref).abs()
    elem = ORACLE_TOL["atol"] + ORACLE_TOL["rtol"] * ref.abs()
    row = ORACLE_TOL["atol"] \
        + ORACLE_TOL["rtol"] * ref.abs().amax(dim=1, keepdim=True)
    if not bool((err <= row).all()):
        raise AssertionError(f"{label}: error {err.max().item()} beyond "
                             f"2e-3 of its row's scale")
    return dict(max_err=err.max().item(),
                max_elem_bar_use=(err / elem).max().item(),
                elems_over_elem_bar=int((err > elem).sum()))


def check_oracle(session) -> list[dict]:
    """Every layer of the session's state, and its query, against the
    port's full-inference oracle on the current graph (:func:`hold_close`);
    returns each layer's numbers."""
    from repro_torch.core.full import full_inference
    state = session.sync()
    H_ref, _ = full_inference(session.workload, session.params,
                              torch.as_tensor(state.H[0], device=DEVICE),
                              *session.graph.coo(), session.graph.in_degree)
    out = [hold_close(torch.as_tensor(state.H[l], device=DEVICE), H_ref[l],
                      f"layer {l}") for l in range(1, len(H_ref))]
    hold_close(torch.as_tensor(session.query(), device=DEVICE), H_ref[-1],
               "query")
    return out


def run_session(workload: str, counters: dict, kernel: str | None) -> dict:
    """One arxiv-scale device-engine session, checked against the oracle.
    Every launch count is set to 0 just before the session is driven and
    read just after; ``kernel`` (None for a path with no kernel of its own)
    must have run on every hop of every batch."""
    from repro_torch.core.full import full_inference
    torch.cuda.reset_peak_memory_stats()
    session, build_s, boot = build_session(workload, "device", counters)
    updates = session.make_stream(N_UPDATES, seed=1).updates
    eng = session.engine.impl
    H_start = [h.clone() for h in eng.state.H] \
        if eng.monotonic or eng.bounded else None
    reset_counts(counters)
    report = session.ingest(updates[:-N_PROFILED], batch_size=BATCH)
    torch.cuda.synchronize()
    profiled, report_p = profile_window(session, updates[-N_PROFILED:])
    launches = {name: fn.launches for name, fn in counters.items()}
    # the hop kernels' launches by shape (R, Din[, Dh], Dout), for the
    # by-rung timing after the sessions
    by_shape = {name: dict(fn.launches_by_shape) for name, fn in
                counters.items() if hasattr(fn, "launches_by_shape")
                and fn.launches_by_shape}
    routes = dict(counters["extremum_apply"].launches_by_route)
    if routes["kchunk"]:
        raise AssertionError(f"{workload}: extremum_apply launches by route "
                             f"{routes}; the main path's shapes must take "
                             f"the resident route")
    L = ARXIV["n_layers"]
    n_batches = report.n_batches + report_p.n_batches
    if report.n_batches < 20 or (kernel is not None
                                 and launches[kernel] < L * n_batches):
        raise AssertionError(f"{workload}: {launches} launches for "
                             f"{n_batches} batches x {L} layers")

    state = session.sync()
    x = torch.as_tensor(state.H[0], device=DEVICE)
    H_ref, S_ref = full_inference(session.workload, session.params, x,
                                  *session.graph.coo(),
                                  session.graph.in_degree)
    layer_err, layer_tol_use = [], []
    for l in range(1, L + 1):
        got = torch.as_tensor(state.H[l], device=DEVICE)
        torch.testing.assert_close(got, H_ref[l], **ORACLE_TOL)
        err = (got - H_ref[l]).abs()
        layer_err.append(err.max().item())
        # the largest share of the allowed error any element uses (< 1)
        allowed = ORACLE_TOL["atol"] + ORACLE_TOL["rtol"] * H_ref[l].abs()
        layer_tol_use.append((err / allowed).max().item())
    final = torch.as_tensor(session.query(), device=DEVICE)
    torch.testing.assert_close(final, H_ref[L], **ORACLE_TOL)
    # predictions: every disagreement must be a near-tie of the oracle's
    # own logits (a difference within the 2e-3 bar)
    pred = torch.as_tensor(session.predict(), device=DEVICE)
    ref_pred = H_ref[L].argmax(dim=1)
    bad = (pred != ref_pred).nonzero().flatten()
    gap = (H_ref[L][bad, ref_pred[bad]] - H_ref[L][bad, pred[bad]]).abs()
    if bad.numel() and gap.max().item() > 2e-3 * (
            1 + H_ref[L][bad].abs().max().item()):
        raise AssertionError(f"{workload}: predictions disagree beyond "
                             f"ties at {bad.numel()} vertices")
    lat = sorted(report.latencies)
    p50 = statistics.median(lat) * 1e3
    result = dict(
        workload=workload, n=ARXIV["n"], edges=session.graph.num_edges,
        layers=L, width=ARXIV["d_hidden"], classes=ARXIV["n_classes"],
        updates=len(updates), timed_batches=report.n_batches, batch=BATCH,
        build_s=build_s, bootstrap_segment_mm_launches=boot,
        launches=launches, retries=eng.retries,
        launches_by_shape={name: {"x".join(map(str, k)): v
                                  for k, v in shapes.items()}
                           for name, shapes in by_shape.items()},
        hop_caps=[list(c) for c in eng._caps(0)],
        mirror_uploads=eng.out_mirror.uploads,
        steady_ups=BATCH / (p50 * 1e-3), p50_ms=p50,
        p99_ms=report.p99_latency_ms, wall_ups=report.throughput,
        max_err_per_layer=layer_err, tol_use_per_layer=layer_tol_use,
        predict_mismatch=int(bad.numel()),
        peak_mem_gb=torch.cuda.max_memory_allocated() / 2**30,
        profiled=profiled)
    results = report.results + report_p.results
    affected = sum(int(r.affected.size) for r in results)
    if eng.monotonic:
        # a max/min over the unchanged features involves no rounding
        if not torch.equal(torch.as_tensor(state.S[1], device=DEVICE),
                           S_ref[1]):
            raise AssertionError(f"{workload}: S[1] differs from the "
                                 f"oracle's")
        result.update(
            pull=eng.pull, witnesses_checked=check_witnesses(eng),
            counters={f: sum(getattr(r, f) for r in results) for f in (
                "shrink_events", "rows_reaggregated", "dims_reaggregated",
                "recover_hits")})
    if eng.bounded:
        caps = eng._caps(0)
        result.update(
            counters={f: sum(getattr(r, f) for r in results) for f in (
                "rows_reaggregated", "deferred_rows", "bound_violations",
                "patch_events")},
            # per hop (recipients, edges, pulled lanes, largest in-degree)
            needed_per_hop_max=eng._hw.tolist(),
            # PNA's bag rectangle at the settled caps (int32 ids)
            rect_bytes_per_hop=[4 * c[0] * c[3] for c in caps])
    if eng.monotonic or eng.bounded:
        result.update(
            # share of the last hop's recipients whose embedding changed
            filter_pass_share=affected / max(int(eng.sizes_total[-1][0]),
                                             1),
            needed_per_hop_total=eng.sizes_total.tolist(),
            in_mirror_uploads=eng.in_mirror.uploads,
            # per layer: rows whose H moved over the stream, and those that
            # moved by less than 1e-5 relative -- rounding, not change
            changed_rows=[], tiny_change_rows=[])
        for l in range(1, L + 1):
            h0 = H_start[l][:eng.n]
            moved = (eng.state.H[l][:eng.n] - h0).abs().amax(dim=1)
            scale = h0.abs().amax(dim=1).clamp(min=1.0)
            result["changed_rows"].append(int((moved > 0).sum()))
            result["tiny_change_rows"].append(
                int(((moved > 0) & (moved < 1e-5 * scale)).sum()))
    log("session", json.dumps(result))
    result["by_shape"] = by_shape
    if eng.bounded:
        # after the session line, so its numbers survive a failed check
        aux = check_bounded_aux(session)
        log("session_aux", json.dumps(dict(workload=workload, **aux)))
        result.update(aux)
    return result


def run_tolerance_session(workload: str = "ga-s", tolerance: float = 0.1,
                          n_batches: int = 10) -> dict:
    """Approximate mode at the arxiv scale: batches of 100 feature nudges
    (N(0, 1e-6) added to current features, the sensor-jitter regime in
    which interior changes fit a deferral budget).  After each batch the
    certified bound must stay within the tolerance and every published
    row's error against the oracle within its bound plus 2e-3."""
    from repro_torch.api import InferenceSession, SessionConfig
    from repro_torch.core.full import full_inference
    from repro_torch.core.graph import FeatureUpdate, UpdateBatch
    session = InferenceSession.build(SessionConfig(
        workload=workload, engine="device", graph="powerlaw",
        holdout_frac=0.1, seed=0, device=DEVICE,
        engine_options={"tolerance": tolerance}, **ARXIV))
    gen = torch.Generator().manual_seed(2)
    x = torch.as_tensor(session.state.H[0]).clone()
    rows, max_err, max_bound = [], 0.0, 0.0
    for _ in range(n_batches):
        vs = torch.randperm(ARXIV["n"], generator=gen)[:BATCH]
        x[vs] += 1e-6 * torch.randn((BATCH, ARXIV["d_in"]), generator=gen)
        res = session.apply_one(UpdateBatch(features=[
            FeatureUpdate(int(v), x[v].numpy().copy()) for v in vs]))
        bound = torch.as_tensor(session.engine.error_bound(), device=DEVICE)
        if bound.max().item() > tolerance + 1e-6:
            raise AssertionError(f"certified bound {bound.max().item()} "
                                 f"exceeds the tolerance {tolerance}")
        st = session.sync()
        H_ref, _ = full_inference(session.workload, session.params,
                                  torch.as_tensor(st.H[0], device=DEVICE),
                                  *session.graph.coo(),
                                  session.graph.in_degree)
        err = (torch.as_tensor(st.H[-1], device=DEVICE)
               - H_ref[-1]).abs().amax(dim=1)
        if (err > bound + ORACLE_TOL["atol"]).any():
            raise AssertionError(f"published error {err.max().item()} "
                                 f"exceeds the certified bound "
                                 f"{bound.max().item()}")
        max_err = max(max_err, err.max().item())
        max_bound = max(max_bound, bound.max().item())
        rows.append((res.deferred_rows, res.bound_violations,
                     res.rows_reaggregated))
    result = dict(workload=workload, tolerance=tolerance, batches=n_batches,
                  deferred_rows=[r[0] for r in rows],
                  bound_violations=[r[1] for r in rows],
                  rows_reaggregated=[r[2] for r in rows],
                  max_published_err=max_err, max_error_bound=max_bound,
                  eps_per_layer=session.engine.impl._eps.tolist())
    log("tolerance_session", json.dumps(result))
    return result


def f64_share(session, Hs: list) -> list[float]:
    """The largest share of the per-element 2e-3 bar that each final layer
    in ``Hs`` uses against a float64 full pass over the session's graph
    (the plain segment-sum and the layers in float64): how far fp32
    evaluations of that layer can be from its exact value."""
    import copy
    src, dst, w = session.graph.coo()
    s_t = torch.as_tensor(src, device=DEVICE)
    d_t = torch.as_tensor(dst, device=DEVICE)
    w_t = torch.as_tensor(w, device=DEVICE).double() \
        if session.workload.spec.weighted \
        else torch.ones(len(src), device=DEVICE, dtype=torch.float64)
    k = torch.as_tensor(session.graph.in_degree, device=DEVICE).double()
    h = torch.as_tensor(session.state.H[0], device=DEVICE).double()
    for layer in session.params:
        s_l = torch.zeros_like(h).index_add_(0, d_t, h[s_t] * w_t[:, None])
        h = copy.deepcopy(layer).double()(h, session.workload.normalize(s_l,
                                                                         k))
    bar = ORACLE_TOL["atol"] + ORACLE_TOL["rtol"] * h.abs()
    return [((torch.as_tensor(H, device=DEVICE).double() - h).abs() / bar)
            .max().item() for H in Hs]


def run_full_session(workload: str, counters: dict) -> dict:
    """The ``full`` engine (a from-scratch pass on the card after every
    batch) over the stream's first batches: segment_mm must launch exactly
    once per layer per batch and nothing else at all; each layer's S must
    hold against the plain aggregation of the session's own H (1e-5 of the
    terms' magnitude); a fresh pass over the final graph must give the
    same bits (no atomics); and the final H must hold against a
    ``device``-engine session over the same batches (:func:`hold_close`).
    Also times the bare full pass on the card ("s per full pass"), the
    CSR it builds (upload, sort and work items: ``coo_to_csr``), the
    host's edge export (``graph.coo()``) and the whole state rewrite a
    batch does (export, upload, pass, download of every H and S)."""
    from repro_torch.api.engines import _materialize_state
    from repro_torch.core.full import full_inference
    from repro_torch.kernels.segment_mm import coo_to_csr
    from repro_torch.kernels.segment_mm.ops import partition
    from repro_torch.kernels.segment_mm.ref import segment_mm_ref
    L = ARXIV["n_layers"]
    session, build_s, boot = build_session(workload, "full", counters)
    updates = session.make_stream(N_UPDATES, seed=1).updates
    updates = updates[:N_FULL_BATCHES * BATCH]
    reset_counts(counters)
    partition.launches = 0
    report = session.ingest(updates, batch_size=BATCH)
    torch.cuda.synchronize()
    launches = {name: fn.launches for name, fn in counters.items()}
    partitions = partition.launches
    if partitions != report.n_batches:
        raise AssertionError(f"{workload}/full: the partition ran "
                             f"{partitions} times for {report.n_batches} "
                             f"batches")
    if launches["segment_mm"] != L * report.n_batches \
            or sum(launches.values()) != launches["segment_mm"]:
        raise AssertionError(f"{workload}/full: {launches} launches for "
                             f"{report.n_batches} batches x {L} layers")
    state = session.sync()
    x = torch.as_tensor(state.H[0], device=DEVICE)
    src, dst, w = session.graph.coo()
    w_t = torch.as_tensor(w, device=DEVICE) if session.workload.spec.weighted \
        else torch.ones(len(src), device=DEVICE)
    s_t = torch.as_tensor(src, device=DEVICE)
    d_t = torch.as_tensor(dst, device=DEVICE)
    seg_err = []
    for l in range(1, L + 1):
        h = torch.as_tensor(state.H[l - 1], device=DEVICE)
        plain = segment_mm_ref(s_t, d_t, w_t, h, ARXIV["n"])
        mag = segment_mm_ref(s_t, d_t, w_t.abs(), h.abs(), ARXIV["n"])
        err = (torch.as_tensor(state.S[l], device=DEVICE) - plain).abs()
        if not bool((err <= 1e-5 * mag).all()):
            raise AssertionError(f"{workload}/full: S[{l}] exceeds 1e-5 of "
                                 f"its terms' magnitude")
        seg_err.append(err.max().item())
    pass_s = []
    for _ in range(3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        H_pass, _ = full_inference(session.workload, session.params, x, src,
                                   dst, w, session.graph.in_degree)
        torch.cuda.synchronize()
        pass_s.append(time.perf_counter() - t0)
        for l in range(1, L + 1):
            if not torch.equal(H_pass[l].cpu(),
                               torch.as_tensor(state.H[l])):
                raise AssertionError(f"{workload}/full: a fresh pass gave "
                                     f"other bits at layer {l}")
    csr_s = []
    for _ in range(3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        coo_to_csr(src, dst, w, ARXIV["n"], DEVICE)
        torch.cuda.synchronize()
        csr_s.append(time.perf_counter() - t0)
    t0 = time.perf_counter()
    session.graph.coo()
    coo_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    _materialize_state(session.workload, session.params, session.graph,
                       state, DEVICE)
    materialize_s = time.perf_counter() - t0
    dev, _, _ = build_session(workload, "device", counters)
    dev.ingest(dev.make_stream(N_UPDATES, seed=1).updates[:len(updates)],
               batch_size=BATCH)
    dstate = dev.sync()
    vs_device = [hold_close(torch.as_tensor(state.H[l], device=DEVICE),
                            torch.as_tensor(dstate.H[l], device=DEVICE),
                            f"{workload} full vs device, layer {l}")
                 for l in range(1, L + 1)]
    # both final layers against float64: what fp32 can resolve there
    last_f64_bar_use = dict(zip(("full", "device"),
                                f64_share(session, [state.H[L],
                                                    dstate.H[L]])))
    result = dict(
        workload=workload, engine="full", n=ARXIV["n"],
        edges=session.graph.num_edges, layers=L, batches=report.n_batches,
        batch=BATCH, build_s=build_s, bootstrap_segment_mm_launches=boot,
        launches=launches, partition_launches=partitions,
        p50_ms=report.median_latency_ms,
        batch_ms=[t * 1e3 for t in report.latencies],
        full_pass_s=pass_s, csr_s=csr_s, host_coo_s=coo_s, materialize_s=materialize_s,
        S_err_vs_plain_per_layer=seg_err,
        vs_device_per_layer=vs_device, last_f64_bar_use=last_f64_bar_use)
    log("full_session", json.dumps(result))
    return result


def run_ripple_session(counters: dict) -> dict:
    """The host ``ripple`` engine on gc-s: NumPy on the host over the state
    the full pass bootstrapped on the card; no kernel launches while it
    runs.  Held against the oracle after its batches; its rates are the
    host's."""
    session, build_s, boot = build_session("gc-s", "ripple", counters)
    updates = session.make_stream(N_UPDATES, seed=1).updates
    reset_counts(counters)
    report = session.ingest(updates[:N_RIPPLE_BATCHES * BATCH],
                            batch_size=BATCH)
    launches = {name: fn.launches for name, fn in counters.items()}
    if sum(launches.values()):
        raise AssertionError(f"the host ripple engine launched {launches}")
    vs_oracle = check_oracle(session)
    p50 = report.median_latency_ms
    result = dict(
        workload="gc-s", engine="ripple", n=ARXIV["n"],
        edges=session.graph.num_edges, batches=report.n_batches,
        batch=BATCH, build_s=build_s, bootstrap_segment_mm_launches=boot,
        host_p50_ms=p50, host_p99_ms=report.p99_latency_ms,
        host_steady_ups=BATCH / (p50 * 1e-3),
        affected_per_batch=[int(r.affected.size) for r in report.results],
        vs_oracle_per_layer=vs_oracle)
    log("ripple_session", json.dumps(result))
    return result


def generate(prefill, decode, params, prompts, n_tokens: int):
    """One request through the serving steps: prefill, then greedy decode
    to ``n_tokens`` tokens a sequence.  Returns (tokens [B, n_tokens], the
    logits of each decode step, prefill ms, per-step decode ms); each step
    ends in a synchronise, as a server that hands tokens out would."""
    S = prompts.shape[1]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    logits, caches = prefill(params, prompts)
    tok = logits[:, -1].argmax(-1)
    torch.cuda.synchronize()
    prefill_ms = (time.perf_counter() - t0) * 1e3
    out, step_logits, step_ms = [tok], [], []
    for i in range(n_tokens - 1):
        t0 = time.perf_counter()
        lg, caches = decode(params, caches, tok, S + i)
        tok = lg.argmax(-1)
        torch.cuda.synchronize()
        step_ms.append((time.perf_counter() - t0) * 1e3)
        out.append(tok)
        step_logits.append(lg)
    return torch.stack(out, 1), step_logits, prefill_ms, step_ms


def profile_lm(prefill, decode, params, prompts, n_steps: int) -> dict:
    """One prefill and ``n_steps`` decode steps under torch.profiler: each
    one's device busy share (device time over wall time, which the
    profiler's own host cost inflates) and device operations, and the
    flash_attention kernel's share of the prefill's device time."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    def window(fn):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        dev = [e for e in prof.key_averages()
               if e.device_type == DeviceType.CUDA]
        busy = sum(e.self_device_time_total for e in dev) * 1e-6
        # the flash_attention kernels: flash_kernel_sm90 (wgmma route) and
        # flash_kernel (mma route)
        attn = sum(e.self_device_time_total for e in dev
                   if "flash_kernel" in e.key) * 1e-6
        top = sorted(dev, key=lambda e: -e.self_device_time_total)[:6]
        return dict(wall_ms=wall * 1e3, device_busy_ms=busy * 1e3,
                    device_busy_share=busy / wall if dev else None,
                    device_ops=sum(e.count for e in dev),
                    attention_share=attn / busy if busy else None,
                    top=[[e.key[:60], e.self_device_time_total / 1e3,
                          e.count] for e in top])

    S = prompts.shape[1]
    state = {}

    def run_prefill():
        state["logits"], state["caches"] = prefill(params, prompts)

    def run_decode():
        tok = state["logits"][:, -1].argmax(-1)
        caches = state["caches"]
        for i in range(n_steps):
            lg, caches = decode(params, caches, tok, S + i)
            tok = lg.argmax(-1)

    run_prefill()
    torch.cuda.synchronize()
    run_decode()            # warm the decode path outside the window
    run_prefill()
    return dict(prefill=window(run_prefill),
                decode=dict(steps=n_steps, **window(run_decode)))


def lm_checks(cfg, prefill, params, prompts, tokens, step_logits, *,
              label: str) -> dict:
    """The prefill logits with the kernel against the same model with the
    plain attention, and the logits of decode step ``checked_steps``
    against a re-prefill (kernel) of the prompt and the tokens generated
    up to it; relative L2 of each."""
    from repro_torch.kernels.flash_attention.ref import flash_attention_ref
    from repro_torch.models.lm.steps import make_prefill_step
    t = LM["checked_steps"]
    kern, _ = prefill(params, prompts)
    plain, _ = make_prefill_step(cfg, attention=flash_attention_ref)(
        params, prompts)
    again, _ = make_prefill_step(cfg)(
        params, torch.cat([prompts, tokens[:, :t]], dim=1))
    for name, x in (("kernel", kern), ("plain", plain), ("again", again)):
        if not bool(torch.isfinite(x).all()):
            raise AssertionError(f"{label}: {name} prefill logits are not "
                                 f"finite")
    return dict(kernel_vs_plain=rel_l2(kern, plain),
                decode_vs_reprefill=rel_l2(step_logits[t - 1],
                                           again[:, -1]),
                reprefill_len=prompts.shape[1] + t)


def run_lm(counters: dict) -> dict:
    """Phase 4: phi4-mini-3.8b at full width and depth, served on the card
    (see the module's docstring).  Returns the flash_attention launches of
    the two requests and the numbers printed."""
    import dataclasses
    from repro_torch.configs import get_arch
    from repro_torch.models.lm.model import init_params
    from repro_torch.models.lm.steps import make_decode_step, make_prefill_step
    cfg = get_arch(LM["arch"]).CONFIG
    B, S, T = LM["batch"], LM["prompt"], LM["tokens"]
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    gen = torch.Generator(device=DEVICE).manual_seed(0)
    t0 = time.perf_counter()
    params = init_params(gen, cfg, DEVICE)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    leaves = [t for blk in (params, params["dense_blocks"],
                            params["dense_blocks"]["attn"],
                            params["dense_blocks"]["mlp"])
              for t in blk.values() if isinstance(t, torch.Tensor)]
    n_params = sum(t.numel() for t in leaves)
    param_bytes = sum(t.numel() * t.element_size() for t in leaves)
    prompts = torch.randint(0, cfg.vocab, (B, S), generator=gen,
                            device=DEVICE)
    prefill = make_prefill_step(cfg, max_seq=S + T)
    decode = make_decode_step(cfg)

    # ---- the main path: a warm-up request, then the timed one ------------
    flash = counters["flash_attention"]
    reset_counts(counters)
    generate(prefill, decode, params, prompts, T)
    first = flash.launches
    tokens, step_logits, prefill_ms, step_ms = generate(
        prefill, decode, params, prompts, T)
    launches = {name: fn.launches for name, fn in counters.items()}
    routes = dict(flash.launches_by_route)
    if (first, launches["flash_attention"]) != (cfg.n_layers,
                                                2 * cfg.n_layers) \
            or sum(launches.values()) != launches["flash_attention"]:
        raise AssertionError(f"lm: {first} flash_attention launches in the "
                             f"first request and {launches} after the "
                             f"second; each prefill of {cfg.n_layers} "
                             f"layers must launch it {cfg.n_layers} times "
                             f"and no other kernel")
    if routes["wgmma"] != launches["flash_attention"]:
        raise AssertionError(f"lm: flash_attention launches by route "
                             f"{routes}; every prefill launch must take the "
                             f"wgmma route")
    peak_bf16 = torch.cuda.max_memory_allocated()
    if tokens.shape != (B, T) or not bool(((tokens >= 0)
                                           & (tokens < cfg.vocab)).all()):
        raise AssertionError(f"lm: generated tokens {tuple(tokens.shape)} "
                             f"outside the vocabulary")
    profiled = profile_lm(prefill, decode, params, prompts, 4)
    bf16 = lm_checks(cfg, prefill, params, prompts, tokens, step_logits,
                     label="bf16")
    sample = tokens[0, :8].tolist()
    del params, step_logits
    torch.cuda.empty_cache()

    # ---- fp32 at full width and depth --------------------------------------
    cfg32 = dataclasses.replace(cfg, param_dtype="float32",
                                compute_dtype="float32")
    t = LM["checked_steps"]
    params = init_params(torch.Generator(device=DEVICE).manual_seed(0),
                         cfg32, DEVICE)
    prefill32 = make_prefill_step(cfg32, max_seq=S + t + 1)
    toks32, logits32, _, _ = generate(prefill32, make_decode_step(cfg32),
                                      params, prompts, t + 1)
    fp32 = lm_checks(cfg32, prefill32, params, prompts, toks32, logits32,
                     label="fp32")
    peak_fp32 = torch.cuda.max_memory_allocated()
    del params, logits32
    torch.cuda.empty_cache()
    for dtype, checks in (("bfloat16", bf16), ("float32", fp32)):
        for key in ("kernel_vs_plain", "decode_vs_reprefill"):
            if checks[key] > LM_BARS[dtype]:
                raise AssertionError(f"lm {dtype}: {key} relative L2 "
                                     f"{checks[key]} > {LM_BARS[dtype]}")

    decode_ms = statistics.mean(step_ms)
    result = dict(
        arch=cfg.name, layers=cfg.n_layers, d_model=cfg.d_model,
        heads=cfg.n_heads, kv_heads=cfg.n_kv_heads, d_head=cfg.head_dim,
        d_ff=cfg.d_ff, vocab=cfg.vocab, dtype=cfg.param_dtype, batch=B,
        prompt=S, tokens=T, params=n_params, param_bytes=param_bytes,
        init_s=init_s, launches=launches, flash_routes=routes,
        prefill_ms=prefill_ms,
        prefill_tok_per_s=B * S / (prefill_ms * 1e-3),
        decode_ms_per_token=decode_ms, decode_ms=step_ms,
        generated_tok_per_s=B * (T - 1) / (sum(step_ms) * 1e-3),
        peak_gb_bf16=peak_bf16 / 1e9, peak_gb_fp32_checks=peak_fp32 / 1e9,
        profiled=profiled, bf16=bf16, fp32=fp32, sample=sample)
    log(f"lm: {n_params} parameters ({param_bytes / 1e9:.3f} GB bf16), peak "
        f"{peak_bf16 / 1e9:.3f} GB; prefill {prefill_ms:.3f} ms "
        f"({result['prefill_tok_per_s']:.0f} prompt tok/s); decode "
        f"{decode_ms:.3f} ms/token ({result['generated_tok_per_s']:.1f} "
        f"generated tok/s); device busy: prefill "
        f"{profiled['prefill']['device_busy_share']:.3f}, decode "
        f"{profiled['decode']['device_busy_share']:.3f}; attention "
        f"{profiled['prefill']['attention_share']:.3f} of the prefill's "
        f"device time")
    log(f"lm relative L2: kernel vs plain attention bf16 "
        f"{bf16['kernel_vs_plain']}, fp32 {fp32['kernel_vs_plain']}; decode "
        f"vs re-prefill bf16 {bf16['decode_vs_reprefill']}, fp32 "
        f"{fp32['decode_vs_reprefill']}")
    log("lm_session", json.dumps(result))
    return result


def phase_rungs(sessions: list[dict]) -> dict:
    """The hop kernels timed at every shape (R, Din[, Dh], Dout) the
    sessions launched them at, with those launches: one ``kernel_rung``
    line a shape, and per kernel the sum of launches x (ms - bound), the
    device time its launches lose to its bound (and, for extremum_apply,
    to the replaced K-chunked route, ``prev_ms``).  Returns the sums."""
    checks = {"delta_apply": lambda R, Din, Dout: check_delta(
                  torch.Generator().manual_seed(R), R, Din, Dout, False, True,
                  timed=True),
              "mlp_apply": lambda R, Din, Dh, Dout: check_mlp(
                  torch.Generator().manual_seed(R), R, Din, Dh, Dout, False,
                  True, timed=True),
              "extremum_apply": lambda R, Din, Dout: check_extremum(
                  torch.Generator().manual_seed(R), R, Din, Dout, True, True,
                  timed=True)}
    sums = {}
    for name, check in checks.items():
        launches = {}
        for s in sessions:
            for shape, n in s["by_shape"].get(name, {}).items():
                launches[shape] = launches.get(shape, 0) + n
        total = dict(launches=0, ms=0.0, bound_ms=0.0, loss_ms=0.0)
        if name == "extremum_apply":
            total["prev_ms"] = 0.0
        for shape in sorted(launches):
            n = launches[shape]
            row = check(*shape)
            row.update(launches=n, loss_ms=n * (row["ms"] - row["bound_ms"]))
            log("kernel_rung", json.dumps(row))
            total["launches"] += n
            total["ms"] += n * row["ms"]
            total["bound_ms"] += n * row["bound_ms"]
            total["loss_ms"] += row["loss_ms"]
            if "prev_ms" in total:
                total["prev_ms"] += n * row["prev_ms"]
        sums[name] = total
    log("rungs", json.dumps(sums))
    return sums


def main() -> int:
    if not torch.cuda.is_available():
        sys.exit("chip_smoke: no CUDA device is available")
    if not (ROOT / "src" / "repro_torch").is_dir():
        sys.exit(f"chip_smoke: the port's package is missing beside "
                 f"{Path(__file__).name} (src/repro_torch)")
    sys.path.insert(0, str(ROOT / "src"))
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    from repro_torch.kernels import _build
    from repro_torch.kernels.delta_apply import delta_apply
    from repro_torch.kernels.embedding_bag import embedding_bag
    from repro_torch.kernels.extremum_apply import extremum_apply
    from repro_torch.kernels.flash_attention import flash_attention
    from repro_torch.kernels.mlp_apply import mlp_apply
    from repro_torch.kernels.segment_mm import segment_mm

    # ---- phase 1: build --------------------------------------------------
    build_s = _build.build_all()
    log(f"build: {build_s:.1f} s into {_build.BUILD_DIR}")
    for name, out in _build.BUILD_LOG.items():
        for line in out.splitlines():
            if "registers" in line or "spill" in line:
                log(f"ptxas {name}: {line.strip()}")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    log(f"card: {card}")
    log(f"torch {torch.__version__} cuda {torch.version.cuda} "
        f"device {torch.cuda.get_device_name(0)}")

    # ---- phase 2: kernels against their plain versions -------------------
    # the floor under every kernel time: a one-element add_, timed alike
    one = torch.zeros(1, device=DEVICE)
    log(f"launch floor: {device_ms(lambda: one.add_(1))} ms (one-element "
        f"add_)")
    flash_rows = phase_flash()
    kernel_rows = phase_kernels()

    # ---- phase 3: the main paths, one session each -----------------------
    counters = {"delta_apply": delta_apply, "mlp_apply": mlp_apply,
                "extremum_apply": extremum_apply,
                "embedding_bag": embedding_bag, "segment_mm": segment_mm,
                "flash_attention": flash_attention}
    sessions = [run_session(wl, counters, kernel) for wl, kernel in (
        ("gc-s", "delta_apply"), ("gi-s", "mlp_apply"),
        ("gs-max", "extremum_apply"), ("gc-min", "extremum_apply"),
        ("gp-m", "embedding_bag"), ("ga-s", None))]
    run_tolerance_session()
    full_sessions = [run_full_session(wl, counters)
                     for wl in ("gc-s", "gc-w")]
    ripple = run_ripple_session(counters)
    # the hop kernels at every shape the sessions launched them at
    rungs = phase_rungs(sessions)

    # ---- phase 4: LM serving, flash_attention in every prefill layer -----
    lm = run_lm(counters)

    launches = {name: sum(s["launches"][name] for s in sessions)
                for name in counters}
    launches["flash_attention"] = lm["launches"]["flash_attention"]
    # segment_mm: the full engines' batches and every bootstrap counted
    launches["segment_mm"] = sum(
        s["launches"]["segment_mm"] + s["bootstrap_segment_mm_launches"]
        for s in full_sessions) + sum(
        s["bootstrap_segment_mm_launches"] for s in sessions + [ripple])
    # the partition: once per full pass (checked where each pass ran)
    L = ARXIV["n_layers"]
    partition_launches = sum(
        s["partition_launches"] + s["bootstrap_segment_mm_launches"] // L
        for s in full_sessions) + sum(
        s["bootstrap_segment_mm_launches"] // L
        for s in sessions + [ripple])
    if partition_launches == 0:
        raise AssertionError("the partition never launched on the main "
                             "path")
    for name, count in launches.items():
        if count == 0:
            raise AssertionError(f"{name} never launched on the main path")

    # ---- the kernels line: timed at the main path's largest hop ----------
    gen = torch.Generator().manual_seed(1)
    kernels = []
    for name, source, replaces, check in (
            ("delta_apply", "src/repro_torch/kernels/csrc/delta_apply.cu",
             "src/repro/kernels/delta_apply/kernel.py:61",
             lambda R, D: check_delta(gen, R, 128, D, False, True,
                                      timed=True)),
            ("mlp_apply", "src/repro_torch/kernels/csrc/mlp_apply.cu",
             "src/repro/kernels/mlp_apply/kernel.py:66",
             lambda R, D: check_mlp(gen, R, 128, D, D, False, True,
                                    timed=True)),
            ("extremum_apply",
             "src/repro_torch/kernels/csrc/extremum_apply.cu",
             "src/repro/kernels/extremum_apply/kernel.py:115",
             lambda R, D: check_extremum(gen, R, 128, D, True, True,
                                         timed=True))):
        R = max(c[0] for s in sessions if s["launches"][name]
                for c in s["hop_caps"])
        rows = [check(R, D) for D in (128, 40)]
        for row in rows:
            log("kernel_main", json.dumps(row))
        row = rows[0]
        kernels.append(dict(
            name=name, route="cuda", source=source, replaces=replaces,
            launches=launches[name], max_abs_err=row["max_abs_err"],
            ms=row["ms"], plain_ms=row["plain_ms"],
            bound_ms=row["bound_ms"], bound_by=row["bound_by"],
            library_ms=None, shape=f"R={R} Din=128 Dout=128",
            main_path_ms=rungs[name]["ms"],
            main_path_loss_ms=rungs[name]["loss_ms"], passed=True))
        if name == "extremum_apply":
            kernels[-1].update(kernel_route=row["route"],
                               prev_ms=row["prev_ms"],
                               prev_design="K-chunked route",
                               main_path_prev_ms=rungs[name]["prev_ms"])
    # embedding_bag at the largest rectangle the gp-m session's hops used
    pnm = next(s for s in sessions if s["workload"] == "gp-m")
    B, hot = max(((c[0], c[3]) for c in pnm["hop_caps"]),
                 key=lambda c: c[0] * c[1])
    indeg = arxiv_in_degrees()
    degs = indeg[torch.randint(0, ARXIV["n"], (B,), generator=gen)]
    degs[0] = indeg.max()
    row = check_embedding_bag(99, ARXIV["n"], B, hot, 128, degs=degs,
                              timed=True)
    log("kernel_main", json.dumps(row))
    kernels.append(dict(
        name="embedding_bag", route="cuda",
        source="src/repro_torch/kernels/csrc/embedding_bag.cu",
        replaces="src/repro/kernels/embedding_bag/kernel.py:47",
        launches=launches["embedding_bag"], max_abs_err=row["max_abs_err"],
        ms=row["ms"], plain_ms=row["plain_ms"], bound_ms=row["bound_ms"],
        bound_by=row["bound_by"], library_ms=row["library_ms"],
        shape=f"B={B} hot={hot} d=128 kept={row['kept_lanes']}",
        passed=True))
    # segment_mm at the full pass's shape, timed in phase 2
    row, row40 = (next(r for r in kernel_rows if r["kernel"] == "segment_mm"
                       and r["n"] == ARXIV["n"] and r["d"] == d)
                  for d in (128, 40))
    kernels.append(dict(
        name="segment_mm", route="cuda",
        source="src/repro_torch/kernels/csrc/segment_mm.cu",
        replaces="src/repro/kernels/segment_mm/kernel.py:74",
        launches=launches["segment_mm"], max_abs_err=row["max_abs_err"],
        ms=row["ms"], plain_ms=row["plain_ms"], bound_ms=row["bound_ms"],
        bound_by=row["bound_by"], library_ms=row["library_ms"],
        shape=f"n={row['n']} E={row['E']} d=128 "
              f"max_in_degree={row['max_in_degree']}",
        ms_d40=row40["ms"], library_ms_d40=row40["library_ms"],
        bound_ms_d40=row40["bound_ms"], plain_ms_d40=row40["plain_ms"],
        # the CSR's work items: two kernels in the same source (host clock,
        # their readback included), against the plain partition
        partition_launches=partition_launches,
        partition_ms=row["partition_ms"],
        partition_plain_ms=row["partition_plain_ms"],
        passed=True))
    # flash_attention at the prefill's shape, timed in phase 2: the wgmma
    # route, which took every prefill launch
    row = next(r for r in flash_rows if "ms" in r
               and r["dtype"] == str(torch.bfloat16)
               and (r["B"], r["S"], r["H"], r["Hkv"], r["Dh"])
               == tuple(PREFILL.values()))
    kernels.append(dict(
        name="flash_attention", route="cuda",
        source="src/repro_torch/kernels/csrc/flash_attention_sm90.cu",
        replaces="src/repro/kernels/flash_attention/kernel.py:86",
        launches=launches["flash_attention"],
        max_abs_err=row["max_abs_err"], ms=row["ms"],
        plain_ms=row["plain_ms"], bound_ms=row["bound_ms"],
        bound_by=row["bound_by"], library_ms=row["library_ms"],
        library_backend=row["library_backend"],
        kernel_route=row["route"], launches_by_route=lm["flash_routes"],
        shape="B={B} S={S} H={H} Hkv={Hkv} Dh={Dh} bf16 causal".format(
            **PREFILL),
        passed=True))
    torch.cuda.synchronize()

    print(card, flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
