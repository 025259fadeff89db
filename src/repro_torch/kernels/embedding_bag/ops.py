"""Wrapper of the sum-mode bag: the CUDA kernel (``csrc/embedding_bag.cu``)
for CUDA tensors, the plain version (``ref.py``) for CPU tensors.

The kernel has two routes, chosen by :func:`kernel_plan` before the launch:

- ``"narrow"``: short bags, many to a block -- groups of threads read rows
  as 16-byte vectors, a warp's ids come in one coalesced load and are
  handed out by shuffles, persistent blocks walk the bags (rows of a
  multiple of 16 bytes up to 512, hot up to :data:`NARROW_MAX_HOT`, table
  and output 16-byte aligned);
- ``"span"``: one block per (bag, 4096-lane span, 128-column tile), padding
  compacted in shared memory (the design the narrow route replaced for
  short bags), for wide bags and every other shape.

A failed build or launch raises; nothing runs the plain version in its
place.

Gradients: when grad mode is on and the table requires a gradient, the
call goes through :class:`EmbeddingBagFn`, whose forward is the same
launch (the plain version on the CPU) and whose backward is the bag's
transpose in plain PyTorch, a dense ``index_add_`` into the table's
shape -- the gradient of the reference's ``take`` + sum.  No TPU kernel
has a backward to port.

The launch is the custom op ``torch.ops.repro_torch.embedding_bag``
(table, idx, padding_idx): its implementation is :func:`_forward`, its
fake implementation returns the output's shape and dtype and launches
nothing, and its FLOP formula counts one add per lane and column (B hot
d).  So the dry-run traces it on fake tensors, which a ctypes launch
cannot see, and ``FlopCounterMode`` counts it on a card as a trace
does.  On ``DTensor`` s the bag runs per shard of a row-sharded table
(``sharding.py``)."""
from __future__ import annotations

import ctypes
import functools

import torch
from torch.utils.flop_counter import register_flop_formula

from repro_torch.utils import is_dtensor

from .. import _build, _resident
from .._common import cuda_device, on_cpu
from .ref import embedding_bag_ref

ROUTES = ("narrow", "span")
_ROUTE_IDS = {"span": 0, "narrow": 1}   # embedding_bag_launch's `route`
SPAN_LANES = 4096          # lanes a span block sums (SPLIT in the source)
NARROW_WARPS = 4           # warps a narrow block (NARROW_THREADS / 32)
NARROW_BLOCKS_PER_SM = 4   # narrow blocks a SM (3 for fp32 at 1 or 16 lanes)
# row loads a thread keeps in flight over several bags (fp32, bf16), and
# over the lanes of one bag
NARROW_LOADS = {False: 8, True: 4}
NARROW_LANES = {False: 16, True: 8}
# The widest bag the narrow route takes: the crossover of the sweep in
# kernel_plan's docstring (chip_smoke.py's bag_sweep line).
NARROW_MAX_HOT = 16


@functools.cache
def kernel_plan(B: int, hot: int, d: int, bf16: bool, n_sm: int,
                aligned: bool = True) -> dict:
    """How the kernel takes ``B`` bags of ``hot`` lanes over rows of ``d``
    fp32 (or bf16) elements on a card of ``n_sm`` SMs, ``aligned`` when the
    table and the output start on 16-byte boundaries: :func:`narrow_plan`
    where a row is a multiple of 16 bytes and at most 512 and hot at most
    NARROW_MAX_HOT, else ``{"route": "span", "spans": ceil(hot /
    SPAN_LANES)}`` (1 for hot <= SPAN_LANES; with more, an fp32 scratch of
    ``[B * spans, d]``).  Cached: the dict returned is shared, not to be
    changed.

    NARROW_MAX_HOT is the largest hot up to which the narrow route is
    nowhere more than 5% slower than the span route (run-to-run spread) in
    a sweep on an NVIDIA H100 80GB HBM3 at 700 W (chip_smoke.py's
    ``bag_sweep``: ids uniform over 4,194,304 rows, both routes in turns).
    Narrow ms / span ms at hot 1, 2, 4, 8, 16, 32, 64, 256:

    ======================  ====  ====  ====  ====  ====  ====  ====  ====
    fp32 d 64, B 512        1.00  0.92  0.93  0.93  0.95  1.08  1.21  1.32
    fp32 d 64, B 262,144    0.17  0.22  0.35  0.58  0.73  0.86  0.93  0.95
    fp32 d 128, B 512       1.00  0.93  0.94  0.95  0.98  1.08  1.16  0.97
    fp32 d 128, B 262,144   0.27  0.37  0.54  0.89  0.99  1.00  1.00  1.00
    bf16 d 64, B 512        0.93  0.90  0.90  0.95  1.01  1.19  1.43  2.02
    bf16 d 64, B 262,144    0.10  0.14  0.22  0.31  0.42  0.55  0.64  0.70
    bf16 d 128, B 512       0.92  0.88  0.91  0.95  0.98  1.13  1.28  1.60
    bf16 d 128, B 262,144   0.15  0.21  0.32  0.47  0.62  0.80  0.88  0.89
    ======================  ====  ====  ====  ====  ====  ====  ====  ====

    At B 512 both take 6-7 us up to hot 16 (the launch floor is ~5 us);
    past it the narrow route's warps walk their bags' lanes a window at a
    time while the span route spreads each bag over a block, so the
    engine's rectangles (hot 64 and up, mostly padding) stay on the span
    route."""
    row = d * (2 if bf16 else 4)
    if aligned and row % 16 == 0 and row <= 512 and hot <= NARROW_MAX_HOT:
        return narrow_plan(B, hot, d, bf16, n_sm)
    return span_plan(hot)


def span_plan(hot: int) -> dict:
    """The span route for bags of ``hot`` lanes."""
    return dict(route="span", spans=max(1, -(-hot // SPAN_LANES)))


@functools.cache
def narrow_plan(B: int, hot: int, d: int, bf16: bool, n_sm: int) -> dict:
    """The narrow route at any hot (kernel_plan bounds hot; the sweep
    times beyond it): ``{"route": "narrow", "group": G, "bags": u,
    "lanes": w, "tile": nb, "grid": blocks}`` -- groups of G threads (the
    row's 16-byte vectors, rounded up to a power of two), w lanes of a bag
    in flight (hot rounded up to a power of two, at most NARROW_LANES), u =
    max(1, NARROW_LOADS / w) bags a group but at most G (so that a warp
    tile holds nb = 32 / G * u <= 32 bags), at most 3 or 4 blocks of
    NARROW_WARPS warps a SM (the kernel's launch bounds, ``Narrow::BLOCKS``
    in the source) and no more than the tiles need.  The row must be a
    multiple of 16 bytes and at most 512."""
    vecs = d * (2 if bf16 else 4) // 16
    group = 1 << (vecs - 1).bit_length()
    w = min(NARROW_LANES[bf16], 1 << (max(hot, 1) - 1).bit_length())
    most = max(1, NARROW_LOADS[bf16] // w)
    u = min(most, group)
    # a thread's fp32 sums (2 E a bag), loads in flight (4 words each) and
    # their addresses (2 each) for `most` bags a group, past 96 registers:
    # 3 blocks
    elems = 8 if bf16 else 4
    heavy = 2 * elems * most + 6 * most * w > 96
    blocks = 3 if heavy else NARROW_BLOCKS_PER_SM
    tile = 32 // group * u
    grid = min(n_sm * blocks, -(-B // (tile * NARROW_WARPS)))
    return dict(route="narrow", group=group, bags=u, lanes=w, tile=tile,
                grid=max(1, grid))


@functools.cache
def _launcher():
    fn = _build.load("embedding_bag").embedding_bag_launch
    fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 12 \
        + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def launch(plan: dict, table, idx, out, padding_idx: int | None) -> None:
    """Launch ``plan``'s route on the current stream, uncounted; raises on
    a CUDA error.  The operands are checked by the caller; the span route's
    scratch is allocated here."""
    (V, d), (B, hot) = table.shape, idx.shape
    spans = plan.get("spans", 1)
    partial = torch.empty((B * spans, d), dtype=torch.float32,
                          device=out.device) if spans > 1 else None
    err = _launcher()(table.data_ptr(), idx.data_ptr(), out.data_ptr(),
                      None if partial is None else partial.data_ptr(),
                      V, d, B, hot, -1 if padding_idx is None else padding_idx,
                      int(table.dtype == torch.bfloat16),
                      _ROUTE_IDS[plan["route"]], spans,
                      plan.get("group", 1).bit_length() - 1,
                      plan.get("bags", 0), plan.get("lanes", 0),
                      plan.get("grid", 0),
                      torch.cuda.current_stream(out.device).cuda_stream)
    if err:
        raise RuntimeError(f"embedding_bag kernel launch failed ({plan}): "
                           f"CUDA error {err}")


@torch.library.custom_op("repro_torch::embedding_bag", mutates_args=())
def _bag_op(table: torch.Tensor, idx: torch.Tensor,
            padding_idx: int | None) -> torch.Tensor:
    """The sum-mode bag: the kernel on a card, the plain version on the
    CPU (:func:`_forward`)."""
    return _forward(table, idx, padding_idx)


@_bag_op.register_fake
def _(table, idx, padding_idx):
    return table.new_empty((idx.shape[0], table.shape[1]))


@register_flop_formula(torch.ops.repro_torch.embedding_bag)
def _bag_flops(table_shape, idx_shape, padding_idx, *args, **kwargs) -> int:
    """One add per lane and column, B hot d (the work PERF.md's bound
    counts); lanes skipped as padding are counted too."""
    (B, hot), d = idx_shape, table_shape[1]
    return B * hot * d


class EmbeddingBagFn(torch.autograd.Function):
    """The sum-mode bag whose forward is the kernel (the plain version on
    the CPU) and whose backward is the transpose of the bag:
    ``grad_table[idx[b, h]] += grad_out[b]`` over every lane but those
    equal to ``padding_idx``, summed in fp32 into a dense ``[V, d]``
    gradient (every row, as JAX's gradient of ``take``: an optimizer's
    moments and weight decay move rows no bag read) and rounded once to
    the table's dtype.  ``idx`` gets no gradient."""

    @staticmethod
    def forward(ctx, table, idx, padding_idx):
        ctx.save_for_backward(idx)
        ctx.table = (table.shape, table.dtype)
        ctx.padding_idx = padding_idx
        return torch.ops.repro_torch.embedding_bag(table, idx, padding_idx)

    @staticmethod
    def backward(ctx, grad_out):
        (idx,), (shape, dtype) = ctx.saved_tensors, ctx.table
        B, hot = idx.shape
        rows = idx.reshape(-1).long()
        src = grad_out.float()[:, None, :].expand(B, hot, shape[1]) \
            .reshape(B * hot, shape[1])
        if ctx.padding_idx is not None:   # a skipped lane adds 0
            src = torch.where((rows != ctx.padding_idx)[:, None], src, 0.0)
        grad = torch.zeros(shape, dtype=torch.float32,
                           device=grad_out.device).index_add_(0, rows, src)
        return grad.to(dtype), None, None


def embedding_bag(table, idx, padding_idx: int | None = None):
    """``out[b] = sum_h table[idx[b, h]]`` for ``idx [B, hot]`` int32 and
    ``table [V, d]`` fp32 or bf16; returns ``[B, d]`` in the table's dtype
    (a bf16 table is summed in fp32 and rounded once).  Lanes equal to
    ``padding_idx`` skip the row read and add nothing.  An index outside
    ``[0, V)`` is never clamped: on the CPU it raises, on a card the kernel
    traps, which surfaces at the next synchronisation.
    With grad mode on and a table that requires a gradient it goes through
    :class:`EmbeddingBagFn`.  A ``DTensor`` table runs per shard
    (``sharding.bag``).
    ``embedding_bag.launches`` counts the kernel launches of this process,
    ``launches_by_route`` each route's.
    """
    if is_dtensor(table):
        from .sharding import bag
        return bag(table, idx, padding_idx)
    if not on_cpu(table, idx):
        cuda_device(table)     # the op's fake would take any other device
    if torch.is_grad_enabled() and table.requires_grad:
        return EmbeddingBagFn.apply(table, idx, padding_idx)
    return torch.ops.repro_torch.embedding_bag(table, idx, padding_idx)


def _forward(table, idx, padding_idx):
    """The launch of :func:`embedding_bag` (its plain version for CPU
    tensors), outside autograd: the custom op's implementation."""
    if on_cpu(table, idx):
        return embedding_bag_ref(table, idx, padding_idx)
    dev = cuda_device(table)
    for name, t in (("table", table), ("idx", idx)):
        if t.device != dev:
            raise ValueError(f"{name} is on {t.device}, expected {dev}")
        if t.dim() != 2:
            raise ValueError(f"{name} must be 2-D, got shape "
                             f"{tuple(t.shape)}")
        if not t.is_contiguous():
            raise ValueError(f"{name} is not contiguous")
    if idx.dtype != torch.int32:
        raise TypeError(f"idx is {idx.dtype}, expected torch.int32")
    if table.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"table is {table.dtype}, expected torch.float32 or "
                        f"torch.bfloat16")
    (V, d), (B, hot) = table.shape, idx.shape
    if padding_idx is not None and not 0 <= padding_idx < V:
        raise ValueError(f"padding_idx {padding_idx} outside [0, {V})")
    out = torch.empty((B, d), dtype=table.dtype, device=dev)
    if B == 0 or d == 0:
        return out
    plan = kernel_plan(B, hot, d, table.dtype == torch.bfloat16,
                       _resident.device_limits(dev.index or 0)[0],
                       _resident.aligned(table, out))
    if max(V, B, hot) >= 2**31 or plan["route"] == "span" \
            and B * plan["spans"] * -(-d // 128) >= 2**31:
        raise ValueError(f"idx {tuple(idx.shape)} with table "
                         f"{tuple(table.shape)} exceeds the kernel's int32 "
                         f"extents and grid")
    with torch.cuda.device(dev):
        launch(plan, table, idx, out, padding_idx)
    embedding_bag.launches += 1
    embedding_bag.launches_by_route[plan["route"]] += 1
    return out


embedding_bag.launches = 0
embedding_bag.launches_by_route = dict.fromkeys(ROUTES, 0)
