"""Wrapper of causal grouped-query attention: one of two CUDA kernels for
CUDA tensors, chosen by :func:`kernel_route` before the launch, the plain
version (``ref.py``) for CPU tensors.

- ``"wgmma"``: ``csrc/flash_attention_sm90.cu``, wgmma + TMA with a
  warp-specialised pipeline, for bf16 at head dims 64 and 128;
- ``"mma"``: ``csrc/flash_attention.cu``, ``mma.sync`` (bf16) or FMA
  (fp32), for fp32 at every head dim of :data:`HEAD_DIMS` and bf16 at
  8, 16 and 32.

A failed build or launch raises; nothing runs the other kernel or the
plain version in its place.

Gradients: when grad mode is on and q, k or v requires a gradient, the
call goes through :class:`FlashAttentionFn`, whose forward is the same
launch (the plain version on the CPU) and whose backward is plain
PyTorch: autograd of the chunked plain formulation
(``ref.attention_grads``), the gradient the reference's training takes of
its own plain attention.  No TPU kernel has a backward to port.

The forward is the custom op ``torch.ops.repro_torch.flash_attention``
(q, k, v, chunk): its implementation is :func:`_forward`, its fake
implementation returns the output's shape and dtype and launches nothing,
and its FLOP formula counts 4 Dh FLOPs for each causal (query, key) pair
and query head; ``sharding.py`` holds its DTensor strategy and layout.  So
the dry-run traces it on fake tensors and ``DTensor`` s, which a ctypes
launch cannot see.  Its gradient is :class:`FlashAttentionFn`'s."""
from __future__ import annotations

import ctypes
import functools

import torch
from torch.utils.flop_counter import register_flop_formula

from .. import _build
from .._common import cuda_device, on_cpu
from .ref import attention_grads, flash_attention_ref

HEAD_DIMS = (8, 16, 32, 64, 128)
WGMMA_HEAD_DIMS = (64, 128)
ROUTES = ("wgmma", "mma")


def kernel_route(dtype: torch.dtype, head_dim: int, n_heads: int,
                 n_kv_heads: int) -> str:
    """The kernel that takes attention of this dtype and shape: ``"wgmma"``
    for bf16 at :data:`WGMMA_HEAD_DIMS`, ``"mma"`` for the rest of fp32 or
    bf16 at :data:`HEAD_DIMS`.  Raises ``TypeError`` for another dtype and
    ``ValueError`` for another head dim or query heads that do not group
    evenly over the kv heads."""
    if dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"q is {dtype}, expected torch.float32 or "
                        f"torch.bfloat16")
    if head_dim not in HEAD_DIMS:
        raise ValueError(f"head dim {head_dim} is not one of {HEAD_DIMS}")
    if n_kv_heads < 1 or n_heads < 1 or n_heads % n_kv_heads:
        raise ValueError(f"{n_heads} query heads do not group over "
                         f"{n_kv_heads} kv heads")
    if dtype == torch.bfloat16 and head_dim in WGMMA_HEAD_DIMS:
        return "wgmma"
    return "mma"


@functools.cache
def _launcher(route: str):
    if route == "wgmma":
        fn = _build.load("flash_attention_sm90").flash_attention_sm90_launch
        fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 5 \
            + [ctypes.c_void_p]
    else:
        fn = _build.load("flash_attention").flash_attention_launch
        fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 6 \
            + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


@torch.library.custom_op("repro_torch::flash_attention", mutates_args=())
def _flash_op(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
              chunk: int) -> torch.Tensor:
    """Causal attention: the kernel on a card, the plain version on the
    CPU (:func:`_forward`).  ``chunk`` is the backward's query chunk."""
    return _forward(q, k, v)


@_flash_op.register_fake
def _(q, k, v, chunk):
    return torch.empty_like(q)


def _grads(q, k, v, grad_out, chunk):
    """:func:`ref.attention_grads` of ``grad_out``; on ``DTensor`` s (the
    dry-run), per shard of q's layout (``sharding.per_shard``)."""
    from torch.distributed.tensor import DTensor
    if isinstance(q, DTensor):
        from .sharding import per_shard
        return per_shard(lambda q_, k_, v_, g_: attention_grads(
            q_, k_, v_, g_.contiguous(), chunk), (q, k, v, grad_out), 3)
    return attention_grads(q, k, v, grad_out.contiguous(), chunk)


@register_flop_formula(torch.ops.repro_torch.flash_attention)
def _flash_flops(q_shape, k_shape, v_shape, chunk, *args, **kwargs) -> int:
    """4 Dh FLOPs (q.k and p.v) for each causal pair of each query head:
    the work PERF.md's bound counts."""
    B, S, H, Dh = q_shape
    return 4 * Dh * H * B * (S * (S + 1) // 2)


class FlashAttentionFn(torch.autograd.Function):
    """Causal attention whose forward is the kernel (the plain version on
    the CPU), through the custom op, and whose backward is
    :func:`ref.attention_grads`, ``chunk`` queries at a time.  Saves q, k
    and v."""

    @staticmethod
    def forward(ctx, q, k, v, chunk):
        ctx.save_for_backward(q, k, v)
        ctx.chunk = chunk
        return torch.ops.repro_torch.flash_attention(q, k, v, chunk)

    @staticmethod
    def backward(ctx, grad_out):
        q, k, v = ctx.saved_tensors
        return (*_grads(q, k, v, grad_out, ctx.chunk), None)


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    chunk: int | None = None) -> torch.Tensor:
    """Causal attention of q ``[B,S,H,Dh]`` over k/v ``[B,S,Hkv,Dh]`` with
    the ``H / Hkv`` query heads of each kv head grouped together; returns
    ``[B,S,H,Dh]`` in q's dtype.  fp32 or bf16, all three of one dtype,
    contiguous; ``Dh`` one of :data:`HEAD_DIMS`; any ``S``.  With grad
    mode on and an input that requires a gradient it goes through
    :class:`FlashAttentionFn`, whose backward takes ``chunk`` queries at a
    time (all ``S`` at once when None).
    ``flash_attention.launches`` counts the kernel launches of this
    process and ``flash_attention.launches_by_route`` each route's."""
    from torch.distributed.tensor import DTensor
    if isinstance(q, DTensor):
        from .sharding import attention_layout
        q, k, v = attention_layout(q, k, v)
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad
                                    or v.requires_grad):
        return FlashAttentionFn.apply(q, k, v, chunk or max(q.shape[1], 1))
    return torch.ops.repro_torch.flash_attention(q, k, v,
                                                 chunk or max(q.shape[1], 1))


def _forward(q, k, v):
    """The launch of :func:`flash_attention` (its plain version for CPU
    tensors), outside autograd."""
    if on_cpu(q, k, v):
        return flash_attention_ref(q, k, v)
    dev = cuda_device(q)
    if q.dim() != 4 or k.dim() != 4:
        raise ValueError(f"q and k must be 4-D; got {tuple(q.shape)}, "
                         f"{tuple(k.shape)}")
    B, S, H, Dh = q.shape
    Hkv = k.shape[2]
    route = kernel_route(q.dtype, Dh, H, Hkv)
    for name, t, shape in (("q", q, (B, S, H, Dh)), ("k", k, (B, S, Hkv, Dh)),
                           ("v", v, (B, S, Hkv, Dh))):
        if t.device != dev:
            raise ValueError(f"{name} is on {t.device}, expected {dev}")
        if t.dtype != q.dtype:
            raise TypeError(f"{name} is {t.dtype}, expected {q.dtype}")
        if tuple(t.shape) != shape:
            raise ValueError(f"{name} has shape {tuple(t.shape)}, expected "
                             f"{shape}")
        if not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError(f"{name} is not contiguous and 16-byte aligned")
    if B * S * H * Dh >= 2**31:
        raise ValueError(f"q has {B * S * H * Dh} elements, beyond the "
                         f"kernel's int32 extents")
    out = torch.empty_like(q)
    if B == 0 or S == 0:
        return out
    args = [q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), B, S,
            H, Hkv, Dh]
    if route == "mma":
        args.append(int(q.dtype == torch.bfloat16))
    with torch.cuda.device(dev):
        err = _launcher(route)(*args,
                               torch.cuda.current_stream(dev).cuda_stream)
    if err:
        raise RuntimeError(f"flash_attention kernel launch failed ({route} "
                           f"route): CUDA error {err}")
    flash_attention.launches += 1
    flash_attention.launches_by_route[route] += 1
    return out


flash_attention.launches = 0
flash_attention.launches_by_route = dict.fromkeys(ROUTES, 0)
