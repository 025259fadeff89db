"""Plain PyTorch version of the message-passing SpMM:
out[v] = sum_{(u, v)} w_uv * x[u], summed in fp32 and cast back to x's
dtype."""
import torch


def segment_mm_ref(src, dst, w, x, n: int):
    """``src``/``dst`` ``[E]`` int32 or int64 edge ends, ``w [E]`` fp32,
    ``x [n_x, d]`` -> ``[n, d]``.  For fp32 ``x`` this is the full pass's
    segment-sum as it stood before the kernel (``index_add_`` in edge
    order)."""
    out = torch.zeros((n, x.shape[1]), dtype=torch.float32, device=x.device)
    out.index_add_(0, dst, x[src].float() * w[:, None])
    return out.to(x.dtype)
