"""Plain PyTorch version of the sum-mode bag: out[b] = sum_h table[idx[b, h]]
(lanes equal to ``padding_idx`` add nothing), summed in fp32 and cast back
to the table's dtype."""
import torch


def embedding_bag_ref(table, idx, padding_idx=None, *, max_elems=1 << 28):
    """``table [V, d]``, ``idx [B, hot]`` -> ``[B, d]``.  Bags are taken a
    few at a time so the gathered ``[bags, hot, d]`` block holds at most
    about ``max_elems`` elements."""
    B, hot = idx.shape
    out = torch.empty((B, table.shape[1]), dtype=torch.float32,
                      device=table.device)
    step = max(1, max_elems // max(hot * table.shape[1], 1))
    for b0 in range(0, B, step):
        rows = idx[b0:b0 + step].long()
        g = table[rows].float()
        if padding_idx is not None:
            g = torch.where((rows != padding_idx)[..., None], g, 0.0)
        out[b0:b0 + step] = g.sum(1)
    return out.to(table.dtype)
