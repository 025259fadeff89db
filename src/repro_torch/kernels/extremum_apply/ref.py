"""Plain PyTorch version of the fused monotonic hop apply:
base = mask ? reagg : S; S' = max|min(base, M); h = act(finite(S') @ W + b)."""
import torch


def extremum_apply_ref(S, mailbox, W, b, *, reagg=None, mask=None,
                       maximize: bool, relu: bool):
    if reagg is not None:
        S = torch.where(mask != 0, reagg, S)
    S_new = torch.maximum(S, mailbox) if maximize \
        else torch.minimum(S, mailbox)
    x = torch.where(torch.isfinite(S_new), S_new, 0.0)
    h = x @ W + b
    if relu:
        h = torch.relu(h)
    return S_new, h
