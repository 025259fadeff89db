"""Plain PyTorch version of the fused hop apply: S' = S + M;
h = act(norm(S', k) @ W + b)."""
import torch


def delta_apply_ref(S, mailbox, k, W, b, *, mean: bool, relu: bool):
    S_new = S + mailbox
    x = S_new / torch.clamp(k, min=1.0)[:, None] if mean else S_new
    h = x @ W + b
    if relu:
        h = torch.relu(h)
    return S_new, h
