"""Plain PyTorch version of the fused GIN apply (matches ``GinLayer``)."""
import torch


def mlp_apply_ref(S, mailbox, h_prev, k, eps: float, W1, b1, W2, b2, *,
                  mean: bool, relu: bool):
    S_new = S + mailbox
    x = S_new / torch.clamp(k, min=1.0)[:, None] if mean else S_new
    z = (1.0 + eps) * h_prev + x
    h = torch.relu(z @ W1 + b1) @ W2 + b2
    if relu:
        h = torch.relu(h)
    return S_new, h
