"""Operand checks shared by the kernel wrappers."""
from __future__ import annotations

import torch


def on_cpu(*tensors: torch.Tensor) -> bool:
    """True when every operand lies on the CPU (the plain-version route)."""
    return all(t.device.type == "cpu" for t in tensors)


def check_operand(name: str, t: torch.Tensor, shape: tuple,
                  device: torch.device,
                  dtype: torch.dtype = torch.float32) -> None:
    """Raise unless ``t`` is a contiguous ``dtype`` (fp32) tensor of
    ``shape`` on the CUDA ``device``: what the kernels take, and nothing
    else."""
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise TypeError(f"{name} is {t.dtype}, expected {dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} has shape {tuple(t.shape)}, expected "
                         f"{tuple(shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} is not contiguous")


def cuda_device(t: torch.Tensor) -> torch.device:
    if t.device.type != "cuda":
        raise ValueError(f"operands must all lie on the CPU or on one CUDA "
                         f"device; got {t.device}")
    return t.device
