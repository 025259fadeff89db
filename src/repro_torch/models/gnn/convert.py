"""Weight carry from the reference: a GNN parameter tree of ``repro``'s
(``INIT``/``SMOKE_INIT``), as NumPy arrays, into the port's."""
from __future__ import annotations

import numpy as np
import torch


def params_from_numpy(tree, device="cuda"):
    """The port's parameters from the reference's GNN tree (nested dicts
    and lists of arrays: ``np.asarray`` of each JAX leaf): the same keys,
    list order, shapes and dtypes, each leaf a tensor on ``device``,
    ``"_zeros"`` included.  Raises on a leaf that is not a float array."""

    def conv(t, path):
        if isinstance(t, dict):
            return {k: conv(v, f"{path}/{k}") for k, v in t.items()}
        if isinstance(t, (list, tuple)):
            return [conv(v, f"{path}/{i}") for i, v in enumerate(t)]
        a = np.asarray(t)
        if a.dtype.kind != "f":
            raise TypeError(f"{path or 'the tree'} is {a.dtype}, not a float "
                            f"array")
        return torch.as_tensor(np.array(a), device=device)

    return conv(tree, "")
