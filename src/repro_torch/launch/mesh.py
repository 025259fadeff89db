"""Device meshes for the distributed engine, over ``torch.distributed``.

Functions, not module-level constants: importing this module starts no
process group.  A mesh names its dimensions as the JAX package's does,
``("data", "model")`` or ``("pod", "data", "model")``, so a
``SessionConfig`` with ``data_axes=("pod", "data")`` means the same
geometry in both packages.  Every rank calls the same function with the
same arguments (``init_device_mesh`` is collective); the default process
group must exist first (``torchrun`` sets it up from its environment).
"""
from __future__ import annotations

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh, init_device_mesh


def make_production_mesh(*, multi_pod: bool = False,
                         device_type: str = "cuda") -> DeviceMesh:
    """The reference's production geometry: 16 x 16, or 2 x 16 x 16 over
    two pods (512 ranks)."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return init_device_mesh(device_type, shape, mesh_dim_names=axes)


def make_local_mesh(data: int = 1, model: int = 1,
                    device_type: str = "cuda") -> DeviceMesh:
    """A ``(data, model)`` mesh over the ranks of the default process group
    (tests, one host)."""
    return init_device_mesh(device_type, (data, model),
                            mesh_dim_names=("data", "model"))


_DEFAULT_MESHES: dict = {}   # (device type, world size) -> mesh


def default_mesh(device) -> DeviceMesh:
    """The mesh a ``dist`` session takes when it is given none: the
    initialised default process group as ``data`` = world size and
    ``model`` = 1, or else one rank on ``device`` (NCCL on ``cuda``, gloo
    on ``cpu``).  The one-rank group and each mesh are made once per
    process and reused, so many sessions in one process do not collide."""
    if not dist.is_initialized():
        dev = torch.device(device)
        dist.init_process_group("nccl" if dev.type == "cuda" else "gloo",
                                store=dist.HashStore(), rank=0,
                                world_size=1)
    device_type = "cuda" if dist.get_backend() == "nccl" else "cpu"
    key = (device_type, dist.get_world_size())
    if key not in _DEFAULT_MESHES:
        _DEFAULT_MESHES[key] = make_local_mesh(
            data=dist.get_world_size(), model=1, device_type=device_type)
    return _DEFAULT_MESHES[key]
