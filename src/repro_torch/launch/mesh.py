"""Device meshes for the distributed engine, over ``torch.distributed``.

Functions, not module-level constants: importing this module starts no
process group (:func:`make_dryrun_mesh` starts a fake one).  A mesh
names its dimensions as the JAX package's does,
``("data", "model")`` or ``("pod", "data", "model")``, so a
``SessionConfig`` with ``data_axes=("pod", "data")`` means the same
geometry in both packages.  Every rank calls the same function with the
same arguments (``init_device_mesh`` is collective); the default process
group must exist first (``torchrun`` sets it up from its environment).
"""
from __future__ import annotations

import math

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh, init_device_mesh

# Roofline constants of one NVIDIA H100 80GB HBM3 (SXM5, 700 W; datasheet):
# the dry-run prices a rank's FLOPs, bytes and collective bytes with them.
PEAK_FLOPS = 989e12      # dense bf16 FLOP/s
HBM_BW = 3.35e12         # bytes/s
NVLINK_BW = 450e9        # bytes/s per direction, within a node
NET_BW = 50e9            # bytes/s per GPU across nodes (400 Gb/s NDR)
GPUS_PER_NODE = 8        # ranks are laid out row-major over the mesh


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


def make_dryrun_mesh(shape: tuple, axes: tuple,
                     device_type: str = "cuda") -> DeviceMesh:
    """A ``DeviceMesh`` of ``shape`` named ``axes`` over a *fake* process
    group of ``prod(shape)`` ranks, this process being rank 0: collectives
    on it move nothing and return tensors of the right shape, so a program
    over fake tensors can be traced as one rank of the whole mesh.  The
    fake group is made here, or reused when the default group is already a
    fake one of that size; a real default group raises (the dry-run runs
    in a process of its own).  ``device_type`` is the mesh's (``"cuda"``
    on the card: DTensor chooses its collectives by it)."""
    from torch.testing._internal.distributed.fake_pg import FakeStore

    world = math.prod(shape)
    if dist.is_initialized():
        if dist.get_backend() != "fake":
            raise RuntimeError(f"a {dist.get_backend()!r} process group is "
                               f"initialised; the dry-run mesh needs a "
                               f"process of its own")
        if dist.get_world_size() != world:
            dist.destroy_process_group()
    if not dist.is_initialized():
        dist.init_process_group("fake", store=FakeStore(), rank=0,
                                world_size=world)
    return init_device_mesh(device_type, tuple(shape),
                            mesh_dim_names=tuple(axes))


def group_bandwidth(ranks) -> float:
    """The rate a collective over ``ranks`` runs at: ``NVLINK_BW`` when they
    share one node of :data:`GPUS_PER_NODE`, else ``NET_BW``."""
    nodes = {int(r) // GPUS_PER_NODE for r in ranks}
    return NVLINK_BW if len(nodes) <= 1 else NET_BW
