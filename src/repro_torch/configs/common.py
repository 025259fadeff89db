"""Cell machinery shared by the dry-run's architecture configs: the port of
``repro``'s ``configs/common.py``.

A *cell* is one (architecture x input shape) pair.  ``Cell.build(mesh)``
returns what the dry-run traces: a function and its arguments as
shape-and-dtype stand-ins (:func:`sds`) with a :class:`Spec` each, the
reference's ``PartitionSpec`` entries.  No parameter or activation is
ever allocated: the dry-run makes one rank's shard of each argument as a
fake tensor and wraps it as a ``DTensor`` (:func:`placements`).
"""
from __future__ import annotations

import math
from dataclasses import dataclass, field
from typing import Any, Callable, NamedTuple

import torch
from torch.distributed.tensor import Replicate, Shard


class Spec(tuple):
    """A partition spec: one entry per tensor dim, ``None`` (replicated),
    a mesh axis name, or a tuple of names (the dim split over their
    product, in that order).  Missing trailing entries are ``None``."""

    def __new__(cls, *entries):
        return super().__new__(cls, entries)

    def __repr__(self) -> str:
        return f"Spec{tuple(self)!r}"


class SDS(NamedTuple):
    """A shape-and-dtype stand-in for one (global) tensor."""

    shape: tuple
    dtype: torch.dtype


def sds(shape, dtype=torch.float32) -> SDS:
    return SDS(tuple(int(d) for d in shape), dtype)


@dataclass
class Built:
    """A traceable cell: ``fn(*args)`` with one :class:`Spec` tree per
    argument (``in_shardings``) and the roofline's metadata.

    ``in_shardings`` None means ``args`` are already one rank's local
    shapes, passed as plain fake tensors (a program that runs its own
    collectives, as the ripple propagate does).  ``probes`` stays empty:
    the port's layers are a Python loop, so a full-depth trace counts every
    layer; the reference's probes and their least-squares fit exist only
    because XLA's cost analysis counts a scanned body once."""

    fn: Callable
    args: tuple                      # SDS trees
    in_shardings: Any                # Spec trees (one per arg) or None
    model_flops: float               # analytic useful FLOPs for this step
    notes: str = ""
    probes: list = field(default_factory=list)
    design_full: tuple | None = None


@dataclass
class Cell:
    arch: str
    shape: str
    kind: str                        # train | prefill | decode | stream
    builder: Callable                # (mesh) -> Built
    tags: tuple[str, ...] = ()

    @property
    def name(self) -> str:
        return f"{self.arch}/{self.shape}"

    def build(self, mesh) -> Built:
        return self.builder(mesh)


def mesh_shape(mesh) -> dict:
    """``{axis name: size}`` of a ``DeviceMesh`` (or of any object with the
    JAX mesh's ``shape`` mapping, as the tests' stubs have)."""
    names = getattr(mesh, "mesh_dim_names", None)
    if names is not None:
        return {a: mesh.size(i) for i, a in enumerate(names)}
    return dict(mesh.shape)


def axis_names(mesh) -> tuple:
    names = getattr(mesh, "mesh_dim_names", None)
    return tuple(names) if names is not None else tuple(mesh.axis_names)


def _axes(entry) -> tuple:
    return entry if isinstance(entry, tuple) else (entry,)


def _axis_size(mesh, entry) -> int:
    shape = mesh_shape(mesh)
    return math.prod(shape[a] for a in _axes(entry))


def sanitize_spec(mesh, spec: Spec, shape) -> Spec:
    """Drop/move mesh axes whose size does not divide the dimension.

    When e.g. n_kv_heads=2 cannot shard over model=16, the axis is moved
    to another (currently replicated, divisible) dim of the same tensor so
    the parallelism is preserved (e.g. heads -> head_dim), else dropped to
    replication.  The reference's rule, entry for entry."""
    shape = tuple(shape)
    ndim = len(shape)
    ent = tuple(spec) + (None,) * (ndim - len(tuple(spec)))
    new = list(ent[:ndim])
    for i, entry in enumerate(list(new)):
        if entry is None:
            continue
        if shape[i] % _axis_size(mesh, entry) == 0:
            continue
        new[i] = None
        for j in range(ndim):
            if new[j] is None and j != i and \
                    shape[j] % _axis_size(mesh, entry) == 0 and shape[j] > 1:
                new[j] = entry
                break
    return Spec(*new)


def placements(mesh, spec: Spec, ndim: int) -> tuple:
    """A spec as DTensor placements, one per mesh dim: ``Shard(i)`` on each
    mesh axis that tensor dim ``i``'s entry names, ``Replicate()`` on the
    rest (and on an axis of one rank).  A dim split over several axes is
    sharded on each, outermost first; DTensor shards in mesh-dim order, so
    such an entry must list its axes in the mesh's order (the reference's
    always do)."""
    names = axis_names(mesh)
    size = mesh_shape(mesh)
    out = [Replicate()] * len(names)
    for i, entry in enumerate(tuple(spec)[:ndim]):
        if entry is None:
            continue
        axes = _axes(entry)
        dims = [names.index(a) for a in axes]
        if dims != sorted(dims):
            raise ValueError(f"spec entry {entry} is not in the mesh's axis "
                             f"order {names}")
        for a, d in zip(axes, dims):
            if size[a] > 1:     # an axis of one rank splits nothing
                out[d] = Shard(i)
    return tuple(out)


def local_shape(mesh, spec: Spec, shape) -> tuple:
    """Rank 0's shard of a tensor of ``shape`` laid out by ``spec``: each
    sharded dim cut into its axes' product of chunks, the first chunk
    (rounded up, as ``torch.chunk`` and DTensor cut an uneven dim)."""
    out = list(shape)
    for i, entry in enumerate(tuple(spec)[:len(out)]):
        if entry is not None:
            for a in _axes(entry):
                out[i] = -(-out[i] // mesh_shape(mesh)[a])
    return tuple(out)


def tree_map_specs(fn, specs, *trees):
    """``fn(spec, *leaves)`` over a :class:`Spec` tree and the trees that
    share its structure (dicts, tuples, NamedTuples, lists); a ``Spec`` is
    a leaf, and so is anything in ``specs`` that is not a container."""
    if isinstance(specs, Spec) or not isinstance(specs, (dict, list, tuple)):
        return fn(specs, *trees)
    if isinstance(specs, dict):
        return {k: tree_map_specs(fn, specs[k], *(t[k] for t in trees))
                for k in specs}
    parts = [tree_map_specs(fn, s, *(t[i] for t in trees))
             for i, s in enumerate(specs)]
    if hasattr(specs, "_fields"):
        return type(specs)(*parts)
    return type(specs)(parts)


def dp_axes_of(mesh):
    return ("pod", "data") if "pod" in axis_names(mesh) else "data"


def dp_size_of(mesh) -> int:
    shape = mesh_shape(mesh)
    n = shape["data"]
    if "pod" in shape:
        n *= shape["pod"]
    return n
