"""The paper's own workload at production scale: streaming GC-S-3L inference
on a Papers-100M-class graph, distributed over the full mesh (the port of
``repro``'s ``configs/ripple_stream.py``).

The cell traces the port's distributed RIPPLE propagate
(``core/distributed.make_ripple_propagate``: all-to-all halo exchanges,
row-parallel UPDATE with a reduce-scatter) as one rank, with its
arguments laid out as ``DistEngine`` lays them out on a rank: this
partition's ``n_local + 1`` state rows (the last one the trash row) and
its model rank's feature columns, int64 ids in ``DistCSR`` and in
``DistBatch.ints`` (the reference's are int32), ``tp_param_shards``' row
shards.  The propagate runs its own ``torch.distributed`` collectives on
plain tensors, so the cell needs no ``DTensor``.
"""
from __future__ import annotations

import math

import torch

from repro_torch.core.distributed import (DistBatch, DistCSR, MeshComm,
                                          make_ripple_propagate)
from repro_torch.core.workloads import make_workload
from repro_torch.utils import next_bucket

from .common import Built, Cell, axis_names, mesh_shape, sds

N_VERTICES = 111_059_956
N_EDGES = 1_615_685_872
D_FEAT = 128
D_HID = 128
N_CLASSES = 176          # padded to /16 for TP divisibility (ogbn: 172)
N_LAYERS = 3
# streaming batch of 1000 updates; caps per hop sized for Papers' fan-out
CAPS = ((1 << 14, 1 << 18), (1 << 18, 1 << 22), (1 << 21, 1 << 25))
HALO_CAP = 1 << 18
FEAT_CAP = 1 << 10       # 1k-update batch, routed


def build_ripple(mesh, *, n_vertices: int = N_VERTICES,
                 n_edges: int = N_EDGES, pool: int | None = None,
                 caps: tuple = CAPS, halo_cap=HALO_CAP,
                 feat_cap: int = FEAT_CAP, dims: tuple | None = None,
                 donate: bool = False):
    """The cell on ``mesh``: the propagate and one rank's arguments.  The
    keywords default to the reference's Papers-100M geometry; ``pool``
    (the rank's CSR slots) defaults to the reference's 1.3 x the mean
    edges per partition, rounded up to a power of two, ``dims`` to
    (128, 128, 128, 176), and ``donate`` to the reference's cell (state
    not updated in place; a ``DistEngine`` donates)."""
    data_axes = tuple(a for a in axis_names(mesh) if a != "model")
    size = mesh_shape(mesh)
    n_parts = math.prod(size[a] for a in data_axes)
    M = size["model"]
    n_local = -(-n_vertices // n_parts)
    if pool is None:
        pool = next_bucket(int(n_edges / n_parts * 1.3))
    if dims is None:
        dims = (D_FEAT,) + (D_HID,) * (N_LAYERS - 1) + (N_CLASSES,)
    L = len(dims) - 1
    wl = make_workload("gc-s", n_layers=L, d_in=dims[0], d_hidden=dims[1],
                       n_classes=dims[-1])
    comm = MeshComm(mesh, data_axes)
    fn = make_ripple_propagate(comm, wl, n_local, caps, halo_cap,
                               donate=donate)

    nl1 = n_local + 1
    ids = torch.int64
    params_a = [{"w": sds((dims[l] // M, dims[l + 1])),
                 "b": sds((dims[l + 1] // M,))} for l in range(L)]
    H_a = tuple(sds((nl1, dims[l] // M)) for l in range(L + 1))
    S_a = (sds((nl1, 1)),) + tuple(sds((nl1, dims[l] // M))
                                   for l in range(L))
    k_a = sds((n_local,))
    csr_a = DistCSR(col=sds((pool,), ids), w=sds((pool,)),
                    start=sds((n_local,), ids), length=sds((n_local,), ids))
    batch_a = DistBatch(ints=sds((5, feat_cap), ids),
                        ws=sds((2, feat_cap)),
                        feat_val=sds((feat_cap, dims[0] // M)))
    # useful FLOPs: 2 ops per message x caps + update matmuls on frontier
    msg_ops = sum(2.0 * e * D_HID for _, e in caps)
    upd_ops = sum(2.0 * r * D_HID * D_HID for r, _ in caps)
    return Built(fn=fn, args=(params_a, H_a, S_a, k_a, csr_a, batch_a),
                 in_shardings=None, model_flops=msg_ops + upd_ops,
                 notes="paper §5 distributed streaming step, Papers-100M "
                       "scale")


CELLS = [Cell("ripple-papers", "stream_1k", "stream", build_ripple)]
