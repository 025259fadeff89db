"""schnet-part: SchNet on ogb_products with OWNER-PARTITIONED push-based
message passing (``models/gnn/partitioned.py``) over a group of P ranks,
at SchNet's published widths (``configs/schnet.py``'s ``HP``).

Capacity assumptions (documented, not silent): e_cap = 1.3x the mean
edges a partition (LDG imbalance slack measured on scaled samples);
halo_cap = 4x the mean per-destination message count; v2's cap2 = 1.5x
the mean edges a (source, destination) pair.

The dry-run's cells (``CELLS``: :func:`build`, v1, and :func:`build_v2`)
run the partitioned step's own collectives over the process group of
every rank of the mesh flattened, as ``ripple-papers`` runs the
propagate's: rank 0's local arguments as plain tensors
(``in_shardings`` None), no ``DTensor``.  The reference's arguments are
``[P, ...]`` stacks sharded over every axis; one rank's shard is the same
bytes.
"""
from __future__ import annotations

import math

import torch

from repro_torch.models.gnn.partitioned import (PartEdges, RoutedEdges,
                                                make_partitioned_schnet,
                                                make_partitioned_schnet_v2)
from repro_torch.models.gnn.schnet import init_schnet

from .common import Built, Cell, mesh_shape, sds
from .gnn_common import abstract, adamw_abstract, gnn_model_flops
from .schnet import HP

N, M, D, CLASSES = 2449408, 61859840, 100, 47


def capacities(n_parts: int, n: int = N, m: int = M) -> dict:
    """n_local, e_cap, halo_cap (v1) and cap2 (v2) of the cell over
    ``n_parts`` ranks, for a graph of ``n`` vertices and ``m`` edges (the
    cell's own by default)."""
    n_local = n // n_parts
    if n_local * n_parts != n:
        raise ValueError(f"{n} vertices do not split over {n_parts} ranks")
    e_cap = int(-(-int(m / n_parts * 1.3) // 1024) * 1024)
    halo_cap = int(-(-int(e_cap / n_parts * 4) // 256) * 256)
    cap2 = int(-(-int(m / n_parts ** 2 * 1.5) // 256) * 256)
    return dict(n_local=n_local, e_cap=e_cap, halo_cap=halo_cap, cap2=cap2)


def _group(mesh):
    """The process group of every rank of a ``DeviceMesh`` flattened."""
    from repro_torch.models.gnn.sharded import _flat_group
    return _flat_group(mesh)


def _built(mesh, make, edges_a, caps: dict, n: int, m: int,
           notes: str) -> Built:
    """The cell of one partitioned step: ``make(group)`` builds it when the
    step first runs (the mesh's process group exists only then)."""
    n_local = caps["n_local"]
    params_a = abstract(init_schnet(torch.Generator(), d_in=D, d_out=CLASSES,
                                    device="meta", **HP))
    args = (params_a, adamw_abstract(params_a), sds((n_local, D)), edges_a,
            sds((n_local,), torch.int32))
    steps = []

    def fn(*a):
        if not steps:
            steps.append(make(_group(mesh)).train_step)
        return steps[0](*a)

    flops = gnn_model_flops("schnet", n, m, D, HP["d_hidden"],
                            HP["n_interactions"], "train")
    return Built(fn=fn, args=args, in_shardings=None, model_flops=flops,
                 notes=notes)


def _parts(mesh) -> int:
    return math.prod(mesh_shape(mesh).values())


def build(mesh, *, n: int = N, m: int = M, halo_cap: int | None = None):
    """v1 over every rank of ``mesh``: the cell's capacities for its ``n``
    vertices and ``m`` edges (``halo_cap`` overridden where given)."""
    caps = capacities(_parts(mesh), n, m)
    if halo_cap is not None:
        caps["halo_cap"] = halo_cap
    e = caps["e_cap"]
    edges_a = PartEdges(src_local=sds((e,), torch.int32),
                        dst_global=sds((e,), torch.int32), dist=sds((e,)),
                        mask=sds((e,)))
    return _built(
        mesh, lambda g: make_partitioned_schnet(
            g, n_local=caps["n_local"], e_cap=e, halo_cap=caps["halo_cap"],
            d_in=D, d_out=CLASSES, **HP), edges_a, caps, n, m,
        f"partitioned push; e_cap={e} halo_cap={caps['halo_cap']}")


def build_v2(mesh, *, n: int = N, m: int = M, cap2: int | None = None):
    """v2 over every rank of ``mesh``: the cell's ``cap2`` for its ``n``
    vertices and ``m`` edges (or ``cap2`` where given)."""
    p = _parts(mesh)
    caps = capacities(p, n, m)
    if cap2 is not None:
        caps["cap2"] = cap2
    c = caps["cap2"]
    edges_a = RoutedEdges(src_local=sds((p, c), torch.int32),
                          dst_local=sds((p, c), torch.int32),
                          dist=sds((p, c)), mask=sds((p, c)))
    return _built(
        mesh, lambda g: make_partitioned_schnet_v2(
            g, n_local=caps["n_local"], cap2=c, d_in=D, d_out=CLASSES,
            **HP), edges_a, caps, n, m, f"pre-routed push v2; cap2={c}")


CELLS = [Cell("schnet-part", "ogb_products", "train", build),
         Cell("schnet-part", "ogb_products_v2", "train", build_v2)]
