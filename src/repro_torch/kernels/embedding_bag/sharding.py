"""``embedding_bag`` on ``DTensor`` s: the bag per shard of a row-sharded
table, for traces over a mesh (the dry-run, ``launch/dryrun.py``) and for
DLRM's cells (tables ``Spec("model", None)``).  Nothing here runs on plain
tensors.

Each rank of a mesh dim that shards the table's rows bags the lanes whose
ids fall in its block of rows; the outputs are then a partial sum over
those dims, as ``models/lm/sharded.embed`` leaves the LM's vocabulary.
The ids are replicated over those dims and keep their batch shards on the
others.  The kernel never clamps an id, and ``padding_idx`` skips every
lane equal to it, so a lane outside the block cannot be marked with it
without dropping the real ids that hit that row: such a lane is pointed
at the block's row 0 and skipped as padding, and the lanes that really
hit row 0 are added back, ``hits * table[0]`` (exact for one lane a bag,
DLRM's; with more, one more rounding).  The user's ``padding_idx`` lanes
count as outside.  The gradient of each rank's block is dense, ``[V / M,
d]``, a partial sum over the dims that split the batch.
"""
from __future__ import annotations

import torch

from repro_torch.utils import mesh_block


def local_bag(table, idx, padding_idx, lo: int):
    """The bag of the lanes of ``idx`` (global ids) that fall in ``table``,
    the block of rows from ``lo``; other lanes and ``padding_idx``'s add
    nothing."""
    from .ops import embedding_bag
    rows = table.shape[0]
    at = idx - lo
    inside = (at >= 0) & (at < rows)
    if padding_idx is not None:
        inside &= idx != padding_idx
    at = torch.where(inside, at, 0).to(torch.int32).contiguous()
    out = embedding_bag(table, at, 0)
    hits = (inside & (at == 0)).sum(1, keepdim=True).to(out.dtype)
    return out + hits * table[0]


def bag(table, idx, padding_idx=None):
    """``embedding_bag(table, idx, padding_idx)`` of ``DTensor`` s: a table
    ``[V, d]`` and ids ``[B, hot]``, per shard (module docstring):
    ``[B, d]`` laid out as the ids' batch, a partial sum over the dims that
    shard the table's rows."""
    from torch.distributed.tensor import Partial, Replicate, Shard
    from torch.distributed.tensor.experimental import local_map

    from .ops import embedding_bag
    mesh = table.device_mesh
    t_lay = list(table.placements)
    rows = [i for i, p in enumerate(t_lay)
            if isinstance(p, Shard) and p.dim == 0 and mesh.size(i) > 1]
    if any(isinstance(p, Shard) and p.dim != 0 for p in t_lay):
        raise ValueError(f"a table sharded on {t_lay}: only its rows may be")
    i_lay = [Shard(0) if i not in rows and isinstance(p, Shard)
             and p.dim == 0 else Replicate()
             for i, p in enumerate(idx.placements)]
    out = [Partial() if i in rows else p for i, p in enumerate(i_lay)]
    # each rank of a dim that splits the batch bags its own rows: the
    # table's gradient is a partial sum there
    t_grad = [Partial() if isinstance(p, Shard) else t_lay[i]
              for i, p in enumerate(i_lay)]
    if rows:
        block, n = mesh_block(mesh, rows)
        lo = block * (table.shape[0] // n)

        def fn(t, ids):
            return local_bag(t, ids, padding_idx, lo)
    else:
        def fn(t, ids):
            return embedding_bag(t, ids, padding_idx)
    return local_map(fn, out_placements=out, in_placements=(t_lay, i_lay),
                     in_grad_placements=(t_grad, i_lay), device_mesh=mesh,
                     redistribute_inputs=True)(table, idx)
