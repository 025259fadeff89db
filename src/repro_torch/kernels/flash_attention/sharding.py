"""``flash_attention`` on ``DTensor`` s: the custom op's sharding strategy
and the layout its operands take, for traces over a mesh (the dry-run,
``launch/dryrun.py``).  ``launch/dtensor_rules.register`` registers
:func:`strategies` with DTensor.  Nothing here runs on plain tensors.

Batch and heads are independent in attention, so a layout that shards
either leaves each rank the whole computation on its shard.  Where q, k
or v come in sharded on a dim that neither batch nor heads can take (GQA's
two to eight kv heads against a model size of 16), they are gathered and
every rank of that mesh dim computes all heads: a replicate strategy,
whose all-gather the trace counts and whose repeated work shows in
``flops_per_chip``.
"""
from __future__ import annotations


def strategies(q, k, v, *rest):
    """Strategies of ``flash_attention(q, k, v, chunk)`` ([B, S, H, Dh]
    operands and output) for one mesh dim; DTensor combines them over the
    mesh's dims and drops the layouts a dim is too short for: batch
    sharded, heads sharded (query and kv heads alike, when both counts
    divide every mesh dim's size, so each kv head stays with its group of
    query heads), or all replicated."""
    from torch.distributed.tensor import Replicate, Shard
    H, Hkv = q.shape[2], k.shape[2]
    sizes = tuple(q.mesh.mesh.shape)
    none = [None] * len(rest)
    out = [([Shard(0)], [Shard(0)] * 3 + none)]
    if all(H % s == 0 and Hkv % s == 0 for s in sizes):
        out.append(([Shard(2)], [Shard(2)] * 3 + none))
    out.append(([Replicate()], [Replicate()] * 3 + none))
    return out


def attention_layout(q, k, v):
    """``DTensor`` q, k, v ``[B, S, H, Dh]`` laid out alike, as attention
    runs on them: on each mesh dim of more than one rank, the heads on
    ``model`` when both head counts divide its size, else the batch when
    it divides (with the dims that shard it already), else replicated.
    One of :func:`strategies`' layouts, so the op moves nothing more; a
    backward that runs per shard (:func:`per_shard`) finds its operands
    saved in it."""
    from torch.distributed.tensor import Replicate, Shard
    mesh = q.device_mesh
    names = mesh.mesh_dim_names or ()
    lay, batch = [], 1
    for i in range(mesh.ndim):
        n = mesh.size(i)
        if n > 1 and names[i] == "model" and q.shape[2] % n == 0 \
                and k.shape[2] % n == 0:
            lay.append(Shard(2))
        elif n > 1 and q.shape[0] % (batch * n) == 0:
            lay.append(Shard(0))
            batch *= n
        else:
            lay.append(Replicate())
    return tuple(t if list(t.placements) == lay
                 else t.redistribute(mesh, lay) for t in (q, k, v))


def per_shard(fn, tensors, n_out: int):
    """``fn`` of plain tensors run on each rank's shards of ``DTensor`` s
    laid out alike (``local_map``; the first tensor's layout, the others
    redistributed to it), its ``n_out`` outputs in that layout.  For
    attention's operands in :func:`attention_layout`: each rank's part is
    the whole computation on its shard."""
    from torch.distributed.tensor.experimental import local_map
    lay = list(tensors[0].placements)
    return local_map(fn, out_placements=lay if n_out == 1
                     else tuple([lay] * n_out),
                     in_placements=tuple([lay] * len(tensors)),
                     device_mesh=tensors[0].device_mesh,
                     redistribute_inputs=True)(*tensors)
