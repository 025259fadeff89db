"""The GNN, DLRM-RM2 and ``schnet-part`` dry-run cells against the
reference's, without a trace: for each of the 22 cells on the two
production meshes (``AbstractMesh`` (16, 16) and (2, 16, 16)), the port's
per-chip argument bytes (``dryrun.argument_bytes``) equal the reference's
(each leaf's ``NamedSharding.shard_shape`` times its item size), the
global shapes and dtypes agree leaf for leaf (``schnet-part``'s port
arguments are one rank's shard, so its leaves are held to the reference's
shard shapes), the model FLOPs agree to 1e-12 and the capacity notes are
equal.  No dtype differs (ids, labels and the AdamW step are int32 on
both sides).  Also the registry: the reference's 40 assigned cells and
45 with the extras, by name and in order.

Meshes on the port's side are stubs with the JAX mesh's ``shape`` and
``axis_names``: the builders read nothing else.
"""
import jax
import numpy as np
import pytest
from jax.sharding import AbstractMesh

from repro.configs.registry import all_cells as ref_all_cells
from repro.configs.registry import get_arch as ref_get_arch

from repro_torch.configs.common import SDS
from repro_torch.configs.registry import all_cells, get_arch
from repro_torch.launch.dryrun import argument_bytes

ARCHS = ("schnet", "pna", "nequip", "dimenet", "dlrm-rm2", "schnet-part")
CELLS = [(a, c.shape) for a in ARCHS for c in ref_get_arch(a).CELLS]


class Mesh:
    """A mesh stub: ``shape`` by axis name and ``axis_names``."""

    def __init__(self, **axes):
        self.shape = dict(axes)
        self.axis_names = tuple(axes)


MESHES = {"16x16": (dict(data=16, model=16), AbstractMesh(
              (16, 16), ("data", "model"))),
          "2x16x16": (dict(pod=2, data=16, model=16), AbstractMesh(
              (2, 16, 16), ("pod", "data", "model")))}


def _cell(get, arch: str, shape: str):
    return next(c for c in get(arch).CELLS if c.shape == shape)


def _leaves(tree, path=()):
    """``{path: leaf}`` of a tree of stand-ins: dict keys, sequence indices
    (a NamedTuple's field names), ``None`` skipped."""
    if tree is None:
        return {}
    if isinstance(tree, (SDS, jax.ShapeDtypeStruct)):
        return {path: tree}
    out = {}
    if isinstance(tree, dict):
        for k, v in tree.items():
            out.update(_leaves(v, path + (k,)))
    elif hasattr(tree, "_fields"):
        for k in tree._fields:
            out.update(_leaves(getattr(tree, k), path + (k,)))
    else:
        for i, v in enumerate(tree):
            out.update(_leaves(v, path + (i,)))
    return out


def _ref_shards(built) -> dict:
    """``{path: (shard shape, dtype name)}`` of the reference's arguments."""
    shards = jax.tree.leaves(built.in_shardings)
    leaves = _leaves(tuple(built.args))
    assert len(shards) == len(leaves)
    # jax flattens dicts in sorted key order
    order = jax.tree_util.tree_flatten_with_path(tuple(built.args))[0]
    paths = [tuple(getattr(k, "key", getattr(k, "idx", getattr(k, "name",
                                                               None)))
                   for k in p) for p, _ in order]
    return {p: (tuple(s.shard_shape(leaves[p].shape)), str(leaves[p].dtype))
            for p, s in zip(paths, shards)}


def test_registry_holds_the_references_cells_in_order():
    assert [c.name for c in all_cells()] == [c.name for c in ref_all_cells()]
    assert len(all_cells()) == 40
    extra = [c.name for c in all_cells(include_extra=True)]
    assert extra == [c.name for c in ref_all_cells(include_extra=True)]
    assert len(extra) == 45
    for c, r in zip(all_cells(True), ref_all_cells(True)):
        assert c.kind == r.kind, c.name


@pytest.mark.parametrize("mesh", sorted(MESHES))
@pytest.mark.parametrize("arch,shape", CELLS,
                         ids=[f"{a}/{s}" for a, s in CELLS])
def test_cell_matches_reference_shards(arch, shape, mesh):
    stub, abstract = Mesh(**MESHES[mesh][0]), MESHES[mesh][1]
    ref = _cell(ref_get_arch, arch, shape).build(abstract)
    port = _cell(get_arch, arch, shape).build(stub)
    want = _ref_shards(ref)
    assert argument_bytes(port, stub) == sum(
        int(np.prod(s)) * np.dtype(d).itemsize for s, d in want.values())
    got = _leaves(tuple(port.args))
    assert set(got) == set(want)
    ref_leaves = _leaves(tuple(ref.args))
    for p, a in got.items():
        assert str(a.dtype).removeprefix("torch.") == want[p][1], p
        if port.in_shardings is None:
            # one rank's shard: the reference's stacks lose their leading
            # dim of one partition
            shard = want[p][0]
            if len(shard) == len(a.shape) + 1 and shard[0] == 1:
                shard = shard[1:]
            assert a.shape == shard, p
        else:
            assert a.shape == tuple(ref_leaves[p].shape), p
    assert port.model_flops == pytest.approx(ref.model_flops, rel=1e-12)
    assert port.notes == ref.notes
