"""The port's LDG partitioner against the JAX package's: the same
partition bit for bit (the distributed engine's per-hop communication
counts depend on it), and the invariants of tests/test_partition_props.py."""
import numpy as np
import pytest

from repro.core import partition as rpart
from repro.core.graph import erdos_renyi, powerlaw_graph

from repro_torch.core import partition as tpart


def _graph(kind: str, n: int, seed: int):
    gen = erdos_renyi if kind == "er" else powerlaw_graph
    src, dst, _ = gen(n, 4 * n, seed=seed)
    return src, dst


@pytest.mark.parametrize("parts", range(1, 9))
@pytest.mark.parametrize("n,kind,seed", [(10, "er", 0), (60, "er", 1),
                                         (300, "powerlaw", 2),
                                         (1000, "powerlaw", 3)])
def test_partition_bit_identical(parts, n, kind, seed):
    src, dst = _graph(kind, n, seed)
    ref = rpart.ldg_partition(n, src, dst, parts, seed=seed)
    got = tpart.ldg_partition(n, src, dst, parts, seed=seed)
    assert (got.n, got.n_parts, got.n_local, got.n_pad) \
        == (ref.n, ref.n_parts, ref.n_local, ref.n_pad)
    for field in ("part_of", "new_of_old", "old_of_new"):
        np.testing.assert_array_equal(getattr(got, field),
                                      getattr(ref, field))
        assert getattr(got, field).dtype == getattr(ref, field).dtype
    np.testing.assert_array_equal(got.local_counts(), ref.local_counts())
    assert tpart.edge_cut(got.part_of, src, dst) \
        == rpart.edge_cut(ref.part_of, src, dst)


@pytest.mark.parametrize("n,parts,seed", [(10, 2, 0), (40, 4, 1), (80, 8, 5),
                                          (57, 3, 2), (33, 7, 4)])
def test_partition_invariants(n, parts, seed):
    src, dst, _ = erdos_renyi(n, 4 * n, seed=seed)
    p = tpart.ldg_partition(n, src, dst, parts, seed=seed)
    # every vertex assigned
    assert (p.part_of >= 0).all() and (p.part_of < parts).all()
    # balance within the LDG slack
    assert p.local_counts().max() <= int(np.ceil(n / parts * 1.05)) + 1
    # relabeling is a bijection consistent with ownership; pad slots -1
    assert np.unique(p.new_of_old).size == n
    np.testing.assert_array_equal(p.old_of_new[p.new_of_old], np.arange(n))
    np.testing.assert_array_equal(p.new_of_old // p.n_local, p.part_of)
    assert (p.old_of_new == -1).sum() == p.n_pad - n


def test_partition_cuts_beat_random():
    """LDG is not worse than a random assignment on a community graph."""
    rng = np.random.default_rng(0)
    n_half = 60
    a = rng.integers(0, n_half, size=(800, 2))
    b = rng.integers(n_half, 2 * n_half, size=(800, 2))
    cross = np.stack([rng.integers(0, n_half, 40),
                      rng.integers(n_half, 2 * n_half, 40)], 1)
    e = np.concatenate([a, b, cross])
    e = e[e[:, 0] != e[:, 1]]
    p = tpart.ldg_partition(2 * n_half, e[:, 0], e[:, 1], 2, seed=0)
    cut = tpart.edge_cut(p.part_of, e[:, 0], e[:, 1])
    rand_cut = tpart.edge_cut(rng.integers(0, 2, 2 * n_half), e[:, 0],
                              e[:, 1])
    assert cut < rand_cut
    assert tpart.edge_cut(p.part_of, e[:0, 0], e[:0, 1]) == 0.0
