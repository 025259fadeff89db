"""The benchmark's generators: seeded graphs and the steady-churn stream."""
import numpy as np
import pytest

from bench.gen.graph import powerlaw_graph, seed_sequence, snapshot_split
from bench.gen.stream import ChurnStream

N, M, D = 400, 2400, 8


def _stream(seed, traffic, holdout=0.1, d=D):
    s_graph, s_split, s_stream = seed_sequence(seed).spawn(3)
    src, dst = powerlaw_graph(N, M, np.random.default_rng(s_graph))
    snap, hold = snapshot_split(src, dst, holdout,
                                np.random.default_rng(s_split))
    x = np.zeros((N, d), np.float32)
    return ChurnStream(N, snap, hold, x, traffic,
                       np.random.default_rng(s_stream))


UNIFORM = dict(batch=30, mix=[1, 1, 1], skew=0.0)


def _run(stream, batches):
    out = []
    for _ in range(batches):
        b = stream.next_batch()
        stream.commit(b)
        out.append(b)
    return out


@pytest.mark.parametrize("seed", [0, 2**31 + 17, -5])
def test_graph_is_seeded_simple_and_sized(seed):
    a = powerlaw_graph(N, M, np.random.default_rng(seed_sequence(seed)))
    b = powerlaw_graph(N, M, np.random.default_rng(seed_sequence(seed)))
    assert all(np.array_equal(x, y) for x, y in zip(a, b))
    src, dst = a
    assert src.size == M and not np.any(src == dst)
    assert np.unique(src * N + dst).size == M
    # destinations follow the rank: vertex 0 takes the most in-edges
    deg = np.bincount(dst, minlength=N)
    assert deg[0] == deg.max() and deg[:10].sum() > deg[-100:].sum()


def test_same_seed_same_stream_and_other_seed_differs():
    s1, s2, s3 = (_stream(7, UNIFORM), _stream(7, UNIFORM),
                  _stream(8, UNIFORM))
    b1, b2, b3 = _run(s1, 20), _run(s2, 20), _run(s3, 20)
    for x, y in zip(b1, b2):
        for f in ("add_src", "add_dst", "del_src", "del_dst", "feat_idx",
                  "feat_val"):
            assert np.array_equal(getattr(x, f), getattr(y, f))
    assert any(not np.array_equal(x.del_src, y.del_src)
               for x, y in zip(b1, b3))


def test_batches_keep_the_mix_and_are_valid():
    s = _stream(3, UNIFORM)
    present = set((s.edges[0] * N + s.edges[1]).tolist())
    m0 = len(present)
    counts = np.zeros(3, int)
    for b in _run(s, 60):
        assert len(b) == 30
        adds = set((b.add_src * N + b.add_dst).tolist())
        dels = set((b.del_src * N + b.del_dst).tolist())
        assert not adds & present and dels <= present
        assert len(adds) == b.add_src.size and len(dels) == b.del_src.size
        present = (present - dels) | adds
        counts += [b.add_src.size, b.del_src.size, b.feat_idx.size]
    assert list(counts) == [600, 600, 600]
    assert present == set((s.edges[0] * N + s.edges[1]).tolist())
    assert len(present) == m0


def test_mix_holds_after_the_held_out_edges_are_spent():
    s = _stream(4, UNIFORM, holdout=0.02)
    held = s.pool_size
    batches = _run(s, 5 * held // 10 + 20)   # ~10 adds a batch
    adds = sum(b.add_src.size for b in batches)
    assert adds > 2 * held                   # the pool was refilled
    late = batches[-20:]
    assert [b.add_src.size for b in late] == [b.del_src.size for b in late]
    assert all(b.add_src.size == 10 for b in late)
    assert s.m == M - held


def test_features_only_stream_keeps_the_graph():
    s = _stream(5, dict(batch=50, mix=[0, 0, 1]))
    before = s.edges[0].copy(), s.edges[1].copy()
    x = s.x.copy()
    batches = _run(s, 10)
    assert all(b.feat_idx.size == 50 and b.add_src.size == 0
               and b.del_src.size == 0 for b in batches)
    assert np.array_equal(before[0], s.edges[0])
    assert not np.array_equal(x, s.x)
    # the last value written to a vertex is the one tracked
    last = batches[-1]
    v = last.feat_idx[-1]
    assert np.array_equal(s.x[v], last.feat_val[-1])


def test_skewed_deletions_fall_on_high_in_degree_destinations():
    uni = _run(_stream(6, dict(batch=30, mix=[0, 1, 0], skew=0.0)), 20)
    hot = _run(_stream(6, dict(batch=30, mix=[0, 1, 0], skew=1.0)), 20)
    s = _stream(6, UNIFORM)
    deg = np.bincount(s.edges[1], minlength=N)

    def mean_deg(batches):
        return deg[np.concatenate([b.del_dst for b in batches])].mean()
    assert mean_deg(hot) > 1.5 * mean_deg(uni)


def test_in_degree_feature_targets_follow_the_graph():
    t = dict(batch=40, mix=[0, 0, 1], skew=1.0, feature_target="in_degree")
    s = _stream(9, t)
    deg = np.bincount(s.edges[1], minlength=N)
    picked = np.concatenate([b.feat_idx for b in _run(s, 25)])
    assert deg[picked].mean() > 2 * deg.mean()
