"""Native C++ host kernels vs the Python/numpy reference implementations."""

import numpy as np
import pytest

from dualmessagepassing_tpu import native
from dualmessagepassing_tpu.data.subiso import (
    edge_subiso_weights,
    enumerate_subisomorphisms,
)

pytestmark = pytest.mark.skipif(not native.available(),
                                reason="native kernels not built")


def rand_case(rng, pv=3, pe=4, gv=8, ge=20, nl=2, el=2):
    ps = rng.integers(0, pv, pe)
    pr = (ps + rng.integers(1, pv, pe)) % pv
    gs = rng.integers(0, gv, ge)
    gr = (gs + rng.integers(1, gv, ge)) % gv
    return (ps.astype(np.int64), pr.astype(np.int64),
            rng.integers(0, el, pe).astype(np.int64),
            rng.integers(0, nl, pv).astype(np.int64),
            gs.astype(np.int64), gr.astype(np.int64),
            rng.integers(0, el, ge).astype(np.int64),
            rng.integers(0, nl, gv).astype(np.int64))


def test_enumeration_matches_python(rng):
    for _ in range(10):
        ps, pr, pel, pvl, gs, gr, gel, gvl = rand_case(rng)
        want = enumerate_subisomorphisms(ps, pr, pvl, pel, gs, gr, gvl, gel,
                                         use_native=False)
        got = native.enumerate_subiso_native(ps, pr, pel, pvl,
                                             gs, gr, gel, gvl)
        assert got.shape == want.shape
        # same set of mappings (order may differ)
        def rows(a):
            return set(map(tuple, a.tolist()))
        assert rows(got) == rows(want)


def test_edge_weights_match_python(rng):
    ps, pr, pel, pvl, gs, gr, gel, gvl = rand_case(rng, ge=30)
    iso = enumerate_subisomorphisms(ps, pr, pvl, pel, gs, gr, gvl, gel)
    want = edge_subiso_weights(ps, pr, pel, gs, gr, gel, iso)
    got = native.edge_subiso_weights_native(ps, pr, pel, gs, gr, gel,
                                            len(gvl), iso)
    np.testing.assert_array_equal(got, want)


def test_sample_in_edges_semantics(rng):
    from dualmessagepassing_tpu.unc.data import WholeGraph

    src = rng.integers(0, 20, 100)
    dst = (src + rng.integers(1, 20, 100)) % 20
    rel = rng.integers(0, 2, 100)
    g = WholeGraph(20, 2, np.stack([src, rel, dst], 1).astype(np.int64))
    nodes = np.arange(20, dtype=np.int64)
    eids = native.sample_in_edges_native(g.in_ptr, g.in_order, nodes, 5, 42)
    # every sampled edge's receiver is the requested node; <=5 per node
    cnt = np.bincount(g.receivers[eids], minlength=20)
    assert cnt.max() <= 5
    # no duplicate edges per node (without replacement)
    assert len(eids) == len(set(eids.tolist()))
    # full-degree nodes keep all their edges
    for v in range(20):
        if g.in_deg[v] <= 5:
            assert cnt[v] == g.in_deg[v]


def test_random_walks_follow_edges(rng):
    from dualmessagepassing_tpu.unc.data import WholeGraph

    src = rng.integers(0, 15, 60)
    dst = (src + rng.integers(1, 15, 60)) % 15
    rel = rng.integers(0, 2, 60)
    g = WholeGraph(15, 2, np.stack([src, rel, dst], 1).astype(np.int64))
    out_dst = g.receivers[g.out_order]
    seeds = np.arange(5, dtype=np.int64)
    walks = native.random_walks_native(g.out_ptr, out_dst, seeds, 3, 4, 7)
    assert walks.shape == (4, 5, 4)
    edge_set = set(zip(g.senders.tolist(), g.receivers.tolist()))
    for rep in walks:
        for i, row in enumerate(rep):
            assert row[0] == seeds[i]
            for a, b in zip(row[:-1], row[1:]):
                if b == -1:
                    break
                assert (int(a), int(b)) in edge_set


def test_native_speedup(rng):
    """The native enumerator should beat Python by a wide margin."""
    import time

    ps, pr, pel, pvl, gs, gr, gel, gvl = rand_case(
        rng, pv=4, pe=5, gv=24, ge=140, nl=1, el=1)
    def best_of_3(fn):
        # the fastest of three runs: parallel test workers share the cores
        times = []
        for _ in range(3):
            t0 = time.perf_counter()
            out = fn()
            times.append(time.perf_counter() - t0)
        return out, min(times)

    want, t_py = best_of_3(lambda: enumerate_subisomorphisms(
        ps, pr, pvl, pel, gs, gr, gvl, gel, use_native=False))
    got, t_c = best_of_3(lambda: native.enumerate_subiso_native(
        ps, pr, pel, pvl, gs, gr, gel, gvl))
    assert got.shape == want.shape
    # informational; native should be at least ~5x faster on this size
    print(f"python {t_py*1e3:.1f}ms native {t_c*1e3:.1f}ms "
          f"({t_py/max(t_c,1e-9):.0f}x)")
    assert t_c < t_py
