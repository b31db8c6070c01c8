"""Cycle search tests: batched DLS vs host BFS, enumeration vs a naive
bounded simple-cycle enumerator (SURVEY §4 strategy)."""

import numpy as np
import jax.numpy as jnp

from mcaat_tpu.cycles.finder import CycleFinder, find_cycles
from mcaat_tpu.cycles.start_nodes import select_start_nodes, self_reachable_batch
from test_prune import make_graph


def naive_bounded_cycles_through(out, valid, start, min_len, max_len):
    """All simple cycles through start with min_len < len <= max_len."""
    cycles = []

    def dfs(node, path):
        for nb in sorted(int(x) for x in out[node] if x >= 0):
            if not valid[nb]:
                continue
            if nb == start:
                if min_len < len(path) <= max_len:
                    cycles.append(list(path))
            elif nb not in path and len(path) < max_len:
                path.append(nb)
                dfs(nb, path)
                path.pop()

    dfs(start, [start])
    return {tuple(c) for c in cycles}


def two_loop_graph():
    # node 0 is shared by two loops: 0..5..0 (len 6) and 0,10..14,0 (len 6)
    edges = {0: [1, 10]}
    for i in range(1, 5):
        edges[i] = [i + 1]
    edges[5] = [0]
    for i in range(10, 14):
        edges[i] = [i + 1]
    edges[14] = [0]
    return make_graph(edges, 15, mult=[100] + [30] * 14)


def test_self_reachable_batch_matches_truth():
    g = two_loop_graph()
    starts = np.arange(15, dtype=np.int32)
    reach = self_reachable_batch(g, starts, max_depth=10)
    on_loop = np.zeros(15, bool)
    on_loop[0:6] = True
    on_loop[10:15] = True  # nodes 6-9 are isolated
    assert (reach == on_loop).all()
    reach_short = self_reachable_batch(g, starts, max_depth=5)
    assert not reach_short.any()  # loops have length 6 > 5


def test_self_reachable_respects_validity():
    g = two_loop_graph()
    g = g.set_invalid(np.arange(15) == 3)  # break first loop
    reach = self_reachable_batch(g, np.array([0], dtype=np.int32), max_depth=10)
    assert reach[0]  # second loop still closes
    g = g.set_invalid(np.arange(15) == 12)  # break second loop too
    reach = self_reachable_batch(g, np.array([0], dtype=np.int32), max_depth=10)
    assert not reach[0]


def test_select_start_nodes_predicate():
    g = two_loop_graph()
    # only node 0 has indeg 2 and mult 100 > 20
    buckets = select_start_nodes(g, threshold_multiplicity=20, cycle_max_length=10,
                                 verbose=False)
    all_nodes = [n for v in buckets.values() for n in v]
    assert all_nodes == [0]


def test_select_start_nodes_rejects_self_loop():
    edges = {0: [0, 1], 1: [2], 2: [0]}
    g = make_graph(edges, 3, mult=[100, 50, 50])
    buckets = select_start_nodes(g, 20, 10, verbose=False)
    assert [n for v in buckets.values() for n in v] == []


def test_enumeration_matches_naive():
    g = two_loop_graph()
    out = np.asarray(g.out).reshape(-1, 4)
    valid = np.asarray(g.valid)
    finder = CycleFinder(
        out=out,
        in_=np.asarray(g.in_).reshape(-1, 4),
        valid=valid,
        mult=np.asarray(g.mult),
        cycle_min_length=3,
        cycle_max_length=10,
    )
    cycles = finder.find_cycles_from(0)
    got = {tuple(c) for c in cycles}
    expected = naive_bounded_cycles_through(out, valid, 0, 3, 10)
    assert expected <= got  # every bounded simple cycle is found
    # and every found cycle is a real cycle within bounds
    for c in got:
        assert 3 < len(c) <= 10
        for a, b in zip(c, list(c[1:]) + [c[0]]):
            assert b in out[a]


def test_enumeration_min_length_excludes():
    g = two_loop_graph()
    finder = CycleFinder(
        out=np.asarray(g.out).reshape(-1, 4),
        in_=np.asarray(g.in_).reshape(-1, 4),
        valid=np.asarray(g.valid),
        mult=np.asarray(g.mult),
        cycle_min_length=6,  # cycles have exactly 6 nodes; need > 6 -> none
        cycle_max_length=10,
    )
    assert finder.find_cycles_from(0) == []


def test_visited_suppression():
    g = two_loop_graph()
    finder = CycleFinder(
        out=np.asarray(g.out).reshape(-1, 4),
        in_=np.asarray(g.in_).reshape(-1, 4),
        valid=np.asarray(g.valid),
        mult=np.asarray(g.mult),
        cycle_min_length=3,
        cycle_max_length=10,
    )
    buckets = {5: [0], 4: [1]}  # node 1 in a lower bucket
    results = finder.enumerate(buckets, verbose=False)
    assert 0 in results and len(results[0]) >= 2
    assert 1 not in results  # suppressed: node 1 was on node 0's cycles


def test_mult_ratio_filter():
    # neighbor with tiny multiplicity is filtered (start_mult // nb_mult > 500)
    edges = {0: [1], 1: [2], 2: [0]}
    g = make_graph(edges, 3, mult=[100000, 100, 100])
    finder = CycleFinder(
        out=np.asarray(g.out).reshape(-1, 4),
        in_=np.asarray(g.in_).reshape(-1, 4),
        valid=np.asarray(g.valid),
        mult=np.asarray(g.mult),
        cycle_min_length=1,
        cycle_max_length=10,
    )
    assert finder.find_cycles_from(0) == []  # 100000 // 100 = 1000 > 500

    g2 = make_graph(edges, 3, mult=[1000, 100, 100])
    finder2 = CycleFinder(
        out=np.asarray(g2.out).reshape(-1, 4),
        in_=np.asarray(g2.in_).reshape(-1, 4),
        valid=np.asarray(g2.valid),
        mult=np.asarray(g2.mult),
        cycle_min_length=1,
        cycle_max_length=10,
    )
    assert len(finder2.find_cycles_from(0)) >= 1


# ---------------------------------------------------------------------------
# Candidate-neighborhood extraction (cycles/neighborhood.py)
# ---------------------------------------------------------------------------


def test_touched_mask_forward_reachable():
    from mcaat_tpu.cycles.neighborhood import touched_mask

    g = two_loop_graph()
    mask = touched_mask(g.out, g.valid, np.array([0]), radius=10, n_nodes=15)
    expected = np.zeros(15, bool)
    expected[0:6] = True
    expected[10:15] = True  # nodes 6-9 unreachable from 0
    assert (mask == expected).all()
    # radius-bounded: only 3 steps reaches 0,1,2,3 and 10,11,12
    mask3 = touched_mask(g.out, g.valid, np.array([0]), radius=3, n_nodes=15)
    expected3 = np.zeros(15, bool)
    expected3[[0, 1, 2, 3, 10, 11, 12]] = True
    assert (mask3 == expected3).all()


def test_touched_mask_respects_validity():
    from mcaat_tpu.cycles.neighborhood import touched_mask

    g = two_loop_graph().set_invalid(np.arange(15) == 2)
    mask = touched_mask(g.out, g.valid, np.array([0]), radius=10, n_nodes=15)
    assert not mask[3]  # behind the invalid node
    assert mask[1]  # invalid node 2 itself is not entered
    assert not mask[2]


def test_extraction_enumeration_parity():
    """Forced-extraction enumeration == full-graph enumeration, globally
    remapped (VERDICT r1 weak #5 parity requirement)."""
    from mcaat_tpu.cycles.finder import enumerate_from_buckets

    g = two_loop_graph()
    buckets = {5: [0]}
    full = enumerate_from_buckets(
        g, buckets, 3, 10, verbose=False, min_nodes_for_extraction=10**9
    )
    extracted = enumerate_from_buckets(
        g, buckets, 3, 10, verbose=False, min_nodes_for_extraction=0
    )
    assert full == extracted
    assert 0 in extracted and len(extracted[0]) >= 2


def test_extraction_parity_on_synthetic_metagenome():
    from mcaat_tpu.cycles.finder import enumerate_from_buckets
    from mcaat_tpu.cycles.start_nodes import select_start_nodes
    from mcaat_tpu.graph.dbg import build_dbg_from_reads
    from mcaat_tpu.io.fastq import encode_sequences
    from mcaat_tpu.prune.prune import prune_graph
    from synthetic import make_metagenome

    meta = make_metagenome(seed=7, n_arrays=1, n_spacers=5)
    batch = encode_sequences(meta["reads"])
    g = build_dbg_from_reads(batch.codes, batch.lengths, k=23)
    g = prune_graph(g, verbose=False)
    buckets = select_start_nodes(g, 20, 77, verbose=False)
    assert buckets, "fixture must produce start nodes"
    full = enumerate_from_buckets(
        g, buckets, 27, 77, verbose=False, min_nodes_for_extraction=10**9
    )
    extracted = enumerate_from_buckets(
        g, buckets, 27, 77, verbose=False, min_nodes_for_extraction=0
    )
    assert full == extracted


def test_tangle_cluster_bounds_abort():
    """A start node with > CLUSTER_BOUNDS (500) cycles aborts cleanly with
    no cycles (src/cycle_finder.cpp:132,161-165; our clean-abort
    divergence is documented in cycles/finder.py). 10 segments of 2
    parallel paths = 2^10 = 1024 distinct bounded cycles through node 0,
    with uniform multiplicity so the mult-ratio filter stays out of the
    way. Exercises the native enumerator when built (same contract)."""
    from mcaat_tpu.cycles.finder import enumerate_on_arrays

    edges = {}
    nid = 1
    cur = 0  # segment merge point; start node is 0
    for _seg in range(10):
        a1, a2, b1, b2, nxt = nid, nid + 1, nid + 2, nid + 3, nid + 4
        nid += 5
        edges[cur] = [a1, b1]
        edges[a1] = [a2]
        edges[b1] = [b2]
        edges[a2] = [nxt]
        edges[b2] = [nxt]
        cur = nxt
    edges[cur] = [0]  # close back to start
    g = make_graph(edges, nid, mult=[50] * nid)
    results = enumerate_on_arrays(
        np.asarray(g.out).reshape(-1, 4),
        np.asarray(g.in_).reshape(-1, 4),
        np.asarray(g.valid),
        np.asarray(g.mult),
        {5: [0]},
        cycle_min_length=3,
        cycle_max_length=77,
        verbose=False,
    )
    assert results[0] == []  # tangle: clean abort, no junk cycles

    # control: 8 segments = 256 cycles < 500 -> fully enumerated
    edges2 = {}
    nid = 1
    cur = 0
    for _seg in range(8):
        a1, a2, b1, b2, nxt = nid, nid + 1, nid + 2, nid + 3, nid + 4
        nid += 5
        edges2[cur] = [a1, b1]
        edges2[a1] = [a2]
        edges2[b1] = [b2]
        edges2[a2] = [nxt]
        edges2[b2] = [nxt]
        cur = nxt
    edges2[cur] = [0]
    g2 = make_graph(edges2, nid, mult=[50] * nid)
    results2 = enumerate_on_arrays(
        np.asarray(g2.out).reshape(-1, 4),
        np.asarray(g2.in_).reshape(-1, 4),
        np.asarray(g2.valid),
        np.asarray(g2.mult),
        {5: [0]},
        cycle_min_length=3,
        cycle_max_length=77,
        verbose=False,
    )
    assert len(results2[0]) == 256


def test_find_cycles_compact_path_parity():
    """The large-graph compact path (probe + enumerate on the extracted
    neighborhood) == the small-graph path, forced via the threshold."""
    import mcaat_tpu.cycles.finder as finder_mod
    from mcaat_tpu.cycles.finder import find_cycles
    from mcaat_tpu.graph.dbg import build_dbg_from_reads
    from mcaat_tpu.io.fastq import encode_sequences
    from synthetic import make_metagenome

    meta = make_metagenome(seed=19, n_arrays=2, n_spacers=5)
    batch = encode_sequences(meta["reads"])
    g1 = build_dbg_from_reads(batch.codes, batch.lengths, k=23)
    g2 = build_dbg_from_reads(batch.codes, batch.lengths, k=23)
    old = finder_mod.NEIGHBORHOOD_MIN_NODES
    try:
        finder_mod.NEIGHBORHOOD_MIN_NODES = 0  # force compact path
        _ga, res_compact = find_cycles(g1, verbose=False)
    finally:
        finder_mod.NEIGHBORHOOD_MIN_NODES = old
    _gb, res_direct = find_cycles(g2, verbose=False)
    assert res_compact == res_direct
    assert res_direct, "fixture must produce cycles"


def test_find_cycles_lazy_clip_parity():
    """Deferred (neighborhood-scale) tip clipping == global pruning,
    forced via the thresholds (see finder.LAZY_CLIP_MIN_NODES)."""
    import mcaat_tpu.cycles.finder as finder_mod
    from mcaat_tpu.cycles.finder import find_cycles
    from mcaat_tpu.graph.dbg import build_dbg_from_reads
    from mcaat_tpu.io.fastq import encode_sequences
    from synthetic import make_metagenome

    # background_len adds linear chains that only the tip clip removes
    meta = make_metagenome(
        seed=23, n_arrays=2, n_spacers=5, background_len=4000,
        background_coverage=6.0,
    )
    batch = encode_sequences(meta["reads"])
    g1 = build_dbg_from_reads(batch.codes, batch.lengths, k=23)
    g2 = build_dbg_from_reads(batch.codes, batch.lengths, k=23)
    old_n = finder_mod.NEIGHBORHOOD_MIN_NODES
    old_l = finder_mod.LAZY_CLIP_MIN_NODES
    try:
        finder_mod.NEIGHBORHOOD_MIN_NODES = 0
        finder_mod.LAZY_CLIP_MIN_NODES = 0  # force deferred clipping
        _ga, res_lazy = find_cycles(g1, verbose=False)
    finally:
        finder_mod.NEIGHBORHOOD_MIN_NODES = old_n
        finder_mod.LAZY_CLIP_MIN_NODES = old_l
    _gb, res_full = find_cycles(g2, verbose=False, full_prune=True)
    assert res_lazy == res_full
    assert res_full, "fixture must produce cycles"


def test_undirected_region_kernel_matches_host():
    """Device region-growth kernel == per-level host loop on random
    graphs with invalidated nodes (invalid nodes join the reached set
    but never expand)."""
    import jax.numpy as jnp

    from mcaat_tpu.cycles.neighborhood import (
        _undirected_region_mask_host,
        undirected_region_mask,
    )
    from mcaat_tpu.graph.dbg import DBG

    rng = np.random.default_rng(7)
    for trial in range(4):
        n = int(rng.integers(30, 200))
        out = np.full((n, 4), -1, dtype=np.int32)
        for v in range(n):
            for b in range(int(rng.integers(0, 3))):
                out[v, b] = int(rng.integers(0, n))
        in_ = np.full((n, 4), -1, dtype=np.int32)
        for v in range(n):
            for b, w in enumerate(out[v]):
                if w >= 0:
                    for slot in range(4):
                        if in_[w, slot] < 0:
                            in_[w, slot] = v
                            break
        valid = rng.random(n) > 0.3
        g = DBG(
            k=23,
            kmers=jnp.zeros((n,), jnp.int64),
            mult=jnp.ones((n,), jnp.int32),
            out=jnp.asarray(out.reshape(-1)),
            in_=jnp.asarray(in_.reshape(-1)),
            valid=jnp.asarray(valid),
        )
        seeds = np.unique(rng.integers(0, n, size=5).astype(np.int64))
        hops = int(rng.integers(1, 6))
        got = undirected_region_mask(g, seeds, hops)
        want = _undirected_region_mask_host(g, seeds, hops)
        np.testing.assert_array_equal(got, want, err_msg=f"trial {trial}")


def test_candidate_ids_matches_fused_mask():
    """Two-stage candidate scan (compact + refine, and its >n/8 fallback)
    must match the fused full-graph predicate exactly."""
    from mcaat_tpu.cycles.start_nodes import _candidate_mask, candidate_ids
    from mcaat_tpu.graph.dbg import DBG

    rng = np.random.default_rng(11)
    for trial, (dense, thr) in enumerate([(False, 10), (True, 1), (False, 50)]):
        n = int(rng.integers(500, 3000))
        out = rng.integers(-1, n, size=4 * n).astype(np.int32)
        in_ = rng.integers(-1, n, size=4 * n).astype(np.int32)
        valid = rng.random(n) < 0.8
        if dense:
            mult = rng.integers(1, 40, size=n).astype(np.int32)
        else:
            mult = np.ones(n, np.int32)
            mult[rng.choice(n, n // 20, replace=False)] = thr + 5
        g = DBG(
            k=23,
            kmers=jnp.zeros((n,), jnp.int64),
            mult=jnp.asarray(mult),
            out=jnp.asarray(out),
            in_=jnp.asarray(in_),
            valid=jnp.asarray(valid),
        )
        ref = np.nonzero(
            np.asarray(_candidate_mask(g.out, g.in_, g.valid, g.mult, thr))
        )[0]
        got = candidate_ids(g, thr)
        np.testing.assert_array_equal(ref, got, err_msg=f"trial {trial}")


def test_unpack_bitset_bit_order():
    from mcaat_tpu.cycles.neighborhood import _unpack_bitset

    rng = np.random.default_rng(12)
    for n in (1, 31, 32, 33, 1000, 4097):
        words = rng.integers(0, 2**32, size=(n + 31) // 32, dtype=np.uint32)
        ids = np.arange(n, dtype=np.int64)
        want = ((words[ids >> 5] >> (ids & 31).astype(np.uint32)) & 1).astype(bool)
        np.testing.assert_array_equal(_unpack_bitset(words, n), want)
