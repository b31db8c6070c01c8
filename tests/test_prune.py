"""Pruning pass tests on handcrafted adjacency."""

import numpy as np
import jax.numpy as jnp

from mcaat_tpu.graph.dbg import DBG
from mcaat_tpu.prune.prune import clip_tips, invalidate_low_multiplicity, prune_graph


def make_graph(out_edges: dict[int, list[int]], n: int, mult=None) -> DBG:
    out = np.full((n, 4), -1, dtype=np.int32)
    in_ = np.full((n, 4), -1, dtype=np.int32)
    out_slot = {u: 0 for u in range(n)}
    in_slot = {u: 0 for u in range(n)}
    for u, vs in out_edges.items():
        for v in vs:
            out[u, out_slot[u]] = v
            out_slot[u] += 1
            in_[v, in_slot[v]] = u
            in_slot[v] += 1
    if mult is None:
        mult = np.full(n, 10, dtype=np.int32)
    return DBG(
        k=23,
        kmers=jnp.arange(n, dtype=jnp.int64),
        mult=jnp.asarray(mult, dtype=jnp.int32),
        out=jnp.asarray(out.reshape(-1)),
        in_=jnp.asarray(in_.reshape(-1)),
        valid=jnp.ones(n, dtype=bool),
    )


def test_invalidate_low_multiplicity():
    g = make_graph({0: [1], 1: [0]}, 3, mult=[10, 1, 5])
    g2, n = invalidate_low_multiplicity(g)
    assert n == 1
    assert list(np.asarray(g2.valid)) == [True, False, True]


def test_clip_tips_chain():
    # cycle 0->1->2->0 with a dead chain 2->3->4
    g = make_graph({0: [1], 1: [2], 2: [0, 3], 3: [4]}, 5)
    g2, n = clip_tips(g)
    valid = np.asarray(g2.valid)
    assert n == 2
    assert list(valid) == [True, True, True, False, False]


def test_clip_tips_preserves_cycle():
    g = make_graph({0: [1], 1: [2], 2: [0]}, 3)
    g2, n = clip_tips(g)
    assert n == 0
    assert np.asarray(g2.valid).all()


def test_clip_tips_matches_per_level_fixpoint_random():
    """Chain-collapse clip == the per-level reference fixpoint, fuzzed."""
    from mcaat_tpu.prune.prune import _clip_tips_fixpoint

    rng = np.random.default_rng(3)
    for trial in range(25):
        n = int(rng.integers(5, 120))
        out_edges = {}
        in_deg = [0] * n
        for u in range(n):
            deg = int(rng.integers(0, 4))
            vs = []
            for v in set(rng.integers(0, n, size=deg).tolist()):
                if in_deg[v] < 4:
                    in_deg[v] += 1
                    vs.append(v)
            out_edges[u] = vs
        g = make_graph(out_edges, n)
        # random pre-invalidation
        valid0 = rng.random(n) > 0.2
        g = g.with_valid(jnp.asarray(valid0))
        expect = np.asarray(_clip_tips_fixpoint(g.out, g.valid))
        got, _ = clip_tips(g)
        np.testing.assert_array_equal(
            np.asarray(got.valid), expect, err_msg=f"trial {trial}"
        )


def test_clip_tips_long_chain():
    """A long linear chain into a cycle: only the cycle + feeders survive.

    (This shape — one background-genome chain — made the old per-level
    while_loop run one iteration per chain node inside one device program.)
    """
    n = 3000
    edges = {i: [i + 1] for i in range(n - 1)}
    # cycle at the front: 0..9 loop; chain 10.. dangles off node 3
    edges[9] = [0]
    edges[3] = [4, 10]
    g = make_graph(edges, n)
    g2, clipped = clip_tips(g)
    valid = np.asarray(g2.valid)
    assert valid[:10].all()
    assert not valid[10:].any()
    assert clipped == n - 10


def test_clip_tips_chain_into_unary_cycle():
    # chain 0->1->2 entering unary cycle 2->3->4->2: everything survives
    g = make_graph({0: [1], 1: [2], 2: [3], 3: [4], 4: [2]}, 5)
    g2, n = clip_tips(g)
    assert n == 0
    assert np.asarray(g2.valid).all()


def test_clip_tips_self_loop():
    # self-loop is a cycle; feeder chain survives, dead branch dies
    g = make_graph({0: [1], 1: [1, 2], 2: []}, 3)
    g2, n = clip_tips(g)
    assert list(np.asarray(g2.valid)) == [True, True, False]
    assert n == 1


def test_prune_graph_combined():
    # mult-1 node 3 feeds the cycle; clipping must not eat the cycle
    g = make_graph({0: [1], 1: [2], 2: [0], 3: [0]}, 4, mult=[10, 10, 10, 1])
    g2 = prune_graph(g, verbose=False)
    assert list(np.asarray(g2.valid)) == [True, True, True, False]
