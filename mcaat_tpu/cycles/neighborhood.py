"""Candidate-neighborhood extraction for host cycle enumeration.

The per-start-node DFS (``cycles/finder.py``) only ever walks nodes that
are forward-reachable from a start node within ``cycle_max_length`` steps:
a node can join a path only as an out-neighbor of a path node, and path
length is bounded by the lock mechanism (reference
``src/cycle_finder.cpp:168-179``). Lock *relaxation* walks incoming edges
(``:191-210``), but a relaxed lock can only influence the output if the
relaxed node is itself appendable — i.e. forward-reachable — so
restricting the graph to the union forward-reachable set of all start
nodes is exactly output-preserving.

Previously the enumeration pulled the full ``[N,4]`` adjacency + valid +
mult to host regardless of how few candidates survived (~20 GB at the
1B-node target). Here a device union-BFS computes the touched set first
(frontier gathers + visited bitset, cost ∝ neighborhood size, not N) and
only the touched rows cross to host, remapped to compact local ids.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np

from mcaat_tpu.graph.dbg import DBG


@functools.partial(jax.jit, static_argnames=("max_depth", "cap"))
def _union_reach_kernel(
    out: jax.Array,  # int32 [4N] flat adjacency
    valid: jax.Array,  # bool  [N]
    seeds: jax.Array,  # int32 [S], -1 padded
    max_depth: int,
    cap: int,
):
    """Union BFS from all seeds; returns (touched bool[N], overflow bool).

    One shared frontier (compacted id list, capacity ``cap``) + one global
    visited bitset — unlike the per-lane probe in ``start_nodes.py`` this
    answers "which nodes does ANY seed reach", so per-level cost is
    ∝ the true frontier size, deduped across seeds.
    """
    N = out.shape[0] // 4
    W = (N + 31) // 32
    S = seeds.shape[0]

    seeds_live = (seeds >= 0) & valid[jnp.maximum(seeds, 0)]
    seeds_c = jnp.where(seeds_live, jnp.maximum(seeds, 0), N)
    seeds_sorted = jnp.sort(seeds_c)

    visited = jnp.zeros((W,), dtype=jnp.uint32)
    sw = jnp.minimum(seeds_sorted >> 5, W - 1)
    sb = jnp.where(
        seeds_sorted < N,
        jnp.uint32(1) << (seeds_sorted & 31).astype(jnp.uint32),
        jnp.uint32(0),
    )
    # seeds may repeat a word; bitwise accumulate via max over OR-scan is
    # overkill — dedupe bits through a scatter-max of per-word OR is not
    # directly available, so mark seeds one bit at a time with .add after
    # explicit dedup: duplicated (word,bit) pairs only come from duplicate
    # seed ids, which the caller guarantees unique.
    visited = visited.at[sw].add(sb, indices_are_sorted=True, mode="promise_in_bounds")

    frontier = jnp.full((cap,), N, dtype=jnp.int32)
    take = min(cap, S)
    frontier = frontier.at[:take].set(seeds_sorted[:take])
    overflow = jnp.sum(seeds_sorted < N) > cap

    def cond(state):
        depth, frontier, visited, overflow = state
        return (depth < max_depth) & (frontier[0] < N) & ~overflow

    def body(state):
        depth, frontier, visited, overflow = state
        f_live = frontier < N
        f_idx = jnp.minimum(frontier, N - 1)
        slots = (f_idx * 4)[:, None] + jnp.arange(4, dtype=jnp.int32)
        nbrs = out[slots]  # [cap, 4]
        ok = (nbrs >= 0) & f_live[:, None]
        nbrs_c = jnp.maximum(nbrs, 0)
        ok &= valid[nbrs_c]
        flat = jnp.sort(jnp.where(ok, nbrs_c, N).reshape(-1))  # [4*cap]
        dup = jnp.concatenate(
            [jnp.zeros((1,), bool), (flat[1:] == flat[:-1]) & (flat[1:] < N)]
        )
        word = jnp.minimum(flat >> 5, W - 1)
        bit = jnp.uint32(1) << (flat & 31).astype(jnp.uint32)
        got = visited.at[word].get(indices_are_sorted=True, mode="promise_in_bounds")
        seen = (got & bit) != 0
        flat = jnp.where(dup | seen | (flat >= N), N, flat)
        flat = jnp.sort(flat)
        n_new = jnp.sum(flat < N)
        overflow = overflow | (n_new > cap)
        new_frontier = flat[:cap]
        nf_live = new_frontier < N
        w2 = jnp.minimum(new_frontier >> 5, W - 1)
        b2 = jnp.where(
            nf_live,
            jnp.uint32(1) << (new_frontier & 31).astype(jnp.uint32),
            jnp.uint32(0),
        )
        visited = visited.at[w2].add(
            b2, indices_are_sorted=True, mode="promise_in_bounds"
        )
        return depth + 1, new_frontier, visited, overflow

    _, frontier, visited, overflow = jax.lax.while_loop(
        cond, body, (jnp.int32(0), frontier, visited, overflow)
    )
    # return the PACKED bitset: 8x fewer bytes to download than bool[N]
    return visited, overflow


def touched_mask(
    graph_out, graph_valid, seeds: np.ndarray, radius: int, n_nodes: int
) -> np.ndarray | None:
    """Union forward-reachable mask from ``seeds`` within ``radius`` steps.

    Tiered frontier capacities; returns None if even the largest tier
    overflows (caller falls back to the full-graph path).
    """
    seeds = np.unique(np.asarray(seeds, dtype=np.int32))
    if len(seeds) == 0:
        return np.zeros(n_nodes, dtype=bool)
    from mcaat_tpu.graph.dbg import _bucket_size

    cap0 = _bucket_size(max(4 * len(seeds), 4096))
    for cap in (cap0, cap0 * 16, cap0 * 256):
        if cap > 4 * n_nodes:
            cap = _bucket_size(4 * n_nodes)
        visited, overflow = _union_reach_kernel(
            graph_out,
            graph_valid,
            jnp.asarray(seeds),
            radius,
            cap,
        )
        if not bool(overflow):
            return _unpack_bitset(np.asarray(visited), n_nodes)
        if cap >= 4 * n_nodes:
            break
    return None


def remap_to_local(gids: np.ndarray, a: np.ndarray) -> np.ndarray:
    """Global ids -> compact local ids (rank in the sorted ``gids``);
    entries outside ``gids`` (and negatives) become -1. Shared by the
    single-device and sharded subgraph compactions.

    PRECONDITION: ``gids`` must be sorted ascending AND duplicate-free
    (every caller passes ``np.nonzero`` outputs, which are both). The
    dense fast path derives its table bound from ``gids[-1]`` and
    scatters ranks by position, so an unsorted or duplicated input would
    silently return wrong local ids; the searchsorted fallback would
    return the first duplicate's rank.

    Bulk lookups take a dense scatter/gather map (an order of magnitude
    faster than host binary search on millions of chain entries) when
    the id range keeps the map under 2 GB; sparse/huge ranges fall back
    to searchsorted."""
    if len(gids) == 0:
        return np.full(a.shape, -1, dtype=np.int32)
    hi = int(gids[-1]) + 1
    # cheap guard for the precondition (O(1), vs the O(n) map build):
    # sorted-unique implies gids[-1] is the max and len(gids) ids fit
    # strictly below hi
    assert len(gids) <= hi, "remap_to_local: gids not sorted-unique"
    if a.size >= 4 * len(gids) and hi <= (1 << 29):
        # np.zeros = calloc (lazy zero pages, unlike np.full's eager -1
        # fill) — store local+1 so untouched zeros decode to the -1 miss
        # sentinel
        dense = np.zeros(hi, dtype=np.int32)
        dense[gids] = np.arange(1, len(gids) + 1, dtype=np.int32)
        ok = (a >= 0) & (a < hi)
        res = dense[np.where(ok, a, 0)]
        res -= 1
        res[~ok] = -1
        return res
    pos = np.searchsorted(gids, np.maximum(a, 0))
    pos_c = np.minimum(pos, len(gids) - 1)
    hit = (a >= 0) & (gids[pos_c] == np.maximum(a, 0))
    return np.where(hit, pos_c, -1).astype(np.int32)


def extract_subgraph(graph: DBG, mask: np.ndarray):
    """Compact the masked rows into host arrays with remapped local ids.

    Returns ``(out[M,4], in_[M,4], valid[M], mult[M], global_ids[M])``;
    adjacency entries leaving the mask become -1 (they are unreachable
    from any seed, so dropping them is output-preserving — see module
    docstring). ``global_ids`` is sorted ascending, so local-id order ==
    global-id order (bucket determinism is preserved).
    """
    gids = np.nonzero(mask)[0].astype(np.int64)
    sel = jnp.asarray(gids)
    # device-side gather of only the touched rows, then one host transfer
    sub_out = np.asarray(_gather_rows(graph.out, sel))
    sub_in = np.asarray(_gather_rows(graph.in_, sel))
    sub_valid = np.asarray(graph.valid[sel])
    sub_mult = np.asarray(graph.mult[sel])
    return (
        remap_to_local(gids, sub_out),
        remap_to_local(gids, sub_in),
        sub_valid,
        sub_mult,
        gids,
    )


@jax.jit
def _gather_rows(adj_flat: jax.Array, ids: jax.Array) -> jax.Array:
    slots = (ids * 4)[:, None] + jnp.arange(4, dtype=jnp.int32)
    return adj_flat[slots]


@functools.partial(jax.jit, static_argnames=("levels", "cap"))
def _undirected_region_steps(
    out: jax.Array,  # int32 [4N] flat out-adjacency
    in_: jax.Array,  # int32 [4N] flat in-adjacency
    valid: jax.Array,  # bool  [N]
    frontier: jax.Array,  # int32 [cap] sorted, N-padded (valid nodes only)
    visited: jax.Array,  # uint32 [ceil(N/32)] reached bitset
    levels: int,
    cap: int,
):
    """``levels`` levels of undirected bounded growth (cost ∝ cap·levels).

    Semantics of keep_crispr_regions_extended_by_k's growth (reference
    src/spacer_ordering.cpp:96-129): invalid neighbors join the reached
    set but only valid nodes expand. State-in/state-out so the caller can
    re-size ``cap`` between phases — the frontier collapses to a trickle
    once the cycle region is saturated, and a fixed seed-sized cap would
    pay cap-sized gathers for all ~78 levels. Returns
    ``(frontier', visited', overflow)``.
    """
    N = out.shape[0] // 4
    W = (N + 31) // 32

    def cond(state):
        depth, frontier, visited, overflow = state
        return (depth < levels) & (frontier[0] < N) & ~overflow

    def body(state):
        depth, frontier, visited, overflow = state
        f_live = frontier < N
        f_idx = jnp.minimum(frontier, N - 1)
        slots = (f_idx * 4)[:, None] + jnp.arange(4, dtype=jnp.int32)
        nbrs = jnp.concatenate([out[slots], in_[slots]], axis=1)  # [cap, 8]
        ok = (nbrs >= 0) & f_live[:, None]
        nbrs_c = jnp.maximum(nbrs, 0)
        flat = jnp.sort(jnp.where(ok, nbrs_c, N).reshape(-1))  # [8*cap]
        dup = jnp.concatenate(
            [jnp.zeros((1,), bool), (flat[1:] == flat[:-1]) & (flat[1:] < N)]
        )
        word = jnp.minimum(flat >> 5, W - 1)
        bit = jnp.uint32(1) << (flat & 31).astype(jnp.uint32)
        got = visited.at[word].get(indices_are_sorted=True, mode="promise_in_bounds")
        seen = (got & bit) != 0
        stale = dup | seen | (flat >= N)
        # mark ALL fresh nodes reached (valid or not): scatter at the
        # already-sorted `flat` positions, stale entries contribute 0 bits
        # (saves a third per-level sort)
        visited = visited.at[word].add(
            jnp.where(stale, jnp.uint32(0), bit),
            indices_are_sorted=True,
            mode="promise_in_bounds",
        )
        # ... but only valid ones enter the next frontier
        fresh_v = jnp.where(
            ~stale & valid[jnp.minimum(flat, N - 1)], flat, N
        )
        fresh_v = jnp.sort(fresh_v)
        overflow = overflow | (jnp.sum(fresh_v < N) > cap)
        return depth + 1, fresh_v[:cap], visited, overflow

    _, frontier, visited, overflow = jax.lax.while_loop(
        cond, body, (jnp.int32(0), frontier, visited, jnp.array(False))
    )
    return frontier, visited, overflow


# levels per phase: between phases the frontier capacity is re-sized to
# the live frontier, so a saturated region stops paying seed-sized gathers
_REGION_PHASE_LEVELS = 6


def undirected_region_mask(
    graph: DBG, seeds: np.ndarray, hops: int, verbose: bool = False
) -> np.ndarray:
    """Undirected ``hops``-hop expansion of ``seeds`` (bool [N]): invalid
    neighbors join the reached set but only valid nodes expand — the
    exact semantics of keep_crispr_regions_extended_by_k's growth
    (reference src/spacer_ordering.cpp:96-129). Runs as phased device
    programs with a compacted frontier whose capacity adapts to the live
    frontier between phases (cost ∝ region size, not N). The full-array
    formulation (ordering._grow_region) runs hops × O(4N) passes in one
    program, which failed on the previous accelerator at large graphs; a
    per-level host loop pays one dispatch per gather. A phase that
    overflows retries with 8x capacity from the same pre-phase state; the
    host loop remains as the final fallback.
    """
    from mcaat_tpu.graph.dbg import _bucket_size

    import time

    n = graph.size
    W = (n + 31) // 32
    reached = np.zeros(n, dtype=bool)
    seeds = np.unique(np.asarray(seeds, dtype=np.int64))
    if len(seeds) == 0:
        return reached

    t_setup = time.perf_counter()
    # initial reached bitset + valid-seed frontier, built on host (tiny)
    visited_np = np.zeros(W, dtype=np.uint32)
    np.bitwise_or.at(
        visited_np, (seeds >> 5).astype(np.int64),
        np.uint32(1) << (seeds & 31).astype(np.uint32),
    )
    visited_j = jnp.asarray(visited_np)
    # bucket-pad the seed-validity gather so it reuses compiled shapes
    s_pad = _bucket_size(len(seeds))
    seeds_b = np.zeros(s_pad, dtype=np.int64)
    seeds_b[: len(seeds)] = seeds
    valid_seed = np.asarray(graph.valid[jnp.asarray(seeds_b)])[: len(seeds)]
    frontier_np = seeds[valid_seed].astype(np.int32)
    if verbose:
        print(
            f"      region setup: {time.perf_counter() - t_setup:.2f}s "
            f"({len(seeds)} seeds)",
            flush=True,
        )

    # ONE upload; afterwards the frontier stays device-resident between
    # phases (re-sized with device slice/pad), so no phase re-uploads it
    count = len(frontier_np)
    cap = _bucket_size(max(4 * count, 4096))
    if cap > 4 * n:
        cap = _bucket_size(4 * n)
    fr = np.full(cap, n, dtype=np.int32)
    fr[:count] = np.sort(frontier_np)
    frontier_j = jnp.asarray(fr)

    remaining = hops
    while remaining > 0 and count > 0:
        # phase cost ∝ cap x levels and cap tracks the LIVE frontier only
        # between phases: with a large frontier (many cycle-node seeds
        # saturate their region after 1-2 hops and collapse) run SHORT
        # phases so the cap can adapt down before paying 6 levels at full
        # width; once the cap is small the per-phase dispatch dominates,
        # so pack MANY levels per program. The ladder was tuned on the
        # previous accelerator and is unmeasured on this card.
        want = _bucket_size(max(4 * count, 4096))
        cap = min(want, _bucket_size(4 * n))
        if count > 32_768:
            levels = 2
        elif cap <= 16_384:
            levels = 4 * _REGION_PHASE_LEVELS
        else:
            levels = _REGION_PHASE_LEVELS
        levels = min(levels, remaining)
        done = False
        while not done:
            frontier_j = _resize_frontier(frontier_j, cap, jnp.int32(n))
            t0 = time.perf_counter()
            frontier_next, visited_next, overflow = _undirected_region_steps(
                graph.out, graph.in_, graph.valid,
                frontier_j, visited_j, levels, cap,
            )
            if not bool(overflow):
                visited_j = visited_next
                frontier_j = frontier_next
                count = int(jnp.sum(frontier_next < n))
                remaining -= levels
                done = True
                if verbose:
                    print(
                        f"      region phase: {levels} levels cap={cap} "
                        f"frontier={count} "
                        f"({time.perf_counter() - t0:.2f}s)",
                        flush=True,
                    )
            elif cap >= 4 * n:
                # even the full-graph tier overflowed: host fallback picks
                # up from the already-reached state
                if verbose:
                    print(
                        f"    region growth kernel overflowed at cap={cap}",
                        flush=True,
                    )
                f = np.asarray(frontier_j)
                reached = _unpack_bitset(np.asarray(visited_j), n)
                return _undirected_region_mask_host(
                    graph, f[f < n].astype(np.int64), remaining,
                    reached=reached,
                )
            else:
                # retry the same phase (pre-phase frontier kept) bigger
                cap = min(_bucket_size(cap * 8), _bucket_size(4 * n))

    t_fin = time.perf_counter()
    res = _unpack_bitset(np.asarray(visited_j), n)
    if verbose:
        print(
            f"      region finish (bitset down+unpack): "
            f"{time.perf_counter() - t_fin:.2f}s",
            flush=True,
        )
    return res


@functools.partial(jax.jit, static_argnames=("new_cap",))
def _resize_frontier(frontier: jax.Array, new_cap: int, fill: jax.Array):
    """Device-side frontier re-size (sorted, fill-padded at the tail)."""
    cur = frontier.shape[0]
    if new_cap <= cur:
        # never truncates live entries: the caller's new_cap >= 4x the
        # live count (which the overflow check bounds to <= cur)
        return frontier[:new_cap]
    return jnp.concatenate(
        [frontier, jnp.full((new_cap - cur,), fill, frontier.dtype)]
    )


def _unpack_bitset(words: np.ndarray, n: int) -> np.ndarray:
    """Bit i of the mask = bit (i & 31) of uint32 word (i >> 5) — i.e.
    little-endian bit order, which on a little-endian host is exactly
    ``unpackbits(view(uint8), bitorder="little")``, with no int64
    temporaries (a fancy-indexed gather allocated 32 bytes per node)."""
    return np.unpackbits(
        np.ascontiguousarray(words).view(np.uint8), count=n, bitorder="little"
    ).astype(bool)


def _undirected_region_mask_host(
    graph: DBG, seeds: np.ndarray, hops: int, reached: np.ndarray | None = None
) -> np.ndarray:
    """Per-level host-loop fallback (exact same semantics, no frontier cap).

    ``reached`` continues from a partially-grown state (kernel overflow
    handoff): ``seeds`` is then the live frontier, already in it.
    """
    from mcaat_tpu.graph.dbg import _bucket_size

    n = graph.size
    valid_h = np.asarray(graph.valid)
    if reached is None:
        reached = np.zeros(n, dtype=bool)
    reached[seeds] = True
    frontier = seeds[valid_h[seeds]]
    for _ in range(hops):
        if len(frontier) == 0:
            break
        F = _bucket_size(len(frontier))
        fr = np.full(F, int(frontier[0]), dtype=np.int64)  # pad with a real id
        fr[: len(frontier)] = frontier
        fr_j = jnp.asarray(fr)
        o = np.asarray(_gather_rows(graph.out, fr_j)).ravel()
        i = np.asarray(_gather_rows(graph.in_, fr_j)).ravel()
        nbrs = np.concatenate([o, i])
        nbrs = nbrs[nbrs >= 0]
        new = np.unique(nbrs)
        new = new[~reached[new]]
        reached[new] = True
        frontier = new[valid_h[new]]
    return reached


def extract_region_graph(graph: DBG, mask: np.ndarray):
    """Compact the masked rows into a full DBG (kmers kept for labels) +
    the ascending global-id map."""
    gids = np.nonzero(mask)[0].astype(np.int64)
    sel = jnp.asarray(gids)
    out_rows = np.asarray(_gather_rows(graph.out, sel))
    in_rows = np.asarray(_gather_rows(graph.in_, sel))
    compact = DBG(
        k=graph.k,
        kmers=graph.kmers[sel],
        mult=graph.mult[sel],
        out=jnp.asarray(remap_to_local(gids, out_rows).reshape(-1)),
        in_=jnp.asarray(remap_to_local(gids, in_rows).reshape(-1)),
        valid=graph.valid[sel],
    )
    return compact, gids


def remap_chains(gids: np.ndarray, cycles: list[list[int]], reads):
    """Remap cycle/read node chains into compact local ids; out-of-region
    entries get unique negative surrogates (-2 - first-appearance rank),
    distinct from the -1 miss sentinel, preserving equality structure.

    ``reads`` is a ``Chains`` (or list of lists); the remapped reads come
    back as ``Chains`` over the SAME offsets — no per-read Python
    round-trip (VERDICT r4 #4).
    """
    from mcaat_tpu.reads.chains import Chains

    reads = Chains.from_lists(reads)
    lens_c = [len(c) for c in cycles]
    flat = np.concatenate(
        [np.asarray(c, dtype=np.int64) for c in cycles]
        + [reads.flat, np.zeros(0, dtype=np.int64)]
    )
    out = remap_to_local(gids, flat).astype(np.int64)
    miss = (out < 0) & (flat >= 0)
    if miss.any():
        miss_vals = flat[miss]
        _vals, first_idx, inv = np.unique(
            miss_vals, return_index=True, return_inverse=True
        )
        rank = np.argsort(np.argsort(first_idx, kind="stable"), kind="stable")
        out[miss] = -2 - rank[inv]
    cyc_res = []
    off = 0
    for ln in lens_c:
        cyc_res.append(out[off : off + ln].tolist())
        off += ln
    return cyc_res, reads.with_flat(out[off:])
