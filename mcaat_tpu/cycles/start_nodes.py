"""Start-node selection: vectorized candidate filter + batched bounded BFS.

Replaces ``CycleFinder::ChunkStartNodes`` + ``DepthLevelSearch`` (reference
``src/cycle_finder.cpp:248-343,387-427``). The reference runs millions of
scalar depth-limited DFS probes (its own headline optimization target:
30-40M nodes / 5 min, ``src/z_optimization_dev_notes.md:11``). Here the
candidate predicate is one vectorized pass over the whole node table, and
the "is this node on a cycle of length ≤ L" probe runs as a *batched*
frontier BFS: B candidate lanes advance together, each level is one gather
``out[frontier] -> [B, F, 4]`` + dedup (sort per lane) + bitset visited
update — all on device.

Candidate predicate (src/cycle_finder.cpp:398-411):
  valid ∧ in-degree ≥ 2 ∧ mult > threshold_multiplicity ∧ no self-loop,
then keep only candidates that can reach themselves within
``cycle_max_length`` steps.

The BFS uses a per-lane visited bitset (uint32 words) and a per-level
frontier cap F. If a lane's level ever overflows F the lane is flagged and
re-checked exactly on host (rare: the probe region is bounded by depth
≤ 77 over out-degree ≤ 4 graphs that have been multiplicity-pruned).
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np

from mcaat_tpu.graph.dbg import DBG


@functools.partial(jax.jit, static_argnames=("max_depth", "frontier_cap"))
def _self_reach_kernel(
    out: jax.Array,  # int32 [4N] flat adjacency
    valid: jax.Array,  # bool  [N]
    starts: jax.Array,  # int32 [B]
    max_depth: int,
    frontier_cap: int,
):
    N = out.shape[0] // 4
    B = starts.shape[0]
    F = frontier_cap
    W = (N + 31) // 32
    live_lane = starts >= 0
    starts_c = jnp.maximum(starts, 0)

    frontier = jnp.full((B, F), N, dtype=jnp.int32)
    frontier = frontier.at[:, 0].set(jnp.where(live_lane, starts_c, N))
    # flat [B*W] bitset: per-level membership gather + mark scatter run as
    # 1-D ops with sorted indices (chosen over 2-D scatters on the previous
    # accelerator)
    visited = jnp.zeros((B * W,), dtype=jnp.uint32)
    found = jnp.zeros((B,), dtype=bool)
    overflow = jnp.zeros((B,), dtype=bool)
    row_base = (jnp.arange(B, dtype=jnp.int32) * W)[:, None]

    def cond(state):
        depth, frontier, visited, found, overflow = state
        # early exit: every lane either found its cycle or its frontier died
        active = ~found & (frontier[:, 0] < N)
        return (depth < max_depth) & jnp.any(active)

    def body(state):
        depth, frontier, visited, found, overflow = state
        # found lanes stop expanding (kill their frontier)
        frontier = jnp.where(found[:, None], N, frontier)
        f_live = frontier < N
        f_idx = jnp.minimum(frontier, N - 1)
        slots = (f_idx * 4)[:, :, None] + jnp.arange(4, dtype=jnp.int32)
        nbrs = out[slots]  # [B, F, 4]
        nbr_live = (nbrs >= 0) & f_live[..., None]
        nbrs_c = jnp.maximum(nbrs, 0)
        nbr_live &= valid[nbrs_c]
        # cycle closure: any neighbor equals the lane's start node
        found = found | jnp.any(nbr_live & (nbrs_c == starts_c[:, None, None]), axis=(1, 2))

        flat = jnp.where(nbr_live, nbrs_c, N).reshape(B, 4 * F)
        # sort first: dedup is adjacent-compare, and the visited gather's
        # flat indices become sorted (row_base increases by lane, words
        # nondecreasing within a lane)
        flat = jnp.sort(flat, axis=1)
        dup = jnp.concatenate(
            [jnp.zeros((B, 1), bool), (flat[:, 1:] == flat[:, :-1]) & (flat[:, 1:] < N)],
            axis=1,
        )
        # visited filter: flat 1-D gather with sorted indices (computed
        # before nulling dups so the index sequence stays sorted; a dup
        # entry just re-gathers its predecessor's word)
        word = jnp.minimum(flat >> 5, W - 1)
        bit = (jnp.uint32(1) << (flat & 31).astype(jnp.uint32))
        gidx = (row_base + word).reshape(-1)
        got = visited.at[gidx].get(indices_are_sorted=True, mode="promise_in_bounds")
        seen = (got.reshape(B, 4 * F) & bit) != 0
        # drop dups + seen entries and compact with one more sort
        flat = jnp.where(dup | seen, N, flat)
        flat = jnp.sort(flat, axis=1)
        n_new = jnp.sum(flat < N, axis=1)
        overflow = overflow | (n_new > F)
        new_frontier = flat[:, :F]
        # mark visited: flat 1-D scatter-add, sorted indices (values are
        # deduped so bits are fresh; dead slots add 0)
        nf_live = new_frontier < N
        w2 = jnp.minimum(new_frontier >> 5, W - 1)
        b2 = jnp.where(
            nf_live, jnp.uint32(1) << (new_frontier & 31).astype(jnp.uint32), jnp.uint32(0)
        )
        sidx = (row_base + w2).reshape(-1)
        visited = visited.at[sidx].add(
            b2.reshape(-1), indices_are_sorted=True, mode="promise_in_bounds"
        )
        return depth + 1, new_frontier, visited, found, overflow

    _, frontier, visited, found, overflow = jax.lax.while_loop(
        cond, body, (jnp.int32(0), frontier, visited, found, overflow)
    )
    return found & live_lane, overflow & live_lane


def self_reachable_batch(
    graph: DBG,
    starts: np.ndarray,
    max_depth: int,
    batch: int = 512,
    frontier_cap: int = 64,
) -> np.ndarray:
    """For each start node: can it reach itself in ≤ max_depth valid steps?

    Exact and tiered: per-level cost is gather-bound (∝ batch ×
    frontier_cap), so the first pass runs with a small frontier; lanes
    that overflow retry with a 16x frontier, and anything still
    overflowing falls back to an exact host DFS (rare tangles).
    """
    starts = np.asarray(starts, dtype=np.int32)
    n = len(starts)
    result = np.zeros(n, dtype=bool)
    if n == 0:
        return result
    # frontier can never exceed the node count; shrink lanes for tiny inputs
    # (fewer/faster compiles, same results)
    cap1 = min(frontier_cap, _pow2ceil(graph.size))
    cap2 = min(frontier_cap * 16, _pow2ceil(graph.size))
    batch = min(batch, _pow2ceil(n))
    # per-lane visited bitset is N/32 words; cap the total at ~1 GiB so
    # big graphs don't OOM (throughput per candidate is ~flat in B anyway)
    words_per_lane = (graph.size + 31) // 32
    max_lanes = max(int((1 << 28) // max(words_per_lane, 1)), 16)
    batch = min(batch, 1 << (max_lanes.bit_length() - 1))  # pow2 floor

    retry: list[int] = []
    for lo in range(0, n, batch):
        chunk = starts[lo : lo + batch]
        pad = np.full(batch - len(chunk), -1, dtype=np.int32)
        starts_b = jnp.asarray(np.concatenate([chunk, pad]))
        found, overflow = _self_reach_kernel(
            graph.out, graph.valid, starts_b, max_depth, cap1
        )
        found = np.asarray(found[: len(chunk)])
        overflow = np.asarray(overflow[: len(chunk)])
        result[lo : lo + len(chunk)] = found
        retry.extend((lo + i) for i in np.nonzero(overflow & ~found)[0])

    if retry and cap2 > cap1:
        still: list[int] = []
        retry_np = np.asarray(retry, dtype=np.int64)
        rbatch = min(batch, _pow2ceil(len(retry)))
        for lo in range(0, len(retry_np), rbatch):
            sel = retry_np[lo : lo + rbatch]
            chunk = starts[sel]
            pad = np.full(rbatch - len(chunk), -1, dtype=np.int32)
            starts_b = jnp.asarray(np.concatenate([chunk, pad]))
            found, overflow = _self_reach_kernel(
                graph.out, graph.valid, starts_b, max_depth, cap2
            )
            found = np.asarray(found[: len(chunk)])
            overflow = np.asarray(overflow[: len(chunk)])
            result[sel] = found
            still.extend(sel[np.nonzero(overflow & ~found)[0]].tolist())
        retry = still

    if retry:
        out_h = np.asarray(graph.out).reshape(-1, 4)
        valid_h = np.asarray(graph.valid)
        for i in retry:
            result[i] = _self_reach_host(out_h, valid_h, int(starts[i]), max_depth)
    return result


def _pow2ceil(x: int) -> int:
    return 1 << max(int(x) - 1, 1).bit_length()


def _self_reach_host(
    out: np.ndarray, valid: np.ndarray, start: int, max_depth: int
) -> bool:
    """Exact host BFS fallback (mirrors DLS semantics, src/cycle_finder.cpp:248)."""
    frontier = {start}
    seen: set[int] = set()
    for _ in range(max_depth):
        nxt: set[int] = set()
        for v in frontier:
            for nb in out[v]:
                nb = int(nb)
                if nb < 0 or not valid[nb]:
                    continue
                if nb == start:
                    return True
                if nb not in seen:
                    seen.add(nb)
                    nxt.add(nb)
        if not nxt:
            return False
        frontier = nxt
    return False


@jax.jit
def _candidate_mask(out, in_, valid, mult, threshold_multiplicity):
    """Static candidate predicate, one fused pass (src/cycle_finder.cpp:398-411).

    Flat strided slices only — ``(out == ids4).reshape(-1, 4)`` was
    materialized by XLA as ``u32[N,4]`` at the previous accelerator's
    tiled layout, which padded the minor dim many times over. Strided [N]
    slices of the flat [4N] array never pad.
    """
    from mcaat_tpu.graph.dbg import _degree

    indeg = _degree(in_, valid)
    ids = jnp.arange(out.shape[0] // 4, dtype=jnp.int32)
    self_loop = (out[0::4] == ids)
    for b in range(1, 4):
        self_loop = self_loop | (out[b::4] == ids)
    return valid & (indeg >= 2) & (mult > threshold_multiplicity) & ~self_loop


@jax.jit
def _precand_order(valid, mult, threshold_multiplicity):
    """Cheap pre-candidate compaction: candidate ids first, ascending.

    ``argsort(~pre, stable)`` puts the nodes passing the O(N)-cheap half
    of the predicate (valid & mult>thr) at the front in ascending-id
    order — one device sort instead of a host nonzero over a downloaded
    full-size bool mask.
    """
    pre = valid & (mult > threshold_multiplicity)
    return jnp.argsort(~pre, stable=True), jnp.sum(pre)


@jax.jit
def _cand_refine(out, in_, valid, ids):
    """indeg>=2 & no-self-loop for a SMALL id set (4 slot gathers)."""
    base = ids.astype(jnp.int64) * 4
    indeg = jnp.zeros(ids.shape, jnp.int32)
    self_loop = jnp.zeros(ids.shape, bool)
    for b in range(4):
        ib = in_[base + b]
        indeg = indeg + ((ib >= 0) & valid[jnp.maximum(ib, 0)])
        self_loop = self_loop | (out[base + b] == ids.astype(out.dtype))
    return (indeg >= 2) & ~self_loop


def candidate_ids(graph: DBG, threshold_multiplicity: int) -> np.ndarray:
    """Two-stage static candidate scan (src/cycle_finder.cpp:398-411).

    The fused full-graph predicate pays a 4N random validity gather for
    in-degrees to evaluate a filter that typically keeps ~1e3 nodes.
    Stage 1 compacts the cheap O(N) half (valid & mult>thr) with one
    device sort; stage 2 gathers the in/out slots of the survivors only.
    Falls back to the fused scan when the pre-filter keeps > n/8 nodes
    (the refine gathers would approach full-scan cost). Result is
    identical either way: ascending candidate ids.
    """
    from mcaat_tpu.graph.dbg import _bucket_size

    n = graph.size
    order, cnt = _precand_order(
        graph.valid, graph.mult, jnp.asarray(threshold_multiplicity, graph.mult.dtype)
    )
    c = int(cnt)
    if c == 0:
        return np.empty(0, dtype=np.int64)
    if c > n // 8:
        cand_mask = _candidate_mask(
            graph.out, graph.in_, graph.valid, graph.mult, threshold_multiplicity
        )
        return np.nonzero(np.asarray(cand_mask))[0].astype(np.int64)
    c_pad = min(_bucket_size(c), n)
    ids = order[:c_pad]
    keep = _cand_refine(graph.out, graph.in_, graph.valid, ids)
    ids_h = np.asarray(ids)[:c]
    return ids_h[np.asarray(keep)[:c]].astype(np.int64)


def select_start_nodes(
    graph: DBG,
    threshold_multiplicity: int,
    cycle_max_length: int,
    verbose: bool = True,
) -> dict[int, list[int]]:
    """Candidate scan + DLS filter; returns {log2-mult bucket: [node ids]}.

    Bucketing matches the reference: key = ceil(log2(multiplicity)),
    processed in descending order (src/cycle_finder.cpp:414-416,468).
    """
    cand = candidate_ids(graph, threshold_multiplicity).astype(np.int32)
    if verbose:
        print(f"ChunkStartNodes: {len(cand)} candidates pass the static filter")
    reach = self_reachable_batch(graph, cand, cycle_max_length)
    kept = cand[reach]
    return bucket_start_nodes(kept, np.asarray(graph.mult)[kept], verbose=verbose)


def bucket_start_nodes(
    kept: np.ndarray, mult: np.ndarray, verbose: bool = True
) -> dict[int, list[int]]:
    """Bucket surviving start nodes by ceil(log2(multiplicity))
    (src/cycle_finder.cpp:414-416); shared by the single-device and
    sharded candidate scans."""
    buckets: dict[int, list[int]] = {}
    for node, m in zip(np.asarray(kept).tolist(), np.asarray(mult).tolist()):
        key = int(np.ceil(np.log2(m))) if m > 1 else 0
        buckets.setdefault(key, []).append(int(node))
    if verbose:
        total = sum(len(v) for v in buckets.values())
        for key in sorted(buckets, reverse=True):
            print(
                f"Chunked start nodes: multiplicity bucket (log2)={key}, "
                f"nodes={len(buckets[key])}"
            )
        print(f"Start nodes found in chunks: {total}")
    return buckets
