"""Bounded multicycle enumeration (the "FBCE" core algorithm).

Faithful reimplementation of ``CycleFinder::FindCycle`` /
``FindCycleUtil`` / ``FindApproximateCRISPRArrays`` (reference
``src/cycle_finder.cpp:131-492``): Johnson-style bounded-length cycle
enumeration with a lock/relax mechanism, run per start node.

Division of labor: the *whole-graph* work — pruning, the
candidate scan and the millions of bounded reachability probes — runs on
device (see ``prune/`` and ``cycles/start_nodes.py``). The per-start-node
DFS below only ever touches the tiny neighborhood of an actual CRISPR
candidate (cycles ≤ cycle_max_length, ≤ 500 cycles per node), so it runs
on host over the numpy adjacency mirror; its cost is negligible next to
the scans.

Semantics preserved from the reference:
* neighbor admission: not globally visited, start_mult // nbr_mult ≤ 500,
  neighbor != expanding node, both valid (``_BackgroundCheck``,
  src/cycle_finder.cpp:40-52).
* a cycle is recorded when the start node reappears and
  ``len(path) > cycle_min_length`` (src/cycle_finder.cpp:157-166).
* lock/relax: a node is expandable iff ``len(path) < lock[node]``
  (default ``cycle_max_length``); on backtrack, locks of ancestors within
  range are relaxed through *incoming* edges (src/cycle_finder.cpp:168-210).
* nodes of recorded cycles are marked globally visited, suppressing later
  start nodes (src/cycle_finder.cpp:217-223).
* start nodes are processed bucket-by-bucket in descending
  ceil(log2(mult)) order (src/cycle_finder.cpp:468).

Deterministic divergences (documented, SURVEY.md §7.3 risk 2):
* neighbor sets iterate in ascending node order (the reference iterates
  C++ unordered_set order — thread/schedule dependent).
* a start node that exceeds ``cluster_bounds`` (500) cycles aborts with no
  cycles. The reference clears the list and then spins until a 10M-step
  counter trips (src/cycle_finder.cpp:147-166), returning whatever
  accumulated after the last clear — i.e. effectively junk for such
  tangles; we abort cleanly.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

from mcaat_tpu.graph.dbg import DBG
from mcaat_tpu.prune.prune import prune_graph
from mcaat_tpu.cycles.start_nodes import select_start_nodes

CLUSTER_BOUNDS = 500  # src/cycle_finder.cpp:132
MULT_RATIO_LIMIT = 500  # src/cycle_finder.cpp:45
STEP_LIMIT = 10_000_000  # src/cycle_finder.cpp:149


@dataclass
class CycleFinder:
    """Host-side enumerator over a pruned graph's numpy adjacency."""

    out: np.ndarray  # int32 [N, 4]
    in_: np.ndarray  # int32 [N, 4]
    valid: np.ndarray  # bool [N]
    mult: np.ndarray  # int32 [N]
    cycle_min_length: int
    cycle_max_length: int
    visited: np.ndarray = field(default=None)  # bool [N]

    def __post_init__(self):
        if self.visited is None:
            self.visited = np.zeros(self.out.shape[0], dtype=bool)

    # -- neighbor queries (≙ _GetOutgoings/_GetIncomings with background check)
    def _admissible(self, nbrs, node: int, start_mult: int) -> list[int]:
        res = []
        for nb in nbrs:
            nb = int(nb)
            if nb < 0 or not self.valid[nb]:
                continue
            if self.visited[nb]:
                continue
            if start_mult // int(self.mult[nb]) > MULT_RATIO_LIMIT:
                continue
            if nb == node:
                continue
            res.append(nb)
        res.sort()
        return res

    def _outgoings(self, node: int, start_mult: int) -> list[int]:
        if not self.valid[node]:
            return []
        return self._admissible(self.out[node], node, start_mult)

    def _incomings(self, node: int, start_mult: int) -> list[int]:
        if not self.valid[node]:
            return []
        return self._admissible(self.in_[node], node, start_mult)

    # -- the bounded DFS with lock/relax (≙ FindCycle) ------------------------
    def find_cycles_from(self, start: int) -> list[list[int]]:
        max_len = self.cycle_max_length
        min_len = self.cycle_min_length
        start_mult = int(self.mult[start])

        path: list[int] = [start]
        lock: dict[int, int] = {start: 0}
        stack: list[list[int]] = [self._outgoings(start, start_mult)]
        backtrack: list[int] = [max_len]
        cycles: list[list[int]] = []
        steps = 0

        while stack:
            steps += 1
            if steps > STEP_LIMIT:
                break
            neighbors = stack[-1]
            advanced = False
            aborted = False
            for pos, nb in enumerate(neighbors):
                if nb == start:
                    backtrack[-1] = 1
                    if len(path) > min_len:
                        cycles.append(list(path))
                        if len(cycles) >= CLUSTER_BOUNDS:
                            return []  # tangle: abort (see module docstring)
                elif len(path) < lock.get(nb, max_len):
                    neighbors.pop(pos)
                    path.append(nb)
                    backtrack.append(max_len)
                    lock[nb] = len(path)
                    stack.append(self._outgoings(nb, start_mult))
                    advanced = True
                    break
            if aborted:
                break
            if not advanced:
                stack.pop()
                v = path.pop()
                bl = backtrack.pop()
                if backtrack:
                    backtrack[-1] = min(backtrack[-1], bl)
                if bl < max_len:
                    # relax locks of ancestors (Johnson-style unblocking,
                    # bounded to cycle_max_length; src/cycle_finder.cpp:191-210)
                    relax_stack = [(bl, v)]
                    path_set = set(path)
                    while relax_stack:
                        rbl, u = relax_stack.pop()
                        if lock.get(u, max_len) < max_len - rbl + 1:
                            lock[u] = max_len - rbl + 1
                            for w in self._incomings(u, start_mult):
                                if w not in path_set:
                                    relax_stack.append((rbl + 1, w))

        if cycles:
            for cyc in cycles:
                for node in cyc:
                    self.visited[node] = True
        return cycles

    # -- full enumeration over bucketed start nodes (≙ FindApproximateCRISPRArrays)
    def enumerate(
        self, buckets: dict[int, list[int]], verbose: bool = True
    ) -> dict[int, list[list[int]]]:
        results: dict[int, list[list[int]]] = {}
        cumulative = 0
        for key in sorted(buckets, reverse=True):
            at_bucket_start = cumulative
            nodes = sorted(buckets[key])
            for start in nodes:
                if self.visited[start]:
                    continue
                cycles = self.find_cycles_from(start)
                cumulative += len(cycles)
                results[start] = cycles
            if verbose:
                print(
                    f"Bucket log2_mult={key}: processed {len(nodes)} nodes, "
                    f"found {cumulative - at_bucket_start} cycles "
                    f"(cumulative {cumulative})"
                )
        if verbose:
            print(
                f"Cycle enumeration completed: total cycles={cumulative}, "
                f"result nodes={len(results)}"
            )
        return results


# below this node count the full-graph host transfer is trivially cheap
# and the extraction kernel's compile cost dominates; above it, only the
# candidate neighborhoods cross to host (VERDICT r1 weak #5: the full
# [N,4] pull would be ~20 GB at the 1B-node target)
NEIGHBORHOOD_MIN_NODES = 200_000

# Above this node count tip clipping is DEFERRED to the extracted candidate
# neighborhood ("lazy clip"): the global pointer-doubling chain collapse is
# ~log2(N) full-array random gathers, which dominated the cycle stage on
# the previous accelerator, while the neighborhood is orders of magnitude
# smaller (unmeasured on this card). This is output-preserving:
#  * self-reach (<= L steps) is clip-invariant: every node on a closed walk
#    lies on a cycle, and tip clipping never removes cycle nodes, so a
#    self-reaching walk exists pre-clip iff it exists post-clip.
#  * the candidate static filter matches the reference's post-clip filter on
#    the final (self-reaching) set: for a self-reaching node v, every
#    mult-valid in-neighbor u reaches v's cycle through the u->v edge, so u
#    is post-clip alive and indeg_pre(v) == indeg_post(v). Pre-clip
#    candidates are a superset, filtered to the same set by the probes.
#  * enumeration runs on the locally-clipped neighborhood: every cycle
#    (length <= L) through a start node lies in its forward <=L ball, local
#    clipping preserves all cycles inside the ball, and locally-dead
#    branches can never complete a cycle — the recorded cycle sequences are
#    identical (src/cycle_finder.cpp runs post-clip; parity-tested in
#    tests/test_reference_parity.py).
# The ordering stage's region growth needs post-clip validity; the condensed
# region graph is clipped there (pipeline.spacer_ordering_step completes the
# deferred clip — its condense threshold is tied to this constant, and its
# non-condensed path clips whenever the graph is at lazy scale).
LAZY_CLIP_MIN_NODES = 1_000_000

# Lazy clipping presumes enumeration runs on the (clipped) extracted
# neighborhood, never on an unclipped full graph.
assert LAZY_CLIP_MIN_NODES >= NEIGHBORHOOD_MIN_NODES


def enumerate_on_arrays(
    out: np.ndarray,
    in_: np.ndarray,
    valid: np.ndarray,
    mult: np.ndarray,
    buckets: dict[int, list[int]],
    cycle_min_length: int,
    cycle_max_length: int,
    verbose: bool = True,
) -> dict[int, list[list[int]]]:
    """Host enumeration over explicit adjacency arrays (native fast path
    with Python fallback; same deterministic order and semantics)."""
    try:
        from mcaat_tpu.native import enumerate_cycles as native_enumerate

        ordered_starts = [
            s for key in sorted(buckets, reverse=True) for s in sorted(buckets[key])
        ]
        results = native_enumerate(
            out, in_, valid, mult,
            np.asarray(ordered_starts, dtype=np.int64),
            cycle_min_length, cycle_max_length,
        )
    except ImportError:
        results = None
    if results is None:
        finder = CycleFinder(
            out=out, in_=in_, valid=valid, mult=mult,
            cycle_min_length=cycle_min_length,
            cycle_max_length=cycle_max_length,
        )
        results = finder.enumerate(buckets, verbose=verbose)
    elif verbose:
        total = sum(len(c) for c in results.values())
        print(
            f"Cycle enumeration completed (native): total cycles={total}, "
            f"result nodes={len(results)}"
        )
    return results


def enumerate_from_buckets(
    graph: DBG,
    buckets: dict[int, list[int]],
    cycle_min_length: int,
    cycle_max_length: int,
    verbose: bool = True,
    min_nodes_for_extraction: int = NEIGHBORHOOD_MIN_NODES,
) -> dict[int, list[list[int]]]:
    """Cycle enumeration with device-side neighborhood extraction.

    For large graphs, a device union-BFS computes the forward-reachable
    set of all start nodes (output-preserving — see
    ``cycles/neighborhood.py``) and only those rows cross to host; the
    enumeration runs on compact local ids and results map back to global.
    """
    starts_all = np.asarray(
        sorted(s for nodes in buckets.values() for s in nodes), dtype=np.int64
    )
    if len(starts_all) == 0:
        return {}
    n = graph.size
    if n >= min_nodes_for_extraction:
        from mcaat_tpu.cycles.neighborhood import extract_subgraph, touched_mask

        mask = touched_mask(
            graph.out, graph.valid, starts_all, cycle_max_length, n
        )
        if mask is not None:
            out_h, in_h, valid_h, mult_h, gids = extract_subgraph(graph, mask)
            if verbose:
                print(
                    f"Neighborhood extraction: {len(gids)}/{n} nodes "
                    f"touched by {len(starts_all)} start nodes"
                )
            loc_of = {int(g): i for i, g in enumerate(gids)}
            buckets_loc = {
                key: [loc_of[s] for s in nodes]
                for key, nodes in buckets.items()
            }
            results_loc = enumerate_on_arrays(
                out_h, in_h, valid_h, mult_h, buckets_loc,
                cycle_min_length, cycle_max_length, verbose=verbose,
            )
            return {
                int(gids[start]): [[int(gids[v]) for v in cyc] for cyc in cycles]
                for start, cycles in results_loc.items()
            }
        if verbose:
            print("Neighborhood extraction overflowed; using full graph")
    out = np.asarray(graph.out).reshape(-1, 4)
    in_ = np.asarray(graph.in_).reshape(-1, 4)
    valid = np.asarray(graph.valid)
    mult = np.asarray(graph.mult)
    return enumerate_on_arrays(
        out, in_, valid, mult, buckets,
        cycle_min_length, cycle_max_length, verbose=verbose,
    )


def find_cycles(
    graph: DBG,
    threshold_multiplicity: int = 20,
    cycle_min_length: int = 27,
    cycle_max_length: int = 77,
    verbose: bool = True,
    full_prune: bool = False,
) -> tuple[DBG, dict[int, list[list[int]]]]:
    """Prune + start-node scan (device) + cycle enumeration (host).

    Returns the pruned graph and ``{start_node: [cycles]}`` (each cycle a
    node-id list beginning at its start node), the analog of
    ``CycleFinder::results`` (reference include/cycle_finder.h:60).

    Large graphs take the compact path: after the static candidate scan,
    the union forward-reachable set is extracted ONCE and the tip clip,
    the self-reach probes and the enumeration all run on the compact
    subgraph (see LAZY_CLIP_MIN_NODES; at 16.7M nodes the global chain
    collapse alone cost 15.3s and the full-graph probes carried a 1 GB
    visited bitset per 512-lane batch). With ``full_prune`` the graph is
    always globally pruned first — callers whose downstream consumes
    whole-graph validity (the DEBUG pipeline's Filters/protospacer/phage
    stages) need that.
    """
    import jax.numpy as jnp

    from mcaat_tpu.cycles.start_nodes import (
        bucket_start_nodes,
        candidate_ids,
        self_reachable_batch,
    )
    from mcaat_tpu.prune.prune import clip_tips, invalidate_low_multiplicity
    from mcaat_tpu.utils.profiling import tick_printer

    _tick = tick_printer("cycles", verbose)

    lazy_clip = not full_prune and graph.size >= LAZY_CLIP_MIN_NODES
    if lazy_clip:
        graph, n_mult = invalidate_low_multiplicity(graph)
        if verbose:
            print(
                f"Graph size: {graph.size} nodes; "
                f"tip clipping deferred to the candidate neighborhood"
            )
            print(
                f"Pre-filter: invalidated {n_mult} node(s) with multiplicity <= 1."
            )
        _tick("mult filter")
    else:
        graph = prune_graph(graph, verbose=verbose)
        _tick("prune")
    n = graph.size
    if n >= NEIGHBORHOOD_MIN_NODES:
        from mcaat_tpu.cycles.neighborhood import extract_subgraph, touched_mask

        cand = candidate_ids(graph, threshold_multiplicity)
        if verbose:
            print(f"ChunkStartNodes: {len(cand)} candidates pass the static filter")
        _tick("candidate scan")
        if len(cand) == 0:
            return graph, {}
        mask = touched_mask(graph.out, graph.valid, cand, cycle_max_length, n)
        _tick("touched mask (union BFS)")
        if mask is not None:
            out_h, in_h, valid_h, mult_h, gids = extract_subgraph(graph, mask)
            if verbose:
                print(
                    f"Neighborhood extraction: {len(gids)}/{n} nodes "
                    f"touched by {len(cand)} start nodes"
                )
            _tick("subgraph extraction")
            sub = DBG(
                k=graph.k,
                kmers=jnp.zeros((len(gids),), jnp.int64),
                mult=jnp.asarray(mult_h),
                out=jnp.asarray(out_h.reshape(-1)),
                in_=jnp.asarray(in_h.reshape(-1)),
                valid=jnp.asarray(valid_h),
            )
            if lazy_clip:
                # deferred tip clip, at neighborhood scale (see
                # LAZY_CLIP_MIN_NODES for why this is output-preserving)
                sub, n_clipped = clip_tips(sub)
                valid_h = np.asarray(sub.valid)
                if verbose:
                    print(
                        f"Neighborhood tip clip: {n_clipped} node(s) clipped"
                    )
                _tick("neighborhood clip")
            loc_cand = np.searchsorted(gids, cand).astype(np.int32)
            reach = self_reachable_batch(sub, loc_cand, cycle_max_length)
            _tick("self-reach probes")
            kept_loc = loc_cand[reach]
            buckets_loc = bucket_start_nodes(
                kept_loc, mult_h[kept_loc], verbose=verbose
            )
            results_loc = enumerate_on_arrays(
                out_h, in_h, valid_h, mult_h, buckets_loc,
                cycle_min_length, cycle_max_length, verbose=verbose,
            )
            _tick("enumeration")
            results = {
                int(gids[s]): [[int(gids[v]) for v in cyc] for cyc in cycles]
                for s, cycles in results_loc.items()
            }
            return graph, results
        if verbose:
            print("Neighborhood extraction overflowed; using full graph")
        if lazy_clip:
            graph, _ = clip_tips(graph)
            _tick("global clip (extraction fallback)")
    buckets = select_start_nodes(
        graph, threshold_multiplicity, cycle_max_length, verbose=verbose
    )
    results = enumerate_from_buckets(
        graph, buckets, cycle_min_length, cycle_max_length, verbose=verbose
    )
    return graph, results


def cycles_map_to_cycles(results: dict[int, list[list[int]]]) -> list[list[int]]:
    """Flatten {start: [cycles]} deterministically (≙ src/tmp_utils.cpp:26-38)."""
    flat: list[list[int]] = []
    for start in sorted(results):
        flat.extend(results[start])
    return flat
