"""Spacer ordering: subproblem split + constraint solving.

Reimplements reference ``src/spacer_ordering.cpp`` with the same
observable math. The only stage with whole-graph cost — growing the
CRISPR region by k hops (``keep_crispr_regions_extended_by_k``,
src/spacer_ordering.cpp:78-139) — runs on device as iterated frontier
expansion; everything after the SCC split operates on tiny subproblems
and runs on host:

* SCC split: iterative Tarjan (the reference's recursive version,
  src/spacer_ordering.cpp:3-76, overflows on long paths — SURVEY §7.3
  risk 6), components of size > 1 only, scanning nodes in ascending id
  order for determinism.
* minimum set cover over cycles (replaces the vendored cft solver,
  src/spacer_ordering.cpp:270-314): exact branch-and-bound for small
  instances, greedy beyond — the instances that occur are tiny
  (SURVEY §7.3 risk 5).
* read-derived ordering constraints (src/spacer_ordering.cpp:356-489),
  including the reference's quirk of feeding ``every_possible_combination``
  the *unmerged* index list (line 400) — kept for output parity.
* greedy cycle resolution via maximal spanning tree (Kruskal on
  weight = constraint count, src/spacer_ordering.cpp:491-573).
* heuristic topological sort with identical confidence arithmetic
  (src/spacer_ordering.cpp:575-731), made iterative.
"""

from __future__ import annotations

import functools
from dataclasses import dataclass, field

import jax
import jax.numpy as jnp
import numpy as np

from mcaat_tpu.graph.dbg import DBG

NOT_IN_ANY_CYCLE_INDEX = 2**32 - 1  # spacer_ordering.h:68


# ---------------------------------------------------------------------------
# Region growing (device)
# ---------------------------------------------------------------------------


@functools.partial(jax.jit, static_argnames=("hops",))
def _grow_region(out, in_, valid, seed_mask, hops: int):
    """BFS-expand seed nodes ``hops`` times through valid nodes.

    Expansion only proceeds *from* valid nodes, but invalid neighbors do
    join the reached set (they stay invalid afterwards) — mirroring the
    reference which inserts raw neighbors into the kept set but only
    expands valid members (src/spacer_ordering.cpp:96-129).

    Pure-gather formulation (no nonzero/scatter): node v is
    added this hop iff any of its in- or out-neighbors is an expandable
    frontier node — read off the reverse adjacency with two gathers.
    """

    def body(_, state):
        reached, frontier = state
        fm = frontier & valid  # only valid nodes expand
        in_c = jnp.maximum(in_, 0)  # flat [4N]
        out_c = jnp.maximum(out, 0)
        # strided flat slices, not reshape(-1, 4) — see prune._chain_collapse
        # u -> v edge with u in frontier: check v's in-list
        # v -> u edge with u in frontier: check v's out-list
        hit = (fm[in_c[0::4]] & (in_[0::4] >= 0)) | (
            fm[out_c[0::4]] & (out[0::4] >= 0)
        )
        for b in range(1, 4):
            hit = hit | (fm[in_c[b::4]] & (in_[b::4] >= 0))
            hit = hit | (fm[out_c[b::4]] & (out[b::4] >= 0))
        new_frontier = hit & ~reached
        return reached | hit, new_frontier

    reached, _ = jax.lax.fori_loop(0, hops, body, (seed_mask, seed_mask))
    return reached


# Above this size the k-hop growth runs the frontier-compact bitset
# kernel instead of the hops x O(4N) full-array program: the full-array
# formulation pays 8 gathers/hop x read_len hops over the whole region
# graph, where the frontier never exceeds a few thousand nodes. Identical
# semantics (parity-tested both ways). The threshold was tuned on the
# previous accelerator and is unmeasured on this card.
GROW_FRONTIER_MIN_NODES = 100_000


def keep_crispr_regions_extended_by_k(
    graph: DBG, k_hops: int, cycles: list[list[int]]
) -> DBG:
    """Invalidate everything outside the k-hop-extended cycle region.

    ≙ reference src/spacer_ordering.cpp:78-139 (note: the hop count the
    pipeline passes is the *read chain length*, src/main_run_and_debug.cpp:40-41).
    """
    n = graph.size
    if n >= GROW_FRONTIER_MIN_NODES:
        from mcaat_tpu.cycles.neighborhood import undirected_region_mask

        seeds = np.asarray(
            sorted({int(v) for c in cycles for v in c}), dtype=np.int64
        )
        reached = undirected_region_mask(graph, seeds, int(k_hops))
        return graph.with_valid(graph.valid & jnp.asarray(reached))
    seed = np.zeros(n, dtype=bool)
    for cycle in cycles:
        seed[np.asarray(cycle, dtype=np.int64)] = True
    reached = _grow_region(
        graph.out, graph.in_, graph.valid, jnp.asarray(seed), int(k_hops)
    )
    return graph.with_valid(graph.valid & reached)


# ---------------------------------------------------------------------------
# SCC split (host, iterative Tarjan)
# ---------------------------------------------------------------------------


@dataclass
class Subgraph:
    """≙ reference ``Graph`` struct (spacer_ordering.h:38-66)."""

    adjacency: dict[int, list[int]] = field(default_factory=dict)
    nodes: set[int] = field(default_factory=set)

    def add_edge(self, u: int, v: int) -> None:
        self.adjacency.setdefault(u, []).append(v)
        self.nodes.add(u)
        self.nodes.add(v)

    def edge_count(self) -> int:
        return sum(len(v) for v in self.adjacency.values())


def _valid_csr(out: np.ndarray, valid: np.ndarray):
    """CSR of the valid out-adjacency (vectorized once, no per-node lists)."""
    ok = (out >= 0) & valid[np.maximum(out, 0)] & valid[:, None]
    counts = ok.sum(axis=1)
    indptr = np.zeros(out.shape[0] + 1, dtype=np.int64)
    np.cumsum(counts, out=indptr[1:])
    # row-major nonzero order keeps each node's neighbors in slot order
    indices = out[ok]
    return indptr, indices.astype(np.int64)


def find_strongly_connected_components(
    out: np.ndarray, valid: np.ndarray
) -> list[list[int]]:
    """Iterative Tarjan over valid nodes; components with > 1 node.

    Matches the reference's traversal (ascending node order, out-neighbors
    filtered by validity; src/spacer_ordering.cpp:3-76) without the
    recursion-depth hazard. Neighbor lists come from one vectorized CSR
    pass; index/lowlink state is flat arrays, not dicts. When the native
    lib is built, the Tarjan walk itself runs in C (mcaat_scc — emission
    AND intra-component order identical; ~50x over this Python loop,
    which ran 4.1s on the 796M-window run's 394k-node condensed region);
    randomized parity: tests/test_ordering.py::test_native_scc_parity.
    """
    n = out.shape[0]
    indptr, indices = _valid_csr(out, valid)

    from mcaat_tpu.native import scc_components

    native_comps = scc_components(indptr, indices, valid)
    if native_comps is not None:
        return native_comps
    index_map = np.full(n, -1, dtype=np.int64)
    lowlink = np.zeros(n, dtype=np.int64)
    on_stack = np.zeros(n, dtype=bool)
    tarjan_stack: list[int] = []
    components: list[list[int]] = []
    counter = 0

    valid_nodes = np.nonzero(valid)[0]

    for root in valid_nodes:
        root = int(root)
        if index_map[root] >= 0:
            continue
        # each work item: (node, next neighbor cursor)
        index_map[root] = lowlink[root] = counter
        counter += 1
        tarjan_stack.append(root)
        on_stack[root] = True
        work: list[list[int]] = [[root, int(indptr[root])]]
        while work:
            top = work[-1]
            node, i = top
            end = int(indptr[node + 1])
            advanced = False
            while i < end:
                nb = int(indices[i])
                i += 1
                if index_map[nb] < 0:
                    top[1] = i
                    index_map[nb] = lowlink[nb] = counter
                    counter += 1
                    tarjan_stack.append(nb)
                    on_stack[nb] = True
                    work.append([nb, int(indptr[nb])])
                    advanced = True
                    break
                elif on_stack[nb]:
                    if index_map[nb] < lowlink[node]:
                        lowlink[node] = index_map[nb]
            if advanced:
                continue
            # node finished
            work.pop()
            if lowlink[node] == index_map[node]:
                comp = []
                while True:
                    w = tarjan_stack.pop()
                    on_stack[w] = False
                    comp.append(w)
                    if w == node:
                        break
                if len(comp) > 1:
                    components.append(comp)
            if work:
                parent = work[-1][0]
                if lowlink[node] < lowlink[parent]:
                    lowlink[parent] = lowlink[node]
    return components


def divide_graph_into_subgraphs(out: np.ndarray, valid: np.ndarray) -> list[Subgraph]:
    """≙ reference src/spacer_ordering.cpp:141-175 (vectorized per SCC).

    Adjacency lists assemble by run-splitting the row-major edge
    selection — each component node appears as exactly one row, so its
    kept out-slots are contiguous and the dict insertion order (first
    appearance of u) plus each u's neighbor order (slot order) are
    byte-identical to the former per-edge ``add_edge`` loop.
    """
    subgraphs: list[Subgraph] = []
    in_comp = np.full(out.shape[0], -1, dtype=np.int64)
    for ci, component in enumerate(find_strongly_connected_components(out, valid)):
        comp = np.asarray(component, dtype=np.int64)
        in_comp[comp] = ci
        rows = out[comp]  # [m, 4]
        ok = (rows >= 0) & (in_comp[np.maximum(rows, 0)] == ci)
        us = np.repeat(comp, 4).reshape(-1, 4)[ok]
        vs = rows[ok]
        if len(us) == 0:
            continue
        sg = Subgraph()
        starts = np.flatnonzero(np.r_[True, us[1:] != us[:-1]])
        ends = np.r_[starts[1:], len(us)]
        sg.adjacency = {
            int(us[s]): vs[s:e].tolist() for s, e in zip(starts, ends)
        }
        # every node of a >1-node SCC has an internal out- AND in-edge,
        # so the reference's add_edge node set equals the component set
        sg.nodes = set(comp.tolist())
        subgraphs.append(sg)
    return subgraphs


# Above this node count the host-side growth's adjacency download
# (2 x 16 B/node) outweighs the phased device kernel; below it the
# growth reuses the SCC split's own download and runs as pure numpy
# hops instead of the phased kernel's per-hop dispatches (tuned on the
# previous accelerator; unmeasured on this card).
_HOST_GROW_MAX_NODES = 4_000_000


def get_crispr_regions_extended_by_k(
    graph: DBG, k_hops: int, cycles: list[list[int]], verbose: bool = False
) -> tuple[DBG, list[Subgraph]]:
    import jax.numpy as jnp

    from mcaat_tpu.utils.profiling import tick_printer

    _t = tick_printer("  region split", verbose)
    if GROW_FRONTIER_MIN_NODES <= graph.size <= _HOST_GROW_MAX_NODES:
        # compact (condensed-region) graphs: download the adjacency ONCE
        # (the SCC split needs out/valid anyway), grow on host, push the
        # shrunken validity back up
        out_h = np.asarray(graph.out).reshape(-1, 4)
        in_h = np.asarray(graph.in_).reshape(-1, 4)
        valid_h = np.asarray(graph.valid)
        _t("adjacency download")
        seeds = np.unique(
            np.asarray(
                sorted({int(v) for c in cycles for v in c}), dtype=np.int64
            )
        )
        reached = _region_mask_host_arrays(
            out_h, in_h, valid_h, seeds, int(k_hops)
        )
        valid_h = valid_h & reached
        graph = graph.with_valid(jnp.asarray(valid_h))
        _t("keep_crispr growth (host)")
    else:
        graph = keep_crispr_regions_extended_by_k(graph, k_hops, cycles)
        _t("keep_crispr growth")
        out_h = np.asarray(graph.out).reshape(-1, 4)
        valid_h = np.asarray(graph.valid)
        _t("adjacency download")
    subgraphs = divide_graph_into_subgraphs(out_h, valid_h)
    _t("SCC + subgraph build")
    return graph, subgraphs


def _region_mask_host_arrays(
    out_h: np.ndarray,  # [N, 4]
    in_h: np.ndarray,  # [N, 4]
    valid_h: np.ndarray,  # [N]
    seeds: np.ndarray,
    hops: int,
) -> np.ndarray:
    """Pure-host undirected region growth over downloaded adjacency —
    identical semantics to keep_crispr_regions_extended_by_k's growth
    (invalid neighbors join the reached set, only valid nodes expand;
    src/spacer_ordering.cpp:96-129). Each hop is numpy gathers over the
    live frontier: zero device dispatches."""
    n = valid_h.shape[0]
    reached = np.zeros(n, dtype=bool)
    if len(seeds) == 0:
        return reached
    reached[seeds] = True
    frontier = seeds[valid_h[seeds]]
    for _ in range(hops):
        if len(frontier) == 0:
            break
        nbrs = np.concatenate(
            [out_h[frontier].ravel(), in_h[frontier].ravel()]
        )
        nbrs = nbrs[nbrs >= 0]
        new = np.unique(nbrs)
        new = new[~reached[new]]
        reached[new] = True
        frontier = new[valid_h[new]]
    return reached


# ---------------------------------------------------------------------------
# Relevance filters + set cover
# ---------------------------------------------------------------------------


def get_relevant_reads(
    subgraph: Subgraph, reads: list[list[int]]
) -> list[list[int]]:
    """Reads whose first or last node lies in the subgraph (ref :186-200)."""
    return [
        r for r in reads if r and (r[0] in subgraph.nodes or r[-1] in subgraph.nodes)
    ]


def get_relevant_cycles(
    subgraph: Subgraph, cycles: list[list[int]]
) -> list[list[int]]:
    """Cycles entirely inside the subgraph (ref :202-222)."""
    return [c for c in cycles if all(n in subgraph.nodes for n in c)]


def filter_subproblems(
    graph_size: int,
    subgraphs: list[Subgraph],
    reads: list[list[int]],
    cycles: list[list[int]],
) -> list[tuple[Subgraph, list[list[int]], list[list[int]]]]:
    """All subgraphs' relevance filters in one vectorized pass.

    Result-identical to calling ``get_relevant_reads`` /
    ``get_relevant_cycles`` per subgraph (ref :186-222) — SCC subgraphs
    partition the node set (every node of a >1-node SCC has an internal
    edge), so membership tests collapse to ONE node→subgraph-index map
    instead of S × R Python set lookups. Keeps the reference's subproblem
    skip rule: no relevant reads, or fewer than 3 relevant cycles
    (main_run_and_debug.cpp:54-59).
    """
    from mcaat_tpu.reads.chains import Chains

    reads = Chains.from_lists(reads)
    sgid = np.full(graph_size, -1, dtype=np.int64)
    for i, sg in enumerate(subgraphs):
        sgid[np.fromiter(sg.nodes, dtype=np.int64, count=len(sg.nodes))] = i

    # endpoint → subgraph index, vectorized over the flat chain arrays
    firsts = reads.firsts()
    lasts = reads.lasts()

    def _ep_sgid(ep):
        ok = (ep >= 0) & (ep < graph_size)
        return np.where(ok, sgid[np.where(ok, ep, 0)], -1)

    e0 = _ep_sgid(firsts)
    e1 = _ep_sgid(lasts)

    # -3 = empty cycle (vacuously inside EVERY subgraph, matching
    # all() on an empty generator); -2 = spans subgraphs / outside
    cyc_sg = np.full(len(cycles), -3, dtype=np.int64)
    for j, c in enumerate(cycles):
        if not c:
            continue
        arr = np.asarray(c, dtype=np.int64)
        if arr.min() < 0 or arr.max() >= graph_size:
            cyc_sg[j] = -2
            continue
        s = sgid[arr]
        cyc_sg[j] = s[0] if (s[0] >= 0 and (s == s[0]).all()) else -2

    remaining: list[tuple[Subgraph, list[list[int]], list[list[int]]]] = []
    for i, sg in enumerate(subgraphs):
        relevant_cycles = [
            cycles[j] for j in np.nonzero((cyc_sg == i) | (cyc_sg == -3))[0]
        ]
        relevant_cycles = get_minimum_cycles_for_full_coverage(relevant_cycles)
        if len(relevant_cycles) < 3:
            continue
        relevant_reads = reads.select(np.nonzero((e0 == i) | (e1 == i))[0])
        if len(relevant_reads) == 0:
            continue
        remaining.append((sg, relevant_reads, relevant_cycles))
    return remaining


def solve_min_cover_problem(
    universe: set[int], sets: list[list[int]]
) -> list[int]:
    """Minimum set cover: indices of a minimum-cardinality covering family.

    Replaces the vendored cft heuristic (ref :270-314). Exact
    branch-and-bound for ≤ 24 sets, greedy + redundancy elimination
    beyond — real instances here are a handful of cycles per subgraph.
    """
    if not universe or not sets:
        print("Error: Unable to find min cover as the universe or sets are empty")
        return []
    masks: list[int] = []
    elem_bit = {e: i for i, e in enumerate(sorted(universe))}
    full = (1 << len(elem_bit)) - 1
    for s in sets:
        m = 0
        for e in s:
            if e in elem_bit:
                m |= 1 << elem_bit[e]
        masks.append(m)
    union_all = 0
    for m in masks:
        union_all |= m
    if union_all != full:
        # not coverable — mirror cft returning best effort: greedy partial
        return _greedy_cover(masks, full)
    if len(masks) <= 24:
        return _exact_cover(masks, full)
    return _greedy_cover(masks, full)


def _greedy_cover(masks: list[int], full: int) -> list[int]:
    chosen: list[int] = []
    covered = 0
    while covered != full:
        best, best_gain = -1, 0
        for i, m in enumerate(masks):
            gain = bin(m & ~covered).count("1")
            if gain > best_gain:
                best, best_gain = i, gain
        if best < 0:
            break
        chosen.append(best)
        covered |= masks[best]
    # redundancy elimination: drop any set whose elements the rest still cover
    kept = list(chosen)
    for i in list(chosen):
        others = 0
        for j in kept:
            if j != i:
                others |= masks[j]
        if others == covered:
            kept.remove(i)
    return sorted(kept)


def _exact_cover(masks: list[int], full: int) -> list[int]:
    order = sorted(range(len(masks)), key=lambda i: -bin(masks[i]).count("1"))
    best: list[int] | None = None

    def bound_possible(covered: int, start: int) -> bool:
        rest = covered
        for idx in order[start:]:
            rest |= masks[idx]
        return rest == full

    def rec(start: int, covered: int, picked: list[int]):
        nonlocal best
        if covered == full:
            if best is None or len(picked) < len(best):
                best = list(picked)
            return
        if best is not None and len(picked) + 1 >= len(best):
            return
        if not bound_possible(covered, start):
            return
        for pos in range(start, len(order)):
            idx = order[pos]
            if masks[idx] & ~covered:
                picked.append(idx)
                rec(pos + 1, covered | masks[idx], picked)
                picked.pop()
                if best is not None and len(picked) + 1 >= len(best):
                    return

    rec(0, 0, [])
    return sorted(best or [])


def get_minimum_cycles_for_full_coverage(cycles: list[list[int]]) -> list[list[int]]:
    """≙ reference :224-268 — keep only a minimum covering subfamily."""
    if not cycles:
        return cycles
    node_id_map: dict[int, int] = {}
    sets: list[list[int]] = []
    universe: set[int] = set()
    for cycle in cycles:
        s = []
        for node in cycle:
            if node not in node_id_map:
                node_id_map[node] = len(node_id_map)
            mapped = node_id_map[node]
            s.append(mapped)
            universe.add(mapped)
        sets.append(s)
    kept = set(solve_min_cover_problem(universe, sets))
    return [c for i, c in enumerate(cycles) if i in kept]


# ---------------------------------------------------------------------------
# Constraints
# ---------------------------------------------------------------------------


def get_node_to_unique_cycle_map(cycles: list[list[int]]) -> dict[int, int]:
    """node -> cycle index, for nodes unique to exactly one cycle (ref :316-340)."""
    cycle_sets = [set(c) for c in cycles]
    counts: dict[int, int] = {}
    owner: dict[int, int] = {}
    for i, cs in enumerate(cycle_sets):
        for node in cs:
            counts[node] = counts.get(node, 0) + 1
            owner[node] = i
    return {node: owner[node] for node, c in counts.items() if c == 1}


def get_all_cycle_indices(node_to_cycle_map: dict[int, int]) -> list[int]:
    seen: list[int] = []
    for idx in node_to_cycle_map.values():
        if idx not in seen:
            seen.append(idx)
    return seen


def every_possible_combination(v: list[int]) -> list[tuple[int, int]]:
    """All ordered in-order pairs with distinct values (ref :356-372)."""
    out = []
    for i in range(len(v)):
        for j in range(i + 1, len(v)):
            if v[i] != v[j]:
                out.append((v[i], v[j]))
    return out


def generate_constraints_from_read(
    read: list[int], node_to_cycle_map: dict[int, int]
) -> list[tuple[int, int]]:
    """≙ reference :374-412 — NOTE: feeds the *unmerged* sequence to
    every_possible_combination (quirk preserved; line 400)."""
    indices = [node_to_cycle_map[n] for n in read if n in node_to_cycle_map]
    return every_possible_combination(indices)


def generate_out_of_cycles_constraints_from_read(
    read: list[int], node_to_cycle_map: dict[int, int]
) -> list[tuple[int, int]]:
    """≙ reference :414-459."""
    if not read:
        return []
    if read[0] not in node_to_cycle_map or read[-1] not in node_to_cycle_map:
        return []
    indices = [node_to_cycle_map.get(n, NOT_IN_ANY_CYCLE_INDEX) for n in read]
    merged: list[int] = []
    for idx in indices:
        if not merged or idx != merged[-1]:
            merged.append(idx)
    if len(merged) > 1:
        return [(merged[0], merged[1])]
    return []


def generate_constraints(
    reads: list[list[int]], node_to_cycle_map: dict[int, int]
) -> list[tuple[int, int]]:
    constraints: list[tuple[int, int]] = []
    for read in reads:
        constraints.extend(generate_constraints_from_read(read, node_to_cycle_map))
        constraints.extend(
            generate_out_of_cycles_constraints_from_read(read, node_to_cycle_map)
        )
    return constraints


# ---------------------------------------------------------------------------
# MST + greedy cycle resolution
# ---------------------------------------------------------------------------


def get_maximal_spanning_tree(
    edges: list[tuple[int, int]]
) -> list[tuple[int, int]]:
    """Kruskal on weight = occurrence count, descending (ref :491-550).

    Tie-break: the reference sorts (weight, edge) pairs descending, so ties
    break by larger edge tuple first; preserved here.
    """
    parent: dict[int, int] = {}
    rank: dict[int, int] = {}

    def find(x: int) -> int:
        while parent.setdefault(x, x) != x:
            parent[x] = parent[parent[x]]
            x = parent[x]
        return x

    def union(x: int, y: int) -> bool:
        rx, ry = find(x), find(y)
        if rx == ry:
            return False
        if rank.setdefault(rx, 0) < rank.setdefault(ry, 0):
            parent[rx] = ry
        elif rank[rx] > rank[ry]:
            parent[ry] = rx
        else:
            parent[ry] = rx
            rank[rx] += 1
        return True

    weights: dict[tuple[int, int], int] = {}
    for e in edges:
        weights[e] = weights.get(e, 0) + 1
    ordered = sorted(weights.items(), key=lambda kv: (kv[1], kv[0]), reverse=True)
    mst = []
    for edge, _w in ordered:
        if union(edge[0], edge[1]):
            mst.append(edge)
    return mst


def resolve_cycles_greedy(
    constraints: list[tuple[int, int]],
    heuristic_node_values: dict[int, int],
) -> list[tuple[int, int]]:
    """Keep MST constraints; removed ones debit the target's heuristic
    (ref :552-573). Returns the filtered constraint list."""
    mst = set(get_maximal_spanning_tree(constraints))
    filtered = []
    for c in constraints:
        frm, to = c
        if c not in mst and frm != NOT_IN_ANY_CYCLE_INDEX and to != NOT_IN_ANY_CYCLE_INDEX:
            heuristic_node_values[to] = heuristic_node_values.get(to, 0) - 1
        else:
            filtered.append(c)
    return filtered


# ---------------------------------------------------------------------------
# Heuristic topological sort
# ---------------------------------------------------------------------------


def solve_constraints_with_topological_sort(
    constraints: list[tuple[int, int]],
    heuristic_node_values: dict[int, int],
    nodes: list[int],
) -> tuple[list[int], float]:
    """≙ reference :658-731. Returns (total_order, confidence)."""
    edges: dict[tuple[int, int], int] = {}
    for c in constraints:
        if NOT_IN_ANY_CYCLE_INDEX in c:
            continue
        edges[c] = edges.get(c, 0) + 1

    possible_start_nodes = []
    for node in nodes:
        has_incoming = any(
            src != NOT_IN_ANY_CYCLE_INDEX and dst == node for src, dst in constraints
        )
        if not has_incoming:
            possible_start_nodes.append(node)

    node_affection_to_start = {node: 0 for node in nodes}
    for src, dst in constraints:
        if src != NOT_IN_ANY_CYCLE_INDEX and dst != NOT_IN_ANY_CYCLE_INDEX:
            continue
        if src == NOT_IN_ANY_CYCLE_INDEX:
            if dst in node_affection_to_start:
                node_affection_to_start[dst] += 1
        else:
            if src in node_affection_to_start:
                node_affection_to_start[src] -= 1

    total_order: list[int] = []
    confidence = 0.0

    # iterative version of apply_topological_sort (ref :575-656)
    while possible_start_nodes:
        best_i = 0
        best_value = float("-inf")
        total_abs = 0.0
        for i, node in enumerate(possible_start_nodes):
            value = float(node_affection_to_start.get(node, 0)) + float(
                heuristic_node_values.get(node, 0)
            )
            if value >= best_value:
                best_value = value
                best_i = i
            total_abs += abs(value)
        if total_abs > 0:
            confidence += abs(best_value) / total_abs
        start_node = possible_start_nodes.pop(best_i)
        total_order.append(start_node)

        candidates = []
        for edge in list(edges):
            frm, to = edge
            if frm == start_node:
                candidates.append(to)
                heuristic_node_values[to] = heuristic_node_values.get(to, 0) + edges[edge]
                del edges[edge]
        for cand in candidates:
            if not any(to == cand for (_frm, to) in edges):
                possible_start_nodes.append(cand)

    if total_order:
        confidence /= len(total_order)
    return total_order, confidence


def order_cycles(
    reads: list[list[int]],
    cycles: list[list[int]],
    verbose: bool = True,
) -> tuple[list[int], float, float]:
    """≙ reference :733-766. Returns (order, conf_cycle_res, conf_toposort)."""
    node_to_cycle_map = get_node_to_unique_cycle_map(cycles)
    all_cycle_indices = get_all_cycle_indices(node_to_cycle_map)
    constraints = generate_constraints(reads, node_to_cycle_map)
    if verbose:
        print(f"      ▸ {len(constraints)} constraints derived")

    heuristic_node_values = {node: 0 for node in all_cycle_indices}
    before = len(constraints)
    constraints = resolve_cycles_greedy(constraints, heuristic_node_values)
    conf_cycle_res = len(constraints) / before if before else 1.0
    if verbose:
        print(
            f"      ▸ {len(constraints)} constraints remain after resolving "
            f"cycles (confidence = {conf_cycle_res * 100:.2f}%)"
        )

    order, conf_topo = solve_constraints_with_topological_sort(
        constraints, heuristic_node_values, all_cycle_indices
    )
    return order, conf_cycle_res, conf_topo


def get_ordered_cycles(
    cycle_order: list[int], cycles: list[list[int]]
) -> list[list[int]]:
    """≙ reference :768-781."""
    return [cycles[i] for i in cycle_order if i < len(cycles)]
