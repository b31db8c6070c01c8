"""Whole-graph vectorized pruning passes.

Replaces the reference's scalar pruning in
``CycleFinder::FindApproximateCRISPRArrays`` (src/cycle_finder.cpp:433-452):

* ``InvalidateMultiplicityOneNodes`` (src/cycle_finder.cpp:372-382):
  one masked update ``valid &= mult > 1``.
* ``CollectTips`` + per-tip ``RecursiveReduction``
  (src/cycle_finder.cpp:346-371): backward clipping of dead-end chains.
  The surviving set is exactly the nodes that can still reach a cycle
  (every other node's forward paths all die at a tip). Computed here in
  O(log N) device passes by **pointer doubling over unary chains**:

    1. every degree-1 node points at its unique valid successor; branch
       (deg ≥ 2) and dead (deg 0 / invalid) nodes point at themselves;
    2. ``ptr <- ptr[ptr]`` for ceil(log2 N) passes collapses every unary
       chain onto its terminal (a branch node, a dead tip, or — if the
       pointer never leaves unary nodes — a pure unary cycle);
    3. branch nodes' aliveness is a fixpoint over the tiny condensed
       graph (≤ 4 edges per branch node), solved on host;
    4. one vectorized pass assigns validity from terminal classes.

  A naive per-level "remove current tips" fixpoint needs one full-array
  pass per chain NODE — a long linear background chain puts that many
  iterations into one device program (which the previous accelerator's
  execution watchdog killed). Doubling needs ~log2(N) ≈ 25 passes
  regardless of chain length. (The reference walks parent chains from the initial
  tips; this fixpoint additionally clips dead-ends exposed by the
  multiplicity filter. Nodes differing between the two can never lie on
  a cycle — they have no valid outgoing path — so cycle enumeration and
  everything downstream is unaffected.)
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np

from mcaat_tpu.graph.dbg import DBG, _degree


def invalidate_low_multiplicity(graph: DBG) -> tuple[DBG, int]:
    """valid &= mult > 1; returns (graph, number invalidated)."""
    kill = graph.valid & (graph.mult <= 1)
    n = int(jnp.sum(kill))
    return graph.set_invalid(kill), n


@jax.jit
def _clip_tips_fixpoint(out: jax.Array, valid: jax.Array) -> jax.Array:
    """Per-level reference fixpoint — O(longest dead chain) iterations.

    Kept as the semantic model for parity tests ONLY: a long linear chain
    (common — any non-repetitive genome region is one) makes this loop
    for hundreds of thousands of full-array passes inside one device
    program. Production path is
    :func:`_chain_collapse` + :func:`clip_tips`.
    """

    def cond(state):
        valid, changed = state
        return changed

    def body(state):
        valid, _ = state
        outdeg = _degree(out, valid)
        tips = valid & (outdeg == 0)
        return valid & ~tips, jnp.any(tips)

    valid, _ = jax.lax.while_loop(cond, body, (valid, jnp.array(True)))
    return valid


# terminal classes
_DEAD = 0  # deg 0 or invalid
_UNARY = 1  # deg 1
_BRANCH = 2  # deg >= 2


@functools.partial(jax.jit, static_argnames=("n_passes",))
def _chain_collapse(out: jax.Array, valid: jax.Array, n_passes: int):
    """Pointer-double unary chains onto their terminals.

    Returns ``(ntype [N], ptr [N])``: ntype in {_DEAD,_UNARY,_BRANCH};
    ``ptr`` is each unary node's chain terminal (self for non-unary).
    If a unary node's terminal is still unary after ceil(log2 N) passes
    it sits on a pure unary cycle (alive).
    """
    N = valid.shape[0]
    deg = _degree(out, valid)
    ntype = jnp.where(
        ~valid | (deg == 0), _DEAD, jnp.where(deg == 1, _UNARY, _BRANCH)
    ).astype(jnp.int32)
    adj_ok = (out >= 0) & valid[jnp.maximum(out, 0)]
    # strided flat slices, not reshape(-1, 4): no [N,4] intermediate
    succ = jnp.where(adj_ok[0::4], out[0::4], -1)
    for b in range(1, 4):
        succ = jnp.maximum(succ, jnp.where(adj_ok[b::4], out[b::4], -1))
    # (the unique valid successor when deg == 1)
    ids = jnp.arange(N, dtype=jnp.int32)
    ptr = jnp.where(ntype == _UNARY, succ, ids)

    def body(_, p):
        return p[p]

    ptr = jax.lax.fori_loop(0, n_passes, body, ptr)
    return ntype, ptr


@jax.jit
def _condensed_slots(out: jax.Array, valid: jax.Array, ntype, ptr):
    """Per out-slot condensed class: -1 dead, -2 alive (unary cycle),
    else the branch-node id the slot's chain terminates at."""
    u = out
    ok = (u >= 0) & valid[jnp.maximum(u, 0)]
    u_c = jnp.maximum(u, 0)
    tu = ptr[u_c]
    tclass = ntype[tu]
    res = jnp.where(
        ~ok | (tclass == _DEAD),
        -1,
        jnp.where(tclass == _UNARY, -2, tu),
    )
    return res.astype(jnp.int32)


@jax.jit
def _final_valid(valid, ntype, ptr, alive):
    """Vectorized validity from terminal classes + branch fixpoint result."""
    tclass = ntype[ptr]
    unary_alive = jnp.where(
        tclass == _UNARY, True, jnp.where(tclass == _DEAD, False, alive[ptr])
    )
    return jnp.where(
        ntype == _UNARY,
        valid & unary_alive,
        jnp.where(ntype == _BRANCH, valid & alive, False),
    )


def clip_tips(graph: DBG) -> tuple[DBG, int]:
    """Tip clipping to fixpoint; returns (graph, number clipped).

    Device: chain collapse (log N gathers) + condensed-slot classes.
    Host: aliveness fixpoint over the (small) branch-node set.
    """
    N = graph.size
    before = int(jnp.sum(graph.valid))
    if N == 0:
        return graph, 0
    n_passes = max(int(np.ceil(np.log2(max(N, 2)))) + 1, 1)
    ntype, ptr = _chain_collapse(graph.out, graph.valid, n_passes)
    cond = _condensed_slots(graph.out, graph.valid, ntype, ptr)

    ntype_h = np.asarray(ntype)
    branch = np.nonzero(ntype_h == _BRANCH)[0].astype(np.int32)
    alive = np.zeros(N, dtype=bool)
    if len(branch) > 0:
        # condensed edges of branch nodes only ([B,4] host gather)
        cond_h = np.asarray(cond).reshape(-1, 4)[branch]
        # remap branch targets to compact branch indices
        of_node = np.full(N, -1, dtype=np.int64)
        of_node[branch] = np.arange(len(branch))
        tgt = np.where(cond_h >= 0, of_node[np.maximum(cond_h, 0)], -1)
        has_cycle_edge = (cond_h == -2).any(axis=1)
        a = np.ones(len(branch), dtype=bool)  # greatest fixpoint: start alive
        while True:
            # edge alive: direct unary-cycle edge, or live branch target
            t_alive = (tgt >= 0) & a[np.maximum(tgt, 0)]
            new_a = has_cycle_edge | t_alive.any(axis=1)
            if (new_a == a).all():
                break
            a = new_a
        alive[branch] = a

    new_valid = _final_valid(graph.valid, ntype, ptr, jnp.asarray(alive))
    graph = graph.with_valid(new_valid)
    return graph, before - int(jnp.sum(new_valid))


def prune_graph(graph: DBG, verbose: bool = True) -> DBG:
    """Full pruning pass in the reference's order (src/cycle_finder.cpp:433-452)."""
    import time

    t0 = time.perf_counter()
    tips0 = int(jnp.sum(graph.valid & (graph.out_degree() == 0)))
    if verbose:
        print(f"Graph size: {graph.size} nodes; gathered tips: {tips0}")
    graph, n_mult = invalidate_low_multiplicity(graph)
    if verbose:
        print(f"Pre-filter: invalidated {n_mult} node(s) with multiplicity <= 1.")
        print(f"    [prune] mult filter: {time.perf_counter() - t0:.2f}s", flush=True)
        t0 = time.perf_counter()
    graph, n_tips = clip_tips(graph)
    if verbose:
        remaining = int(jnp.sum(graph.valid))
        tips_after = int(jnp.sum(graph.valid & (graph.out_degree() == 0)))
        print(f"After pruning, tips: {tips_after}, valid edges: {remaining}")
        print(f"    [prune] clip tips: {time.perf_counter() - t0:.2f}s", flush=True)
    return graph
