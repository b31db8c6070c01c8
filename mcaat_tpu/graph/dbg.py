"""De Bruijn graph as a structure-of-arrays over a sorted k-mer table.

Device-side replacement for megahit's BOSS-style succinct dBG (consumed API
catalogued in SURVEY.md §2.2-N2; reference call sites in
``src/cycle_finder.cpp``, ``src/reads.cpp``, ``src/spacer_ordering.cpp``).
Instead of rank/select over a wavelet-tree-like structure queried one node
at a time, we precompute direct adjacency:

* ``kmers``  int64 ``[N]``  — sorted packed 23-mers; node id == rank.
  Deterministic: independent of thread scheduling, unlike the reference.
* ``mult``   int32 ``[N]``  — occurrence count of the k-mer in the input
  (+ reverse-complement strand when enabled, matching megahit's
  both-strand graph; see ``src/main_run_and_debug.cpp:54-56``).
* ``out``    int32 ``[4N]`` flat — out-neighbor id of node ``v`` per
  appended base ``b`` at slot ``4v+b``, -1 if the (k+1)-mer v·b was never
  observed. An edge exists iff its (k+1)-mer occurs in the reads — same
  semantics as megahit's edge set. Stored FLAT, not ``[N,4]``: the
  previous accelerator's tiled layouts padded a minor dim of 4 to the
  lane width, and flat [4N] stays dense on any backend. Host-side views
  reshape to ``[N,4]`` (numpy, unpadded).
* ``in_``    int32 ``[4N]`` flat — in-neighbor id per prepended base.
* ``valid``  bool ``[N]``   — the IsValidEdge/SetInvalidEdge mask.

Every query is batched (`lookup(kmers) -> ids`, `outgoing(ids) -> [Q,4]`),
replacing the scalar SDBG API (`IndexBinarySearch`, `OutgoingEdges`, ...)
with gathers that XLA vectorizes across the batch.

Degree semantics: ``EdgeOutdegree``/``EdgeIndegree`` count *valid*
neighbors only, which is what makes the reference's backward tip clipping
(``CycleFinder::RecursiveReduction``, src/cycle_finder.cpp:359-371)
actually propagate up dead chains.
"""

from __future__ import annotations

import functools
import os
from dataclasses import dataclass, replace
from typing import Optional

import jax
import jax.numpy as jnp
import numpy as np

from mcaat_tpu.io.fastq import decode_kmer
from mcaat_tpu.kmer.count import SENTINEL, count_unique, extract_kmers


@jax.tree_util.register_pytree_node_class
@dataclass
class DBG:
    k: int
    kmers: jax.Array  # int64 [N] sorted
    mult: jax.Array  # int32 [N]
    out: jax.Array  # int32 [4N] flat (slot 4v+b)
    in_: jax.Array  # int32 [4N] flat
    valid: jax.Array  # bool [N]

    # -- pytree plumbing ------------------------------------------------------
    def tree_flatten(self):
        return (self.kmers, self.mult, self.out, self.in_, self.valid), (self.k,)

    @classmethod
    def tree_unflatten(cls, aux, children):
        return cls(aux[0], *children)

    # -- basic properties -----------------------------------------------------
    @property
    def size(self) -> int:
        """Number of nodes (== SDBG::size())."""
        return int(self.kmers.shape[0])

    # -- batched query API ----------------------------------------------------
    def lookup(self, query_kmers: jax.Array) -> jax.Array:
        """Packed k-mers -> node ids, -1 for missing (≙ IndexBinarySearch)."""
        return _lookup(self.kmers, query_kmers)

    def outgoing(self, ids: jax.Array) -> jax.Array:
        """[Q] -> [Q,4] out-neighbor ids (valid-filtered; -1 elsewhere)."""
        return _neighbors(self.out, self.valid, ids)

    def incoming(self, ids: jax.Array) -> jax.Array:
        return _neighbors(self.in_, self.valid, ids)

    def out_degree(self) -> jax.Array:
        """Valid out-degree of every node, int32 [N]."""
        return _degree(self.out, self.valid)

    def in_degree(self) -> jax.Array:
        return _degree(self.in_, self.valid)

    def set_invalid(self, mask: jax.Array) -> "DBG":
        """Functional SetInvalidEdge over a boolean mask."""
        return replace(self, valid=self.valid & ~mask)

    def with_valid(self, valid: jax.Array) -> "DBG":
        return replace(self, valid=valid)

    # -- host-side helpers ----------------------------------------------------
    def label(self, node_id: int) -> str:
        """k-mer label of a node (≙ fetch_node_label, src/tmp_utils.cpp:83)."""
        return decode_kmer(int(np.asarray(self.kmers[node_id])), self.k)

    def to_host(self) -> "HostDBG":
        # np.array (copy): jax buffers surface as read-only views, and the
        # host stages (e.g. PhageCurator revalidation) mutate `valid`
        return HostDBG(
            k=self.k,
            kmers=np.array(self.kmers),
            mult=np.array(self.mult),
            out=np.array(self.out).reshape(-1, 4),
            in_=np.array(self.in_).reshape(-1, 4),
            valid=np.array(self.valid),
        )


@dataclass
class HostDBG:
    """Numpy mirror of the graph for the host-side combinatorial stages."""

    k: int
    kmers: np.ndarray
    mult: np.ndarray
    out: np.ndarray
    in_: np.ndarray
    valid: np.ndarray

    @property
    def size(self) -> int:
        return int(self.kmers.shape[0])

    def label(self, node_id: int) -> str:
        return decode_kmer(int(self.kmers[node_id]), self.k)

    def outgoing_list(self, node: int) -> list[int]:
        """Valid out-neighbors of one node (deterministic ascending order)."""
        nbrs = self.out[node]
        res = [int(v) for v in nbrs if v >= 0 and self.valid[v]]
        res.sort()
        return res

    def incoming_list(self, node: int) -> list[int]:
        nbrs = self.in_[node]
        res = [int(v) for v in nbrs if v >= 0 and self.valid[v]]
        res.sort()
        return res

    def _band_filtered(self, node: int, nbrs: list[int]) -> list[int]:
        m = float(self.mult[node])
        return [
            v
            for v in nbrs
            if float(self.mult[v]) >= m / 2 and float(self.mult[v]) <= m * 1.2
        ]

    def band_outgoing_list(self, node: int) -> list[int]:
        """Valid out-neighbors within the multiplicity band [m/2, 1.2m].

        ≙ graph_generic_func::_GetOutgoings (reference
        src/graph_generic_func.cpp:7-19): neighbors whose multiplicity
        deviates from the node's by more than the band ("higher
        variability") are dropped. Empty when the node itself is invalid.
        """
        if not self.valid[node]:
            return []
        return self._band_filtered(node, self.outgoing_list(node))

    def band_incoming_list(self, node: int) -> list[int]:
        """≙ graph_generic_func::_GetIncomings (src/graph_generic_func.cpp:21-34)."""
        if not self.valid[node]:
            return []
        return self._band_filtered(node, self.incoming_list(node))


@jax.jit
def _lookup(table: jax.Array, query: jax.Array) -> jax.Array:
    # method="sort" (sort-merge) for bulk lookups: chosen over the default
    # binary search on the previous accelerator; unmeasured on this card
    from mcaat_tpu.kmer.count import SENTINEL

    method = "sort" if query.size >= 4096 else "scan"
    idx = jnp.searchsorted(table, query, method=method)
    idx_c = jnp.minimum(idx, table.shape[0] - 1)
    # query != SENTINEL guard: a bucket-padded table carries SENTINEL tail
    # entries which must never count as hits
    found = (idx < table.shape[0]) & (table[idx_c] == query) & (query != SENTINEL)
    return jnp.where(found, idx_c, -1).astype(jnp.int32)


@jax.jit
def _join_lookup2(table: jax.Array, q1: jax.Array, q2: jax.Array):
    """Ranks of two query arrays in a sorted unique table, one fused join.

    One (key, tag)-sort + rank cumsum + one sort-back replaces two
    independent ``searchsorted(method="sort")`` calls (each of which sorts
    table+query twice internally), for the adjacency build where both
    endpoint lookups share the node table. Misses (and
    SENTINEL queries / SENTINEL-padded table tails) return -1.
    """
    T = table.shape[0]
    n1 = q1.shape[0]
    keys = jnp.concatenate([table, q1, q2])
    n = keys.shape[0]
    # tag sorts table entries before equal-key queries, so rank==cumsum-1
    # lands exactly on the matching table entry. (A tagless single-key
    # sort + rank+1 fixup needs one extra random gather per query array;
    # it lost to the tag on the previous accelerator, unmeasured here.)
    tag = (jnp.arange(n, dtype=jnp.int32) >= T).astype(jnp.int32)
    orig = jnp.arange(n, dtype=jnp.int32)
    _sk, st, so = jax.lax.sort((keys, tag, orig), num_keys=2)
    rank = jnp.cumsum(1 - st) - 1  # index of last table entry at/below
    _o, rank_orig = jax.lax.sort((so, rank), num_keys=1)

    def res(q, r):
        rc = jnp.clip(r, 0, T - 1)
        hit = (r >= 0) & (table[rc] == q) & (q != SENTINEL)
        return jnp.where(hit, rc, -1).astype(jnp.int32)

    return res(q1, rank_orig[T : T + n1]), res(q2, rank_orig[T + n1 :])


@jax.jit
def _join_lookup1(table: jax.Array, q: jax.Array) -> jax.Array:
    """Rank of one query array in a sorted unique table (sort-join).

    Single-query variant of :func:`_join_lookup2`, used when the source
    endpoint ids already come from the counting stage
    (``derive_nodes_from_edges``) and only the destination endpoint needs
    the join. Misses / SENTINEL return -1.
    """
    T = table.shape[0]
    keys = jnp.concatenate([table, q])
    n = keys.shape[0]
    tag = (jnp.arange(n, dtype=jnp.int32) >= T).astype(jnp.int32)
    orig = jnp.arange(n, dtype=jnp.int32)
    _sk, st, so = jax.lax.sort((keys, tag, orig), num_keys=2)
    rank = jnp.cumsum(1 - st) - 1
    _o, rank_orig = jax.lax.sort((so, rank), num_keys=1)
    r = rank_orig[T:]
    rc = jnp.clip(r, 0, T - 1)
    hit = (r >= 0) & (table[rc] == q) & (q != SENTINEL)
    return jnp.where(hit, rc, -1).astype(jnp.int32)


@jax.jit
def _join_lookup1_trusted(table: jax.Array, q: jax.Array) -> jax.Array:
    """Sort-join rank WITHOUT the hit-verification gather, for queries
    guaranteed present in the table (r5 adjacency attribution,
    VERDICT r4 #6).

    The adjacency's destination join qualifies: every live edge's
    SUFFIX is a k-window of the same read (the window one position
    right, or the read's last window — with RC, of the RC read), and
    ``derive_nodes_from_edges`` builds the node table as exactly the
    unique k-windows (edge prefixes ∪ last windows), so v ∈ table
    always. That removes the random ``table[rank]`` gather AND lets
    the tag bit pack into the sort key's low bit (46-bit
    k-mers << 63), dropping one int32 operand from the 268M-row sort.
    SENTINEL queries (padded edge rows) still return -1 — they sort
    into the SENTINEL-padded table tail, whose ranks are >= the live
    row count only when... they are NOT: a SENTINEL query's rank points
    at the last table row, so callers MUST mask dead rows themselves
    (``_edge_slots`` does, via ``live``). Regression:
    tests/test_graph.py asserts trusted == verified on real builds.
    """
    T = table.shape[0]
    # key2 = key << 1 | is_query: table rows sort before equal-key
    # queries, exactly like the (key, tag) 2-key sort. SENTINEL (int64
    # max) would overflow the shift, so SENTINEL rows (bucket-padded
    # table tails / dead queries) map to a 2^62 ceiling above every real
    # 47-bit key2 — they keep sorting LAST, leaving real ranks intact.
    big = jnp.int64(1) << jnp.int64(62)
    k2 = jnp.concatenate(
        [
            jnp.where(table == SENTINEL, big, table << jnp.int64(1)),
            jnp.where(
                q == SENTINEL, big | 1, (q << jnp.int64(1)) | jnp.int64(1)
            ),
        ]
    )
    n = k2.shape[0]
    orig = jnp.arange(n, dtype=jnp.int32)
    sk, so = jax.lax.sort((k2, orig), num_keys=1)
    rank = jnp.cumsum(1 - (sk & 1).astype(jnp.int32)) - 1
    _o, rank_orig = jax.lax.sort((so, rank), num_keys=1)
    r = rank_orig[T:]
    return jnp.where(q != SENTINEL, jnp.minimum(r, T - 1), -1).astype(
        jnp.int32
    )


@jax.jit
def _neighbors(adj: jax.Array, valid: jax.Array, ids: jax.Array) -> jax.Array:
    ids_c = jnp.maximum(ids, 0)
    slots = ids_c[..., None] * 4 + jnp.arange(4, dtype=jnp.int32)
    nbrs = adj[slots]  # [Q, 4]
    nbr_ok = (nbrs >= 0) & valid[jnp.maximum(nbrs, 0)]
    nbr_ok &= (ids >= 0)[..., None]
    return jnp.where(nbr_ok, nbrs, -1)


@jax.jit
def _band_neighbors(
    adj: jax.Array, valid: jax.Array, mult: jax.Array, ids: jax.Array
) -> jax.Array:
    """Batched multiplicity-band neighbor fetch: keep neighbors whose
    multiplicity lies in [m/2, 1.2*m] of the query node's (and both ends
    valid). Device-batched equivalent of graph_generic_func::_GetOutgoings
    / _GetIncomings (reference src/graph_generic_func.cpp:7-34) — pass
    ``out`` or ``in_`` as ``adj``. Returns [Q, 4] int32, -1 padded."""
    nbrs = _neighbors(adj, valid, ids)  # [Q,4], already validity-masked
    m = mult[jnp.maximum(ids, 0)].astype(jnp.float32)[..., None]
    nm = mult[jnp.maximum(nbrs, 0)].astype(jnp.float32)
    ok = (nbrs >= 0) & (nm >= m / 2) & (nm <= m * 1.2)
    ok &= ((ids >= 0) & valid[jnp.maximum(ids, 0)])[..., None]
    return jnp.where(ok, nbrs, -1)


@jax.jit
def _degree(adj: jax.Array, valid: jax.Array) -> jax.Array:
    """Valid-degree per node from a flat [4N] adjacency.

    Summed over strided flat slices, NOT ``reshape(-1, 4)``: on the
    previous accelerator XLA materialized the [N,4] reshape at a tiled
    layout that padded the minor dim of 4 many times over.
    """
    ok = (adj >= 0) & valid[jnp.maximum(adj, 0)]
    deg = ok[0::4].astype(jnp.int32)
    for b in range(1, 4):
        deg = deg + ok[b::4]
    return deg


def _edge_slots(kmers23, edges24, live, k, u_id=None):
    """Endpoint ids + flat adjacency slots for a (padded) unique edge set.

    When ``u_id`` (the source endpoint's node id per edge row, from
    ``derive_nodes_from_edges``) is provided, only the destination endpoint
    needs the sort-join — halving the join size.
    """
    N = kmers23.shape[0]
    mask_k = (jnp.int64(1) << jnp.int64(2 * k)) - 1

    u = edges24 >> jnp.int64(2)  # first 23 bases
    v = edges24 & mask_k  # last 23 bases
    last = (edges24 & jnp.int64(3)).astype(jnp.int32)
    first = (edges24 >> jnp.int64(2 * k)).astype(jnp.int32)

    if u_id is None:
        u_id, v_id = _join_lookup2(kmers23, u, v)
    else:
        # suffix-closure invariant ⇒ the verification gather is dead
        # weight (see _join_lookup1_trusted); MCAAT_VERIFY_ADJ=1 keeps
        # the checked join for debugging (checked at trace time)
        v_id = (
            _join_lookup1(kmers23, v)
            if os.environ.get("MCAAT_VERIFY_ADJ")
            else _join_lookup1_trusted(kmers23, v)
        )
    ok = live & (u_id >= 0) & (v_id >= 0)

    # Flat 1-D scatter slots with uniqueness/sortedness hints (chosen over
    # the general 2-D scatter on the previous accelerator). Each unique
    # 24-mer u·b maps to a unique flat slot u_id*4+b, and — since the edge
    # integer is
    # e == (u << 2) | b — sorted edges give SORTED out-slots.
    dump = jnp.int32(4 * N)
    out_slot = jnp.where(ok, u_id * 4 + last, dump)
    in_slot = jnp.where(ok, v_id * 4 + first, dump)
    return ok, out_slot, in_slot, u_id, v_id


@functools.partial(jax.jit, static_argnames=("k",))
def _build_adjacency(
    kmers23: jax.Array,
    edges24: jax.Array,
    n_edges: jax.Array,
    k: int = 23,
    u_id=None,
):
    """Scatter unique (k+1)-mers into out/in adjacency over the k-mer table."""
    N = kmers23.shape[0]
    live = jnp.arange(edges24.shape[0]) < n_edges
    ok, out_slot, in_slot, u_id, v_id = _edge_slots(
        kmers23, edges24, live, k, u_id=u_id
    )
    out = (
        jnp.full((4 * N + 1,), -1, dtype=jnp.int32)
        .at[out_slot]
        .set(jnp.where(ok, v_id, -1), unique_indices=True, indices_are_sorted=True)
    )
    in_ = (
        jnp.full((4 * N + 1,), -1, dtype=jnp.int32)
        .at[in_slot]
        .set(jnp.where(ok, u_id, -1), unique_indices=True)
    )
    return out[: 4 * N], in_[: 4 * N]


@functools.partial(
    jax.jit, static_argnames=("k",), donate_argnums=(2, 3)
)
def _adjacency_scatter_chunk(
    kmers23, edge_chunk, out_flat, in_flat, n_live, k: int = 23, u_id=None
):
    live = jnp.arange(edge_chunk.shape[0]) < n_live
    ok, out_slot, in_slot, u_id, v_id = _edge_slots(
        kmers23, edge_chunk, live, k, u_id=u_id
    )
    out_flat = out_flat.at[out_slot].set(
        jnp.where(ok, v_id, -1), unique_indices=True, indices_are_sorted=True
    )
    in_flat = in_flat.at[in_slot].set(
        jnp.where(ok, u_id, -1), unique_indices=True
    )
    return out_flat, in_flat


def build_adjacency_chunked(
    kmers23: jax.Array,
    edges24,
    n_edges: int,
    k: int = 23,
    chunk_edges: int = 64_000_000,
    u_id=None,
):
    """Memory-bounded adjacency assembly: edge chunks join + scatter in turn.

    The single-shot ``_build_adjacency`` sorts table + the destination
    query array together (N + E rows); at large E that sort's buffers
    exceed device memory. Here each chunk joins (N + C rows) and scatters
    into donated accumulator arrays, so peak memory is the node table +
    one chunk + the [4N] adjacency — the same ceiling as chunked
    counting. Every chunk re-sorts the node table, so chunks should be as
    large as memory allows.
    Chunks of the sorted edge table keep the sorted-out-slot property.
    ``u_id`` (per-edge source node ids) chunks alongside the edges.
    """
    N = int(kmers23.shape[0])
    # chunks slice DEVICE-resident tables: staging the edge table through
    # host numpy and re-uploading each chunk costs host<->device traffic
    # per build for a ~e_keep*8B device-memory saving
    edges_j = jnp.asarray(edges24)
    u_id_j = None if u_id is None else jnp.asarray(u_id)
    out_flat = jnp.full((4 * N + 1,), -1, dtype=jnp.int32)
    in_flat = jnp.full((4 * N + 1,), -1, dtype=jnp.int32)
    for lo in range(0, max(n_edges, 1), chunk_edges):
        hi = min(lo + chunk_edges, n_edges)
        chunk = edges_j[lo:hi]
        if hi - lo < chunk_edges:
            chunk = jnp.concatenate(
                [chunk, jnp.full((chunk_edges - (hi - lo),), SENTINEL, jnp.int64)]
            )
        uc = None
        if u_id_j is not None:
            uc = u_id_j[lo:hi]
            if hi - lo < chunk_edges:
                uc = jnp.concatenate(
                    [uc, jnp.full((chunk_edges - (hi - lo),), -1, jnp.int32)]
                )
        out_flat, in_flat = _adjacency_scatter_chunk(
            kmers23,
            chunk,
            out_flat,
            in_flat,
            jnp.int32(hi - lo),
            k=k,
            u_id=uc,
        )
    return out_flat[: 4 * N], in_flat[: 4 * N]


@functools.partial(jax.jit, static_argnames=("n_keep", "k"))
def _adjacency_from_instances(
    inst_id: jax.Array,  # int32 [R, W] node id of each k-window instance
    codes: jax.Array,  # uint8 [R, L]
    lengths: jax.Array,  # int32 [R]
    n_keep: int,
    k: int = 23,
):
    """Adjacency by direct instance scatters — no edge dedup, no join.

    Consecutive k-window instances of a read ARE its (k+1)-mer edges, and
    both endpoints of every observed edge are *guaranteed present* in the
    node table (each is itself a counted window), so the unique-(k+1)-mer
    table and the endpoint join are unnecessary work: scatter
    ``out[4*id(p) + base(p+k)] = id(p+1)`` per instance. Duplicate edge
    instances write identical values, so scatter order is immaterial
    (deterministic result). Same edge semantics as megahit — an edge
    exists iff its (k+1)-mer occurs (src/sdbg_build.cpp:216 ``-m 1``).
    """
    R, W = inst_id.shape
    p_iota = jax.lax.broadcasted_iota(jnp.int32, (R, W - 1), 1)
    live = p_iota < (lengths[:, None] - k)  # window p+1 still in the read
    u_id = inst_id[:, :-1]
    v_id = inst_id[:, 1:]
    b_app = codes[:, k : k + W - 1].astype(jnp.int32)
    b_first = codes[:, : W - 1].astype(jnp.int32)
    dump = jnp.int32(4 * n_keep)
    out_slot = jnp.where(live, u_id * 4 + b_app, dump).reshape(-1)
    in_slot = jnp.where(live, v_id * 4 + b_first, dump).reshape(-1)
    out = (
        jnp.full((4 * n_keep + 1,), -1, jnp.int32)
        .at[out_slot]
        .set(jnp.where(live, v_id, -1).reshape(-1), mode="promise_in_bounds")
    )[: 4 * n_keep]
    in_ = (
        jnp.full((4 * n_keep + 1,), -1, jnp.int32)
        .at[in_slot]
        .set(jnp.where(live, u_id, -1).reshape(-1), mode="promise_in_bounds")
    )[: 4 * n_keep]
    return out, in_


def build_dbg(
    kmers23: np.ndarray | jax.Array,
    counts23: np.ndarray | jax.Array,
    edges24: np.ndarray | jax.Array,
    n_edges: Optional[int] = None,
    k: int = 23,
    u_id=None,
) -> DBG:
    """Assemble a DBG from a unique sorted 23-mer table and 24-mer edge set."""
    kmers23 = jnp.asarray(kmers23)
    counts23 = jnp.asarray(counts23, dtype=jnp.int32)
    if n_edges is None:
        n_edges = int(edges24.shape[0])
    # single-shot up to 134M edges with u_id (a one-sided join, N+E sort
    # rows) and 32M without (two-sided, N+2E rows), and only while the
    # node table stays within 134.2M rows: cut-offs fit to the previous
    # accelerator's device memory, unmeasured on this card. Past them
    # the chunked join re-sorts the node table per chunk.
    single_shot_max = 134_000_000 if u_id is not None else 32_000_000
    node_rows = int(kmers23.shape[0])
    if int(n_edges) > single_shot_max or node_rows > 134_217_728:
        out, in_ = build_adjacency_chunked(
            kmers23, edges24, int(n_edges), k=k, u_id=u_id
        )
    else:
        out, in_ = _build_adjacency(
            kmers23,
            jnp.asarray(edges24),
            jnp.asarray(n_edges),
            k=k,
            u_id=None if u_id is None else jnp.asarray(u_id),
        )
    valid = jnp.ones((kmers23.shape[0],), dtype=bool)
    return DBG(k=k, kmers=kmers23, mult=counts23, out=out, in_=in_, valid=valid)


# Above this row count the bucket ladder drops to 2 tiers/octave
# ({1, 1.5} x pow2 instead of {1, 1.25, 1.5, 1.75}): fewer, coarser
# tiers mean more cross-dataset reuse of compiled programs at the cost
# of up to 50% padding. Chosen for the previous accelerator's slow cold
# compiles; unmeasured on this card. Env-tunable so CPU tests can
# exercise the coarse ladder at small sizes.
_COARSE_BUCKET_MIN = int(
    os.environ.get("MCAAT_COARSE_BUCKET_MIN", str(64 * 1024 * 1024))
)


def _bucket_size(n: int) -> int:
    """Round up to a fraction-of-an-octave bucket: {1, 1.25, 1.5, 1.75} x
    a power of two (≤25% padding waste) below ``_COARSE_BUCKET_MIN``,
    {1, 1.5} x a power of two (≤50% waste, half the tiers → double the
    compiled-program reuse across datasets) above it."""
    if n <= 1024:
        return 1024
    p = 1 << (n - 1).bit_length() - 1  # largest power of two <= n-1... floor
    fracs = (
        (1.0, 1.5, 2.0)
        if n > _COARSE_BUCKET_MIN
        else (1.0, 1.25, 1.5, 1.75, 2.0)
    )
    for frac in fracs:
        cand = int(p * frac)
        if cand >= n:
            return cand
    return 2 * p


# Single-pass build engine. "join": fused (key,tag) sort-join over unique
# edges (default). "inst": scatter adjacency straight from the counting
# sort's per-instance ids — algorithmically less work (no 24-mer dedup, no
# join), but its adjacency scatters have non-unique random indices, which
# serialized on the previous accelerator. Kept as a tested reference
# formulation; unmeasured on this card.
BUILD_ENGINE = "join"


def build_dbg_from_reads(
    codes: np.ndarray,
    lengths: np.ndarray,
    k: int = 23,
    add_reverse_complement: bool = True,
    bucket_shapes: bool = True,
    chunk_windows: int = 384_000_000,
    engine: str | None = None,
    verbose: bool = False,
    endpoints_out: dict | None = None,
) -> DBG:
    """End-to-end graph build from a padded read-code matrix.

    Replaces ``SDBGBuild`` (reference ``src/sdbg_build.cpp``): k-mer
    extraction, counting and adjacency construction, all on device. With
    ``add_reverse_complement`` the reverse-complement strand of every read
    is counted too, mirroring megahit's both-strand edge set.

    ``bucket_shapes`` pads the read count and the node/edge tables to
    bucketed sizes so different datasets reuse compiled programs
    (compiles dominate small runs). Padded nodes carry SENTINEL k-mers,
    multiplicity 0 and ``valid=False``; every query path masks them out.

    With ``endpoints_out`` (a dict) the build stashes the device-resident
    FIRST/LAST packed k-windows of every input row under keys
    ``first_km``/``last_km`` (int64 [R_pad], SENTINEL where len < k) —
    the read mapper's keep predicate needs exactly these two windows per
    read (src/reads.cpp:74-76), and computing them while the code matrix
    is already on device spares the mapper its own re-upload of the full
    matrix.
    """
    from mcaat_tpu.utils.profiling import tick_printer

    _tick = tick_printer("build", verbose)

    codes_np = np.asarray(codes)
    lengths_np = np.asarray(lengths)
    R_input = int(codes_np.shape[0])  # caller rows, pre-bucket
    if bucket_shapes:
        R, L = codes_np.shape
        R_pad = _bucket_size(R)
        L_pad = (L + 31) // 32 * 32
        codes2 = np.zeros((R_pad, L_pad), dtype=np.uint8)
        codes2[:R, :L] = codes_np
        lengths2 = np.zeros((R_pad,), dtype=np.int32)
        lengths2[:R] = lengths_np
        codes_np, lengths_np = codes2, lengths2

    from mcaat_tpu.kmer.count import (
        extract_first_kmer,
        extract_last_kmer,
        revcomp_kmers,
        upload_codes,
    )

    # The RC strand never materializes as a code matrix: the RC read's
    # window multiset is the elementwise revcomp_kmers of the forward
    # windows (and its last k-window is the RC of the forward FIRST
    # k-window), so RC joins inside the counting programs as bit math
    # instead of a row-wise RC roll of take_along_axis gathers. The "inst"
    # engine still needs RC code rows.
    add_rc = add_reverse_complement
    if engine is None:
        engine = BUILD_ENGINE

    # window cap from the TRUE max read length: the bucketed column pad
    # (L=100 -> 128) would otherwise inflate every window-multiset sort
    # by the pad ratio (~35% dead SENTINEL windows)
    max_true = int(lengths_np.max()) if lengths_np.size else 0
    w24 = max((max_true - k + 7) // 8 * 8, 8)
    R_rows, L_cols = codes_np.shape
    n_windows = (
        R_rows * min(max(L_cols - k, 0), w24) * (2 if add_rc else 1)
    )
    use_parts = bool(chunk_windows) and n_windows > chunk_windows
    if use_parts and engine == "inst":
        # the inst engine has no memory-bounded counting path: running it
        # single-pass at scales the chunk budget exists for would run out
        # of device memory
        raise ValueError(
            f"engine='inst' has no chunked counting path: {n_windows} "
            f"windows exceeds the {chunk_windows}-window single-pass "
            "budget (use engine='join' or raise chunk_windows)"
        )
    use_parts = use_parts and engine != "inst"
    last = None

    if use_parts:
        # memory-bounded multi-pass counting. The 384M default budget was
        # fit to the previous accelerator's device memory with margin for
        # the downstream table/adjacency working set; unmeasured on this
        # card. Row parts upload SEPARATELY: the parted path avoids the
        # monolithic full-matrix host pack/copy and bounds per-part host
        # staging.
        from mcaat_tpu.kmer.count import count_edges_parts

        windows_per_row = max(min(L_cols - k, w24), 1) * (2 if add_rc else 1)
        chunk_rows = max(chunk_windows // windows_per_row, 1)
        # parts past the CALLER's row count are pure bucket padding
        # (zero-length rows, zero windows), yet would cost compiles and a
        # full count — stop at the last caller row (the row-count bucket
        # only exists for the single-pass path's shape reuse; parts
        # re-bucket themselves,
        # and endpoints_out stays row-aligned because callers slice
        # [:num_reads] <= R_input)
        rows_eff = min(R_rows, max(R_input, 1))
        n_chunks = (rows_eff + chunk_rows - 1) // chunk_rows
        parts = []
        for ci in range(n_chunks):
            c_np = codes_np[ci * chunk_rows : (ci + 1) * chunk_rows]
            l_np = lengths_np[ci * chunk_rows : (ci + 1) * chunk_rows]
            if ci == n_chunks - 1 and rows_eff < (ci + 1) * chunk_rows:
                c_np = c_np[: max(rows_eff - ci * chunk_rows, 1)]
                l_np = l_np[: c_np.shape[0]]
            if c_np.shape[0] < chunk_rows:
                # bucket the tail part instead of padding it to the full
                # budget: a mostly-padding tail would otherwise sort a
                # full-budget window multiset. The bucketed tail costs one
                # extra compiled shape (from the standard ladder).
                tail_rows = min(chunk_rows, _bucket_size(c_np.shape[0]))
                c2 = np.zeros((tail_rows, L_cols), dtype=np.uint8)
                c2[: c_np.shape[0]] = c_np
                l2 = np.zeros((tail_rows,), dtype=np.int32)
                l2[: l_np.shape[0]] = l_np
                c_np, l_np = c2, l2
            parts.append((upload_codes(c_np), jnp.asarray(l_np)))
        firsts = [extract_first_kmer(c, l, k) for c, l in parts]
        lasts_f = [extract_last_kmer(c, l, k) for c, l in parts]
        if endpoints_out is not None:
            # concatenated rows align with the caller's input rows (the
            # caller slices off any tail padding)
            endpoints_out["first_km"] = jnp.concatenate(firsts)
            endpoints_out["last_km"] = jnp.concatenate(lasts_f)
        _tick("upload (dispatch; transfers overlap the counts)")
        u24, c24, n24 = count_edges_parts(
            parts, k, w_cap=w24, add_rc=add_rc, verbose=verbose
        )
        _tick(f"edge count (chunked, {n24} unique)")
        last = jnp.concatenate(lasts_f)
        if add_rc:
            # the RC strand's last k-window == RC of the forward FIRST
            last = jnp.concatenate(
                [last] + [revcomp_kmers(f, k) for f in firsts]
            )
        if bucket_shapes:
            # the bucketed tail part makes this concat's length dataset-
            # dependent; SENTINEL-pad to a bucket so the last-window
            # count program is shared across datasets (SENTINEL windows
            # are already present from zero-length pad rows and are
            # ignored downstream)
            L_last = int(last.shape[0])
            L_bkt = _bucket_size(L_last)
            if L_bkt > L_last:
                last = jnp.concatenate(
                    [last, jnp.full((L_bkt - L_last,), SENTINEL, last.dtype)]
                )
        del parts, firsts, lasts_f
    else:
        codes_j = upload_codes(codes_np)  # 2-bit packed in transfer
        lengths_j = jnp.asarray(lengths_np)
        if endpoints_out is not None:
            # BEFORE any engine-specific row doubling: rows must align
            # with the caller's input rows
            endpoints_out["first_km"] = extract_first_kmer(codes_j, lengths_j, k)
            endpoints_out["last_km"] = extract_last_kmer(codes_j, lengths_j, k)
        if add_rc and engine == "inst":
            codes_rc, lengths_rc = _reverse_complement_batch(codes_j, lengths_j)
            codes_j = jnp.concatenate([codes_j, codes_rc], axis=0)
            lengths_j = jnp.concatenate([lengths_j, lengths_rc], axis=0)
            add_rc = False
        if verbose:
            jax.block_until_ready((codes_j, lengths_j))
        _tick("upload")

    if use_parts:
        pass  # counted above
    elif engine == "inst":
        from mcaat_tpu.kmer.count import count_unique_with_ids

        km = extract_kmers(codes_j, lengths_j, k)
        R, W = km.shape
        u23, c23, n23, inst_id = count_unique_with_ids(km.reshape(-1))
        n23_i = int(n23)
        n_keep = _bucket_size(n23_i) if bucket_shapes else n23_i
        n_keep = min(n_keep, int(u23.shape[0]))
        out, in_ = _adjacency_from_instances(
            inst_id.reshape(R, W), codes_j, lengths_j, n_keep, k=k
        )
        valid = jnp.arange(n_keep) < n23_i
        return DBG(
            k=k,
            kmers=u23[:n_keep],
            mult=c23[:n_keep],
            out=out,
            in_=in_,
            valid=valid,
        )
    else:
        from mcaat_tpu.kmer.count import count_unique

        km1 = extract_kmers(codes_j, lengths_j, k + 1, w_cap=w24).reshape(-1)
        if add_rc:
            km1 = jnp.concatenate([km1, revcomp_kmers(km1, k + 1)])
        u24, c24, n24 = count_unique(km1)
        _tick(f"edge count ({int(n24)} unique)")
    # node table + per-edge source ids DERIVED from the (bucket-sliced)
    # unique edge table — two window-count-sized sorts cheaper than
    # re-counting the k-window multiset, and it halves the adjacency join
    from mcaat_tpu.kmer.count import (
        _bucket_slice,
        count_unique,
        derive_nodes_from_edges,
        extract_first_kmer,
        extract_last_kmer,
    )

    n24_i = int(n24)
    e_keep = _bucket_size(n24_i) if bucket_shapes else max(n24_i, 1)
    e_keep = min(e_keep, int(u24.shape[0]))
    u24s, c24s = u24[:e_keep], c24[:e_keep]
    if last is None:
        last = extract_last_kmer(codes_j, lengths_j, k)
        if add_rc:
            # the RC strand's last k-window == RC of the forward FIRST
            last = jnp.concatenate(
                [last, revcomp_kmers(extract_first_kmer(codes_j, lengths_j, k), k)]
            )
    u_l, c_l, n_l = count_unique(last)
    if bucket_shapes:
        u_l, c_l, _ = _bucket_slice(u_l, c_l, int(n_l))
    _tick("last-window count")
    u23, c23, n23, u_id = derive_nodes_from_edges(
        u24s, c24s, jnp.int32(n24_i), u_l, c_l
    )
    n23_i = int(n23)
    _tick(f"derive nodes ({n23_i} nodes)")
    n_keep = _bucket_size(n23_i) if bucket_shapes else n23_i
    n_keep = min(n_keep, int(u23.shape[0]))
    graph = build_dbg(
        u23[:n_keep], c23[:n_keep], u24s, n_edges=n24_i, k=k, u_id=u_id
    )
    if verbose:
        jax.block_until_ready(graph)
    _tick("adjacency")
    # padded tail rows are non-nodes
    if n_keep > n23_i:
        live = jnp.arange(n_keep) < n23_i
        graph = graph.with_valid(graph.valid & live)
    return graph


@jax.jit
def _reverse_complement_batch(codes: jax.Array, lengths: jax.Array):
    """Reverse-complement padded 2-bit code rows (pad stays at the tail)."""
    R, L = codes.shape
    comp = (3 - codes.astype(jnp.int32)).astype(jnp.uint8)
    rev = comp[:, ::-1]
    # After reversal, each row's live bases sit at the tail; roll them to
    # the front by each row's pad amount.
    shift = L - lengths
    col = jax.lax.broadcasted_iota(jnp.int32, (R, L), 1)
    src = col + shift[:, None]
    src_c = jnp.minimum(src, L - 1)
    rolled = jnp.take_along_axis(rev, src_c, axis=1)
    live = col < lengths[:, None]
    return jnp.where(live, rolled, 0).astype(jnp.uint8), lengths
