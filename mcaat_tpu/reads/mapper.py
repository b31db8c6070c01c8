"""Read → node-chain mapping.

Replaces reference ``src/reads.cpp:33-130``. A read is kept iff its
*first or last* window's node is in the cycle-node set
(src/reads.cpp:74-76), so the mapper decides keep from ONE batched device
lookup of just the two endpoint k-mers per read, then extracts + looks up
full window chains only for the (rare) kept reads — instead of a scalar
``IndexBinarySearch`` per window of every read like the reference, or a
batched lookup of every window (~25x more volume at 3% keep rate). A kept
read is its full chain of node ids, including misses (-1), mirroring the
reference which stores whatever IndexBinarySearch returns.

Reads with ``len(seq) <= 2k`` are skipped (src/reads.cpp:64-66).
Mate-2 sequences are reverse-complemented before mapping
(src/reads.cpp:116-127).
"""

from __future__ import annotations

import functools
from typing import Optional

import jax
import jax.numpy as jnp
import numpy as np

from mcaat_tpu.graph.dbg import DBG
from mcaat_tpu.io.fastq import ReadBatch, encode_sequences, read_sequences, reverse_complement
from mcaat_tpu.kmer.count import extract_kmers


def map_reads_to_nodes(graph: DBG, batch: ReadBatch) -> tuple[np.ndarray, np.ndarray]:
    """All window node-ids per read: ``ids[R, W]`` int32 (-1 miss), lengths.

    ``n_windows[i] = lengths[i] - k + 1`` live windows per read.
    """
    if batch.num_reads == 0 or batch.max_len < graph.k:
        return (
            np.zeros((batch.num_reads, 0), dtype=np.int32),
            np.zeros((batch.num_reads,), dtype=np.int32),
        )
    kmers = extract_kmers(jnp.asarray(batch.codes), jnp.asarray(batch.lengths), graph.k)
    ids = graph.lookup(kmers.reshape(-1)).reshape(kmers.shape)
    n_windows = np.maximum(np.asarray(batch.lengths) - graph.k + 1, 0).astype(np.int32)
    return np.asarray(ids), n_windows


def chains_from_ids(
    ids: np.ndarray,
    n_windows: np.ndarray,
    lengths: np.ndarray,
    k: int,
    cycle_nodes: set[int],
):
    """Filter + materialize node chains (≙ get_read_from_sequence).

    The keep predicate (first-or-last window node in the cycle set,
    src/reads.cpp:74-76) is evaluated vectorized over all reads; only the
    (rare) kept reads materialize, flat (``Chains``)."""
    from mcaat_tpu.reads.chains import Chains

    R = ids.shape[0]
    if R == 0 or ids.shape[1] == 0:
        return Chains.empty()
    lengths = np.asarray(lengths)
    n_windows = np.asarray(n_windows)
    firsts = ids[:, 0]
    lasts = ids[np.arange(R), np.clip(n_windows - 1, 0, ids.shape[1] - 1)]
    cyc = np.fromiter(cycle_nodes, dtype=np.int64, count=len(cycle_nodes))
    cyc.sort()
    eligible = (lengths > 2 * k) & (n_windows > 0)
    keep = eligible & (np.isin(firsts, cyc) | np.isin(lasts, cyc))
    kept = np.nonzero(keep)[0]
    return Chains.from_dense(ids[kept], n_windows[kept])


def get_reads(
    graph: DBG,
    fastq_file_1: str,
    fastq_file_2: Optional[str],
    cycles: list[list[int]],
    verbose: bool = False,
    batches: Optional[dict] = None,
    endpoints: Optional[dict] = None,
    region_provider=None,
):
    """≙ reference ``get_reads`` (src/reads.cpp:91-130).

    Parses straight into the padded 2-bit code matrix (native C++ parser
    when built) — no Python string materialization; mate-2 rows are
    reverse-complemented as a vectorized code-matrix op
    (≙ reverse_pair_ends_sequence, src/reads.cpp:20-31). ``batches``
    (``{path: ReadBatch}``) reuses the build stage's parse — the
    reference re-reads the FASTQ here (kseqpp, src/reads.cpp:3-18), but
    the bytes are identical either way. ``endpoints``
    (``{path: (first_km, last_km)}`` device arrays in RAW orientation,
    stashed by the build) lets the keep decision run with no code
    re-upload; the mate-2 endpoints are the bit-math RC of the raw ones
    swapped: first(RC(r)) == revcomp(last(r)).

    ``region_provider`` (the production big-graph path, VERDICT r4 #5):
    a callable ``read_chain_len -> (table_kmers, table_ids) | None``.
    When given, it is called once with the first kept read's window
    count (== the region-growth hop count the ordering stage uses,
    src/spacer_ordering.cpp:78) and the kept chains join against that
    SMALL sorted table — the cycle REGION's node table — instead of the
    full node table (a ~150k-row join instead of 134M rows at the
    796M-window shape). Windows outside the table map to -1 (the same
    value as a graph miss). This is ordering-output-identical: chain
    entries are consumed ONLY via (a) membership tests against cycle /
    SCC-subgraph / region node sets, all subsets of the region
    (ordering.py get_relevant_reads/filter_subproblems,
    neighborhood.remap_chains), and (b) adjacent-equality AFTER the
    node→cycle-index mapping, where every out-of-map entry collapses to
    NOT_IN_ANY_CYCLE_INDEX regardless of its id
    (ordering.py:516-531, fast.py merged transitions) — so the identity
    of an out-of-region id is unobservable. The reference stores the
    global rank for such windows (src/reads.cpp:74-89); ``reads``
    content differs there, reports do not (golden + parity tests).
    """
    from mcaat_tpu.io.fastq import read_encoded_batch, reverse_complement_batch
    from mcaat_tpu.kmer.count import revcomp_kmers
    from mcaat_tpu.utils.profiling import tick_printer

    _tick = tick_printer("mapper", verbose)
    cycle_nodes: set[int] = set()
    for cycle in cycles:
        cycle_nodes.update(int(n) for n in cycle)

    def _batch(path: str):
        if batches is not None and path in batches:
            return batches[path]
        return read_encoded_batch(path)

    def _eps(path: str, mate2: bool):
        if not endpoints or path not in endpoints:
            return None
        first_km, last_km = endpoints[path]
        if mate2:
            return (
                revcomp_kmers(last_km, graph.k),
                revcomp_kmers(first_km, graph.k),
            )
        return first_km, last_km

    from mcaat_tpu.reads.chains import Chains

    cyc_km_j = _bucketed_cycle_kmer_table(graph, cycle_nodes)
    plan = []
    b1 = _batch(fastq_file_1)
    _tick(f"parse ({b1.num_reads} reads)")
    plan.append(
        (b1, _phase1_kept(graph, b1, cyc_km_j, _eps(fastq_file_1, False)))
    )
    _tick(f"keep decision ({len(plan[0][1])} kept)")
    if fastq_file_2:
        b2 = reverse_complement_batch(_batch(fastq_file_2))
        _tick("parse mate-2")
        plan.append(
            (b2, _phase1_kept(graph, b2, cyc_km_j, _eps(fastq_file_2, True)))
        )
        _tick(f"keep decision mate-2 ({len(plan[1][1])} kept)")

    table = None
    if region_provider is not None:
        # the region hop count is the FIRST kept read's window count —
        # exactly the len(reads[0]) the ordering stage would use
        for b, kept in plan:
            if len(kept):
                rcl = int(b.lengths[kept[0]]) - graph.k + 1
                table = region_provider(rcl)
                break
        _tick("region table")

    parts: list[Chains] = []
    for b, kept in plan:
        L_pad = max((b.max_len + 31) // 32 * 32, 32)
        parts.append(
            _chains_for_kept(
                graph, b.codes, b.lengths, kept, L_pad, 1 << 20,
                tick=_tick if verbose else None, table=table,
            )
        )
    _tick("map")
    return Chains.concat(parts)


def _phase1_kept(graph: DBG, batch: ReadBatch, cyc_km_j, endpoints) -> np.ndarray:
    """Phase 1 alone: kept-read indices of one batch (endpoint keep
    predicate; see ``_map_batch`` for the endpoint-stash fast path)."""
    from mcaat_tpu.graph.dbg import _bucket_size
    from mcaat_tpu.kmer.count import upload_codes

    R_total = batch.num_reads
    if R_total == 0:
        return np.zeros(0, dtype=np.int64)
    if int(np.asarray(batch.lengths).max(initial=0)) < graph.k:
        return np.zeros(0, dtype=np.int64)
    if endpoints is not None:
        from mcaat_tpu.kmer.count import SENTINEL

        first_km, last_km = endpoints
        R_dev = int(first_km.shape[0])
        R_pad = _bucket_size(max(R_dev, 1))
        if R_pad > R_dev:
            pad = jnp.full((R_pad - R_dev,), SENTINEL, first_km.dtype)
            first_km = jnp.concatenate([first_km, pad])
            last_km = jnp.concatenate([last_km, pad])
        lengths_full = np.zeros(R_pad, dtype=np.int32)
        lengths_full[:R_total] = batch.lengths
        keep_d = _keep_from_endpoints(
            cyc_km_j, first_km, last_km, jnp.asarray(lengths_full), graph.k
        )
        return np.nonzero(np.asarray(keep_d)[:R_total])[0]

    L_pad = max((batch.max_len + 31) // 32 * 32, 32)
    kept_parts = []
    chunk_reads = 1 << 20
    for lo in range(0, R_total, chunk_reads):
        c_np = batch.codes[lo : lo + chunk_reads]
        l_np = batch.lengths[lo : lo + chunk_reads]
        R = c_np.shape[0]
        R_pad = _bucket_size(R)
        codes = np.zeros((R_pad, L_pad), dtype=np.uint8)
        codes[:R, : c_np.shape[1]] = c_np
        lengths = np.zeros((R_pad,), dtype=np.int32)
        lengths[:R] = l_np
        if int(l_np.max(initial=0)) < graph.k:
            continue
        keep_d = _endpoint_keep_mask(
            cyc_km_j, upload_codes(codes), jnp.asarray(lengths), graph.k
        )
        kept_parts.append(lo + np.nonzero(np.asarray(keep_d[:R]))[0])
    if not kept_parts:
        return np.zeros(0, dtype=np.int64)
    return np.concatenate(kept_parts)


def _isin_sorted(x, table_sorted):
    """Membership of non-negative ids in a sorted id table (sort-merge
    searchsorted at bulk sizes, chosen over the binary-search lowering on
    the previous accelerator)."""
    x64 = x.astype(jnp.int64)
    method = "sort" if x.size >= 4096 else "scan"
    pos = jnp.searchsorted(table_sorted, x64, method=method)
    pos_c = jnp.minimum(pos, table_sorted.shape[0] - 1)
    return (x >= 0) & (table_sorted[pos_c] == x64)


@functools.partial(jax.jit, static_argnames=("k",))
def _endpoint_keep_mask(cyc_kmers, codes, lengths, k: int):
    """Keep predicate from the two endpoint windows only.

    The reference keeps a read iff its FIRST or LAST k-mer's node is in
    the cycle set (src/reads.cpp:74-76) — so only those two windows need
    extraction to decide keep. Full window chains are then materialized
    for the (rare) kept reads alone: at 105M windows / 675k reads only
    ~3% survive, so this cuts the mapping stage's extract+lookup volume
    ~25x versus scoring every window. The membership test joins the
    endpoint k-mers against the CYCLE NODES' OWN k-mer table (node id =
    k-mer rank, so sorted cycle ids gather to a sorted k-mer table) —
    equivalent to lookup-then-id-membership, but the sort-join is
    2R + |cycles| rows instead of 2R + N.
    """
    from mcaat_tpu.kmer.count import extract_first_kmer, extract_last_kmer

    first_km = extract_first_kmer(codes, lengths, k)
    last_km = extract_last_kmer(codes, lengths, k)
    eligible = lengths > 2 * k
    return eligible & (
        _isin_sorted(first_km, cyc_kmers) | _isin_sorted(last_km, cyc_kmers)
    )


def _map_sequences(
    graph: DBG,
    sequences: list[str],
    cycle_nodes: set[int],
    chunk_reads: int = 1 << 20,
) -> list[list[int]]:
    """String-list convenience wrapper around :func:`_map_batch`."""
    if not sequences:
        from mcaat_tpu.reads.chains import Chains

        return Chains.empty()
    return _map_batch(
        graph, encode_sequences(sequences), cycle_nodes, chunk_reads
    )


@functools.partial(jax.jit, static_argnames=("k",))
def _keep_from_endpoints(cyc_kmers, first_km, last_km, lengths, k: int):
    """Keep predicate from PRE-EXTRACTED endpoint k-mers (device-resident
    from the build — see ``build_dbg_from_reads(endpoints_out=...)``): no
    code-matrix re-upload at all. Joins against the cycle nodes' k-mer
    table (see :func:`_endpoint_keep_mask` for why that equals the
    full-table lookup at a fraction of the sort volume). SENTINEL
    endpoints (len < k rows, stash padding) only occur on ineligible
    rows; the table pad (int64 max - 1) matches nothing either way."""
    eligible = lengths > 2 * k
    return eligible & (
        _isin_sorted(first_km, cyc_kmers) | _isin_sorted(last_km, cyc_kmers)
    )


def _chains_for_kept(
    graph: DBG,
    codes_src: np.ndarray,
    lengths_src: np.ndarray,
    kept_idx: np.ndarray,
    L_pad: int,
    chunk_reads: int,
    tick=None,
    table=None,
):
    """Phase 2: full window chains for the (rare) kept reads only; the
    kept count is bucketed so the extract+lookup hit a handful of
    compiled shapes instead of one per kept count. Chains materialize
    FLAT (``Chains.from_dense`` — one vectorized compress of the dense
    id matrix instead of one ``.tolist()`` per read, VERDICT r4 #4).
    With ``table`` (a sorted ``(kmers, ids)`` pair, e.g. the cycle
    region's node table) the window lookup joins against it instead of
    the full node table — see ``get_reads(region_provider=...)``."""
    from mcaat_tpu.graph.dbg import _bucket_size
    from mcaat_tpu.kmer.count import upload_codes
    from mcaat_tpu.reads.chains import Chains

    parts: list[Chains] = []
    for lo in range(0, len(kept_idx), chunk_reads):
        sel = kept_idx[lo : lo + chunk_reads]
        n_kept = len(sel)
        g_pad = _bucket_size(n_kept)
        codes_k = np.zeros((g_pad, L_pad), dtype=np.uint8)
        codes_k[:n_kept, : codes_src.shape[1]] = codes_src[sel]
        lengths_k = np.zeros((g_pad,), dtype=np.int32)
        lengths_k[:n_kept] = lengths_src[sel]
        kmers = extract_kmers(
            upload_codes(codes_k), jnp.asarray(lengths_k), graph.k
        )
        # int32 on device before the download: node ids fit, and the
        # [kept, W] id matrix is the mapper's largest device->host
        # transfer (89MB as int64 at the 600M-window shapes)
        if table is not None:
            ids_dev = _table_lookup_ids(
                table[0], table[1], kmers.reshape(-1)
            )
        else:
            ids_dev = graph.lookup(kmers.reshape(-1))
        ids_kept = np.asarray(
            ids_dev.reshape(kmers.shape)[:n_kept].astype(jnp.int32)
        )
        if tick is not None:
            tick(f"chain lookup+download ({n_kept} kept)")
        n_win_host = np.maximum(lengths_k[:n_kept] - graph.k + 1, 0)
        parts.append(Chains.from_dense(ids_kept, n_win_host))
        if tick is not None:
            tick("chain materialize")
    return Chains.concat(parts)


@jax.jit
def _table_lookup_ids(table_kms, table_ids, queries):
    """Window k-mers → ids through a SMALL sorted (kmers, ids) side
    table; -1 for misses. Same contract as ``graph.lookup`` except ids
    come from ``table_ids`` (e.g. global ids of the region rows)."""
    from mcaat_tpu.graph.dbg import _lookup

    pos = _lookup(table_kms, queries)
    return jnp.where(
        pos >= 0, table_ids[jnp.maximum(pos, 0)].astype(jnp.int32), -1
    )


def _bucketed_cycle_kmer_table(graph: DBG, cycle_nodes: set[int]) -> jax.Array:
    """Sorted cycle-node K-MER table for the keep joins: node id == k-mer
    rank, so gathering graph.kmers at the ascending cycle ids yields a
    sorted table. Bucket-padded with int64 max - 1 — above every real
    (46-bit) k-mer, below/distinct from SENTINEL (int64 max), so padded
    rows match neither real endpoints nor SENTINEL endpoints."""
    from mcaat_tpu.graph.dbg import _bucket_size

    cyc = np.fromiter(cycle_nodes, dtype=np.int64, count=len(cycle_nodes))
    cyc.sort()
    c_pad = _bucket_size(max(len(cyc), 1))
    ids_b = np.zeros(c_pad, dtype=np.int64)
    ids_b[: len(cyc)] = cyc
    kms = graph.kmers[jnp.asarray(ids_b)]
    pad_val = jnp.int64(np.iinfo(np.int64).max - 1)
    live = jnp.arange(c_pad) < len(cyc)
    return jnp.where(live, kms, pad_val)


def _map_batch(
    graph: DBG,
    full_batch: ReadBatch,
    cycle_nodes: set[int],
    chunk_reads: int = 1 << 20,
    endpoints: tuple | None = None,
    verbose: bool = False,
):
    """Batched window lookup for one batch (memory-bounded at scale):
    ``_phase1_kept`` keep decision + ``_chains_for_kept`` full chains.
    Kept as the direct-API / _map_sequences entry; ``get_reads`` drives
    the same two phases itself (it needs the kept sets of ALL batches
    before building the region table)."""
    from mcaat_tpu.reads.chains import Chains

    if full_batch.num_reads == 0:
        return Chains.empty()
    if int(np.asarray(full_batch.lengths).max(initial=0)) < graph.k:
        return Chains.empty()
    cyc_km_j = _bucketed_cycle_kmer_table(graph, cycle_nodes)
    kept_idx = _phase1_kept(graph, full_batch, cyc_km_j, endpoints)
    L_pad = max((full_batch.max_len + 31) // 32 * 32, 32)
    return _chains_for_kept(
        graph, full_batch.codes, full_batch.lengths, kept_idx, L_pad,
        chunk_reads,
    )
