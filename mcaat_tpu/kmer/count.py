"""Device-side k-mer extraction and counting.

Device-side replacement for megahit's CX1 k-mer sorting pipeline
(``Read2SdbgS1``/``Read2SdbgS2`` driven from the reference
``src/sdbg_build.cpp:122-190``): k-mers are packed into int64 lanes
(k=23 → 46 bits, k+1=24 → 48 bits), sorted with XLA's sort, and reduced to
a unique sorted table + multiplicities with a segment reduce. The solid
threshold is m=1 (keep everything), matching the reference's hardcoded
``"-m","1"`` (``src/sdbg_build.cpp:216``).

All shapes are static: reads come in as a padded ``[R, Lmax]`` code matrix,
invalid window positions are masked to a sentinel that sorts last.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np

SENTINEL = jnp.iinfo(jnp.int64).max


def pack_codes_host(codes: np.ndarray) -> np.ndarray:
    """Pack a [R, L] 2-bit code matrix to [R, ceil(L/4)] bytes (host).

    Packing 4 bases/byte cuts the host->device transfer volume 4x.
    Unpack on device with :func:`unpack_codes_device`. The native
    single-pass packer is used when built (the numpy formulation makes 6+
    full-size passes); numpy fallback otherwise.
    """
    from mcaat_tpu import native

    codes = np.asarray(codes, dtype=np.uint8)
    packed = native.pack_codes(codes)
    if packed is not None:
        return packed
    R, L = codes.shape
    Lp = (L + 3) // 4 * 4
    c = np.zeros((R, Lp), np.uint8)
    c[:, :L] = codes
    c = c.reshape(R, Lp // 4, 4)
    return c[:, :, 0] | (c[:, :, 1] << 2) | (c[:, :, 2] << 4) | (c[:, :, 3] << 6)


@jax.jit
def unpack_codes_device(packed: jax.Array) -> jax.Array:
    """[R, L/4] packed bytes -> [R, L] 2-bit codes (device)."""
    shifts = jnp.arange(0, 8, 2, dtype=jnp.uint8)
    u = (packed[:, :, None] >> shifts) & jnp.uint8(3)
    return u.reshape(packed.shape[0], -1)


def upload_codes(codes: np.ndarray) -> jax.Array:
    """Host code matrix -> device, 2-bit packed in transfer."""
    return unpack_codes_device(jnp.asarray(pack_codes_host(codes)))


@functools.partial(jax.jit, static_argnames=("k", "w_cap"))
def extract_kmers(
    codes: jax.Array, lengths: jax.Array, k: int, w_cap: int | None = None
) -> jax.Array:
    """All k-mer windows of each read, packed big-endian into int64.

    Returns ``[R, W]`` int64 with ``W = Lmax - k + 1`` (or ``w_cap`` when
    given); windows past a read's length are SENTINEL. ``w_cap`` matters
    when the column count is padded for shape bucketing: the dead pad
    columns would otherwise inflate every downstream sort (~35% at
    L=100 padded to 128) — pass the true max window count instead.
    """
    codes = codes.astype(jnp.int64)
    R, L = codes.shape
    W = L - k + 1
    if w_cap is not None:
        W = min(W, w_cap)

    def body(t, acc):
        return (acc << 2) | jax.lax.dynamic_slice(codes, (0, t), (R, W))

    kmers = jax.lax.fori_loop(0, k, body, jnp.zeros((R, W), jnp.int64))
    pos = jax.lax.broadcasted_iota(jnp.int32, (R, W), 1)
    valid = pos + k <= lengths[:, None]
    return jnp.where(valid, kmers, SENTINEL)


@functools.partial(jax.jit, static_argnames=("k",))
def revcomp_kmers(kmers: jax.Array, k: int) -> jax.Array:
    """Elementwise reverse-complement of packed k-mers (SENTINEL kept).

    Pure elementwise bit math: complement is XOR with 2k ones (2-bit
    code c -> 3-c), base-order reversal is a full 2-bit-group bit
    reversal of the 64-bit word followed by a logical right shift. This
    is what lets the both-strand build skip materializing
    reverse-complemented code matrices entirely — the RC read's window
    multiset IS the elementwise RC of the forward window multiset, so
    ~10 cheap ops per window replace a row-wise RC roll
    (take_along_axis over [R, L]).
    """
    u = kmers.astype(jnp.uint64)
    ones = (jnp.uint64(1) << jnp.uint64(2 * k)) - jnp.uint64(1)
    x = u ^ ones
    m1 = jnp.uint64(0x3333333333333333)
    x = ((x >> 2) & m1) | ((x & m1) << 2)
    m2 = jnp.uint64(0x0F0F0F0F0F0F0F0F)
    x = ((x >> 4) & m2) | ((x & m2) << 4)
    m3 = jnp.uint64(0x00FF00FF00FF00FF)
    x = ((x >> 8) & m3) | ((x & m3) << 8)
    m4 = jnp.uint64(0x0000FFFF0000FFFF)
    x = ((x >> 16) & m4) | ((x & m4) << 16)
    x = (x >> 32) | (x << 32)
    x = x >> jnp.uint64(64 - 2 * k)
    return jnp.where(kmers == SENTINEL, SENTINEL, x.astype(jnp.int64))


@jax.jit
def count_unique(kmers_flat: jax.Array):
    """Sort + segment-reduce: unique sorted values and their counts.

    Returns ``(unique_sorted, counts, n_unique)`` with static shapes
    (padded with SENTINEL / 0); ``n_unique`` is the number of live entries.

    Compaction is by sorting, not ``nonzero`` or a binary-search
    ``searchsorted``: chosen on the previous accelerator, where those
    lowered poorly; unmeasured on this card.
    """
    s = jnp.sort(kmers_flat)
    n = s.shape[0]
    is_head = jnp.concatenate([jnp.ones((1,), bool), s[1:] != s[:-1]])
    is_head &= s != SENTINEL
    n_live = jnp.sum((s != SENTINEL).astype(jnp.int32))  # sentinels sort last
    n_unique = jnp.sum(is_head.astype(jnp.int32))
    pos = jnp.arange(n, dtype=jnp.int32)
    # compaction BY SORTING: non-heads become SENTINEL / n and sort to the
    # tail, heads keep their relative (sorted) order. ONE key sort carrying pos as payload yields
    # both arrays (masked keys and masked positions induce the same order),
    # halving the compaction sort cost.
    unique, head_idx = jax.lax.sort(
        (jnp.where(is_head, s, SENTINEL), jnp.where(is_head, pos, n)),
        num_keys=1,
    )
    # count of unique i = (index of next head, or first sentinel) - head index
    next_head = jnp.concatenate([head_idx[1:], jnp.array([n], dtype=jnp.int32)])
    counts = jnp.where(
        pos < n_unique,
        jnp.minimum(next_head, n_live) - head_idx,
        0,
    ).astype(jnp.int32)
    return unique, counts, n_unique


@jax.jit
def count_unique_with_ids(kmers_flat: jax.Array):
    """Like :func:`count_unique`, plus each instance's id in the unique table.

    One payload-carrying sort gives both the unique sorted table and, for
    every input position, the rank of its value — the node id. This is
    what lets the adjacency build skip the (k+1)-mer dedup + join
    entirely: consecutive window instances ARE the edges (see
    ``graph.dbg._adjacency_from_instances``).

    Returns ``(unique_sorted, counts, n_unique, inst_id)``; ``inst_id`` is
    int32 [n] aligned with the input order (sentinel inputs get an
    arbitrary in-range id — callers mask them).
    """
    n = kmers_flat.shape[0]
    orig = jnp.arange(n, dtype=jnp.int32)
    s, so = jax.lax.sort((kmers_flat, orig), num_keys=1)
    is_head = jnp.concatenate([jnp.ones((1,), bool), s[1:] != s[:-1]])
    is_head &= s != SENTINEL
    n_live = jnp.sum((s != SENTINEL).astype(jnp.int32))
    n_unique = jnp.sum(is_head.astype(jnp.int32))
    pos = jnp.arange(n, dtype=jnp.int32)
    unique, head_idx = jax.lax.sort(
        (jnp.where(is_head, s, SENTINEL), jnp.where(is_head, pos, n)),
        num_keys=1,
    )
    next_head = jnp.concatenate([head_idx[1:], jnp.array([n], dtype=jnp.int32)])
    counts = jnp.where(
        pos < n_unique,
        jnp.minimum(next_head, n_live) - head_idx,
        0,
    ).astype(jnp.int32)
    rank = (jnp.cumsum(is_head.astype(jnp.int32)) - 1).astype(jnp.int32)
    inst_id = jnp.zeros((n,), jnp.int32).at[so].set(
        rank, unique_indices=True, mode="promise_in_bounds"
    )
    return unique, counts, n_unique, inst_id


@functools.partial(jax.jit, static_argnames=("k",))
def extract_first_kmer(codes: jax.Array, lengths: jax.Array, k: int) -> jax.Array:
    """The first k-window of each read, packed int64 [R]; SENTINEL if len < k."""
    codes = codes.astype(jnp.int64)
    R, L = codes.shape

    def body(t, acc):
        return (acc << 2) | codes[:, t]

    acc = jax.lax.fori_loop(0, min(k, L), body, jnp.zeros((R,), jnp.int64))
    return jnp.where(lengths >= k, acc, SENTINEL)


@functools.partial(jax.jit, static_argnames=("k",))
def extract_last_kmer(codes: jax.Array, lengths: jax.Array, k: int) -> jax.Array:
    """The last k-window of each read, packed int64 [R]; SENTINEL if len < k."""
    codes = codes.astype(jnp.int64)
    R, L = codes.shape
    start = jnp.maximum(lengths - k, 0).astype(jnp.int32)

    def body(t, acc):
        col = jnp.minimum(start + t, L - 1)
        c = jnp.take_along_axis(codes, col[:, None].astype(jnp.int32), axis=1)[:, 0]
        return (acc << 2) | c

    acc = jax.lax.fori_loop(0, k, body, jnp.zeros((R,), jnp.int64))
    return jnp.where(lengths >= k, acc, SENTINEL)


@jax.jit
def node_multiset_from_edges(km_k1_flat: jax.Array, last_k: jax.Array) -> jax.Array:
    """The k-mer window multiset, derived from (k+1)-mer windows.

    Identity: every k-window of a read except the last is the prefix of a
    (k+1)-window; the last k-window is appended separately. Saves a second
    full extraction pass + keeps counts exactly equal to extracting the
    k-windows directly (property-tested).
    """
    pref = jnp.where(km_k1_flat == SENTINEL, SENTINEL, km_k1_flat >> 2)
    return jnp.concatenate([pref, last_k])


def count_nodes_and_edges(codes: jax.Array, lengths: jax.Array, k: int):
    """One-extraction counting of k-mer nodes and (k+1)-mer edges.

    Returns ``(u_k, c_k, n_k, u_k1, n_k1)``. Replaces two independent
    extract+count passes; the k-mer multiset is derived from the
    (k+1)-mers (see node_multiset_from_edges).
    """
    km1 = extract_kmers(codes, lengths, k + 1).reshape(-1)
    last = extract_last_kmer(codes, lengths, k)
    km = node_multiset_from_edges(km1, last)
    u_k, c_k, n_k = count_unique(km)
    u_k1, _c, n_k1 = count_unique(km1)
    return u_k, c_k, n_k, u_k1, n_k1


def _compact_counted_sorted(keys, cnts, max_run: int):
    """Reduce (sorted keys with ≤ ``max_run`` duplicates each, aligned
    counts) to a unique table: ``(unique, counts, n_unique, is_head)``.

    Keys must be sorted ascending; SENTINEL rows are ignored (their counts
    are zeroed). Run sums come from ``max_run - 1`` shifted masked adds —
    elementwise only — instead of the generic full-width int64 count
    cumsum + two boundary gathers (chosen on the previous accelerator,
    where those gathers dominated the merge; unmeasured on this card).
    CORRECTNESS CONTRACT: a key occurring more than
    ``max_run`` times is silently under-counted — callers must bound run
    lengths structurally (see :func:`merge_counted`,
    :func:`derive_nodes_from_edges`). The returned ``overflow`` scalar
    counts positions whose run EXCEEDS ``max_run`` (nonzero ⇒ the
    contract was violated and counts are corrupt); host sync points that
    already materialize ``n_unique`` assert it is zero for ~free.
    """
    is_head = jnp.concatenate([jnp.ones((1,), bool), keys[1:] != keys[:-1]])
    is_head &= keys != SENTINEL
    n_unique = jnp.sum(is_head.astype(jnp.int32))
    overflow = jnp.sum(
        (keys[max_run:] == keys[:-max_run]) & (keys[max_run:] != SENTINEL)
    ).astype(jnp.int32)
    cz = jnp.where(keys == SENTINEL, 0, cnts)
    run_sum = cz
    for j in range(1, max_run):
        same_j = jnp.concatenate(
            [keys[j:] == keys[:-j], jnp.zeros((j,), bool)]
        )
        shifted = jnp.concatenate([cz[j:], jnp.zeros((j,), cz.dtype)])
        run_sum = run_sum + jnp.where(same_j, shifted, 0)
    unique, counts = jax.lax.sort(
        (jnp.where(is_head, keys, SENTINEL), jnp.where(is_head, run_sum, 0)),
        num_keys=1,
    )
    return unique, counts, n_unique, is_head, overflow


@jax.jit
def merge_counted(unique_a, counts_a, unique_b, counts_b):
    """Merge two (sorted unique, counts) tables into one.

    Both inputs are UNIQUE tables, so after the merge sort each key
    appears at most twice — the bounded-run compaction is 2 sorts +
    elementwise only. Returns ``(unique, counts,
    n_unique, overflow)``; ``overflow`` is nonzero iff an input was NOT
    a unique table (counts are then corrupt — callers assert it at the
    host sync that materializes ``n_unique``).
    """
    keys = jnp.concatenate([unique_a, unique_b])
    cnts = jnp.concatenate([counts_a, counts_b])
    keys, cnts = jax.lax.sort((keys, cnts), num_keys=1)
    unique, counts, n_unique, _, overflow = _compact_counted_sorted(
        keys, cnts, max_run=2
    )
    return unique, counts, n_unique, overflow


@jax.jit
def derive_nodes_from_edges(u_k1, c_k1, n_k1, u_last, c_last):
    """Node (k-mer) table derived from the unique (k+1)-mer edge table.

    Every k-window instance of a read is either the prefix of one of its
    (k+1)-windows or the read's last k-window (the identity behind
    :func:`node_multiset_from_edges`), so

        c_k(x) = sum over (k+1)-mers e with prefix x of c_{k+1}(e)
                 + c_last(x).

    ``u_k1`` is sorted, so its prefixes ``e >> 2`` form sorted runs of
    length <= 4: the unique prefixes and run-sums come from one compaction
    sort instead of re-counting the full k-window multiset (which costs
    two window-count-sized sorts — this derivation's inputs are the far
    smaller unique tables). Merging with the (tiny) last-window table
    yields the final node table AND, as a by-product, the node id of every
    unique (k+1)-mer's prefix — the adjacency build's source endpoint,
    making its source-side sort-join unnecessary.

    Args: ``u_k1``/``c_k1`` int64/int32 [E] SENTINEL-padded sorted unique
    (k+1)-mers with counts, ``n_k1`` live rows (traced scalar), ``u_last``/
    ``c_last`` the counted last-k-window table (SENTINEL-padded).

    Returns ``(u_k, c_k, n_k, u_id)``: node table [E + Rl] (SENTINEL/0
    padded), live count, and int32 [E] prefix node ids (-1 on dead rows).
    """
    E = u_k1.shape[0]
    pos = jnp.arange(E, dtype=jnp.int32)
    live1 = (pos < n_k1) & (u_k1 != SENTINEL)
    p = jnp.where(live1, u_k1 >> 2, SENTINEL)
    cp = jnp.where(live1, c_k1, 0)

    # ONE merge sort does everything: the raw (duplicated, ≤4-run) prefix
    # rows and the last-window table sort together, and the compaction
    # aggregates counts across prefix-duplicate runs AND merges the two
    # tables in the same pass (a prior version pre-compacted the prefix
    # runs with their own sort first — a full extra E-row sort).
    keys_m = jnp.concatenate([p, u_last])
    cnts_m = jnp.concatenate([cp, jnp.where(u_last == SENTINEL, 0, c_last)])
    orig_m = jnp.concatenate(
        [pos, jnp.full((u_last.shape[0],), -1, jnp.int32)]
    )
    k_s, c_s, o_s = jax.lax.sort((keys_m, cnts_m, orig_m), num_keys=1)
    # run bound: ≤4 duplicate prefixes (sorted (k+1)-mers share a k-prefix
    # in groups of ≤4) + ≤1 row from the unique last-window table
    # the <=5 run bound is structural (u_k1 unique ⇒ ≤4 same-prefix rows,
    # u_last unique ⇒ ≤1 more), so the overflow scalar is discarded here
    u_k, c_k, n_k, is_head_m, _ovf = _compact_counted_sorted(
        k_s, c_s, max_run=5
    )
    # every row of a run (head or not) reads its run's final rank off the
    # head cumsum, so each prefix-side row directly carries its node id
    rank_m = (jnp.cumsum(is_head_m.astype(jnp.int32)) - 1).astype(jnp.int32)
    # Invert the merge permutation by SORTING (o_s carries each of 0..E-1
    # exactly once; last-side rows sort past E): the first E payloads are
    # the ranks in prefix-table order. Chosen over a dump-slot scatter on
    # the previous accelerator, where its non-unique writes serialized;
    # unmeasured on this card.
    n_m = k_s.shape[0]
    inv_key = jnp.where(o_s >= 0, o_s, n_m)
    _ik, rank_p_full = jax.lax.sort((inv_key, rank_m), num_keys=1)
    u_id = jnp.where(live1, rank_p_full[:E], -1).astype(jnp.int32)
    return u_k, c_k, n_k, u_id


def _bucket_slice(u: jax.Array, c: jax.Array, n: int):
    """Slice (u, c) down to the bucketed size >= n live rows.

    Bucketed (not exact) sizes mean successive chunk merges hit a handful
    of compiled shapes instead of one fresh compile per chunk.
    """
    from mcaat_tpu.graph.dbg import _bucket_size

    size = min(_bucket_size(max(n, 1)), int(u.shape[0]))
    u, c = u[:size], c[:size]
    if size < n:  # cannot happen (bucket >= n), defensive
        raise AssertionError((size, n))
    return u, c, size


# Cumulative ACTUAL bucketed part bytes the chunked counters keep
# device-resident. Parts spill to host (oldest first) only past this,
# instead of staging everything keyed on the window-count UPPER bound.
# Sized for the previous accelerator's device memory; unmeasured on
# this card.
DEVICE_PARTS_BUDGET = 4 << 30


def _part_nbytes(u) -> int:
    """(int64 key + int32 count) bytes of one bucketed part."""
    return int(u.shape[0]) * 12


def _merge_two(a, b):
    """Merge two (u, c, n, level) stack entries -> one at level+1."""
    ua, ca, _na, la = a
    ub, cb, _nb, lb = b
    mu, mc, mn, ovf = merge_counted(
        jnp.asarray(ua), jnp.asarray(ca), jnp.asarray(ub), jnp.asarray(cb)
    )
    mn_i = int(mn)
    assert int(ovf) == 0, "merge_counted fed a non-unique table"
    mu, mc, _ = _bucket_slice(mu, mc, mn_i)
    return [mu, mc, mn_i, max(la, lb) + 1]


def _merge_stack_push(stack, u, cnt, n_i):
    """Push one chunk table onto a binary-counter merge stack.

    Equal-level neighbors merge immediately (mergesort's binary counter),
    so at most ~log2(K) parts are ever alive — the same pairwise tree as
    a post-hoc tree merge (O(K·C·log K) sorted rows, chosen over a linear
    accumulate chain and a flat concat-all merge on the previous
    accelerator), but interleaved with
    the chunk counts so parts never pile up. Parts stay device-resident;
    when the live set's ACTUAL bytes exceed DEVICE_PARTS_BUDGET the
    oldest parts spill to host numpy (re-uploaded at their merge).
    """
    stack.append([u, cnt, n_i, 0])
    while len(stack) >= 2 and stack[-1][3] == stack[-2][3]:
        b = stack.pop()
        a = stack.pop()
        stack.append(_merge_two(a, b))
    live = sum(
        _part_nbytes(p[0]) for p in stack if not isinstance(p[0], np.ndarray)
    )
    for p in stack:  # spill oldest (merged-last) first
        if live <= DEVICE_PARTS_BUDGET:
            break
        if not isinstance(p[0], np.ndarray):
            live -= _part_nbytes(p[0])
            p[0], p[1] = np.asarray(p[0]), np.asarray(p[1])


def _merge_stack_drain(stack):
    """Merge the remaining stack entries (newest/smallest first) and
    return ``(unique, counts, n)``."""
    if not stack:
        return jnp.zeros((0,), jnp.int64), jnp.zeros((0,), jnp.int32), 0
    while len(stack) > 1:
        b = stack.pop()
        a = stack.pop()
        stack.append(_merge_two(a, b))
    u, c, n, _ = stack[0]
    return jnp.asarray(u), jnp.asarray(c), n


def count_unique_chunked(
    codes, lengths, k: int, chunk_rows: int
) -> tuple[jax.Array, jax.Array, int]:
    """Memory-bounded counting: count row chunks, then tree-merge.

    Peak device memory is bounded by one chunk's window count plus one
    pairwise merge — this is what lifts the single-pass memory ceiling.
    Returns (unique, counts, n_unique) like count_unique.
    """
    codes = np.asarray(codes)
    lengths = np.asarray(lengths)
    R = codes.shape[0]
    stack: list = []
    for lo in range(0, R, chunk_rows):
        c = jnp.asarray(codes[lo : lo + chunk_rows])
        l = jnp.asarray(lengths[lo : lo + chunk_rows])
        km = extract_kmers(c, l, k).reshape(-1)
        u, cnt, nu = count_unique(km)
        nu_i = int(nu)
        # bucket the kept slice: exact sizes would give every chunk merge
        # a fresh shape -> a fresh compile
        u, cnt, _ = _bucket_slice(u, cnt, nu_i)
        _merge_stack_push(stack, u, cnt, nu_i)
    u, c, n = _merge_stack_drain(stack)
    if n == 0 and not stack:
        return jnp.zeros((0,), jnp.int64), jnp.zeros((0,), jnp.int32), 0
    return u[:n], c[:n], n


@functools.partial(
    jax.jit, static_argnames=("k", "w_cap", "chunk_rows", "add_rc")
)
def _count_edge_chunk(codes, lengths, start, k: int, w_cap, chunk_rows: int,
                      add_rc: bool = False):
    """(k+1)-mer count of one row chunk, sliced ON DEVICE: a traced start
    offset means one compiled program serves every chunk, and the code
    matrix never round-trips through host numpy between chunks. With
    ``add_rc`` the reverse-complement strand joins the multiset as the elementwise RC of the forward windows
    (:func:`revcomp_kmers`) — no RC code matrix exists anywhere."""
    c = jax.lax.dynamic_slice_in_dim(codes, start, chunk_rows, axis=0)
    l = jax.lax.dynamic_slice_in_dim(lengths, start, chunk_rows, axis=0)
    km1 = extract_kmers(c, l, k + 1, w_cap=w_cap).reshape(-1)
    if add_rc:
        km1 = jnp.concatenate([km1, revcomp_kmers(km1, k + 1)])
    return count_unique(km1)


def count_edges_chunked(codes, lengths, k: int, chunk_rows: int,
                        w_cap: int | None = None, verbose: bool = False,
                        add_rc: bool = False):
    """Memory-bounded (k+1)-mer counting: per-chunk count + merge.

    Only the edge ((k+1)-mer) table is counted — the node table is derived
    from it afterwards (:func:`derive_nodes_from_edges`), which halves the
    per-chunk sort work versus counting both multisets. Returns
    ``(u_k1, c_k1, n_k1)`` with a bucketed (SENTINEL-padded) table.
    """
    import time

    R = int(codes.shape[0])
    # pad rows to a chunk multiple: dynamic_slice clamps at the array edge,
    # which would re-count tail rows otherwise; zero-length pad rows
    # produce only SENTINEL windows
    n_chunks = max((R + chunk_rows - 1) // chunk_rows, 1)
    R_pad = n_chunks * chunk_rows
    codes_j = jnp.asarray(codes)
    lengths_j = jnp.asarray(lengths)
    if R_pad > R:
        codes_j = jnp.concatenate(
            [codes_j, jnp.zeros((R_pad - R, codes_j.shape[1]), codes_j.dtype)]
        )
        lengths_j = jnp.concatenate(
            [lengths_j, jnp.zeros((R_pad - R,), lengths_j.dtype)]
        )
    stack: list = []
    t0 = time.perf_counter()
    t_merge = 0.0
    for ci in range(n_chunks):
        u, cnt, nu = _count_edge_chunk(
            codes_j, lengths_j, ci * chunk_rows, k, w_cap, chunk_rows,
            add_rc=add_rc,
        )
        nu_i = int(nu)
        # bucketed slices keep merge shapes stable across chunks (see
        # count_unique_chunked)
        u, cnt, _ = _bucket_slice(u, cnt, nu_i)
        tm = time.perf_counter()
        # merge completion is forced inside _merge_two by int(mn)
        _merge_stack_push(stack, u, cnt, nu_i)
        t_merge += time.perf_counter() - tm
    if verbose:
        t1 = time.perf_counter()
        spilled = sum(1 for p in stack if isinstance(p[0], np.ndarray))
        print(
            f"    [build]   {n_chunks} chunk counts: {t1 - t0 - t_merge:.2f}s"
            f" + interleaved merges: {t_merge:.2f}s"
            f" (stack={len(stack)}, host-spilled={spilled})",
            flush=True,
        )
        t0 = t1
    res = _merge_stack_drain(stack)
    if verbose:
        jax.block_until_ready(res)
        print(f"    [build]   final merge: {time.perf_counter() - t0:.2f}s", flush=True)
    return res


@functools.partial(jax.jit, static_argnames=("k", "w_cap", "add_rc"))
def _count_edge_part(codes, lengths, k: int, w_cap, add_rc: bool = False):
    """(k+1)-mer count of one PRE-UPLOADED row part (fixed shape across
    parts — the per-part twin of :func:`_count_edge_chunk`, for callers
    that upload row ranges separately)."""
    km1 = extract_kmers(codes, lengths, k + 1, w_cap=w_cap).reshape(-1)
    if add_rc:
        km1 = jnp.concatenate([km1, revcomp_kmers(km1, k + 1)])
    return count_unique(km1)


def count_edges_parts(parts, k: int, w_cap: int | None = None,
                      add_rc: bool = False, verbose: bool = False):
    """Memory-bounded (k+1)-mer counting over per-part device arrays.

    ``parts`` is ``[(codes_j, lengths_j)]``; all but the last share one
    shape (the tail part may be smaller — the caller buckets it so a
    mostly-padding tail does not sort a full-budget window multiset).
    Same merge-stack reduction as :func:`count_edges_chunked`; the
    difference is that the parts were uploaded separately, which removes
    the monolithic full-matrix host pack/copy and keeps per-part host
    memory bounded. Whether part uploads overlap the counts on this card
    is unmeasured. With ``verbose`` each part prints its own count vs
    merge split; a part's count tick includes any upload wait still
    pending when it starts.
    """
    import time

    stack: list = []
    t0 = time.perf_counter()
    t_merge = 0.0
    for pi, (codes_j, lengths_j) in enumerate(parts):
        tp = time.perf_counter()
        u, cnt, nu = _count_edge_part(codes_j, lengths_j, k, w_cap, add_rc)
        nu_i = int(nu)
        u, cnt, _ = _bucket_slice(u, cnt, nu_i)
        tm = time.perf_counter()
        _merge_stack_push(stack, u, cnt, nu_i)
        tm2 = time.perf_counter()
        t_merge += tm2 - tm
        if verbose:
            print(
                f"    [build]     part {pi + 1}/{len(parts)} "
                f"({int(codes_j.shape[0])} rows): count {tm - tp:.2f}s, "
                f"merge {tm2 - tm:.2f}s ({nu_i} unique)",
                flush=True,
            )
    if verbose:
        t1 = time.perf_counter()
        spilled = sum(1 for p in stack if isinstance(p[0], np.ndarray))
        print(
            f"    [build]   {len(parts)} part counts: {t1 - t0 - t_merge:.2f}s"
            f" + interleaved merges: {t_merge:.2f}s"
            f" (stack={len(stack)}, host-spilled={spilled})",
            flush=True,
        )
        t0 = t1
    res = _merge_stack_drain(stack)
    if verbose:
        jax.block_until_ready(res)
        print(f"    [build]   final merge: {time.perf_counter() - t0:.2f}s", flush=True)
    return res


def host_endpoint_kmers(
    codes: np.ndarray, lengths: np.ndarray, k: int
) -> tuple[np.ndarray, np.ndarray]:
    """First/last k-window of each read, packed int64, on HOST numpy.

    The endpoint-first keep predicate (reference src/reads.cpp:74-76
    tests only a read's first or last window node) needs exactly these
    two k-mers per read; computing them host-side means the mapper's
    phase-1 keep decision uploads 16 bytes/read instead of the full code
    matrix. Returns ``(first_km [R], last_km [R])``; reads shorter than
    ``k`` get SENTINEL.
    """
    codes = np.asarray(codes, dtype=np.uint8)
    lengths = np.asarray(lengths, dtype=np.int64)
    R, L = codes.shape
    sen = np.int64(np.iinfo(np.int64).max)
    if L < k or R == 0:
        s = np.full(R, sen, dtype=np.int64)
        return s, s.copy()
    first = np.zeros(R, dtype=np.int64)
    for t in range(k):
        first = (first << 2) | codes[:, t].astype(np.int64)
    start = np.maximum(lengths - k, 0)
    idx = np.minimum(start[:, None] + np.arange(k, dtype=np.int64)[None, :], L - 1)
    g = np.take_along_axis(codes, idx, axis=1).astype(np.int64)
    last = np.zeros(R, dtype=np.int64)
    for t in range(k):
        last = (last << 2) | g[:, t]
    ok = lengths >= k
    return np.where(ok, first, sen), np.where(ok, last, sen)


def count_kmers_for_reads(
    codes: np.ndarray, lengths: np.ndarray, k: int
) -> tuple[np.ndarray, np.ndarray]:
    """Host-facing: unique sorted k-mers + counts for a read batch."""
    kmers = extract_kmers(jnp.asarray(codes), jnp.asarray(lengths), k)
    unique, counts, n_unique = count_unique(kmers.reshape(-1))
    n = int(n_unique)
    return np.asarray(unique[:n]), np.asarray(counts[:n])
