"""Distributed de Bruijn graph: node table + adjacency sharded over kp.

The single-device ``graph.dbg.DBG`` holds the whole structure-of-arrays
in one device's memory. At 1B+ nodes the table must shard (SURVEY §7.3 risk 4): here the
k-mer space is radix-partitioned by the packed k-mer's top bits over the
mesh's ``kp`` axis, so shard s owns a contiguous sorted range.

Key property exploited for the build: a 24-mer edge ``e = u·b`` has the
same top bits as its source 23-mer ``u`` (``e >> (48-bits) == u >>
(46-bits)``), so every edge is co-located with its source node — the
*out*-adjacency builds entirely locally. Destination ids and the
*in*-adjacency require one routed exchange each (``all_to_all`` over kp).

Global node id = ``shard * T + local_rank`` with fixed per-shard capacity
``T``; SENTINEL-padded tails keep shapes static.

`frontier_step` is the distributed BFS primitive: global node ids route to
their owner shard, the owner gathers out-neighbors, results route back —
the communication shape of the distributed cycle search and read mapper
(SURVEY §5 "long-context" analog).
"""

from __future__ import annotations

import functools
from dataclasses import dataclass

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, PartitionSpec as P

from mcaat_tpu.kmer.count import (
    SENTINEL,
    count_unique,
    derive_nodes_from_edges,
    extract_first_kmer,
    extract_kmers,
    extract_last_kmer,
    merge_counted,
    revcomp_kmers,
)
from mcaat_tpu.parallel.sharded import _bucket_by_owner, _owner_shift

shard_map = jax.shard_map


@functools.lru_cache(maxsize=None)
def _replicator(mesh: Mesh):
    from jax.sharding import NamedSharding

    return jax.jit(lambda x: x, out_shardings=NamedSharding(mesh, P()))


def host_replicated(mesh: Mesh, x) -> np.ndarray:
    """Host numpy view of a mesh-sharded array, valid across processes.

    Single-process: plain ``np.asarray`` (every shard is addressable).
    Multi-process: a kp-sharded array is NOT fully addressable, so one
    jitted identity with replicated out_sharding all-gathers it first —
    every process executes this (the host orchestration loops are
    replicated across processes by design). Use only for O(N)-bounded
    masks/ids, never for adjacency-sized arrays.
    """
    if jax.process_count() == 1:
        return np.asarray(x)
    return np.asarray(_replicator(mesh)(x))


@dataclass
class ShardedDBG:
    """Per-shard arrays; leading axis is the kp shard."""

    k: int
    mesh: Mesh
    kmers: jax.Array  # int64 [kp, T] sorted per shard, SENTINEL pad
    mult: jax.Array  # int32 [kp, T]
    out: jax.Array  # int32 [kp, 4T] flat GLOBAL node ids, -1 absent
    in_: jax.Array  # int32 [kp, 4T] flat GLOBAL node ids, -1 absent
    valid: jax.Array  # bool  [kp, T]
    route_cap: int = 0  # all_to_all bucket capacity the build used
    n_live: np.ndarray | None = None  # int [kp] live rows per shard
    # adjacency is flat (slot 4*local+base), like graph.dbg.DBG

    @property
    def shard_capacity(self) -> int:
        return int(self.kmers.shape[1])

    @property
    def n_nodes(self) -> int:
        if self.n_live is not None:
            return int(self.n_live.sum())
        return int(jnp.sum(self.kmers != SENTINEL))

    def to_single_device(self):
        """Materialize a host-side global view (tests / small graphs)."""
        kp, T = self.kmers.shape
        return (
            np.asarray(self.kmers).reshape(kp * T),
            np.asarray(self.mult).reshape(kp * T),
            np.asarray(self.out).reshape(kp * T, 4),
            np.asarray(self.valid).reshape(kp * T),
            np.asarray(self.in_).reshape(kp * T, 4),
        )  # host reshape to [.,4] is numpy — unpadded


# ---------------------------------------------------------------------------
# Two-phase distributed build: count → size capacity from LIVE rows → adjacency
# ---------------------------------------------------------------------------

# Per-part budget on the per-shard counting input (rows fed to one
# per-shard count_unique sort), with headroom for the resident
# merge-stack parts + the final tables. Fit to the previous accelerator's
# 16 GB of device memory; unmeasured on this card.
SHARDED_COUNT_SHARD_ROWS = 192_000_000


@functools.partial(
    jax.jit,
    static_argnames=("mesh", "k", "route_cap", "route_cap_last", "add_rc"),
)
def _sharded_route_part(
    mesh: Mesh,
    codes: jax.Array,  # uint8 [R, L] sharded over ("dp","kp") rows
    lengths: jax.Array,  # int32 [R]
    k: int,
    route_cap: int,
    route_cap_last: int,
    add_rc: bool = False,
):
    """Route one row part's (k+1)-mer edges + last k-windows to owners.

    An edge shares its top bits with its source k-mer, so every node
    k-mer reaches its owner shard as a prefix of a routed edge or as a
    routed last window — the k-window multiset itself (the largest
    array) never crosses the interconnect. With ``add_rc`` the reverse
    strand joins as pure bit math (its edge multiset is the elementwise
    RC of the forward edges; its last k-window is the RC of the forward
    FIRST window) — no RC code matrix is materialized or uploaded.

    Returns (a24 [kp, dp*kp*route_cap], a_l [kp, dp*kp*route_cap_last],
    dropped) — per-shard routed multisets, SENTINEL-padded.
    """
    kp = mesh.shape["kp"]
    shift23 = _owner_shift(k, kp)
    shift24 = _owner_shift(k + 1, kp)

    def step(codes_local, lengths_local):
        km24 = extract_kmers(codes_local, lengths_local, k + 1).reshape(-1)
        last23 = extract_last_kmer(codes_local, lengths_local, k)
        if add_rc:
            km24 = jnp.concatenate([km24, revcomp_kmers(km24, k + 1)])
            first23 = extract_first_kmer(codes_local, lengths_local, k)
            last23 = jnp.concatenate([last23, revcomp_kmers(first23, k)])
        s24, d24 = _bucket_by_owner(km24, kp, shift24, route_cap)
        s_l, d_l = _bucket_by_owner(last23, kp, shift23, route_cap_last)
        r24 = jax.lax.all_to_all(s24[None], "kp", 1, 1, tiled=False)[0].reshape(-1)
        r_l = jax.lax.all_to_all(s_l[None], "kp", 1, 1, tiled=False)[0].reshape(-1)
        a24 = jax.lax.all_gather(r24, "dp", tiled=True)
        a_l = jax.lax.all_gather(r_l, "dp", tiled=True)
        dropped = jax.lax.psum(d24 + d_l, ("dp", "kp"))
        return a24[None], a_l[None], dropped

    fn = shard_map(
        step,
        mesh=mesh,
        in_specs=(P(("dp", "kp"), None), P(("dp", "kp"))),
        out_specs=(P("kp", None), P("kp", None), P()),
        check_vma=False,
    )
    return fn(codes, lengths)


# Per-shard (batched over the kp axis, zero-communication) table kernels:
# vmap over the shard axis + GSPMD keeps each row's sort/merge/derive on
# its owner device. These reuse the single-chip kernels verbatim.
_vcount = jax.jit(jax.vmap(count_unique))
_vmerge = jax.jit(jax.vmap(merge_counted))
_vderive = jax.jit(jax.vmap(derive_nodes_from_edges))

# elementwise, sharding-preserving: the reference's
# InvalidateMultiplicityOneNodes (src/cycle_finder.cpp:372-382)
_vmult_filter = jax.jit(lambda valid, mult: valid & (mult > 1))


def _sbucket(n: int) -> int:
    from mcaat_tpu.graph.dbg import _bucket_size

    return _bucket_size(max(int(n), 1))


def _smerge_two(mesh: Mesh, a, b):
    """Merge two sharded (u [kp,C], c, n_dev [kp], n_vec, level) stack
    entries; the merged table is sliced to the bucketed max live rows."""
    ua, ca, _nda, _nva, la = a
    ub, cb, _ndb, _nvb, lb = b
    mu, mc, mn, ovf = _vmerge(ua, ca, ub, cb)
    n_vec = host_replicated(mesh, mn)
    assert int(host_replicated(mesh, ovf).max()) == 0, (
        "sharded merge fed a non-unique table"
    )
    size = min(_sbucket(n_vec.max()), int(mu.shape[1]))
    return [mu[:, :size], mc[:, :size], mn, n_vec, max(la, lb) + 1]


def _sstack_push(mesh: Mesh, stack: list, u, c, n_dev, n_vec):
    """Binary-counter merge stack over per-shard counted tables (the
    sharded twin of kmer.count._merge_stack_push; at most ~log2(parts)
    node-proportional tables are ever alive per shard)."""
    stack.append([u, c, n_dev, n_vec, 0])
    while len(stack) >= 2 and stack[-1][4] == stack[-2][4]:
        b = stack.pop()
        a = stack.pop()
        stack.append(_smerge_two(mesh, a, b))


def _sstack_drain(mesh: Mesh, stack: list):
    while len(stack) > 1:
        b = stack.pop()
        a = stack.pop()
        stack.append(_smerge_two(mesh, a, b))
    u, c, n_dev, n_vec, _ = stack[0]
    return u, c, n_dev, n_vec


@functools.partial(jax.jit, static_argnames=("mesh", "k", "adj_cap"))
def _sharded_adjacency(
    mesh: Mesh,
    u23: jax.Array,  # int64 [kp, T] final node table
    u24: jax.Array,  # int64 [kp, C] final unique edge table
    u_id: jax.Array,  # int32 [kp, C] source node id per edge (-1 dead)
    k: int,
    adj_cap: int,
):
    """Adjacency assembly at node-proportional capacity T.

    Out-edges are co-located with their source (same top bits); the
    destination id needs one routed lookup, the in-adjacency one routed
    (v, base, u_gid) exchange. Returns (out [kp,4T], in_ [kp,4T],
    dropped) — dropped > 0 means a routing bucket overflowed (caller
    retries with a doubled ``adj_cap``).
    """
    kp = mesh.shape["kp"]
    T = u23.shape[1]
    shift23 = _owner_shift(k, kp)
    mask_k = (np.int64(1) << np.int64(2 * k)) - 1

    def step(u23_l, u24_l, u_id_l):
        u23_l, u24_l, u_id_l = u23_l[0], u24_l[0], u_id_l[0]
        my_kp = jax.lax.axis_index("kp")
        v = u24_l & jnp.int64(mask_k)
        b = (u24_l & jnp.int64(3)).astype(jnp.int32)
        # T = bucket(max live) >= every shard's live rows, so u_id < T
        # always holds for live rows — no overflow drop path remains
        u_ok = (u24_l != SENTINEL) & (u_id_l >= 0)
        u_pos_c = jnp.minimum(jnp.maximum(u_id_l, 0), T - 1)
        v_gid, d_v = _routed_lookup(
            u23_l, jnp.where(u_ok, v, SENTINEL), kp, shift23, adj_cap, T, my_kp
        )
        ok = u_ok & (v_gid >= 0)
        dump = jnp.int32(4 * T)
        slots = jnp.where(ok, u_pos_c.astype(jnp.int32) * 4 + b, dump)
        # u24 sorted ⇒ (prefix rank, base) strictly ascending over live
        # rows and dead rows sort last ⇒ slots are sorted
        out_flat = (
            jnp.full((4 * T + 1,), -1, dtype=jnp.int32)
            .at[slots]
            .set(jnp.where(ok, v_gid, -1), unique_indices=True,
                 indices_are_sorted=True)
        )
        out_local = out_flat[: 4 * T]

        # ---- in-adjacency: route (v, first_base, u_gid) to owner(v) ----
        first = ((u24_l >> jnp.int64(2 * k)) & jnp.int64(3)).astype(jnp.int64)
        u_gid = (
            my_kp.astype(jnp.int32) * T + u_pos_c.astype(jnp.int32)
        ).astype(jnp.int64)
        key = jnp.where(ok, v, SENTINEL)
        payload = jnp.where(ok, u_gid * 4 + first, jnp.int64(-1))
        ownerv = jnp.where(
            key != SENTINEL, (key >> shift23).astype(jnp.int32), kp
        )
        order = jnp.argsort(ownerv, stable=True)
        key_s = key[order]
        pay_s = payload[order]
        owner_s = ownerv[order]
        bounds = jnp.searchsorted(owner_s, jnp.arange(kp + 1, dtype=jnp.int32))
        starts, ends = bounds[:kp], bounds[1:]
        nq = key.shape[0]
        col = jax.lax.broadcasted_iota(jnp.int32, (kp, adj_cap), 1)
        idx = starts[:, None] + col
        live = idx < ends[:, None]
        idx_c = jnp.minimum(idx, nq - 1)
        send_k = jnp.where(live, key_s[idx_c], SENTINEL)
        send_p = jnp.where(live, pay_s[idx_c], jnp.int64(-1))
        d_in = jnp.sum(jnp.maximum(ends - starts - adj_cap, 0))
        recv_k = jax.lax.all_to_all(send_k[None], "kp", 1, 1, tiled=False)[0].reshape(-1)
        recv_p = jax.lax.all_to_all(send_p[None], "kp", 1, 1, tiled=False)[0].reshape(-1)
        v_pos = jnp.searchsorted(
            u23_l, recv_k, method="sort" if recv_k.size >= 4096 else "scan"
        )
        v_pos_c = jnp.minimum(v_pos, T - 1)
        hit = (recv_k != SENTINEL) & (u23_l[v_pos_c] == recv_k) & (recv_p >= 0)
        in_slot = jnp.where(
            hit,
            v_pos_c.astype(jnp.int32) * 4 + (recv_p & 3).astype(jnp.int32),
            dump,
        )
        in_flat = (
            jnp.full((4 * T + 1,), -1, dtype=jnp.int32)
            .at[in_slot]
            .set(
                jnp.where(hit, (recv_p >> 2).astype(jnp.int32), -1),
                unique_indices=True,
            )
        )
        in_local = in_flat[: 4 * T]
        dropped = jax.lax.psum(d_v + d_in, ("dp", "kp"))
        return out_local[None], in_local[None], dropped

    fn = shard_map(
        step,
        mesh=mesh,
        in_specs=(P("kp", None), P("kp", None), P("kp", None)),
        out_specs=(P("kp", None), P("kp", None), P()),
        check_vma=False,
    )
    return fn(u23, u24, u_id)


def _routed_lookup(table_local, queries, kp, shift, route_cap, T, my_kp):
    """Inside shard_map: route queries to owners, search, route back.

    Returns (GLOBAL node ids (owner*T + local pos), -1 for misses,
    aligned with the input query order; dropped count — queries that
    overflowed a routing bucket).
    """
    n = queries.shape[0]
    owner = jnp.where(
        queries != SENTINEL, (queries >> shift).astype(jnp.int32), kp
    )
    order = jnp.argsort(owner, stable=True)
    q_sorted = queries[order]
    owner_sorted = owner[order]
    bounds = jnp.searchsorted(owner_sorted, jnp.arange(kp + 1, dtype=jnp.int32))
    starts, ends = bounds[:kp], bounds[1:]
    col = jax.lax.broadcasted_iota(jnp.int32, (kp, route_cap), 1)
    idx = starts[:, None] + col
    live = idx < ends[:, None]
    idx_c = jnp.minimum(idx, n - 1)
    send = jnp.where(live, q_sorted[idx_c], SENTINEL)
    dropped = jnp.sum(jnp.maximum(ends - starts - route_cap, 0))

    recv = jax.lax.all_to_all(send[None], "kp", 1, 1, tiled=False)[0]
    flat = recv.reshape(-1)
    method = "sort" if flat.size >= 4096 else "scan"
    pos = jnp.searchsorted(table_local, flat, method=method)
    pos_c = jnp.minimum(pos, T - 1)
    hit = (flat != SENTINEL) & (table_local[pos_c] == flat)
    gid = jnp.where(hit, my_kp.astype(jnp.int32) * T + pos_c.astype(jnp.int32), -1)
    back = jax.lax.all_to_all(
        gid.reshape(kp, route_cap)[None], "kp", 1, 1, tiled=False
    )[0]
    out_sorted = jnp.full((n,), -1, dtype=jnp.int32)
    out_sorted = out_sorted.at[
        jnp.where(live, idx_c, n).reshape(-1)
    ].set(back.reshape(-1), mode="drop")
    return jnp.zeros((n,), jnp.int32).at[order].set(out_sorted), dropped


def _lift_part(mesh: Mesh, codes_p: np.ndarray, lengths_p: np.ndarray):
    """Lift one per-process row part into global ("dp","kp")-sharded
    arrays; the code matrix is transferred 2-bit packed (4x fewer
    bytes) and unpacks on device."""
    from jax.sharding import NamedSharding

    from mcaat_tpu.kmer.count import pack_codes_host, unpack_codes_device

    codes_sh = NamedSharding(mesh, P(("dp", "kp"), None))
    len_sh = NamedSharding(mesh, P(("dp", "kp")))
    packed = pack_codes_host(codes_p)
    g_packed = jax.make_array_from_process_local_data(codes_sh, packed)
    g_lengths = jax.make_array_from_process_local_data(len_sh, lengths_p)
    return unpack_codes_device(g_packed), g_lengths


def build_sharded_dbg(
    mesh: Mesh,
    codes,
    lengths,
    k: int = 23,
    route_cap: int | None = None,
    add_rc: bool = False,
    count_shard_rows: int | None = None,
    verbose: bool = False,
    max_retries: int = 4,
) -> tuple[ShardedDBG, int]:
    """Two-phase distributed build over the ("dp","kp") mesh.

    ``codes``/``lengths`` are THIS PROCESS's local read rows (host
    numpy; single-process callers pass all rows). Multi-process callers
    must call with their own host shard on every process.

    Phase 1 (count): row parts are lifted to the mesh, their (k+1)-mer
    edges + last k-windows routed to owner shards (``all_to_all`` over
    kp, ``all_gather`` over dp) and counted per shard; part tables
    reduce through a per-shard binary-counter merge stack, so the
    per-shard window volume may exceed the single-pass sort budget
    (``count_shard_rows`` bounds one part's per-shard count input — the
    sharded twin of the single-chip 384M-window budget, ≙ the
    reference's RAM-bounded counting, src/sdbg_build.cpp:122-190).

    Phase 2 (allocate + adjacency): the node table derives per shard
    from the unique edge table, and the shard capacity is set to
    ``T = bucket(max live rows over shards)`` — NODE-proportional.
    Sizing from the window count (r3) over-allocated 16.8x at kp=8 and
    made a 1B-node graph un-holdable on a 16-chip slice
    (44 GB/chip of capacity vs ~3 GB of live rows); counting first
    mirrors the single-chip bucket-the-kept-slice pattern
    (kmer/count.py _bucket_slice).

    Routing-bucket overflows (k-mer-space skew) retry internally with
    doubled capacities. Returns (graph, dropped); dropped == 0 unless
    ``max_retries`` doublings still overflowed.
    """
    import time

    from jax.experimental import multihost_utils

    codes = np.asarray(codes, dtype=np.uint8)
    lengths = np.asarray(lengths, dtype=np.int32)
    kp = mesh.shape["kp"]
    dp = mesh.shape["dp"]
    n_local_shards = len(mesh.local_devices)
    n_proc = jax.process_count()

    import os as _os

    # agree on a common per-host row count and padded length
    R, L = codes.shape
    if n_proc > 1:
        maxes = multihost_utils.process_allgather(
            np.asarray([R, L], dtype=np.int64)
        )
        R_max, L_max = int(maxes[:, 0].max()), int(maxes[:, 1].max())
    else:
        R_max, L_max = R, L
    L_pad = max((L_max + 3) // 4 * 4, 4)  # packed-upload alignment

    # part sizing: one part's per-shard count input is
    # dp*kp*route_cap ≈ 2x (part windows)/kp rows
    budget = count_shard_rows or int(
        _os.environ.get("MCAAT_COUNT_SHARD_ROWS", SHARDED_COUNT_SHARD_ROWS)
    )
    wpr = max(L_max - k, 1) * (2 if add_rc else 1)  # (k+1)-windows per row
    rows_budget = max(
        int(budget * kp // (2 * wpr * max(n_proc, 1))), n_local_shards
    )
    rows_per_part = (
        (min(rows_budget, R_max) + n_local_shards - 1)
        // n_local_shards
        * n_local_shards
    )
    n_parts = max((R_max + rows_per_part - 1) // rows_per_part, 1)

    part_rows_total = rows_per_part * n_proc
    part_windows = part_rows_total * wpr
    local_windows = part_windows // (dp * kp)
    cap0 = route_cap or _sbucket(2 * max(local_windows // kp, 1))
    cap_l0 = _sbucket(
        2 * max(rows_per_part * (2 if add_rc else 1) // (n_local_shards * kp), 1)
    )

    t0 = time.perf_counter()
    attempt_cap, attempt_cap_l = cap0, cap_l0
    dropped_final = 0
    for _attempt in range(max_retries):
        stack24: list = []
        stack_l: list = []
        overflow = False
        for pi in range(n_parts):
            lo = pi * rows_per_part
            hi = min(lo + rows_per_part, R_max)
            codes_p = np.zeros((rows_per_part, L_pad), dtype=np.uint8)
            lengths_p = np.zeros((rows_per_part,), dtype=np.int32)
            r_lo, r_hi = min(lo, R), min(hi, R)
            if r_hi > r_lo:
                codes_p[: r_hi - r_lo, :L] = codes[r_lo:r_hi]
                lengths_p[: r_hi - r_lo] = lengths[r_lo:r_hi]
            g_codes, g_lengths = _lift_part(mesh, codes_p, lengths_p)
            a24, a_l, d_route = _sharded_route_part(
                mesh, g_codes, g_lengths, k, attempt_cap, attempt_cap_l,
                add_rc=add_rc,
            )
            if int(d_route) > 0:
                dropped_final = int(d_route)
                overflow = True
                break
            u24, c24, n24 = _vcount(a24)
            u_l, c_l, n_l = _vcount(a_l)
            nv24 = host_replicated(mesh, n24)
            nv_l = host_replicated(mesh, n_l)
            s24 = min(_sbucket(nv24.max()), int(u24.shape[1]))
            s_l = min(_sbucket(nv_l.max()), int(u_l.shape[1]))
            _sstack_push(mesh, stack24, u24[:, :s24], c24[:, :s24], n24, nv24)
            _sstack_push(mesh, stack_l, u_l[:, :s_l], c_l[:, :s_l], n_l, nv_l)
            if verbose:
                print(
                    f"    [sbuild]  part {pi + 1}/{n_parts}: "
                    f"{nv24.max()} max unique edges/shard "
                    f"({time.perf_counter() - t0:.2f}s)",
                    flush=True,
                )
        if overflow:
            attempt_cap = _sbucket(attempt_cap * 2)
            attempt_cap_l = _sbucket(attempt_cap_l * 2)
            continue

        u24, c24, n24_dev, nv24 = _sstack_drain(mesh, stack24)
        u_l, c_l, _nl_dev, _nvl = _sstack_drain(mesh, stack_l)
        u23f, c23f, n23, u_id = _vderive(u24, c24, n24_dev, u_l, c_l)
        nv23 = host_replicated(mesh, n23)
        T = min(_sbucket(nv23.max()), int(u23f.shape[1]))
        u23 = u23f[:, :T]
        c23 = c23f[:, :T]
        if verbose:
            print(
                f"    [sbuild]  node table: {int(nv23.sum())} nodes, "
                f"T={T} (max live/shard {nv23.max()}, "
                f"{time.perf_counter() - t0:.2f}s)",
                flush=True,
            )

        # phase 2: adjacency with its own (edge-proportional) route cap
        C = int(u24.shape[1])
        adj_cap = _sbucket(2 * max(C // kp, 1))
        for _a in range(max_retries):
            out, in_, d_adj = _sharded_adjacency(mesh, u23, u24, u_id, k, adj_cap)
            dropped_final = int(d_adj)
            if dropped_final == 0 or adj_cap >= C:
                break
            adj_cap = min(_sbucket(adj_cap * 2), _sbucket(C))
        if dropped_final == 0:
            graph = ShardedDBG(
                k=k, mesh=mesh, kmers=u23, mult=c23, out=out, in_=in_,
                valid=u23 != SENTINEL, route_cap=attempt_cap,
                n_live=nv23.astype(np.int64),
            )
            graph.n_parts = n_parts  # observability (at-scale artifacts)
            return graph, 0
        break  # adjacency overflow is not fixed by re-counting
    return (
        ShardedDBG(
            k=k, mesh=mesh,
            kmers=jnp.zeros((kp, 1), jnp.int64),
            mult=jnp.zeros((kp, 1), jnp.int32),
            out=jnp.zeros((kp, 4), jnp.int32),
            in_=jnp.zeros((kp, 4), jnp.int32),
            valid=jnp.zeros((kp, 1), bool),
        ),
        max(dropped_final, 1),
    )


def _routed_value_gather(values_local, gids, kp, T, cap, fill):
    """Inside shard_map: gather ``values[g]`` for GLOBAL ids ``g`` whose
    owner is ``g // T`` — route ids to owners, gather the owner's local
    row, route back. The owner-routed replacement for replicating the
    full ``[kp*T]`` value array with ``all_gather`` (VERDICT r4 #1):
    wire cost is O(queries), not O(N·kp).

    Returns (values aligned with ``gids`` — ``fill`` for ``gids < 0`` or
    dropped queries; dropped count — queries overflowing a routing
    bucket; callers retry with doubled ``cap``).
    """
    n = gids.shape[0]
    owner = jnp.where(gids >= 0, gids // T, kp).astype(jnp.int32)
    order = jnp.argsort(owner, stable=True)
    g_sorted = gids[order]
    owner_sorted = owner[order]
    bounds = jnp.searchsorted(owner_sorted, jnp.arange(kp + 1, dtype=jnp.int32))
    starts, ends = bounds[:kp], bounds[1:]
    col = jax.lax.broadcasted_iota(jnp.int32, (kp, cap), 1)
    idx = starts[:, None] + col
    live = idx < ends[:, None]
    idx_c = jnp.minimum(idx, n - 1)
    send = jnp.where(live, g_sorted[idx_c], -1)
    dropped = jnp.sum(jnp.maximum(ends - starts - cap, 0)).astype(jnp.int32)
    recv = jax.lax.all_to_all(send[None], "kp", 1, 1, tiled=False)[0].reshape(-1)
    loc = jnp.where(recv >= 0, recv % T, 0)
    vals = jnp.where(recv >= 0, values_local[loc], fill)
    back = jax.lax.all_to_all(
        vals.reshape(kp, cap)[None], "kp", 1, 1, tiled=False
    )[0]
    out_sorted = jnp.full((n,), fill, dtype=vals.dtype)
    out_sorted = out_sorted.at[
        jnp.where(live, idx_c, n).reshape(-1)
    ].set(back.reshape(-1), mode="drop")
    return jnp.full((n,), fill, dtype=vals.dtype).at[order].set(out_sorted), dropped


@functools.partial(jax.jit, static_argnames=("mesh", "route_cap"))
def routed_gather(mesh: Mesh, values: jax.Array, gids: jax.Array,
                  route_cap: int):
    """Owner-routed gather of ``values[g // T, g % T]`` for a replicated
    [Q] global-id array (-1 dead → zero of the value dtype). The
    query-proportional replacement for a replicated-out_shardings gather
    of a sharded table (which replicates the WHOLE table per call — the
    node k-mer table alone is 8 GB at 1B nodes). With ``route_cap`` = Q
    no bucket can overflow (dropped ≡ 0)."""
    kp = mesh.shape["kp"]
    T = values.shape[1]

    def step(values_l, g):
        values_l = values_l[0]
        vals, _dropped = _routed_value_gather(
            values_l, g, kp, T, route_cap,
            fill=jnp.zeros((), values_l.dtype),
        )
        return vals

    fn = shard_map(
        step,
        mesh=mesh,
        in_specs=(P(None, "kp"), P()),
        out_specs=P(),
        check_vma=False,
    )
    return fn(values.reshape(1, -1), gids)


@functools.partial(jax.jit, static_argnames=("mesh", "route_cap"))
def _tag_adjacency(mesh: Mesh, adj: jax.Array, valid: jax.Array, route_cap: int):
    """One routed pass encoding TARGET validity into adjacency entries:
    entry g pointing at an invalid node becomes ``-2 - g`` (recoverable);
    valid targets stay ``g``; absent stays ``-1``."""
    kp = mesh.shape["kp"]
    T = valid.shape[1]

    def step(adj_l, valid_l):
        adj_l = adj_l[0]  # flat [4T] global ids
        valid_l = valid_l[0]
        ok, dropped = _routed_value_gather(
            valid_l, adj_l, kp, T, route_cap, fill=False
        )
        tagged = jnp.where(
            adj_l < 0, jnp.int32(-1), jnp.where(ok, adj_l, -2 - adj_l)
        )
        return tagged[None], jax.lax.psum(dropped, ("dp", "kp"))

    fn = shard_map(
        step,
        mesh=mesh,
        in_specs=(P(None, "kp"), P(None, "kp")),
        out_specs=(P(None, "kp"), P()),
        check_vma=False,
    )
    tagged, dropped = fn(adj.reshape(1, -1), valid.reshape(1, -1))
    return tagged.reshape(kp, 4 * T), dropped


def tag_adjacency(mesh: Mesh, adj: jax.Array, valid: jax.Array) -> jax.Array:
    """Validity-tagged adjacency (see ``_tag_adjacency``), with routing
    capacity retries. ONE O(4N)-wire routed exchange per validity epoch;
    afterwards every BFS/candidate consumer reads neighbor validity
    LOCALLY from the tag — no per-call validity collective anywhere
    (VERDICT r4 #1: frontier_step previously all-gathered the full
    ``[kp*T]`` mask on every call). Per-owner load is structurally
    bounded: a DBG node has ≤ 4 in-edges, so each target id appears ≤ 4
    times in the global out-adjacency."""
    from mcaat_tpu.utils import wire

    kp, T = valid.shape
    cap = _sbucket(2 * max(4 * T // kp, 1))
    while True:
        tagged, dropped = _tag_adjacency(mesh, adj, valid, cap)
        wire.add("tag_adjacency", kp * kp * cap * (4 + 1 + 4))
        if int(dropped) == 0 or cap >= 4 * T:
            return tagged
        cap = min(_sbucket(cap * 4), _sbucket(4 * T))


def decode_tagged(adj) -> jax.Array:
    """Recover raw global ids from a validity-tagged adjacency
    (``-2-g`` → ``g``; ``-1`` stays absent)."""
    return jnp.where(adj <= -2, -2 - adj, adj)


def tagged_adjacency(sg: "ShardedDBG", valid):
    """(out, in_) tagged with ``valid`` — cached on the graph object so
    the cycle stage and the region condensation (same validity epoch)
    share one tagging pass per array. Cache key is the ``valid`` array
    OBJECT (a new epoch is always a new array)."""
    cache = getattr(sg, "_tag_cache", None)
    if cache is not None and cache[0] is valid:
        return cache[1], cache[2]
    outv = tag_adjacency(sg.mesh, sg.out, valid)
    inv = tag_adjacency(sg.mesh, sg.in_, valid)
    sg._tag_cache = (valid, outv, inv)
    return outv, inv


@functools.partial(
    jax.jit, static_argnames=("mesh", "n_passes", "gather_cap")
)
def _sharded_chain_collapse(mesh: Mesh, outv: jax.Array, valid: jax.Array,
                            n_passes: int, gather_cap: int):
    """Distributed unary-chain collapse by pointer doubling.

    ``outv`` is the valid-TAGGED adjacency (``tag_adjacency`` with the
    same ``valid``), so successor admissibility is a local sign test —
    no validity gather. Each doubling pass routes every node's pointer
    target to its owner shard and gathers the owner's pointer
    (``_routed_value_gather``): O(N) wire per pass instead of the
    ``all_gather``'s O(N·kp) (VERDICT r4 #1). log2(N) passes total.

    Bounded-scale path: at ≥ cycles.finder.LAZY_CLIP_MIN_NODES the
    sharded pipeline defers tip clipping to the extracted candidate
    neighborhood and never runs this (mirroring the single-device lazy
    clip). Convergence can concentrate pointers onto few targets
    (duplicate queries), so the routing capacity retries; the escalation
    ceiling T equals the all_gather volume this replaced.

    Returns (ntype [kp,T], ptr [kp,T] of GLOBAL ids, dropped).
    """
    from mcaat_tpu.prune.prune import _BRANCH, _DEAD, _UNARY

    kp = mesh.shape["kp"]
    T = valid.shape[1]

    def step(out_l, valid_l):
        out_l = out_l[0]  # flat [4T], validity-tagged global neighbor ids
        valid_l = valid_l[0]
        my = jax.lax.axis_index("kp")
        adj_ok = out_l >= 0  # tagged ⇒ target validity is the sign bit
        # strided flat slices, not reshape(T, 4) — see prune._chain_collapse
        deg = adj_ok[0::4].astype(jnp.int32)
        succ = jnp.where(adj_ok[0::4], out_l[0::4], -1)
        for b in range(1, 4):
            deg = deg + adj_ok[b::4]
            succ = jnp.maximum(succ, jnp.where(adj_ok[b::4], out_l[b::4], -1))
        ntype = jnp.where(
            ~valid_l | (deg == 0), _DEAD, jnp.where(deg == 1, _UNARY, _BRANCH)
        ).astype(jnp.int32)
        gids = my.astype(jnp.int32) * T + jnp.arange(T, dtype=jnp.int32)
        ptr = jnp.where(ntype == _UNARY, succ, gids)

        def body(_, carry):
            p, dropped = carry
            newp, d = _routed_value_gather(p, p, kp, T, gather_cap, fill=-1)
            return newp, dropped + d

        ptr, dropped = jax.lax.fori_loop(
            0, n_passes, body, (ptr, jnp.int32(0))
        )
        return ntype[None], ptr[None], jax.lax.psum(dropped, ("dp", "kp"))

    fn = shard_map(
        step,
        mesh=mesh,
        in_specs=(P(None, "kp"), P(None, "kp")),
        out_specs=(P(None, "kp"), P(None, "kp"), P()),
        check_vma=False,
    )
    nt, pt, dropped = fn(outv.reshape(1, -1), valid.reshape(1, -1))
    return nt.reshape(kp, T), pt.reshape(kp, T), dropped


def sharded_prune_and_candidates(
    mesh: Mesh,
    mult: jax.Array,  # [kp, T]
    out: jax.Array,  # [kp, 4T] flat global ids
    in_: jax.Array,  # [kp, 4T] flat global ids
    valid: jax.Array,  # [kp, T]
    threshold_multiplicity: int = 20,
):
    """Distributed pruning + start-node candidate scan.

    Multiplicity ≤ 1 invalidation and the chain collapse run sharded on
    device (see ``_sharded_chain_collapse``); the condensed branch-node
    fixpoint + final classification run on host over the collapsed
    pointers (the branch set is tiny — same split as
    ``prune.clip_tips``). Returns (valid [kp, T], candidates [kp, T]).
    """
    from mcaat_tpu.cycles.start_nodes import _candidate_mask
    from mcaat_tpu.prune.prune import (
        _BRANCH,
        _condensed_slots,
        _final_valid,
    )

    kp = mesh.shape["kp"]
    T = mult.shape[1]
    N = kp * T
    valid0 = _vmult_filter(valid, mult)
    n_passes = max(int(np.ceil(np.log2(max(N, 2)))) + 1, 1)
    outv0 = tag_adjacency(mesh, out, valid0)
    gather_cap = _sbucket(2 * max(T // kp, 1))
    while True:
        ntype, ptr, dropped = _sharded_chain_collapse(
            mesh, outv0, valid0, n_passes, gather_cap
        )
        from mcaat_tpu.utils import wire

        wire.add(
            "chain_collapse", n_passes * kp * kp * gather_cap * (4 + 4 + 4)
        )
        if int(dropped) == 0 or gather_cap >= T:
            break
        gather_cap = min(_sbucket(gather_cap * 4), _sbucket(T))

    # all O(N) work stays on device: the flat [kp,T]/[kp,4T] layout equals
    # the single-device global-id layout (slot 4g+b), so the single-device
    # jitted helpers apply directly. Host sees only the (tiny) branch-row
    # condensed classes for the aliveness fixpoint — same split as
    # prune.clip_tips.
    ntype_f = ntype.reshape(-1)
    ptr_f = ptr.reshape(-1)
    out_f = out.reshape(-1)
    in_f = in_.reshape(-1)
    valid0_f = valid0.reshape(-1)
    cond = _condensed_slots(out_f, valid0_f, ntype_f, ptr_f)  # [4N] device

    branch = np.nonzero(host_replicated(mesh, ntype_f == _BRANCH))[0].astype(
        np.int64
    )
    alive = np.zeros(N, dtype=bool)
    if len(branch) > 0:
        sel = jnp.asarray(branch)
        slots = (sel * 4)[:, None] + jnp.arange(4, dtype=sel.dtype)
        cond_h = host_replicated(mesh, cond[slots])  # [B,4] — only branch rows cross
        of_node = np.full(N, -1, dtype=np.int64)
        of_node[branch] = np.arange(len(branch))
        tgt = np.where(cond_h >= 0, of_node[np.maximum(cond_h, 0)], -1)
        has_cycle_edge = (cond_h == -2).any(axis=1)
        a = np.ones(len(branch), dtype=bool)
        while True:
            t_alive = (tgt >= 0) & a[np.maximum(tgt, 0)]
            new_a = has_cycle_edge | t_alive.any(axis=1)
            if (new_a == a).all():
                break
            a = new_a
        alive[branch] = a

    v = _final_valid(valid0_f, ntype_f, ptr_f, alive)
    cand = _candidate_mask(
        out_f, in_f, v, mult.reshape(-1), threshold_multiplicity
    )
    return v.reshape(kp, T), cand.reshape(kp, T)


# ---------------------------------------------------------------------------
# Per-shard two-stage start-node candidate scan (the at-scale path)
# ---------------------------------------------------------------------------


@jax.jit
def _vprecand(valid, mult, thr):
    """Per-shard cheap-half compaction: candidate LOCAL ids first,
    ascending (zero communication — vmap over the kp axis keeps each
    shard's argsort on its owner device; the sharded twin of
    cycles.start_nodes._precand_order)."""

    def one(valid_l, mult_l):
        pre = valid_l & (mult_l > thr)
        return jnp.argsort(~pre, stable=True), jnp.sum(pre)

    return jax.vmap(one)(valid, mult)


@jax.jit
def _vcand_refine(outv, inv, ids, gid_base):
    """indeg ≥ 2 & no-self-loop for small per-shard local-id sets, read
    entirely from the validity-TAGGED local adjacency rows (an in-entry
    ≥ 0 IS a valid in-neighbor — no full-graph 4N random validity
    gather)."""

    def one(outv_l, inv_l, ids_l, base_l):
        slots = ids_l * 4
        gids = base_l + ids_l
        indeg = jnp.zeros(ids_l.shape, jnp.int32)
        self_loop = jnp.zeros(ids_l.shape, bool)
        for b in range(4):
            indeg = indeg + (inv_l[slots + b] >= 0)
            ob = outv_l[slots + b]
            self_loop = self_loop | (jnp.where(ob <= -2, -2 - ob, ob) == gids)
        return (indeg >= 2) & ~self_loop

    return jax.vmap(one)(outv, inv, ids, gid_base)


def sharded_candidate_ids(
    sg: ShardedDBG, valid, outv, inv, threshold_multiplicity: int
) -> np.ndarray:
    """Start-node candidates (ascending GLOBAL ids) over the sharded
    graph — ≙ CycleFinder::ChunkStartNodes' static predicate
    (src/cycle_finder.cpp:398-411), evaluated per shard with zero O(N)
    collectives and candidate-proportional downloads: stage 1 compacts
    ``valid & mult > thr`` per shard (device argsort), stage 2 refines
    the survivors' in/out slots against the validity TAGS."""
    kp, T = sg.kmers.shape
    order, counts = _vprecand(
        valid, sg.mult, jnp.asarray(threshold_multiplicity, sg.mult.dtype)
    )
    counts_h = host_replicated(sg.mesh, counts)
    c_max = int(counts_h.max())
    if c_max == 0:
        return np.empty(0, dtype=np.int64)
    c_pad = min(_sbucket(c_max), T)
    ids = order[:, :c_pad].astype(jnp.int32)
    gid_base = (jnp.arange(kp, dtype=jnp.int32) * T)[:, None]
    keep = _vcand_refine(outv, inv, ids, gid_base)
    ids_h = host_replicated(sg.mesh, ids)
    keep_h = host_replicated(sg.mesh, keep)
    res = []
    for s in range(kp):
        c = int(counts_h[s])
        sel = ids_h[s, :c][keep_h[s, :c]]
        res.append(np.int64(s) * T + np.sort(sel).astype(np.int64))
    return np.concatenate(res) if res else np.empty(0, dtype=np.int64)


@functools.partial(jax.jit, static_argnames=("mesh", "route_cap"))
def frontier_step(
    mesh: Mesh,
    out: jax.Array,  # [kp, 4T] flat adjacency, validity-TAGGED or raw
    frontier: jax.Array,  # int32 [Q] global ids (replicated), -1 dead
    route_cap: int = 1 << 14,
):
    """One distributed BFS expansion: global ids -> all out-neighbor
    entries, exactly as stored.

    With a ``tag_adjacency``-tagged adjacency the caller reads target
    validity straight off each entry (``>= 0`` valid, ``<= -2`` is
    ``-2 - gid`` of an invalid target, ``-1`` absent) — NO validity
    collective runs here (the r4 version all-gathered the full
    ``[kp*T]`` valid mask per call: ~1 GB broadcast per hop at 1B
    nodes, VERDICT r4 #1). With the raw (untagged) adjacency this is an
    unfiltered expansion. Wire cost: one Q-id route + one 4Q-entry
    route back over kp.

    Returns int32 [Q, 4] of adjacency entries (-1 for dead lanes).
    """
    kp = mesh.shape["kp"]
    T = out.shape[1] // 4

    def step(out_l, frontier_l):
        out_l = out_l[0]  # flat [4T]
        q = frontier_l
        n = q.shape[0]
        owner = jnp.where(q >= 0, q // T, kp).astype(jnp.int32)
        order = jnp.argsort(owner, stable=True)
        q_sorted = q[order]
        owner_sorted = owner[order]
        bounds = jnp.searchsorted(owner_sorted, jnp.arange(kp + 1, dtype=jnp.int32))
        starts, ends = bounds[:kp], bounds[1:]
        col = jax.lax.broadcasted_iota(jnp.int32, (kp, route_cap), 1)
        idx = starts[:, None] + col
        live = idx < ends[:, None]
        idx_c = jnp.minimum(idx, n - 1)
        send = jnp.where(live, q_sorted[idx_c], -1)

        recv = jax.lax.all_to_all(send[None], "kp", 1, 1, tiled=False)[0]
        flat = recv.reshape(-1)
        loc = jnp.where(flat >= 0, flat % T, 0)
        nbrs = out_l[(loc * 4)[:, None] + jnp.arange(4, dtype=jnp.int32)]  # [kp*cap, 4]
        res = jnp.where((flat >= 0)[:, None], nbrs, -1)
        back = jax.lax.all_to_all(
            res.reshape(kp, route_cap, 4)[None], "kp", 1, 1, tiled=False
        )[0]
        out_sorted = jnp.full((n, 4), -1, dtype=jnp.int32)
        out_sorted = out_sorted.at[
            jnp.where(live, idx_c, n).reshape(-1)
        ].set(back.reshape(-1, 4), mode="drop")
        return jnp.full((n, 4), -1, jnp.int32).at[order].set(out_sorted)

    fn = shard_map(
        step,
        mesh=mesh,
        in_specs=(P(None, "kp"), P()),
        out_specs=P(),
        check_vma=False,
    )
    return fn(out.reshape(1, -1), frontier)


def sharded_dbg_to_dbg(sg: ShardedDBG):
    """Compact a ShardedDBG into a single-device ``graph.dbg.DBG``.

    Shards own contiguous sorted k-mer ranges, so the concatenated live
    rows are globally sorted; global ids (shard*T + local) are remapped to
    compact ranks. Used when the distributed build feeds the host-side
    combinatorial stages (the reference pipeline shape: heavy build on the
    mesh, small downstream on one device).
    """
    from mcaat_tpu.graph.dbg import DBG

    kmers, mult, out, valid, in_ = sg.to_single_device()
    live = kmers != int(SENTINEL)
    new_of_old = np.where(live, np.cumsum(live) - 1, -1).astype(np.int32)

    def remap(adj):
        a = adj[live]
        return np.where(a >= 0, new_of_old[np.maximum(a, 0)], -1).astype(np.int32)

    return DBG(
        k=sg.k,
        kmers=jnp.asarray(kmers[live]),
        mult=jnp.asarray(mult[live].astype(np.int32)),
        out=jnp.asarray(remap(out).reshape(-1)),
        in_=jnp.asarray(remap(in_).reshape(-1)),
        valid=jnp.asarray(valid[live]),
    )
