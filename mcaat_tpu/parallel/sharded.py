"""Multi-chip sharding: data-parallel reads × k-mer-space-partitioned graph.

The reference is single-node OpenMP with no distributed backend at all
(SURVEY §2.3; its only parallel runtime is ``find_package(OpenMP)``).
This module is the scale-out design:

* mesh axes ``("dp", "kp")`` — ``dp`` shards reads (FASTQ shards stream
  in data-parallel), ``kp`` radix-partitions the k-mer space by the top
  bits of the packed k-mer, so the sorted node table, multiplicities and
  adjacency live distributed over chips (≈1 GB/chip at 1B nodes over 16
  chips, SURVEY §7.3 risk 4).
* k-mer counting: local extraction → bucket by owner (one sort, since
  the owner id *is* the top bits) → ``all_to_all`` over ``kp`` (NCCL
  over the cards' interconnect) → ``all_gather`` over ``dp`` → local
  sort + segment-reduce. Every card reaches every other at the same
  rate, so the mesh follows the algorithm alone.
* query routing (the frontier-exchange primitive for distributed read
  mapping / BFS): queries bucketed by owner, ``all_to_all`` to owner
  shards, local binary search, ``all_to_all`` back, inverse-permute.

Everything is fixed-capacity + sentinel-padded: no dynamic shapes under
``jit``. Overflow of a routing bucket is detected and reported via a
per-step counter (``dropped``) rather than silently lost.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from mcaat_tpu.kmer.count import SENTINEL, count_unique, extract_kmers

shard_map = jax.shard_map


def make_pipeline_mesh(devices=None, dp: int | None = None) -> Mesh:
    """Build a ("dp", "kp") mesh. kp must be a power of two (radix bits)."""
    if devices is None:
        devices = jax.devices()
    n = len(devices)
    if dp is None:
        # prefer kp as large as possible while keeping kp a power of two
        kp = 1 << (n.bit_length() - 1)
        while n % kp:
            kp >>= 1
        dp = n // kp
    kp = n // dp
    if dp * kp != n or kp & (kp - 1):
        raise ValueError(f"cannot build mesh: n={n}, dp={dp}, kp={kp}")
    arr = np.asarray(devices).reshape(dp, kp)
    return Mesh(arr, ("dp", "kp"))


def _owner_shift(k: int, kp: int) -> int:
    return 2 * k - (kp.bit_length() - 1)


def _bucket_by_owner(kmers_flat: jax.Array, kp: int, shift: int, cap: int):
    """Sort + slice into a [kp, cap] send buffer (sentinel-padded).

    Sorting the packed k-mers groups them by owner automatically (the
    owner id is the top bits). Returns (send_buffer, dropped_count).
    """
    s = jnp.sort(kmers_flat)
    owners = jnp.arange(kp, dtype=jnp.int64) << shift
    starts = jnp.searchsorted(s, owners)
    ends = jnp.concatenate(
        [starts[1:], jnp.array([jnp.searchsorted(s, SENTINEL)], dtype=starts.dtype)]
    )
    col = jax.lax.broadcasted_iota(jnp.int32, (kp, cap), 1)
    idx = starts[:, None] + col
    live = idx < ends[:, None]
    idx_c = jnp.minimum(idx, s.shape[0] - 1)
    buf = jnp.where(live, s[idx_c], SENTINEL)
    dropped = jnp.sum(jnp.maximum(ends - starts - cap, 0))
    return buf, dropped


@functools.partial(
    jax.jit, static_argnames=("mesh", "k", "route_cap", "unique_cap")
)
def sharded_count_kmers(
    mesh: Mesh,
    codes: jax.Array,  # uint8 [R, L], sharded over dp rows
    lengths: jax.Array,  # int32 [R]
    k: int,
    route_cap: int = 1 << 16,
    unique_cap: int = 1 << 16,
):
    """Distributed k-mer counting over the ("dp", "kp") mesh.

    Returns (unique [kp*unique_cap] sentinel-padded int64 sharded over kp,
    counts [kp*unique_cap] int32, dropped scalar).
    """
    kp = mesh.shape["kp"]
    dp = mesh.shape["dp"]
    shift = _owner_shift(k, kp)

    def step(codes_local, lengths_local):
        kmers = extract_kmers(codes_local, lengths_local, k).reshape(-1)
        send, dropped = _bucket_by_owner(kmers, kp, shift, route_cap)
        # all_to_all over kp: row i of `recv` is what kp-peer i sent to us
        recv = jax.lax.all_to_all(
            send[None], "kp", split_axis=1, concat_axis=1, tiled=False
        )[0]
        mine = recv.reshape(-1)
        # merge the dp shards of this kp range
        allmine = jax.lax.all_gather(mine, "dp", tiled=True)
        unique, counts, _ = count_unique(allmine)
        unique = unique[:unique_cap]
        counts = counts[:unique_cap]
        dropped = jax.lax.psum(dropped, ("dp", "kp"))
        return unique[None], counts[None], dropped

    # reads are sharded over BOTH axes for extraction (every chip routes
    # its own read slice); kp columns re-merge via the all_to_all, dp rows
    # via the all_gather
    fn = shard_map(
        step,
        mesh=mesh,
        in_specs=(P(("dp", "kp"), None), P(("dp", "kp"))),
        out_specs=(P(None, "kp"), P(None, "kp"), P()),
        check_vma=False,
    )
    unique, counts, dropped = fn(codes, lengths)
    return unique.reshape(-1), counts.reshape(-1), dropped


@functools.partial(jax.jit, static_argnames=("mesh", "k", "route_cap"))
def sharded_lookup(
    mesh: Mesh,
    table: jax.Array,  # int64 [kp * T] sentinel-padded, sharded over kp
    queries: jax.Array,  # int64 [Q], sharded over dp
    k: int,
    route_cap: int = 1 << 15,
):
    """Distributed k-mer → owner-local index lookup (frontier exchange).

    Each query is routed to its owner shard, binary-searched in
    the owner's local table slice, and the (owner-local) hit index is
    routed back; -1 for misses. This is the communication shape of the
    distributed read-mapper and BFS frontier exchange.

    Returns (local_idx int32 [Q] sharded over dp, dropped scalar).
    """
    kp = mesh.shape["kp"]
    shift = _owner_shift(k, kp)

    def step(table_local, queries_local):
        tloc = table_local[0]
        q = queries_local
        n = q.shape[0]
        owner = jnp.where(q != SENTINEL, (q >> shift).astype(jnp.int32), kp)
        # stable sort by owner so we can invert the permutation later
        order = jnp.argsort(owner, stable=True)
        q_sorted = q[order]
        owner_sorted = owner[order]
        bounds = jnp.searchsorted(owner_sorted, jnp.arange(kp + 1, dtype=jnp.int32))
        starts, ends = bounds[:kp], bounds[1:]
        col = jax.lax.broadcasted_iota(jnp.int32, (kp, route_cap), 1)
        idx = starts[:, None] + col
        live = idx < ends[:, None]
        idx_c = jnp.minimum(idx, n - 1)
        send = jnp.where(live, q_sorted[idx_c], SENTINEL)
        dropped = jnp.sum(jnp.maximum(ends - starts - route_cap, 0))

        recv = jax.lax.all_to_all(
            send[None], "kp", split_axis=1, concat_axis=1, tiled=False
        )[0]
        flat = recv.reshape(-1)
        method = "sort" if flat.size >= 4096 else "scan"
        pos = jnp.searchsorted(tloc, flat, method=method)
        pos_c = jnp.minimum(pos, tloc.shape[0] - 1)
        hit = (flat != SENTINEL) & (tloc[pos_c] == flat)
        res = jnp.where(hit, pos_c, -1).astype(jnp.int32)
        # route results back: inverse all_to_all
        back = jax.lax.all_to_all(
            res.reshape(kp, route_cap)[None], "kp", split_axis=1, concat_axis=1,
            tiled=False,
        )[0]
        # scatter back into query order (dead lanes target index n -> dropped)
        out_sorted = jnp.full((n,), -1, dtype=jnp.int32)
        flat_idx = (starts[:, None] + col).reshape(-1)
        flat_live = live.reshape(-1)
        out_sorted = out_sorted.at[
            jnp.where(flat_live, flat_idx, n)
        ].set(back.reshape(-1), mode="drop")
        out = jnp.zeros((n,), jnp.int32).at[order].set(out_sorted)
        return out, jax.lax.psum(dropped, ("dp", "kp"))

    fn = shard_map(
        step,
        mesh=mesh,
        in_specs=(P(None, "kp"), P("dp")),
        out_specs=(P("dp"), P()),
        check_vma=False,
    )
    table2 = table.reshape(1, -1)
    return fn(table2, queries)


@functools.partial(
    jax.jit, static_argnames=("mesh", "k", "route_cap", "unique_cap")
)
def sharded_pipeline_step(
    mesh: Mesh,
    codes: jax.Array,
    lengths: jax.Array,
    k: int,
    route_cap: int = 1 << 14,
    unique_cap: int = 1 << 14,
):
    """One full distributed pipeline step (the dry-run "training step").

    Count k-mers across the mesh, then route every read's k-mer back
    through the sharded table (the read-mapping/frontier communication
    pattern), and reduce basic stats. Exercises all_to_all (kp),
    all_gather (dp), and psum (both axes).
    """
    unique, counts, dropped_a = sharded_count_kmers(
        mesh, codes, lengths, k, route_cap=route_cap, unique_cap=unique_cap
    )
    kmers = extract_kmers(codes, lengths, k)
    flat = kmers.reshape(-1)
    idx, dropped_b = sharded_lookup(mesh, unique, flat, k, route_cap=route_cap)
    n_unique = jnp.sum(unique != SENTINEL)
    n_hit = jnp.sum(idx >= 0)
    total_mult = jnp.sum(counts)
    return {
        "n_unique": n_unique,
        "n_hit": n_hit,
        "total_mult": total_mult,
        "dropped": dropped_a + dropped_b,
    }
