"""Batched device-side similarity scoring (rapidfuzz semantics).

The north-star design calls for the RapidFuzz-style edit-distance scoring
to run as batched DP kernels on device (BASELINE.json). Strings here are
spacers/repeats ≤ 64 bp, so Hyyrö's bit-parallel LCS fits one 64-bit
row — kept as a pair of uint32 words, so the hot loop stays 32-bit. Each
batch lane scores one pair per scan step; a [B]-batch of pairs runs in a
single ``lax.scan`` over the query length.

``ratio``   = 100 * 2*LCS(a,b) / (|a|+|b|)      (indel distance)
``partial_ratio`` = max ratio of the shorter string against every
alignment window of the longer — windows are expanded into extra batch
lanes, so the whole all-pairs × all-windows workload is one kernel call.

Exact parity with the host implementation (``report.fuzz``) is tested in
``tests/test_batched_fuzz.py``.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np

MAXLEN = 64  # bits in the DP row (2 x uint32)


def encode_batch(strings: list[str], maxlen: int = MAXLEN):
    """ASCII strings -> (codes uint8 [B, maxlen], lengths int32 [B]).

    DNA-centric 2-bit coding with non-ACGT collapsed to T — identical to
    the pipeline's base coding, which is also what the host fuzz sees.
    """
    lut = np.full(256, 3, dtype=np.uint8)
    for i, b in enumerate("ACGT"):
        lut[ord(b)] = i
        lut[ord(b.lower())] = i
    codes = np.zeros((len(strings), maxlen), dtype=np.uint8)
    lengths = np.zeros(len(strings), dtype=np.int32)
    for i, s in enumerate(strings):
        raw = np.frombuffer(s.encode("ascii"), dtype=np.uint8)[:maxlen]
        codes[i, : len(raw)] = lut[raw]
        lengths[i] = len(raw)
    return codes, lengths


@jax.jit
def _match_masks(codes: jax.Array, lengths: jax.Array):
    """Per-lane match masks: [B, 4, 2] uint32 (lo word, hi word).

    Pure integer where+sum per base (bits are disjoint, so sum == OR),
    with no [B, L, 4] one-hot intermediate.
    """
    B, L = codes.shape
    pos = jnp.arange(L)
    live = pos[None, :] < lengths[:, None]
    lo_bit = jnp.where((pos < 32)[None, :] & live, jnp.uint32(1) << (pos % 32).astype(jnp.uint32), 0)
    hi_bit = jnp.where((pos >= 32)[None, :] & live, jnp.uint32(1) << (pos % 32).astype(jnp.uint32), 0)
    los = []
    his = []
    for c in range(4):
        m = codes == c
        los.append(jnp.sum(jnp.where(m, lo_bit, jnp.uint32(0)), axis=1))
        his.append(jnp.sum(jnp.where(m, hi_bit, jnp.uint32(0)), axis=1))
    return jnp.stack(
        [jnp.stack(los, axis=1), jnp.stack(his, axis=1)], axis=2
    ).astype(jnp.uint32)


def _add64(alo, ahi, blo, bhi):
    lo = alo + blo
    carry = (lo < alo).astype(jnp.uint32)
    return lo, ahi + bhi + carry


def _sub64(alo, ahi, blo, bhi):
    lo = alo - blo
    borrow = (alo < blo).astype(jnp.uint32)
    return lo, ahi - bhi - borrow


@jax.jit
def lcs_batch(
    a_codes: jax.Array, a_lengths: jax.Array,
    b_codes: jax.Array, b_lengths: jax.Array,
) -> jax.Array:
    """LCS length per lane; a is the bit-parallel row (|a| ≤ 64)."""
    B = a_codes.shape[0]
    masks = _match_masks(a_codes, a_lengths)  # [B, 4, 2]
    la = a_lengths.astype(jnp.uint32)
    # all-ones masks over la bits, as (lo, hi) words; shift amounts are
    # clamped below 32 before shifting (<<32 is undefined)
    lo_sh = jnp.minimum(la, 31)
    full_lo = jnp.where(
        la >= 32, jnp.uint32(0xFFFFFFFF), (jnp.uint32(1) << lo_sh) - 1
    )
    ha = jnp.where(la > 32, la - 32, 0)
    hi_sh = jnp.minimum(ha, 31)
    full_hi = jnp.where(
        ha >= 32, jnp.uint32(0xFFFFFFFF), (jnp.uint32(1) << hi_sh) - 1
    )

    lane = jnp.arange(B)

    def step(carry, j):
        slo, shi = carry
        c = b_codes[:, j].astype(jnp.int32)
        mlo = masks[lane, c, 0]
        mhi = masks[lane, c, 1]
        ulo, uhi = slo & mlo, shi & mhi
        plo, phi = _add64(slo, shi, ulo, uhi)
        qlo, qhi = _sub64(slo, shi, ulo, uhi)
        nlo, nhi = plo | qlo, phi | qhi
        live = j < b_lengths
        slo = jnp.where(live, nlo & full_lo, slo)
        shi = jnp.where(live, nhi & full_hi, shi)
        return (slo, shi), None

    init = (full_lo, full_hi)
    (slo, shi), _ = jax.lax.scan(step, init, jnp.arange(b_codes.shape[1]))
    ones = _popcount(slo & full_lo) + _popcount(shi & full_hi)
    return (a_lengths - ones.astype(jnp.int32)).astype(jnp.int32)


def _popcount(x: jax.Array) -> jax.Array:
    x = x - ((x >> 1) & jnp.uint32(0x55555555))
    x = (x & jnp.uint32(0x33333333)) + ((x >> 2) & jnp.uint32(0x33333333))
    x = (x + (x >> 4)) & jnp.uint32(0x0F0F0F0F)
    return (x * jnp.uint32(0x01010101)) >> 24


@jax.jit
def ratio_batch(a_codes, a_lengths, b_codes, b_lengths) -> jax.Array:
    """fuzz::ratio per lane, float32 [B] in [0, 100].

    The quotient is taken in float64 and rounded once to float32, which
    is bit-identical to rounding the host's double-precision
    ``report.fuzz.ratio`` on every backend. (XLA's GPU float32 division
    is not correctly rounded: a float32 quotient differed from the host
    in the last bit on about a third of random pairs on an H100.)
    """
    lcs = lcs_batch(a_codes, a_lengths, b_codes, b_lengths)
    total = a_lengths + b_lengths
    score = (
        200.0 * lcs.astype(jnp.float64)
        / jnp.maximum(total, 1).astype(jnp.float64)
    )
    return jnp.where(total > 0, score, 100.0).astype(jnp.float32)


def pairwise_ratio_matrix(strings: list[str]) -> np.ndarray:
    """All-pairs fuzz::ratio for ≤64bp strings, one device call."""
    n = len(strings)
    if n == 0:
        return np.zeros((0, 0), dtype=np.float32)
    codes, lengths = encode_batch(strings)
    ii, jj = np.meshgrid(np.arange(n), np.arange(n), indexing="ij")
    a_c = jnp.asarray(codes[ii.reshape(-1)])
    a_l = jnp.asarray(lengths[ii.reshape(-1)])
    b_c = jnp.asarray(codes[jj.reshape(-1)])
    b_l = jnp.asarray(lengths[jj.reshape(-1)])
    r = ratio_batch(a_c, a_l, b_c, b_l)
    return np.asarray(r).reshape(n, n)


def partial_ratio_pairs(
    shorts: list[str], longs: list[str]
) -> np.ndarray:
    """fuzz::partial_ratio per (shorts[i], longs[i]) pair, one device call.

    Every alignment window (including clipped edges) becomes a lane; the
    per-pair max is reduced on host. Equal-length pairs score the plain
    ratio of the two strings, as ``report.fuzz.partial_ratio`` does.
    """
    assert len(shorts) == len(longs)
    if not shorts:
        return np.zeros((0,), dtype=np.float32)
    a_list, b_list, owner = [], [], []
    for idx, (a, b) in enumerate(zip(shorts, longs)):
        s, l = (a, b) if len(a) <= len(b) else (b, a)
        ls, ll = len(s), len(l)
        if ls == 0 or ls == ll:
            a_list.append(s)
            b_list.append(l)
            owner.append(idx)
            continue
        for start in range(-(ls - 1), max(ll, 1)):
            win = l[max(0, start) : max(0, start + ls)]
            if not win:
                continue
            a_list.append(s)
            b_list.append(win)
            owner.append(idx)
    a_c, a_l = encode_batch(a_list)
    b_c, b_l = encode_batch(b_list)
    r = np.asarray(ratio_batch(
        jnp.asarray(a_c), jnp.asarray(a_l), jnp.asarray(b_c), jnp.asarray(b_l)
    ))
    out = np.zeros(len(shorts), dtype=np.float32)
    for lane, idx in enumerate(owner):
        if len(shorts[idx]) == 0 and len(longs[idx]) == 0:
            out[idx] = 100.0
        out[idx] = max(out[idx], r[lane])
    return out
