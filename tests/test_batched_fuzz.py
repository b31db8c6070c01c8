"""Device batched fuzz vs the host bit-parallel implementation."""

import numpy as np
import pytest

import jax.numpy as jnp

from mcaat_tpu.report.batched_fuzz import (
    encode_batch,
    lcs_batch,
    pairwise_ratio_matrix,
    partial_ratio_pairs,
    ratio_batch,
)
from mcaat_tpu.report.fuzz import lcs_length, partial_ratio, ratio


def rand_dna(rng, n):
    return "".join("ACGT"[i] for i in rng.integers(0, 4, size=n))


@pytest.mark.parametrize("seed", range(4))
def test_lcs_batch_matches_host(seed):
    rng = np.random.default_rng(seed)
    a_list = [rand_dna(rng, int(rng.integers(0, 64))) for _ in range(40)]
    b_list = [rand_dna(rng, int(rng.integers(0, 64))) for _ in range(40)]
    a_c, a_l = encode_batch(a_list)
    b_c, b_l = encode_batch(b_list)
    got = np.asarray(lcs_batch(jnp.asarray(a_c), jnp.asarray(a_l),
                               jnp.asarray(b_c), jnp.asarray(b_l)))
    for i, (a, b) in enumerate(zip(a_list, b_list)):
        assert got[i] == lcs_length(a, b), (a, b)


def test_ratio_batch_matches_host():
    rng = np.random.default_rng(9)
    a_list = [rand_dna(rng, int(rng.integers(1, 60))) for _ in range(30)]
    b_list = [rand_dna(rng, int(rng.integers(1, 60))) for _ in range(30)]
    a_c, a_l = encode_batch(a_list)
    b_c, b_l = encode_batch(b_list)
    got = np.asarray(ratio_batch(jnp.asarray(a_c), jnp.asarray(a_l),
                                 jnp.asarray(b_c), jnp.asarray(b_l)))
    for i, (a, b) in enumerate(zip(a_list, b_list)):
        assert abs(got[i] - ratio(a, b)) < 1e-4


def test_pairwise_matrix():
    strings = ["ACGTACGT", "ACGTACGA", "TTTTTTTT"]
    m = pairwise_ratio_matrix(strings)
    assert m.shape == (3, 3)
    for i in range(3):
        assert m[i, i] == 100.0
        for j in range(3):
            assert abs(m[i, j] - ratio(strings[i], strings[j])) < 1e-4


def test_partial_ratio_pairs_matches_host():
    rng = np.random.default_rng(4)
    shorts = [rand_dna(rng, int(rng.integers(5, 30))) for _ in range(10)]
    longs = [rand_dna(rng, int(rng.integers(30, 60))) for _ in range(10)]
    # plant one true substring case
    longs[0] = rand_dna(rng, 10) + shorts[0] + rand_dna(rng, 10)
    got = partial_ratio_pairs(shorts, longs)
    assert got[0] == 100.0
    for i in range(10):
        assert abs(got[i] - partial_ratio(shorts[i], longs[i])) < 1e-4


def _lcs_cases(case):
    """(a, b) string lists for the parametrized lcs/ratio cases."""
    if case == "identical_and_empty":
        return (
            ["ACGTACGTACGTACGTACGTACGT", "", "AAAA", ""],
            ["ACGTACGTACGTACGTACGTACGT", "ACGT", "TTTT", ""],
        )
    rng = np.random.default_rng(case)
    return (
        [rand_dna(rng, int(rng.integers(5, 65))) for _ in range(case)],
        [rand_dna(rng, int(rng.integers(5, 65))) for _ in range(case)],
    )


@pytest.mark.parametrize("case", ["identical_and_empty", 1, 127, 1025])
def test_lcs_and_ratio_batch_cases(case):
    """Identical, empty and odd batch sizes score exactly like the host."""
    a_list, b_list = _lcs_cases(case)
    a_c, a_l = encode_batch(a_list)
    b_c, b_l = encode_batch(b_list)
    lcs = np.asarray(lcs_batch(a_c, a_l, b_c, b_l))
    r = np.asarray(ratio_batch(a_c, a_l, b_c, b_l))
    assert lcs.shape == r.shape == (len(a_list),)
    for i, (a, b) in enumerate(zip(a_list, b_list)):
        assert lcs[i] == lcs_length(a, b), (a, b)
        assert r[i] == np.float32(ratio(a, b)), (a, b)


def test_ratio_batch_is_one_plain_program():
    """ratio_batch is a single jitted XLA program on every backend: no
    platform branch and no custom kernel call in its lowering."""
    import importlib.util

    a_c, a_l = encode_batch(["ACGT", "GATTACA"])
    text = ratio_batch.lower(a_c, a_l, a_c, a_l).as_text()
    assert "custom_call" not in text
    assert importlib.util.find_spec("mcaat_tpu.report.pallas_dp") is None


def test_partial_ratio_pairs_equal_lengths():
    """Equal-length pairs score the plain ratio (no clipped windows),
    exactly like report.fuzz.partial_ratio."""
    rng = np.random.default_rng(12)
    shorts = ["AC", "ACGTT"] + [rand_dna(rng, 30) for _ in range(8)]
    longs = ["CA", "TTGCA"] + [rand_dna(rng, 30) for _ in range(8)]
    got = partial_ratio_pairs(shorts, longs)
    for i, (a, b) in enumerate(zip(shorts, longs)):
        assert got[i] == np.float32(partial_ratio(a, b)), (a, b)
