"""Native C++ runtime parity with the Python implementations."""

import numpy as np
import pytest

from mcaat_tpu.native import (
    enumerate_cycles,
    native_available,
    parse_fastx,
    parse_fastx_batch,
)


@pytest.fixture(autouse=True)
def _needs_native():
    if not native_available():
        pytest.skip("native library unavailable (no C++ compiler)")


def test_parse_fastq_matches_python(tmp_path):
    p = tmp_path / "r.fq"
    p.write_text("@r1\nACGT\n+\nIIII\n@r2\nGGCCTT\n+\nIIIIII\n")
    assert parse_fastx(str(p)) == ["ACGT", "GGCCTT"]
    codes, lengths = parse_fastx_batch(str(p))
    assert lengths.tolist() == [4, 6]
    assert codes[0, :4].tolist() == [0, 1, 2, 3]
    assert codes[1, :6].tolist() == [2, 2, 1, 1, 3, 3]


def test_parse_fasta_multiline(tmp_path):
    p = tmp_path / "r.fa"
    p.write_text(">a\nACGT\nTT\n>b\nGG\n")
    assert parse_fastx(str(p)) == ["ACGTTT", "GG"]


def test_parse_gzip(tmp_path):
    import gzip

    p = tmp_path / "r.fq.gz"
    with gzip.open(p, "wt") as fh:
        fh.write("@r1\nACGTAC\n+\nIIIIII\n")
    assert parse_fastx(str(p)) == ["ACGTAC"]


def test_parse_non_acgt_becomes_t(tmp_path):
    p = tmp_path / "r.fq"
    p.write_text("@r1\nANGN\n+\nIIII\n")
    assert parse_fastx(str(p)) == ["ATGT"]


def test_enumerate_matches_python():
    from mcaat_tpu.cycles.finder import CycleFinder
    from test_cycles import two_loop_graph

    g = two_loop_graph()
    out = np.asarray(g.out).reshape(-1, 4)
    in_ = np.asarray(g.in_).reshape(-1, 4)
    valid = np.asarray(g.valid)
    mult = np.asarray(g.mult)

    native = enumerate_cycles(
        out, in_, valid, mult, np.array([0], dtype=np.int64), 3, 10
    )
    finder = CycleFinder(
        out=out, in_=in_, valid=valid, mult=mult,
        cycle_min_length=3, cycle_max_length=10,
    )
    python = {0: finder.find_cycles_from(0)}
    assert set(map(tuple, native[0])) == set(map(tuple, python[0]))


def test_enumerate_visited_suppression():
    from test_cycles import two_loop_graph

    g = two_loop_graph()
    native = enumerate_cycles(
        np.asarray(g.out).reshape(-1, 4), np.asarray(g.in_).reshape(-1, 4), np.asarray(g.valid),
        np.asarray(g.mult), np.array([0, 1], dtype=np.int64), 3, 10,
    )
    assert 0 in native and len(native[0]) >= 2
    assert 1 not in native  # visited-suppressed


def test_enumerate_mult_ratio():
    from test_prune import make_graph

    edges = {0: [1], 1: [2], 2: [0]}
    g = make_graph(edges, 3, mult=[100000, 100, 100])
    native = enumerate_cycles(
        np.asarray(g.out).reshape(-1, 4), np.asarray(g.in_).reshape(-1, 4), np.asarray(g.valid),
        np.asarray(g.mult), np.array([0], dtype=np.int64), 1, 10,
    )
    assert native.get(0, []) == []


def test_native_poa_consensus_parity():
    """Native POA == Python POA, byte-identical (tie-breaking ported
    line for line; native/mcaat_host.cpp mcaat_poa_consensus)."""
    import numpy as np
    import pytest

    from mcaat_tpu.native import native_available, poa_consensus
    from mcaat_tpu.poa import compute_consensus_py

    if not native_available():
        pytest.skip("native library not built")
    rng = np.random.default_rng(3)
    for trial in range(8):
        base = "".join("ACGT"[i] for i in rng.integers(0, 4, size=60))
        group = []
        for _ in range(int(rng.integers(2, 6))):
            s = list(base)
            for _m in range(int(rng.integers(0, 6))):
                p = int(rng.integers(0, len(s)))
                op = int(rng.integers(0, 3))
                if op == 0:
                    s[p] = "ACGT"[int(rng.integers(0, 4))]
                elif op == 1 and len(s) > 30:
                    del s[p]
                else:
                    s.insert(p, "ACGT"[int(rng.integers(0, 4))])
            group.append("".join(s))
        want = compute_consensus_py(group)
        got = poa_consensus(group)
        assert got == want, (trial, group)
    assert poa_consensus([]) == ""
    assert poa_consensus(["ACGT"]) == compute_consensus_py(["ACGT"])
