"""Tests for the auxiliary components: Filters, protospacers, phage
curation, POA consensus, export IO, checkpointing, profiling."""

import numpy as np
import pytest

from mcaat_tpu.graph.dbg import HostDBG


def toy_host_graph(labels: dict[int, str], edges: dict[int, list[int]], mult=None):
    """HostDBG stub with explicit labels (bypasses packed k-mers)."""
    n = len(labels)
    out = np.full((n, 4), -1, dtype=np.int32)
    in_ = np.full((n, 4), -1, dtype=np.int32)
    out_slot = [0] * n
    in_slot = [0] * n
    for u, vs in edges.items():
        for v in vs:
            out[u, out_slot[u]] = v
            out_slot[u] += 1
            in_[v, in_slot[v]] = u
            in_slot[v] += 1
    g = HostDBG(
        k=len(next(iter(labels.values()))),
        kmers=np.arange(n, dtype=np.int64),
        mult=np.full(n, 10, dtype=np.int32) if mult is None else np.asarray(mult, np.int32),
        out=out,
        in_=in_,
        valid=np.ones(n, dtype=bool),
    )
    g.label = lambda node, _labels=labels: _labels[int(node)]  # type: ignore
    return g


# ---- POA consensus ---------------------------------------------------------


def test_poa_identical_sequences():
    from mcaat_tpu.poa import compute_consensus

    assert compute_consensus(["ACGTACGT"] * 3) == "ACGTACGT"


def test_poa_majority_vote():
    from mcaat_tpu.poa import compute_consensus

    seqs = ["ACGTACGTAC", "ACGTACGTAC", "ACGTTCGTAC"]
    assert compute_consensus(seqs) == "ACGTACGTAC"


def test_poa_empty():
    from mcaat_tpu.poa import compute_consensus

    assert compute_consensus([]) == ""
    assert compute_consensus(["ACGT"]) == "ACGT"


# ---- Filters ---------------------------------------------------------------


def test_filters_requires_multiple_cycles():
    from mcaat_tpu.systems.filters import Filters

    labels = {i: "A" * 23 for i in range(5)}
    g = toy_host_graph(labels, {})
    filters = Filters(g, {0: [[0, 1, 2]]})  # only one cycle
    arrays, n = filters.list_arrays()
    assert arrays == {} and n == 0


# ---- Protospacers ----------------------------------------------------------


def test_protospacer_in_out_discovery():
    from mcaat_tpu.protospacers import IsolateProtospacers

    # cycle {1,2,3}; node 0 points in; node 4 is pointed to
    labels = {i: "ACGT" for i in range(5)}
    g = toy_host_graph(labels, {0: [1], 1: [2], 2: [3, 4], 3: [1]})
    iso = IsolateProtospacers(graph=g, cycle_nodes={1: {1, 2, 3}}, cycle_to_group={1: 99})
    in_map, out_map = iso.get_protospacer_nodes()
    assert in_map == {1: {0}}
    assert out_map == {1: {4}}


def test_protospacer_paths_roundtrip(tmp_path):
    from mcaat_tpu.protospacers import IsolateProtospacers

    paths = {7: {3: [[1, 2, 3], [9, 10]]}, 8: {5: [[4, 5]]}}
    p = tmp_path / "paths.txt"
    IsolateProtospacers.write_paths_to_file(paths, str(p))
    back = IsolateProtospacers.read_paths_from_file(str(p))
    assert back == paths


def test_contains_subsequence():
    from mcaat_tpu.protospacers import _contains_subsequence

    assert _contains_subsequence([1, 2, 3, 4], [2, 3])
    assert not _contains_subsequence([1, 2, 3, 4], [2, 4])
    assert not _contains_subsequence([1, 2], [1, 2, 3])


# ---- Phage curator ---------------------------------------------------------


def test_phage_beam_search_simple_path():
    from mcaat_tpu.phage import PhageCurator

    # chain 0 -> 1 -> 2 -> 3 -> 4
    labels = {i: "ACGTA"[i % 5] * 23 for i in range(5)}
    g = toy_host_graph(labels, {i: [i + 1] for i in range(4)}, mult=[10] * 5)
    curator = PhageCurator(graph=g)
    paths = curator.beam_search_paths_avoiding(
        0, lower=3, higher=4, forbidden=set(), beam_width=5,
        min_mult=1.0, max_mult=100.0,
    )
    assert paths  # found at least one path of depth in [3, 4]
    assert all(3 <= len(p) - 1 <= 4 for p in paths)


def test_phage_beam_respects_forbidden_and_mult():
    from mcaat_tpu.phage import PhageCurator

    labels = {i: "A" * 23 for i in range(4)}
    g = toy_host_graph(labels, {0: [1], 1: [2], 2: [3]}, mult=[10, 10, 1, 10])
    curator = PhageCurator(graph=g)
    # node 2 has mult 1 -> blocked
    paths = curator.beam_search_paths_avoiding(
        0, 2, 3, set(), 5, min_mult=1.0, max_mult=100.0
    )
    assert paths == []


def test_phage_top_paths_selection():
    from mcaat_tpu.phage import PhageCurator

    labels = {i: "A" * 23 for i in range(6)}
    g = toy_host_graph(labels, {}, mult=[10, 10, 10, 50, 50, 50])
    curator = PhageCurator(graph=g)
    paths = [[0, 1, 2], [3, 4, 5]]
    # window [min=5, max=20]: avg 10 -> delta 0; avg 50 -> delta 30
    best = curator.get_top_paths_from_beam_paths(paths, max_val=20, min_val=5, top_n=1)
    assert best == [[0, 1, 2]]


# ---- export IO -------------------------------------------------------------


def test_cycles_json_roundtrip(tmp_path):
    from mcaat_tpu.io.export import read_cycles, write_cycles

    cycles = {5: [[1, 2, 3], [4, 5]], 9: [[7]]}
    p = tmp_path / "cycles.json"
    write_cycles(str(p), cycles)
    assert read_cycles(str(p)) == cycles


def test_gfa_export(tmp_path):
    from mcaat_tpu.io.export import write_nodes_gfa

    labels = {0: "ACGT", 1: "CGTA", 2: "GTAC"}
    g = toy_host_graph(labels, {0: [1], 1: [2]})
    g.valid[2] = False
    p = tmp_path / "g.gfa"
    write_nodes_gfa(str(p), g)
    text = p.read_text()
    assert "S\t0\t*" in text and "S\t1\t*" in text
    assert "S\t2" not in text  # invalid node excluded
    assert "L\t0\t+\t1\t+\t0M" in text
    assert "L\t1" not in text  # link to invalid node excluded


def test_path_writer(tmp_path):
    from mcaat_tpu.io.export import PathWriter

    labels = {0: "AAAA", 1: "CCCC"}
    g = toy_host_graph(labels, {0: [1]})
    out_dir = tmp_path / "genome1"
    PathWriter(g, [0, 1], str(out_dir))
    assert (out_dir / "cycles.txt").read_text() == "AAAA CCCC \n"
    assert (out_dir / "labels.txt").read_text() == "0 1 \n"


def test_node_counter():
    from mcaat_tpu.io.export import NodeCounter

    nc = NodeCounter({0: [10, 11], 1: [20, 21, 22]})
    counts = nc.get_counts()
    assert counts[0][0] == 2  # position 0 seen in both cycles
    assert counts[2][0] == 1
    nc.filter_only_unique_nodes()
    assert list(nc.get_counts()) == [2]


# ---- checkpointing ---------------------------------------------------------


def test_graph_checkpoint_roundtrip(tmp_path):
    import jax.numpy as jnp

    from mcaat_tpu.checkpoint import load_graph, save_graph
    from mcaat_tpu.graph.dbg import build_dbg_from_reads
    from mcaat_tpu.io.fastq import encode_sequences

    batch = encode_sequences(["ACGTACGTTGCAACGGTCCAGTTTACGCATCG"] * 2)
    g = build_dbg_from_reads(batch.codes, batch.lengths, k=23)
    p = tmp_path / "graph.npz"
    save_graph(str(p), g)
    g2 = load_graph(str(p))
    assert g2.k == g.k
    assert (np.asarray(g2.kmers) == np.asarray(g.kmers)).all()
    assert (np.asarray(g2.out) == np.asarray(g.out)).all()


def test_cycles_reads_systems_checkpoint(tmp_path):
    from mcaat_tpu.checkpoint import (
        load_cycles,
        load_reads,
        load_systems,
        save_cycles,
        save_reads,
        save_systems,
    )
    from mcaat_tpu.pipeline import FoundSystem

    cycles = {3: [[1, 2], [4, 5, 6]]}
    save_cycles(str(tmp_path / "c.json"), cycles)
    assert load_cycles(str(tmp_path / "c.json")) == cycles

    reads = [[1, 2, 3], [-1, 5]]
    save_reads(str(tmp_path / "r.json"), reads)
    assert load_reads(str(tmp_path / "r.json")) == reads

    systems = [FoundSystem("SEQ", "REP", ["S1", "S2"], 0.9, 0.8)]
    save_systems(str(tmp_path / "s.json"), systems)
    loaded = load_systems(str(tmp_path / "s.json"))
    assert loaded[0].repeat == "REP" and loaded[0].spacers == ["S1", "S2"]


# ---- profiling -------------------------------------------------------------


def test_profiler_stages():
    from mcaat_tpu.utils.profiling import Profiler

    prof = Profiler()
    with prof.stage("build", nodes=100):
        pass
    prof.count("build", edges=50)
    assert prof.stages[0].counters == {"nodes": 100, "edges": 50}
    assert "build" in prof.report()
    assert "build" in prof.to_json()


# ---- band-filtered neighbors (graph_generic_func parity) --------------------


def test_band_neighbor_lists():
    # node 0 (mult 10) -> {1 (mult 5), 2 (mult 12), 3 (mult 13)}:
    # band [5, 12] keeps 1 and 2, drops 3; incoming mirrors it
    g = toy_host_graph(
        {0: "AAA", 1: "AAC", 2: "AAG", 3: "AAT"},
        {0: [1, 2, 3], 1: [0], 2: [0], 3: [0]},
        mult=[10, 5, 12, 13],
    )
    assert g.band_outgoing_list(0) == [1, 2]
    assert g.band_incoming_list(0) == [1, 2]
    # invalid node yields nothing (ref graph_generic_func.cpp:9-11)
    g.valid[0] = False
    assert g.band_outgoing_list(0) == []
    # invalid neighbors are dropped before the band test
    g.valid[0] = True
    g.valid[2] = False
    assert g.band_outgoing_list(0) == [1]


def test_band_neighbors_device_matches_host():
    import jax.numpy as jnp

    from mcaat_tpu.graph.dbg import _band_neighbors

    g = toy_host_graph(
        {0: "AAA", 1: "AAC", 2: "AAG", 3: "AAT"},
        {0: [1, 2, 3], 1: [0, 2], 2: [0], 3: [0]},
        mult=[10, 5, 12, 13],
    )
    ids = jnp.asarray(np.arange(4, dtype=np.int32))
    dev = _band_neighbors(
        jnp.asarray(g.out.reshape(-1)),
        jnp.asarray(g.valid),
        jnp.asarray(g.mult),
        ids,
    )
    for node in range(4):
        got = sorted(int(v) for v in np.asarray(dev[node]) if v >= 0)
        assert got == g.band_outgoing_list(node)


# ---- node counter (node_counter.h intent) -----------------------------------


def test_node_counter():
    from mcaat_tpu.cycles.node_counter import count_nodes, unique_nodes

    cycles = {7: [1, 2, 3, 2], 9: [3, 4]}
    assert count_nodes(cycles) == {1: 1, 2: 2, 3: 2, 4: 1}
    assert unique_nodes(cycles) == {1: 1, 4: 1}
    assert count_nodes({}) == {}


# ---- --threads wiring (≙ src/main.cpp:292-294) ------------------------------


def test_threads_drives_ordering_pool(monkeypatch):
    """--threads must bound the ordering pool: 1 forces the serial loop,
    MCAAT_ORDERING_PROCS still overrides, 0 resets to the cpu default."""
    import os

    from mcaat_tpu import pipeline as pl

    monkeypatch.delenv("MCAAT_ORDERING_PROCS", raising=False)
    try:
        pl.configure_threads(1)
        assert pl._ordering_worker_count() == 1
        pl.configure_threads(3)
        assert pl._ordering_worker_count() == 3
        monkeypatch.setenv("MCAAT_ORDERING_PROCS", "5")
        assert pl._ordering_worker_count() == 5
        monkeypatch.delenv("MCAAT_ORDERING_PROCS")
        pl.configure_threads(0)
        assert pl._ordering_worker_count() == (os.cpu_count() or 1)
    finally:
        pl.configure_threads(0)


def test_run_pipeline_applies_settings_threads(tmp_path, monkeypatch):
    import os
    import sys

    sys.path.insert(0, os.path.join(os.path.dirname(__file__)))
    from synthetic import make_metagenome, write_fastq

    from mcaat_tpu import pipeline as pl
    from mcaat_tpu.settings import Settings

    meta = make_metagenome(seed=5, n_arrays=1, n_spacers=3, coverage=25.0)
    f = tmp_path / "r.fq"
    write_fastq(str(f), meta["reads"])
    monkeypatch.delenv("MCAAT_ORDERING_PROCS", raising=False)
    s = Settings(
        input_files=str(f), output_file=str(tmp_path / "o.txt"), threads=1
    )
    try:
        pl.run_pipeline(s, verbose=False)
        assert pl._ORDERING_THREADS == 1
        assert pl._ordering_worker_count() == 1
    finally:
        pl.configure_threads(0)


def test_ordering_pool_worker_failure_raises(monkeypatch):
    """A failing ordering worker raises in the parent: there is no silent
    serial rerun (the workers are spawned, so this goes through the pool)."""
    from mcaat_tpu import pipeline as pl

    monkeypatch.setenv("MCAAT_ORDERING_PROCS", "2")
    monkeypatch.setattr(pl, "_ORDERING_POOL_MIN_SUBPROBLEMS", 1)
    broken = [(None, None, None), (None, None, None)]
    with pytest.raises(TypeError):
        pl._solve_subproblems(None, broken)
