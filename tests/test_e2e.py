"""End-to-end pipeline tests on synthetic metagenomes with planted
CRISPR arrays (BASELINE.json configs 1-2)."""

import numpy as np
import pytest

from mcaat_tpu.pipeline import run_pipeline
from mcaat_tpu.settings import Settings
from synthetic import make_metagenome, write_fasta, write_fastq


def run_on(tmp_path, meta, paired=False, **settings_kw):
    reads = meta["reads"]
    s = Settings(**settings_kw)
    if paired:
        from mcaat_tpu.io.fastq import reverse_complement

        half = len(reads) // 2
        f1 = tmp_path / "r1.fq"
        f2 = tmp_path / "r2.fq"
        write_fastq(str(f1), reads[:half])
        # mate-2 is stored reverse-complemented; the pipeline flips it back
        write_fastq(str(f2), [reverse_complement(r) for r in reads[half:]])
        s.input_files = f"{f1} {f2}"
    else:
        f1 = tmp_path / "r.fq"
        write_fastq(str(f1), reads)
        s.input_files = str(f1)
    s.output_file = str(tmp_path / "CRISPR_Arrays.txt")
    return run_pipeline(s, verbose=False)


def spacers_found(result, planted_spacers):
    """Fraction of planted spacers whose core appears in the report.

    The filter cascade legitimately trims spacer edges (common
    prefix/suffix k-mers are reassigned to the repeat), so match on the
    spacer core, either strand.
    """
    from mcaat_tpu.io.fastq import reverse_complement

    text = result.report_text
    hits = 0
    for sp in planted_spacers:
        core = sp[6:-6]
        if core in text or reverse_complement(core) in text:
            hits += 1
    return hits / len(planted_spacers)


@pytest.mark.slow
def test_single_array_detected(tmp_path):
    meta = make_metagenome(seed=3, n_arrays=1, n_spacers=6, coverage=40.0)
    result = run_on(tmp_path, meta)
    planted = meta["arrays"][0]
    assert len(result.cycles) > 0, "no cycles found in the dBG"
    assert len(result.found_systems) >= 1, "no CRISPR system reconstructed"
    # the consensus repeat must match the planted repeat (some systems may
    # be the reverse-complement strand)
    assert spacers_found(result, planted["spacers"]) >= 0.5
    assert "Number of Systems: 0" not in result.report_text


@pytest.mark.slow
def test_paired_end_detected(tmp_path):
    meta = make_metagenome(seed=11, n_arrays=1, n_spacers=5, coverage=50.0)
    result = run_on(tmp_path, meta, paired=True)
    assert len(result.found_systems) >= 1
    assert spacers_found(result, meta["arrays"][0]["spacers"]) >= 0.5


@pytest.mark.slow
def test_no_array_in_pure_background(tmp_path):
    rng = np.random.default_rng(5)
    from synthetic import random_seq, sample_reads

    bg = random_seq(rng, 3000)
    reads = sample_reads(rng, bg, read_len=100, coverage=10.0)
    result = run_on(tmp_path, {"reads": reads, "arrays": []})
    assert result.found_systems == []
    assert "Number of Systems: 0" in result.report_text


@pytest.mark.slow
def test_settings_sweep_threshold_multiplicity(tmp_path):
    """BASELINE config 3: custom settings must steer the cycle finder.

    threshold_multiplicity above the array coverage suppresses all start
    nodes (≙ the reference's Settings::CycleFinderSettings knob,
    settings.h:33-38); at the default the array is found.
    """
    meta = make_metagenome(seed=31, n_arrays=1, n_spacers=6, coverage=40.0)
    found = run_on(tmp_path, meta)
    assert len(found.found_systems) >= 1
    cfg = tmp_path / "settings.txt"
    cfg.write_text("threshold_multiplicity=5000\n")
    s = Settings()
    assert s.load_from_file(str(cfg))
    assert s.cycle_finder_settings.threshold_multiplicity == 5000
    suppressed = run_on(
        tmp_path, meta, cycle_finder_settings=s.cycle_finder_settings
    )
    assert suppressed.found_systems == []


@pytest.mark.slow
def test_settings_sweep_cycle_length_window(tmp_path):
    """cycle_max_length below the array period finds no cycles."""
    meta = make_metagenome(seed=33, n_arrays=1, n_spacers=6, coverage=40.0)
    s = Settings()
    s.cycle_finder_settings.cycle_max_length = 30  # period ≈ 60-80 nodes
    s.cycle_finder_settings.cycle_min_length = 27
    result = run_on(
        tmp_path, meta, cycle_finder_settings=s.cycle_finder_settings
    )
    assert result.found_systems == []


@pytest.mark.slow
def test_two_arrays_detected(tmp_path):
    meta = make_metagenome(seed=21, n_arrays=2, n_spacers=5, coverage=40.0)
    result = run_on(tmp_path, meta)
    all_spacers = [sp for a in meta["arrays"] for sp in a["spacers"]]
    assert len(result.found_systems) >= 2
    assert spacers_found(result, all_spacers) >= 0.5


@pytest.mark.slow
def test_debug_pipeline_smoke(tmp_path):
    """DEBUG-main extension end-to-end (src/main.cpp:358-493): Filters →
    analyzer → protospacers → phage curation, plus the multiplicity
    histogram dump (src/main.cpp:497-510)."""
    import os

    from mcaat_tpu.pipeline import run_debug_pipeline
    from mcaat_tpu.settings import Settings

    meta = make_metagenome(seed=13, n_arrays=1, n_spacers=5, coverage=35.0)
    f1 = tmp_path / "r.fq"
    write_fastq(str(f1), meta["reads"])
    s = Settings()
    s.input_files = str(f1)
    s.output_folder = str(tmp_path)
    s.output_file = str(tmp_path / "CRISPR_Arrays.txt")
    result = run_debug_pipeline(s, verbose=False)
    assert result.report_text
    hist = tmp_path / "node_multiplicities.txt"
    assert hist.exists()
    lines = hist.read_text().strip().splitlines()
    assert lines and all(
        l.startswith("Multiplicity ") and l.endswith(" nodes") for l in lines
    )
    assert (tmp_path / "grouped_paths_protospacers.txt").exists()


@pytest.mark.slow
def test_region_condensation_parity(tmp_path):
    """Forced region condensation in the ordering stage == direct path
    (the big-graph safeguard added after the 16.7M-node worker crash)."""
    from mcaat_tpu.cycles.finder import cycles_map_to_cycles, find_cycles
    from mcaat_tpu.graph.dbg import build_dbg_from_reads
    from mcaat_tpu.io.fastq import encode_sequences
    from mcaat_tpu.pipeline import spacer_ordering_step
    from mcaat_tpu.reads.mapper import get_reads

    meta = make_metagenome(seed=17, n_arrays=2, n_spacers=5, coverage=40.0)
    f1 = tmp_path / "r.fq"
    write_fastq(str(f1), meta["reads"])
    batch = encode_sequences(meta["reads"])
    g = build_dbg_from_reads(batch.codes, batch.lengths, k=23)
    g, cycles_map = find_cycles(g, verbose=False)
    cycles = cycles_map_to_cycles(cycles_map)
    reads = get_reads(g, str(f1), None, cycles)
    assert reads and cycles

    _g1, sys_direct = spacer_ordering_step(
        g, reads, cycles, verbose=False, condense_min_nodes=10**12
    )
    _g2, sys_cond = spacer_ordering_step(
        g, reads, cycles, verbose=False, condense_min_nodes=0
    )
    assert len(sys_direct) == len(sys_cond) >= 1
    for a, b in zip(sys_cond, sys_direct):
        assert a.full_sequence == b.full_sequence
        assert a.repeat == b.repeat
        assert a.spacers == b.spacers
        assert a.confidence_cycle_resolution == b.confidence_cycle_resolution
        assert a.confidence_topological_sort == b.confidence_topological_sort


@pytest.mark.slow
def test_lazy_clip_pipeline_parity(tmp_path):
    """Full pipeline with the big-graph path forced (deferred tip clip +
    neighborhood extraction + region condensation) produces the same
    report as the default small-graph path."""
    import mcaat_tpu.cycles.finder as finder_mod
    import mcaat_tpu.pipeline as pipeline_mod

    meta = make_metagenome(
        seed=29, n_arrays=2, n_spacers=5, background_len=4000,
        background_coverage=6.0, coverage=40.0,
    )
    base = run_on(tmp_path, meta)
    old = (
        finder_mod.NEIGHBORHOOD_MIN_NODES,
        finder_mod.LAZY_CLIP_MIN_NODES,
        pipeline_mod.REGION_CONDENSE_MIN_NODES,
    )
    try:
        finder_mod.NEIGHBORHOOD_MIN_NODES = 0
        finder_mod.LAZY_CLIP_MIN_NODES = 0
        pipeline_mod.REGION_CONDENSE_MIN_NODES = 0
        big = run_on(tmp_path, meta)
    finally:
        (
            finder_mod.NEIGHBORHOOD_MIN_NODES,
            finder_mod.LAZY_CLIP_MIN_NODES,
            pipeline_mod.REGION_CONDENSE_MIN_NODES,
        ) = old
    assert big.report_text == base.report_text
    assert len(big.found_systems) == len(base.found_systems) >= 1


@pytest.mark.slow
def test_condensed_region_clip_parity(tmp_path):
    """ADVICE r2 medium: the condensed-region tip clip invalidates nodes
    whose only cycle-reaching path exits the read_len region (globally
    alive in the reference's global-clip schedule). Construct exactly
    that — an array followed by a >read_len unique tail ending in a
    short tandem cycle (period 8 < cycle_min_length, so never
    enumerated/seeded) — verify the scenario materializes (the region
    clip really kills globally-alive nodes), and assert the condensed
    path's output equals the direct global-clip path's. See the proof at
    pipeline.spacer_ordering_step: such nodes are in no SCC, so the
    Subgraphs (the only thing downstream consumes) are identical."""
    import jax.numpy as jnp

    from mcaat_tpu.cycles.finder import cycles_map_to_cycles, find_cycles
    from mcaat_tpu.cycles.neighborhood import (
        extract_region_graph,
        undirected_region_mask,
    )
    from mcaat_tpu.graph.dbg import build_dbg_from_reads
    from mcaat_tpu.io.fastq import encode_sequences
    from mcaat_tpu.pipeline import spacer_ordering_step
    from mcaat_tpu.prune.prune import clip_tips
    from mcaat_tpu.reads.mapper import get_reads
    from synthetic import make_crispr_array, random_seq, sample_reads

    rng = np.random.default_rng(47)
    arr_seq, _repeat, _spacers = make_crispr_array(rng, n_spacers=5)
    tail = random_seq(rng, 170)  # > read_len hops: exits the region
    tandem = "ACGTGACT" * 8  # period-8 dBG cycle, len 8 < cycle_min 27
    template = (
        random_seq(rng, 200) + arr_seq + tail + tandem + random_seq(rng, 200)
    )
    reads = sample_reads(rng, template, read_len=100, coverage=40.0)
    f1 = tmp_path / "r.fq"
    write_fastq(str(f1), reads)
    batch = encode_sequences(reads)
    g = build_dbg_from_reads(batch.codes, batch.lengths, k=23)
    g, cycles_map = find_cycles(g, verbose=False)  # global clip (small graph)
    cycles = cycles_map_to_cycles(cycles_map)
    reads_m = get_reads(g, str(f1), None, cycles)
    assert reads_m and cycles

    # scenario check: the region clip kills >= 1 node that is globally
    # alive (tail nodes: in-region, only cycle-path exits to the tandem)
    seeds = np.asarray(sorted({n for c in cycles for n in c}), dtype=np.int64)
    mask = undirected_region_mask(g, seeds, len(reads_m[0]))
    region, gids = extract_region_graph(g, mask)
    region_clipped, n_clipped = clip_tips(region)
    assert n_clipped > 0
    killed_local = np.asarray(region.valid) & ~np.asarray(region_clipped.valid)
    killed_global = gids[np.nonzero(killed_local)[0]]
    g_valid = np.asarray(g.valid)
    assert g_valid[killed_global].any(), (
        "expected a region-clipped node that the global clip keeps"
    )

    _g1, sys_direct = spacer_ordering_step(
        g, reads_m, cycles, verbose=False, condense_min_nodes=10**12
    )
    _g2, sys_cond = spacer_ordering_step(
        g, reads_m, cycles, verbose=False, condense_min_nodes=0
    )
    assert len(sys_direct) == len(sys_cond) >= 1
    for a, b in zip(sys_cond, sys_direct):
        assert a.full_sequence == b.full_sequence
        assert a.repeat == b.repeat
        assert a.spacers == b.spacers
        assert a.confidence_cycle_resolution == b.confidence_cycle_resolution
        assert a.confidence_topological_sort == b.confidence_topological_sort


def test_duplicate_input_file_doubles_multiplicity(tmp_path):
    """A path listed twice contributes its reads twice (the reference
    loops over listed files, src/tmp_utils.cpp:8-24) — a path-keyed dict
    once halved duplicate files' multiplicities."""
    from mcaat_tpu.pipeline import build_graph_from_settings

    meta = make_metagenome(seed=31, n_arrays=1, n_spacers=4, coverage=12.0)
    fq = str(tmp_path / "reads.fq")
    write_fastq(fq, meta["reads"])
    g1 = build_graph_from_settings(
        Settings(input_files=fq, output_file=str(tmp_path / "a.txt"))
    )
    g2 = build_graph_from_settings(
        Settings(input_files=f"{fq} {fq}", output_file=str(tmp_path / "b.txt"))
    )
    assert g2.size == g1.size
    np.testing.assert_array_equal(np.asarray(g2.kmers), np.asarray(g1.kmers))
    np.testing.assert_array_equal(
        np.asarray(g2.mult), 2 * np.asarray(g1.mult)
    )


def test_parallel_ordering_pool_matches_serial(tmp_path, monkeypatch):
    """The process-pooled subproblem loop must be byte-identical to the
    serial loop (report AND captured verbose text)."""
    import contextlib
    import io
    import os
    import sys

    sys.path.insert(0, os.path.join(os.path.dirname(__file__)))
    from synthetic import make_metagenome, write_fastq

    from mcaat_tpu import pipeline as pl
    from mcaat_tpu.settings import Settings

    meta = make_metagenome(seed=31, n_arrays=2, n_spacers=4, coverage=35.0)
    f = tmp_path / "r.fq"
    write_fastq(str(f), meta["reads"])

    def run(procs: str):
        monkeypatch.setenv("MCAAT_ORDERING_PROCS", procs)
        s = Settings(
            input_files=str(f), output_file=str(tmp_path / f"o{procs}.txt")
        )
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            r = pl.run_pipeline(s, verbose=True)
        return r, buf.getvalue()

    monkeypatch.setattr(pl, "_ORDERING_POOL_MIN_SUBPROBLEMS", 1)
    r_ser, out_ser = run("1")
    r_par, out_par = run("2")
    assert r_par.report_text == r_ser.report_text
    assert [fs.repeat for fs in r_par.found_systems] == [
        fs.repeat for fs in r_ser.found_systems
    ]
    # the verbose subproblem blocks are replayed in order — identical text
    # modulo wall-clock timing lines
    import re

    def strip_timings(text: str) -> str:
        tail = text.split("Splitting into subproblems")[-1]
        return "\n".join(
            ln
            for ln in tail.splitlines()
            if not re.search(r"\d+\.\d+s", ln)
            and not ln.startswith("Saved in:")
        )

    assert strip_timings(out_par) == strip_timings(out_ser)


def test_region_first_mapping_matches_full_table(tmp_path, monkeypatch):
    """VERDICT r4 #5: with the condense threshold forced low, the mapper
    joins kept chains against the cycle REGION table (out-of-region
    windows -> -1) and hands the grown mask to the ordering stage. The
    report and systems must equal the default full-table run, and the
    chains must agree on every in-region entry."""
    import contextlib
    import io
    import os
    import sys

    sys.path.insert(0, os.path.join(os.path.dirname(__file__)))
    from synthetic import make_metagenome, write_fastq

    from mcaat_tpu import pipeline as pl
    from mcaat_tpu.settings import Settings

    meta = make_metagenome(seed=53, n_arrays=2, n_spacers=5, coverage=40.0)
    f = tmp_path / "r.fq"
    write_fastq(str(f), meta["reads"])

    def run(tag):
        s = Settings(
            input_files=str(f), output_file=str(tmp_path / f"{tag}.txt")
        )
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            return pl.run_pipeline(s, verbose=True)

    r_full = run("full")
    # force the region-first path (condense threshold below graph size)
    monkeypatch.setattr(pl, "REGION_CONDENSE_MIN_NODES", 1)
    from mcaat_tpu.cycles import finder as _finder

    monkeypatch.setattr(_finder, "NEIGHBORHOOD_MIN_NODES", 1)
    r_region = run("region")
    assert r_region.report_text == r_full.report_text
    assert [fs.repeat for fs in r_region.found_systems] == [
        fs.repeat for fs in r_full.found_systems
    ]
    assert [fs.spacers for fs in r_region.found_systems] == [
        fs.spacers for fs in r_full.found_systems
    ]
    # chains: same keep set/lengths; in-region entries identical; region
    # replaces out-of-region ids with -1 only
    assert len(r_region.reads) == len(r_full.reads)
    import numpy as np

    a, b = r_region.reads, r_full.reads
    np.testing.assert_array_equal(a.offsets, b.offsets)
    diff = a.flat != b.flat
    assert (a.flat[diff] == -1).all()
