"""End-to-end pipeline orchestration.

The analog of the reference's release ``main()``
(``src/main.cpp:496-591``) and the STEP 6-8 wrappers
(``src/main_run_and_debug.cpp``): graph build → cycle finding → read
mapping → spacer ordering → systems → report. Heavy stages run on device
(see the per-module docstrings); this file is control flow only.
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field

import numpy as np

from mcaat_tpu.cycles.finder import cycles_map_to_cycles, find_cycles
from mcaat_tpu.evaluation import (
    get_most_similar_sequence,
    get_number_of_duplicate_spacers,
    get_string_similarity,
)
from mcaat_tpu.graph.dbg import DBG, build_dbg_from_reads
from mcaat_tpu.io.fastq import encode_sequences, read_sequences
from mcaat_tpu.ordering.ordering import (
    filter_subproblems,
    get_crispr_regions_extended_by_k,
    get_ordered_cycles,
)
from mcaat_tpu.reads.mapper import get_reads
from mcaat_tpu.report.analyzer import CRISPRAnalyzer
from mcaat_tpu.settings import Settings
from mcaat_tpu.systems.extract import get_systems


@dataclass
class FoundSystem:
    """≙ the reference's found_systems tuple (main_run_and_debug.cpp:123-129)."""

    full_sequence: str
    repeat: str
    spacers: list[str]
    confidence_cycle_resolution: float
    confidence_topological_sort: float


@dataclass
class PipelineResult:
    graph: DBG | None = None
    cycles_map: dict[int, list[list[int]]] = field(default_factory=dict)
    cycles: list[list[int]] = field(default_factory=list)
    reads: list[list[int]] = field(default_factory=list)
    found_systems: list[FoundSystem] = field(default_factory=list)
    report_text: str = ""
    profile: object = None  # utils.profiling.Profiler of the run


def _load_input_batches(settings: Settings) -> list:
    """Parse the input files: ``[(path, ReadBatch)]``, one entry per
    LISTED file. A path listed twice contributes its reads twice, exactly
    like the reference's per-file loop (src/tmp_utils.cpp:8-24) — a
    path-keyed dict silently halved duplicate files' multiplicities. Each
    distinct path is parsed once and the batch object shared."""
    from mcaat_tpu.io.fastq import read_encoded_batch

    cache: dict = {}
    entries = []
    for path in settings.input_file_list():
        if path not in cache:
            cache[path] = read_encoded_batch(path)
        entries.append((path, cache[path]))
    return entries


def _concat_batches(entries: list) -> tuple[np.ndarray, np.ndarray]:
    """Stack per-file batches into one padded 2-bit code matrix."""
    batches = [b for _, b in entries if b.num_reads]
    if not batches:
        raise RuntimeError("No sequences found in input files")
    max_len = max(b.max_len for b in batches)
    codes = np.zeros((sum(b.num_reads for b in batches), max_len), dtype=np.uint8)
    lengths = np.zeros(codes.shape[0], dtype=np.int32)
    row = 0
    for b in batches:
        codes[row : row + b.num_reads, : b.max_len] = b.codes
        lengths[row : row + b.num_reads] = b.lengths
        row += b.num_reads
    return codes, lengths


def _load_input_codes(settings: Settings) -> tuple[np.ndarray, np.ndarray]:
    """Parse all input files into one padded 2-bit code matrix."""
    return _concat_batches(_load_input_batches(settings))


def _sharded_mode(settings: Settings) -> bool:
    import jax

    # single-process only: the sharded pipeline's host orchestration
    # (masks, compactions) needs fully-addressable arrays; multi-process
    # runs go through parallel/multihost.py instead
    return (
        settings.mesh != "off"
        and len(jax.devices()) > 1
        and jax.process_count() == 1
    )


def build_graph_from_settings(
    settings: Settings,
    verbose: bool = False,
    batches: list | None = None,
    endpoints_out: dict | None = None,
) -> DBG:
    """STEP: graph build (≙ SDBGBuild, src/sdbg_build.cpp).

    Uses the native parser when built (2-bit codes filled in C++, no
    Python string materialization). ``batches`` reuses already-parsed
    per-file ReadBatches (run_pipeline parses each input exactly once
    and shares them with the read mapper). ``endpoints_out`` is filled
    with the device-resident per-read endpoint k-mers keyed BY FILE
    (``{path: (first_km, last_km)}``, first occurrence wins for a
    duplicated path — same file, same endpoints) for the mapper's keep
    predicate — single-device build only (the sharded path routes reads
    itself).
    """
    if batches is None:
        batches = _load_input_batches(settings)
    codes, lengths = _concat_batches(batches)
    if _sharded_mode(settings):
        graph = _build_graph_sharded(codes, lengths, settings)
        if graph is not None:
            return graph
    # --ram bounds the counting working set (≙ the reference feeding
    # --ram to megahit's host_mem, src/sdbg_build.cpp:202): the default
    # 384M-window single-pass/chunk budget was fit to the previous
    # accelerator's 16 GB of device memory and is unmeasured on this card;
    # scale down proportionally when the user asks for less
    chunk_windows = 384_000_000
    if settings.ram_explicit and settings.ram and settings.ram < 16.0:
        chunk_windows = max(int(chunk_windows * settings.ram / 16.0), 2_000_000)
    eps_rows = {} if endpoints_out is not None else None
    graph = build_dbg_from_reads(
        codes,
        lengths,
        k=23,
        add_reverse_complement=settings.add_reverse_complement,
        chunk_windows=chunk_windows,
        verbose=verbose,
        endpoints_out=eps_rows,
    )
    if endpoints_out is not None and eps_rows:
        # split the concatenated-row endpoint arrays back per input file
        off = 0
        for path, b in batches:
            if not b.num_reads:
                continue
            endpoints_out.setdefault(
                path,
                (
                    eps_rows["first_km"][off : off + b.num_reads],
                    eps_rows["last_km"][off : off + b.num_reads],
                ),
            )
            off += b.num_reads
    return graph


def _build_graph_sharded(codes, lengths, settings: Settings):
    """Distributed graph build, compacted to a single-device DBG (used by
    checkpointed runs; the non-checkpointed multi-device path keeps the
    graph sharded — see parallel/sharded_pipeline.py). Returns None to
    fall back to the single-device build on capacity overflow."""
    from mcaat_tpu.parallel.sharded_pipeline import (
        build_sharded_graph_for_pipeline,
    )
    from mcaat_tpu.parallel.sharded_graph import sharded_dbg_to_dbg

    sg = build_sharded_graph_for_pipeline(codes, lengths, settings)
    if sg is None:
        return None
    return sharded_dbg_to_dbg(sg)


# above this node count the ordering stage condenses the read_len-hop
# cycle region first: the full-array region growth (hops × O(4N) in one
# device program) failed on the previous accelerator at large graphs, and
# the host Tarjan/CSR would otherwise walk the whole graph. Tied to the cycle
# stage's lazy-clip threshold: the condensation is also where the deferred
# tip clip is completed (cycles/finder.LAZY_CLIP_MIN_NODES). None means
# "track finder.LAZY_CLIP_MIN_NODES at call time" so a runtime override of
# the finder threshold (tests force lazy mode that way) keeps the
# deferred-clip completion coupled to it.
REGION_CONDENSE_MIN_NODES: int | None = None


def _condense_threshold() -> int:
    from mcaat_tpu.cycles import finder as _finder

    if REGION_CONDENSE_MIN_NODES is not None:
        return REGION_CONDENSE_MIN_NODES
    return _finder.LAZY_CLIP_MIN_NODES


def spacer_ordering_step(
    graph: DBG,
    reads: list[list[int]],
    cycles: list[list[int]],
    verbose: bool = True,
    condense_min_nodes: int | None = None,
    region_mask: np.ndarray | None = None,
) -> tuple[DBG, list[FoundSystem]]:
    """STEP 7 (≙ run_and_debug_spacer_ordering, main_run_and_debug.cpp:32-140).

    ``region_mask``: a precomputed ``undirected_region_mask(graph,
    cycle seeds, len(reads[0]))`` — the region-first mapper (VERDICT r4
    #5) grows it before the chain lookup and hands it back here so the
    condense path skips the second growth."""
    from mcaat_tpu.cycles import finder as _finder

    if condense_min_nodes is None:
        condense_min_nodes = _condense_threshold()
    found_systems: list[FoundSystem] = []
    if not reads:
        return graph, found_systems
    read_chain_len = len(reads[0])
    from mcaat_tpu.utils.profiling import tick_printer

    _tick = tick_printer("ordering", verbose)

    if graph.size >= condense_min_nodes:
        from mcaat_tpu.cycles.neighborhood import (
            extract_region_graph,
            remap_chains,
            undirected_region_mask,
        )

        seeds = np.asarray(sorted({n for c in cycles for n in c}), dtype=np.int64)
        _tick("cycle-node seed set")
        if region_mask is not None:
            mask = region_mask
        else:
            mask = undirected_region_mask(
                graph, seeds, read_chain_len, verbose=verbose
            )
        _tick("region mask growth")
        graph, gids = extract_region_graph(graph, mask)
        _tick("region extract")
        cycles, reads = remap_chains(gids, cycles, reads)
        _tick("chain remap")
        if verbose:
            print(
                f"  ▸ Region condensed to {len(gids)} nodes for the "
                f"ordering stages"
            )
        # lazy-clip completion (cycles/finder.LAZY_CLIP_MIN_NODES): at this
        # scale the cycle stage defers tip clipping, so clip the condensed
        # region so the region growth + SCC split below see post-clip
        # validity.
        #
        # Output-preservation proof (vs the reference's GLOBAL clip,
        # src/cycle_finder.cpp:346-371, which runs before its region
        # growth src/spacer_ordering.cpp:78-139). Everything downstream
        # consumes only the Subgraphs (SCC node sets + internal edges,
        # ordering.divide_graph_into_subgraphs) — get_relevant_reads /
        # get_relevant_cycles test membership of subgraph.nodes, which
        # contain SCC-internal endpoints only. So it suffices that the
        # SCC decomposition is identical:
        #  1. Every reference-subgraph node lies on a directed cycle
        #     entirely inside this region graph: it is strongly connected
        #     within the reference's grown region, so it lies on a closed
        #     walk of nodes ≤ read_len directed hops from a cycle seed —
        #     all within the (undirected, pre-clip-valid, hence superset)
        #     read_len-hop mask this graph was extracted from, and edges
        #     between mask nodes survive the boundary truncation.
        #  2. Nodes on region-internal cycles reach a cycle, so the clip
        #     below keeps them: no reference SCC node is ever clipped.
        #     Contrapositive: a region node whose only cycle-reaching
        #     path exits the region (clipped here, globally alive in the
        #     reference) is on no region-internal closed walk, hence in
        #     no reference SCC either — clipping it is unobservable.
        #  3. The growth below reaches every reference SCC node: the
        #     reference reaches it via a ≤read_len valid path from a
        #     seed, and each path node reaches that SCC's region-internal
        #     cycle through the path suffix (in the mask by the same hop
        #     bound), so it survives this clip and expands here too.
        #     Conversely region-clip-valid ⊆ globally-valid on mask
        #     nodes, so our reached set ⊆ the reference's; with 1-3 each
        #     reference SCC stays strongly connected here and no new
        #     nodes join — the decompositions coincide.
        # Regression: tests/test_e2e.py::test_condensed_region_clip_parity
        # constructs the rare case (peripheral in-region node whose only
        # cycle-path exits the region, carrying an anchored read).
        from mcaat_tpu.prune.prune import clip_tips

        graph, _ = clip_tips(graph)
        _tick("region condense")
    elif graph.size >= _finder.LAZY_CLIP_MIN_NODES:
        # a caller raised condense_min_nodes above the lazy-clip threshold:
        # the graph may carry a deferred tip clip — complete it globally so
        # the region growth below sees post-clip validity
        from mcaat_tpu.prune.prune import clip_tips

        graph, _ = clip_tips(graph)
        _tick("global clip (condense skipped)")

    if verbose:
        print("  ▸ Splitting into subproblems")
    graph, subgraphs = get_crispr_regions_extended_by_k(
        graph, read_chain_len, cycles, verbose=verbose
    )
    _tick("region split (SCC)")

    if verbose:
        print("  🔄 Filtering subproblems:")
    # megahit-style RC component is discarded by having no relevant
    # reads (main_run_and_debug.cpp:54-59); one vectorized pass over all
    # subgraphs (result-identical to the per-subgraph filters)
    remaining = filter_subproblems(graph.size, subgraphs, reads, cycles)
    if verbose:
        print(
            f"  ✅ Filtered out {len(subgraphs) - len(remaining)}/"
            f"{len(subgraphs)} subproblems"
        )
        print(f"  🔄 Solving {len(remaining)} subproblems...")
    _tick("subproblem filter")

    host_graph = graph.to_host()
    results = _solve_subproblems(host_graph, remaining)
    for idx, cycle_order, conf_res, conf_topo, system, log_text in results:
        sg, relevant_reads, relevant_cycles = remaining[idx]
        if verbose:
            print(f"    Subproblem {idx + 1}/{len(remaining)}:")
            print(
                f"      🛈 Graph with {len(sg.nodes)} nodes and "
                f"{sg.edge_count()} edges"
            )
            print(f"      🛈 Reads with {len(relevant_reads)}/{len(reads)} used")
            print(f"      🛈 Cycles with {len(relevant_cycles)} used")
            import sys as _sys

            _sys.stdout.write(log_text)
            print(f"      ▸ The order is {' '.join(map(str, cycle_order))}")
            print(
                f"      ▸ Cycles were resolved with a confidence of "
                f"{conf_res * 100:.2f}%"
            )
            print(f"      ▸ Topological sort has a confidence of {conf_topo * 100:.2f}%")
        if system is None:
            if verbose:
                print("      ▸ Node order is too short and is not processed further")
            continue
        repeat, spacers, full_sequence = system
        if verbose:
            print(f"        ▸ Number of spacers: {len(spacers)}")
        found_systems.append(
            FoundSystem(full_sequence, repeat, spacers, conf_res, conf_topo)
        )
    if verbose:
        print("  ✅ Completed each subproblem")
    _tick("subproblem solve")
    return graph, found_systems


# --threads: worker-count ceiling for the ordering pool (and the native
# OpenMP packer, via native.set_threads). None = unset (cpu_count).
_ORDERING_THREADS: int | None = None


def configure_threads(n: int) -> None:
    """Wire ``settings.threads`` into every parallel backend: the
    ordering process pool defaults to it (``MCAAT_ORDERING_PROCS`` still
    overrides) and the native library's OpenMP team is bounded by it.
    ≙ the reference's omp_set_num_threads (src/main.cpp:292-294). A
    non-positive ``n`` resets to the unset default."""
    global _ORDERING_THREADS
    _ORDERING_THREADS = int(n) if n and n > 0 else None
    if _ORDERING_THREADS is not None:
        from mcaat_tpu import native as _native

        _native.set_threads(_ORDERING_THREADS)


def _ordering_worker_count() -> int:
    """Ordering-pool size: env override > --threads > cpu_count."""
    import os

    return int(
        os.environ.get(
            "MCAAT_ORDERING_PROCS",
            str(_ORDERING_THREADS or os.cpu_count() or 1),
        )
    )

# parallelize only past this subproblem count: below it the worker
# start-up + dispatch overhead exceeds the loop itself
_ORDERING_POOL_MIN_SUBPROBLEMS = 8


def _ordering_context():
    """Ordering workers fork from a fork server. A fork of this process
    is not safe once it holds a live device runtime (its threads and
    device context), and a spawned worker pays a fresh interpreter and
    package import each; the fork server pays that import once per
    process (the three are timed in PERF.md)."""
    import atexit
    import multiprocessing

    global _ORDERING_SERVER_STOP_REGISTERED
    ctx = multiprocessing.get_context("forkserver")
    ctx.set_forkserver_preload([__name__])
    if not _ORDERING_SERVER_STOP_REGISTERED:
        atexit.register(stop_ordering_server)
        _ORDERING_SERVER_STOP_REGISTERED = True
    return ctx


_ORDERING_SERVER_STOP_REGISTERED = False


def stop_ordering_server() -> None:
    """Stop the fork server and the resource tracker it started, and wait
    for both to exit. Left alone they only notice the parent's pipes
    close once it has gone, and wind down after it, so the process would
    end with its children still running. Registered to run at exit by
    the first pool context; safe to call sooner (the next pool starts
    them again) or when neither runs. CPython has no public stop for
    either, hence the private calls."""
    from multiprocessing import forkserver, resource_tracker

    forkserver._forkserver._stop()
    resource_tracker._resource_tracker._stop()


def start_ordering_server() -> None:
    """Start the ordering pool's fork server now: a fresh interpreter
    that imports this module once, never initialises a device backend,
    and forks every ordering worker. Started at ``run_pipeline`` entry,
    its import overlaps the device stages; the pool starts it on first
    use otherwise. Idempotent."""
    from multiprocessing import forkserver

    if _ordering_worker_count() > 1:
        _ordering_context()
        forkserver.ensure_running()


def _solve_ordering_subproblem(args):
    """One ordering solve, pool-safe: returns everything the parent needs
    to emit the exact serial verbose block. ``order_cycles_fast``'s own
    verbose lines are captured so the parent can replay them in
    deterministic subproblem order."""
    import contextlib
    import io

    from mcaat_tpu.ordering.fast import order_cycles_fast

    idx, relevant_reads, relevant_cycles = args
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        cycle_order, conf_res, conf_topo = order_cycles_fast(
            relevant_reads, relevant_cycles, verbose=True
        )
    return idx, cycle_order, conf_res, conf_topo, buf.getvalue()


def _solve_subproblems(host_graph, remaining):
    """Solve the (independent) ordering subproblems, in parallel when
    there are enough of them (≙ the reference's per-subproblem OpenMP
    parallelism, src/main_run_and_debug.cpp:32-140). Results come back
    in subproblem order, and all verbose text is emitted by the caller,
    so output is byte-identical to the serial loop.
    ``MCAAT_ORDERING_PROCS`` overrides the worker count (0/1 forces
    serial). A worker failure raises; there is no silent serial rerun.

    Workers are forked from the fork server (see
    :func:`start_ordering_server`), never from this process. Tasks carry
    only their reads and cycles; the repeat/spacer extraction, the one
    step that reads the graph, runs here in the parent, so the graph is
    never copied into a worker."""
    tasks = [
        (i, rr, rc) for i, (_sg, rr, rc) in enumerate(remaining)
    ]
    n_procs = min(_ordering_worker_count(), len(tasks))
    if n_procs > 1 and len(tasks) >= _ORDERING_POOL_MIN_SUBPROBLEMS:
        from concurrent.futures import ProcessPoolExecutor

        with ProcessPoolExecutor(
            max_workers=n_procs, mp_context=_ordering_context()
        ) as ex:
            solved = list(ex.map(_solve_ordering_subproblem, tasks))
    else:
        solved = [_solve_ordering_subproblem(t) for t in tasks]
    results = []
    for idx, cycle_order, conf_res, conf_topo, log_text in solved:
        ordered_cycles = get_ordered_cycles(cycle_order, tasks[idx][2])
        system = None
        if len(ordered_cycles) >= 2:
            system = get_systems(host_graph, ordered_cycles)
        results.append((idx, cycle_order, conf_res, conf_topo, system, log_text))
    return results


def benchmark_results(settings: Settings, found_systems: list[FoundSystem]) -> None:
    """STEP 8, benchmark mode (≙ main_run_and_debug.cpp:142-212)."""
    benchmark_sequences = []
    try:
        with open(settings.benchmark_file) as fh:
            benchmark_sequences = [line.strip() for line in fh if line.strip()]
        print(f"Loaded {len(benchmark_sequences)} benchmark sequences.")
    except OSError:
        print(f"Error: Could not open benchmark file: {settings.benchmark_file}")

    print(
        f"  ▸ {len(found_systems)} crispr sequences are found and benchmarked "
        f"using {len(benchmark_sequences)} sequences"
    )
    no_match = 0
    avg_sim = 0.0
    for fs in found_systems:
        expected = get_most_similar_sequence(fs.full_sequence, benchmark_sequences)
        if expected == "":
            print(f"    ▸ No expected match for sequence: {fs.full_sequence}")
            no_match += 1
            continue
        sim = get_string_similarity(fs.full_sequence, expected)
        dups = get_number_of_duplicate_spacers(fs.spacers, expected)
        print(
            f"    ▸ ≥{sim * 100:.2f}% sequence similarity, with "
            f"{len(fs.spacers)} spacers, {dups} duplicate spacers, "
            f"confidence of cycle resolution: "
            f"{fs.confidence_cycle_resolution * 100:.2f}%, confidence of "
            f"topological sort: {fs.confidence_topological_sort * 100:.2f}%, "
            f"and the repeat: {fs.repeat}, and sequence: {fs.full_sequence}"
        )
        avg_sim += sim
    denom = len(found_systems) - no_match
    if denom > 0:
        avg_sim /= denom
    print(
        f"  ▸ The average sequence similarity is {avg_sim * 100:.2f}% with "
        f"{no_match}/{len(found_systems)} ignored"
    )


def print_results(found_systems: list[FoundSystem]) -> None:
    """STEP 8, confidence-graded summary (≙ main_run_and_debug.cpp:214-258)."""
    counts = {"🔴": 0, "🟠": 0, "🟡": 0, "🟢": 0}
    for fs in found_systems:
        if (
            len(fs.repeat) <= 23
            or fs.confidence_cycle_resolution < 0.5
            or fs.confidence_topological_sort < 0.5
        ):
            grade = "🔴"
        elif fs.confidence_cycle_resolution < 0.75 or fs.confidence_topological_sort < 0.75:
            grade = "🟠"
        elif fs.confidence_cycle_resolution < 0.85 or fs.confidence_topological_sort < 0.85:
            grade = "🟡"
        else:
            grade = "🟢"
        counts[grade] += 1
        print(f"  {grade} repeat: {fs.repeat}, sequence: {fs.full_sequence}")
    total = sum(counts.values())
    print(
        f"  ▸ {len(found_systems)} CRISPR Arrays were found with "
        f"🔴 ({counts['🔴']}/{total}), 🟠 ({counts['🟠']}/{total}), "
        f"🟡 ({counts['🟡']}/{total}), 🟢 ({counts['🟢']}/{total})"
    )


def run_debug_pipeline(settings: Settings, verbose: bool = True) -> PipelineResult:
    """The reference's DEBUG-main extension (src/main.cpp:358-493):
    Filters → CRISPRAnalyzer → protospacer isolation → phage curation."""
    import os

    from mcaat_tpu.phage import PhageCurator
    from mcaat_tpu.protospacers import (
        IsolateProtospacers,
        create_repeat_to_spacer_nodes,
    )
    from mcaat_tpu.systems.filters import Filters

    configure_threads(settings.threads)
    result = PipelineResult()
    graph = build_graph_from_settings(settings)

    # ≙ DEBUG main's node-multiplicity histogram dump (src/main.cpp:497-510):
    # "Multiplicity {m}: {c} nodes" lines into node_multiplicities.txt
    mult_h = np.asarray(graph.mult)[np.asarray(graph.valid)]
    values, counts = np.unique(mult_h, return_counts=True)
    if verbose:
        print("Node Multiplicity Distribution:")
    hist_path = os.path.join(
        settings.output_folder or ".", "node_multiplicities.txt"
    )
    with open(hist_path, "w") as fh:
        for m, c in zip(values.tolist(), counts.tolist()):
            fh.write(f"Multiplicity {m}: {c} nodes\n")

    cfs = settings.cycle_finder_settings
    # full_prune: the DEBUG stages below (Filters, protospacer isolation,
    # phage curation) consume whole-graph validity, so tip clipping cannot
    # be deferred to the candidate neighborhood here
    graph, cycles_map = find_cycles(
        graph,
        threshold_multiplicity=cfs.threshold_multiplicity,
        cycle_min_length=cfs.cycle_min_length,
        cycle_max_length=cfs.cycle_max_length,
        verbose=verbose,
        full_prune=True,
    )
    result.graph = graph
    result.cycles_map = cycles_map
    host = graph.to_host()

    if verbose:
        print("FILTERS START:")
    filters = Filters(host, cycles_map)
    systems, n_spacers = filters.list_arrays()
    if verbose:
        print(f"Number of spacers: {n_spacers} before cleaning")
        print("POST PROCESSING START:")
    analyzer = CRISPRAnalyzer(systems, settings.output_file or "CRISPR_Arrays.txt")
    result.report_text = analyzer.run_analysis()
    if verbose:
        print(f"Saved in: {analyzer.output_path}")
    systems_from_analyzer = analyzer.get_systems()
    repeat_to_spacer_nodes = create_repeat_to_spacer_nodes(host, systems_from_analyzer)
    if verbose:
        print(
            f"Created repeat_to_spacer_nodes map with "
            f"{len(repeat_to_spacer_nodes)} entries."
        )

    isolator = IsolateProtospacers.from_repeat_to_spacer_nodes(
        host, repeat_to_spacer_nodes
    )
    in_map, out_map = isolator.get_protospacer_nodes()
    grouped = isolator.depth_limited_paths_from_in_to_out(in_map, out_map, 50, 1)
    out_dir = settings.output_folder or "."
    isolator.write_paths_to_file(
        grouped, os.path.join(out_dir, "grouped_paths_protospacers.txt")
    )

    curator = PhageCurator(graph=host, grouped_paths=grouped, cycles=cycles_map)
    curator.find_quality_paths_beam_search(
        3000, 3010, os.path.join(out_dir, "QualityPaths_BeamWidth50.fasta"), 50
    )
    return result


def _run_pipeline_sharded(
    settings: Settings,
    verbose: bool = True,
    checkpoint_dir: str | None = None,
):
    """Full pipeline with the graph sharded over the device mesh.

    Build, prune, candidate scan and read-window lookups run distributed
    (``parallel/sharded_pipeline.py``); the host combinatorial stages see
    only two small compactions (candidate neighborhood, cycle region).
    With ``checkpoint_dir`` every stage boundary persists SHARDED
    (per-shard npz files — no single-device compaction, so resumable
    runs keep the full multi-chip scale; r3 forced checkpointed runs
    through the single-device path). Returns None if the sharded build
    overflows its capacity retries (caller falls back to the
    single-device path).
    """
    import os

    from mcaat_tpu.parallel.sharded_pipeline import (
        build_sharded_graph_for_pipeline,
        run_sharded_downstream,
        sources_from_batches,
    )
    from mcaat_tpu.utils.profiling import Profiler

    prof = Profiler()
    t0 = time.time()

    graph_ck_dir = (
        os.path.join(checkpoint_dir, "graph_sharded") if checkpoint_dir else None
    )
    sg = None
    input_batches = None
    if graph_ck_dir and os.path.exists(os.path.join(graph_ck_dir, "meta.json")):
        from mcaat_tpu import checkpoint as ckpt
        from mcaat_tpu.parallel.sharded import make_pipeline_mesh

        try:
            sg = ckpt.load_sharded_graph(graph_ck_dir, make_pipeline_mesh())
        except ValueError:
            sg = None  # mesh/kp mismatch: rebuild below
        if sg is not None and verbose:
            print(
                f"Graph loaded from sharded checkpoint: {sg.n_nodes} nodes"
            )
    if sg is None:
        input_batches = _load_input_batches(settings)
        codes, lengths = _concat_batches(input_batches)
        with prof.stage("graph_build"):
            sg = build_sharded_graph_for_pipeline(codes, lengths, settings)
        if sg is None:
            return None
        if graph_ck_dir:
            from mcaat_tpu import checkpoint as ckpt

            ckpt.save_sharded_graph(graph_ck_dir, sg)
        if verbose:
            print(
                f"Graph built (sharded over {dict(sg.mesh.shape)}): "
                f"capacity {sg.kmers.size} rows ({time.time() - t0:.2f}s)"
            )
    # the mapper reuses the parsed batches — zero FASTQ re-parses. On a
    # graph-checkpoint resume nothing was parsed yet; sources_from_batches
    # falls back to parsing (once) only if the mapping stage actually runs.
    f1, f2 = settings.fastq_files()
    if input_batches is not None:
        batches_by_path: dict = {}
        for path, b in input_batches:
            batches_by_path.setdefault(path, b)
        map_sources = sources_from_batches(sg, batches_by_path, f1, f2)
        # the MapSources hold the only references the mapper needs; drop
        # the frame-level ones so MapSource.release() frees the parsed
        # code matrices after mapping (VERDICT r4 #2)
        del input_batches, batches_by_path, codes, lengths, b
    else:
        map_sources = None
    result = run_sharded_downstream(
        sg, settings, verbose=verbose, profiler=prof,
        map_sources=map_sources, checkpoint_dir=checkpoint_dir,
    )
    if verbose:
        print(f"Total time: {time.time() - t0:.2f}s")
    return result


def run_pipeline(
    settings: Settings,
    verbose: bool = True,
    checkpoint_dir: str | None = None,
) -> PipelineResult:
    """Full release pipeline (≙ src/main.cpp:496-591).

    With ``checkpoint_dir``, every stage boundary is persisted (graph
    .npz, cycles/reads JSON) and completed stages are skipped on rerun —
    first-class stage resume (SURVEY §5; the reference only materializes
    the graph folder and deletes it at the end).

    With multiple devices and ``settings.mesh != "off"`` the graph stays
    sharded over the mesh through build → prune → candidate scan →
    read mapping (``parallel/sharded_pipeline.py``); only the candidate
    neighborhood and the cycle region are ever compacted. Checkpointed
    sharded runs persist per-shard artifacts (``graph_sharded/``,
    ``valid_pruned/``) — resume never compacts the graph to one device.
    """
    import os

    from mcaat_tpu.utils.profiling import Profiler, compile_counter

    configure_threads(settings.threads)
    start_ordering_server()
    if _sharded_mode(settings):
        result = _run_pipeline_sharded(
            settings, verbose, checkpoint_dir=checkpoint_dir
        )
        if result is not None:
            return result

    prof = Profiler()
    cc0 = compile_counter().snapshot()
    result = PipelineResult()
    t0 = time.time()

    ckpt = None
    if checkpoint_dir:
        from mcaat_tpu import checkpoint as ckpt

        os.makedirs(checkpoint_dir, exist_ok=True)

    def _ck(name: str) -> str:
        return os.path.join(checkpoint_dir, name)

    graph_ck = checkpoint_dir and os.path.exists(_ck("graph.npz"))
    input_batches = None
    input_endpoints: dict = {}
    if graph_ck:
        graph = ckpt.load_graph(_ck("graph.npz"))
        if verbose:
            print(f"Graph loaded from checkpoint: {graph.size} nodes")
    else:
        with prof.stage("graph_build"):
            input_batches = _load_input_batches(settings)
            graph = build_graph_from_settings(
                settings, verbose=verbose, batches=input_batches,
                endpoints_out=input_endpoints,
            )
        prof.count("graph_build", nodes=graph.size)
        if checkpoint_dir:
            ckpt.save_graph(_ck("graph.npz"), graph)
        if verbose:
            print(f"Graph built: {graph.size} nodes ({time.time() - t0:.2f}s)")
    result.graph = graph

    cfs = settings.cycle_finder_settings
    if checkpoint_dir and os.path.exists(_ck("cycles.json")):
        cycles_map = ckpt.load_cycles(_ck("cycles.json"))
        graph = ckpt.load_graph(_ck("graph_pruned.npz"))
        if verbose:
            print(f"Cycles loaded from checkpoint: {len(cycles_map)} start nodes")
    else:
        with prof.stage("cycle_search"):
            graph, cycles_map = find_cycles(
                graph,
                threshold_multiplicity=cfs.threshold_multiplicity,
                cycle_min_length=cfs.cycle_min_length,
                cycle_max_length=cfs.cycle_max_length,
                verbose=verbose,
            )
        prof.count("cycle_search", start_nodes=len(cycles_map))
        if checkpoint_dir:
            ckpt.save_cycles(_ck("cycles.json"), cycles_map)
            ckpt.save_graph(_ck("graph_pruned.npz"), graph)
    result.cycles_map = cycles_map
    result.cycles = cycles_map_to_cycles(cycles_map)
    if verbose:
        print(f"Number of nodes in results: {len(cycles_map)}")
        print("🔸STEP 6: Finding relevant reads")

    # region-first mapping (VERDICT r4 #5): at condense scale the cycle
    # REGION (the read_len-hop expansion the ordering stage needs anyway)
    # is grown BEFORE the chain lookup, and the kept chains join against
    # its ~1e5-row node table instead of the full one (a 10x smaller
    # sort-join at the 796M-window shape). The mask is reused by STEP 7.
    region_state: dict = {}

    def _region_provider(read_chain_len: int):
        import jax.numpy as jnp

        from mcaat_tpu.cycles.neighborhood import undirected_region_mask

        seeds = np.asarray(
            sorted({n for c in result.cycles for n in c}), dtype=np.int64
        )
        mask = undirected_region_mask(
            graph, seeds, read_chain_len, verbose=verbose
        )
        region_state["mask"] = mask
        region_state["read_chain_len"] = read_chain_len
        gids = np.nonzero(mask)[0]
        if len(gids) == 0:
            return None
        # gids ascending + kmers sorted ⇒ the gathered table is sorted
        return graph.kmers[jnp.asarray(gids)], jnp.asarray(gids)

    use_region_join = graph.size >= _condense_threshold()

    if checkpoint_dir and os.path.exists(_ck("reads.json")):
        reads = ckpt.load_reads(_ck("reads.json"))
        if verbose:
            print(f"Reads loaded from checkpoint: {len(reads)}")
    else:
        f1, f2 = settings.fastq_files()
        with prof.stage("read_mapping"):
            # first occurrence wins on a duplicated path: same file bytes,
            # same ReadBatch (get_reads maps each of f1/f2 once)
            batches_by_path = None
            if input_batches is not None:
                batches_by_path = {}
                for path, b in input_batches:
                    batches_by_path.setdefault(path, b)
            reads = get_reads(
                graph, f1, f2, result.cycles, verbose=verbose,
                batches=batches_by_path, endpoints=input_endpoints or None,
                region_provider=_region_provider if use_region_join else None,
            )
        prof.count("read_mapping", reads=len(reads))
        if checkpoint_dir:
            ckpt.save_reads(_ck("reads.json"), reads)
    result.reads = reads
    if verbose:
        print(f"    ▸ Found {len(reads)} reads")
        print("🔸STEP 7: Order the spacers")

    region_mask = None
    if reads and region_state.get("read_chain_len") == len(reads[0]):
        region_mask = region_state.get("mask")
    with prof.stage("spacer_ordering"):
        graph, found_systems = spacer_ordering_step(
            graph, reads, result.cycles, verbose, region_mask=region_mask
        )
    prof.count("spacer_ordering", systems=len(found_systems))
    result.graph = graph
    result.found_systems = found_systems

    if settings.benchmark_file:
        if verbose:
            print("🔸STEP 8: Compare to ground of truth using benchmark file")
        benchmark_results(settings, found_systems)
    elif verbose:
        print("🔸STEP 8: Results")
        print_results(found_systems)

    all_systems: dict[str, list[str]] = {}
    for fs in found_systems:
        all_systems[fs.repeat] = fs.spacers
    analyzer = CRISPRAnalyzer(all_systems, settings.output_file or "CRISPR_Arrays.txt")
    with prof.stage("report"):
        result.report_text = analyzer.run_analysis()
    result.profile = prof
    if verbose:
        print(f"Saved in: {analyzer.output_path}")
        print("Stage timings:")
        print(prof.report())
        n_c, s_c = compile_counter().delta(cc0)
        print(f"XLA compiles this run: {n_c} programs, {s_c:.1f}s")
        print(f"Total time: {time.time() - t0:.2f}s")
    return result
