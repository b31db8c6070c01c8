"""Smoke run of the reads-to-report path on an NVIDIA GPU.

Everything runs in this one process (a second JAX process on the card
would fail for want of memory) and goes through the user's entry point,
``mcaat_tpu.cli.main``. Phases, each on lines of its own:

1. device gate: platform, device kind and count, ``nvidia-smi`` name and
   power limit; anything but a GPU exits non-zero here;
2. native runtime: ``native/mcaat_host.cpp`` is compiled and must load
   (no Python fallback);
3. golden reports: the four committed fixtures must give byte-identical
   ``CRISPR_Arrays.txt`` files;
4. full-size sample (150 planted arrays in a 23.5 Mbp background, about
   1.93M reads and 302M 23-mer windows with the reverse complement): the
   node table and multiplicities must equal a numpy reference, and the
   CLI report must recover every planted array; prints the cold and warm
   walls, the number of compiled programs and the peak device bytes;
5. fuzz scorer: ``ratio_batch`` on 262,144 random pairs and
   ``partial_ratio_pairs`` on a 40-spacer all-pairs set must equal
   ``report/fuzz.py`` exactly;
6. processes: the ordering pool's fork server and resource tracker are
   stopped and waited for, and no process this run started may be left.

The last line is ``{"ok": true, "device": {...}}``; a failed phase exits
non-zero before it.

Without options the run keeps to the first visible card. On a host with
several cards the CLI itself shards over every visible device
(``--mesh auto``); ``--mesh off`` or ``CUDA_VISIBLE_DEVICES=0`` gives a
one-card run there.

``--four-cards`` runs only the multi-card check on a four-GPU host: the
phase-4 sample built and run sharded over the four cards, then on card 0
alone with ``--mesh off``; the reports must be byte-identical and the
node tables must hash the same, and the process phase follows.

When a phase fails, the tail of the last CLI run's console output goes
to stderr.

Usage:  python chip_smoke.py [--four-cards]
"""

from __future__ import annotations

import argparse
import contextlib
import hashlib
import io
import json
import os
import shutil
import subprocess
import sys
import tempfile
import time

REPO = os.path.dirname(os.path.abspath(__file__))
DATA = os.path.join(REPO, "tests", "data")
K = 23

# the ``scripts/`` 302M-window shape: 150 arrays, 23.5 Mbp background
SAMPLE = dict(
    seed=7,
    n_arrays=150,
    n_spacers=6,
    background_len=23_500_000,
    background_coverage=8.0,
    coverage=35.0,
    read_len=100,
)
GOLDENS = [
    ("golden", ["golden_reads.fq"]),
    ("golden_pe", ["golden_pe_1.fq", "golden_pe_2.fq"]),
    ("golden_rc", ["golden_rc_reads.fq"]),
    ("golden_mut", ["golden_mut_reads.fq"]),
]


class SmokeFailure(Exception):
    pass


def check(cond: bool, what: str) -> None:
    if not cond:
        raise SmokeFailure(what)


def say(phase: str, msg: str) -> None:
    print(f"[{phase}] {msg}", flush=True)


def nvidia_smi() -> list[str]:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True,
        text=True,
        check=True,
    ).stdout
    return [ln.strip() for ln in out.splitlines() if ln.strip()]


def device_gate(expect_count: int | None):
    """Phase 1: refuse anything but a GPU. Returns (device, card label)."""
    import jax

    devs = jax.devices()
    d = devs[0]
    say("gate", f"platform={d.platform} kind={d.device_kind} count={len(devs)}")
    if d.platform != "gpu":
        raise SmokeFailure(
            f"no GPU: JAX platform is {d.platform!r}; this smoke never runs "
            "on the CPU"
        )
    if expect_count is not None and len(devs) != expect_count:
        raise SmokeFailure(f"need {expect_count} GPUs, JAX sees {len(devs)}")
    cards = nvidia_smi()
    for line in cards:
        say("gate", f"nvidia-smi: {line}")
    return d, cards[0]


# console output of the last CLI run, shown when a phase fails
_cli_log = io.StringIO()


def run_cli(args: list[str]) -> str:
    """``mcaat_tpu.cli.main`` in-process; returns its console output."""
    global _cli_log
    from mcaat_tpu.cli import main

    _cli_log = io.StringIO()
    with contextlib.redirect_stdout(_cli_log):
        rc = main(args)
    check(rc == 0, f"cli {' '.join(args)} returned {rc}")
    return _cli_log.getvalue()


def phase_native() -> None:
    from mcaat_tpu import native

    t0 = time.perf_counter()
    built = native.build_library()
    check(native.native_available(), "native library did not load")
    say(
        "native",
        f"{'compiled' if built else 'up to date'}: {native._LIB_PATH} "
        f"({time.perf_counter() - t0:.2f}s); {native.build_info()}",
    )
    if built:
        say("native", f"command: {native.last_build_command}")


def phase_goldens(tmp: str) -> None:
    for name, files in GOLDENS:
        out = os.path.join(tmp, name)
        paths = [os.path.join(DATA, f) for f in files]
        t0 = time.perf_counter()
        run_cli(["--input-files", *paths, "--output-folder", out])
        with open(os.path.join(out, "CRISPR_Arrays.txt")) as fh:
            got = fh.read()
        with open(os.path.join(DATA, f"{name}_CRISPR_Arrays.txt")) as fh:
            want = fh.read()
        check(got == want, f"{name}: report differs from the golden file")
        say("golden", f"{name}: byte-identical ({time.perf_counter() - t0:.1f}s)")


def make_sample(tmp: str):
    sys.path.insert(0, os.path.join(REPO, "tests"))
    from synthetic import make_metagenome, write_fastq

    t0 = time.perf_counter()
    meta = make_metagenome(**SAMPLE)
    fq = os.path.join(tmp, "sample.fq")
    write_fastq(fq, meta["reads"])
    n_reads = len(meta["reads"])
    n_windows = 2 * sum(max(len(r) - K + 1, 0) for r in meta["reads"])
    say(
        "sample",
        f"{n_reads} reads, {n_windows} {K}-mer windows with the reverse "
        f"complement, {SAMPLE['n_arrays']} planted arrays "
        f"({time.perf_counter() - t0:.1f}s to generate)",
    )
    return meta, fq


def host_node_table(reads: list[str]):
    """Independent reference: numpy-packed forward and reverse-complement
    23-mer windows, counted with ``np.unique``."""
    import numpy as np

    lengths = {len(r) for r in reads}
    check(len(lengths) == 1, "reference expects equal read lengths")
    L = lengths.pop()
    lut = np.zeros(256, np.uint8)
    for i, b in enumerate(b"ACGT"):
        lut[b] = i
    codes = lut[np.frombuffer("".join(reads).encode(), np.uint8)].reshape(-1, L)

    def windows(c):
        W = L - K + 1
        acc = np.zeros((c.shape[0], W), np.int64)
        for t in range(K):
            acc <<= 2
            acc |= c[:, t : t + W]
        return acc.ravel()

    allw = np.concatenate([windows(codes), windows(3 - codes[:, ::-1])])
    return np.unique(allw, return_counts=True)


def live_table(kmers, mult):
    import numpy as np

    from mcaat_tpu.kmer.count import SENTINEL

    k = np.asarray(kmers).reshape(-1)
    m = np.asarray(mult).reshape(-1)
    live = k != int(SENTINEL)
    k, m = k[live], m[live]
    order = np.argsort(k, kind="stable")
    return k[order], m[order]


def table_sha1(kmers, mult) -> str:
    h = hashlib.sha1(kmers.astype("<i8").tobytes())
    h.update(mult.astype("<i4").tobytes())
    return h.hexdigest()


def planted_recall(meta, report: str):
    from mcaat_tpu.io.fastq import reverse_complement

    hits = total = arrays = 0
    for arr in meta["arrays"]:
        found = 0
        for sp in arr["spacers"]:
            total += 1
            core = sp[6:-6]
            if core in report or reverse_complement(core) in report:
                found += 1
        hits += found
        arrays += found > 0
    return arrays, hits, total


def n_systems(report: str) -> int:
    for line in report.splitlines():
        if line.startswith("Number of Systems:"):
            return int(line.split(":")[1])
    raise SmokeFailure("report has no 'Number of Systems' line")


def stage_lines(log: str) -> list[str]:
    lines = log.splitlines()
    if "Stage timings:" not in lines:
        return []
    return lines[lines.index("Stage timings:") :]


def phase_sample(tmp: str, card: str) -> None:
    import jax
    import jax.numpy as jnp
    import numpy as np

    from mcaat_tpu.graph.dbg import _bucket_size
    from mcaat_tpu.kmer.count import count_unique
    from mcaat_tpu.pipeline import build_graph_from_settings
    from mcaat_tpu.settings import Settings
    from mcaat_tpu.utils.profiling import compile_counter

    meta, fq = make_sample(tmp)
    label = f"one smoke run on {card}; not a benchmark figure"

    walls = {}
    reports = {}
    for run in ("cold", "warm"):
        out = os.path.join(tmp, f"sample_{run}")
        cc0 = compile_counter().snapshot()
        t0 = time.perf_counter()
        log = run_cli(["--input-files", fq, "--output-folder", out])
        walls[run] = time.perf_counter() - t0
        n_prog, s_prog = compile_counter().delta(cc0)
        with open(os.path.join(out, "CRISPR_Arrays.txt")) as fh:
            reports[run] = fh.read()
        say(
            "sample",
            f"CLI {run} wall {walls[run]:.1f}s, {n_prog} programs compiled "
            f"({s_prog:.1f}s) ({label})",
        )
        for line in stage_lines(log):
            say("sample", f"  {line.strip()}")
    check(reports["warm"] == reports["cold"], "warm report differs from cold")

    report = reports["cold"]
    arrays, hits, total = planted_recall(meta, report)
    say(
        "sample",
        f"systems in report: {n_systems(report)} (planted: "
        f"{SAMPLE['n_arrays']}); planted arrays found: {arrays}/"
        f"{SAMPLE['n_arrays']}; planted-spacer recall: {hits}/{total} = "
        f"{100.0 * hits / total:.2f}%",
    )
    check(arrays == SAMPLE["n_arrays"], "a planted array is missing")
    check(hits >= 0.98 * total, "planted-spacer recall below 98%")

    t0 = time.perf_counter()
    graph = build_graph_from_settings(Settings(input_files=fq))
    got_k, got_m = live_table(graph.kmers, graph.mult)
    n_rows = int(graph.kmers.shape[0])
    del graph
    t_dev = time.perf_counter() - t0
    t0 = time.perf_counter()
    ref_k, ref_m = host_node_table(meta["reads"])
    t_ref = time.perf_counter() - t0
    check(
        np.array_equal(got_k, ref_k) and np.array_equal(got_m, ref_m),
        "node table or multiplicities differ from the numpy reference",
    )
    say(
        "sample",
        f"node table: {len(ref_k)} nodes ({n_rows} rows with padding), "
        f"multiplicities sum {int(ref_m.sum())}, equal to the numpy reference "
        f"(build {t_dev:.1f}s, reference {t_ref:.1f}s), sha1 "
        f"{table_sha1(got_k, got_m)}",
    )

    stats = jax.devices()[0].memory_stats() or {}
    say(
        "memory",
        f"peak_bytes_in_use {stats.get('peak_bytes_in_use')} of bytes_limit "
        f"{stats.get('bytes_limit')}",
    )
    # the build's largest program: the window-multiset sort, at the shape
    # graph.dbg.build_dbg_from_reads gives it (bucketed rows, 8-aligned
    # (k+1)-mer window cap, both strands)
    L = SAMPLE["read_len"]
    rows = _bucket_size(len(meta["reads"]))
    w_cap = min(((L + 31) // 32 * 32) - K, (L - K + 7) // 8 * 8)
    n = rows * w_cap * 2
    ma = (
        count_unique.lower(jax.ShapeDtypeStruct((n,), jnp.int64))
        .compile()
        .memory_analysis()
    )
    say(
        "memory",
        f"count_unique[{n}] memory_analysis: argument "
        f"{ma.argument_size_in_bytes}, output {ma.output_size_in_bytes}, "
        f"temp {ma.temp_size_in_bytes}, alias {ma.alias_size_in_bytes} bytes",
    )


def phase_fuzz() -> None:
    import jax.numpy as jnp
    import numpy as np

    from mcaat_tpu.report import fuzz
    from mcaat_tpu.report.batched_fuzz import (
        encode_batch,
        partial_ratio_pairs,
        ratio_batch,
    )

    rng = np.random.default_rng(5)

    def rand_strings(n, lo, hi):
        lens = rng.integers(lo, hi + 1, size=n)
        flat = np.frombuffer(b"ACGT", np.uint8)[rng.integers(0, 4, int(lens.sum()))]
        text = flat.tobytes().decode()
        ends = np.cumsum(lens)
        return [text[e - m : e] for e, m in zip(ends, lens)]

    n = 262_144
    a = rand_strings(n, 20, 64)
    b = rand_strings(n, 20, 64)
    a_c, a_l = encode_batch(a)
    b_c, b_l = encode_batch(b)
    args = [jnp.asarray(x) for x in (a_c, a_l, b_c, b_l)]
    t0 = time.perf_counter()
    got = np.asarray(ratio_batch(*args))
    t_first = time.perf_counter() - t0
    want = np.array([fuzz.ratio(x, y) for x, y in zip(a, b)], np.float32)
    bad = int(np.sum(got != want))
    check(bad == 0, f"ratio_batch differs from report/fuzz.py on {bad} pairs")
    say("fuzz", f"ratio_batch on {n} pairs of 20-64 bp: equal to report/fuzz.py "
        f"(first call incl. compile {t_first:.2f}s)")

    # the all-pairs set CRISPRAnalyzer.filter_substring_spacers builds
    spacers = sorted(rand_strings(40, 23, 50), key=len, reverse=True)
    shorts = [spacers[i] for i in range(40) for j in range(i)]
    longs = [spacers[j] for i in range(40) for j in range(i)]
    got = partial_ratio_pairs(shorts, longs)
    want = np.array(
        [fuzz.partial_ratio(x, y) for x, y in zip(shorts, longs)], np.float32
    )
    bad = int(np.sum(got != want))
    check(bad == 0, f"partial_ratio_pairs differs on {bad} pairs")
    say("fuzz", f"partial_ratio_pairs on the 40-spacer all-pairs set "
        f"({len(shorts)} pairs): equal to report/fuzz.py")


def _descendants(pid: int) -> list[int]:
    """Live (not zombie) descendants of ``pid``, from ``/proc``."""
    children: dict[int, list[int]] = {}
    for name in os.listdir("/proc"):
        if not name.isdigit():
            continue
        try:
            with open(f"/proc/{name}/stat") as fh:
                state, ppid = fh.read().rsplit(")", 1)[1].split()[:2]
        except (OSError, ValueError):
            continue
        if state != "Z":
            children.setdefault(int(ppid), []).append(int(name))
    found, stack = [], [pid]
    while stack:
        kids = children.get(stack.pop(), [])
        found += kids
        stack += kids
    return found


def _running(pid: int) -> bool:
    try:
        with open(f"/proc/{pid}/stat") as fh:
            return fh.read().rsplit(")", 1)[1].split()[0] != "Z"
    except (OSError, IndexError):
        return False


def phase_processes() -> None:
    """Phase 6: stop the ordering pool's fork server and resource tracker
    (``stop_ordering_server`` waits for both); nothing this run started
    may outlive it."""
    from mcaat_tpu.pipeline import stop_ordering_server

    started = _descendants(os.getpid())
    stop_ordering_server()
    left = sorted({p for p in started + _descendants(os.getpid()) if _running(p)})
    check(not left, f"processes still running after the run: {left}")
    say("procs", f"{len(started)} child processes stopped; none left")


def phase_four_cards(tmp: str, card: str) -> None:
    """The sharded path over four cards against card 0 alone."""
    import jax

    from mcaat_tpu.pipeline import (
        _concat_batches,
        _load_input_batches,
        build_graph_from_settings,
    )
    from mcaat_tpu.parallel.sharded_pipeline import (
        build_sharded_graph_for_pipeline,
    )
    from mcaat_tpu.settings import Settings

    label = f"one smoke run on 4x {card}; not a benchmark figure"
    meta, fq = make_sample(tmp)
    settings = Settings(input_files=fq)
    codes, lengths = _concat_batches(_load_input_batches(settings))
    t0 = time.perf_counter()
    sg = build_sharded_graph_for_pipeline(codes, lengths, settings)
    t_build = time.perf_counter() - t0
    del codes, lengths
    check(sg is not None, "sharded build overflowed its routing capacity")
    mesh_shape = dict(sg.mesh.shape)
    check(mesh_shape == {"dp": 1, "kp": 4}, f"mesh is {mesh_shape}")
    shards = sorted(sg.kmers.addressable_shards, key=lambda s: s.index[0].start)
    devices = [s.device for s in shards]
    check(len(set(devices)) == 4, f"shards share devices: {devices}")
    from mcaat_tpu.kmer.count import SENTINEL

    for s, n_live in zip(shards, sg.n_live):
        live = int((jax.numpy.asarray(s.data) != SENTINEL).sum())
        check(live == int(n_live) and live > 0, f"shard on {s.device}: {live}")
        say("cards", f"shard {s.index[0].start} on {s.device}: {live} live rows")
    sha_sharded = table_sha1(*live_table(sg.kmers, sg.mult))
    say("cards", f"sharded build {t_build:.1f}s, mesh {mesh_shape}, node table "
        f"sha1 {sha_sharded} ({label})")
    del sg, shards

    t0 = time.perf_counter()
    log = run_cli(
        ["--input-files", fq, "--output-folder", os.path.join(tmp, "sharded")]
    )
    check("Graph built (sharded over {'dp': 1, 'kp': 4})" in log,
          "the CLI run did not take the sharded path")
    say("cards", f"CLI sharded over 4 cards: {time.perf_counter() - t0:.1f}s "
        f"({label})")

    graph = build_graph_from_settings(Settings(input_files=fq, mesh="off"))
    sha_single = table_sha1(*live_table(graph.kmers, graph.mult))
    del graph
    say("cards", f"card-0 build node table sha1 {sha_single}")
    check(sha_single == sha_sharded, "node-table sha1 differs")

    t0 = time.perf_counter()
    run_cli(
        ["--input-files", fq, "--output-folder", os.path.join(tmp, "single"),
         "--mesh", "off"]
    )
    say("cards", f"CLI on card 0 (--mesh off): {time.perf_counter() - t0:.1f}s "
        f"({label})")
    reports = []
    for name in ("sharded", "single"):
        with open(os.path.join(tmp, name, "CRISPR_Arrays.txt")) as fh:
            reports.append(fh.read())
    check(reports[0] == reports[1], "sharded report differs from card-0 report")
    arrays, hits, total = planted_recall(meta, reports[0])
    say("cards", f"reports byte-identical; planted arrays {arrays}/"
        f"{SAMPLE['n_arrays']}, spacer recall {hits}/{total}")
    for d in jax.devices():
        stats = d.memory_stats() or {}
        say("memory", f"{d}: peak_bytes_in_use {stats.get('peak_bytes_in_use')}")


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument(
        "--four-cards",
        action="store_true",
        help="run only the sharded-vs-one-card check on a four-GPU host",
    )
    opts = ap.parse_args(argv)
    if not opts.four_cards:
        # keep to one card before JAX starts
        visible = os.environ.get("CUDA_VISIBLE_DEVICES")
        os.environ["CUDA_VISIBLE_DEVICES"] = (
            visible.split(",")[0] if visible else "0"
        )
    sys.path.insert(0, REPO)
    import mcaat_tpu  # noqa: F401  (x64, compile cache)

    tmp = tempfile.mkdtemp(prefix="mcaat_smoke_")
    try:
        dev, card = device_gate(4 if opts.four_cards else None)
        if opts.four_cards:
            phase_four_cards(tmp, card)
        else:
            phase_native()
            phase_goldens(tmp)
            phase_sample(tmp, card)
            phase_fuzz()
        phase_processes()
    except Exception as e:
        tail = _cli_log.getvalue().splitlines()[-40:]
        if tail:
            print("chip_smoke: last CLI output:", *tail, sep="\n  ",
                  file=sys.stderr, flush=True)
        if not isinstance(e, SmokeFailure):
            raise
        print(f"chip_smoke: FAILED: {e}", file=sys.stderr, flush=True)
        return 1
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    import jax

    print(
        json.dumps(
            {
                "ok": True,
                "device": {
                    "platform": dev.platform,
                    "kind": dev.device_kind,
                    "count": len(jax.devices()),
                },
            }
        ),
        flush=True,
    )
    return 0


if __name__ == "__main__":
    sys.exit(main())
