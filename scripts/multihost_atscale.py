"""At-scale multi-process artifact (VERDICT r3 missing #3 / next #3).

Runs the FULL multi-host pipeline — 2 jax.distributed processes x 4
virtual CPU devices, kp spanning both processes — on a metagenome sized
to a multi-million-node graph (production k=23, RC on), and records:

  * per-shard live rows vs the allocated (node-proportional) capacity
  * build + pipeline wall times (labeled CPU-mesh emulation)
  * peak host RSS per process
  * node-table SHA parity: distributed build vs single-process build
  * report parity: multi-host report vs single-process `run_pipeline`

Prints the record as JSON. Scale knobs:
MCAAT_AS_BACKGROUND (default 3_000_000 bp), MCAAT_AS_ARRAYS (20),
MCAAT_AS_COUNT_ROWS (per-part per-shard counting budget — set low to
force n_parts > 1 through the per-shard merge stacks, VERDICT r4 #3).

r5 additions: per-stage host-RSS attribution (VERDICT r4 #2), per-stage
routed-collective wire volumes (VERDICT r4 #1), and the multi-part
distributed counting evidence.

Usage:  python scripts/multihost_atscale.py
"""

from __future__ import annotations

import json
import os
import socket
import subprocess
import sys
import tempfile
import time

# a CPU emulation of several hosts: every process runs on the CPU backend
os.environ["JAX_PLATFORMS"] = "cpu"

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)
sys.path.insert(0, os.path.join(REPO, "tests"))

N_PROC = 2
LOCAL_DEVICES = 4


def parent() -> int:
    from synthetic import make_metagenome, write_fastq

    background = int(os.environ.get("MCAAT_AS_BACKGROUND", "3000000"))
    n_arrays = int(os.environ.get("MCAAT_AS_ARRAYS", "20"))
    t0 = time.time()
    meta = make_metagenome(
        seed=97,
        n_arrays=n_arrays,
        n_spacers=6,
        coverage=30.0,
        background_len=background,
        background_coverage=4.0,
    )
    tmpdir = tempfile.mkdtemp(prefix="mcaat_atscale_")
    fq = os.path.join(tmpdir, "reads.fq")
    write_fastq(fq, meta["reads"])
    n_reads = len(meta["reads"])
    est_windows = 2 * sum(max(len(r) - 23, 0) for r in meta["reads"][:1000])
    est_windows = est_windows * n_reads // min(n_reads, 1000)
    print(
        f"generated {n_reads} reads (~{est_windows/1e6:.0f}M windows w/RC, "
        f"background {background/1e6:.1f}Mbp) in {time.time()-t0:.1f}s",
        flush=True,
    )

    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]

    t_mh = time.time()
    procs = []
    for pid in range(N_PROC):
        env = dict(os.environ)
        env["JAX_PLATFORMS"] = "cpu"
        env["XLA_FLAGS"] = f"--xla_force_host_platform_device_count={LOCAL_DEVICES}"
        env["MCAAT_COORDINATOR"] = f"localhost:{port}"
        env["MCAAT_NUM_PROCESSES"] = str(N_PROC)
        env["MCAAT_PROCESS_ID"] = str(pid)
        env["MCAAT_AS_FASTQ"] = fq
        if "MCAAT_AS_COUNT_ROWS" in os.environ:
            env["MCAAT_COUNT_SHARD_ROWS"] = os.environ["MCAAT_AS_COUNT_ROWS"]
        # children advance in lockstep through jax.distributed collectives;
        # PIPEs read sequentially can deadlock once a later child fills its
        # 64KB buffer while child 0 still runs (ADVICE r4) — log to files
        log_f = open(os.path.join(tmpdir, f"child{pid}.log"), "w+")
        procs.append(
            (
                subprocess.Popen(
                    [sys.executable, os.path.abspath(__file__)],
                    env=env,
                    stdout=log_f,
                    stderr=subprocess.STDOUT,
                    text=True,
                ),
                log_f,
            )
        )
    child_stats = [None] * N_PROC
    ok = True
    for pid, (p, log_f) in enumerate(procs):
        p.wait(timeout=14400)
        log_f.seek(0)
        out = log_f.read()
        log_f.close()
        for line in out.splitlines():
            if line.startswith("ATSCALE_STATS "):
                child_stats[pid] = json.loads(line[len("ATSCALE_STATS "):])
        if p.returncode != 0 or child_stats[pid] is None:
            ok = False
            print(f"--- child {pid} (rc={p.returncode}) ---")
            print(out[-6000:])
    mh_wall = time.time() - t_mh
    if not ok:
        return 1
    print(f"multi-host pipeline done in {mh_wall:.1f}s (emulation)", flush=True)

    # single-process reference: report parity + node-table SHA parity
    import hashlib

    import numpy as np

    from mcaat_tpu.graph.dbg import build_dbg_from_reads
    from mcaat_tpu.io.fastq import read_encoded_batch
    from mcaat_tpu.kmer.count import SENTINEL
    from mcaat_tpu.pipeline import run_pipeline
    from mcaat_tpu.settings import Settings

    t_sp = time.time()
    batch = read_encoded_batch(fq)
    g = build_dbg_from_reads(batch.codes, batch.lengths, k=23)
    km = np.sort(np.asarray(g.kmers)[np.asarray(g.kmers) != int(SENTINEL)])
    sp_sha = hashlib.sha1(km.tobytes()).hexdigest()[:16]
    sp_nodes = int(km.size)
    del g, km

    s = Settings()
    s.input_files = fq
    s.output_file = os.path.join(tmpdir, "sp_CRISPR_Arrays.txt")
    s.mesh = "off"
    ref = run_pipeline(s, verbose=False)
    sp_wall = time.time() - t_sp
    mh_text = open(os.path.join(tmpdir, "mh_CRISPR_Arrays.txt")).read()
    report_parity = mh_text == ref.report_text
    st0 = child_stats[0]
    sha_parity = st0["node_table_sha1"] == sp_sha and all(
        c["node_table_sha1"] == sp_sha for c in child_stats
    )

    live = np.asarray(st0["live_rows_per_shard"], dtype=np.int64)
    artifact = {
        "what": (
            "At-scale multi-process artifact: full multi-host pipeline "
            f"({N_PROC} jax.distributed processes x {LOCAL_DEVICES} virtual "
            "CPU devices, kp spans processes) on a "
            f"{st0['n_nodes']/1e6:.1f}M-node graph; node-proportional "
            "shard capacity, node-table + report parity vs single-process"
        ),
        "n_reads": n_reads,
        "est_windows": est_windows,
        "n_nodes": st0["n_nodes"],
        "mesh": st0["mesh"],
        "n_processes": N_PROC,
        "live_rows_per_shard": st0["live_rows_per_shard"],
        "shard_capacity": st0["shard_capacity"],
        "capacity_over_max_live": round(
            st0["shard_capacity"] / max(int(live.max()), 1), 3
        ),
        "route_cap": st0["route_cap"],
        "build_wall_s_emulation": st0["build_wall_s"],
        "pipeline_wall_s_emulation": round(mh_wall, 1),
        "singleprocess_wall_s": round(sp_wall, 1),
        "peak_rss_gb_per_process": [
            c["peak_rss_gb"] for c in child_stats
        ],
        "n_parts": st0.get("n_parts"),
        "stages_child0": st0.get("stages"),
        "wire_bytes_child0": st0.get("wire"),
        "node_table_parity": bool(sha_parity),
        "report_parity": bool(report_parity),
        "n_systems": st0.get("n_systems"),
        "note": (
            "CPU-mesh emulation: wall seconds measure XLA-CPU collective "
            "emulation serialized through 2 localhost processes on a "
            "2-core box, not device scaling. The scaling facts are the "
            "per-shard splits, the node-proportional capacity and the "
            "parity gates; RSS is per-PROCESS host memory (each process "
            "hosts 4 virtual devices + replicated host orchestration)."
        ),
    }
    print(json.dumps(artifact, indent=2))
    if not (report_parity and sha_parity):
        print("PARITY FAILURE")
        return 1
    print("MULTIHOST ATSCALE PASSED")
    return 0


def child() -> int:
    import resource

    import jax

    from mcaat_tpu.parallel.multihost import (
        initialize_distributed,
        run_pipeline_multihost,
    )
    from mcaat_tpu.settings import Settings

    assert initialize_distributed(), "distributed init failed"
    pid = jax.process_index()
    fq = os.environ["MCAAT_AS_FASTQ"]
    s = Settings()
    s.input_files = fq
    s.output_file = os.path.join(os.path.dirname(fq), "mh_CRISPR_Arrays.txt")
    stats: dict = {}
    result = run_pipeline_multihost(s, verbose=pid == 0, stats_out=stats)
    stats["peak_rss_gb"] = round(
        resource.getrusage(resource.RUSAGE_SELF).ru_maxrss / 2**20, 2
    )
    if pid == 0:
        assert result is not None and result.report_text
        stats["n_systems"] = len(result.found_systems)
    print("ATSCALE_STATS " + json.dumps(stats), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(child() if "MCAAT_PROCESS_ID" in os.environ else parent())
