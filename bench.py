"""Benchmark: the BASELINE.md metric set on one chip.

Prints ONE JSON line: {"metric", "value", "unit", "vs_baseline", "extra"}.
The primary metric stays graph-build k-mer throughput (comparable to
round 1); "extra" carries the full BASELINE "Reported metrics" row:

* graph_build_kmers_per_s       — uniform-random reads (r1-comparable)
* planted_build_kmers_per_s     — planted-array metagenome (realistic
                                  dedup/multiplicity profile, VERDICT r1
                                  weak #2)
* cycle_search_nodes_per_s      — prune + start-node scan rate over the
                                  planted graph (the analog of the
                                  reference's DLS scan, 100-133k nodes/s
                                  on CPU, src/z_optimization_dev_notes.md:11)
* e2e_reads_per_s_warm          — full pipeline, all programs compiled
* spacer_recovery               — planted-spacer recall of the e2e run
* scaling                       — per-shard row/byte splits, all_to_all
                                  wire bytes and a node-table parity gate
                                  at kp=1 vs kp=8 on the virtual CPU mesh
                                  (wall time labeled emulation overhead)

Baseline: the reference builds + searches a 1-billion-node dBG in ~3 h on
a multi-core CPU (readme.md:15) ≈ 92.6k nodes/s end-to-end; its optimized
start-node scan runs ≈ 100-133k nodes/s. vs_baseline normalizes the
primary metric against 100k/s.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time

import numpy as np

import mcaat_tpu  # noqa: F401  (x64 config)
import jax
import jax.numpy as jnp

from mcaat_tpu.graph.dbg import _build_adjacency
from mcaat_tpu.kmer.count import (
    count_unique,
    derive_nodes_from_edges,
    extract_kmers,
    extract_last_kmer,
)

K = 23
BASELINE_NODES_PER_S = 100_000.0  # reference DLS-optimized rate (BASELINE.md)


def log(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


def synth_reads(n_reads: int, length: int, seed: int = 0):
    rng = np.random.default_rng(seed)
    codes = rng.integers(0, 4, size=(n_reads, length)).astype(np.uint8)
    lengths = np.full(n_reads, length, dtype=np.int32)
    return jnp.asarray(codes), jnp.asarray(lengths)


@jax.jit
def build_step(codes, lengths):
    # production build path (build_dbg_from_reads): single 24-mer
    # extraction + count; the 23-mer node table AND the per-edge source
    # ids are derived from the unique edge table (prefix identity), so
    # only the destination endpoint needs a sort-join (_join_lookup1)
    km1 = extract_kmers(codes, lengths, K + 1).reshape(-1)
    u24, c24, n24 = count_unique(km1)
    last = extract_last_kmer(codes, lengths, K)
    u_l, c_l, _n_l = count_unique(last)
    u23, c23, n23, u_id = derive_nodes_from_edges(u24, c24, n24, u_l, c_l)
    out, in_ = _build_adjacency(u23, u24, n24, u_id=u_id)
    return n23, n24, jnp.sum(out >= 0)


def bench_uniform_build():
    n_reads, length = 100_000, 100
    codes, lengths = synth_reads(n_reads, length)
    n_windows = n_reads * (length - K + 1)

    def run():
        return jax.block_until_ready(build_step(codes, lengths))

    run()  # warmup/compile
    iters = 3
    t0 = time.perf_counter()
    for _ in range(iters):
        run()
    dt = (time.perf_counter() - t0) / iters
    return n_windows / dt


def bench_planted(meta, fq_path):
    """Planted-metagenome build + cycle-scan + e2e rates."""
    from mcaat_tpu.cycles.finder import find_cycles
    from mcaat_tpu.graph.dbg import build_dbg_from_reads
    from mcaat_tpu.io.fastq import read_encoded_batch, reverse_complement
    from mcaat_tpu.pipeline import run_pipeline
    from mcaat_tpu.settings import Settings

    batch = read_encoded_batch(fq_path)
    n_windows = 2 * int(np.maximum(batch.lengths - K + 1, 0).sum())  # + RC strand

    def build():
        return jax.block_until_ready(
            build_dbg_from_reads(batch.codes, batch.lengths, k=K)
        )

    g = build()  # compile
    t0 = time.perf_counter()
    g = build()
    build_dt = time.perf_counter() - t0
    planted_build_rate = n_windows / build_dt

    # cycle-search scan rate (prune + candidate scan + self-reach + enum)
    def search():
        return find_cycles(g, verbose=False)

    search()  # compile
    t0 = time.perf_counter()
    _g2, cycles_map = search()
    search_dt = time.perf_counter() - t0
    scan_rate = g.size / search_dt

    # e2e (warm): second in-process run reuses every compiled program
    out_file = os.path.join(os.path.dirname(fq_path), "CRISPR_Arrays.txt")
    s = Settings(input_files=fq_path, output_file=out_file)
    run_pipeline(s, verbose=False)
    t0 = time.perf_counter()
    result = run_pipeline(s, verbose=False)
    e2e_dt = time.perf_counter() - t0
    n_reads = batch.num_reads
    reads_per_s = n_reads / e2e_dt

    hits = total = 0
    for arr in meta["arrays"]:
        for sp in arr["spacers"]:
            total += 1
            core = sp[6:-6]
            if core in result.report_text or reverse_complement(core) in result.report_text:
                hits += 1
    return {
        "planted_build_kmers_per_s": round(planted_build_rate, 1),
        "cycle_search_nodes_per_s": round(scan_rate, 1),
        "graph_nodes": int(g.size),
        "n_cycles": sum(len(v) for v in cycles_map.values()),
        "e2e_reads_per_s_warm": round(reads_per_s, 1),
        "e2e_seconds_warm": round(e2e_dt, 2),
        "n_reads": n_reads,
        "spacer_recovery": f"{hits}/{total}",
    }


def bench_scaling(fq_path):
    """Sharded-build SCALING EVIDENCE at kp ∈ {1, 8} on the virtual CPU
    mesh (BASELINE "Reported metrics" row; replaces the r2 kp wall-time
    pair, which only measured XLA-CPU collective emulation and read as a
    regression — VERDICT r2 weak #1).

    Actionable numbers per kp:
      * live_rows_max/min_per_shard — the memory split (max ≈ N/kp when
        the k-mer radix partition is balanced)
      * store_mb_per_shard          — graph-store HBM per device
        (kmers 8B + mult 4B + out/in 4x4B each per capacity row)
      * a2a_wire_mb_per_device      — bytes each device puts on the
        interconnect in the build's all_to_all rounds (static shapes:
        6 routed arrays of [kp, route_cap], 5 int64 + 1 int32)
      * node_table_sha1             — correctness gate: kp=8 must hash
        identical to kp=1

    Wall seconds ARE reported but labeled emulation overhead: a virtual
    CPU mesh serializes collectives through one process and says nothing
    about ICI scaling.
    """
    script = (
        "import sys, time, hashlib, numpy as np\n"
        "sys.path.insert(0, '.')\n"
        "from mcaat_tpu.io.fastq import read_encoded_batch\n"
        "from mcaat_tpu.kmer.count import SENTINEL\n"
        "from mcaat_tpu.parallel.sharded_pipeline import build_sharded_graph_for_pipeline\n"
        "from mcaat_tpu.settings import Settings\n"
        f"b = read_encoded_batch({fq_path!r})\n"
        "s = Settings()\n"
        "sg = build_sharded_graph_for_pipeline(b.codes, b.lengths, s)  # compile\n"
        "t0 = time.perf_counter()\n"
        "sg = build_sharded_graph_for_pipeline(b.codes, b.lengths, s)\n"
        "dt = time.perf_counter() - t0\n"
        "kmers = np.asarray(sg.kmers)\n"
        "live = kmers != int(SENTINEL)\n"
        "rows = live.sum(axis=1)\n"
        "kp, T = kmers.shape\n"
        "store_b = T * (8 + 4 + 4 * 4 + 4 * 4)\n"
        "flat = np.sort(kmers[live].ravel())\n"
        "h = hashlib.sha1(flat.tobytes()).hexdigest()[:16]\n"
        "import jax\n"
        "st = jax.local_devices()[0].memory_stats() or {}\n"
        "peak = st.get('peak_bytes_in_use', -1)\n"
        "print('KP_STATS', kp, T, int(rows.max()), int(rows.min()),"
        " store_b, round(dt, 2), h, sg.route_cap, peak)\n"
    )
    out = {}
    for n_dev in (1, 8):
        env = dict(os.environ)
        env["JAX_PLATFORMS"] = "cpu"
        env["XLA_FLAGS"] = f"--xla_force_host_platform_device_count={n_dev}"
        try:
            res = subprocess.run(
                [sys.executable, "-c", script],
                env=env,
                capture_output=True,
                text=True,
                timeout=600,
                cwd=os.path.dirname(os.path.abspath(__file__)),
            )
            for line in res.stdout.splitlines():
                if line.startswith("KP_STATS"):
                    _, kp, T, rmax, rmin, store_b, dt, h, rcap, peak = (
                        line.split()
                    )
                    kp = int(kp)
                    # 6 routed [kp, route_cap] arrays per device in the
                    # build (edges, last-windows, v-lookup send + int32
                    # back, in-adjacency key + payload)
                    wire_b = kp * int(rcap) * (8 * 5 + 4)
                    out[f"kp{kp}"] = {
                        "live_rows_max_per_shard": int(rmax),
                        "live_rows_min_per_shard": int(rmin),
                        "shard_capacity": int(T),
                        "capacity_over_max_live": round(
                            int(T) / max(int(rmax), 1), 2
                        ),
                        "store_mb_per_shard": round(int(store_b) / 2**20, 1),
                        "a2a_wire_mb_per_device": round(wire_b / 2**20, 1),
                        "emulation_wall_s": float(dt),
                        "node_table_sha1": h,
                        "device_peak_bytes": int(peak),  # -1: backend
                        # exposes no memory_stats (virtual CPU devices)
                    }
        except (subprocess.TimeoutExpired, OSError):
            out[f"kp{n_dev}"] = None
    k1, k8 = out.get("kp1"), out.get("kp8")
    out["node_table_parity"] = bool(
        k1 and k8 and k1["node_table_sha1"] == k8["node_table_sha1"]
    )
    out["note"] = (
        "virtual CPU mesh: emulation_wall_s measures XLA-CPU collective "
        "emulation in one process, not device scaling; the actionable "
        "scaling facts are the per-shard row/byte splits, the "
        "node-proportional capacity ratio and the parity gate"
    )
    return out


def main():
    sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), "tests"))
    from synthetic import make_metagenome, write_fastq

    log("bench: uniform-build ...")
    uniform_rate = bench_uniform_build()
    log(f"bench: uniform build {uniform_rate/1e6:.2f}M kmers/s")

    meta = make_metagenome(
        seed=123,
        n_arrays=20,
        n_spacers=6,
        background_len=200_000,
        background_coverage=8.0,
        coverage=35.0,
    )
    import tempfile

    fq_path = os.path.join(tempfile.mkdtemp(prefix="mcaat_bench_"), "reads.fq")
    write_fastq(fq_path, meta["reads"])
    log(f"bench: planted metagenome with {len(meta['reads'])} reads ...")
    extra = bench_planted(meta, fq_path)
    log(f"bench: planted {extra}")

    log("bench: scaling evidence (virtual CPU mesh subprocesses) ...")
    extra["scaling"] = bench_scaling(fq_path)
    log(f"bench: scaling {extra['scaling']}")

    print(
        json.dumps(
            {
                "metric": "graph_build_kmers_per_s_per_chip",
                "value": round(uniform_rate, 1),
                "unit": "kmers/s",
                "vs_baseline": round(uniform_rate / BASELINE_NODES_PER_S, 2),
                "extra": extra,
            }
        )
    )


if __name__ == "__main__":
    main()
