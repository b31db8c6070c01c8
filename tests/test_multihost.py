"""Multi-host scaffolding: per-host input ranges + 2-process dryrun."""

import gzip
import os
import subprocess
import sys

import numpy as np
import pytest

from mcaat_tpu.parallel.multihost import host_byte_range, read_host_shard
from synthetic import make_metagenome, write_fastq

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _all_shards_cover_all_records(path, n_proc):
    from mcaat_tpu.io.fastq import read_encoded_batch

    full = read_encoded_batch(path)
    full_rows = sorted(
        tuple(full.codes[i, : full.lengths[i]]) for i in range(full.num_reads)
    )
    rows = []
    for pid in range(n_proc):
        b = read_host_shard(path, pid, n_proc)
        rows.extend(
            tuple(b.codes[i, : b.lengths[i]]) for i in range(b.num_reads)
        )
    assert sorted(rows) == full_rows


def test_host_ranges_partition_fastq(tmp_path):
    meta = make_metagenome(seed=31, n_arrays=1, n_spacers=3, coverage=10.0)
    fq = str(tmp_path / "r.fq")
    write_fastq(fq, meta["reads"])
    for n_proc in (2, 3, 4):
        _all_shards_cover_all_records(fq, n_proc)
        # byte ranges are disjoint and cover the file
        size = os.path.getsize(fq)
        bounds = [host_byte_range(fq, p, n_proc) for p in range(n_proc)]
        assert bounds[0][0] == 0
        assert bounds[-1][1] == size
        for (a, b), (c, d) in zip(bounds, bounds[1:]):
            assert b == c


def test_host_ranges_partition_fasta(tmp_path):
    fa = str(tmp_path / "r.fa")
    rng = np.random.default_rng(5)
    with open(fa, "w") as fh:
        for i in range(57):
            seq = "".join("ACGT"[b] for b in rng.integers(0, 4, size=80))
            fh.write(f">read{i}\n{seq[:40]}\n{seq[40:]}\n")
    _all_shards_cover_all_records(fa, 2)
    _all_shards_cover_all_records(fa, 3)


def test_host_ranges_gzip_modulo(tmp_path):
    meta = make_metagenome(seed=32, n_arrays=1, n_spacers=3, coverage=5.0)
    fq = str(tmp_path / "r.fq")
    write_fastq(fq, meta["reads"])
    gz = fq + ".gz"
    with open(fq, "rb") as src, gzip.open(gz, "wb") as dst:
        dst.write(src.read())
    _all_shards_cover_all_records(gz, 2)


@pytest.mark.slow
def test_two_process_dryrun():
    """2 jax.distributed processes on localhost: distributed count→build
    collectives across process boundaries (VERDICT r1 item 2)."""
    env = {
        k: v
        for k, v in os.environ.items()
        if not k.startswith("MCAAT_")
    }
    res = subprocess.run(
        [sys.executable, os.path.join(REPO, "scripts", "multihost_dryrun.py")],
        env=env,
        capture_output=True,
        text=True,
        timeout=560,
    )
    assert res.returncode == 0, res.stdout[-4000:] + res.stderr[-2000:]
    assert "MULTIHOST DRYRUN PASSED" in res.stdout
