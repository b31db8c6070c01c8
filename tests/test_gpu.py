"""Card-only checks: a golden report and the fuzz scorer on the GPU.

Skipped without a card. On a GPU machine:
``JAX_PLATFORMS=cuda python -m pytest -m gpu tests/``
(``python chip_smoke.py`` runs the same checks at full size).
"""

import os

import numpy as np
import pytest

pytestmark = pytest.mark.gpu

DATA = os.path.join(os.path.dirname(__file__), "data")


def test_golden_report_on_gpu(gpu, tmp_path):
    from mcaat_tpu.pipeline import run_pipeline
    from mcaat_tpu.settings import Settings

    s = Settings(
        input_files=os.path.join(DATA, "golden_reads.fq"),
        output_file=str(tmp_path / "CRISPR_Arrays.txt"),
    )
    result = run_pipeline(s, verbose=False)
    with open(os.path.join(DATA, "golden_CRISPR_Arrays.txt")) as fh:
        assert result.report_text == fh.read()


def test_ratio_batch_on_gpu_equals_host(gpu):
    from mcaat_tpu.report.batched_fuzz import encode_batch, ratio_batch
    from mcaat_tpu.report.fuzz import ratio

    rng = np.random.default_rng(3)
    a = ["".join("ACGT"[i] for i in rng.integers(0, 4, int(n)))
         for n in rng.integers(20, 65, 4096)]
    b = a[1:] + a[:1]
    a_c, a_l = encode_batch(a)
    b_c, b_l = encode_batch(b)
    got = np.asarray(ratio_batch(a_c, a_l, b_c, b_l))
    want = np.array([ratio(x, y) for x, y in zip(a, b)], np.float32)
    np.testing.assert_array_equal(got, want)
