"""Golden-output regression test (SURVEY §4: golden-output equality).

The fixture input (``tests/data/golden_reads.fq``) holds a planted CRISPR
array (ground truth in ``golden_truth.json``); the committed
``golden_CRISPR_Arrays.txt`` is the pipeline's canonical output for it.
Any semantic change to graph build, cycle search, ordering, systems
extraction, or the report cascade shows up as a diff here.
"""

import json
import os

import pytest

from mcaat_tpu.pipeline import run_pipeline
from mcaat_tpu.settings import Settings

DATA = os.path.join(os.path.dirname(__file__), "data")


@pytest.fixture(autouse=True)
def _native_umap():
    """The golden reports pin the native (libstdc++ unordered_map)
    repeat-candidate order; the pure-Python fallback is deterministic but
    trims nested candidates in first-seen order (see
    report/analyzer.py::_get_common_kmers)."""
    from mcaat_tpu.native import umap_order

    if umap_order(["A", "B"]) is None:
        pytest.skip("native runtime unavailable (no C++ compiler)")


def test_golden_report_byte_identical(tmp_path):
    s = Settings(
        input_files=os.path.join(DATA, "golden_reads.fq"),
        output_file=str(tmp_path / "CRISPR_Arrays.txt"),
    )
    result = run_pipeline(s, verbose=False)
    expected = open(os.path.join(DATA, "golden_CRISPR_Arrays.txt")).read()
    assert result.report_text == expected


def test_golden_truth_recovered(tmp_path):
    truth = json.load(open(os.path.join(DATA, "golden_truth.json")))
    s = Settings(
        input_files=os.path.join(DATA, "golden_reads.fq"),
        output_file=str(tmp_path / "CRISPR_Arrays.txt"),
    )
    result = run_pipeline(s, verbose=False)
    # the reported repeat is the planted repeat minus its final base
    # (reference quirk) on one strand or the other
    from mcaat_tpu.io.fastq import reverse_complement

    repeat = truth[0]["repeat"]
    assert (
        repeat[:-1] in result.report_text
        or reverse_complement(repeat)[:-1] in result.report_text
    )
    assert "Number of Systems: 1" in result.report_text


def _run_fixture(tmp_path, input_files: str):
    s = Settings(
        input_files=input_files,
        output_file=str(tmp_path / "CRISPR_Arrays.txt"),
    )
    return run_pipeline(s, verbose=False)


def _report_fixture(name: str) -> str:
    return open(os.path.join(DATA, f"{name}_CRISPR_Arrays.txt")).read()


def test_golden_rc_only_array(tmp_path):
    """Array present only on the reverse-complement strand: megahit-style
    both-strand counting must still recover it (src/main_run_and_debug.cpp:54-56)."""
    result = _run_fixture(tmp_path, os.path.join(DATA, "golden_rc_reads.fq"))
    assert result.report_text == _report_fixture("golden_rc")
    truth = json.load(open(os.path.join(DATA, "golden_rc_truth.json")))
    from mcaat_tpu.io.fastq import reverse_complement

    found = sum(
        1
        for sp in truth[0]["spacers"]
        if sp[6:-6] in result.report_text
        or reverse_complement(sp[6:-6]) in result.report_text
    )
    assert found == len(truth[0]["spacers"])


def test_golden_mutated_repeat(tmp_path):
    """One repeat occurrence carries a point mutation; the extension scan
    tolerates point mutations (tmp_utils.cpp:239-263) and the array is
    still reported (possibly split at the mutated occurrence)."""
    result = _run_fixture(tmp_path, os.path.join(DATA, "golden_mut_reads.fq"))
    assert result.report_text == _report_fixture("golden_mut")
    truth = json.load(open(os.path.join(DATA, "golden_mut_truth.json")))
    from mcaat_tpu.io.fastq import reverse_complement

    found = sum(
        1
        for sp in truth[0]["spacers"]
        if sp[6:-6] in result.report_text
        or reverse_complement(sp[6:-6]) in result.report_text
    )
    assert found >= 4  # fixture loses the spacers flanking the mutation
    assert "Number of Systems: 1" in result.report_text


def test_golden_paired_end(tmp_path):
    """Paired-end input: mate-2 file is stored reverse-complemented and
    flipped back by the mapper (reads.cpp:116-127)."""
    files = (
        os.path.join(DATA, "golden_pe_1.fq")
        + " "
        + os.path.join(DATA, "golden_pe_2.fq")
    )
    result = _run_fixture(tmp_path, files)
    assert result.report_text == _report_fixture("golden_pe")
    truth = json.load(open(os.path.join(DATA, "golden_pe_truth.json")))
    from mcaat_tpu.io.fastq import reverse_complement

    found = sum(
        1
        for sp in truth[0]["spacers"]
        if sp[6:-6] in result.report_text
        or reverse_complement(sp[6:-6]) in result.report_text
    )
    assert found == len(truth[0]["spacers"])
