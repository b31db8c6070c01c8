"""FASTQ/FASTA ingest.

Replaces the reference's kseqpp-based reader (``src/reads.cpp:3-18``) and
megahit's ``SequenceLibCollection`` binary read library (reference
``src/sdbg_build.cpp:59-115``). Reads are parsed on host, 2-bit encoded,
and packed into a dense padded ``[R, Lmax]`` uint8 matrix ready for device
k-mer extraction — the device-side equivalent of megahit's packed read
format.

Base encoding: A=0, C=1, G=2, T=3. Any non-ACGT character is encoded as T,
mirroring the reference's lookup coding where "other" maps to the same code
as T (``src/reads.cpp:44-53``: A=1,C=2,G=3,T/other=4).

If the optional native C++ extension (``native/``) is built, parsing is
delegated to it; otherwise a pure-Python parser is used.
"""

from __future__ import annotations

import gzip
from dataclasses import dataclass
from typing import Iterable, Optional

import numpy as np

_COMP = str.maketrans("ACGTacgt", "TGCAtgca")

# base -> 2-bit code lookup table; non-ACGT -> 3 (T)
_ENCODE_LUT = np.full(256, 3, dtype=np.uint8)
for i, b in enumerate("ACGT"):
    _ENCODE_LUT[ord(b)] = i
    _ENCODE_LUT[ord(b.lower())] = i

_DECODE = np.frombuffer(b"ACGT", dtype=np.uint8)


def _open_maybe_gzip(path: str):
    with open(path, "rb") as probe:
        magic = probe.read(2)
    if magic == b"\x1f\x8b":
        return gzip.open(path, "rt")
    return open(path, "r")


def read_sequences(path: str) -> list[str]:
    """Parse FASTA or FASTQ (optionally gzipped) and return sequences.

    Behavioral parity with ``extract_sequences_from_fastq_file``
    (reference ``src/reads.cpp:3-18``): returns the sequence of every
    record, in file order.
    """
    try:
        from mcaat_tpu.native import native_available, parse_fastx

        if native_available():
            return parse_fastx(path)
    except ImportError:
        pass
    return _read_sequences_py(path)


def parse_fastx_chunk(chunk: bytes) -> list[str]:
    """Parse FASTA/FASTQ records from an in-memory byte slice (must start
    at a record boundary). Single parser shared with the file path — the
    multi-host byte-range reader (parallel/multihost.py) uses this so
    chunked and whole-file parsing can never diverge."""
    import io

    if not chunk:
        return []
    return _parse_fastx_handle(
        io.StringIO(chunk.decode("ascii", errors="replace"))
    )


def _read_sequences_py(path: str) -> list[str]:
    try:
        with _open_maybe_gzip(path) as fh:
            return _parse_fastx_handle(fh)
    except Exception as e:  # parity: reference logs and returns what it has
        print(f'Error reading file "{path}" sequences because: {e}')
        return []


def _parse_fastx_handle(fh) -> list[str]:
    sequences: list[str] = []
    first = fh.read(1)
    if not first:
        return sequences
    if first == ">":
        # FASTA (possibly multi-line sequences)
        seq_parts: list[str] = []
        fh.readline()  # rest of header
        for line in fh:
            line = line.rstrip("\n\r")
            if line.startswith(">"):
                if seq_parts:
                    sequences.append("".join(seq_parts))
                    seq_parts = []
            elif line:
                seq_parts.append(line)
        if seq_parts:
            sequences.append("".join(seq_parts))
    elif first == "@":
        # FASTQ: 4-line records
        fh.readline()  # rest of header
        while True:
            seq = fh.readline()
            if not seq:
                break
            sequences.append(seq.strip())
            plus = fh.readline()
            qual = fh.readline()
            if not plus or not qual:
                break
            header = fh.readline()
            if not header:
                break
    else:
        raise ValueError(f"Unrecognized FASTA/FASTQ start byte {first!r}")
    return sequences


def reverse_complement(sequence: str) -> str:
    """Reverse complement; non-ACGT characters pass through reversed.

    Parity with ``reverse_pair_ends_sequence`` (reference
    ``src/reads.cpp:20-31``).
    """
    return sequence.translate(_COMP)[::-1]


@dataclass
class ReadBatch:
    """Dense padded 2-bit-coded reads: ``codes[R, Lmax]`` uint8, lengths[R]."""

    codes: np.ndarray  # uint8 [R, Lmax], padded with 0
    lengths: np.ndarray  # int32 [R]

    @property
    def num_reads(self) -> int:
        return int(self.codes.shape[0])

    @property
    def max_len(self) -> int:
        return int(self.codes.shape[1])


def encode_sequences(
    sequences: Iterable[str], max_len: Optional[int] = None, pad_to_multiple: int = 1
) -> ReadBatch:
    """Encode ASCII sequences into a padded 2-bit-code matrix."""
    seqs = list(sequences)
    lengths = np.array([len(s) for s in seqs], dtype=np.int32)
    if max_len is None:
        max_len = int(lengths.max()) if len(seqs) else 0
    if pad_to_multiple > 1 and max_len % pad_to_multiple:
        max_len += pad_to_multiple - max_len % pad_to_multiple
    codes = np.zeros((len(seqs), max_len), dtype=np.uint8)
    for i, s in enumerate(seqs):
        raw = np.frombuffer(s.encode("ascii"), dtype=np.uint8)[:max_len]
        codes[i, : len(raw)] = _ENCODE_LUT[raw]
    return ReadBatch(codes=codes, lengths=np.minimum(lengths, max_len))


def read_encoded_batch(path: str) -> ReadBatch:
    """Parse a FASTA/FASTQ(.gz) file directly into a ReadBatch.

    Fast path: the native C++ parser fills the padded 2-bit matrix without
    materializing Python strings. Falls back to the Python parser.
    """
    try:
        from mcaat_tpu.native import parse_fastx_batch

        res = parse_fastx_batch(path)
        if res is not None:
            codes, lengths = res
            return ReadBatch(codes=codes, lengths=lengths)
    except ImportError:
        pass
    return encode_sequences(_read_sequences_py(path))


def reverse_complement_batch(batch: ReadBatch) -> ReadBatch:
    """Reverse-complement every row of a code matrix (host numpy)."""
    codes = batch.codes
    lengths = batch.lengths
    out = np.zeros_like(codes)
    comp = (3 - codes.astype(np.int16)).astype(np.uint8)
    for i in range(codes.shape[0]):
        L = int(lengths[i])
        out[i, :L] = comp[i, :L][::-1]
    return ReadBatch(codes=out, lengths=lengths.copy())


def decode_kmer(packed: int, k: int) -> str:
    """Decode a 2-bit packed k-mer integer (big-endian base order) to str."""
    chars = []
    for shift in range(2 * (k - 1), -2, -2):
        chars.append("ACGT"[(int(packed) >> shift) & 3])
    return "".join(chars)


def encode_kmer(kmer: str) -> int:
    """Pack a k-mer string into a 2-bit integer (first base = high bits)."""
    v = 0
    for ch in kmer:
        code = {"A": 0, "C": 1, "G": 2, "T": 3}.get(ch.upper(), 3)
        v = (v << 2) | code
    return v
