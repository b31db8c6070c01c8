"""ctypes bindings for the native host runtime (native/mcaat_host.cpp).

The library is compiled from source at first use into
``native/libmcaat_host.so`` (ignored by git), or ahead of time with
``make -C native``; both use the same flags. The build holds a file lock
and renames a finished temporary file into place, so concurrent first
uses (test workers, several processes) compile it once and never load a
half-written file. Without a C++ compiler every entry point degrades to
the pure-Python implementation, and the loader says so once on stderr.
"""

from __future__ import annotations

import ctypes
import os
import shutil
import subprocess
import sys
import tempfile
from typing import Optional

import numpy as np

_NATIVE_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))),
    "native",
)
_SRC_PATH = os.path.join(_NATIVE_DIR, "mcaat_host.cpp")
_LIB_PATH = os.path.join(_NATIVE_DIR, "libmcaat_host.so")
# keep in step with native/Makefile (OpenMP is added per attempt)
_CXXFLAGS = ["-O3", "-std=c++17", "-fPIC", "-Wall"]
_LDFLAGS = ["-shared", "-lz"]

_lib: Optional[ctypes.CDLL] = None
_tried = False
last_build_command: Optional[str] = None


def _up_to_date(src: str, lib: str) -> bool:
    return os.path.exists(lib) and os.path.getmtime(lib) >= os.path.getmtime(src)


def _compilers() -> list[str]:
    """``$CXX`` first, then ``g++`` and ``c++`` from PATH, without repeats."""
    found = []
    for name in (os.environ.get("CXX"), "g++", "c++"):
        path = shutil.which(name) if name else None
        if path and os.path.realpath(path) not in map(os.path.realpath, found):
            found.append(path)
    return found


def build_library(src: str = _SRC_PATH, lib: str = _LIB_PATH) -> bool:
    """Compile ``src`` into the shared library ``lib`` unless it is newer
    than its source. Returns True when this call compiled it. Raises
    RuntimeError when no compiler is found or every compile fails.

    Every compiler is tried with OpenMP before any is tried without it
    (the source guards its OpenMP use, so a compiler that lacks it still
    gives a working, single-threaded library, and says so on stderr).
    The command that compiled it is kept in ``last_build_command``."""
    import fcntl

    global last_build_command
    if _up_to_date(src, lib):
        return False
    compilers = _compilers()
    if not compilers:
        raise RuntimeError("no C++ compiler found (set CXX or install g++)")
    out_dir = os.path.dirname(os.path.abspath(lib))
    with open(os.path.join(out_dir, ".build.lock"), "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        if _up_to_date(src, lib):  # another process built it meanwhile
            return False
        fd, tmp = tempfile.mkstemp(
            prefix="." + os.path.basename(lib) + ".", dir=out_dir
        )
        os.close(fd)
        errors = []
        try:
            for omp in (["-fopenmp"], []):
                for cxx in compilers:
                    cmd = [cxx, *_CXXFLAGS, *omp, src, "-o", tmp, *_LDFLAGS, *omp]
                    res = subprocess.run(cmd, capture_output=True, text=True)
                    if res.returncode == 0:
                        os.replace(tmp, lib)
                        last_build_command = " ".join(cmd).replace(tmp, lib)
                        if not omp:
                            print(
                                f"mcaat_tpu: no compiler accepted -fopenmp; "
                                f"{lib} is single-threaded",
                                file=sys.stderr,
                            )
                        return True
                    errors.append(f"{cxx} {' '.join(omp)}: {res.stderr[-1000:]}")
            raise RuntimeError(f"compiling {src} failed:\n" + "\n".join(errors))
        finally:
            if os.path.exists(tmp):
                os.unlink(tmp)


def _load() -> Optional[ctypes.CDLL]:
    global _lib, _tried
    if _tried:
        return _lib
    _tried = True
    try:
        build_library()
        lib = ctypes.CDLL(_LIB_PATH)
    except (RuntimeError, OSError) as e:
        print(
            f"mcaat_tpu: native runtime unavailable, using the Python "
            f"fallback ({e})",
            file=sys.stderr,
        )
        return None
    c = ctypes
    lib.mcaat_parse_fastx.restype = c.c_int
    lib.mcaat_parse_fastx.argtypes = [
        c.c_char_p,
        c.POINTER(c.POINTER(c.c_uint8)),
        c.POINTER(c.POINTER(c.c_int32)),
        c.POINTER(c.c_int64),
        c.POINTER(c.c_int32),
    ]
    lib.mcaat_free.restype = None
    lib.mcaat_free.argtypes = [c.c_void_p]
    lib.mcaat_enumerate_cycles.restype = c.c_void_p
    lib.mcaat_enumerate_cycles.argtypes = [
        c.POINTER(c.c_int32),
        c.POINTER(c.c_int32),
        c.POINTER(c.c_uint8),
        c.POINTER(c.c_int32),
        c.c_int64,
        c.POINTER(c.c_int64),
        c.c_int64,
        c.c_int,
        c.c_int,
    ]
    for name in ("mcaat_sink_n_groups", "mcaat_sink_n_cycles", "mcaat_sink_flat_size"):
        fn = getattr(lib, name)
        fn.restype = c.c_int64
        fn.argtypes = [c.c_void_p]
    lib.mcaat_sink_copy.restype = None
    lib.mcaat_sink_copy.argtypes = [c.c_void_p] + [c.POINTER(c.c_int64)] * 4
    lib.mcaat_sink_free.restype = None
    lib.mcaat_sink_free.argtypes = [c.c_void_p]
    lib.mcaat_poa_consensus.restype = c.c_int
    lib.mcaat_poa_consensus.argtypes = [
        c.c_char_p,
        c.POINTER(c.c_int64),
        c.c_int64,
        c.c_int,
        c.c_int,
        c.c_int,
        c.POINTER(c.c_char_p),
        c.POINTER(c.c_int64),
    ]
    lib.mcaat_umap_order.restype = c.c_int64
    lib.mcaat_umap_order.argtypes = [
        c.c_char_p,
        c.POINTER(c.c_int64),
        c.c_int64,
        c.POINTER(c.c_int64),
    ]
    lib.mcaat_pack_codes.restype = None
    lib.mcaat_pack_codes.argtypes = [
        c.POINTER(c.c_uint8),
        c.c_int64,
        c.c_int64,
        c.c_int64,
        c.POINTER(c.c_uint8),
    ]
    lib.mcaat_scc.restype = c.c_int64
    lib.mcaat_scc.argtypes = [
        c.POINTER(c.c_int64),
        c.POINTER(c.c_int64),
        c.c_int64,
        c.POINTER(c.c_uint8),
        c.POINTER(c.c_int64),
        c.POINTER(c.c_int64),
    ]
    lib.mcaat_set_threads.restype = None
    lib.mcaat_set_threads.argtypes = [c.c_int]
    _lib = lib
    return _lib


def build_info(lib: Optional[ctypes.CDLL] = None) -> "str | None":
    """What the loaded library (or ``lib``) says it was built with: the
    compiler version and its OpenMP version, or None when unavailable."""
    lib = lib or _load()
    if lib is None:
        return None
    lib.mcaat_compiler_version.restype = ctypes.c_char_p
    omp = lib.mcaat_openmp_version()
    return (
        f"compiler {lib.mcaat_compiler_version().decode()}, "
        + (f"OpenMP {omp}" if omp else "no OpenMP")
    )


def pack_codes(codes) -> "np.ndarray | None":
    """[R, L] 2-bit code matrix -> [R, ceil(L/4)] packed bytes, or None
    when the native lib is unavailable (caller falls back to numpy)."""
    import numpy as np

    lib = _load()
    if lib is None:
        return None
    codes = np.ascontiguousarray(codes, dtype=np.uint8)
    R, L = codes.shape
    lp = (L + 3) // 4
    out = np.empty((R, lp), dtype=np.uint8)
    lib.mcaat_pack_codes(
        codes.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
        ctypes.c_int64(R),
        ctypes.c_int64(L),
        ctypes.c_int64(lp),
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
    )
    return out


def scc_components(indptr, indices, valid) -> "list[list[int]] | None":
    """Tarjan SCC over a CSR adjacency — result- AND order-identical to
    ordering.find_strongly_connected_components (the caller's fallback).
    Returns the list of >1-node components in emission order, or None
    when the native lib is unavailable."""
    import numpy as np

    lib = _load()
    if lib is None:
        return None
    indptr = np.ascontiguousarray(indptr, dtype=np.int64)
    indices = np.ascontiguousarray(indices, dtype=np.int64)
    valid_u8 = np.ascontiguousarray(valid, dtype=np.uint8)
    n = valid_u8.shape[0]
    order = np.empty(max(n, 1), dtype=np.int64)
    sizes = np.empty(max(n, 1), dtype=np.int64)
    p64 = ctypes.POINTER(ctypes.c_int64)
    n_comp = lib.mcaat_scc(
        indptr.ctypes.data_as(p64),
        indices.ctypes.data_as(p64),
        ctypes.c_int64(n),
        valid_u8.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
        order.ctypes.data_as(p64),
        sizes.ctypes.data_as(p64),
    )
    comps: list[list[int]] = []
    pos = 0
    for ci in range(int(n_comp)):
        sz = int(sizes[ci])
        comps.append(order[pos : pos + sz].tolist())
        pos += sz
    return comps


def native_available() -> bool:
    return _load() is not None


def set_threads(n: int) -> None:
    """Bound the native library's OpenMP team (the packer's parallel-for)
    to ``n`` threads — ≙ the reference's omp_set_num_threads
    (src/main.cpp:292-294). No-op when the library is unavailable."""
    lib = _load()
    if lib is None or n <= 0:
        return
    lib.mcaat_set_threads(ctypes.c_int(int(n)))


def umap_order(keys: list[str]):
    """Indices permuting ``keys`` (first-seen order) into libstdc++
    ``unordered_map`` iteration order — the order the reference's
    common-kmer candidate lists come out in (post_processing.h:50-63),
    which its spacer trim / repeat reconstruction depend on. Returns None
    when the native library is unavailable (callers keep first-seen
    order; see report/analyzer._get_common_kmers for the divergence
    note)."""
    lib = _load()
    if lib is None or not keys:
        return None
    c = ctypes
    buf = "".join(keys).encode("ascii")
    offsets = np.zeros(len(keys) + 1, dtype=np.int64)
    np.cumsum([len(k) for k in keys], out=offsets[1:])
    order = np.zeros(len(keys), dtype=np.int64)
    n = lib.mcaat_umap_order(
        buf,
        offsets.ctypes.data_as(c.POINTER(c.c_int64)),
        len(keys),
        order.ctypes.data_as(c.POINTER(c.c_int64)),
    )
    if int(n) != len(keys):
        return None
    return order.tolist()


def parse_fastx_batch(path: str):
    """Parse FASTA/FASTQ(.gz) directly into (codes [R, Lmax] uint8, lengths).

    Returns None if the native library is unavailable or parsing failed.
    """
    lib = _load()
    if lib is None:
        return None
    c = ctypes
    codes_p = c.POINTER(c.c_uint8)()
    lengths_p = c.POINTER(c.c_int32)()
    n_reads = c.c_int64()
    max_len = c.c_int32()
    rc = lib.mcaat_parse_fastx(
        path.encode(), c.byref(codes_p), c.byref(lengths_p),
        c.byref(n_reads), c.byref(max_len),
    )
    if rc != 0:
        return None
    n, m = int(n_reads.value), int(max_len.value)
    try:
        codes = np.ctypeslib.as_array(codes_p, shape=(max(n * m, 1),))[: n * m]
        codes = codes.reshape(n, m).copy()
        lengths = np.ctypeslib.as_array(lengths_p, shape=(max(n, 1),))[:n].copy()
    finally:
        lib.mcaat_free(codes_p)
        lib.mcaat_free(lengths_p)
    return codes, lengths


def parse_fastx(path: str) -> list[str]:
    """Sequence strings via the native parser (decoded from 2-bit codes).

    NOTE: non-ACGT characters come back as 'T' (the pipeline's canonical
    coding). Raises ImportError when unavailable so callers fall back.
    """
    res = parse_fastx_batch(path)
    if res is None:
        raise ImportError("native library unavailable")
    codes, lengths = res
    lut = np.frombuffer(b"ACGT", dtype=np.uint8)
    out = []
    for i in range(codes.shape[0]):
        row = lut[codes[i, : lengths[i]]]
        out.append(row.tobytes().decode("ascii"))
    return out


def enumerate_cycles(
    out: np.ndarray,
    in_: np.ndarray,
    valid: np.ndarray,
    mult: np.ndarray,
    start_nodes: np.ndarray,
    min_len: int,
    max_len: int,
):
    """Native bounded multicycle enumeration.

    Returns {start_node: [cycles]} or None if the library is unavailable.
    """
    lib = _load()
    if lib is None:
        return None
    c = ctypes
    out = np.ascontiguousarray(out, dtype=np.int32)
    in_ = np.ascontiguousarray(in_, dtype=np.int32)
    valid_u8 = np.ascontiguousarray(valid, dtype=np.uint8)
    mult = np.ascontiguousarray(mult, dtype=np.int32)
    starts = np.ascontiguousarray(start_nodes, dtype=np.int64)
    h = lib.mcaat_enumerate_cycles(
        out.ctypes.data_as(c.POINTER(c.c_int32)),
        in_.ctypes.data_as(c.POINTER(c.c_int32)),
        valid_u8.ctypes.data_as(c.POINTER(c.c_uint8)),
        mult.ctypes.data_as(c.POINTER(c.c_int32)),
        out.shape[0],
        starts.ctypes.data_as(c.POINTER(c.c_int64)),
        len(starts),
        min_len,
        max_len,
    )
    try:
        n_groups = lib.mcaat_sink_n_groups(h)
        n_cycles = lib.mcaat_sink_n_cycles(h)
        flat_size = lib.mcaat_sink_flat_size(h)
        g_starts = np.zeros(max(n_groups, 1), dtype=np.int64)
        g_offsets = np.zeros(n_groups + 1, dtype=np.int64)
        offsets = np.zeros(n_cycles + 1, dtype=np.int64)
        flat = np.zeros(max(flat_size, 1), dtype=np.int64)
        lib.mcaat_sink_copy(
            h,
            g_starts.ctypes.data_as(c.POINTER(c.c_int64)),
            g_offsets.ctypes.data_as(c.POINTER(c.c_int64)),
            offsets.ctypes.data_as(c.POINTER(c.c_int64)),
            flat.ctypes.data_as(c.POINTER(c.c_int64)),
        )
    finally:
        lib.mcaat_sink_free(h)
    results: dict[int, list[list[int]]] = {}
    for g in range(n_groups):
        cycles = []
        for ci in range(g_offsets[g], g_offsets[g + 1]):
            cycles.append(flat[offsets[ci] : offsets[ci + 1]].tolist())
        results[int(g_starts[g])] = cycles
    return results


def poa_consensus(sequences, match: int = 3, mismatch: int = -5, gap: int = -3):
    """Native POA consensus; None when the library is unavailable.

    Result-identical to ``mcaat_tpu.poa.compute_consensus`` (parity test
    in tests/test_native.py).
    """
    lib = _load()
    if lib is None:
        return None
    c = ctypes
    blob = "".join(sequences).encode("ascii")
    offsets = (c.c_int64 * (len(sequences) + 1))()
    acc = 0
    for i, s in enumerate(sequences):
        offsets[i] = acc
        acc += len(s)
    offsets[len(sequences)] = acc
    out = c.c_char_p()
    out_len = c.c_int64()
    rc = lib.mcaat_poa_consensus(
        blob, offsets, len(sequences), match, mismatch, gap,
        c.byref(out), c.byref(out_len),
    )
    if rc != 0:
        return None
    try:
        return c.string_at(out, out_len.value).decode("ascii")
    finally:
        lib.mcaat_free(out)
