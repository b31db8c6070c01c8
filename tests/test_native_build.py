"""Building the native runtime from source (native/mcaat_host.cpp)."""

import ctypes
import os
import shutil
import threading

import pytest

from mcaat_tpu import native

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture
def compiler():
    if not (os.environ.get("CXX") or shutil.which("g++") or shutil.which("c++")):
        pytest.skip("no C++ compiler")


def test_build_from_source_races_to_one_compile(tmp_path, compiler):
    """Concurrent first uses compile once (lock + temp file + rename),
    and an up-to-date library is not rebuilt."""
    src = tmp_path / "mcaat_host.cpp"
    shutil.copy(os.path.join(REPO, "native", "mcaat_host.cpp"), src)
    lib = tmp_path / "libmcaat_host.so"
    built = []
    threads = [
        threading.Thread(
            target=lambda: built.append(native.build_library(str(src), str(lib)))
        )
        for _ in range(4)
    ]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert sorted(built) == [False, False, False, True]
    assert sorted(os.listdir(tmp_path)) == [
        ".build.lock", "libmcaat_host.so", "mcaat_host.cpp"
    ]
    assert hasattr(ctypes.CDLL(str(lib)), "mcaat_parse_fastx")
    assert native.build_library(str(src), str(lib)) is False


def test_library_path_is_git_ignored():
    """The loader's output path sits in native/ and is ignored by git."""
    assert native._LIB_PATH == os.path.join(REPO, "native", "libmcaat_host.so")
    with open(os.path.join(REPO, ".gitignore")) as fh:
        ignored = fh.read().split()
    assert "native/libmcaat_host.so" in ignored
    assert "native/.build.lock" in ignored


def test_build_failure_raises(tmp_path, compiler):
    src = tmp_path / "broken.cpp"
    src.write_text("this is not C++\n")
    with pytest.raises(RuntimeError, match="failed"):
        native.build_library(str(src), str(tmp_path / "libbroken.so"))
    assert not (tmp_path / "libbroken.so").exists()
    assert [f for f in os.listdir(tmp_path) if f.startswith(".libbroken")] == []


def test_build_reports_compiler_and_openmp(tmp_path, compiler):
    """A build records its command, and the library reports the compiler
    and OpenMP version it was built with."""
    src = tmp_path / "mcaat_host.cpp"
    shutil.copy(os.path.join(REPO, "native", "mcaat_host.cpp"), src)
    lib = tmp_path / "libmcaat_host.so"
    assert native.build_library(str(src), str(lib)) is True
    assert native.last_build_command.endswith(f"-o {lib} -shared -lz -fopenmp")
    info = native.build_info(ctypes.CDLL(str(lib)))
    assert info.startswith("compiler ") and "OpenMP 20" in info


def test_build_without_openmp_support(tmp_path, compiler, monkeypatch, capsys):
    """A compiler that refuses -fopenmp still yields a working library,
    which says it has no OpenMP, and the build says so on stderr."""
    real = native._compilers()[0]
    fake = tmp_path / "g++"
    fake.write_text(
        "#!/bin/sh\n"
        'for a in "$@"; do [ "$a" = -fopenmp ] && exit 1; done\n'
        f'exec {real} "$@"\n'
    )
    fake.chmod(0o755)
    monkeypatch.setattr(native, "_compilers", lambda: [str(fake)])
    src = tmp_path / "mcaat_host.cpp"
    shutil.copy(os.path.join(REPO, "native", "mcaat_host.cpp"), src)
    lib = tmp_path / "libmcaat_host.so"
    assert native.build_library(str(src), str(lib)) is True
    assert "single-threaded" in capsys.readouterr().err
    assert "-fopenmp" not in native.last_build_command
    built = ctypes.CDLL(str(lib))
    assert hasattr(built, "mcaat_set_threads")
    assert native.build_info(built).endswith(", no OpenMP")
