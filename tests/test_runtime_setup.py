"""Process set-up: where the compile cache goes, and the smoke's refusal
to run anywhere but on a GPU."""

import os
import shutil
import subprocess
import sys

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _env(**extra):
    env = {k: v for k, v in os.environ.items() if k != "JAX_COMPILATION_CACHE_DIR"}
    env["JAX_PLATFORMS"] = "cpu"
    env["PYTHONPATH"] = os.pathsep.join(
        p for p in (REPO, env.get("PYTHONPATH")) if p
    )
    env.update(extra)
    return env


@pytest.mark.parametrize("env_dir", [None, "given"])
def test_compile_cache_dir(tmp_path, env_dir):
    """JAX_COMPILATION_CACHE_DIR wins untouched; without it the cache is
    the checkout's fixed .jax_cache directory."""
    extra = {}
    want = os.path.join(REPO, ".jax_cache")
    if env_dir:
        want = str(tmp_path / env_dir)
        extra["JAX_COMPILATION_CACHE_DIR"] = want
    out = subprocess.run(
        [sys.executable, "-c",
         "import mcaat_tpu, jax; print(jax.config.jax_compilation_cache_dir)"],
        env=_env(**extra), cwd=str(tmp_path), capture_output=True, text=True,
        check=True,
    ).stdout
    assert out.strip() == want


_POOL_RUN = """
from concurrent.futures import ProcessPoolExecutor
from mcaat_tpu import pipeline
pipeline.start_ordering_server()
with ProcessPoolExecutor(2, mp_context=pipeline._ordering_context()) as ex:
    assert list(ex.map(abs, [-1, -2])) == [1, 2]
"""


def _running_in_session(sid):
    """Pids of the live (not zombie) processes of session ``sid``."""
    pids = []
    for name in os.listdir("/proc"):
        if not name.isdigit():
            continue
        try:
            with open(f"/proc/{name}/stat") as fh:
                state, _ppid, _pgrp, session = fh.read().rsplit(")", 1)[1].split()[:4]
        except (OSError, ValueError):
            continue
        if int(session) == sid and state != "Z":
            pids.append(int(name))
    return pids


@pytest.mark.parametrize(
    "end",
    ["", "import chip_smoke\nchip_smoke.phase_processes()\n"],
    ids=["at_exit", "smoke_phase"],
)
def test_ordering_pool_leaves_no_process(tmp_path, end):
    """The ordering pool's fork server and resource tracker are stopped
    and waited for before the interpreter exits, at exit or by the
    smoke's process phase, so nothing the run started outlives it."""
    # output to a file, not a pipe: reading a pipe to its end would also
    # wait for every process that inherited it
    with open(tmp_path / "log", "w+") as log:
        proc = subprocess.Popen(
            [sys.executable, "-c", _POOL_RUN + end],
            env=_env(MCAAT_ORDERING_PROCS="2"), start_new_session=True,
            stdout=log, stderr=subprocess.STDOUT,
        )
        rc = proc.wait(timeout=300)
        left = _running_in_session(proc.pid)
        log.seek(0)
        text = log.read()
    assert rc == 0, text
    assert left == []
    if end:
        assert "[procs]" in text and "none left" in text


def test_chip_smoke_refuses_the_cpu():
    res = subprocess.run(
        [sys.executable, os.path.join(REPO, "chip_smoke.py")],
        env=_env(), capture_output=True, text=True, timeout=300,
    )
    assert res.returncode != 0
    assert '"ok"' not in res.stdout
    assert "platform=cpu" in res.stdout
    assert "no GPU" in res.stderr


def test_chip_smoke_alone_fails(tmp_path):
    """Without the rest of the repository the smoke cannot import the
    package, and fails before it reaches the device gate."""
    shutil.copy(os.path.join(REPO, "chip_smoke.py"), tmp_path)
    env = _env()
    env.pop("PYTHONPATH")
    res = subprocess.run(
        [sys.executable, str(tmp_path / "chip_smoke.py")],
        env=env, cwd=str(tmp_path), capture_output=True, text=True,
        timeout=300,
    )
    assert res.returncode != 0
    assert "No module named 'mcaat_tpu'" in res.stderr
    assert "[gate]" not in res.stdout
    assert '"ok"' not in res.stdout
