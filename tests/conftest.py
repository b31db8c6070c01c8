"""Test configuration: the CPU backend with 8 virtual devices, so the
multi-device sharding paths run without an accelerator. Tests marked
``gpu`` need a card and skip elsewhere; on a GPU machine run them with
``JAX_PLATFORMS=cuda python -m pytest -m gpu tests/``."""

import os

import pytest

os.environ.setdefault("JAX_PLATFORMS", "cpu")
flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8"
    ).strip()


@pytest.fixture
def gpu():
    """Skip unless JAX's default device is an NVIDIA GPU (decided when
    the test runs, never at collection)."""
    import jax

    if jax.devices()[0].platform != "gpu":
        pytest.skip("needs an NVIDIA GPU (JAX_PLATFORMS=cuda -m gpu)")
