"""Test configuration: the CPU backend with 8 virtual devices.

The tests run on the CPU, deterministic and in parallel (pytest-xdist),
with 8 virtual devices for the mesh tests.  Code that only runs on the
GPU (the CUDA ladder) is checked here through its host build and its
Python wrapper; on the card it runs as phases of chip_smoke.py.  Tests
that need the card carry the `gpu` marker and skip here.
"""

import os
import sys

flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8"
    ).strip()

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax
import pytest

jax.config.update("jax_platforms", "cpu")

from halo2_aggregation import platform  # noqa: E402

# Persistent compilation cache: the big scans (scalar_mul, inv) compile once
# per checkout instead of once per pytest run.
platform.enable_compile_cache()


@pytest.fixture
def gpu():
    """For tests marked `gpu`: skip unless JAX's backend is a GPU (decided
    here, at run time, never at import)."""
    if jax.default_backend() != "gpu":
        pytest.skip("needs an NVIDIA GPU; runs in chip_smoke.py on the card")
