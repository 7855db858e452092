"""The one place that says what device the program runs on.

Every dispatch that depends on the device (the CUDA scalar-mul ladder,
the device quotient, memory-derived caps) asks this module.  Two
platforms are known:

* ``gpu`` — an NVIDIA card through JAX's CUDA plugin.  Hand-written
  kernels run here and nowhere else; a kernel that cannot be built or
  loaded raises instead of silently taking another path.
* ``cpu`` — tests and development.  Plain XLA is the only path.

Any other backend is an error: a new accelerator has to be added here
deliberately, with its own kernels or an explicit decision to use XLA.

This module also places JAX's persistent compilation cache
(`enable_compile_cache`), so that every entry point keeps it in the same
directory.
"""

from __future__ import annotations

import os

#: repository root — build outputs and the default compile cache live
#: under ``build/`` here (listed in .gitignore)
REPO_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BUILD_DIR = os.path.join(REPO_ROOT, "build")

KNOWN = ("gpu", "cpu")


def backend() -> str:
    """``"gpu"`` or ``"cpu"``; raises for a backend this program does not
    support."""
    import jax

    b = jax.default_backend().lower()
    if b in ("gpu", "cuda"):
        return "gpu"
    if b == "cpu":
        return "cpu"
    raise RuntimeError(
        f"unsupported JAX backend {b!r} "
        f"(devices: {[d.device_kind for d in jax.devices()]}); "
        f"known: {KNOWN}"
    )


def on_gpu() -> bool:
    return backend() == "gpu"


def describe() -> dict:
    """Platform, kind and count as JAX reports them."""
    import jax

    devs = jax.devices()
    return {
        "platform": devs[0].platform,
        "kind": devs[0].device_kind,
        "count": len(devs),
    }


def require_gpu() -> dict:
    """For measurement paths: the device description, or an error when
    JAX finds no GPU (a CPU timing is never reported as a device one)."""
    if backend() != "gpu":
        raise RuntimeError("no GPU: JAX runs on the CPU backend")
    return describe()


def card_name_and_power_limit() -> str:
    """`nvidia-smi --query-gpu=name,power.limit`, one line per card."""
    import subprocess

    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip()


def device_memory_bytes(device=None) -> int:
    """Bytes one device can hold: the card's own allocator limit on the
    GPU; physical host memory on the CPU backend (which reports none)."""
    import jax

    dev = device or jax.devices()[0]
    stats = dev.memory_stats() if hasattr(dev, "memory_stats") else None
    if stats and stats.get("bytes_limit"):
        return int(stats["bytes_limit"])
    if backend() == "gpu":
        raise RuntimeError(f"{dev.device_kind} reports no memory limit")
    return os.sysconf("SC_PAGE_SIZE") * os.sysconf("SC_PHYS_PAGES")


def compile_cache_dir() -> str:
    """``$JAX_COMPILATION_CACHE_DIR`` when set, else one fixed directory
    inside the checkout (a fixed path, so later runs hit it)."""
    return os.environ.get("JAX_COMPILATION_CACHE_DIR") or os.path.join(
        BUILD_DIR, "jax_cache"
    )


def enable_compile_cache() -> str:
    """Turn on JAX's persistent compilation cache at
    `compile_cache_dir()`; returns the directory."""
    import jax

    path = compile_cache_dir()
    jax.config.update("jax_compilation_cache_dir", path)
    jax.config.update("jax_persistent_cache_min_entry_size_bytes", -1)
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 0.5)
    return path
