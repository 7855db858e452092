"""Batched variable-base scalar multiplication: the verifier's multiopen
ladder, dispatched by platform.

* GPU: the CUDA kernel in native/ec_ladder.cu, called through the XLA
  foreign function interface — one thread per lane, 4-bit windows, the
  whole ladder in one launch.  It is built with nvcc for sm_90a at first
  use (utils/build.py); a failed build or load raises.
* CPU: `curve_ops.scalar_mul`, the 254-step XLA scan.

Both take and return the XLA path's layout: Jacobian points of (..., 32)
Montgomery 8-bit limbs and (..., 32) plain 8-bit scalar limbs.  The
wrapper regroups limbs into 8 x 32-bit words for the kernel and back;
Montgomery R is 2^256 in both, so no value changes.  The two paths can
return different Jacobian representatives of the same point (only Z == 0
for the identity is shared); every consumer normalizes to affine.
"""

from __future__ import annotations

import ctypes
import functools

import jax
import jax.numpy as jnp
import numpy as np

from .. import platform
from ..fields import NLIMBS
from ..utils import build
from . import curve_ops as co

FFI_TARGET = "h2a_ec_ladder"
SOURCE = build.source_path("ec_ladder.cu")
WINDOW_BITS = 4


# -- layout: 8-bit limbs <-> 32-bit words, 4-bit windows ---------------------


def limbs8_to_u32(a):
    """(..., 32) 8-bit limbs (int32) -> (..., 8) uint32 words."""
    a = jnp.asarray(a)
    a = a.astype(jnp.uint32).reshape(*a.shape[:-1], 8, 4)
    shifts = jnp.asarray([0, 8, 16, 24], jnp.uint32)
    return jnp.sum(a << shifts, axis=-1, dtype=jnp.uint32)


def u32_to_limbs8(w):
    """(..., 8) uint32 words -> (..., 32) int32 8-bit limbs."""
    w = jnp.asarray(w, jnp.uint32)
    shifts = jnp.asarray([0, 8, 16, 24], jnp.uint32)
    limbs = (w[..., None] >> shifts) & 0xFF
    return limbs.reshape(*w.shape[:-1], NLIMBS).astype(jnp.int32)


def windows4(scalars, nbits: int):
    """(..., 32) plain 8-bit limbs -> (..., ceil(nbits/4)) uint8 windows,
    window w holding bits [4w, 4w+4); bits at and above `nbits` are
    dropped, as the XLA scan drops them."""
    s = jnp.asarray(scalars).astype(jnp.int32)
    n_win = -(-nbits // WINDOW_BITS)
    lo = s & 0xF
    hi = s >> 4
    wins = jnp.stack([lo, hi], axis=-1).reshape(*s.shape[:-1], 2 * NLIMBS)
    wins = wins[..., :n_win]
    top = nbits - WINDOW_BITS * (n_win - 1)  # live bits of the last window
    if top < WINDOW_BITS:
        wins = wins.at[..., -1].set(wins[..., -1] & ((1 << top) - 1))
    return wins.astype(jnp.uint8)


def pack_points(p: co.JacPoint):
    """JacPoint of (..., 32) limbs -> (N, 3, 8) uint32, N = prod(...)."""
    return jnp.stack(
        [limbs8_to_u32(c).reshape(-1, 8) for c in (p.x, p.y, p.z)], axis=1
    )


def unpack_points(w, lead) -> co.JacPoint:
    """(N, 3, 8) uint32 -> JacPoint of (*lead, 32) limbs."""
    return co.JacPoint(
        *(u32_to_limbs8(w[:, i]).reshape(*lead, NLIMBS) for i in range(3))
    )


# -- the libraries ------------------------------------------------------------


def cuda_command(nvcc: str) -> list:
    return [
        nvcc,
        "-gencode", "arch=compute_90a,code=sm_90a",
        "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
        "-I", jax.ffi.include_dir(),
    ]


def cuda_library_file(nvcc: str | None = None) -> str:
    return build.build_shared_library(
        SOURCE, cuda_command(nvcc or build.find_nvcc()), "libh2a_ec_ladder"
    )


HOST_COMMAND = ["g++", "-x", "c++", "-std=c++17", "-O2", "-shared", "-fPIC"]


def host_library_file() -> str:
    """The kernel's arithmetic built as plain C++ (no CUDA): what the CPU
    tests check against the oracle."""
    return build.build_shared_library(
        SOURCE, HOST_COMMAND, "libh2a_ec_ladder_host"
    )


@functools.lru_cache(maxsize=None)
def load_cuda() -> str:
    """Build (once) and register the CUDA ladder as an FFI target."""
    lib = ctypes.cdll.LoadLibrary(cuda_library_file())
    jax.ffi.register_ffi_target(
        FFI_TARGET, jax.ffi.pycapsule(lib.H2aEcLadder), platform="CUDA"
    )
    return FFI_TARGET


@functools.lru_cache(maxsize=None)
def load_host():
    lib = ctypes.cdll.LoadLibrary(host_library_file())
    u32p = np.ctypeslib.ndpointer(np.uint32, flags="C_CONTIGUOUS")
    u8p = np.ctypeslib.ndpointer(np.uint8, flags="C_CONTIGUOUS")
    lib.h2a_ladder_host.argtypes = [
        u32p, u8p, ctypes.c_int64, ctypes.c_int32, u32p,
    ]
    lib.h2a_jac_add_host.argtypes = [u32p, u32p, ctypes.c_int64, u32p]
    lib.h2a_fq_mul_host.argtypes = [u32p, u32p, ctypes.c_int64, u32p]
    return lib


# -- the ladder ---------------------------------------------------------------


def scalar_mul_cuda(p: co.JacPoint, scalars, nbits: int = 254) -> co.JacPoint:
    """The CUDA ladder over every lane of (..., 32) inputs (jittable)."""
    target = load_cuda()
    lead = p.x.shape[:-1]
    pts = pack_points(p)
    wins = windows4(scalars, nbits).reshape(pts.shape[0], -1)
    out = jax.ffi.ffi_call(
        target, jax.ShapeDtypeStruct(pts.shape, jnp.uint32)
    )(pts, wins)
    return unpack_points(out, lead)


def scalar_mul_host(p: co.JacPoint, scalars, nbits: int = 254) -> co.JacPoint:
    """The kernel's own arithmetic, run on the host (tests only)."""
    lead = p.x.shape[:-1]
    pts = np.ascontiguousarray(np.asarray(pack_points(p)))
    wins = np.ascontiguousarray(
        np.asarray(windows4(scalars, nbits)).reshape(pts.shape[0], -1)
    )
    out = np.empty_like(pts)
    load_host().h2a_ladder_host(pts, wins, pts.shape[0], wins.shape[1], out)
    return unpack_points(jnp.asarray(out), lead)


def scalar_mul_lanes(p: co.JacPoint, scalars, nbits: int = 254) -> co.JacPoint:
    """s_i * P_i for every lane: the CUDA ladder on the GPU, the XLA scan
    on the CPU."""
    if platform.on_gpu():
        return scalar_mul_cuda(p, scalars, nbits)
    return co.scalar_mul(p, scalars, nbits)
