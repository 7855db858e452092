"""Conversions between Python ints and 4x64-bit little-endian limb arrays.

The numpy (n, 4) uint64 layout is the interchange format between the Python
orchestration layer, the native C++ runtime (native/h2a_native.cpp), and
the on-disk SRS cache — plain (non-Montgomery) canonical values throughout.
"""

from __future__ import annotations

import numpy as np

_M64 = (1 << 64) - 1


def int_to_u64(x: int, width: int = 4) -> np.ndarray:
    return np.array(
        [(x >> (64 * i)) & _M64 for i in range(width)], dtype=np.uint64
    )


def ints_to_u64(xs, width: int = 4) -> np.ndarray:
    """List of ints -> (n, width) uint64, via one bulk frombuffer."""
    nbytes = 8 * width
    buf = b"".join(int(x).to_bytes(nbytes, "little") for x in xs)
    return np.frombuffer(buf, dtype="<u8").reshape(len(xs), width).astype(np.uint64)


def u64_to_int(arr) -> int:
    return sum(int(v) << (64 * i) for i, v in enumerate(np.asarray(arr)))


def u64_to_ints(arr) -> list:
    a = np.ascontiguousarray(np.asarray(arr, dtype="<u8"))
    n, width = a.shape
    buf = a.tobytes()
    nbytes = 8 * width
    return [
        int.from_bytes(buf[i * nbytes : (i + 1) * nbytes], "little")
        for i in range(n)
    ]


def points_to_u64(points):
    """Affine int points ((x, y) or None) -> ((n, 8) u64, (n,) u8 inf)."""
    n = len(points)
    out = np.zeros((n, 8), dtype=np.uint64)
    infs = np.zeros(n, dtype=np.uint8)
    xs, ys = [], []
    for p in points:
        if p is None:
            xs.append(0)
            ys.append(0)
        else:
            xs.append(p[0])
            ys.append(p[1])
    out[:, :4] = ints_to_u64(xs)
    out[:, 4:] = ints_to_u64(ys)
    infs[:] = [1 if p is None else 0 for p in points]
    return out, infs


def u64_to_points(arr, infs) -> list:
    xs = u64_to_ints(np.asarray(arr)[:, :4])
    ys = u64_to_ints(np.asarray(arr)[:, 4:])
    return [
        None if i else (x, y) for x, y, i in zip(xs, ys, np.asarray(infs))
    ]


def u64_to_limbs8(arr: np.ndarray) -> np.ndarray:
    """(n, 4) uint64 -> (n, 32) int32 8-bit limbs, zero-copy byte view
    (little-endian throughout) — the device-MSM ingest path."""
    a = np.ascontiguousarray(arr, dtype="<u8")
    return a.view(np.uint8).reshape(a.shape[0], 32).astype(np.int32)


def u64_view8(arr: np.ndarray) -> np.ndarray:
    """(n, 4) uint64 -> (n, 32) uint8 zero-copy byte view.  The H2D-cheap
    form of u64_to_limbs8: ship 32 bytes/row to the device and widen to
    int32 on-device (4x less transfer than shipping int32 limbs)."""
    a = np.ascontiguousarray(arr, dtype="<u8")
    return a.view(np.uint8).reshape(a.shape[0], 32)


def limbs8_to_u64(limbs: np.ndarray) -> np.ndarray:
    """(n, 32) int32 8-bit limbs -> (n, 4) uint64."""
    b = np.asarray(limbs, dtype=np.int32).astype(np.uint8)
    return b.reshape(b.shape[0], 32).view("<u8").astype(np.uint64)
