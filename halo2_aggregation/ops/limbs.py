"""Host-side codec between Python ints and the device limb representation.

Device representation: ``(..., NLIMBS)`` int32 arrays holding NLIMBS=32
little-endian limbs of LIMB_BITS=8 bits each (values < 256 when canonical).
8-bit limbs keep every partial product below 2^16 and every 32-term column
sum below 2^21, so the multiply convolution is exact in int32 (the "8-bit
sub-limb decomposition" design from BASELINE.md).

The reference's analog is halo2wrong's RNS 4x68-bit decomposition
(`examples/simple-example.rs:396-397`) — that layout is for
*in-circuit* non-native arithmetic and reappears in aggregation/gadgets;
this one is for batched device compute.
"""

from __future__ import annotations

import numpy as np

from ..fields import LIMB_BITS, NLIMBS

_MASK = (1 << LIMB_BITS) - 1


def int_to_limbs(x: int, nlimbs: int = NLIMBS) -> np.ndarray:
    """Little-endian limb decomposition of a non-negative int."""
    assert x >= 0
    out = np.zeros(nlimbs, dtype=np.int32)
    for i in range(nlimbs):
        out[i] = x & _MASK
        x >>= LIMB_BITS
    assert x == 0, "value does not fit in nlimbs"
    return out


def limbs_to_int(limbs) -> int:
    """Inverse of int_to_limbs; accepts any 1-D int array."""
    arr = np.asarray(limbs, dtype=object)
    acc = 0
    for i in range(arr.shape[-1] - 1, -1, -1):
        acc = (acc << LIMB_BITS) + int(arr[i])
    return acc


def ints_to_limbs(xs, nlimbs: int = NLIMBS) -> np.ndarray:
    """Vector codec: list of ints -> (len, nlimbs) int32.

    8-bit limbs are exactly little-endian bytes, so the bulk path is one
    `to_bytes` per int + one frombuffer (10x the per-limb Python loop;
    this ran 6.4K times per aggregation batch — VERDICT r2 item 4).
    `to_bytes` raises OverflowError for values that don't fit, matching
    the loop's fit assert."""
    xs = list(xs)
    if LIMB_BITS == 8:
        buf = b"".join(int(x).to_bytes(nlimbs, "little") for x in xs)
        return (
            np.frombuffer(buf, dtype=np.uint8)
            .astype(np.int32)
            .reshape(len(xs), nlimbs)
        )
    return np.stack([int_to_limbs(int(x), nlimbs) for x in xs])


def limbs_to_ints(arr) -> list:
    a = np.asarray(arr)
    flat = a.reshape(-1, a.shape[-1])
    return [limbs_to_int(row) for row in flat]
