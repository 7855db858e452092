"""Byte-level codecs: field elements and compressed G1 points.

Formats follow the halo2 lineage the reference builds on (SURVEY.md §2b:
`Blake2bRead::read_point` consumes 32-byte compressed points; scalars are
32-byte LE reprs).  Our compressed format: x as 32 LE bytes with the parity
of y stored in bit 255 (the two spare bits above the 254-bit modulus);
the identity is all-zero bytes.
"""

from __future__ import annotations

from ..fields import CURVE_B, Q, R

_SIGN_BIT = 1 << 255


def fq_to_bytes(x: int) -> bytes:
    return int(x % Q).to_bytes(32, "little")


def fq_from_bytes(b: bytes) -> int:
    x = int.from_bytes(b, "little")
    if x >= Q:
        # explicit raise (not assert): these run on attacker-controlled
        # proof bytes and must survive `python -O` (proof malleability).
        raise ValueError("non-canonical Fq encoding")
    return x


def fr_to_bytes(x: int) -> bytes:
    return int(x % R).to_bytes(32, "little")


def fr_from_bytes(b: bytes) -> int:
    x = int.from_bytes(b, "little")
    if x >= R:
        raise ValueError("non-canonical Fr encoding")
    return x


def fq_sqrt(a: int):
    """Square root in Fq (q = 3 mod 4): a^((q+1)/4); None if non-residue.
    Through the native C++ modexp (~5x the Python pow; decompression
    dominates parse_proof)."""
    from . import native

    return native.fq_sqrt(a % Q)


def g1_compress(p) -> bytes:
    """Point ((x, y) or None for identity) -> 32 bytes."""
    if p is None:
        return b"\x00" * 32
    x, y = p
    enc = x % Q
    if y % 2 == 1:
        enc |= _SIGN_BIT
    return enc.to_bytes(32, "little")


def g1_decompress(b: bytes):
    v = int.from_bytes(b, "little")
    if v == 0:
        return None
    sign = bool(v & _SIGN_BIT)
    x = v & ~_SIGN_BIT
    if x >= Q:
        raise ValueError("bad point encoding")
    y = fq_sqrt((x * x % Q * x + CURVE_B) % Q)
    if y is None:
        raise ValueError("x not on curve")
    if bool(y % 2) != sign:
        y = Q - y
    return (x, y)
