"""Batched BN254 G1 arithmetic in JAX: Jacobian point ops over Fq limbs.

The batched device replacement for the EC arithmetic the reference delegates to
halo2wrong's `BaseFieldEccChip` (`src/verifier.rs:156-174`,
`mul_var` at `src/multiopen.rs:393` — its dominant cost).

Representation:
* Affine: ``(x, y, inf)`` — x, y are (..., 32) Montgomery-form Fq limbs,
  inf is a (...,) bool mask (no Option types, no branches).
* Jacobian: ``(X, Y, Z)`` with Z == 0 encoding infinity, so the unified
  add/double formulas need no control flow — everything is `where`-selects
  over the batch.

Scalars are (..., 32) plain (non-Montgomery) 8-bit limbs of the Fr value.
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np
from jax import lax

from ..fields import CURVE_B, G1_GEN, LIMB_BITS, NLIMBS
from . import field_ops as fo
from .field_ops import FQ


class AffinePoint(NamedTuple):
    x: jax.Array  # (..., 32) mont Fq
    y: jax.Array  # (..., 32) mont Fq
    inf: jax.Array  # (...,) bool


class JacPoint(NamedTuple):
    x: jax.Array
    y: jax.Array
    z: jax.Array  # z == 0 <=> infinity


def jac_identity(batch_shape=()):
    zero = jnp.zeros((*batch_shape, NLIMBS), jnp.int32)
    one = jnp.broadcast_to(jnp.asarray(FQ.one_mont), (*batch_shape, NLIMBS)).astype(
        jnp.int32
    )
    return JacPoint(one, one, zero)


def affine_to_jac(p: AffinePoint) -> JacPoint:
    one = jnp.broadcast_to(jnp.asarray(FQ.one_mont), p.x.shape).astype(jnp.int32)
    z = fo.select(p.inf, jnp.zeros_like(p.x), one)
    return JacPoint(p.x, p.y, z)


@jax.jit
def jac_double(p: JacPoint) -> JacPoint:
    """dbl-2009-l; Z=0 (infinity) maps to Z3=0 automatically."""
    A = fo.mont_sq(p.x, FQ)
    B = fo.mont_sq(p.y, FQ)
    C = fo.mont_sq(B, FQ)
    t = fo.mont_sq(fo.add(p.x, B, FQ), FQ)
    D = fo.sub(fo.sub(t, A, FQ), C, FQ)
    D = fo.add(D, D, FQ)  # 2((X+B)^2 - A - C)
    E = fo.add(fo.add(A, A, FQ), A, FQ)  # 3A
    F = fo.mont_sq(E, FQ)
    x3 = fo.sub(F, fo.add(D, D, FQ), FQ)
    C8 = fo.add(C, C, FQ)
    C8 = fo.add(C8, C8, FQ)
    C8 = fo.add(C8, C8, FQ)
    y3 = fo.sub(fo.mont_mul(E, fo.sub(D, x3, FQ), FQ), C8, FQ)
    z3 = fo.mont_mul(fo.add(p.y, p.y, FQ), p.z, FQ)
    return JacPoint(x3, y3, z3)


@jax.jit
def jac_add(p: JacPoint, q: JacPoint) -> JacPoint:
    """Unified Jacobian + Jacobian addition with branchless edge handling:
    p==inf -> q; q==inf -> p; p==q -> double; p==-q -> inf."""
    z1z1 = fo.mont_sq(p.z, FQ)
    z2z2 = fo.mont_sq(q.z, FQ)
    u1 = fo.mont_mul(p.x, z2z2, FQ)
    u2 = fo.mont_mul(q.x, z1z1, FQ)
    s1 = fo.mont_mul(p.y, fo.mont_mul(q.z, z2z2, FQ), FQ)
    s2 = fo.mont_mul(q.y, fo.mont_mul(p.z, z1z1, FQ), FQ)
    h = fo.sub(u2, u1, FQ)
    r = fo.sub(s2, s1, FQ)

    h2 = fo.mont_sq(h, FQ)
    h3 = fo.mont_mul(h2, h, FQ)
    u1h2 = fo.mont_mul(u1, h2, FQ)
    x3 = fo.sub(fo.sub(fo.mont_sq(r, FQ), h3, FQ), fo.add(u1h2, u1h2, FQ), FQ)
    y3 = fo.sub(
        fo.mont_mul(r, fo.sub(u1h2, x3, FQ), FQ), fo.mont_mul(s1, h3, FQ), FQ
    )
    z3 = fo.mont_mul(fo.mont_mul(p.z, q.z, FQ), h, FQ)

    p_inf = fo.is_zero(p.z)
    q_inf = fo.is_zero(q.z)
    h_zero = fo.is_zero(h)
    r_zero = fo.is_zero(r)
    both = ~p_inf & ~q_inf

    dbl = jac_double(p)
    use_dbl = both & h_zero & r_zero
    # p == -q: result infinity (z3 = 0 already since h == 0 -> z3 == 0) —
    # but x3/y3 are garbage; z==0 is all that matters downstream.
    x = fo.select(use_dbl, dbl.x, x3)
    y = fo.select(use_dbl, dbl.y, y3)
    z = fo.select(use_dbl, dbl.z, z3)
    # identity cases
    x = fo.select(q_inf, p.x, fo.select(p_inf, q.x, x))
    y = fo.select(q_inf, p.y, fo.select(p_inf, q.y, y))
    z = fo.select(q_inf, p.z, fo.select(p_inf, q.z, z))
    return JacPoint(x, y, z)


@jax.jit
def jac_neg(p: JacPoint) -> JacPoint:
    return JacPoint(p.x, fo.neg(p.y, FQ), p.z)


@jax.jit
def jac_to_affine(p: JacPoint) -> AffinePoint:
    """Batch conversion; infinity encoded in the inf mask."""
    zinv = fo.inv(p.z, FQ)  # 0 -> 0
    zinv2 = fo.mont_sq(zinv, FQ)
    x = fo.mont_mul(p.x, zinv2, FQ)
    y = fo.mont_mul(p.y, fo.mont_mul(zinv2, zinv, FQ), FQ)
    return AffinePoint(x, y, fo.is_zero(p.z))


def scalar_bits_msb(scalars, nbits: int = 256):
    """(..., 32) plain limbs -> (nbits, ...) bit array, MSB first."""
    idx = np.arange(nbits - 1, -1, -1)
    limb = idx // LIMB_BITS
    shift = idx % LIMB_BITS
    cols = scalars[..., limb]  # (..., nbits)
    bits = (cols >> jnp.asarray(shift)) & 1
    return jnp.moveaxis(bits, -1, 0)


@functools.partial(jax.jit, static_argnums=(2,))
def scalar_mul(p: JacPoint, scalars, nbits: int = 256) -> JacPoint:
    """Batched variable-base scalar multiplication (the `mul_var` analog),
    MSB-first double-and-add under lax.scan."""
    bits = scalar_bits_msb(scalars, nbits)

    def step(acc, bit):
        acc = jac_double(acc)
        added = jac_add(acc, p)
        mask = bit.astype(bool)
        acc = JacPoint(
            fo.select(mask, added.x, acc.x),
            fo.select(mask, added.y, acc.y),
            fo.select(mask, added.z, acc.z),
        )
        return acc, None

    acc0 = jac_identity(p.x.shape[:-1])
    acc, _ = lax.scan(step, acc0, bits)
    return acc


@functools.partial(jax.jit, static_argnums=(2,))
def scalar_mul_windowed(p: JacPoint, scalars, nbits: int = 256) -> JacPoint:
    """EXPERIMENTAL (round 2): 4-bit windowed double-and-add — 16-entry
    per-lane table, nbits/4 iterations of (4 doublings + table-select +
    add).  ~40% fewer field muls and 4x fewer sequential steps than the
    bit ladder, but the current formulation's XLA graph (4 inlined
    doubles + table build) compiles prohibitively slowly; not wired into
    any default path until the body is restructured."""
    w = 4
    nwin = (nbits + w - 1) // w
    # table[d] = d * P, d in 0..15 (batched along a new leading axis)
    tbl = [jac_identity(p.x.shape[:-1]), p]
    for d in range(2, 16):
        tbl.append(jac_add(tbl[d - 1], p))
    tx = jnp.stack([t.x for t in tbl])  # (16, ..., 32)
    ty = jnp.stack([t.y for t in tbl])
    tz = jnp.stack([t.z for t in tbl])

    # digit extraction: windows MSB-first; digit j covers bits [4j, 4j+4)
    def digit(j):
        limb = (j * w) // LIMB_BITS
        off = (j * w) % LIMB_BITS
        return (scalars[..., limb] >> off) & 0xF

    def step(acc, j):
        for _ in range(w):
            acc = jac_double(acc)
        d = digit(nwin - 1 - j)  # (...,)
        sel = d[None, ..., None] == jnp.arange(16).reshape(
            16, *([1] * (scalars.ndim - 1)), 1
        )
        ax = jnp.sum(jnp.where(sel, tx, 0), axis=0)
        ay = jnp.sum(jnp.where(sel, ty, 0), axis=0)
        az = jnp.sum(jnp.where(sel, tz, 0), axis=0)
        acc = jac_add(acc, JacPoint(ax, ay, az))
        return acc, None

    acc0 = jac_identity(p.x.shape[:-1])
    acc, _ = lax.scan(step, acc0, jnp.arange(nwin))
    return acc


@jax.jit
def jac_sum(p: JacPoint) -> JacPoint:
    """Fold a batch of points along axis 0 to a single point.

    lax.scan left fold: the jac_add body (~3.6K HLO ops) compiles ONCE
    per call site.  The former unrolled tree reduction emitted one
    jac_add per level and dominated the cold-compile cost of every
    program containing lane sums (XLA:CPU pays minutes per 10K HLO ops
    on a small host); the group element is identical either way
    and the fold lengths here (tens of lanes) are noise at runtime
    against the 254-step ladder."""
    n = p.x.shape[0]
    if n == 1:
        return JacPoint(p.x[0], p.y[0], p.z[0])

    def step(acc, q):
        return jac_add(acc, q), None

    acc0 = JacPoint(p.x[0], p.y[0], p.z[0])
    rest = JacPoint(p.x[1:], p.y[1:], p.z[1:])
    acc, _ = lax.scan(step, acc0, rest)
    return acc


def jac_segment_sum(p: JacPoint, seg_ids, num_segs: int) -> JacPoint:
    """Fold points along axis 0 into per-segment accumulators with ONE
    scan whose body is a single jac_add + a dynamic-index update —
    the compile-cheap form of several per-segment lane sums (used by the
    mesh verifier step where w/zw/f/e lane counts differ).

    p: (m, ..., 32) points; seg_ids: (m,) int32 (static values, traced
    array); returns (num_segs, ..., 32) sums (identity for empty segs)."""
    seg_ids = jnp.asarray(seg_ids, jnp.int32)
    acc0 = jac_identity((num_segs, *p.x.shape[1:-1]))

    def step(acc, lane_seg):
        lane, seg = lane_seg
        cur = JacPoint(acc.x[seg], acc.y[seg], acc.z[seg])
        new = jac_add(cur, lane)
        return (
            JacPoint(
                acc.x.at[seg].set(new.x),
                acc.y.at[seg].set(new.y),
                acc.z.at[seg].set(new.z),
            ),
            None,
        )

    acc, _ = lax.scan(step, acc0, (p, seg_ids))
    return acc


# ---------------------------------------------------------------------------
# host-side codecs (oracle interop)
# ---------------------------------------------------------------------------


def affine_from_ints(points) -> AffinePoint:
    """List of oracle points ((x, y) or None) -> batched AffinePoint."""
    xs, ys, infs = [], [], []
    for pt in points:
        if pt is None:
            xs.append(0)
            ys.append(0)
            infs.append(True)
        else:
            xs.append(pt[0])
            ys.append(pt[1])
            infs.append(False)
    return AffinePoint(
        jnp.asarray(FQ.to_mont_array(xs)),
        jnp.asarray(FQ.to_mont_array(ys)),
        jnp.asarray(np.array(infs)),
    )


def affine_to_ints(p: AffinePoint) -> list:
    xs = FQ.from_mont_array(p.x)
    ys = FQ.from_mont_array(p.y)
    infs = np.asarray(p.inf).reshape(-1)
    return [None if i else (x, y) for x, y, i in zip(xs, ys, infs)]


def jac_to_ints(p: JacPoint) -> list:
    """Jacobian device batch -> host affine int pairs.

    The projective->affine division happens host-side: for the small
    batches this is used on (verifier outputs), three bigint muls and one
    pow per point beat compiling the 254-step device inversion scan."""
    from ..fields import Q

    xs = FQ.from_mont_array(p.x)
    ys = FQ.from_mont_array(p.y)
    zs = FQ.from_mont_array(p.z)
    out = []
    for x, y, z in zip(xs, ys, zs):
        if z == 0:
            out.append(None)
            continue
        zinv = pow(z, -1, Q)
        zi2 = zinv * zinv % Q
        out.append((x * zi2 % Q, y * zi2 % Q * zinv % Q))
    return out
