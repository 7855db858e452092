"""Multi-scalar multiplication on the device: windowed bucket (Pippenger) MSM.

The reference's MSMs hide inside its halo2 fork's prover (`create_proof`,
`commit_lagrange` — SURVEY.md §2b) and inside the in-circuit folds
(`src/multiopen.rs:443-492`).  Here MSM is an explicit
kernel, per BASELINE.md ("MSM Mpoint-adds/s/chip").

Formulation (no scatter-add in the compute path): per 8-bit window,

  1. digits  = the w-th 8-bit limb of every scalar (window == limb);
  2. sort    lane indices by digit (lax.sort_key_val);
  3. gather  the points into digit order;
  4. one segmented inclusive scan (lax.associative_scan with a
     same-segment jac_add combiner, ~2N combines) — after which the last
     element of each digit-run is that bucket's point sum;
  5. scatter the run-ends into the 256-entry bucket table (one .at[].set);
  6. bucket fold: suffix sums give  sum_d d * bucket_d  in 2*256 adds;
  7. Horner across windows: 8 doublings per window.

Work: ~2N point-adds per window x 32 windows — within 2x of scalar
Pippenger, and every add is a (lanes, 32)-vectorized op.  Large n is
processed in slabs so live memory stays ~6 x slab x 32 x 4B.

msm() keeps the simple per-lane-ladder + tree-sum for small n (the
verifier path), where the sort/scan machinery doesn't pay.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
from jax import lax

from . import curve_ops as co
from . import field_ops as fo
from ..fields import NLIMBS
from .ec_ladder import scalar_mul_lanes

#: below this size the per-lane ladder beats the bucket machinery
_BUCKET_MIN_N = 1 << 14
_SLAB = 1 << 21


def msm(points: co.AffinePoint, scalars, nbits: int = 256) -> co.JacPoint:
    """points: batched AffinePoint (n, 32); scalars: (n, 32) plain limbs.
    Returns the single Jacobian sum  sum_i s_i * P_i."""
    n = points.x.shape[0]
    if n >= _BUCKET_MIN_N:
        return msm_bucket(points, scalars, nbits)
    jac = co.affine_to_jac(points)
    per = scalar_mul_lanes(jac, scalars, nbits)
    return co.jac_sum(per)


def _seg_combine(a, b):
    """Segmented-sum monoid: (seg, pt) x (seg, pt); right segment wins,
    points add when the segments match."""
    seg_a, xa, ya, za = a
    seg_b, xb, yb, zb = b
    added = co.jac_add(co.JacPoint(xa, ya, za), co.JacPoint(xb, yb, zb))
    same = (seg_a == seg_b)[:, None]
    x = jnp.where(same, added.x, xb)
    y = jnp.where(same, added.y, yb)
    z = jnp.where(same, added.z, zb)
    return seg_b, x, y, z


@functools.partial(jax.jit)
def _window_buckets(digits, px, py, pz):
    """One window's 256-entry bucket table for one slab.

    digits (n,) int32; p* (n, 32) Jacobian mont coords.  Returns bucket
    coords (257, 32) — index 256 is the dump row for masked writes."""
    n = digits.shape[0]
    order = jnp.argsort(digits)
    d_s = digits[order]
    px, py, pz = px[order], py[order], pz[order]
    seg, x, y, z = lax.associative_scan(_seg_combine, (d_s, px, py, pz))
    # run ends: last element of each digit segment
    nxt = jnp.concatenate([d_s[1:], jnp.full((1,), -1, d_s.dtype)])
    is_end = d_s != nxt
    idx = jnp.where(is_end, d_s, 256)
    shape = (257, NLIMBS)
    one = jnp.asarray(fo.FQ.one_mont)
    bx = jnp.broadcast_to(one, shape).astype(jnp.int32).at[idx].set(x)
    by = jnp.broadcast_to(one, shape).astype(jnp.int32).at[idx].set(y)
    bz = jnp.zeros(shape, jnp.int32).at[idx].set(z)
    return bx, by, bz


@functools.partial(jax.jit)
def _bucket_fold(bx, by, bz):
    """sum_{d=1}^{255} d * bucket_d by running + suffix sums
    (the classic Pippenger bucket fold, 2*255 adds)."""
    b = co.JacPoint(bx[1:256], by[1:256], bz[1:256])

    def step(carry, pt):
        run, total = carry
        run = co.jac_add(run, pt)
        total = co.jac_add(total, run)
        return (run, total), None

    ident = co.jac_identity()
    rev = co.JacPoint(b.x[::-1], b.y[::-1], b.z[::-1])
    (_, total), _ = lax.scan(step, (ident, ident), rev)
    return total.x, total.y, total.z


def msm_bucket(points: co.AffinePoint, scalars, nbits: int = 256) -> co.JacPoint:
    """Windowed (8-bit) bucket MSM over slabs; scalars (n, 32) plain limbs."""
    n = points.x.shape[0]
    jac = co.affine_to_jac(points)
    scalars = jnp.asarray(scalars, jnp.int32)
    windows = (nbits + 7) // 8

    # per-window accumulated bucket tables across slabs
    totals = []
    for w in range(windows - 1, -1, -1):
        acc = None
        for s0 in range(0, n, _SLAB):
            s1 = min(s0 + _SLAB, n)
            bx, by, bz = _window_buckets(
                scalars[s0:s1, w],
                jac.x[s0:s1],
                jac.y[s0:s1],
                jac.z[s0:s1],
            )
            if acc is None:
                acc = (bx, by, bz)
            else:
                added = co.jac_add(
                    co.JacPoint(*acc), co.JacPoint(bx, by, bz)
                )
                acc = (added.x, added.y, added.z)
        totals.append(_bucket_fold(*acc))

    # Horner across windows, high -> low: total = 2^8 * total + total_w
    total = co.JacPoint(*(t[None] for t in totals[0]))
    for t in totals[1:]:
        for _ in range(8):
            total = co.jac_double(total)
        total = co.jac_add(total, co.JacPoint(*(c[None] for c in t)))
    return co.JacPoint(total.x[0], total.y[0], total.z[0])


def msm_host(points_int, scalars_int):
    """Oracle-backed MSM for tiny inputs / tests."""
    from ..oracle import curve as oc

    return oc.g1_msm(points_int, scalars_int)
