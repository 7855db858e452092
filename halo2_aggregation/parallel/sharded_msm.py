"""Mesh-sharded MSM: points/scalars split across devices, partial sums
combined with collectives.

SURVEY.md §2d's "MSM/bucket parallelism" row: each device runs the
batched ladder (ops/ec_ladder.py: CUDA on the GPU) over its local shard
of point lanes, reduces locally to one Jacobian partial, then the
partials are all-gathered (a point sum is not a ring `psum` — EC
addition isn't an arithmetic add — so we gather the per-device partials
and add them, replicated; D points of traffic, negligible vs the local
work)."""

from __future__ import annotations

import functools

import jax
from jax.sharding import Mesh, PartitionSpec as P
from jax import shard_map

from ..ops import curve_ops as co
from ..ops.ec_ladder import scalar_mul_lanes


def _fold_lanes(p: co.JacPoint) -> co.JacPoint:
    """Sum (n, 32) points to one: fold n/w columns of width w, then the w
    column sums, so the serial scans take ~2*sqrt(n) steps, not n."""
    n = p.x.shape[0]
    w = 1 << max(0, (n.bit_length() - 1) // 2)
    if n % w:
        return co.jac_sum(p)
    cols = co.jac_sum(co.JacPoint(*(c.reshape(n // w, w, -1) for c in p)))
    return co.jac_sum(cols)


def sharded_msm(mesh: Mesh, axis: str, points: co.AffinePoint, scalars, nbits=254):
    """points: (N, 32) AffinePoint, scalars: (N, 32) plain limbs; N must be
    divisible by the mesh axis size.  Returns a replicated JacPoint sum."""
    x, y, z = _sharded_msm_step(mesh, axis, nbits)(
        points.x, points.y, points.inf, scalars
    )
    return co.JacPoint(x, y, z)


@functools.lru_cache(maxsize=None)
def _sharded_msm_step(mesh: Mesh, axis: str, nbits: int):
    """The jitted shard_map program of sharded_msm, built once per mesh."""

    def local(px, py, pinf, s):
        jac = co.affine_to_jac(co.AffinePoint(px, py, pinf))
        per = scalar_mul_lanes(jac, s, nbits)
        part = _fold_lanes(per)  # local partial (32,)
        # gather all partials and tree-add (replicated on every device)
        gx = jax.lax.all_gather(part.x, axis)
        gy = jax.lax.all_gather(part.y, axis)
        gz = jax.lax.all_gather(part.z, axis)
        total = co.jac_sum(co.JacPoint(gx, gy, gz))
        return total.x, total.y, total.z

    spec_sharded = P(axis)
    spec_repl = P()
    return jax.jit(
        shard_map(
            local,
            mesh=mesh,
            in_specs=(spec_sharded, spec_sharded, spec_sharded, spec_sharded),
            out_specs=(spec_repl, spec_repl, spec_repl),
            check_vma=False,
        )
    )
