"""Multi-proof verification sharded over a device mesh.

The batched verifier (plonk/device_verifier.py) is batch-polymorphic, so
scaling to many chips is pure data parallelism: shard every (B, ...) leaf
of the VerifierBatch over the `dp` mesh axis and let XLA run the identical
program on each shard — the reference's `num_proofs: 1` loop
(simple-example.rs:651-658) becomes B proofs across D chips.

The production step, `shmap_verify_algebra_fast`, is a `shard_map` with
explicit collectives: the per-shard program is compiled once at
shard-local shapes, the CUDA ladder runs per shard (an FFI call cannot
be partitioned by GSPMD), and the only communication is four tiny
`all_gather`s of per-shard Jacobian partials over `mp`.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
from jax import lax
from jax import shard_map
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from ..plonk.device_verifier import VerifierBatch, field_algebra


def shard_batch(mesh: Mesh, batch: VerifierBatch, axis: str = "dp") -> VerifierBatch:
    """device_put every leaf with the proof axis sharded over `axis`."""

    def put(leaf):
        if leaf is None:
            return None
        spec = P(axis, *([None] * (leaf.ndim - 1)))
        return jax.device_put(leaf, NamedSharding(mesh, spec))

    return jax.tree_util.tree_map(put, batch)


def sharded_field_algebra(mesh: Mesh, vk, batch: VerifierBatch, B: int):
    """Run the verifier field algebra with the proof axis sharded; XLA
    compiles one SPMD program, no collectives needed (fully data parallel)."""
    sharded = shard_batch(mesh, batch)
    return field_algebra(vk, sharded, B)


_SHMAP_JIT = {}


def shmap_verify_algebra_fast(mesh: Mesh, vk, batch: VerifierBatch, parsed):
    """The production verifier step under a dp x mp mesh via `shard_map`:

    * proofs shard over `dp` (pure data parallelism — the reference's
      one-proof loop, simple-example.rs:651-658, across chips);
    * each component's multiopen lanes shard over `mp`; every shard runs
      field algebra (for its local proofs) + ONE batched 254-bit ladder
      over its local lanes, reduces them to per-component Jacobian
      partials, and the partials are combined with an `all_gather` over
      `mp` + a log2(mp) tree add (EC addition is not a ring `psum`).

    The e-lane (e = -(eval_known + h_coeff*h_eval) * G1) rides the same
    ladder call on every shard, with its scalar zeroed on mp ranks != 0
    (zero scalar -> identity point -> inert under the tree add).

    The per-shard program is compiled directly at local shapes, with no
    GSPMD partitioning pass, once per (mesh, vk, B, lane counts)."""
    from ..ops import curve_ops as co
    from ..plonk.device_verifier import fast_prep

    mp = mesh.shape["mp"]
    B = len(parsed)
    assert B % mesh.shape["dp"] == 0, "proof batch must divide dp"
    lane_pts, lane_scalars, ms, h_coeff, known = fast_prep(
        vk, parsed, lane_pad=mp
    )
    # Split the concatenated lane axis back into per-component arrays so
    # each component (already padded to a multiple of mp by fast_prep)
    # shards evenly over mp without crossing component boundaries.
    comp_pts, comp_ss = [], []
    off = 0
    for m in ms:
        comp_pts.append(
            co.JacPoint(
                lane_pts.x[:, off : off + m],
                lane_pts.y[:, off : off + m],
                lane_pts.z[:, off : off + m],
            )
        )
        comp_ss.append(lane_scalars[:, off : off + m])
        off += m
    key = (mesh, vk.hash_scalar(), B, tuple(ms))
    if key not in _SHMAP_JIT:
        _SHMAP_JIT[key] = _shmap_step(mesh, vk, B, tuple(ms))
    b = jax.tree_util.tree_map(lambda x: x if x is None else jnp.asarray(x), batch)
    return _SHMAP_JIT[key](b, tuple(comp_pts), tuple(comp_ss), h_coeff, known)


def _shmap_step(mesh: Mesh, vk, B: int, ms: tuple):
    """The jitted shard_map program of shmap_verify_algebra_fast."""
    from ..fields import G1_GEN
    from ..ops import curve_ops as co
    from ..ops import field_ops as fo
    from ..ops.ec_ladder import scalar_mul_lanes
    from ..plonk.device_verifier import _points_to_batch

    FR = fo.FR
    mp = mesh.shape["mp"]
    B_loc = B // mesh.shape["dp"]
    ms_loc = tuple(m // mp for m in ms)

    def local(b_loc, pts_loc, ss_loc, hc, kn):
        h_eval, _, _ = field_algebra(vk, b_loc, B_loc)
        eval_multi = fo.add(fo.mont_mul(hc, h_eval, FR), kn, FR)
        e_scalar = fo.from_mont(fo.neg(eval_multi, FR), FR)  # (B_loc, 32)
        on_rank0 = lax.axis_index("mp") == 0
        e_s = jnp.where(on_rank0, e_scalar, jnp.zeros_like(e_scalar))
        g1 = _points_to_batch([G1_GEN] * B_loc)
        all_pts = co.JacPoint(
            jnp.concatenate([p.x for p in pts_loc] + [g1.x[:, None, :]], 1),
            jnp.concatenate([p.y for p in pts_loc] + [g1.y[:, None, :]], 1),
            jnp.concatenate([p.z for p in pts_loc] + [g1.z[:, None, :]], 1),
        )
        all_ss = jnp.concatenate(list(ss_loc) + [e_s[:, None, :]], axis=1)
        per = scalar_mul_lanes(all_pts, all_ss, 254)

        # ONE segmented scan folds every local lane into its component
        # accumulator (w=0, zw=1, f=2, e=3) — compile-once body instead of
        # per-component unrolled reductions
        seg = np.concatenate(
            [np.full(m, i, np.int32) for i, m in enumerate(ms_loc)]
            + [np.array([3], np.int32)]
        )
        lanes_first = co.JacPoint(
            jnp.moveaxis(per.x, 1, 0),
            jnp.moveaxis(per.y, 1, 0),
            jnp.moveaxis(per.z, 1, 0),
        )
        partial = co.jac_segment_sum(lanes_first, seg, 4)  # (4, B_loc, 32)
        g = co.JacPoint(
            lax.all_gather(partial.x, "mp"),
            lax.all_gather(partial.y, "mp"),
            lax.all_gather(partial.z, "mp"),
        )  # (mp, 4, B_loc, 32)
        tot = co.jac_sum(g)  # one more scan fold across mp partials
        quads = {
            name: co.JacPoint(tot.x[i], tot.y[i], tot.z[i])
            for i, name in enumerate(("w", "zw", "f", "e"))
        }
        quads["h_eval"] = h_eval
        return quads

    dp_spec = P("dp")
    lane_spec = P("dp", "mp")
    return jax.jit(
        shard_map(
            local,
            mesh=mesh,
            in_specs=(dp_spec, lane_spec, lane_spec, dp_spec, dp_spec),
            out_specs=dp_spec,
            check_vma=False,
        )
    )
