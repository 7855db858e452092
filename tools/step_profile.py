"""Profile the aggregation pipeline's jitted device step piece by piece.

This tool splits the gathered step (`device_verifier.fast_device_gathered`)
into separately-jitted pieces and times each (every timed call ends in a
device-to-host copy), so the share of each piece gets a recorded
breakdown:

  field_algebra   transcript-replay scalar algebra for h_eval (B, 32)
  gather          trace-time lane-point gather/concat out of the batch
  ladder          ONE (B, M)-lane 254-bit scalar-mul (ops/ec_ladder.py:
                  the CUDA ladder on the GPU, the XLA scan on the CPU)
  folds           per-component jac sums + output stack
  full            the production single-dispatch step (reference)

Sum(pieces) > full is expected (extra dispatches + D2H per piece); the
RATIO between pieces is the signal.  Run on the GPU:
    python tools/step_profile.py            # B from H2A_BENCH_BATCH
Each piece is a fresh jit program; compiles are kept in the persistent
cache (platform.compile_cache_dir()).
"""

import json
import os
import statistics
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax
import jax.numpy as jnp
import numpy as np

from halo2_aggregation import platform

platform.enable_compile_cache()


def timed(fn, trials=5):
    ts = []
    for _ in range(trials):
        t0 = time.time()
        fn()
        ts.append(time.time() - t0)
    return statistics.median(ts), ts


def main():
    from halo2_aggregation.config import H2AConfig
    from halo2_aggregation.models import simple_example as se
    from halo2_aggregation.ops import curve_ops as co
    from halo2_aggregation.ops.ec_ladder import scalar_mul_lanes
    from halo2_aggregation.plonk import kzg
    from halo2_aggregation.plonk.keygen import keygen
    from halo2_aggregation.plonk.prover import create_proof
    from halo2_aggregation.plonk.verifier import parse_proof
    from halo2_aggregation.plonk.device_verifier import (
        _desc_point_batch,
        _fast_device_gathered_jitted,
        batch_proofs,
        fast_prep_gathered,
        field_algebra,
    )

    cfg = H2AConfig.from_env()
    B = cfg.batch
    k = cfg.k_inner
    params = kzg.setup(k)
    circuit = se.MyCircuit(constant=7, a=2, b=3)
    cs_e, _, asg_e = se.build(circuit.without_witnesses(), k=k)
    vk, pk = keygen(params, cs_e, asg_e)
    protos = []
    for a, b in [(2, 3), (4, 5), (1, 255), (6, 6)]:
        c = se.MyCircuit(constant=7, a=a, b=b)
        _, _, asg = se.build(c, k=k)
        pub = [c.public_output()]
        proof = create_proof(params, pk, asg, [pub], seed=40 + a)
        protos.append((pub, proof, [params.commit_lagrange(pub)]))

    parsed = [
        parse_proof(vk, protos[i % 4][2], protos[i % 4][1]) for i in range(B)
    ]
    batch = batch_proofs(vk, parsed)
    descs, lane_ss, hc, kn = fast_prep_gathered(vk, parsed)
    batch = jax.tree_util.tree_map(
        lambda x: x if x is None else jnp.asarray(x), batch
    )
    for leaf in jax.tree_util.tree_leaves(batch):
        np.asarray(jnp.ravel(leaf)[0])  # force uploads outside timings
    lane_ss = jnp.asarray(lane_ss)
    np.asarray(lane_ss[0, 0, 0])

    out = {}

    # ---- piece 1: field algebra --------------------------------------
    @jax.jit
    def fa(b):
        h, _, _ = field_algebra(vk, b, B)
        return h

    fa_out = fa(batch)
    np.asarray(fa_out)  # compile + warm
    out["field_algebra_s"], _ = timed(lambda: np.asarray(fa(batch)))

    # ---- piece 2: lane-point gather ----------------------------------
    flat_descs = tuple(d for comp in descs for d in comp)

    @jax.jit
    def gather(b):
        pts = [_desc_point_batch(vk, b, d, B) for d in flat_descs]
        return (
            jnp.stack([p.x for p in pts], 1),
            jnp.stack([p.y for p in pts], 1),
            jnp.stack([p.z for p in pts], 1),
        )

    gx, gy, gz = gather(batch)
    np.asarray(gx[0, 0, 0])
    out["gather_s"], _ = timed(
        lambda: [np.asarray(c[0, 0, 0]) for c in gather(batch)]
    )
    # materialized pre-gathered inputs for the ladder piece
    gx, gy, gz = (jnp.asarray(np.asarray(c)) for c in (gx, gy, gz))

    # ---- piece 3: the ladder -----------------------------------------
    @jax.jit
    def ladder(px, py, pz, ss):
        return scalar_mul_lanes(co.JacPoint(px, py, pz), ss, 254)

    lad = ladder(gx, gy, gz, lane_ss)
    np.asarray(lad.x[0, 0, 0])
    out["ladder_s"], _ = timed(
        lambda: np.asarray(ladder(gx, gy, gz, lane_ss).x[0, 0, 0])
    )
    lx, ly, lz = (jnp.asarray(np.asarray(c)) for c in (lad.x, lad.y, lad.z))

    # ---- piece 4: per-component folds + output stack -----------------
    ms = tuple(len(comp) for comp in descs)

    @jax.jit
    def folds(px, py, pz):
        quads = []
        off = 0
        for m in ms:
            per = co.JacPoint(
                px[:, off : off + m], py[:, off : off + m], pz[:, off : off + m]
            )
            off += m
            trans = co.JacPoint(
                jnp.moveaxis(per.x, 1, 0),
                jnp.moveaxis(per.y, 1, 0),
                jnp.moveaxis(per.z, 1, 0),
            )
            quads.append(co.jac_sum(trans))
        return jnp.stack(
            [getattr(q, c) for q in quads for c in ("x", "y", "z")]
        )

    fo_out = folds(lx, ly, lz)
    np.asarray(fo_out[0, 0, 0])
    out["folds_s"], _ = timed(lambda: np.asarray(folds(lx, ly, lz)[0, 0, 0]))

    # ---- reference: the full production step + its D2H ---------------
    step = _fast_device_gathered_jitted(vk, B, descs)
    stacked, _h = step(batch, lane_ss, hc, kn)
    np.asarray(stacked)
    out["full_step_s"], _ = timed(
        lambda: np.asarray(step(batch, lane_ss, hc, kn)[0][0, 0, 0])
    )
    out["full_step_d2h_s"], _ = timed(
        lambda: np.asarray(step(batch, lane_ss, hc, kn)[0])
    )

    out["B"] = B
    out["lanes"] = sum(ms) + 1
    out["device"] = platform.describe()
    print(json.dumps(out))


if __name__ == "__main__":
    main()
