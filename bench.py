"""Benchmark: B simple-example proofs -> one accumulator, on one GPU.

Prints ONE JSON line:
  {"metric": "proofs_aggregated_per_s", "value": N, "unit": "proofs/s",
   "vs_baseline": M, "detail": {...}}

The metric is the end-to-end aggregation pipeline at batch B on one card:
per-proof Blake2b transcript replay (host) -> batched verification
algebra (device: Lagrange evals, all constraint expressions, the
single-MSM GWC multiopen fold via the CUDA ladder) -> quad extraction ->
ONE folded pairing check for the whole batch (native C++ pairing).  This
is BASELINE.json's headline ("proofs aggregated/sec").

The reference publishes no numbers (BASELINE.md: "none exist"), so
vs_baseline is measured against this repo's own single-threaded host-int
verifier doing the same algebra.

Methodology:
  * medians over trials, not best-of;
  * every timed region ends in a device-to-host copy;
  * parity gates (ladder vs the oracle, MSM vs native Pippenger) run
    before the timings they guard;
  * per-stage timings (parse/prep/device+D2H/pairing) in the detail;
  * the device is named (platform, kind, count, and nvidia-smi's name and
    power limit); with no GPU the benchmark fails.
"""

import json
import os
import statistics
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))


def median_rate(fn, work, trials):
    ts = []
    for _ in range(trials):
        t0 = time.time()
        fn()
        ts.append(time.time() - t0)
    return work / statistics.median(ts), statistics.median(ts)


def median_rate_spread(fn, work, trials):
    """(median_rate, [per-trial rates]): the spread is reported beside the
    median."""
    ts = []
    for _ in range(trials):
        t0 = time.time()
        fn()
        ts.append(time.time() - t0)
    return work / statistics.median(ts), [round(work / t, 3) for t in ts]


def main():
    import jax
    import jax.numpy as jnp
    import numpy as np

    from halo2_aggregation import platform

    platform.enable_compile_cache()
    device = platform.require_gpu()
    device["nvidia_smi"] = platform.card_name_and_power_limit()

    from halo2_aggregation.config import H2AConfig
    from halo2_aggregation.models import simple_example as se
    from halo2_aggregation.ops import curve_ops as co
    from halo2_aggregation.ops import field_ops as fo
    from halo2_aggregation.ops.ec_ladder import scalar_mul_lanes
    from halo2_aggregation.ops.limbs import ints_to_limbs
    from halo2_aggregation.plonk import kzg
    from halo2_aggregation.plonk.device_verifier import (
        _fast_device_gathered_jitted,
        batch_proofs,
        check_aggregate,
        fast_prep,
        fast_prep_gathered,
    )
    from halo2_aggregation.plonk.keygen import keygen
    from halo2_aggregation.plonk.prover import create_proof
    from halo2_aggregation.plonk.verifier import parse_proof, verify_proof

    cfg = H2AConfig.from_env()
    B = cfg.batch
    k = cfg.k_inner

    # --- build real proofs, cycle to a batch of B -------------------------
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

    stage = {}

    def full_aggregate_once(record=False):
        """parse B transcripts -> device algebra -> quads -> ONE folded
        pairing: the end-to-end 'B proofs -> one accumulator' pipeline."""
        t0 = time.time()
        parsed = [
            parse_proof(vk, protos[i % 4][2], protos[i % 4][1])
            for i in range(B)
        ]
        t1 = time.time()
        batch = batch_proofs(vk, parsed)
        descs, lane_ss, hc, kn = fast_prep_gathered(vk, parsed)
        t2 = time.time()
        step = _fast_device_gathered_jitted(vk, B, descs)
        stacked, _h = step(batch, lane_ss, hc, kn)
        arr = np.asarray(stacked)  # ONE D2H transfer for all 12 coords
        quads_cols = [
            co.jac_to_ints(co.JacPoint(arr[3 * i], arr[3 * i + 1], arr[3 * i + 2]))
            for i in range(4)
        ]
        t3 = time.time()
        quads = [tuple(qc[i] for qc in quads_cols) for i in range(B)]
        ok = check_aggregate(quads, params)
        t4 = time.time()
        assert ok
        if record:
            stage.update(
                parse_s=round(t1 - t0, 3),
                prep_s=round(t2 - t1, 3),
                device_and_d2h_s=round(t3 - t2, 3),
                pairing_s=round(t4 - t3, 3),
            )

    full_aggregate_once()  # warmup + compile
    agg_rate, agg_spread = median_rate_spread(
        full_aggregate_once, B, trials=int(os.environ.get("H2A_BENCH_TRIALS", "5"))
    )
    # profiler capture: H2A_PROFILE=<dir> records a jax.profiler trace of
    # one end-to-end aggregation
    prof_dir = os.environ.get("H2A_PROFILE")
    if prof_dir:
        with jax.profiler.trace(prof_dir):
            full_aggregate_once(record=True)
    else:
        full_aggregate_once(record=True)

    # --- device verification algebra alone --------------------------------
    parsed = [parse_proof(vk, protos[i % 4][2], protos[i % 4][1]) for i in range(B)]
    batch = batch_proofs(vk, parsed)
    lanes = fast_prep(vk, parsed)  # coordinate-materializing (ladder diag)
    descs_g, lane_ss_g, hc_g, kn_g = fast_prep_gathered(vk, parsed)

    step = _fast_device_gathered_jitted(vk, B, descs_g)

    def algebra_once():
        stacked, _h = step(batch, lane_ss_g, hc_g, kn_g)
        np.asarray(stacked)

    algebra_once()
    device_rate, _ = median_rate(algebra_once, B, trials=3)

    # --- EC ladder diagnostic: scalar-muls/s over the real lanes ----------
    n_lanes = int(lanes[0].x.shape[0] * lanes[0].x.shape[1])
    ladder = jax.jit(lambda p, s: scalar_mul_lanes(p, s, 254))

    def ladder_once():
        np.asarray(ladder(lanes[0], lanes[1]).x)

    ladder_once()
    # parity gate before timing: the compiled ladder must agree with the
    # Python-int oracle on real verifier lanes (affine equality)
    from halo2_aggregation.oracle import curve as _oc
    from halo2_aggregation.ops.limbs import limbs_to_ints

    par_n = 8
    sl = co.JacPoint(
        lanes[0].x.reshape(-1, 32)[:par_n],
        lanes[0].y.reshape(-1, 32)[:par_n],
        lanes[0].z.reshape(-1, 32)[:par_n],
    )
    sl_ks = lanes[1].reshape(-1, 32)[:par_n]
    got = co.jac_to_ints(ladder(sl, sl_ks))
    want = [
        _oc.g1_mul(p, int(k))
        for p, k in zip(co.jac_to_ints(sl), limbs_to_ints(np.asarray(sl_ks)))
    ]
    assert got == want, "ladder diverges from the oracle on real lanes"
    ladder_rate, _ = median_rate(ladder_once, n_lanes, trials=3)

    # --- device bucket MSM (XLA sort+scan, ops/msm.py) ---------------------
    # 2^n_msm random points x 254-bit scalars; ~2N point-adds per 8-bit
    # window x 32 windows.  Parity-gated against native Pippenger.
    from halo2_aggregation.ops import msm as msm_mod
    from halo2_aggregation.oracle import curve as oc_
    from halo2_aggregation.utils import native as native_
    from halo2_aggregation.utils.u64 import (
        ints_to_u64,
        u64_to_limbs8,
        u64_to_points,
    )

    n_msm = 1 << int(os.environ.get("H2A_BENCH_MSM_LOG2", "17"))
    base = oc_.g1_generator()
    base_u64 = ints_to_u64([base[0], base[1]]).reshape(-1)
    msm_rng = np.random.default_rng(5)
    msm_ks = ints_to_u64(
        [int(msm_rng.integers(1, 1 << 62)) for _ in range(n_msm)]
    )
    aff_u64, inf_u64 = native_.g1_batch_mul_win(base_u64, msm_ks)
    msm_pts = co.AffinePoint(
        jnp.asarray(fo.to_mont(jnp.asarray(u64_to_limbs8(aff_u64[:, :4])), fo.FQ)),
        jnp.asarray(fo.to_mont(jnp.asarray(u64_to_limbs8(aff_u64[:, 4:])), fo.FQ)),
        jnp.asarray(inf_u64.astype(bool)),
    )
    msm_scalar_ints = [
        int.from_bytes(msm_rng.bytes(31), "little") for _ in range(n_msm)
    ]
    msm_ss = jnp.asarray(u64_to_limbs8(ints_to_u64(msm_scalar_ints)))

    def msm_once():
        r = msm_mod.msm(msm_pts, msm_ss, 254)
        return np.asarray(r.x), np.asarray(r.y), np.asarray(r.z)

    mx, my, mz = msm_once()  # warmup/compile + parity input
    got_msm = co.jac_to_ints(
        co.JacPoint(jnp.asarray(mx)[None], jnp.asarray(my)[None], jnp.asarray(mz)[None])
    )[0]
    want_msm = native_.g1_msm(
        u64_to_points(aff_u64, inf_u64), msm_scalar_ints
    )
    assert got_msm == want_msm, "device MSM diverges from native Pippenger"
    msm_adds = 2 * n_msm * 32
    msm_rate, msm_t = median_rate(lambda: msm_once(), msm_adds, trials=2)

    # --- host baseline: same algebra, single thread, python ints ----------
    pub, proof = protos[0][0], protos[0][1]
    t0 = time.time()
    host_iters = 2
    for _ in range(host_iters):
        ok, _ = verify_proof(params, vk, [pub], proof)
        assert ok
    host_full = (time.time() - t0) / host_iters
    # subtract the (native) pairing cost — deferred in production
    from halo2_aggregation.oracle import curve as oc
    from halo2_aggregation.oracle.pairing import multi_pairing_check_fast

    g = oc.g1_generator()
    t0 = time.time()
    multi_pairing_check_fast([(g, params.s_g2), (oc.g1_neg(g), params.g2)])
    pairing_t = time.time() - t0
    host_rate = 1.0 / max(host_full - pairing_t, 1e-9)

    # --- field-mul micro-bench: 128 chained muls over 2^16 lanes ----------
    rng = np.random.default_rng(0)
    m = 1 << 16
    chain = 128
    a = jnp.asarray(
        ints_to_limbs(
            [int.from_bytes(rng.bytes(32), "little") % fo.FR.p for _ in range(256)]
        )
    )
    a = jnp.tile(a, (m // 256, 1))

    @jax.jit
    def chain_mul(x, y):
        for _ in range(chain):
            x = fo.mont_mul(x, y, fo.FR)
        return x

    r = chain_mul(a, a)
    np.asarray(r[0])  # warm
    t0 = time.time()
    r = chain_mul(r, a)
    np.asarray(r[0])
    fmul_t = time.time() - t0
    fmul_rate = chain * m / fmul_t

    print(
        json.dumps(
            {
                "metric": "proofs_aggregated_per_s",
                "value": round(agg_rate, 3),
                "unit": "proofs/s",
                "vs_baseline": round(agg_rate / host_rate, 3),
                "detail": {
                    "batch": B,
                    "verify_algebra_proofs_per_s": round(device_rate, 3),
                    "ladder_scalar_muls_per_s": round(ladder_rate, 1),
                    "multiopen_lanes": n_lanes,
                    "host_algebra_proofs_per_s": round(host_rate, 3),
                    "msm_mpoint_adds_per_s": round(msm_rate / 1e6, 3),
                    "msm_n_points": n_msm,
                    "msm_wall_s": round(msm_t, 3),
                    "native_pairing_s": round(pairing_t, 3),
                    "fr_mont_mul_per_s": round(fmul_rate, 1),
                    "agg_trials_proofs_per_s": agg_spread,
                    "stages": stage,
                    "device": device,
                },
            }
        )
    )


if __name__ == "__main__":
    main()
