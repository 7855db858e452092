"""Smoke run of the main path on an NVIDIA GPU, through the normal entry
points, at the sizes users run.

    python chip_smoke.py                # one card
    python chip_smoke.py --four-cards   # the mesh path on four cards
    python chip_smoke.py --deadline S   # dump stacks and fail after S s

One card, in one process (a JAX process reserves most of the card):

1. device       the GPU is JAX's backend; nvidia-smi's name and power
                limit; the native engine and the CUDA ladder build and load
2. aggregation  api.verify_batch(..., aggregate=True) over B=128 k=9
                simple-example proofs (bench.py's four, cycled): every quad
                equals the host verifier's, the folded pairing holds, and a
                batch with one corrupted proof is rejected
3. ladder       the CUDA ladder, the XLA scan and the Python-int oracle on
                the batch's 4,480 multiopen lanes (affine equality), with
                both timings, and the device step's time
4. prover       the k=21 outer proof of examples/simple_example.py
                (H2A_PHASE_D=1), byte-equal to docs/artifacts/
                outer_n1_k21.proof; then a k=16 simple-example proof with
                the device quotient and with the host quotient, byte-equal

--four-cards runs only the mesh path and its comparisons: sharded_msm
at 2^17 points against the native Pippenger, and
shmap_verify_algebra_fast on a dp=2 x mp=2 mesh at B=128 against the
one-card path and the host.

Earlier lines give each phase's wall seconds; any failed phase exits
non-zero.  The last line is one JSON object: {"ok": true, "device":
{"platform", "kind", "count"}}.  With no GPU the script exits non-zero
and prints no result.
"""

import faulthandler
import json
import os
import statistics
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, ROOT)

B = 128
WITNESSES = [(2, 3), (4, 5), (1, 255), (6, 6)]  # bench.py's four proofs
OUT_DIR = os.path.join(ROOT, "build", "smoke")
DEADLINE_S = 1150.0  # the run must end within 1,200 s


def log(msg: str) -> None:
    print(msg, flush=True)


class Phase:
    """Prints the phase's wall seconds, or its failure, and re-raises."""

    def __init__(self, name: str):
        self.name = name

    def __enter__(self):
        log(f"== phase {self.name}")
        self.t0 = time.time()
        return self

    def __exit__(self, exc_type, exc, tb):
        dt = time.time() - self.t0
        if exc_type is None:
            log(f"== phase {self.name} ok ({dt:.1f} s)")
        else:
            log(f"== phase {self.name} FAILED after {dt:.1f} s: {exc!r}")
        return False


def timed(fn, trials: int) -> float:
    """Median wall seconds of fn(), which must end in a device sync."""
    ts = []
    for _ in range(trials):
        t0 = time.time()
        fn()
        ts.append(time.time() - t0)
    return statistics.median(ts)


# -- phases ---------------------------------------------------------------------


def phase_device(expect_count: int) -> dict:
    import jax

    from halo2_aggregation import platform
    from halo2_aggregation.ops import ec_ladder
    from halo2_aggregation.utils import native

    dev = platform.require_gpu()
    assert dev["count"] >= expect_count, f"need {expect_count} cards: {dev}"
    log(platform.card_name_and_power_limit())
    log(f"jax {jax.__version__}: {dev}")
    log(f"device memory limit: {platform.device_memory_bytes()} bytes")
    log(f"compile cache: {platform.compile_cache_dir()}")
    t0 = time.time()
    log(f"native engine: {native.library_file()} ({time.time() - t0:.1f} s)")
    t0 = time.time()
    ec_ladder.load_cuda()
    log(f"cuda ladder: {ec_ladder.cuda_library_file()} ({time.time() - t0:.1f} s)")
    return dev


def inner_proofs(k: int = 9):
    """bench.py's four simple-example proofs and their host quads."""
    from halo2_aggregation import api
    from halo2_aggregation.models import simple_example as se
    from halo2_aggregation.plonk.keygen import keygen

    params = api.Setup.new(k)
    circuit = se.MyCircuit(constant=7, a=2, b=3)
    cs, _, asg = se.build(circuit.without_witnesses(), k=k)
    vk, pk = keygen(params, cs, asg)
    protos = []
    for a, b in WITNESSES:
        c = se.MyCircuit(constant=7, a=a, b=b)
        _, _, asg = se.build(c, k=k)
        insts = [[c.public_output()]]
        proof = api.create_proof(params, pk, asg, insts, seed=40 + a)
        ok, efw = api.verify_proof(params, vk, insts, proof)
        assert ok
        protos.append((insts, proof, tuple(efw)))
    return params, vk, protos


def corrupt_scalar(vk, params, insts, proof: bytes) -> bytes:
    """Flip one bit of an evaluation in the proof (the bytes still parse,
    so the batch must be rejected by the pairing, not by the parser)."""
    from halo2_aggregation import api

    inst_comms = [params.commit_lagrange(col) for col in insts]
    n_w = len(api.parse_proof(vk, inst_comms, proof).w_comms)
    off = len(proof) - 32 * (n_w + 1)
    while off > 0:
        bad = bytearray(proof)
        bad[off] ^= 1
        try:
            api.parse_proof(vk, inst_comms, bytes(bad))
            return bytes(bad)
        except ValueError:
            off -= 32
    raise AssertionError("no corruptible scalar found")


def phase_aggregation(params, vk, protos, batch: int):
    from halo2_aggregation import api

    insts = [protos[i % 4][0] for i in range(batch)]
    proofs = [protos[i % 4][1] for i in range(batch)]
    for label in ("cold (compiles)", "warm"):
        t0 = time.time()
        ok, efws = api.verify_batch(params, vk, insts, proofs, aggregate=True)
        log(f"verify_batch B={batch} {label}: {time.time() - t0:.2f} s")
        assert ok, "aggregate pairing rejected a valid batch"
        for i, efw in enumerate(efws):
            assert tuple(efw) == protos[i % 4][2], f"quad {i} != host quad"
    log(f"{batch} quads == host verify_proof quads; aggregate pairing holds")
    bad = list(proofs)
    bad[batch // 2] = corrupt_scalar(vk, params, insts[0], proofs[batch // 2])
    ok_bad, _ = api.verify_batch(params, vk, insts, bad, aggregate=True)
    assert not ok_bad, "aggregate accepted a batch with a corrupted proof"
    log("batch with one corrupted proof: rejected")
    return efws


def phase_ladder(params, vk, protos, batch: int):
    import jax
    import numpy as np

    from halo2_aggregation.ops import curve_ops as co
    from halo2_aggregation.ops import ec_ladder as el
    from halo2_aggregation.ops.limbs import limbs_to_ints
    from halo2_aggregation.oracle import curve as oc
    from halo2_aggregation.plonk import device_verifier as dv

    parsed = parse_batch(params, vk, protos, batch)
    lane_pts, lane_ss, _, _, _ = dv.fast_prep(vk, parsed)
    n = lane_ss.shape[0] * lane_ss.shape[1]
    pts = co.JacPoint(*(c.reshape(n, 32) for c in lane_pts))
    ss = lane_ss.reshape(n, 32)

    cuda = jax.jit(lambda p, s: el.scalar_mul_cuda(p, s, 254))
    scan = jax.jit(lambda p, s: co.scalar_mul(p, s, 254))
    res = {}
    for name, fn, trials in (("cuda", cuda, 10), ("xla_scan", scan, 3)):
        t0 = time.time()
        out = jax.block_until_ready(fn(pts, ss))
        first = time.time() - t0
        t = timed(lambda: jax.block_until_ready(fn(pts, ss)), trials)
        log(f"ladder {name}: {n} lanes, first call {first:.2f} s, "
            f"median {t * 1e3:.3f} ms ({n / t:.0f} scalar-muls/s)")
        res[name] = co.jac_to_ints(out)
    assert res["cuda"] == res["xla_scan"], "CUDA ladder != XLA scan"

    t0 = time.time()
    pts_int = co.jac_to_ints(pts)
    ks = limbs_to_ints(np.asarray(ss))
    memo = {}
    want = []
    for p, k in zip(pts_int, ks):
        key = (p, int(k))
        if key not in memo:
            memo[key] = None if p is None else oc.g1_mul(p, int(k))
        want.append(memo[key])
    assert res["cuda"] == want, "CUDA ladder != oracle"
    log(f"{n} lanes: CUDA == XLA scan == oracle g1_mul "
        f"({len(memo)} distinct lanes, oracle {time.time() - t0:.1f} s)")

    # the whole device step, as api.verify_batch compiled it
    descs, lane_ss_g, hc, kn = dv.fast_prep_gathered(vk, parsed)
    b = dv.batch_proofs(vk, parsed)
    step = dv._fast_device_gathered_jitted(vk, batch, descs)
    jax.block_until_ready(step(b, lane_ss_g, hc, kn))
    t = timed(lambda: jax.block_until_ready(step(b, lane_ss_g, hc, kn)), 5)
    log(f"device step B={batch} (CUDA ladder): median {t * 1e3:.2f} ms")


def phase_prover_k21():
    """The k=21 outer proof through examples/simple_example.py."""
    import runpy

    os.makedirs(OUT_DIR, exist_ok=True)
    os.environ.update(H2A_PHASE_D="1", H2A_ARTIFACTS_DIR=OUT_DIR)
    for var in ("H2A_NUM_PROOFS", "H2A_OUTER_K", "H2A_CONSTRAINED_FS",
                "H2A_WITNESS_OFFSET", "H2A_ARTIFACT_TAG"):
        os.environ.pop(var, None)
    log("quotient placement (H2A_DEVICE_QUOTIENT="
        f"{os.environ.get('H2A_DEVICE_QUOTIENT', '0')}): the coset lines "
        "below say (host) or (device)")
    example = runpy.run_path(
        os.path.join(ROOT, "examples", "simple_example.py"),
        run_name="simple_example",
    )
    example["main"]()
    import jax

    stats = jax.devices()[0].memory_stats()
    log(f"device memory after the prove: peak {stats['peak_bytes_in_use']} "
        f"of {stats['bytes_limit']} bytes")
    with open(os.path.join(OUT_DIR, "outer_n1_k21.proof"), "rb") as f:
        got = f.read()
    with open(os.path.join(ROOT, "docs", "artifacts", "outer_n1_k21.proof"), "rb") as f:
        want = f.read()
    assert got == want, "k=21 outer proof differs from the checked-in artifact"
    log(f"k=21 outer proof: {len(got)} bytes, == docs/artifacts/outer_n1_k21.proof")


def phase_quotient_k16(k: int = 16):
    """Both coset engines at k=16 on the simple example, byte for byte."""
    from halo2_aggregation.models import simple_example as se
    from halo2_aggregation.plonk import kzg
    from halo2_aggregation.plonk.keygen import keygen_native
    from halo2_aggregation.plonk.prover_native import create_proof_native
    from halo2_aggregation.plonk.verifier import verify_proof

    params = kzg.setup(k)
    circuit = se.MyCircuit(constant=7, a=2, b=3)
    cs, _, asg = se.build(circuit.without_witnesses(), k=k)
    vk, pk = keygen_native(params, cs, asg)
    insts = [[circuit.public_output()]]
    proofs = {}
    saved = os.environ.get("H2A_DEVICE_QUOTIENT")
    try:
        for mode, name in (("1", "device"), ("0", "host")):
            os.environ["H2A_DEVICE_QUOTIENT"] = mode
            _, _, asg = se.build(circuit, k=k)
            t0 = time.time()
            last = [t0]

            def prog(msg):
                now = time.time()
                log(f"  [k={k} {name} {now - t0:6.1f}s +{now - last[0]:5.1f}s] {msg}")
                last[0] = now

            proofs[name] = create_proof_native(
                params, pk, asg, insts, seed=42, progress=prog
            )
    finally:
        if saved is None:
            os.environ.pop("H2A_DEVICE_QUOTIENT", None)
        else:
            os.environ["H2A_DEVICE_QUOTIENT"] = saved
    assert proofs["device"] == proofs["host"], f"k={k} device quotient != host"
    ok, _ = verify_proof(params, vk, insts, proofs["device"])
    assert ok
    log(f"k={k} proof ({len(proofs['host'])} bytes): device quotient == host "
        "quotient, and it verifies")


def parse_batch(params, vk, protos, batch: int):
    from halo2_aggregation.plonk.verifier import parse_proof

    return [
        parse_proof(
            vk, [params.commit_lagrange(c) for c in protos[i % 4][0]],
            protos[i % 4][1],
        )
        for i in range(batch)
    ]


def phase_mesh_verify(params, vk, protos, one_card_efws, batch: int):
    """shmap_verify_algebra_fast on a dp=2 x mp=2 mesh of four cards."""
    import jax

    from halo2_aggregation.ops import curve_ops as co
    from halo2_aggregation.parallel.batch_verify import shmap_verify_algebra_fast
    from halo2_aggregation.parallel.mesh import make_mesh
    from halo2_aggregation.plonk.device_verifier import batch_proofs

    mesh = make_mesh(4)
    log(f"mesh {dict(mesh.shape)}")
    parsed = parse_batch(params, vk, protos, batch)
    b = batch_proofs(vk, parsed)
    for label in ("cold (compiles)", "warm"):
        t0 = time.time()
        out = jax.block_until_ready(shmap_verify_algebra_fast(mesh, vk, b, parsed))
        log(f"shmap_verify_algebra_fast B={batch} {label}: {time.time() - t0:.2f} s")
    quads = {q: co.jac_to_ints(out[q]) for q in ("e", "f", "w", "zw")}
    for i in range(batch):
        got = tuple(quads[q][i] for q in ("e", "f", "w", "zw"))
        assert got == protos[i % 4][2], f"mesh quad {i} != host quad"
        assert got == tuple(one_card_efws[i]), f"mesh quad {i} != one-card quad"
    log(f"{batch} mesh quads == one-card quads == host quads")


def phase_sharded_msm(msm_log2: int = 17):
    """sharded_msm over four cards against the native Pippenger."""
    import jax
    import jax.numpy as jnp
    import numpy as np
    from jax.sharding import Mesh

    from halo2_aggregation.ops import curve_ops as co
    from halo2_aggregation.ops import field_ops as fo
    from halo2_aggregation.oracle import curve as oc
    from halo2_aggregation.parallel.sharded_msm import sharded_msm
    from halo2_aggregation.utils import native
    from halo2_aggregation.utils.u64 import ints_to_u64, u64_to_limbs8, u64_to_points

    n = 1 << msm_log2
    rng = np.random.default_rng(5)
    g = oc.g1_generator()
    base = ints_to_u64([g[0], g[1]]).reshape(-1)
    aff, inf = native.g1_batch_mul_win(
        base, ints_to_u64([int(rng.integers(1, 1 << 62)) for _ in range(n)])
    )
    ks = [int.from_bytes(rng.bytes(31), "little") for _ in range(n)]
    pts = co.AffinePoint(
        fo.to_mont_chunked(jnp.asarray(u64_to_limbs8(aff[:, :4])), fo.FQ),
        fo.to_mont_chunked(jnp.asarray(u64_to_limbs8(aff[:, 4:])), fo.FQ),
        jnp.asarray(inf.astype(bool)),
    )
    ss = jnp.asarray(u64_to_limbs8(ints_to_u64(ks)))
    mesh = Mesh(np.array(jax.devices()[:4]), ("lanes",))
    for label in ("cold (compiles)", "warm"):
        t0 = time.time()
        tot = jax.block_until_ready(sharded_msm(mesh, "lanes", pts, ss, 254))
        log(f"sharded_msm 2^{msm_log2} over 4 devices {label}: "
            f"{time.time() - t0:.2f} s")
    got = co.jac_to_ints(co.JacPoint(tot.x[None], tot.y[None], tot.z[None]))[0]
    t0 = time.time()
    want = native.g1_msm(u64_to_points(aff, inf), ks)
    log(f"native Pippenger 2^{msm_log2}: {time.time() - t0:.2f} s")
    assert got == want, "sharded MSM != native Pippenger"
    log(f"sharded_msm 2^{msm_log2} == native Pippenger")


# -- driver ----------------------------------------------------------------------


def main(argv) -> int:
    four = "--four-cards" in argv
    deadline = DEADLINE_S
    if "--deadline" in argv:
        deadline = float(argv[argv.index("--deadline") + 1])
    import jax

    if jax.default_backend() != "gpu":
        print(f"chip_smoke: no GPU (JAX backend: {jax.default_backend()})",
              file=sys.stderr)
        return 2
    from halo2_aggregation import platform

    platform.enable_compile_cache()
    # past the deadline: every thread's stack to stderr, then exit 1
    faulthandler.dump_traceback_later(deadline, exit=True)
    t_all = time.time()
    with Phase("device"):
        dev = phase_device(4 if four else 1)
    with Phase("inner proofs"):
        params, vk, protos = inner_proofs()
    if four:
        with Phase("one-card aggregation"):
            efws = phase_aggregation(params, vk, protos, B)
        with Phase("sharded msm"):
            phase_sharded_msm()
        with Phase("mesh verify"):
            phase_mesh_verify(params, vk, protos, efws, B)
    else:
        with Phase("aggregation"):
            phase_aggregation(params, vk, protos, B)
        with Phase("ladder"):
            phase_ladder(params, vk, protos, B)
        with Phase("prover k=21"):
            phase_prover_k21()
        with Phase("quotient k=16"):
            phase_quotient_k16()
    faulthandler.cancel_dump_traceback_later()
    log(f"all phases ok ({time.time() - t_all:.1f} s)")
    print(json.dumps({"ok": True, "device": {
        "platform": dev["platform"], "kind": dev["kind"], "count": dev["count"],
    }}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
