"""Device verifier vs host verifier: bit-exact quad parity, batched."""

import pytest

from halo2_aggregation.models import simple_example as se
from halo2_aggregation.plonk import kzg
from halo2_aggregation.plonk.keygen import keygen
from halo2_aggregation.plonk.prover import create_proof
from halo2_aggregation.plonk.verifier import verify_proof
from halo2_aggregation.plonk.device_verifier import verify_batch

K = 9


@pytest.fixture(scope="module")
def setup_proofs():
    params = kzg.setup(K)
    circuit = se.MyCircuit(constant=7, a=2, b=3)
    cs_e, _, asg_e = se.build(circuit.without_witnesses(), k=K)
    vk, pk = keygen(params, cs_e, asg_e)
    proofs, insts = [], []
    for a, b in [(2, 3), (4, 5), (1, 255)]:
        c = se.MyCircuit(constant=7, a=a, b=b)
        _, _, asg = se.build(c, k=K)
        pub = [c.public_output()]
        proofs.append(create_proof(params, pk, asg, [pub], seed=100 + a))
        insts.append([pub])
    return params, vk, insts, proofs


@pytest.mark.slow
def test_device_matches_host_quad(setup_proofs):
    params, vk, insts, proofs = setup_proofs
    # host reference quads
    host = [verify_proof(params, vk, ins, pf) for ins, pf in zip(insts, proofs)]
    for ok, _ in host:
        assert ok
    oks, efws = verify_batch(params, vk, insts, proofs)
    assert all(oks)
    for (ok_h, efw_h), efw_t in zip(host, efws):
        assert tuple(efw_h) == tuple(efw_t), "device quad != host quad"


@pytest.mark.slow
def test_slow_path_matches_fast_and_host(setup_proofs):
    """The sequential parity path (fast=False, fold-for-fold mirror of
    verifier.rs/multiopen.rs) must produce the identical quad as the
    production single-MSM path (fast=True) and the host verifier.

    Suite economics (VERDICT r2 item 9): the sequential path dispatches
    ~50 separate 254-step XLA-scan ladders, which the 2-core CPU backend
    executes in minutes per proof — so on CPU the fold-for-fold parity
    runs at B=1 (full 254-bit scalars, nothing narrowed); the full
    3-proof width runs whenever an accelerator backend is present."""
    import jax

    params, vk, insts, proofs = setup_proofs
    if jax.devices()[0].platform == "cpu":
        insts, proofs = insts[:1], proofs[:1]
    host = [verify_proof(params, vk, ins, pf) for ins, pf in zip(insts, proofs)]
    oks_f, efws_fast = verify_batch(params, vk, insts, proofs, fast=True)
    oks_s, efws_slow = verify_batch(params, vk, insts, proofs, fast=False)
    assert all(oks_f) and all(oks_s)
    for (ok_h, efw_h), efw_f, efw_s in zip(host, efws_fast, efws_slow):
        assert tuple(efw_s) == tuple(efw_f) == tuple(efw_h)


@pytest.mark.slow
def test_gathered_step_retraces_cleanly(setup_proofs):
    """Regression: tracing the gathered step twice under ONE vk (different
    batch shapes -> different jit keys) must not leak tracers between
    traces.  A per-vk constant cache in _desc_point_batch once stored
    DynamicJaxprTracers from the first trace and poisoned the second
    (UnexpectedTracerError when the sharded and single-chip paths ran in
    one process); both traces must now produce host-exact quads."""
    from halo2_aggregation.plonk.device_verifier import (
        batch_proofs,
        verify_algebra_fast,
    )
    from halo2_aggregation.plonk.verifier import parse_proof
    from halo2_aggregation.ops import curve_ops as co

    params, vk, insts, proofs = setup_proofs
    for n in (1, 2):  # two trace keys, same vk
        parsed = []
        for ins, pf in zip(insts[:n], proofs[:n]):
            ic = [params.commit_lagrange(col) for col in ins]
            parsed.append(parse_proof(vk, ic, pf))
        out = verify_algebra_fast(vk, batch_proofs(vk, parsed), parsed)
        quads = {k: co.jac_to_ints(out[k]) for k in ("e", "f", "w", "zw")}
        for i in range(n):
            ok, efw = verify_proof(params, vk, insts[i], proofs[i])
            assert ok
            got = tuple(quads[k][i] for k in ("e", "f", "w", "zw"))
            assert got == tuple(efw), f"retrace quad mismatch (B={n}, i={i})"


@pytest.mark.slow
def test_device_rejects_bad_proof(setup_proofs):
    params, vk, insts, proofs = setup_proofs
    bad = bytearray(proofs[0])
    bad[35] ^= 1  # corrupt a commitment byte
    try:
        oks, _ = verify_batch(params, vk, [insts[0]], [bytes(bad)])
        assert not oks[0]
    except ValueError:
        pass  # point decompression may legitimately fail
