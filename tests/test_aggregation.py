"""In-circuit verifier: the aggregation circuit verifies a real inner proof.

The reference's headline milestone ("a circuit that can check if a proof is
valid using vk", README.md:5): build the simple-example inner proof, run
the full in-circuit verifier over it, and check (a) the in-circuit quad
equals the native verifier's (e, f, w, zw) bit-exactly, and (b) all
constraints hold (MockProver, full or sampled via H2A_FULL_MOCK)."""

import os

import pytest

from halo2_aggregation.models import simple_example as se
from halo2_aggregation.models import aggregation_circuit as ac
from halo2_aggregation.plonk import kzg
from halo2_aggregation.plonk.keygen import keygen
from halo2_aggregation.plonk.prover import create_proof
from halo2_aggregation.plonk.verifier import verify_proof


@pytest.fixture(scope="module")
def inner_proof():
    k = 9
    params = kzg.setup(k)
    circuit = se.MyCircuit(constant=7, a=2, b=3)
    cs_e, _, asg_e = se.build(circuit.without_witnesses(), k=k)
    vk, pk = keygen(params, cs_e, asg_e)
    _, _, asg = se.build(circuit, k=k)
    pub = [circuit.public_output()]
    proof = create_proof(params, pk, asg, [pub], seed=42)
    ok, efw = verify_proof(params, vk, [pub], proof)
    assert ok
    inst_comm = params.commit_lagrange(pub)
    return params, vk, proof, pub, inst_comm, efw


@pytest.mark.slow
def test_in_circuit_verifier_quad_matches(inner_proof):
    """Witness-level first: the in-circuit computation reproduces the
    native verifier's quad exactly (the reference's `debug`-feature
    diff, SURVEY.md §4), on a full-width (254-bit mul) synthesis."""
    params, vk, proof, pub, inst_comm, efw = inner_proof
    outer_k = 21
    circuit = ac.SingleProofCircuit(vk, proof)
    public_inputs = circuit.public_inputs(inst_comm, efw)
    cs, cfg, asg, ctx, quad = ac.build(circuit, outer_k, public_inputs)
    got = [quad.e.value(), quad.f.value(), quad.w.value(), quad.zw.value()]
    assert got == list(efw), "in-circuit quad != native verifier quad"
    print(f"rows used: {ctx.offset} (k={outer_k} capacity {1 << outer_k})")
    assert ctx.offset <= cs.usable_rows(1 << outer_k)

    # Full constraint check is default-on for the slow suite (the single
    # most important correctness property of the in-circuit verifier);
    # H2A_FULL_MOCK=0 opts out for quick local iteration.
    if os.environ.get("H2A_FULL_MOCK", "1") == "1":
        from halo2_aggregation.plonk.mock import mock_verify_fast

        failures = mock_verify_fast(cs, asg)
        assert failures == [], failures[:5]


def test_fold_quads_host_matches_aggregate_quads(inner_proof):
    """The circuit's host-side fold reference == device_verifier.aggregate_quads."""
    from halo2_aggregation.models.aggregation_circuit import (
        aggregate_lambda,
        fold_quads_host,
    )
    from halo2_aggregation.plonk.device_verifier import aggregate_quads

    params, vk, proof, pub, inst_comm, efw = inner_proof
    quads = [tuple(efw), tuple(efw)]
    (W, RHS), lam = aggregate_quads(quads, None, params.s_g2, params.g2)
    W2, RHS2 = fold_quads_host(quads)
    assert lam == aggregate_lambda(quads)
    assert (W, RHS) == (W2, RHS2)


@pytest.mark.slow
def test_two_proof_aggregation_circuit(inner_proof):
    """VERDICT r1 item 6 'done' criterion: a 2-proof outer circuit whose
    two quads match the native verifier and whose in-circuit fold matches
    aggregate_quads, with the documented instance layout.  Mock constraint
    check included under H2A_FULL_MOCK=1."""
    from halo2_aggregation.models.aggregation_circuit import (
        AggregationCircuit,
        fold_quads_host,
    )
    from halo2_aggregation.plonk.prover import create_proof as _cp

    params, vk, proof, pub, inst_comm, efw = inner_proof
    # second, distinct inner proof (re-keygen: the fixture keeps only vk)
    circuit2 = se.MyCircuit(constant=7, a=4, b=5)
    cs_e2, _, asg_e2 = se.build(circuit2.without_witnesses(), k=9)
    _, pk2 = keygen(params, cs_e2, asg_e2)
    _, _, asg2 = se.build(circuit2, k=9)
    pub2 = [circuit2.public_output()]
    proof2 = _cp(params, pk2, asg2, [pub2], seed=77)
    ok2, efw2 = verify_proof(params, vk, [pub2], proof2)
    assert ok2
    inst_comm2 = params.commit_lagrange(pub2)

    # fits k=22 since the GLV/MSM circuit shrink; default-on (was k=24,
    # ~10 min + ~50GB, env-gated)
    outer_k = 22
    circ = AggregationCircuit(vk, [proof, proof2], num_proofs=2)
    public_inputs = circ.public_inputs([inst_comm, inst_comm2], [efw, efw2])
    assert len(public_inputs) == 40 * 2 + 16
    cs, cfg, asg, ctx, (quads, W, RHS) = ac.build(circ, outer_k, public_inputs)
    for q, want in zip(quads, (efw, efw2)):
        got = [q.e.value(), q.f.value(), q.w.value(), q.zw.value()]
        assert got == list(want), "in-circuit quad != native quad"
    W_want, RHS_want = fold_quads_host([efw, efw2])
    assert (W.value(), RHS.value()) == (W_want, RHS_want), "in-circuit fold"
    assert ctx.offset <= cs.usable_rows(1 << outer_k)
    print(f"2-proof circuit rows: {ctx.offset} @ k={outer_k}")

    if os.environ.get("H2A_FULL_MOCK", "1") == "1":
        from halo2_aggregation.plonk.mock import mock_verify_fast

        failures = mock_verify_fast(cs, asg)
        assert failures == [], failures[:5]


@pytest.mark.slow
def test_two_proof_constrained_lambda(inner_proof):
    """VERDICT r2 item 5: in constrained-FS mode the fold challenge lambda
    is SQUEEZED by the in-circuit Poseidon sponge over the strict-reduced
    quad limbs (not witnessed); the gadget lambda equals the host
    aggregate_lambda_poseidon and the fold matches fold_quads_host."""
    from halo2_aggregation.models.aggregation_circuit import (
        AggregationCircuit,
        aggregate_lambda_poseidon,
        fold_quads_host,
    )
    from halo2_aggregation.plonk.prover import create_proof as _cp
    from halo2_aggregation.utils.transcript import (
        PoseidonRead,
        PoseidonWrite,
    )

    params, vk, _proof, pub, inst_comm, _efw = inner_proof
    proofs, comms, efws = [], [], []
    for i, (a, b) in enumerate([(2, 3), (4, 5)]):
        circ_i = se.MyCircuit(constant=7, a=a, b=b)
        cs_e, _, asg_e = se.build(circ_i.without_witnesses(), k=9)
        _, pk_i = keygen(params, cs_e, asg_e)
        _, _, asg_i = se.build(circ_i, k=9)
        pub_i = [circ_i.public_output()]
        proof_i = _cp(
            params, pk_i, asg_i, [pub_i], seed=42 + i,
            transcript_cls=PoseidonWrite,
        )
        ok_i, efw_i = verify_proof(
            params, vk, [pub_i], proof_i, transcript_cls=PoseidonRead
        )
        assert ok_i
        proofs.append(proof_i)
        comms.append(params.commit_lagrange(pub_i))
        efws.append(efw_i)

    outer_k = 22
    circ = AggregationCircuit(vk, proofs, num_proofs=2, constrained_fs=True)
    public_inputs = circ.public_inputs(comms, efws)
    cs, cfg, asg, ctx, (quads, W, RHS) = ac.build(circ, outer_k, public_inputs)
    for q, want in zip(quads, efws):
        got = [q.e.value(), q.f.value(), q.w.value(), q.zw.value()]
        assert got == list(want), "in-circuit quad != native quad"
    # the gadget-squeezed lambda == the host Poseidon lambda
    assert circ.last_lambda.value == aggregate_lambda_poseidon(efws)
    W_want, RHS_want = fold_quads_host(efws, constrained_fs=True)
    assert (W.value(), RHS.value()) == (W_want, RHS_want), "in-circuit fold"
    assert ctx.offset <= cs.usable_rows(1 << outer_k)

    if os.environ.get("H2A_FULL_MOCK", "1") == "1":
        from halo2_aggregation.plonk.mock import mock_verify_fast

        failures = mock_verify_fast(cs, asg)
        assert failures == [], failures[:5]


@pytest.mark.slow
@pytest.mark.skipif(
    os.environ.get("H2A_MULTIPROOF", "1") != "1",
    reason="4-proof synthesis at k=23 (~3 min, ~25GB); default-on in the "
    "slow suite (VERDICT r2 item 6), H2A_MULTIPROOF=0 opts out",
)
def test_four_proof_aggregation_circuit(inner_proof):
    """ROADMAP round-3 item 4: N=4 inner proofs in one outer circuit —
    fits k=23 (the reference's SINGLE-proof k, simple-example.rs:663)
    thanks to the GLV + shared-doubling in-circuit MSMs."""
    from halo2_aggregation.models.aggregation_circuit import (
        AggregationCircuit,
        fold_quads_host,
    )
    from halo2_aggregation.plonk.prover import create_proof as _cp

    params, vk, proof, pub, inst_comm, efw = inner_proof
    proofs, pubs, comms, efws = [proof], [pub], [inst_comm], [efw]
    for i, (a, b) in enumerate([(4, 5), (6, 11), (12, 13)]):
        circ_i = se.MyCircuit(constant=7, a=a, b=b)
        cs_e, _, asg_e = se.build(circ_i.without_witnesses(), k=9)
        _, pk_i = keygen(params, cs_e, asg_e)
        _, _, asg_i = se.build(circ_i, k=9)
        pub_i = [circ_i.public_output()]
        proof_i = _cp(params, pk_i, asg_i, [pub_i], seed=100 + i)
        ok_i, efw_i = verify_proof(params, vk, [pub_i], proof_i)
        assert ok_i
        proofs.append(proof_i)
        pubs.append(pub_i)
        comms.append(params.commit_lagrange(pub_i))
        efws.append(efw_i)

    outer_k = 23
    circ = AggregationCircuit(vk, proofs, num_proofs=4)
    public_inputs = circ.public_inputs(comms, efws)
    assert len(public_inputs) == 40 * 4 + 16
    cs, cfg, asg, ctx, (quads, W, RHS) = ac.build(circ, outer_k, public_inputs)
    for q, want in zip(quads, efws):
        got = [q.e.value(), q.f.value(), q.w.value(), q.zw.value()]
        assert got == list(want), "in-circuit quad != native quad"
    W_want, RHS_want = fold_quads_host(efws)
    assert (W.value(), RHS.value()) == (W_want, RHS_want), "in-circuit fold"
    assert ctx.offset <= cs.usable_rows(1 << outer_k)
    print(f"4-proof circuit rows: {ctx.offset} @ k={outer_k}")


@pytest.mark.slow
@pytest.mark.skipif(
    os.environ.get("H2A_MULTIPROOF8", "1") != "1",
    reason="8-proof synthesis at k=24 (~8 min, ~55GB); DEFAULT-ON in the "
    "slow suite since round 4 (VERDICT r3 weak-4: the deepest N-scaling "
    "point must run in CI); H2A_MULTIPROOF8=0 opts out",
)
def test_eight_proof_aggregation_circuit(inner_proof):
    """VERDICT r2 item 6: scale the outer circuit past N=4.  Eight inner
    proofs in one outer circuit — quads and the lambda-fold must match
    the native verifier; row count recorded for the rows-vs-N table in
    docs/AGGREGATION_SCALING.md (the N=64 north-star extrapolation)."""
    from halo2_aggregation.models.aggregation_circuit import (
        AggregationCircuit,
        fold_quads_host,
    )
    from halo2_aggregation.plonk.prover import create_proof as _cp

    params, vk, proof, pub, inst_comm, efw = inner_proof
    proofs, comms, efws = [proof], [inst_comm], [efw]
    for i, (a, b) in enumerate(
        [(4, 5), (6, 11), (12, 13), (1, 255), (3, 9), (8, 21), (17, 2)]
    ):
        circ_i = se.MyCircuit(constant=7, a=a, b=b)
        cs_e, _, asg_e = se.build(circ_i.without_witnesses(), k=9)
        _, pk_i = keygen(params, cs_e, asg_e)
        _, _, asg_i = se.build(circ_i, k=9)
        pub_i = [circ_i.public_output()]
        proof_i = _cp(params, pk_i, asg_i, [pub_i], seed=200 + i)
        ok_i, efw_i = verify_proof(params, vk, [pub_i], proof_i)
        assert ok_i
        proofs.append(proof_i)
        comms.append(params.commit_lagrange(pub_i))
        efws.append(efw_i)

    outer_k = 24
    circ = AggregationCircuit(vk, proofs, num_proofs=8)
    public_inputs = circ.public_inputs(comms, efws)
    assert len(public_inputs) == 40 * 8 + 16
    cs, cfg, asg, ctx, (quads, W, RHS) = ac.build(circ, outer_k, public_inputs)
    for q, want in zip(quads, efws):
        got = [q.e.value(), q.f.value(), q.w.value(), q.zw.value()]
        assert got == list(want), "in-circuit quad != native quad"
    W_want, RHS_want = fold_quads_host(efws)
    assert (W.value(), RHS.value()) == (W_want, RHS_want), "in-circuit fold"
    assert ctx.offset <= cs.usable_rows(1 << outer_k)
    print(f"8-proof circuit rows: {ctx.offset} @ k={outer_k}")


@pytest.mark.slow
def test_constrained_fs_quad_matches(inner_proof):
    """The CONSTRAINED Fiat-Shamir verifier (Poseidon transcript computed
    in-circuit — our soundness upgrade over transcript.rs:62-65): the
    gadget-derived challenges drive the full verifier and reproduce the
    native PoseidonRead verifier's quad bit-exactly."""
    from halo2_aggregation.plonk.keygen import keygen as _kg
    from halo2_aggregation.plonk.prover import create_proof as _cp
    from halo2_aggregation.utils.transcript import (
        PoseidonRead,
        PoseidonWrite,
    )

    params, vk, _proof, pub, inst_comm, _efw = inner_proof
    circuit = se.MyCircuit(constant=7, a=2, b=3)
    cs_e, _, asg_e = se.build(circuit.without_witnesses(), k=9)
    _, pk = _kg(params, cs_e, asg_e)
    _, _, asg_i = se.build(circuit, k=9)
    proof_p = _cp(params, pk, asg_i, [pub], seed=42, transcript_cls=PoseidonWrite)
    ok, efw_p = verify_proof(
        params, vk, [pub], proof_p, transcript_cls=PoseidonRead
    )
    assert ok

    outer_k = 21
    circ = ac.SingleProofCircuit(vk, proof_p, constrained_fs=True)
    public_inputs = circ.public_inputs(inst_comm, efw_p)
    cs, cfg, asg, ctx, quad = ac.build(circ, outer_k, public_inputs)
    got = [quad.e.value(), quad.f.value(), quad.w.value(), quad.zw.value()]
    assert got == list(efw_p), "constrained-FS in-circuit quad != native"
    assert ctx.offset <= cs.usable_rows(1 << outer_k)

    if os.environ.get("H2A_FULL_MOCK", "1") == "1":
        from halo2_aggregation.plonk.mock import mock_verify_fast

        failures = mock_verify_fast(cs, asg)
        assert failures == [], failures[:5]
