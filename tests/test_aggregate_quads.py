"""Quad folding: N deferred pairings -> one (the accumulator semantics)."""

import pytest

from halo2_aggregation.models import simple_example as se
from halo2_aggregation.plonk import kzg
from halo2_aggregation.plonk.keygen import keygen
from halo2_aggregation.plonk.prover import create_proof
from halo2_aggregation.plonk.verifier import verify_proof
from halo2_aggregation.plonk.device_verifier import check_aggregate


@pytest.mark.slow
def test_aggregate_pairing_fold():
    k = 9
    params = kzg.setup(k)
    circuit = se.MyCircuit(constant=7, a=2, b=3)
    cs_e, _, asg_e = se.build(circuit.without_witnesses(), k=k)
    vk, pk = keygen(params, cs_e, asg_e)
    quads = []
    for a, b in [(2, 3), (4, 5)]:
        c = se.MyCircuit(constant=7, a=a, b=b)
        _, _, asg = se.build(c, k=k)
        pub = [c.public_output()]
        proof = create_proof(params, pk, asg, [pub], seed=50 + a)
        ok, efw = verify_proof(params, vk, [pub], proof)
        assert ok
        quads.append(efw)
    # folded: one pairing for both proofs
    assert check_aggregate(quads, params)
    # corrupt one quad -> the aggregate fails
    from halo2_aggregation.oracle import curve as oc

    bad = list(quads)
    e, f, w, zw = bad[1]
    bad[1] = (e, f, oc.g1_double(w), zw)
    assert not check_aggregate(bad, params)
