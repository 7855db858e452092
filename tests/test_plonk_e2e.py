"""End-to-end: mock-verify, keygen, prove, native-verify the simple-example
circuit — BASELINE config 1 ("verify one simple-example halo2 proof")."""

import pytest

from halo2_aggregation.models import simple_example as se
from halo2_aggregation.plonk import kzg
from halo2_aggregation.plonk.keygen import keygen
from halo2_aggregation.plonk.mock import mock_verify
from halo2_aggregation.plonk.prover import create_proof
from halo2_aggregation.plonk.verifier import verify_proof

K = 6  # smallest domain with room for the u8 table would be 9; see below


def test_mock_simple_example():
    circuit = se.MyCircuit(constant=7, a=2, b=3)
    cs, cfg, asg = se.build(circuit, k=9)
    failures = mock_verify(cs, asg)
    assert failures == []


def test_mock_catches_bad_witness():
    circuit = se.MyCircuit(constant=7, a=2, b=3)
    cs, cfg, asg = se.build(circuit, k=9)
    # corrupt the multiplication output
    asg.advice[0][4] = 11
    failures = mock_verify(cs, asg)
    assert failures  # gate + copy violations


@pytest.mark.slow
def test_prove_and_verify():
    k = 9
    circuit = se.MyCircuit(constant=7, a=2, b=3)
    params = kzg.setup(k)

    cs_empty, cfg_e, asg_empty = se.build(circuit.without_witnesses(), k=k)
    vk, pk = keygen(params, cs_empty, asg_empty)

    cs, cfg, asg = se.build(circuit, k=k)
    public_inputs = [circuit.public_output()]
    proof = create_proof(params, pk, asg, [public_inputs], seed=42)

    ok, efw = verify_proof(params, vk, [public_inputs], proof)
    assert ok
    e, f, w, zw = efw
    assert all(p is not None for p in (e, f, w, zw))

    # a wrong public input must fail
    ok_bad, _ = verify_proof(params, vk, [[253]], proof)
    assert not ok_bad
