"""Reference-compatible API surface (api.py) smoke test."""

import pytest

from halo2_aggregation import api
from halo2_aggregation.models import simple_example as se


@pytest.mark.slow
def test_reference_style_flow():
    k = 9
    params = api.Setup.new(k)
    params_verifier = api.Setup.verifier_params(params, 1)

    circuit = se.MyCircuit(constant=7, a=2, b=3)
    cs_e, _, asg_e = se.build(circuit.without_witnesses(), k=k)
    vk = api.keygen_vk(params, cs_e, asg_e)
    pk = api.keygen_pk(params, cs_e, asg_e)

    cs, _, asg = se.build(circuit, k=k)
    assert api.MockProver.run(k, cs, asg).verify() is None

    pub = [circuit.public_output()]
    proof = api.create_proof(params, pk, asg, [pub], seed=7)
    choice, efw = api.verify_proof(params_verifier, vk, [pub], proof)
    assert choice
    assert len(efw) == 4
