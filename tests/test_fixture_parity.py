"""Byte-level pinned-fixture parity (VERDICT r1 item 5).

True Rust-fixture cross-validation is impossible in this environment
(private forks, zero egress, no Rust toolchain — delta documented in
docs/PARITY.md#fixtures).  Instead the checked-in fixture freezes our
transcript bytes, Fiat-Shamir challenges, vk-pinned string + hash, and
final quad for the canonical k=9 simple-example proof: ANY divergence in
serialization, squeeze order, vk hashing, or verifier algebra breaks this
test — regressions cannot drift silently between rounds."""

import json
import os

import pytest

from halo2_aggregation.models import simple_example as se
from halo2_aggregation.plonk import kzg
from halo2_aggregation.plonk.keygen import keygen
from halo2_aggregation.plonk.prover import create_proof
from halo2_aggregation.plonk.verifier import parse_proof, verify_proof

FIXTURE = os.path.join(
    os.path.dirname(os.path.abspath(__file__)), "fixtures", "simple_example_k9.json"
)


@pytest.fixture(scope="module")
def fx():
    with open(FIXTURE) as f:
        return json.load(f)


@pytest.fixture(scope="module")
def built(fx):
    k = fx["k"]
    params = kzg.setup(k)
    circuit = se.MyCircuit(constant=7, a=2, b=3)
    cs_e, _, asg_e = se.build(circuit.without_witnesses(), k=k)
    vk, pk = keygen(params, cs_e, asg_e)
    _, _, asg = se.build(circuit, k=k)
    pub = [circuit.public_output()]
    proof = create_proof(params, pk, asg, [pub], seed=42)
    return params, vk, pub, proof


def test_proof_bytes_pinned(fx, built):
    _, _, _, proof = built
    assert proof.hex() == fx["proof_hex"], (
        "prover transcript bytes diverged from the pinned fixture"
    )


def test_vk_pinned_string_and_hash(fx, built):
    _, vk, _, _ = built
    assert vk.pinned() == fx["vk_pinned"]
    assert str(vk.hash_scalar()) == fx["vk_hash_scalar"]


def test_challenges_and_quad_pinned(fx, built):
    params, vk, pub, _ = built
    # drive the verifier from the FIXTURE's bytes (not the fresh proof):
    # catches decode-side drift independently of the prover
    proof = bytes.fromhex(fx["proof_hex"])
    inst_comms = [params.commit_lagrange([int(v) for v in fx["public_input"]])]
    assert [str(c) for c in inst_comms[0]] == fx["inst_comm"]
    p = parse_proof(vk, inst_comms, proof)
    for name, want in fx["challenges"].items():
        assert str(getattr(p, name)) == want, f"challenge {name} diverged"
    ok, efw = verify_proof(params, vk, [pub], proof)
    assert ok
    assert [[str(c) for c in pt] for pt in efw] == fx["quad"]
