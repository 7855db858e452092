"""Regenerate tests/fixtures/simple_example_k9.json.

Byte-level pinned fixtures (VERDICT r1 item 5): the reference's two
private Rust forks are unreachable (zero-egress environment, no Rust
toolchain), so true cross-implementation bytes cannot be produced here;
docs/PARITY.md#fixtures records the exact delta.  These fixtures freeze
OUR transcript bytes, challenges, vk-hash input and quad so any future
change to the Fiat-Shamir schedule, serialization, or verifier algebra
fails tests/test_fixture_parity.py loudly instead of silently drifting.

Run:  python tests/gen_fixtures.py    (writes the JSON in place)
"""

import json
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

FIXTURE = os.path.join(
    os.path.dirname(os.path.abspath(__file__)),
    "fixtures",
    "simple_example_k9.json",
)


def build():
    import jax

    jax.config.update("jax_platforms", "cpu")

    from halo2_aggregation.models import simple_example as se
    from halo2_aggregation.plonk import kzg
    from halo2_aggregation.plonk.keygen import keygen
    from halo2_aggregation.plonk.prover import create_proof
    from halo2_aggregation.plonk.verifier import parse_proof, verify_proof

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
    inst_comms = [params.commit_lagrange(pub)]
    p = parse_proof(vk, inst_comms, proof)
    return {
        "k": k,
        "public_input": [str(v) for v in pub],
        "proof_hex": proof.hex(),
        "vk_pinned": vk.pinned(),
        "vk_hash_scalar": str(vk.hash_scalar()),
        "challenges": {
            name: str(getattr(p, name))
            for name in ("theta", "beta", "gamma", "y", "x", "v", "u")
        },
        "quad": [[str(c) for c in pt] for pt in efw],
        "inst_comm": [str(c) for c in inst_comms[0]],
    }


if __name__ == "__main__":
    data = build()
    os.makedirs(os.path.dirname(FIXTURE), exist_ok=True)
    with open(FIXTURE, "w") as f:
        json.dump(data, f, indent=1)
    print(f"wrote {FIXTURE} ({os.path.getsize(FIXTURE)} bytes)")
