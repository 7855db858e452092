"""Native scaled prover vs the pure-int reference prover: byte equality.

The pure-Python prover (plonk/prover.py) is the readable byte-exactness
spec; create_proof_native must emit the identical transcript for the same
(circuit, srs, seed).  This pins every engine op (NTT, grand products,
coset quotient, folds) at once.
"""

import numpy as np
import pytest

from halo2_aggregation.models import simple_example as se
from halo2_aggregation.plonk import kzg
from halo2_aggregation.plonk.keygen import keygen
from halo2_aggregation.plonk.prover import create_proof
from halo2_aggregation.plonk.verifier import verify_proof
from halo2_aggregation.utils import native



def test_native_prover_byte_parity():
    from halo2_aggregation.plonk.prover_native import create_proof_native

    k = 9
    params = kzg.setup(k)
    circuit = se.MyCircuit(constant=7, a=2, b=3)
    cs_e, _, asg_e = se.build(circuit.without_witnesses(), k=k)
    vk, pk = keygen(params, cs_e, asg_e)
    pub = [circuit.public_output()]

    _, _, asg1 = se.build(circuit, k=k)
    ref = create_proof(params, pk, asg1, [pub], seed=42)
    _, _, asg2 = se.build(circuit, k=k)
    got = create_proof_native(params, pk, asg2, [pub], seed=42)
    assert got == ref, "native prover diverged from the reference prover"

    ok, _ = verify_proof(params, vk, [pub], got)
    assert ok


def test_device_quotient_byte_parity(monkeypatch):
    """H2A_DEVICE_QUOTIENT routes the per-coset quotient through the JAX
    pass (plonk/quotient_device.py); the proof bytes must be identical to
    the host C++ coset loop — this pins the device coset NTT, the packed
    leaf plumbing, and the LimbOps expression evaluation at once."""
    from halo2_aggregation.plonk.prover_native import create_proof_native

    k = 9
    params = kzg.setup(k)
    circuit = se.MyCircuit(constant=7, a=2, b=3)
    cs_e, _, asg_e = se.build(circuit.without_witnesses(), k=k)
    vk, pk = keygen(params, cs_e, asg_e)
    pub = [circuit.public_output()]

    _, _, asg1 = se.build(circuit, k=k)
    ref = create_proof_native(params, pk, asg1, [pub], seed=42)
    _, _, asg2 = se.build(circuit, k=k)
    monkeypatch.setenv("H2A_DEVICE_QUOTIENT", "1")
    got = create_proof_native(params, pk, asg2, [pub], seed=42)
    assert got == ref, "device quotient diverged from the host coset loop"

    ok, _ = verify_proof(params, vk, [pub], got)
    assert ok


def test_keygen_native_matches_keygen():
    from halo2_aggregation.plonk.keygen import keygen_native
    from halo2_aggregation.plonk.engine import col_to_ints
    from halo2_aggregation.plonk.prover_native import create_proof_native

    k = 9
    params = kzg.setup(k)
    circuit = se.MyCircuit(constant=7, a=2, b=3)
    cs_e, _, asg_e = se.build(circuit.without_witnesses(), k=k)
    vk, pk = keygen(params, cs_e, asg_e)
    cs_n, _, asg_n = se.build(circuit.without_witnesses(), k=k)
    vk2, pk2 = keygen_native(params, cs_n, asg_n)
    assert vk2.fixed_commitments == vk.fixed_commitments
    assert vk2.sigma_commitments == vk.sigma_commitments
    assert vk2.hash_scalar() == vk.hash_scalar()
    for a, b in zip(pk2.sigma_columns, pk.sigma_columns):
        assert col_to_ints(a) == b

    # full native pipeline proof == classic pipeline proof
    pub = [circuit.public_output()]
    _, _, asg1 = se.build(circuit, k=k)
    ref = create_proof(params, pk, asg1, [pub], seed=42)
    _, _, asg2 = se.build(circuit, k=k)
    got = create_proof_native(params, pk2, asg2, [pub], seed=42)
    assert got == ref
