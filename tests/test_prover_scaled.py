"""Mid-scale native pipeline integration: k=18 circuit with the real
2^17 range table, proved end-to-end through keygen_native +
create_proof_native and verified by the host verifier.

This is the scaled dress rehearsal for Phase D (the k=23 outer
aggregation proof, examples/simple-example.rs:678-730),
exercising lookups, chunked permutation, quotient cosets, and multiopen
at a size where the pure-int prover is already infeasible.
"""

import numpy as np
import pytest

from halo2_aggregation.aggregation.gadgets.main_gate import (
    Ctx,
    MainGate,
    Term,
)
from halo2_aggregation.aggregation.gadgets.range_chip import RangeChip
from halo2_aggregation.fields import R
from halo2_aggregation.plonk import kzg
from halo2_aggregation.plonk.circuit import Assignment, ConstraintSystem
from halo2_aggregation.plonk.keygen import keygen_native
from halo2_aggregation.plonk.prover_native import create_proof_native
from halo2_aggregation.plonk.verifier import verify_proof
from halo2_aggregation.utils import native



def build_circuit(k, with_witness: bool, num_checks=512):
    """Range-check a chain of values and expose the running sum."""
    cs = ConstraintSystem()
    inst = cs.instance_column()
    cs.enable_equality(inst)
    mg_cfg = MainGate.configure(cs)
    mg = MainGate(mg_cfg)
    rc_cfg = RangeChip.configure(cs, mg_cfg)
    rc = RangeChip(mg, rc_cfg)
    asg = Assignment(cs, 1 << k)
    ctx = Ctx(asg)
    rc.load_table(asg)
    rng = np.random.default_rng(3)
    total = 0
    acc = mg.assign_constant(ctx, 0)
    for i in range(num_checks):
        bits = [17, 51, 68, 5, 52][i % 5]
        v = int(rng.integers(0, 1 << min(bits, 62)))
        total = (total + v) % R
        cell = rc.range_check(ctx, v if with_witness else None, bits)
        acc_v = None if not with_witness else total
        new_acc = mg.combine(
            ctx,
            [
                Term.from_assigned(acc, 1),
                Term.from_assigned(cell, 1),
                Term.unassigned(acc_v, R - 1),
            ],
        )[2]
        acc = new_acc
    mg.expose_public(ctx, acc, inst, 0)
    return cs, asg, total


@pytest.mark.slow
def test_scaled_pipeline_k18():
    k = 18
    params = kzg.setup(k)
    cs_e, asg_e, _ = build_circuit(k, with_witness=False)
    vk, pk = keygen_native(params, cs_e, asg_e)
    cs_w, asg_w, total = build_circuit(k, with_witness=True)
    proof = create_proof_native(params, pk, asg_w, [[total]], seed=7)
    ok, efw = verify_proof(params, vk, [[total]], proof)
    assert ok
    # wrong public input rejected
    ok2, _ = verify_proof(params, vk, [[(total + 1) % R]], proof)
    assert not ok2
