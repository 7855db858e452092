"""Poseidon: host permutation/sponge vs the constrained gadget."""

import pytest

from halo2_aggregation.fields import R
from halo2_aggregation.oracle.poseidon import PoseidonSponge, permute
from halo2_aggregation.aggregation.gadgets.main_gate import Ctx, MainGate
from halo2_aggregation.aggregation.gadgets.poseidon import (
    PoseidonGadget,
    PoseidonSpongeChip,
)
from halo2_aggregation.plonk.circuit import Assignment, ConstraintSystem
from halo2_aggregation.plonk.mock import mock_verify_fast


def _mk(k=13):
    cs = ConstraintSystem()
    cfg = MainGate.configure(cs)
    mg = MainGate(cfg)
    asg = Assignment(cs, 1 << k)
    return cs, mg, asg, Ctx(asg)


def test_gadget_permutation_matches_oracle_and_constraints_hold():
    cs, mg, asg, ctx = _mk()
    vals = [3, 5, 7]
    state = [mg.assign_value(ctx, v) for v in vals]
    out = PoseidonGadget(mg).permute(ctx, state)
    want = permute(vals)
    assert [o.value for o in out] == want
    assert mock_verify_fast(cs, asg) == []


def test_sponge_chip_matches_host_sponge():
    cs, mg, asg, ctx = _mk()
    chip = PoseidonSpongeChip(mg, ctx)
    host = PoseidonSponge()
    vals = [11, 22, 33, 44, 55]  # odd count exercises partial-block pad
    for v in vals:
        chip.absorb(mg.assign_value(ctx, v))
        host.absorb(v)
    c1 = chip.squeeze(ctx)
    h1 = host.squeeze()
    assert c1.value == h1
    # absorb again after squeeze (duplex reuse)
    chip.absorb(mg.assign_value(ctx, 99))
    host.absorb(99)
    assert chip.squeeze(ctx).value == host.squeeze()
    assert mock_verify_fast(cs, asg) == []


def test_keygen_shape_matches_witness_shape():
    """None-valued synthesis must lay down identical rows."""
    cs1, mg1, asg1, ctx1 = _mk()
    chip = PoseidonSpongeChip(mg1, ctx1)
    chip.absorb(mg1.assign_value(ctx1, 5))
    chip.squeeze(ctx1)
    cs2, mg2, asg2, ctx2 = _mk()
    chip2 = PoseidonSpongeChip(mg2, ctx2)
    chip2.absorb(mg2.assign_value(ctx2, None))
    out = chip2.squeeze(ctx2)
    assert out.value is None
    assert ctx1.offset == ctx2.offset


def test_malicious_challenge_fails_constraints():
    """Tampering with the squeezed cell's value must break a gate row —
    the whole point of the constrained transcript."""
    cs, mg, asg, ctx = _mk()
    chip = PoseidonSpongeChip(mg, ctx)
    chip.absorb(mg.assign_value(ctx, 5))
    out = chip.squeeze(ctx)
    # overwrite the witness of the squeezed cell
    asg.advice[out.column.index][out.row] = (out.value + 1) % R
    assert mock_verify_fast(cs, asg) != []
