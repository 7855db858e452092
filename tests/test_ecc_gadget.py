"""In-circuit EC gadget vs the oracle group law."""

import numpy as np
import pytest

from halo2_aggregation.aggregation.gadgets.ecc import EccChip
from halo2_aggregation.aggregation.gadgets.integer import IntegerChip
from halo2_aggregation.aggregation.gadgets.main_gate import Ctx, MainGate
from halo2_aggregation.aggregation.gadgets.range_chip import RangeChip
from halo2_aggregation.oracle import curve as oc
from halo2_aggregation.plonk.circuit import Assignment, ConstraintSystem
from halo2_aggregation.plonk.mock import mock_verify_fast

RNG = np.random.default_rng(21)


def build(k=18):
    cs = ConstraintSystem()
    mg_cfg = MainGate.configure(cs)
    mg = MainGate(mg_cfg)
    rc_cfg = RangeChip.configure(cs, mg_cfg)
    rc = RangeChip(mg, rc_cfg)
    ic = IntegerChip(mg, rc)
    ec = EccChip(ic)
    asg = Assignment(cs, 1 << k)
    rc.load_table(asg)
    return cs, mg, ec, asg, Ctx(asg)


def rand_point():
    return oc.g1_mul(oc.g1_generator(), int(RNG.integers(2, 1 << 60)))


@pytest.mark.slow
def test_ecc_add_double_neg():
    cs, mg, ec, asg, ctx = build()
    pv, qv = rand_point(), rand_point()
    p = ec.assign_point(ctx, pv)
    q = ec.assign_point(ctx, qv)
    s = ec.add_incomplete(ctx, p, q)
    assert s.value() == oc.g1_add(pv, qv)
    d = ec.double(ctx, p)
    assert d.value() == oc.g1_double(pv)
    n = ec.neg(ctx, p)
    assert n.value() == oc.g1_neg(pv)
    # select
    b1 = mg.assign_bit(ctx, 1)
    b0 = mg.assign_bit(ctx, 0)
    assert ec.select(ctx, b1, p, q).value() == pv
    assert ec.select(ctx, b0, p, q).value() == qv
    # assert_equal on equal points
    p2 = ec.assign_point(ctx, pv)
    ec.assert_equal(ctx, p, p2)
    failures = mock_verify_fast(cs, asg)
    assert failures == [], failures[:5]
    print("rows:", ctx.offset)


@pytest.mark.slow
def test_ecc_mul_var_small():
    cs, mg, ec, asg, ctx = build()
    pv = rand_point()
    p = ec.assign_point(ctx, pv)
    k = int(RNG.integers(1, 1 << 16))
    s = mg.assign_value(ctx, k)
    res = ec.mul_var(ctx, p, s, nbits=16)
    assert res.value() == oc.g1_mul(pv, k)
    failures = mock_verify_fast(cs, asg)
    assert failures == [], failures[:5]
    print("rows for 16-bit mul_var:", ctx.offset)


@pytest.mark.slow
def test_ecc_forged_add_fails():
    cs, mg, ec, asg, ctx = build()
    pv, qv = rand_point(), rand_point()
    p = ec.assign_point(ctx, pv)
    q = ec.assign_point(ctx, qv)
    s = ec.add_incomplete(ctx, p, q)
    # corrupt one limb of the result x-coordinate
    cell = s.x.limbs[0]
    asg.advice[cell.column.index][cell.row] = (asg.advice[cell.column.index][cell.row] + 1)
    assert mock_verify_fast(cs, asg)
