"""RNS IntegerChip (non-native Fq in Fr circuit) vs oracle arithmetic."""

import numpy as np
import pytest

from halo2_aggregation.fields import Q
from halo2_aggregation.aggregation.gadgets.integer import IntegerChip
from halo2_aggregation.aggregation.gadgets.main_gate import Ctx, MainGate
from halo2_aggregation.aggregation.gadgets.range_chip import RangeChip
from halo2_aggregation.plonk.circuit import Assignment, ConstraintSystem
from halo2_aggregation.plonk.mock import mock_verify_fast

RNG = np.random.default_rng(5)
K = 18


def build(k=K):
    cs = ConstraintSystem()
    mg_cfg = MainGate.configure(cs)
    mg = MainGate(mg_cfg)
    rc_cfg = RangeChip.configure(cs, mg_cfg)
    rc = RangeChip(mg, rc_cfg)
    ic = IntegerChip(mg, rc)
    asg = Assignment(cs, 1 << k)
    rc.load_table(asg)
    return cs, mg, rc, ic, asg, Ctx(asg)


def rand_fq():
    return int.from_bytes(RNG.bytes(40), "little") % Q


@pytest.mark.slow
def test_integer_ops_vs_oracle():
    cs, mg, rc, ic, asg, ctx = build()
    a_v, b_v = rand_fq(), rand_fq()
    a = ic.assign_integer(ctx, a_v)
    b = ic.assign_integer(ctx, b_v)
    assert a.value() == a_v

    s = ic.add(ctx, a, b)
    assert s.value() % Q == (a_v + b_v) % Q
    d = ic.sub(ctx, a, b)
    assert d.value() % Q == (a_v - b_v) % Q
    p = ic.mul(ctx, a, b)
    assert p.value() % Q == a_v * b_v % Q
    q = ic.div(ctx, p, b)
    assert q.value() % Q == a_v % Q
    inv = ic.invert(ctx, a)
    assert inv.value() % Q == pow(a_v, -1, Q)
    n = ic.neg(ctx, a)
    assert n.value() % Q == (-a_v) % Q
    # chains: (a+b)*(a-b) == a^2 - b^2
    lhs = ic.mul(ctx, s, d)
    a2 = ic.square(ctx, a)
    b2 = ic.square(ctx, b)
    rhs = ic.sub(ctx, a2, b2)
    ic.assert_equal(ctx, lhs, rhs)
    ic.assert_equal_to_constant(ctx, ic.sub(ctx, a, a), 0)

    failures = mock_verify_fast(cs, asg)
    assert failures == [], failures[:5]
    print("rows used:", ctx.offset)


@pytest.mark.slow
def test_integer_mul_soundness():
    cs, mg, rc, ic, asg, ctx = build()
    a_v, b_v = rand_fq(), rand_fq()
    a = ic.assign_integer(ctx, a_v)
    b = ic.assign_integer(ctx, b_v)
    p = ic.mul(ctx, a, b)
    # corrupt the result's limb 0 witness (and its copies along wire chain)
    bad_col = p.limbs[0].column.index
    bad_row = p.limbs[0].row
    orig = asg.advice[bad_col][bad_row]
    asg.advice[bad_col][bad_row] = (orig + 1) % Q
    failures = mock_verify_fast(cs, asg)
    assert failures, "corrupted mul result must violate constraints"


@pytest.mark.slow
def test_reduce_strict_rejects_noncanonical():
    cs, mg, rc, ic, asg, ctx = build()
    a = ic.assign_integer(ctx, Q - 1)
    z = ic.reduce_strict(ctx, a)
    assert z.value() == Q - 1
    assert mock_verify_fast(cs, asg) == []
