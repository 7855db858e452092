"""Aggregation gadget tests: main gate, range chip (mock-verified)."""

import numpy as np
import pytest

from halo2_aggregation.fields import R
from halo2_aggregation.aggregation.gadgets.main_gate import (
    Ctx,
    MainGate,
    Term,
)
from halo2_aggregation.aggregation.gadgets.range_chip import (
    LOOKUP_BITS,
    RangeChip,
)
from halo2_aggregation.plonk.circuit import Assignment, ConstraintSystem
from halo2_aggregation.plonk.mock import mock_verify_fast

RNG = np.random.default_rng(11)


def build_main_gate(k=10, with_range=False):
    cs = ConstraintSystem()
    mg_cfg = MainGate.configure(cs)
    mg = MainGate(mg_cfg)
    rc = None
    if with_range:
        rc_cfg = RangeChip.configure(cs, mg_cfg)
        rc = RangeChip(mg, rc_cfg)
    asg = Assignment(cs, 1 << k)
    ctx = Ctx(asg)
    return cs, mg, rc, asg, ctx


def test_main_gate_ops():
    cs, mg, _, asg, ctx = build_main_gate()
    x = mg.assign_value(ctx, 41)
    y = mg.assign_constant(ctx, 17)
    s = mg.add(ctx, x, y)
    assert s.value == 58
    d = mg.sub(ctx, x, y)
    assert d.value == 24
    p = mg.mul(ctx, x, y)
    assert p.value == 41 * 17
    q = mg.div(ctx, p, y)
    assert q.value == 41
    n = mg.neg(ctx, x)
    assert n.value == (R - 41) % R
    c5 = mg.mul_by_constant(ctx, x, 5)
    assert c5.value == 205
    b = mg.assign_bit(ctx, 1)
    mg.assert_equal_to_constant(ctx, s, 58)
    assert mock_verify_fast(cs, asg) == []


def test_main_gate_catches_violation():
    cs, mg, _, asg, ctx = build_main_gate()
    x = mg.assign_value(ctx, 4)
    mg.assert_equal_to_constant(ctx, x, 5)
    assert mock_verify_fast(cs, asg)


def test_main_gate_bad_bit():
    cs, mg, _, asg, ctx = build_main_gate()
    # forge a non-bit by manipulating the witness directly
    b = mg.assign_bit(ctx, 1)
    asg.advice[b.column.index][b.row] = 2
    # also the copied b-wire
    asg.advice[mg.config.wires[1].index][b.row] = 2
    assert mock_verify_fast(cs, asg)


@pytest.mark.slow
def test_range_check():
    k = 18  # table 2^17 needs this
    cs, mg, rc, asg, ctx = build_main_gate(k, with_range=True)
    rc.load_table(asg)
    vals_bits = [
        (0, 17),
        ((1 << 17) - 1, 17),
        (1234567, 21),
        ((1 << 68) - 1, 68),
        (17, 5),
        ((1 << 5) - 1, 5),
    ]
    cells = []
    for v, bits in vals_bits:
        cells.append(rc.range_check(ctx, v, bits))
    assert [c.value for c in cells] == [v for v, _ in vals_bits]
    assert mock_verify_fast(cs, asg) == []

    # out-of-range: 2^5 must fail a 5-bit check
    cs2, mg2, rc2, asg2, ctx2 = build_main_gate(k, with_range=True)
    rc2.load_table(asg2)
    # bypass the assertion by forging chunks manually: claim 32 fits 5 bits
    try:
        rc2.range_check(ctx2, 1 << 5, 5)
        assert False, "should have raised"
    except AssertionError:
        pass


@pytest.mark.slow
def test_range_check_partial_chunk_widths():
    # widths used by IntegerChip carries / top limbs (51, 52, 69) all have
    # partial top chunks — honest witnesses must pass with the fixed scheme
    k = 18
    cs, mg, rc, asg, ctx = build_main_gate(k, with_range=True)
    rc.load_table(asg)
    vals_bits = [
        ((1 << 51) - 1, 51),
        ((1 << 52) - 1, 52),
        ((1 << 69) - 1, 69),
        (0, 51),
    ]
    cells = [rc.range_check(ctx, v, bits) for v, bits in vals_bits]
    assert [c.value for c in cells] == [v for v, _ in vals_bits]
    assert mock_verify_fast(cs, asg) == []


@pytest.mark.slow
def test_range_check_malicious_partial_chunk():
    """ADVICE.md round-1 high finding: the old scaling trick admitted any
    field element into range_check(_, bits) for bits % 17 != 0 because the
    scaled chunk sv was never constrained to be a multiple of 2^(17-rem).
    Replay that forged witness against the fixed constraint pattern and
    assert the mock prover rejects it (the raw chunk cv is now looked up)."""
    k = 18
    for bits in (5, 52):
        cs, mg, rc, asg, ctx = build_main_gate(k, with_range=True)
        rc.load_table(asg)
        rem = bits % LOOKUP_BITS
        nfull = bits // LOOKUP_BITS
        scale = 1 << (LOOKUP_BITS - rem)
        sv = 3  # < 2^17 but NOT a multiple of scale
        assert sv % scale != 0
        cv = sv * pow(scale, -1, R) % R  # ~254-bit field element
        # cheating prover emits the chip's exact row pattern:
        srow = mg.combine(
            ctx, [Term.unassigned(sv, 1), Term.unassigned(cv, R - scale)]
        )
        asg.assign_fixed(rc.config.q_range, srow[0].row, 1)
        terms = [
            Term.unassigned(0, 1 << (LOOKUP_BITS * i)) for i in range(nfull)
        ]
        terms.append(Term.from_assigned(srow[1], 1 << (LOOKUP_BITS * nfull)))
        while len(terms) < 4:
            terms.append(Term.zero())
        claimed = cv * (1 << (LOOKUP_BITS * nfull)) % R
        terms.append(Term.unassigned(claimed, R - 1))
        cells = mg.combine(ctx, terms)
        asg.assign_fixed(rc.config.q_range, cells[0].row, 1)
        # every main-gate row is satisfied mod r; only the cv lookup can
        # (and must) catch the forgery
        failures = mock_verify_fast(cs, asg)
        assert failures, f"forged witness for bits={bits} must be rejected"
