"""Oracle sanity: BN254 group law + pairing bilinearity.

These pin the CPU oracle that every device op is diffed against, and that
performs the deferred pairing check (SURVEY.md §3.3: the reference also
defers `e(w,[tau]_2) == e(zw+f+e,[1]_2)` outside the circuit).
"""

import pytest

from halo2_aggregation.fields import Q, R, G1_GEN
from halo2_aggregation.oracle import curve as oc
from halo2_aggregation.oracle import pairing as op


def test_g1_group_law():
    g = oc.g1_generator()
    assert oc.g1_is_on_curve(g)
    g2 = oc.g1_double(g)
    assert oc.g1_is_on_curve(g2)
    g3a = oc.g1_add(g2, g)
    g3b = oc.g1_mul(g, 3)
    assert g3a == g3b
    # order
    assert oc.g1_mul(g, R) is None
    assert oc.g1_add(g, oc.g1_neg(g)) is None


def test_g2_on_twist():
    x, y = oc.g2_generator()
    # y^2 = x^3 + 3/(9+u)
    lhs = oc.fq2_mul(y, y)
    x3 = oc.fq2_mul(oc.fq2_mul(x, x), x)
    b2 = oc.fq2_mul((3, 0), oc.fq2_inv((9, 1)))
    rhs = oc.fq2_add(x3, b2)
    assert lhs == rhs
    # order r
    assert oc.g2_mul(oc.g2_generator(), R) is None


@pytest.mark.slow
def test_pairing_bilinearity():
    g1 = oc.g1_generator()
    g2 = oc.g2_generator()
    a, b = 5, 7
    e_ab = op.pairing(oc.g1_mul(g1, a), oc.g2_mul(g2, b))
    e_base = op.pairing(g1, g2)
    assert e_ab == op.fq12_pow(e_base, a * b)
    assert e_base != op.FQ12_ONE


@pytest.mark.slow
def test_multi_pairing_check():
    g1 = oc.g1_generator()
    g2 = oc.g2_generator()
    # e(aG1, bG2) * e(-abG1, G2) == 1
    pairs = [
        (oc.g1_mul(g1, 6), oc.g2_mul(g2, 11)),
        (oc.g1_neg(oc.g1_mul(g1, 66)), g2),
    ]
    assert op.multi_pairing_check(pairs)
    pairs_bad = [
        (oc.g1_mul(g1, 6), oc.g2_mul(g2, 11)),
        (oc.g1_neg(oc.g1_mul(g1, 65)), g2),
    ]
    assert not op.multi_pairing_check(pairs_bad)
