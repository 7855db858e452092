"""Native C++ Fr engine vs the Python-int oracle (no JAX needed)."""

import numpy as np
import pytest

from halo2_aggregation.fields import R, fr_omega
from halo2_aggregation.oracle import curve as oc
from halo2_aggregation.oracle import poly as opoly
from halo2_aggregation.plonk import engine
from halo2_aggregation.utils import native
from halo2_aggregation.utils.u64 import ints_to_u64, u64_to_points


RNG = np.random.default_rng(7)


def rand_fr(n):
    return [int.from_bytes(RNG.bytes(40), "little") % R for _ in range(n)]


def test_mont_roundtrip_and_binops():
    xs = rand_fr(257)
    ys = rand_fr(257)
    xm = engine.to_mont(engine.col_from_ints(xs))
    ym = engine.to_mont(engine.col_from_ints(ys))
    ops = engine.NativeVecOps()
    assert engine.col_to_ints(engine.from_mont(xm)) == xs
    add = engine.col_to_ints(engine.from_mont(ops.add(xm, ym)))
    assert add == [(a + b) % R for a, b in zip(xs, ys)]
    sub = engine.col_to_ints(engine.from_mont(ops.sub(xm, ym)))
    assert sub == [(a - b) % R for a, b in zip(xs, ys)]
    mul = engine.col_to_ints(engine.from_mont(ops.mul(xm, ym)))
    assert mul == [a * b % R for a, b in zip(xs, ys)]
    neg = engine.col_to_ints(engine.from_mont(ops.neg(xm)))
    assert neg == [(-a) % R for a in xs]
    # scalar broadcast + scale
    c = 0xDEADBEEF
    sc = engine.col_to_ints(engine.from_mont(ops.scale(xm, c)))
    assert sc == [a * c % R for a in xs]


def test_binop_rotation():
    xs = rand_fr(64)
    xm = engine.to_mont(engine.col_from_ints(xs))
    one = engine.mont_scalar(1)
    out = native.fr_vec_binop(2, xm, 3, one, 0, 64)
    got = engine.col_to_ints(engine.from_mont(out))
    assert got == xs[3:] + xs[:3]
    out = native.fr_vec_binop(2, xm, -1, one, 0, 64)
    got = engine.col_to_ints(engine.from_mont(out))
    assert got == xs[-1:] + xs[:-1]


@pytest.mark.parametrize("k", [4, 10])
def test_ntt_matches_oracle(k):
    n = 1 << k
    vals = rand_fr(n)
    dom = engine.NativeDomain(k)
    vm = engine.to_mont(engine.col_from_ints(vals))
    fwd = engine.col_to_ints(engine.from_mont(dom.ntt(vm)))
    assert fwd == opoly.ntt(vals, fr_omega(k), n)
    back = engine.col_to_ints(engine.from_mont(dom.intt(dom.ntt(vm))))
    assert back == vals


def test_coset_evals_matches_oracle():
    k = 6
    n = 1 << k
    coeffs = rand_fr(n)
    g = 5
    dom = engine.NativeDomain(k)
    cm = engine.to_mont(engine.col_from_ints(coeffs))
    got = engine.col_to_ints(engine.from_mont(dom.coset_evals(cm, g)))
    want = [
        opoly.eval_poly(coeffs, g * pow(fr_omega(k), i, R) % R)
        for i in range(n)
    ]
    assert got == want


def test_grand_product_and_batch_inv():
    m = 300
    num = rand_fr(m)
    den = [d or 1 for d in rand_fr(m)]
    nm = engine.to_mont(engine.col_from_ints(num))
    dm = engine.to_mont(engine.col_from_ints(den))
    z = native.fr_grand_product(nm, dm, engine.mont_scalar(1).reshape(-1))
    got = engine.col_to_ints(engine.from_mont(z))
    want = [1]
    for j in range(m):
        want.append(want[-1] * num[j] % R * pow(den[j], -1, R) % R)
    assert got == want
    # batch inv with zeros
    vals = rand_fr(50)
    vals[7] = 0
    vals[20] = 0
    vm = engine.to_mont(engine.col_from_ints(vals))
    native.fr_batch_inv_inplace(vm)
    got = engine.col_to_ints(engine.from_mont(vm))
    assert got == [0 if v == 0 else pow(v, -1, R) for v in vals]


def test_horner_divide_fold():
    coeffs = rand_fr(33)
    x = rand_fr(1)[0]
    cm = engine.to_mont(engine.col_from_ints(coeffs))
    assert engine.eval_at(cm, x) == opoly.eval_poly(coeffs, x)
    q = native.fr_divide_linear(cm, engine.mont_scalar(x).reshape(-1))
    assert engine.col_to_ints(engine.from_mont(q)) == opoly.divide_linear(
        [
            (coeffs[0] - opoly.eval_poly(coeffs, x)) % R,
            *coeffs[1:],
        ],
        x,
    )
    # fold: acc = acc*v + x
    a = rand_fr(40)
    b = rand_fr(40)
    v = 123457
    am = engine.to_mont(engine.col_from_ints(a))
    bm = engine.to_mont(engine.col_from_ints(b))
    native.fr_fold_inplace(am, bm, engine.mont_scalar(v).reshape(-1))
    got = engine.col_to_ints(engine.from_mont(am))
    assert got == [(x * v + y) % R for x, y in zip(a, b)]


def test_pow_series():
    g = 7
    n = 100
    s = engine.pow_series(engine.mont_scalar(g), n)
    got = engine.col_to_ints(engine.from_mont(s))
    assert got == [pow(g, i, R) for i in range(n)]


def test_g1_batch_mul_win_and_normalize():
    scalars = rand_fr(37) + [0]
    base = oc.g1_generator()
    base_u64 = ints_to_u64([base[0], base[1]]).reshape(-1)
    aff, inf = native.g1_batch_mul_win(base_u64, ints_to_u64(scalars))
    got = u64_to_points(aff, inf)
    want = [oc.g1_mul(base, s) for s in scalars]
    assert got == want


def test_g1_msm_threaded_matches_oracle():
    n = 1 << 15  # crosses the 2-thread threshold
    scalars = [int.from_bytes(RNG.bytes(32), "little") % R for _ in range(n)]
    pts = [oc.g1_mul(oc.g1_generator(), i + 1) for i in range(64)] * (n // 64)
    got = native.g1_msm(pts, scalars)
    # oracle check via sum over 64 distinct points: sum_i s_i * P_{i%64}
    agg = [0] * 64
    for i, s in enumerate(scalars):
        agg[i % 64] = (agg[i % 64] + s) % R
    want = oc.g1_msm(pts[:64], agg)
    assert got == want


# ---------------------------------------------------------------------------
# pairing
# ---------------------------------------------------------------------------


def test_native_miller_loop_matches_oracle():
    from halo2_aggregation.oracle import pairing as op

    g1, g2 = oc.g1_generator(), oc.g2_generator()
    p = oc.g1_mul(g1, 12345)
    q = oc.g2_mul(g2, 6789)
    assert native.miller_loop(p, q) == op.miller_loop(p, q)
    # infinity on the G1 side -> 1
    assert native.miller_loop(None, q) == op.FQ12_ONE


@pytest.mark.slow
def test_native_pairing_bilinearity():
    """e(aP, bQ) * e(-abP, Q) == 1 and a perturbed product != 1."""
    g1, g2 = oc.g1_generator(), oc.g2_generator()
    a, b = 777, 888
    good = [
        (oc.g1_mul(g1, a), oc.g2_mul(g2, b)),
        (oc.g1_neg(oc.g1_mul(g1, a * b % R)), g2),
    ]
    bad = [
        (oc.g1_mul(g1, a), oc.g2_mul(g2, b)),
        (oc.g1_neg(oc.g1_mul(g1, 42)), g2),
    ]
    assert native.multi_pairing_check(good)
    assert not native.multi_pairing_check(bad)


def test_native_final_exp_matches_oracle_check():
    """The full check agrees with the Python oracle on a random instance."""
    from halo2_aggregation.oracle import pairing as op

    g1, g2 = oc.g1_generator(), oc.g2_generator()
    pairs = [
        (oc.g1_mul(g1, 31415), oc.g2_mul(g2, 2718)),
        (oc.g1_neg(oc.g1_mul(g1, 31415 * 2718 % R)), g2),
    ]
    assert native.multi_pairing_check(pairs) == op.multi_pairing_check(pairs)
