"""Device limb field arithmetic vs the Python-int oracle (SURVEY.md §4's
"field kernel unit tests against a trusted CPU oracle")."""

import numpy as np
import pytest

import jax.numpy as jnp

from halo2_aggregation.fields import MONT_R, Q, R
from halo2_aggregation.ops import field_ops as fo
from halo2_aggregation.ops.limbs import ints_to_limbs, limbs_to_int, limbs_to_ints

RNG = np.random.default_rng(0xBEEF)


def rand_elems(n, p):
    return [int.from_bytes(RNG.bytes(40), "little") % p for _ in range(n)]


def mont(xs, p):
    return [x * MONT_R % p for x in xs]


@pytest.mark.parametrize("spec", [fo.FQ, fo.FR], ids=["Fq", "Fr"])
def test_add_sub_neg(spec):
    p = spec.p
    a_int = rand_elems(64, p) + [0, 1, p - 1]
    b_int = rand_elems(64, p) + [0, p - 1, p - 1]
    a = jnp.asarray(ints_to_limbs(a_int))
    b = jnp.asarray(ints_to_limbs(b_int))
    got = limbs_to_ints(fo.add(a, b, spec))
    assert got == [(x + y) % p for x, y in zip(a_int, b_int)]
    got = limbs_to_ints(fo.sub(a, b, spec))
    assert got == [(x - y) % p for x, y in zip(a_int, b_int)]
    got = limbs_to_ints(fo.neg(a, spec))
    assert got == [(-x) % p for x in a_int]


@pytest.mark.parametrize("spec", [fo.FQ, fo.FR], ids=["Fq", "Fr"])
def test_mont_mul(spec):
    p = spec.p
    a_int = rand_elems(128, p) + [0, 1, p - 1, p - 1]
    b_int = rand_elems(128, p) + [p - 1, 1, p - 1, 0]
    a = jnp.asarray(ints_to_limbs(mont(a_int, p)))
    b = jnp.asarray(ints_to_limbs(mont(b_int, p)))
    got = fo.mont_mul(a, b, spec)
    want = [x * y % p * MONT_R % p for x, y in zip(a_int, b_int)]
    assert limbs_to_ints(got) == want


@pytest.mark.parametrize("spec", [fo.FQ, fo.FR], ids=["Fq", "Fr"])
def test_mont_roundtrip_and_inv(spec):
    p = spec.p
    a_int = rand_elems(16, p) + [1, p - 1]
    a = jnp.asarray(ints_to_limbs(a_int))
    am = fo.to_mont(a, spec)
    assert limbs_to_ints(am) == mont(a_int, p)
    assert limbs_to_ints(fo.from_mont(am, spec)) == a_int
    ainv = fo.inv(am, spec)
    got = [spec.from_mont_int(row) for row in np.asarray(ainv)]
    assert got == [pow(x, -1, p) for x in a_int]


def test_pow_static():
    p = fo.FR.p
    a_int = rand_elems(8, p)
    a = jnp.asarray(ints_to_limbs(mont(a_int, p)))
    e = 0x1234567890ABCDEF
    got = [fo.FR.from_mont_int(row) for row in np.asarray(fo.mont_pow_static(a, e, fo.FR))]
    assert got == [pow(x, e, p) for x in a_int]
    # e = 0
    got0 = [fo.FR.from_mont_int(row) for row in np.asarray(fo.mont_pow_static(a, 0, fo.FR))]
    assert got0 == [1] * len(a_int)


def test_horner_fold():
    p = fo.FR.p
    vals_int = rand_elems(7, p)
    x_int = rand_elems(1, p)[0]
    vals = jnp.asarray(ints_to_limbs(mont(vals_int, p)))
    x = jnp.asarray(ints_to_limbs([x_int * MONT_R % p]))[0]
    got = fo.FR.from_mont_int(np.asarray(fo.horner_fold(vals, x, fo.FR)))
    acc = vals_int[0]
    for v in vals_int[1:]:
        acc = (acc * x_int + v) % p
    assert got == acc


def test_is_zero_eq_select():
    a = jnp.asarray(ints_to_limbs([0, 5, 0]))
    b = jnp.asarray(ints_to_limbs([0, 5, 7]))
    assert list(np.asarray(fo.is_zero(a))) == [True, False, True]
    assert list(np.asarray(fo.eq(a, b))) == [True, True, False]
    m = jnp.asarray([True, False, True])
    got = limbs_to_ints(fo.select(m, a, b))
    assert got == [0, 5, 0]


def test_mont_mul_big_chunked_matches(monkeypatch):
    """mont_mul_big's lax.map slab path (used by prover-scale NTT stages
    and power series, where full-width conv temps exhaust device memory) must be
    bit-identical to plain mont_mul.  Threshold lowered so the chunked
    branch actually runs at test size."""
    monkeypatch.setattr(fo, "big_rows", lambda: 8)
    p = fo.FR.p
    a_int = rand_elems(32, p)
    b_int = rand_elems(32, p)
    a = jnp.asarray(ints_to_limbs(mont(a_int, p)))
    b = jnp.asarray(ints_to_limbs(mont(b_int, p)))
    got = np.asarray(fo.mont_mul_big(a, b, fo.FR, chunk=8))
    want = np.asarray(fo.mont_mul(a, b, fo.FR))
    assert (got == want).all()
    # broadcast operand (the NTT twiddle / shift-pows shape)
    got2 = np.asarray(fo.mont_mul_big(a, b[:1], fo.FR, chunk=8))
    want2 = np.asarray(fo.mont_mul(a, jnp.broadcast_to(b[:1], a.shape), fo.FR))
    assert (got2 == want2).all()
    # 3D shape as in ntt_dyn stages
    a3 = a.reshape(4, 8, -1)
    got3 = np.asarray(fo.mont_mul_big(a3, b.reshape(4, 8, -1), fo.FR, chunk=8))
    assert (got3.reshape(32, -1) == want).all()
