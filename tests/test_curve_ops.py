"""Device G1 ops vs the Python-int oracle."""

import numpy as np
import jax.numpy as jnp

from halo2_aggregation.fields import R
from halo2_aggregation.oracle import curve as oc
from halo2_aggregation.ops import curve_ops as co
from halo2_aggregation.ops.limbs import ints_to_limbs

RNG = np.random.default_rng(0xCAFE)


def rand_points(n):
    return [oc.g1_mul(oc.g1_generator(), int(RNG.integers(1, 1 << 62))) for _ in range(n)]


def test_double_add_vs_oracle():
    pts = rand_points(8)
    qts = rand_points(8)
    p = co.affine_to_jac(co.affine_from_ints(pts))
    q = co.affine_to_jac(co.affine_from_ints(qts))
    got_dbl = co.jac_to_ints(co.jac_double(p))
    assert got_dbl == [oc.g1_double(x) for x in pts]
    got_add = co.jac_to_ints(co.jac_add(p, q))
    assert got_add == [oc.g1_add(a, b) for a, b in zip(pts, qts)]


def test_add_edge_cases():
    g = oc.g1_generator()
    pts = [g, g, None, g, None]
    qts = [g, oc.g1_neg(g), g, None, None]
    p = co.affine_to_jac(co.affine_from_ints(pts))
    q = co.affine_to_jac(co.affine_from_ints(qts))
    got = co.jac_to_ints(co.jac_add(p, q))
    want = [oc.g1_add(a, b) for a, b in zip(pts, qts)]
    assert got == want


def test_scalar_mul_vs_oracle():
    # 64-bit scalars keep the CPU scan short; the full-width path is
    # exercised by the verifier parity tests
    pts = rand_points(4)
    ks = [0, 1, int.from_bytes(RNG.bytes(8), "little"), (1 << 64) - 1]
    p = co.affine_to_jac(co.affine_from_ints(pts))
    s = jnp.asarray(ints_to_limbs(ks))
    got = co.jac_to_ints(co.scalar_mul(p, s, 64))
    want = [oc.g1_mul(pt, k) for pt, k in zip(pts, ks)]
    assert got == want


def test_jac_sum():
    pts = rand_points(7)
    p = co.affine_to_jac(co.affine_from_ints(pts))
    got = co.jac_to_ints(co.JacPoint(*[a[None] if a.ndim == 0 else a for a in co.jac_sum(p)]))
    acc = None
    for pt in pts:
        acc = oc.g1_add(acc, pt)
    assert got == [acc]
