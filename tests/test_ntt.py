"""NTT/domain kernels vs naive Python-int polynomial evaluation."""

import numpy as np
import jax.numpy as jnp

from halo2_aggregation.fields import R, fr_omega
from halo2_aggregation.ops import field_ops as fo
from halo2_aggregation.ops.ntt import Domain, poly_eval

FR = fo.FR
RNG = np.random.default_rng(0xD00D)


def rand_fr(n):
    return [int.from_bytes(RNG.bytes(40), "little") % R for _ in range(n)]


def test_ntt_roundtrip_and_values():
    k = 4
    dom = Domain(k)
    coeffs_int = rand_fr(dom.n)
    coeffs = jnp.asarray(FR.to_mont_array(coeffs_int))
    evals = dom.ntt(coeffs)
    # naive evaluation
    w = fr_omega(k)
    want = [
        sum(c * pow(w, i * j, R) for j, c in enumerate(coeffs_int)) % R
        for i in range(dom.n)
    ]
    assert FR.from_mont_array(evals) == want
    back = dom.intt(evals)
    assert FR.from_mont_array(back) == coeffs_int


def test_extended_coset_roundtrip():
    k, ext_k = 3, 5
    dom = Domain(k, ext_k)
    coeffs_int = rand_fr(dom.n)
    coeffs = jnp.asarray(FR.to_mont_array(coeffs_int))
    ext = dom.coeffs_to_extended(coeffs)
    # spot check: eval at g * ext_omega^i
    g = dom.g_coset
    for i in [0, 1, 7]:
        x = g * pow(dom.ext_omega, i, R) % R
        want = sum(c * pow(x, j, R) for j, c in enumerate(coeffs_int)) % R
        assert FR.from_mont_array(ext[i : i + 1])[0] == want
    back = dom.extended_to_coeffs(ext)
    assert FR.from_mont_array(back[: dom.n]) == coeffs_int
    assert all(v == 0 for v in FR.from_mont_array(back[dom.n :]))


def test_divide_by_vanishing():
    k, ext_k = 3, 5
    dom = Domain(k, ext_k)
    # numerator = (X^n - 1) * q(X) for random q of degree < 3n
    q_int = rand_fr(3 * dom.n)
    num_int = [0] * (len(q_int) + dom.n)
    for j, c in enumerate(q_int):
        num_int[j + dom.n] = (num_int[j + dom.n] + c) % R
        num_int[j] = (num_int[j] - c) % R
    num = jnp.asarray(FR.to_mont_array(num_int))
    ext = dom.coeffs_to_extended(num)
    h_ext = dom.divide_by_vanishing(ext)
    h = dom.extended_to_coeffs(h_ext)
    got = FR.from_mont_array(h[: len(q_int)])
    assert got == q_int


def test_poly_eval():
    coeffs_int = rand_fr(9)
    x_int = rand_fr(1)[0]
    coeffs = jnp.asarray(FR.to_mont_array(coeffs_int))
    x = jnp.asarray(FR.to_mont(x_int))
    got = FR.from_mont_array(poly_eval(coeffs, x)[None])[0]
    want = 0
    for c in reversed(coeffs_int):
        want = (want * x_int + c) % R
    assert got == want
