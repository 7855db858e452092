"""The coupled device-prover primitives: barycentric evaluation,
eval-form multiopen witnesses, the native dot product, the parallel
batch inversion, and the vectorized lookup permutation.

These back create_proof_native's coefficient-free path (round 5): the
step-7 evaluations and step-8 witnesses run straight off VALUE columns,
so every identity here must hold EXACTLY (the transcript bytes depend
on them; reference: the evals/multiopen the fork's create_proof emits,
verifier.rs:438-510 / multiopen.rs:271-509).
"""

import numpy as np
import pytest

from halo2_aggregation.fields import R
from halo2_aggregation.plonk import engine
from halo2_aggregation.utils import native



def _rand_col(rng, n):
    return [int.from_bytes(rng.bytes(31), "little") % R for _ in range(n)]


def test_fr_dot_matches_python():
    rng = np.random.default_rng(0)
    n = 4097  # crosses the OpenMP chunk boundary
    a = _rand_col(rng, n)
    b = _rand_col(rng, n)
    am = engine.to_mont(engine.col_from_ints(a))
    bm = engine.to_mont(engine.col_from_ints(b))
    got = engine.scalar_to_int(native.fr_dot(am, bm).reshape(1, 4))
    assert got == sum(x * y for x, y in zip(a, b)) % R


def test_batch_inv_parallel_with_zeros():
    rng = np.random.default_rng(1)
    n = 1 << 15  # above the parallel threshold
    vals = _rand_col(rng, n)
    for i in (0, 777, n // 2, n - 1):  # zeros incl. chunk boundaries
        vals[i] = 0
    m = engine.to_mont(engine.col_from_ints(vals))
    native.fr_batch_inv_inplace(m)
    out = engine.col_to_ints(engine.from_mont(m))
    for i in (0, 1, 777, n // 2, n // 2 + 1, n - 1):
        want = 0 if vals[i] == 0 else pow(vals[i], -1, R)
        assert out[i] == want


def test_barycentric_eval_equals_horner():
    rng = np.random.default_rng(2)
    k = 10
    vals = _rand_col(rng, 1 << k)
    ev = engine.to_mont(engine.col_from_ints(vals))
    coeffs = engine.NativeDomain(k).intt(ev)
    bary = engine.Barycentric(k)
    for z in (3, 0x1234567890ABCDEF, R - 7):
        assert bary.eval(ev, z) == engine.eval_at(coeffs, z)


def test_barycentric_point_in_domain_raises():
    bary = engine.Barycentric(6)
    omega = engine.fr_omega(6)
    with pytest.raises(ZeroDivisionError):
        bary.point(pow(omega, 5, R))


def test_witness_evals_equal_divide_linear_ntt():
    """The eval-form multiopen witness is the SAME polynomial the
    synthetic-division path commits: its domain values must equal
    ntt(divide_linear(coeffs, z)) bit-for-bit."""
    rng = np.random.default_rng(3)
    k = 9
    dom = engine.NativeDomain(k)
    vals = _rand_col(rng, 1 << k)
    ev = engine.to_mont(engine.col_from_ints(vals))
    coeffs = dom.intt(ev)
    bary = engine.Barycentric(k)
    z = 0xDEADBEEF12345678
    fe = bary.eval(ev, z)
    w_ev = bary.witness_evals(ev, fe, z)
    q = native.fr_divide_linear(coeffs, engine.mont_scalar(z).reshape(-1))
    assert np.array_equal(w_ev, dom.ntt(q))


def test_permute_lookup_u64_matches_spec():
    from halo2_aggregation.plonk.prover import _permute_lookup
    from halo2_aggregation.plonk.prover_native import _permute_lookup_u64
    from halo2_aggregation.utils.u64 import u64_to_ints

    rng = np.random.default_rng(4)
    for _ in range(40):
        usable = int(rng.integers(1, 300))
        n = usable + int(rng.integers(0, 8))
        nvals = int(rng.integers(1, 25))
        table = [_rand_col(rng, 1)[0] for _ in range(nvals)]
        s = [table[int(i)] for i in rng.integers(0, nvals, size=usable)]
        s += [0] * (n - usable)
        a = [s[int(i)] for i in rng.integers(0, usable, size=usable)]
        a += [0] * (n - usable)
        ap, sp = _permute_lookup(a, s, usable)
        au, su = _permute_lookup_u64(
            engine.col_from_ints(a), engine.col_from_ints(s), usable
        )
        assert u64_to_ints(au) == ap
        assert u64_to_ints(su) == sp


def test_permute_lookup_u64_missing_value_raises():
    from halo2_aggregation.plonk.prover_native import _permute_lookup_u64

    bad = engine.col_from_ints([999] + [1] * 9)
    tbl = engine.col_from_ints([1] * 10)
    with pytest.raises(ValueError):
        _permute_lookup_u64(bad, tbl, 10)
