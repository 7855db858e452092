"""The scalar-mul ladder (ops/ec_ladder.py, native/ec_ladder.cu) on the CPU.

The CUDA kernel has no interpret mode, so its arithmetic is checked here
three ways: a NumPy model of its CIOS multiply and windowed ladder, the
kernel source itself built as plain C++ (`h2a_*_host`), and the wrapper's
layout code (limb regrouping, windows, padding, dispatch).  All three are
compared with the Python-int oracle.  The compiled kernel runs on the
card in chip_smoke.py (and in the `gpu`-marked test below).
"""

import re
from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from halo2_aggregation import platform
from halo2_aggregation.fields import MONT_R, Q, R
from halo2_aggregation.ops import curve_ops as co
from halo2_aggregation.ops import ec_ladder as el
from halo2_aggregation.ops.limbs import ints_to_limbs
from halo2_aggregation.oracle import curve as oc

RNG = np.random.default_rng(2024)
G = oc.g1_generator()


def _words(x: int) -> list:
    return [(x >> (32 * i)) & 0xFFFFFFFF for i in range(8)]


def _from_words(w) -> int:
    return sum(int(v) << (32 * i) for i, v in enumerate(w))


def _rand_fq() -> int:
    return int.from_bytes(RNG.bytes(40), "little") % Q


def _rand_point():
    return oc.g1_mul(G, int(RNG.integers(2, 1 << 60)))


# -- layout -------------------------------------------------------------------

EDGE_INTS = [0, 1, Q - 1, R - 1, (1 << 256) - 1, 0xFFFFFFFF, 1 << 255]


@pytest.mark.parametrize("x", EDGE_INTS, ids=lambda x: hex(x)[:12])
def test_limbs8_u32_round_trip(x):
    limbs = jnp.asarray(ints_to_limbs([x]))
    words = el.limbs8_to_u32(limbs)
    assert words.dtype == jnp.uint32
    assert [int(v) for v in np.asarray(words)[0]] == _words(x)
    back = el.u32_to_limbs8(words)
    assert back.dtype == jnp.int32
    np.testing.assert_array_equal(np.asarray(back), np.asarray(limbs))


def test_limbs8_u32_batched_shapes():
    xs = [_rand_fq() for _ in range(6)]
    limbs = jnp.asarray(ints_to_limbs(xs)).reshape(2, 3, 32)
    words = el.limbs8_to_u32(limbs)
    assert words.shape == (2, 3, 8)
    got = [_from_words(w) for w in np.asarray(words).reshape(6, 8)]
    assert got == xs


@pytest.mark.parametrize("nbits", [254, 256, 32, 5])
def test_windows4_are_the_scalar_nibbles(nbits):
    ks = [int.from_bytes(RNG.bytes(32), "little") for _ in range(4)] + [0]
    wins = np.asarray(el.windows4(jnp.asarray(ints_to_limbs(ks)), nbits))
    n_win = -(-nbits // 4)
    assert wins.shape == (5, n_win) and wins.dtype == np.uint8
    for k, row in zip(ks, wins):
        k_cut = k & ((1 << nbits) - 1)
        assert sum(int(d) << (4 * w) for w, d in enumerate(row)) == k_cut


def test_pack_points_layout():
    pts = [_rand_point() for _ in range(3)]
    jac = co.affine_to_jac(co.affine_from_ints(pts))
    packed = np.asarray(el.pack_points(jac))
    assert packed.shape == (3, 3, 8) and packed.dtype == np.uint32
    for i, (x, y) in enumerate(pts):
        assert _from_words(packed[i, 0]) == x * MONT_R % Q
        assert _from_words(packed[i, 1]) == y * MONT_R % Q
        assert _from_words(packed[i, 2]) == MONT_R % Q  # z = 1
    back = el.unpack_points(jnp.asarray(packed), (3,))
    for a, b in zip(back, jac):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


# -- a NumPy model of the kernel's arithmetic ---------------------------------

M32 = np.uint64(0xFFFFFFFF)
P_W = [np.uint64(v) for v in _words(Q)]
PINV = np.uint64((-pow(Q, -1, 1 << 32)) % (1 << 32))
ONE_W = np.array(_words(MONT_R % Q), np.uint64)


def _reduce(t, hi):
    d = np.empty_like(t)
    borrow = np.zeros(t.shape[0], np.uint64)
    for i in range(8):
        s = t[:, i] - P_W[i] - borrow
        d[:, i] = s & M32
        borrow = s >> np.uint64(63)
    take = (hi != 0) | (borrow == 0)
    return np.where(take[:, None], d, t)


def np_mul(a, b):
    """CIOS Montgomery product over (N, 8) u32 words held in uint64."""
    n = a.shape[0]
    t = np.zeros((n, 10), np.uint64)
    s32 = np.uint64(32)
    for i in range(8):
        c = np.zeros(n, np.uint64)
        for j in range(8):
            c = a[:, j] * b[:, i] + t[:, j] + (c >> s32)
            t[:, j] = c & M32
        c = t[:, 8] + (c >> s32)
        t[:, 8] = c & M32
        t[:, 9] = c >> s32
        m = (t[:, 0] * PINV) & M32
        c = m * P_W[0] + t[:, 0]
        for j in range(1, 8):
            c = m * P_W[j] + t[:, j] + (c >> s32)
            t[:, j - 1] = c & M32
        c = t[:, 8] + (c >> s32)
        t[:, 7] = c & M32
        t[:, 8] = t[:, 9] + (c >> s32)
    return _reduce(t[:, :8].copy(), t[:, 8])


def np_add(a, b):
    t = np.empty_like(a)
    c = np.zeros(a.shape[0], np.uint64)
    for i in range(8):
        c = a[:, i] + b[:, i] + (c >> np.uint64(32))
        t[:, i] = c & M32
    return _reduce(t, c >> np.uint64(32))


def np_sub(a, b):
    d = np.empty_like(a)
    borrow = np.zeros(a.shape[0], np.uint64)
    for i in range(8):
        s = a[:, i] - b[:, i] - borrow
        d[:, i] = s & M32
        borrow = s >> np.uint64(63)
    c = np.zeros(a.shape[0], np.uint64)
    fixed = np.empty_like(d)
    for i in range(8):
        c = d[:, i] + P_W[i] + (c >> np.uint64(32))
        fixed[:, i] = c & M32
    return np.where((borrow != 0)[:, None], fixed, d)


def _zero(a):
    return np.all(a == 0, axis=1)


def np_dbl(p):
    x, y, z = p
    A = np_mul(x, x)
    B = np_mul(y, y)
    C = np_mul(B, B)
    xb = np_add(x, B)
    D = np_sub(np_sub(np_mul(xb, xb), A), C)
    D = np_add(D, D)
    E = np_add(np_add(A, A), A)
    x3 = np_sub(np_mul(E, E), np_add(D, D))
    C8 = np_add(C, C)
    C8 = np_add(C8, C8)
    C8 = np_add(C8, C8)
    y3 = np_sub(np_mul(E, np_sub(D, x3)), C8)
    return x3, y3, np_mul(np_add(y, y), z)


def np_jadd(p, q):
    """Per lane as the kernel's branches: q = O -> p; p = O -> q;
    p == q -> dbl(p); else the general formula."""
    (x1, y1, z1), (x2, y2, z2) = p, q
    z1z1, z2z2 = np_mul(z1, z1), np_mul(z2, z2)
    u1, u2 = np_mul(x1, z2z2), np_mul(x2, z1z1)
    s1 = np_mul(y1, np_mul(z2, z2z2))
    s2 = np_mul(y2, np_mul(z1, z1z1))
    h, r = np_sub(u2, u1), np_sub(s2, s1)
    h2 = np_mul(h, h)
    h3 = np_mul(h2, h)
    u1h2 = np_mul(u1, h2)
    x3 = np_sub(np_sub(np_mul(r, r), h3), np_add(u1h2, u1h2))
    y3 = np_sub(np_mul(r, np_sub(u1h2, x3)), np_mul(s1, h3))
    z3 = np_mul(np_mul(z1, z2), h)
    d = np_dbl(p)
    use_d = _zero(h) & _zero(r)
    out = []
    for c_gen, c_dbl, c_p, c_q in zip((x3, y3, z3), d, p, q):
        c = np.where(use_d[:, None], c_dbl, c_gen)
        c = np.where(_zero(z1)[:, None], c_q, c)
        out.append(np.where(_zero(z2)[:, None], c_p, c))
    return tuple(out)


def np_ladder(pt, wins):
    """pt: 3 x (N, 8) words; wins: (N, n_win) -> 3 x (N, 8)."""
    n = pt[0].shape[0]
    ident = (np.tile(ONE_W, (n, 1)), np.tile(ONE_W, (n, 1)),
             np.zeros((n, 8), np.uint64))
    tbl = [ident, pt]
    for d in range(2, 16):
        tbl.append(np_jadd(tbl[d - 1], pt) if d % 2 else np_dbl(tbl[d // 2]))
    stacked = [np.stack([t[c] for t in tbl]) for c in range(3)]  # (16, N, 8)
    acc = ident
    lanes = np.arange(n)
    for w in range(wins.shape[1] - 1, -1, -1):
        for _ in range(4):
            acc = np_dbl(acc)
        sel = tuple(s[wins[:, w], lanes] for s in stacked)
        acc = np_jadd(acc, sel)
    return acc


def _affine_from_words(x, y, z):
    """Montgomery Jacobian words -> oracle affine point (None = O)."""
    rinv = pow(MONT_R, -1, Q)
    X, Y, Z = (_from_words(v) * rinv % Q for v in (x, y, z))
    if Z == 0:
        return None
    zi = pow(Z, -1, Q)
    return (X * zi * zi % Q, Y * zi * zi * zi % Q)


@pytest.mark.parametrize(
    "a,b",
    [(0, 5), (1, 1), (Q - 1, Q - 1), (Q - 1, 2), ("rand", "rand")],
)
def test_model_and_host_cios_match_python_ints(a, b):
    n = 4
    av = [_rand_fq() if a == "rand" else a for _ in range(n)]
    bv = [_rand_fq() if b == "rand" else b for _ in range(n)]
    aw = np.array([_words(v) for v in av], np.uint64)
    bw = np.array([_words(v) for v in bv], np.uint64)
    want = [x * y * pow(MONT_R, -1, Q) % Q for x, y in zip(av, bv)]
    got_model = [_from_words(r) for r in np_mul(aw, bw)]
    assert got_model == want
    out = np.empty((n, 8), np.uint32)
    el.load_host().h2a_fq_mul_host(
        aw.astype(np.uint32), bw.astype(np.uint32), n, out
    )
    assert [_from_words(r) for r in out] == want


LADDER_CASES = {
    "zero": (lambda: G, 0),
    "one": (lambda: _rand_point(), 1),
    "r_minus_1": (lambda: _rand_point(), R - 1),
    "identity_point": (lambda: None, 12345),
    "small": (lambda: G, 16 * 3 + 2),
    "random": (lambda: _rand_point(), "rand"),
}


def _case_inputs(name, n=3):
    mk, k = LADDER_CASES[name]
    pts = [mk() for _ in range(n)]
    ks = [int.from_bytes(RNG.bytes(32), "little") % R if k == "rand" else k
          for _ in range(n)]
    return pts, ks


@pytest.mark.parametrize("name", sorted(LADDER_CASES))
def test_model_ladder_matches_oracle(name):
    pts, ks = _case_inputs(name, n=2)
    jac = co.affine_to_jac(co.affine_from_ints(pts))
    packed = np.asarray(el.pack_points(jac)).astype(np.uint64)
    wins = np.asarray(el.windows4(jnp.asarray(ints_to_limbs(ks)), 254))
    x, y, z = np_ladder(tuple(packed[:, c] for c in range(3)), wins)
    got = [_affine_from_words(*v) for v in zip(x, y, z)]
    want = [None if p is None else oc.g1_mul(p, k) for p, k in zip(pts, ks)]
    assert got == want


@pytest.mark.parametrize("name", sorted(LADDER_CASES))
def test_host_build_ladder_matches_oracle(name):
    pts, ks = _case_inputs(name)
    jac = co.affine_to_jac(co.affine_from_ints(pts))
    got = co.jac_to_ints(el.scalar_mul_host(jac, jnp.asarray(ints_to_limbs(ks))))
    want = [None if p is None else oc.g1_mul(p, k) for p, k in zip(pts, ks)]
    assert got == want


@pytest.mark.parametrize("case", ["p_eq_q", "p_eq_neg_q", "p_identity", "q_identity"])
def test_host_build_jac_add_edge_cases(case):
    """The kernel's unified add takes P == Q to the doubling and P == -Q
    to Z == 0, as curve_ops.jac_add does."""
    P = _rand_point()
    negP = oc.g1_neg(P)
    p, q, want = {
        "p_eq_q": (P, P, oc.g1_add(P, P)),
        "p_eq_neg_q": (P, negP, None),
        "p_identity": (None, P, P),
        "q_identity": (P, None, P),
    }[case]
    jp = co.affine_to_jac(co.affine_from_ints([p]))
    jq = co.affine_to_jac(co.affine_from_ints([q]))
    a = np.ascontiguousarray(np.asarray(el.pack_points(jp)))
    b = np.ascontiguousarray(np.asarray(el.pack_points(jq)))
    out = np.empty_like(a)
    el.load_host().h2a_jac_add_host(a, b, 1, out)
    assert co.jac_to_ints(el.unpack_points(jnp.asarray(out), (1,))) == [want]
    # and the XLA formula agrees
    assert co.jac_to_ints(co.jac_add(jp, jq)) == [want]


def test_padding_lanes_are_inert():
    """Identity points and zero scalars (the mesh path's lane padding)
    come out as Z == 0 on every path, beside live lanes."""
    live = _rand_point()
    pts = [live, None, G, None]
    ks = [7, 99, 0, 0]
    jac = co.affine_to_jac(co.affine_from_ints(pts))
    ss = jnp.asarray(ints_to_limbs(ks))
    want = [oc.g1_mul(live, 7), None, None, None]
    host = el.scalar_mul_host(jac, ss)
    assert co.jac_to_ints(host) == want
    assert not np.asarray(host.z)[1:].any()
    assert co.jac_to_ints(co.scalar_mul(jac, ss, 254)) == want


# -- dispatch -----------------------------------------------------------------


def test_dispatch_cpu_takes_the_xla_scan():
    jac = co.affine_to_jac(co.affine_from_ints([G]))
    ss = jnp.asarray(ints_to_limbs([5]))
    with mock.patch.object(el, "scalar_mul_cuda") as cuda:
        out = el.scalar_mul_lanes(jac, ss, 254)
    cuda.assert_not_called()
    assert co.jac_to_ints(out) == [oc.g1_mul(G, 5)]


def test_dispatch_gpu_takes_the_cuda_ladder():
    jac = co.affine_to_jac(co.affine_from_ints([G]))
    ss = jnp.asarray(ints_to_limbs([5]))
    with mock.patch.object(platform, "on_gpu", return_value=True), \
            mock.patch.object(el, "scalar_mul_cuda", return_value="cuda") as cuda, \
            mock.patch.object(co, "scalar_mul") as scan:
        assert el.scalar_mul_lanes(jac, ss, 254) == "cuda"
    cuda.assert_called_once()
    scan.assert_not_called()


def test_gpu_without_the_library_raises():
    """On a GPU a missing compiler or a failed build is an error, never a
    silent XLA path."""
    jac = co.affine_to_jac(co.affine_from_ints([G]))
    ss = jnp.asarray(ints_to_limbs([5]))
    el.load_cuda.cache_clear()
    try:
        with mock.patch.object(platform, "on_gpu", return_value=True), \
                mock.patch.object(
                    el.build, "find_nvcc",
                    side_effect=RuntimeError("nvcc not found"),
                ):
            with pytest.raises(RuntimeError, match="nvcc"):
                el.scalar_mul_lanes(jac, ss, 254)
    finally:
        el.load_cuda.cache_clear()


def test_cuda_source_constants_match_the_field():
    src = open(el.SOURCE).read()

    def words(name):
        body = re.search(rf"#define {name}\s*\\\s*\{{([^}}]*)\}}", src).group(1)
        return [int(v, 16) for v in re.findall(r"0x([0-9a-f]+)u", body)]

    assert words("H2A_P_WORDS") == _words(Q)
    assert words("H2A_ONE_WORDS") == _words(MONT_R % Q)
    pinv = int(re.search(r"#define H2A_PINV (0x[0-9a-f]+)u", src).group(1), 16)
    assert pinv == (-pow(Q, -1, 1 << 32)) % (1 << 32)


def test_cuda_build_targets_sm90a():
    cmd = el.cuda_command("/usr/local/cuda/bin/nvcc")
    assert "arch=compute_90a,code=sm_90a" in cmd
    assert jax.ffi.include_dir() in cmd


@pytest.mark.gpu
def test_cuda_ladder_matches_host_build(gpu):
    pts = [_rand_point() for _ in range(64)] + [None]
    ks = [int.from_bytes(RNG.bytes(32), "little") % R for _ in range(65)]
    jac = co.affine_to_jac(co.affine_from_ints(pts))
    ss = jnp.asarray(ints_to_limbs(ks))
    got = co.jac_to_ints(jax.jit(el.scalar_mul_cuda)(jac, ss))
    assert got == co.jac_to_ints(el.scalar_mul_host(jac, ss))
