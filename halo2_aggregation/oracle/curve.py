"""Python-int BN254 G1/G2 group law — the CPU oracle for the device curve ops.

Points are affine ``(x, y)`` tuples or ``None`` for the identity.  This is
the trusted reference for `ops/curve_ops.py` and `ops/msm.py`, playing the
role the halo2wrong `BaseFieldEccChip` plays for the reference
(`src/verifier.rs:156-174` uses it for all EC arithmetic).
"""

from __future__ import annotations

from ..fields import Q, CURVE_B, G1_GEN, R as R_ORDER


def g1_is_on_curve(p):
    if p is None:
        return True
    x, y = p
    return (y * y - x * x * x - CURVE_B) % Q == 0


def g1_neg(p):
    if p is None:
        return None
    x, y = p
    return (x, (-y) % Q)


def g1_add(p, q):
    if p is None:
        return q
    if q is None:
        return p
    x1, y1 = p
    x2, y2 = q
    if x1 == x2:
        if (y1 + y2) % Q == 0:
            return None
        # doubling
        lam = (3 * x1 * x1) * pow(2 * y1, Q - 2, Q) % Q
    else:
        lam = (y2 - y1) * pow(x2 - x1, Q - 2, Q) % Q
    x3 = (lam * lam - x1 - x2) % Q
    y3 = (lam * (x1 - x3) - y1) % Q
    return (x3, y3)


def g1_double(p):
    return g1_add(p, p)


def g1_mul(p, k: int):
    k = int(k)
    acc = None
    add = p
    while k:
        if k & 1:
            acc = g1_add(acc, add)
        add = g1_add(add, add)
        k >>= 1
    return acc


# -- Jacobian helpers (host perf: no per-add inversion) ---------------------


def _jac_add(p, q):
    if p is None:
        return q
    if q is None:
        return p
    x1, y1, z1 = p
    x2, y2, z2 = q
    z1z1 = z1 * z1 % Q
    z2z2 = z2 * z2 % Q
    u1 = x1 * z2z2 % Q
    u2 = x2 * z1z1 % Q
    s1 = y1 * z2 % Q * z2z2 % Q
    s2 = y2 * z1 % Q * z1z1 % Q
    if u1 == u2:
        if (s1 + s2) % Q == 0:
            return None
        return _jac_double(p)
    h = (u2 - u1) % Q
    r = (s2 - s1) % Q
    h2 = h * h % Q
    h3 = h2 * h % Q
    u1h2 = u1 * h2 % Q
    x3 = (r * r - h3 - 2 * u1h2) % Q
    y3 = (r * (u1h2 - x3) - s1 * h3) % Q
    z3 = z1 * z2 % Q * h % Q
    return (x3, y3, z3)


def _jac_double(p):
    if p is None:
        return None
    x1, y1, z1 = p
    a = x1 * x1 % Q
    b = y1 * y1 % Q
    c = b * b % Q
    d = 2 * ((x1 + b) * (x1 + b) - a - c) % Q
    e = 3 * a % Q
    f = e * e % Q
    x3 = (f - 2 * d) % Q
    y3 = (e * (d - x3) - 8 * c) % Q
    z3 = 2 * y1 * z1 % Q
    return (x3, y3, z3)


def _to_jac(p):
    return None if p is None else (p[0], p[1], 1)


def _from_jac(p):
    if p is None or p[2] == 0:
        return None
    zinv = pow(p[2], -1, Q)
    zi2 = zinv * zinv % Q
    return (p[0] * zi2 % Q, p[1] * zi2 % Q * zinv % Q)


def g1_msm(points, scalars):
    """Windowed (Pippenger) MSM with Jacobian accumulation — the fast host
    oracle behind commit_lagrange when device MSM is off."""
    pairs = [(p, int(s)) for p, s in zip(points, scalars, strict=True) if p is not None and int(s) % R_ORDER]
    if not pairs:
        return None
    c = 8 if len(pairs) >= 32 else 4
    nwin = (254 + c - 1) // c
    acc = None
    for w in range(nwin - 1, -1, -1):
        if acc is not None:
            for _ in range(c):
                acc = _jac_double(acc)
        buckets = {}
        shift = w * c
        mask = (1 << c) - 1
        for p, s in pairs:
            d = (s >> shift) & mask
            if d:
                buckets[d] = _jac_add(buckets.get(d), _to_jac(p))
        # sum_b b * bucket[b] via descending suffix sums
        run = None
        tot = None
        for b in range(max(buckets, default=0), 0, -1):
            if b in buckets:
                run = _jac_add(run, buckets[b])
            tot = _jac_add(tot, run)
        acc = _jac_add(acc, tot)
    return _from_jac(acc)


def g1_generator():
    return G1_GEN


# ---------------------------------------------------------------------------
# Fq2 arithmetic + G2 group law (needed for the KZG pairing check's [tau]_2)
# ---------------------------------------------------------------------------


def fq2_add(a, b):
    return ((a[0] + b[0]) % Q, (a[1] + b[1]) % Q)


def fq2_sub(a, b):
    return ((a[0] - b[0]) % Q, (a[1] - b[1]) % Q)


def fq2_neg(a):
    return ((-a[0]) % Q, (-a[1]) % Q)


def fq2_mul(a, b):
    # (a0 + a1 u)(b0 + b1 u), u^2 = -1
    t0 = a[0] * b[0] % Q
    t1 = a[1] * b[1] % Q
    t2 = (a[0] + a[1]) * (b[0] + b[1]) % Q
    return ((t0 - t1) % Q, (t2 - t0 - t1) % Q)


def fq2_scalar(a, k: int):
    return (a[0] * k % Q, a[1] * k % Q)


def fq2_inv(a):
    # 1/(a0 + a1 u) = (a0 - a1 u)/(a0^2 + a1^2)
    norm = (a[0] * a[0] + a[1] * a[1]) % Q
    inv = pow(norm, Q - 2, Q)
    return (a[0] * inv % Q, (-a[1]) * inv % Q)


FQ2_ZERO = (0, 0)
FQ2_ONE = (1, 0)


def g2_add(p, q):
    if p is None:
        return q
    if q is None:
        return p
    x1, y1 = p
    x2, y2 = q
    if x1 == x2:
        if fq2_add(y1, y2) == FQ2_ZERO:
            return None
        num = fq2_scalar(fq2_mul(x1, x1), 3)
        den = fq2_inv(fq2_scalar(y1, 2))
        lam = fq2_mul(num, den)
    else:
        lam = fq2_mul(fq2_sub(y2, y1), fq2_inv(fq2_sub(x2, x1)))
    x3 = fq2_sub(fq2_sub(fq2_mul(lam, lam), x1), x2)
    y3 = fq2_sub(fq2_mul(lam, fq2_sub(x1, x3)), y1)
    return (x3, y3)


def g2_mul(p, k: int):
    k = int(k)
    acc = None
    add = p
    while k:
        if k & 1:
            acc = g2_add(acc, add)
        add = g2_add(add, add)
        k >>= 1
    return acc


def g2_generator():
    from ..fields import G2_GEN_X, G2_GEN_Y

    return (G2_GEN_X, G2_GEN_Y)
