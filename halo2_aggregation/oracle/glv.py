"""GLV endomorphism constants + scalar decomposition for BN254 G1.

BN254 has j-invariant 0 and G1 cofactor 1, so the curve automorphism
phi(x, y) = (beta * x, y)  (beta a primitive cube root of unity in Fq)
acts on EVERY on-curve point as multiplication by lam (a primitive cube
root of unity in Fr, lam^2 + lam + 1 = 0 mod r).  That turns a 254-bit
scalar mul into two ~127-bit halves sharing their doublings:

    [s]P = [s1]P + [s2]phi(P),   s = s1 + s2*lam (mod r),  |s1|,|s2| < 2^127

The short lattice basis comes from the classic extended-Euclid
construction (GLV'01): run EEA on (r, lam) and take the two consecutive
remainder rows straddling sqrt(r).

No counterpart in the reference (its mul_var is a plain 254-bit ladder,
`src/multiopen.rs:393` of the reference); this is a capability this
rebuild adds to shrink the aggregation circuit.
"""

from __future__ import annotations

from math import isqrt

from ..fields import Q, R
from . import curve as oc


def _cube_root_of_unity(p: int) -> int:
    assert (p - 1) % 3 == 0
    e = (p - 1) // 3
    g = 2
    while True:
        w = pow(g, e, p)
        if w != 1:
            assert pow(w, 3, p) == 1
            return w
        g += 1


#: primitive cube root of unity in Fr; phi acts as [LAMBDA] (validated below)
LAMBDA = _cube_root_of_unity(R)
#: the matching cube root in Fq for phi(x,y) = (BETA*x, y)
BETA = _cube_root_of_unity(Q)

# pick the (beta, lam) pairing that actually satisfies phi(G) == [lam]G —
# the two nontrivial cube roots swap the eigenvalue
_G = oc.g1_generator()
if oc.g1_mul(_G, LAMBDA) != ((BETA * _G[0]) % Q, _G[1]):
    BETA = BETA * BETA % Q
    assert oc.g1_mul(_G, LAMBDA) == ((BETA * _G[0]) % Q, _G[1])


def _short_basis():
    """Two short lattice vectors (a, b) with a + b*lam == 0 (mod r)."""
    sq = isqrt(R)
    r0, r1 = R, LAMBDA
    t0, t1 = 0, 1
    rows = [(r0, -t0)]
    while r1 != 0:
        q = r0 // r1
        r0, r1 = r1, r0 - q * r1
        t0, t1 = t1, t0 - q * t1
        rows.append((r0, -t0))
    for i, (a, _) in enumerate(rows):
        if a < sq:
            # rows[i-1] >= sqrt(r) > rows[i]; candidates i and the shorter
            # of i-1 / i+1
            v1 = rows[i]
            prev_, nxt = rows[i - 1], rows[i + 1] if i + 1 < len(rows) else rows[i - 1]
            v2 = nxt if max(abs(nxt[0]), abs(nxt[1])) < max(
                abs(prev_[0]), abs(prev_[1])
            ) else prev_
            return v1, v2
    raise AssertionError("EEA produced no short vector")


_V1, _V2 = _short_basis()
#: |s1|, |s2| bound for any decomposition (used for the in-circuit range
#: check width): max coefficient magnitude of the basis, doubled for the
#: Babai rounding error
GLV_BITS = max(
    abs(_V1[0]), abs(_V1[1]), abs(_V2[0]), abs(_V2[1])
).bit_length() + 2


def decompose(s: int):
    """s (mod r) -> (sign1, |s1|, sign2, |s2|) with
    s == sign1*|s1| + sign2*|s2|*LAMBDA (mod r) and |s_i| < 2^GLV_BITS."""
    s %= R
    (a1, b1), (a2, b2) = _V1, _V2
    # Babai round-off: (c1, c2) = round([s, 0] * B^-1), det(B) = +-r
    det = a1 * b2 - a2 * b1
    c1 = _round_div(b2 * s, det)
    c2 = _round_div(-b1 * s, det)
    s1 = s - c1 * a1 - c2 * a2
    s2 = -c1 * b1 - c2 * b2
    assert (s1 + s2 * LAMBDA - s) % R == 0
    assert abs(s1) < (1 << GLV_BITS) and abs(s2) < (1 << GLV_BITS)
    return (1 if s1 >= 0 else -1, abs(s1), 1 if s2 >= 0 else -1, abs(s2))


def _round_div(a: int, b: int) -> int:
    """round(a / b) to nearest, ties toward +inf; exact integer math."""
    if b < 0:
        a, b = -a, -b
    return (2 * a + b) // (2 * b)


def phi(p):
    """The endomorphism on affine int points."""
    if p is None:
        return None
    return (BETA * p[0] % Q, p[1])
