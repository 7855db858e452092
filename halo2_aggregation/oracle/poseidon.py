"""Poseidon permutation over BN254 Fr — the in-circuit-friendly sponge.

Why this exists: the reference's transcript chip witnesses Fiat-Shamir
challenges UNCONSTRAINED (`src/transcript.rs:62-65`,
"USE THIS CHIP WITH CAUTION") — the aggregation circuit proves "the
verifier algebra accepts under these witnessed challenges", not "under
the challenges the transcript actually produces".  Closing that gap
in-circuit with Blake2b would cost millions of boolean-logic rows;
Poseidon's x^5 S-box is 3 multiplication gates, so the whole transcript
becomes a few hundred thousand rows.  This module is the host-side
reference permutation; the constrained gadget lives in
aggregation/gadgets/poseidon.py and must match it bit-for-bit (pinned by
tests/test_poseidon.py).

Parameters: t = 3 (rate 2, capacity 1), alpha = 5, R_F = 8 full rounds,
R_P = 57 partial rounds — the standard 128-bit-security setting for
alpha=5, t=3 over a ~254-bit prime (Poseidon paper, Table 2 lineage).
Round constants and the MDS matrix are derived deterministically from
Blake2b in counter mode (nothing-up-my-sleeve; we need internal
prover/verifier/gadget consistency, not byte parity with any external
Poseidon instance — there is no Poseidon anywhere in the reference to
match).  The MDS is a Cauchy matrix x_i + y_j with distinct seeds, which
is invertible and (for these parameters) secure.
"""

from __future__ import annotations

import hashlib
from functools import lru_cache

from ..fields import R

T = 3
ALPHA = 5
R_F = 8
R_P = 57
RATE = T - 1


def _h2f(tag: bytes, i: int) -> int:
    """Hash-to-field: 64 bytes of Blake2b(tag, i) reduced mod r."""
    h = hashlib.blake2b(digest_size=64, person=b"H2A-Poseidon----")
    h.update(tag + i.to_bytes(4, "little"))
    return int.from_bytes(h.digest(), "little") % R


@lru_cache(maxsize=None)
def round_constants():
    """(R_F + R_P) x T round constants."""
    n = (R_F + R_P) * T
    return tuple(_h2f(b"rc", i) for i in range(n))


@lru_cache(maxsize=None)
def mds_matrix():
    """T x T Cauchy matrix M[i][j] = 1 / (x_i + y_j), x, y distinct."""
    xs = [_h2f(b"mds-x", i) for i in range(T)]
    ys = [_h2f(b"mds-y", i) for i in range(T)]
    # distinctness + no x_i + y_j == 0 (astronomically unlikely; assert)
    assert len(set(xs)) == T and len(set(ys)) == T
    m = []
    for i in range(T):
        row = []
        for j in range(T):
            s = (xs[i] + ys[j]) % R
            assert s != 0
            row.append(pow(s, R - 2, R))
        m.append(tuple(row))
    return tuple(m)


def _sbox(x: int) -> int:
    x2 = x * x % R
    x4 = x2 * x2 % R
    return x4 * x % R


def permute(state):
    """One Poseidon permutation of a T-element state (list of ints)."""
    assert len(state) == T
    s = [x % R for x in state]
    rc = round_constants()
    mds = mds_matrix()
    half = R_F // 2
    r = 0
    for phase, rounds in ((0, half), (1, R_P), (2, half)):
        for _ in range(rounds):
            s = [(x + rc[r * T + j]) % R for j, x in enumerate(s)]
            if phase == 1:
                s[0] = _sbox(s[0])  # partial round: S-box on word 0 only
            else:
                s = [_sbox(x) for x in s]
            s = [
                sum(mds[i][j] * s[j] for j in range(T)) % R for i in range(T)
            ]
            r += 1
    return s


class PoseidonSponge:
    """Duplex sponge (rate 2, capacity 1) with simple domain separation:
    capacity word initialized from a tag; absorb pads the partial rate
    block with zeros at squeeze time (fixed-length transcript use)."""

    def __init__(self, tag: bytes = b"H2A-Transcript"):
        self.state = [0, 0, _h2f(b"iv" + tag, 0)]
        self.buf: list[int] = []

    def absorb(self, x: int):
        self.buf.append(x % R)

    def _flush(self):
        for i in range(0, len(self.buf), RATE):
            block = self.buf[i : i + RATE]
            for j, v in enumerate(block):
                self.state[j] = (self.state[j] + v) % R
            self.state = permute(self.state)
        self.buf = []

    def squeeze(self) -> int:
        self._flush()
        out = self.state[0]
        # re-permute so consecutive squeezes differ
        self.state = permute(self.state)
        return out
