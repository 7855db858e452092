"""Transcript round-trip and serialization tests."""

import numpy as np

from halo2_aggregation.fields import Q, R
from halo2_aggregation.oracle import curve as oc
from halo2_aggregation.utils import serialization as ser
from halo2_aggregation.utils.transcript import Blake2bRead, Blake2bWrite

RNG = np.random.default_rng(7)


def test_point_compress_roundtrip():
    g = oc.g1_generator()
    for k in [1, 2, 3, 12345, 99999]:
        p = oc.g1_mul(g, k)
        assert ser.g1_decompress(ser.g1_compress(p)) == p
    assert ser.g1_decompress(ser.g1_compress(None)) is None


def test_write_read_parity():
    g = oc.g1_generator()
    pts = [oc.g1_mul(g, k) for k in (5, 6, 7)]
    scalars = [int.from_bytes(RNG.bytes(40), "little") % R for _ in range(3)]

    w = Blake2bWrite()
    c0 = w.squeeze_challenge()
    w.write_point(pts[0])
    w.write_scalar(scalars[0])
    c1 = w.squeeze_challenge()
    w.write_point(pts[1])
    w.write_point(pts[2])
    w.write_scalar(scalars[1])
    w.write_scalar(scalars[2])
    c2 = w.squeeze_challenge()
    proof = w.finalize()

    r = Blake2bRead(proof)
    assert r.squeeze_challenge() == c0
    assert r.read_point() == pts[0]
    assert r.read_scalar() == scalars[0]
    assert r.squeeze_challenge() == c1
    assert r.read_point() == pts[1]
    assert r.read_point() == pts[2]
    assert r.read_scalar() == scalars[1]
    assert r.read_scalar() == scalars[2]
    assert r.squeeze_challenge() == c2
    # different absorb order must give a different challenge
    w2 = Blake2bWrite()
    w2.write_point(pts[1])
    assert w2.squeeze_challenge() != c1


def test_challenges_differ_and_in_field():
    w = Blake2bWrite()
    cs = [w.squeeze_challenge() for _ in range(5)]
    assert len(set(cs)) == 5
    assert all(0 <= c < R for c in cs)
