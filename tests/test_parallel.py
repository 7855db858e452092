"""Mesh-sharded kernels on the 8-virtual-device CPU mesh."""

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from halo2_aggregation.oracle import curve as oc
from halo2_aggregation.ops import curve_ops as co
from halo2_aggregation.ops.limbs import ints_to_limbs
from halo2_aggregation.parallel.mesh import make_mesh
from halo2_aggregation.parallel.sharded_msm import sharded_msm


def test_mesh_shapes():
    m = make_mesh(8)
    assert m.shape["dp"] * m.shape["mp"] == 8
    m2 = make_mesh(4)
    assert m2.shape["dp"] * m2.shape["mp"] == 4


@pytest.mark.slow
def test_sharded_msm_matches_oracle():
    mesh = make_mesh(8, axes=("dp", "mp"))
    mp = mesh.shape["mp"]
    n = mp * 4
    g = oc.g1_generator()
    rng = np.random.default_rng(3)
    pts_int = [oc.g1_mul(g, i + 2) for i in range(n)]
    ss_int = [int(rng.integers(1, 1 << 31)) for _ in range(n)]
    pts = co.affine_from_ints(pts_int)
    ss = jnp.asarray(ints_to_limbs(ss_int))
    total = sharded_msm(mesh, "mp", pts, ss, nbits=32)
    got = co.jac_to_ints(co.JacPoint(total.x[None], total.y[None], total.z[None]))[0]
    assert got == oc.g1_msm(pts_int, ss_int)


@pytest.fixture(scope="module")
def proofs_k9():
    from halo2_aggregation.models import simple_example as se
    from halo2_aggregation.plonk import kzg
    from halo2_aggregation.plonk.keygen import keygen
    from halo2_aggregation.plonk.prover import create_proof

    params = kzg.setup(9)
    circuit = se.MyCircuit(constant=7, a=2, b=3)
    cs_e, _, asg_e = se.build(circuit.without_witnesses(), k=9)
    vk, pk = keygen(params, cs_e, asg_e)
    proofs, insts = [], []
    for a, b in [(2, 3), (4, 5)]:
        c = se.MyCircuit(constant=7, a=a, b=b)
        _, _, asg = se.build(c, k=9)
        pub = [c.public_output()]
        proofs.append(create_proof(params, pk, asg, [pub], seed=60 + a))
        insts.append([pub])
    return params, vk, insts, proofs


@pytest.mark.slow
def test_sharded_field_algebra_matches_unsharded(proofs_k9):
    from halo2_aggregation.parallel.batch_verify import (
        sharded_field_algebra,
    )
    from halo2_aggregation.plonk.verifier import parse_proof
    from halo2_aggregation.plonk.device_verifier import (
        batch_proofs,
        field_algebra,
    )

    params, vk, insts, proofs = proofs_k9
    B = 4
    parsed = [
        parse_proof(
            vk,
            [params.commit_lagrange(col) for col in insts[i % 2]],
            proofs[i % 2],
        )
        for i in range(B)
    ]
    batch = batch_proofs(vk, parsed)
    mesh = make_mesh(8)
    h_sharded, _, _ = sharded_field_algebra(mesh, vk, batch, B)
    h_plain, _, _ = field_algebra(vk, batch, B)
    assert np.array_equal(np.asarray(h_sharded), np.asarray(h_plain))


@pytest.mark.slow
def test_shmap_verify_algebra_fast_matches_host(proofs_k9):
    """The shard_map formulation (driver dryrun path: explicit all_gather
    collectives over mp, no GSPMD pass) produces the host verifier's quad
    bit-exactly."""
    from halo2_aggregation.parallel.batch_verify import (
        shmap_verify_algebra_fast,
    )
    from halo2_aggregation.plonk.verifier import parse_proof, verify_proof
    from halo2_aggregation.plonk.device_verifier import batch_proofs

    params, vk, insts, proofs = proofs_k9
    mesh = make_mesh(8)
    B = mesh.shape["dp"]
    parsed = [
        parse_proof(
            vk,
            [params.commit_lagrange(col) for col in insts[i % 2]],
            proofs[i % 2],
        )
        for i in range(B)
    ]
    batch = batch_proofs(vk, parsed)
    out = shmap_verify_algebra_fast(mesh, vk, batch, parsed)
    quads = {n: co.jac_to_ints(out[n]) for n in ("e", "f", "w", "zw")}
    for i in range(B):
        ok, efw = verify_proof(params, vk, insts[i % 2], proofs[i % 2])
        assert ok
        got = (quads["e"][i], quads["f"][i], quads["w"][i], quads["zw"][i])
        assert got == tuple(efw), f"shmap quad mismatch at proof {i}"


def test_sharded_msm_program_is_built_once():
    from halo2_aggregation.parallel.sharded_msm import _sharded_msm_step

    mesh = make_mesh(8, axes=("dp", "mp"))
    assert _sharded_msm_step(mesh, "mp", 32) is _sharded_msm_step(mesh, "mp", 32)
    assert _sharded_msm_step(mesh, "mp", 32) is not _sharded_msm_step(mesh, "mp", 64)
