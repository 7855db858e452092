"""The device verifier: batched verification algebra over limb arrays.

This is the flagship compute path (BASELINE configs 1-3): after the host
replays the Fiat-Shamir transcript (parse_proof), every remaining step of
the reference verifier — Lagrange l_evals, gate/permutation/lookup
expression evaluation, the y-fold and h reconstruction, and the GWC
multiopen EC folds (`src/verifier.rs:512-762`,
`src/multiopen.rs:271-509`) — runs as batched JAX ops over
``(B, 32)``-shaped limb arrays: B proofs verified in lockstep, one
compiled program per (vk, batch-size).

Every op is batch-polymorphic, so scaling across chips is just sharding
the B axis (parallel/batch_verify.py).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List

import jax
import jax.numpy as jnp
import numpy as np

from ..fields import G1_GEN, R
from ..ops import curve_ops as co
from ..ops import field_ops as fo
from ..ops.ec_ladder import scalar_mul_lanes
from ..ops.limbs import ints_to_limbs
from .keygen import VerifyingKey
from .protocol import (
    LimbOps,
    LookupEvals,
    PermutationSetEvals,
    fold_y,
    gate_expressions,
    lookup_expressions,
    permutation_expressions,
    query_schedule,
    rotation_sets,
)
from .verifier import ParsedProof, num_perm_chunks

FR = fo.FR
FQ = fo.FQ


def _scalars_to_batch(vals: List[int]):
    """(B,) ints -> (B, 32) Montgomery limb array."""
    return jnp.asarray(FR.to_mont_array(vals))


def _points_to_batch(pts: List):
    """(B,) oracle points -> batched JacPoint."""
    return co.affine_to_jac(co.affine_from_ints(pts))


@jax.tree_util.register_dataclass
@dataclass
class VerifierBatch:
    """Batched device-side inputs for B proofs under one vk."""

    # challenges, (B, 32) mont
    theta: object
    beta: object
    gamma: object
    y: object
    x: object
    v: object
    u: object
    # evals, lists of (B, 32) mont
    inst_evals: list
    adv_evals: list
    fix_evals: list
    r_eval: object
    sigma_evals: list
    perm_sets: list  # of PermutationSetEvals with (B,32) leaves
    lookup_evs: list  # of LookupEvals with (B,32) leaves
    # points, JacPoint with (B, 32) coords
    inst_comms: list
    adv_comms: list
    lookups_permuted: list  # (A', S') pairs
    perm_z_comms: list
    lookup_z_comms: list
    r_comm: object
    h_comms: list
    w_comms: list


def batch_proofs(vk: VerifyingKey, parsed: List[ParsedProof]) -> VerifierBatch:
    cs = vk.cs
    num_chunks = num_perm_chunks(cs)

    def S(get):  # scalar field
        return _scalars_to_batch([get(p) for p in parsed])

    def P(get):  # point field
        return _points_to_batch([get(p) for p in parsed])

    perm_sets = []
    for ci in range(num_chunks):
        perm_sets.append(
            PermutationSetEvals(
                z=S(lambda p: p.perm_sets[ci].z),
                z_next=S(lambda p: p.perm_sets[ci].z_next),
                z_last=(
                    S(lambda p: p.perm_sets[ci].z_last)
                    if ci < num_chunks - 1
                    else None
                ),
            )
        )
    lookup_evs = []
    for li in range(len(cs.lookups)):
        lookup_evs.append(
            LookupEvals(
                z=S(lambda p: p.lookup_evs[li].z),
                z_next=S(lambda p: p.lookup_evs[li].z_next),
                a_prime=S(lambda p: p.lookup_evs[li].a_prime),
                a_prime_prev=S(lambda p: p.lookup_evs[li].a_prime_prev),
                s_prime=S(lambda p: p.lookup_evs[li].s_prime),
            )
        )
    return VerifierBatch(
        theta=S(lambda p: p.theta),
        beta=S(lambda p: p.beta),
        gamma=S(lambda p: p.gamma),
        y=S(lambda p: p.y),
        x=S(lambda p: p.x),
        v=S(lambda p: p.v),
        u=S(lambda p: p.u),
        inst_evals=[S(lambda p, i=i: p.inst_evals[i]) for i in range(len(cs.instance_queries))],
        adv_evals=[S(lambda p, i=i: p.adv_evals[i]) for i in range(len(cs.advice_queries))],
        fix_evals=[S(lambda p, i=i: p.fix_evals[i]) for i in range(len(cs.fixed_queries))],
        r_eval=S(lambda p: p.r_eval),
        sigma_evals=[
            S(lambda p, i=i: p.sigma_evals[i])
            for i in range(len(cs.permutation_columns))
        ],
        perm_sets=perm_sets,
        lookup_evs=lookup_evs,
        inst_comms=[P(lambda p, i=i: p.inst_comms[i]) for i in range(cs.num_instance_columns)],
        adv_comms=[P(lambda p, i=i: p.adv_comms[i]) for i in range(cs.num_advice_columns)],
        lookups_permuted=[
            (
                P(lambda p, i=i: p.lookups_permuted[i][0]),
                P(lambda p, i=i: p.lookups_permuted[i][1]),
            )
            for i in range(len(cs.lookups))
        ],
        perm_z_comms=[P(lambda p, i=i: p.perm_z_comms[i]) for i in range(num_chunks)],
        lookup_z_comms=[P(lambda p, i=i: p.lookup_z_comms[i]) for i in range(len(cs.lookups))],
        r_comm=P(lambda p: p.r_comm),
        h_comms=[
            P(lambda p, i=i: p.h_comms[i]) for i in range(cs.quotient_poly_degree())
        ],
        w_comms=[P(lambda p, i=i: p.w_comms[i]) for i in range(len(parsed[0].w_comms))],
    )


def _ec_mul_mont(point: co.JacPoint, scalar_mont):
    """Scalar mul where the scalar arrives in Montgomery form: decode to
    plain limbs on device, then the 254-bit ladder (CUDA on the GPU, the
    XLA scan on the CPU)."""
    plain = fo.from_mont(scalar_mont, FR)
    return scalar_mul_lanes(point, plain, 254)


def field_algebra(vk: VerifyingKey, b: VerifierBatch, batch: int):
    """Device-side steps 20-24 (the pure Fr work): x^n, Lagrange l_evals,
    gate/permutation/lookup expressions, y-fold, h_eval.  Returns
    (h_eval, xn, xn_sub_one) as (B, 32) mont arrays."""
    cs = vk.cs
    n = vk.n
    k = vk.k
    omega = vk.omega
    omega_inv = pow(omega, -1, R)
    bf = cs.blinding_factors()
    chunk_len = cs.degree() - 2
    ops = LimbOps()

    def const(v: int):
        return jnp.broadcast_to(jnp.asarray(FR.to_mont(v)), (batch, fo.NLIMBS))

    # --- step 20: x^n by k squarings; l_evals by batched field inversion ---
    xn = b.x
    for _ in range(k):
        xn = fo.mont_sq(xn, FR)
    xn_sub_one = fo.sub(xn, const(1), FR)
    l_evals = []
    w_pow = 1
    denoms = []
    numers = []
    for i in range(2 + bf):
        numers.append(fo.mont_mul(xn_sub_one, const(w_pow), FR))
        # n * (x - w^i')
        term = fo.sub(b.x, const(w_pow), FR)
        denoms.append(fo.mont_mul(term, const(n), FR))
        w_pow = w_pow * omega_inv % R
    dstack = jnp.stack(denoms)  # (2+bf, B, 32)
    dinv = fo.inv(dstack, FR)
    for i in range(2 + bf):
        l_evals.append(fo.mont_mul(numers[i], dinv[i], FR))
    l_evals.reverse()
    l_last = l_evals[0]
    l_blind = l_evals[1]
    for i in range(2, 1 + bf):
        l_blind = fo.add(l_blind, l_evals[i], FR)
    l_0 = l_evals[1 + bf]

    # --- steps 21-23: expression evaluation (shared protocol formulas) -----
    exprs = gate_expressions(ops, cs, b.adv_evals, b.fix_evals, b.inst_evals)
    exprs += permutation_expressions(
        ops,
        cs,
        b.perm_sets,
        b.sigma_evals,
        b.adv_evals,
        b.fix_evals,
        b.inst_evals,
        l_0,
        l_last,
        l_blind,
        b.beta,
        b.gamma,
        b.x,
        chunk_len,
    )
    for arg, ev in zip(cs.lookups, b.lookup_evs):
        exprs += lookup_expressions(
            ops,
            ev,
            arg,
            l_0,
            l_last,
            l_blind,
            b.theta,
            b.beta,
            b.gamma,
            b.adv_evals,
            b.fix_evals,
            b.inst_evals,
        )

    # --- step 24 (first half): h_eval (vanishing.rs:146-175) ---------------
    h_eval = fold_y(ops, exprs, b.y)
    h_eval = fo.mont_mul(h_eval, fo.inv(xn_sub_one, FR), FR)
    return h_eval, xn, xn_sub_one


def verify_algebra(vk: VerifyingKey, b: VerifierBatch, batch: int):
    """Device-side steps 20-27 of SURVEY.md §3.2 for B proofs at once,
    with EC folds done sequentially exactly as the reference does them
    (the parity-reference path; verify_algebra_fast is the production
    path).  Returns the quad (e, f, w, zw) as batched JacPoints."""
    cs = vk.cs
    omega = vk.omega
    omega_inv = pow(omega, -1, R)
    num_chunks = num_perm_chunks(cs)

    def const(v: int):
        return jnp.broadcast_to(jnp.asarray(FR.to_mont(v)), (batch, fo.NLIMBS))

    h_eval, xn, xn_sub_one = field_algebra(vk, b, batch)

    # --- step 24 (second half): the H fold (vanishing.rs:177-188) ----------
    H = b.h_comms[0]
    xn_power = xn
    for hc in b.h_comms[1:]:
        term = _ec_mul_mont(hc, xn_power)
        xn_power = fo.mont_mul(xn_power, xn, FR)
        H = co.jac_add(H, term)

    # --- step 25: resolve queries (constant commitments from the vk) -------
    fixed_comms_dev = [
        _points_to_batch([c] * batch) for c in vk.fixed_commitments
    ]
    sigma_comms_dev = [
        _points_to_batch([c] * batch) for c in vk.sigma_commitments
    ]
    sched = query_schedule(cs, num_chunks, len(cs.lookups))
    resolved = []
    for q in sched:
        if q.kind == "instance":
            col, _ = cs.instance_queries[q.index]
            resolved.append((q, b.inst_comms[col.index], b.inst_evals[q.index]))
        elif q.kind == "advice":
            col, _ = cs.advice_queries[q.index]
            resolved.append((q, b.adv_comms[col.index], b.adv_evals[q.index]))
        elif q.kind == "fixed":
            col, _ = cs.fixed_queries[q.index]
            resolved.append((q, fixed_comms_dev[col.index], b.fix_evals[q.index]))
        elif q.kind == "perm_z":
            ev = b.perm_sets[q.index]
            resolved.append(
                (q, b.perm_z_comms[q.index], ev.z if q.rotation == 0 else ev.z_next)
            )
        elif q.kind == "perm_z_last":
            resolved.append((q, b.perm_z_comms[q.index], b.perm_sets[q.index].z_last))
        elif q.kind == "lookup_z":
            ev = b.lookup_evs[q.index]
            resolved.append(
                (q, b.lookup_z_comms[q.index], ev.z if q.rotation == 0 else ev.z_next)
            )
        elif q.kind == "lookup_a":
            ev = b.lookup_evs[q.index]
            resolved.append(
                (
                    q,
                    b.lookups_permuted[q.index][0],
                    ev.a_prime if q.rotation == 0 else ev.a_prime_prev,
                )
            )
        elif q.kind == "lookup_s":
            resolved.append(
                (q, b.lookups_permuted[q.index][1], b.lookup_evs[q.index].s_prime)
            )
        elif q.kind == "sigma":
            resolved.append((q, sigma_comms_dev[q.index], b.sigma_evals[q.index]))
        elif q.kind == "vanishing_h":
            resolved.append((q, H, h_eval))
        elif q.kind == "vanishing_r":
            resolved.append((q, b.r_comm, b.r_eval))
        else:
            raise KeyError(q.kind)

    # --- step 27: GWC multiopen fold (multiopen.rs:271-509) ----------------
    by_rot = {}
    for q, comm, ev in resolved:
        by_rot.setdefault(q.rotation, []).append((comm, ev))

    eval_multi = const(0)
    Ws, ZWs, Fs = [], [], []
    for set_i, rot in enumerate(sorted(by_rot)):
        w_exp = pow(omega, rot, R) if rot >= 0 else pow(omega_inv, -rot, R)
        z_pt = fo.mont_mul(b.x, const(w_exp), FR)
        wi = b.w_comms[set_i]
        z_wi = _ec_mul_mont(wi, z_pt)
        Ws.append(wi)
        ZWs.append(z_wi)
        eval_multi = fo.mont_mul(eval_multi, b.u, FR)
        entries = by_rot[rot]
        batch_c, batch_e = entries[0]
        for comm, ev in entries[1:]:
            batch_c = co.jac_add(_ec_mul_mont(batch_c, b.v), comm)
            batch_e = fo.add(fo.mont_mul(batch_e, b.v, FR), ev, FR)
        Fs.append(batch_c)
        eval_multi = fo.add(eval_multi, batch_e, FR)

    def fold_pts(pts):
        acc = pts[0]
        for pt in pts[1:]:
            acc = co.jac_add(_ec_mul_mont(acc, b.u), pt)
        return acc

    w_pt = fold_pts(Ws)
    zw_pt = fold_pts(ZWs)
    f_pt = fold_pts(Fs)
    g1 = _points_to_batch([G1_GEN] * batch)
    e_pt = _ec_mul_mont(g1, fo.neg(eval_multi, FR))

    return {"e": e_pt, "f": f_pt, "w": w_pt, "zw": zw_pt, "h_eval": h_eval}


def _multiopen_coefficients(vk: VerifyingKey, p: ParsedProof):
    """Host-side: expand the GWC folds into explicit linear combinations.

    Every output point of the multiopen (w, zw, f) is a linear combination
    of transcript/vk points whose coefficients are products of u/v powers,
    z_i, and x^n powers — all host-known after transcript replay.  e is
    -(eval_multi) * G1, where eval_multi splits into a host-known part and
    one h_eval-dependent term (h_eval is the only device-computed eval).

    Lane points are returned as DESCRIPTORS, not coordinates: the lane
    structure is vk-static, and every descriptor names either a transcript
    point that already lives (Montgomery-converted) in the VerifierBatch
    or a vk constant — so the device step can GATHER the lane points with
    a trace-time stack instead of the host re-converting B*M points per
    batch (the round-2 `fast_prep` hot spot, VERDICT r2 item 4).

    Returns dict with per-component [(descriptor, scalar)] lane lists plus
    the coefficient of h_eval inside eval_multi."""
    cs = vk.cs
    omega = vk.omega
    omega_inv = pow(omega, -1, R)
    x, u, v = p.x, p.u, p.v
    xn = pow(x, vk.n, R)
    num_chunks = num_perm_chunks(cs)
    sched = query_schedule(cs, num_chunks, len(cs.lookups))

    # resolve each query to (list of (descriptor, base_coeff)) and eval
    # (int or the marker "h_eval")
    def resolve(q):
        if q.kind == "instance":
            col, _ = cs.instance_queries[q.index]
            return [(("inst", col.index), 1)], p.inst_evals[q.index]
        if q.kind == "advice":
            col, _ = cs.advice_queries[q.index]
            return [(("adv", col.index), 1)], p.adv_evals[q.index]
        if q.kind == "fixed":
            col, _ = cs.fixed_queries[q.index]
            return [(("fixed", col.index), 1)], p.fix_evals[q.index]
        if q.kind == "perm_z":
            ev = p.perm_sets[q.index]
            return [(("perm_z", q.index), 1)], (
                ev.z if q.rotation == 0 else ev.z_next
            )
        if q.kind == "perm_z_last":
            return [(("perm_z", q.index), 1)], p.perm_sets[q.index].z_last
        if q.kind == "lookup_z":
            ev = p.lookup_evs[q.index]
            return [(("lookup_z", q.index), 1)], (
                ev.z if q.rotation == 0 else ev.z_next
            )
        if q.kind == "lookup_a":
            ev = p.lookup_evs[q.index]
            return [(("lookup_a", q.index), 1)], (
                ev.a_prime if q.rotation == 0 else ev.a_prime_prev
            )
        if q.kind == "lookup_s":
            return [(("lookup_s", q.index), 1)], p.lookup_evs[
                q.index
            ].s_prime
        if q.kind == "sigma":
            return [(("sigma", q.index), 1)], p.sigma_evals[q.index]
        if q.kind == "vanishing_h":
            # H = sum_l (x^n)^l h_l  (vanishing.rs:177-188)
            lanes = []
            c = 1
            for l in range(len(p.h_comms)):
                lanes.append((("h", l), c))
                c = c * xn % R
            return lanes, "h_eval"
        if q.kind == "vanishing_r":
            return [(("r", 0), 1)], p.r_eval
        raise KeyError(q.kind)

    by_rot = {}
    for q in sched:
        by_rot.setdefault(q.rotation, []).append(q)
    rots = sorted(by_rot)
    K = len(rots)

    w_lanes, zw_lanes, f_lanes = [], [], []
    eval_known = 0
    h_coeff = 0
    for i, rot in enumerate(rots):
        upow = pow(u, K - 1 - i, R)
        z_i = (
            x * pow(omega, rot, R) % R
            if rot >= 0
            else x * pow(omega_inv, -rot, R) % R
        )
        w_lanes.append((("w", i), upow))
        zw_lanes.append((("w", i), upow * z_i % R))
        qs = by_rot[rot]
        m = len(qs)
        for j, q in enumerate(qs):
            vpow = pow(v, m - 1 - j, R)
            coeff = upow * vpow % R
            lanes, ev = resolve(q)
            for desc, c in lanes:
                f_lanes.append((desc, coeff * c % R))
            if ev == "h_eval":
                h_coeff = (h_coeff + coeff) % R
            else:
                eval_known = (eval_known + coeff * ev) % R

    return {
        "w": w_lanes,
        "zw": zw_lanes,
        "f": f_lanes,
        "eval_known": eval_known,
        "h_coeff": h_coeff,
    }


def _desc_point_ints(vk: VerifyingKey, p: ParsedProof, desc):
    """Resolve a lane descriptor to host int coordinates (used by the
    coordinate-materializing `fast_prep` that the mesh paths consume)."""
    kind, idx = desc
    if kind == "w":
        return p.w_comms[idx]
    if kind == "inst":
        return p.inst_comms[idx]
    if kind == "adv":
        return p.adv_comms[idx]
    if kind == "fixed":
        return vk.fixed_commitments[idx]
    if kind == "sigma":
        return vk.sigma_commitments[idx]
    if kind == "perm_z":
        return p.perm_z_comms[idx]
    if kind == "lookup_z":
        return p.lookup_z_comms[idx]
    if kind == "lookup_a":
        return p.lookups_permuted[idx][0]
    if kind == "lookup_s":
        return p.lookups_permuted[idx][1]
    if kind == "h":
        return p.h_comms[idx]
    if kind == "r":
        return p.r_comm
    raise KeyError(kind)


def _desc_point_batch(vk: VerifyingKey, b: VerifierBatch, desc, B: int):
    """Resolve a lane descriptor to a (B, 32) batched JacPoint at trace
    time — transcript points come straight from the VerifierBatch (already
    Montgomery limbs on device); vk constants are converted fresh per
    trace.  Deliberately NOT cached across calls: the jit above already
    traces once per (vk, B, descs), and a cross-trace dict here stored
    DynamicJaxprTracers from the first trace and poisoned every later
    trace sharing the vk (UnexpectedTracerError seen when the sharded
    and single-chip paths ran in one process)."""
    kind, idx = desc
    if kind == "w":
        return b.w_comms[idx]
    if kind == "inst":
        return b.inst_comms[idx]
    if kind == "adv":
        return b.adv_comms[idx]
    if kind in ("fixed", "sigma"):
        pts = vk.fixed_commitments if kind == "fixed" else vk.sigma_commitments
        c = _points_to_batch([pts[idx]])
        bc = lambda a: jnp.broadcast_to(a, (B, fo.NLIMBS))
        return co.JacPoint(bc(c.x), bc(c.y), bc(c.z))
    if kind == "perm_z":
        return b.perm_z_comms[idx]
    if kind == "lookup_z":
        return b.lookup_z_comms[idx]
    if kind == "lookup_a":
        return b.lookups_permuted[idx][0]
    if kind == "lookup_s":
        return b.lookups_permuted[idx][1]
    if kind == "h":
        return b.h_comms[idx]
    if kind == "r":
        return b.r_comm
    raise KeyError(kind)


def fast_prep(vk: VerifyingKey, parsed: List[ParsedProof], lane_pad: int = 1):
    """Host half of the MESH production path: expand the GWC folds into one
    (B, M) lane array of (point, scalar) pairs (+ the h_eval linear data),
    materializing lane-point coordinates host-side so they can be
    device_put with explicit shardings.  `lane_pad` pads M up to a multiple
    (identity points, zero scalars) so the lane axis can shard evenly over
    an `mp` mesh axis.  (The single-chip path uses `fast_prep_gathered`,
    which skips the host point materialization entirely.)"""
    B = len(parsed)
    coeffs = [_multiopen_coefficients(vk, p) for p in parsed]
    names = ("w", "zw", "f")
    ms = []
    pts_cat, ss_cat = [], []
    for name in names:
        pts = [
            [_desc_point_ints(vk, p, d) for d, s in c[name]]
            for c, p in zip(coeffs, parsed)
        ]
        ss = [[s for d, s in c[name]] for c in coeffs]
        m = len(pts[0])
        pad = (-m) % lane_pad
        ms.append(m + pad)
        for row_p, row_s in zip(pts, ss):
            row_p.extend([None] * pad)
            row_s.extend([0] * pad)
        pts_cat.append(pts)
        ss_cat.append(ss)
    m_tot = sum(ms)
    flat_pts = [
        pt for b_i in range(B) for comp in pts_cat for pt in comp[b_i]
    ]
    flat_ss = [s for b_i in range(B) for comp in ss_cat for s in comp[b_i]]
    aff = co.affine_from_ints(flat_pts)
    lane_pts = co.affine_to_jac(
        co.AffinePoint(
            aff.x.reshape(B, m_tot, fo.NLIMBS),
            aff.y.reshape(B, m_tot, fo.NLIMBS),
            aff.inf.reshape(B, m_tot),
        )
    )
    lane_scalars = jnp.asarray(
        np.asarray(ints_to_limbs(flat_ss)).reshape(B, m_tot, fo.NLIMBS)
    )
    h_coeff_mont = jnp.asarray(FR.to_mont_array([c["h_coeff"] for c in coeffs]))
    known_mont = jnp.asarray(FR.to_mont_array([c["eval_known"] for c in coeffs]))
    return lane_pts, lane_scalars, tuple(ms), h_coeff_mont, known_mont


def fast_prep_gathered(vk: VerifyingKey, parsed: List[ParsedProof]):
    """Host half of the SINGLE-CHIP production path: only the per-lane
    scalars (a few dozen bigint products per proof) plus two (B, 32)
    h_eval-linearization vectors leave the host — lane POINTS are gathered
    from the VerifierBatch inside the jitted step (`fast_device_gathered`),
    eliminating the B*M host point conversions that dominated round-2's
    prep stage (VERDICT r2 item 4).

    Returns (descs, lane_scalars, h_coeff_mont, known_mont); `descs` is
    the vk-static per-component lane structure (hashable, part of the jit
    key)."""
    B = len(parsed)
    coeffs = [_multiopen_coefficients(vk, p) for p in parsed]
    names = ("w", "zw", "f")
    descs = tuple(
        tuple(d for d, _ in coeffs[0][name]) for name in names
    )
    flat_ss = [
        s for c in coeffs for name in names for _, s in c[name]
    ]
    m_tot = sum(len(comp) for comp in descs)
    lane_scalars = jnp.asarray(
        np.asarray(ints_to_limbs(flat_ss)).reshape(B, m_tot, fo.NLIMBS)
    )
    h_coeff_mont = jnp.asarray(FR.to_mont_array([c["h_coeff"] for c in coeffs]))
    known_mont = jnp.asarray(FR.to_mont_array([c["eval_known"] for c in coeffs]))
    return descs, lane_scalars, h_coeff_mont, known_mont


def fast_device_gathered(
    vk: VerifyingKey,
    b: VerifierBatch,
    B: int,
    descs: tuple,
    lane_scalars,
    h_coeff_mont,
    known_mont,
):
    """Device half of the gathered path: stack the lane points out of the
    VerifierBatch (a trace-time gather — XLA sees a concat of input
    buffers, no host conversion), then run the standard fast_device."""
    ms = tuple(len(comp) for comp in descs)
    pts = [
        _desc_point_batch(vk, b, d, B) for comp in descs for d in comp
    ]
    lane_pts = co.JacPoint(
        jnp.stack([p.x for p in pts], 1),
        jnp.stack([p.y for p in pts], 1),
        jnp.stack([p.z for p in pts], 1),
    )
    return fast_device(
        vk, b, B, ms, lane_pts, lane_scalars, h_coeff_mont, known_mont
    )


def fast_device(
    vk: VerifyingKey,
    b: VerifierBatch,
    B: int,
    ms: tuple,
    lane_pts: co.JacPoint,
    lane_scalars,
    h_coeff_mont,
    known_mont,
):
    """Device half (jittable, shardable: B over `dp`, lanes over `mp`):
    field algebra for h_eval + ONE batched ladder over every multiopen
    lane INCLUDING the e-component (e = -(eval_known + h_coeff*h_eval)*G1
    — its device-computed scalar is ready before the ladder, so it rides
    the same kernel call instead of paying a second dispatch), then
    per-component tree sums."""
    h_eval, _, _ = field_algebra(vk, b, B)

    # e-lane scalar: -(eval_known + h_coeff * h_eval), decoded to plain limbs
    eval_multi = fo.add(
        fo.mont_mul(h_coeff_mont, h_eval, FR), known_mont, FR
    )
    e_scalar = fo.from_mont(fo.neg(eval_multi, FR), FR)[:, None, :]  # (B,1,32)
    g1 = _points_to_batch([G1_GEN] * B)
    all_pts = co.JacPoint(
        jnp.concatenate([lane_pts.x, g1.x[:, None, :]], axis=1),
        jnp.concatenate([lane_pts.y, g1.y[:, None, :]], axis=1),
        jnp.concatenate([lane_pts.z, g1.z[:, None, :]], axis=1),
    )
    all_scalars = jnp.concatenate([lane_scalars, e_scalar], axis=1)
    per_all = scalar_mul_lanes(all_pts, all_scalars, 254)

    quads = {}
    off = 0
    for name, m in zip(("w", "zw", "f"), ms):
        per = co.JacPoint(
            per_all.x[:, off : off + m],
            per_all.y[:, off : off + m],
            per_all.z[:, off : off + m],
        )
        off += m
        trans = co.JacPoint(
            jnp.moveaxis(per.x, 1, 0), jnp.moveaxis(per.y, 1, 0), jnp.moveaxis(per.z, 1, 0)
        )
        quads[name] = co.jac_sum(trans)

    quads["e"] = co.JacPoint(
        per_all.x[:, off], per_all.y[:, off], per_all.z[:, off]
    )
    quads["h_eval"] = h_eval
    return quads


_FAST_GATHERED_JIT = {}


def _fast_device_gathered_jitted(vk: VerifyingKey, B: int, descs: tuple):
    """Jitted gathered step: inputs are the VerifierBatch + lane scalars
    only; lane points are gathered in-trace."""
    key = (vk.hash_scalar(), B, descs)
    if key not in _FAST_GATHERED_JIT:

        @jax.jit
        def step(b, ss, hc, kn):
            out = fast_device_gathered(vk, b, B, descs, ss, hc, kn)
            stacked = jnp.stack(
                [
                    getattr(out[n], c)
                    for n in ("e", "f", "w", "zw")
                    for c in ("x", "y", "z")
                ]
            )
            return stacked, out["h_eval"]

        _FAST_GATHERED_JIT[key] = step
    return _FAST_GATHERED_JIT[key]


def verify_algebra_fast(
    vk: VerifyingKey, b: VerifierBatch, parsed: List[ParsedProof]
):
    """Production path: device field algebra for h_eval + ONE batched
    double-and-add over all (B, M) multiopen lanes, instead of ~30
    sequential EC fold scans.  Produces the identical quad.  Lane points
    ride the gathered path (no host point materialization)."""
    B = len(parsed)
    descs, lane_scalars, h_coeff_mont, known_mont = fast_prep_gathered(
        vk, parsed
    )
    step = _fast_device_gathered_jitted(vk, B, descs)
    stacked, h_eval = step(b, lane_scalars, h_coeff_mont, known_mont)
    arr = np.asarray(stacked)  # the single D2H transfer
    quads = {}
    for i, name in enumerate(("e", "f", "w", "zw")):
        quads[name] = co.JacPoint(arr[3 * i], arr[3 * i + 1], arr[3 * i + 2])
    quads["h_eval"] = h_eval
    return quads


def synthetic_batch(vk: VerifyingKey, B: int, seed: int = 0) -> VerifierBatch:
    """A structurally-correct VerifierBatch with random field/point values —
    used for compile checks and steady-state benchmarking (identical
    compute shape to real verification)."""
    from ..oracle import curve as oc

    rng = np.random.default_rng(seed)
    cs = vk.cs
    num_chunks = num_perm_chunks(cs)

    def ri():
        return int.from_bytes(rng.bytes(40), "little") % R

    def S():
        return _scalars_to_batch([ri() for _ in range(B)])

    def P():
        g = oc.g1_generator()
        return _points_to_batch(
            [oc.g1_mul(g, int(rng.integers(1, 1 << 31))) for _ in range(B)]
        )

    perm_sets = [
        PermutationSetEvals(
            z=S(), z_next=S(), z_last=S() if ci < num_chunks - 1 else None
        )
        for ci in range(num_chunks)
    ]
    lookup_evs = [
        LookupEvals(z=S(), z_next=S(), a_prime=S(), a_prime_prev=S(), s_prime=S())
        for _ in cs.lookups
    ]
    sched = query_schedule(cs, num_chunks, len(cs.lookups))
    return VerifierBatch(
        theta=S(),
        beta=S(),
        gamma=S(),
        y=S(),
        x=S(),
        v=S(),
        u=S(),
        inst_evals=[S() for _ in cs.instance_queries],
        adv_evals=[S() for _ in cs.advice_queries],
        fix_evals=[S() for _ in cs.fixed_queries],
        r_eval=S(),
        sigma_evals=[S() for _ in cs.permutation_columns],
        perm_sets=perm_sets,
        lookup_evs=lookup_evs,
        inst_comms=[P() for _ in range(cs.num_instance_columns)],
        adv_comms=[P() for _ in range(cs.num_advice_columns)],
        lookups_permuted=[(P(), P()) for _ in cs.lookups],
        perm_z_comms=[P() for _ in range(num_chunks)],
        lookup_z_comms=[P() for _ in cs.lookups],
        r_comm=P(),
        h_comms=[P() for _ in range(cs.quotient_poly_degree())],
        w_comms=[P() for _ in rotation_sets(sched)],
    )


def aggregate_quads(quads, g1, s_g2, g2):
    """Fold N deferred-pairing quads into ONE pairing check.

    Each quad satisfies e(w_i, [tau]_2) == e(zw_i + f_i + e_i, [1]_2); a
    random linear combination with lambda derived by hashing all quads
    (Fiat-Shamir, so the prover cannot bias it) reduces the N checks to
        e(sum l^i w_i, [tau]_2) == e(sum l^i (zw_i+f_i+e_i), [1]_2).
    This is the "N proofs -> one accumulator" aggregation of
    BASELINE.json's north star; returns ((W, RHS), lambda)."""
    import hashlib

    from ..utils.serialization import g1_compress

    h = hashlib.blake2b(digest_size=64, person=b"H2A-Aggregate---")
    for e, f, w, zw in quads:
        for p in (e, f, w, zw):
            h.update(g1_compress(p))
    lam = int.from_bytes(h.digest(), "little") % R

    from ..utils import native

    lams = []
    lp = 1
    for _ in quads:
        lams.append(lp)
        lp = lp * lam % R
    ws = [w for _, _, w, _ in quads]
    # RHS = sum_i lam^i (zw_i + f_i + e_i) folded as ONE 3B-point MSM
    W = native.g1_msm(ws, lams)
    RHS = native.g1_msm(
        [q[3] for q in quads] + [q[1] for q in quads] + [q[0] for q in quads],
        lams * 3,
    )
    return (W, RHS), lam


def check_aggregate(quads, params) -> bool:
    """One pairing for the whole batch (vs one per proof)."""
    from ..oracle import curve as oc
    from ..oracle.pairing import multi_pairing_check_fast as multi_pairing_check

    (W, RHS), _ = aggregate_quads(quads, params.g1, params.s_g2, params.g2)
    return multi_pairing_check(
        [(W, params.s_g2), (oc.g1_neg(RHS), params.g2)]
    )


def verify_batch(
    params,
    vk: VerifyingKey,
    instances_list,
    proofs: List[bytes],
    fast: bool = True,
    aggregate: bool = False,
):
    """Full batched verification: host transcript replay + device algebra +
    host pairing checks.  With aggregate=True, folds all quads into ONE
    pairing check and returns (ok: bool, quads)."""
    from ..oracle import curve as oc
    from ..oracle.pairing import multi_pairing_check_fast as multi_pairing_check
    from .verifier import parse_proof

    parsed = []
    for insts, proof in zip(instances_list, proofs):
        inst_comms = [params.commit_lagrange(col) for col in insts]
        parsed.append(parse_proof(vk, inst_comms, proof))
    B = len(parsed)
    batch = batch_proofs(vk, parsed)
    if fast:
        out = verify_algebra_fast(vk, batch, parsed)
    else:
        out = verify_algebra(vk, batch, B)
    quads = []
    for name in ("e", "f", "w", "zw"):
        quads.append(co.jac_to_ints(out[name]))
    efws = [
        (quads[0][i], quads[1][i], quads[2][i], quads[3][i]) for i in range(B)
    ]
    if aggregate:
        return check_aggregate(efws, params), efws
    oks = []
    for e, f, w, zw in efws:
        rhs = oc.g1_add(oc.g1_add(zw, f), e)
        oks.append(
            multi_pairing_check([(w, params.s_g2), (oc.g1_neg(rhs), params.g2)])
        )
    return oks, efws
