"""verify_proof — native verifier returning ``(ok, (e, f, w, zw))``.

Mirrors the fork's non-standard `verify_proof` that exposes the final four
MSM points for aggregation (`examples/simple-example.rs:
620-626`), and replays the exact schedule of the reference's in-circuit
verifier (SURVEY.md §3.2, verifier.rs:286-762): same absorb order, same
l_eval construction, same query order, same GWC folds.  This host-int
implementation is the bit-exactness anchor; device_verifier.py runs the same
algebra batched on device.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Tuple

from ..fields import R
from ..oracle import curve as oc
from ..oracle.pairing import multi_pairing_check_fast as multi_pairing_check
from ..utils.transcript import Blake2bRead
from .keygen import VerifyingKey
from .kzg import Params
from .protocol import (
    IntOps,
    LookupEvals,
    PermutationSetEvals,
    fold_y,
    gate_expressions,
    lookup_expressions,
    permutation_expressions,
    query_schedule,
    rotation_sets,
)


@dataclass
class VerifierTrace:
    """Every challenge and the final quad — the debug oracle the reference
    gates behind its `debug` feature (SURVEY.md §4), used for transcript
    parity tests between host and device verifiers."""

    theta: int
    beta: int
    gamma: int
    y: int
    x: int
    v: int
    u: int
    h_eval: int
    efw: Tuple


@dataclass
class ParsedProof:
    """Transcript-replay result: every commitment, eval, and challenge in
    schedule order — the host<->device handoff structure."""

    inst_comms: List
    adv_comms: List
    lookups_permuted: List  # (A', S') pairs
    perm_z_comms: List
    lookup_z_comms: List
    r_comm: object
    h_comms: List
    w_comms: List  # multiopen witness commitments, per rotation set (asc)
    inst_evals: List[int]
    adv_evals: List[int]
    fix_evals: List[int]
    r_eval: int
    sigma_evals: List[int]
    perm_sets: List[PermutationSetEvals]
    lookup_evs: List[LookupEvals]
    theta: int
    beta: int
    gamma: int
    y: int
    x: int
    v: int
    u: int


def num_perm_chunks(cs) -> int:
    chunk_len = cs.degree() - 2
    return (len(cs.permutation_columns) + chunk_len - 1) // chunk_len


def parse_proof(
    vk: VerifyingKey, inst_comms, proof: bytes, transcript_cls=Blake2bRead
) -> ParsedProof:
    """Replay the Fiat-Shamir transcript (steps 3-27 of SURVEY.md §3.2) and
    collect everything; host-only (hashing is inherently sequential)."""
    cs = vk.cs
    num_chunks = num_perm_chunks(cs)
    t = transcript_cls(proof)
    t.common_scalar(vk.hash_scalar())
    for c in inst_comms:
        t.common_point(c)
    adv_comms = [t.read_point() for _ in range(cs.num_advice_columns)]
    theta = t.squeeze_challenge()
    lookups_permuted = [
        (t.read_point(), t.read_point()) for _ in range(len(cs.lookups))
    ]
    beta = t.squeeze_challenge()
    gamma = t.squeeze_challenge()
    perm_z_comms = [t.read_point() for _ in range(num_chunks)]
    lookup_z_comms = [t.read_point() for _ in range(len(cs.lookups))]
    r_comm = t.read_point()
    y = t.squeeze_challenge()
    h_comms = [t.read_point() for _ in range(cs.quotient_poly_degree())]
    x = t.squeeze_challenge()
    inst_evals = [t.read_scalar() for _ in cs.instance_queries]
    adv_evals = [t.read_scalar() for _ in cs.advice_queries]
    fix_evals = [t.read_scalar() for _ in cs.fixed_queries]
    r_eval = t.read_scalar()
    sigma_evals = [t.read_scalar() for _ in cs.permutation_columns]
    perm_sets = []
    for ci in range(num_chunks):
        z = t.read_scalar()
        z_next = t.read_scalar()
        z_last = t.read_scalar() if ci < num_chunks - 1 else None
        perm_sets.append(PermutationSetEvals(z, z_next, z_last))
    lookup_evs = []
    for _ in cs.lookups:
        lookup_evs.append(
            LookupEvals(
                z=t.read_scalar(),
                z_next=t.read_scalar(),
                a_prime=t.read_scalar(),
                a_prime_prev=t.read_scalar(),
                s_prime=t.read_scalar(),
            )
        )
    v = t.squeeze_challenge()
    u = t.squeeze_challenge()
    sched = query_schedule(cs, num_chunks, len(cs.lookups))
    w_comms = [t.read_point() for _ in rotation_sets(sched)]
    return ParsedProof(
        inst_comms,
        adv_comms,
        lookups_permuted,
        perm_z_comms,
        lookup_z_comms,
        r_comm,
        h_comms,
        w_comms,
        inst_evals,
        adv_evals,
        fix_evals,
        r_eval,
        sigma_evals,
        perm_sets,
        lookup_evs,
        theta,
        beta,
        gamma,
        y,
        x,
        v,
        u,
    )


def verify_proof(
    params: Params,
    vk: VerifyingKey,
    instances: List[List[int]],
    proof: bytes,
    return_trace: bool = False,
    transcript_cls=Blake2bRead,
):
    cs = vk.cs
    n = vk.n
    omega = vk.omega
    omega_inv = pow(omega, -1, R)
    bf = cs.blinding_factors()
    chunk_len = cs.degree() - 2
    num_chunks = num_perm_chunks(cs)
    ops = IntOps()

    inst_comms = []
    for ci in range(cs.num_instance_columns):
        col = list(instances[ci])
        if len(col) > cs.usable_rows(n):
            raise ValueError("instance too large")
        inst_comms.append(params.commit_lagrange(col))

    p = parse_proof(vk, inst_comms, proof, transcript_cls)
    (theta, beta, gamma, y, x, v, u) = (
        p.theta,
        p.beta,
        p.gamma,
        p.y,
        p.x,
        p.v,
        p.u,
    )
    adv_comms = p.adv_comms
    lookups_permuted = p.lookups_permuted
    perm_z_comms = p.perm_z_comms
    lookup_z_comms = p.lookup_z_comms
    r_comm = p.r_comm
    h_comms = p.h_comms
    inst_evals = p.inst_evals
    adv_evals = p.adv_evals
    fix_evals = p.fix_evals
    r_eval = p.r_eval
    sigma_evals = p.sigma_evals
    perm_sets = p.perm_sets
    lookup_evs = p.lookup_evs

    # 20: x^n and Lagrange evals (verifier.rs:512-591)
    xn = pow(x, n, R)
    l_evals = []
    w = 1  # omega^{-i}
    for i in range(2 + bf):
        num = w * (xn - 1) % R
        den = n * (x - w) % R
        l_evals.append(num * pow(den, -1, R) % R)
        w = w * omega_inv % R
    l_evals.reverse()
    l_last = l_evals[0]
    l_blind = sum(l_evals[1 : 1 + bf]) % R
    l_0 = l_evals[1 + bf]

    # 21-23: expressions
    exprs = gate_expressions(ops, cs, adv_evals, fix_evals, inst_evals)
    exprs += permutation_expressions(
        ops,
        cs,
        perm_sets,
        sigma_evals,
        adv_evals,
        fix_evals,
        inst_evals,
        l_0,
        l_last,
        l_blind,
        beta,
        gamma,
        x,
        chunk_len,
    )
    for arg, ev in zip(cs.lookups, lookup_evs):
        exprs += lookup_expressions(
            ops,
            ev,
            arg,
            l_0,
            l_last,
            l_blind,
            theta,
            beta,
            gamma,
            adv_evals,
            fix_evals,
            inst_evals,
        )

    # 24: expected h eval + H fold (vanishing.rs:136-201)
    h_eval = fold_y(ops, exprs, y) * pow((xn - 1) % R, -1, R) % R
    H = h_comms[0]
    xnp = xn
    for hc in h_comms[1:]:
        H = oc.g1_add(H, oc.g1_mul(hc, xnp))
        xnp = xnp * xn % R

    # 25: queries in schedule order, resolved to (commitment, eval)
    sched = query_schedule(cs, num_chunks, len(cs.lookups))
    resolved = []
    for q in sched:
        if q.kind == "instance":
            col, _ = cs.instance_queries[q.index]
            resolved.append((q, inst_comms[col.index], inst_evals[q.index]))
        elif q.kind == "advice":
            col, _ = cs.advice_queries[q.index]
            resolved.append((q, adv_comms[col.index], adv_evals[q.index]))
        elif q.kind == "fixed":
            col, _ = cs.fixed_queries[q.index]
            resolved.append((q, vk.fixed_commitments[col.index], fix_evals[q.index]))
        elif q.kind == "perm_z":
            ev = perm_sets[q.index]
            resolved.append(
                (q, perm_z_comms[q.index], ev.z if q.rotation == 0 else ev.z_next)
            )
        elif q.kind == "perm_z_last":
            resolved.append((q, perm_z_comms[q.index], perm_sets[q.index].z_last))
        elif q.kind == "lookup_z":
            ev = lookup_evs[q.index]
            resolved.append(
                (q, lookup_z_comms[q.index], ev.z if q.rotation == 0 else ev.z_next)
            )
        elif q.kind == "lookup_a":
            ev = lookup_evs[q.index]
            resolved.append(
                (
                    q,
                    lookups_permuted[q.index][0],
                    ev.a_prime if q.rotation == 0 else ev.a_prime_prev,
                )
            )
        elif q.kind == "lookup_s":
            resolved.append(
                (q, lookups_permuted[q.index][1], lookup_evs[q.index].s_prime)
            )
        elif q.kind == "sigma":
            resolved.append((q, vk.sigma_commitments[q.index], sigma_evals[q.index]))
        elif q.kind == "vanishing_h":
            resolved.append((q, H, h_eval))
        elif q.kind == "vanishing_r":
            resolved.append((q, r_comm, r_eval))
        else:
            raise KeyError(q.kind)

    # 27: GWC multiopen fold (multiopen.rs:271-509)
    by_rot = {}
    for q, comm, ev in resolved:
        by_rot.setdefault(q.rotation, []).append((comm, ev))

    eval_multi = 0
    Ws, ZWs, Fs = [], [], []
    for set_i, rot in enumerate(sorted(by_rot)):
        if rot >= 0:
            z_pt = x * pow(omega, rot, R) % R
        else:
            z_pt = x * pow(omega_inv, -rot, R) % R
        wi = p.w_comms[set_i]
        z_wi = oc.g1_mul(wi, z_pt)
        Ws.append(wi)
        ZWs.append(z_wi)
        eval_multi = eval_multi * u % R
        entries = by_rot[rot]
        batch_c, batch_e = entries[0]
        for comm, ev in entries[1:]:
            batch_c = oc.g1_add(oc.g1_mul(batch_c, v), comm)
            batch_e = (batch_e * v + ev) % R
        Fs.append(batch_c)
        eval_multi = (eval_multi + batch_e) % R

    def fold_pts(pts):
        acc = pts[0]
        for p in pts[1:]:
            acc = oc.g1_add(oc.g1_mul(acc, u), p)
        return acc

    w_pt = fold_pts(Ws)
    zw_pt = fold_pts(ZWs)
    f_pt = fold_pts(Fs)
    e_pt = oc.g1_mul(params.g1, (-eval_multi) % R)

    # deferred pairing: e(w, [tau]_2) == e(zw + f + e, [1]_2)
    rhs = oc.g1_add(oc.g1_add(zw_pt, f_pt), e_pt)
    ok = multi_pairing_check(
        [(w_pt, params.s_g2), (oc.g1_neg(rhs), params.g2)]
    )

    efw = (e_pt, f_pt, w_pt, zw_pt)
    if return_trace:
        return ok, efw, VerifierTrace(theta, beta, gamma, y, x, v, u, h_eval, efw)
    return ok, efw
