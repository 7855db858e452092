"""create_proof — the PLONK/KZG prover.

Follows the transcript schedule the reference verifier replays step-for-step
(SURVEY.md §3.2, src/verifier.rs:286-762); every write here
lines up with a read there.  Host Python-int orchestration with device MSM
(H2A_DEVICE_MSM=1); the batched/device prover paths grow out of this reference
implementation (bench.py tracks the speedups).

Proof layout produced (all reads in verifier.py consume the same order):
  advice commitments | per-lookup (A', S') | perm Z chunks | lookup Zs |
  random r | h pieces | instance evals | advice evals | fixed evals |
  r(x) | sigma evals | perm Z evals (z, z_next[, z_last]) |
  lookup evals (z, z_next, a', a'_prev, s') | per-rotation-set W_i
"""

from __future__ import annotations

import numpy as np

from ..fields import FR_DELTA, R, fr_omega
from ..oracle import poly as opoly
from ..utils.transcript import Blake2bWrite
from .circuit import Any, Assignment, Column, ConstraintSystem
from .keygen import ProvingKey
from .kzg import Params
from .protocol import (
    VecIntOps,
    fold_y,
    gate_expressions,
    lookup_expressions,
    LookupEvals,
    permutation_expressions,
    PermutationSetEvals,
    query_schedule,
    rotation_sets,
)


def _rand_fr(rng) -> int:
    return int.from_bytes(rng.bytes(40), "little") % R


def _column_values(assignment: Assignment, col):
    if col.kind == Any.ADVICE:
        vals = assignment.advice[col.index]
        return [0 if v is None else v for v in vals]
    if col.kind == Any.FIXED:
        return list(assignment.fixed[col.index])
    return list(assignment.instance[col.index])


def _eval_expr_at_row(cs, expr, assignment, row, n):
    """Evaluate an expression on raw column values at one row (rotations
    wrap mod n) — used for lookup input/table compression."""
    from .circuit import evaluate_expr

    def q(queries, cols):
        def get(qi):
            col, rot = queries[qi]
            vals = cols(col)
            return vals[(row + rot.value) % n]

        return get

    return evaluate_expr(
        expr,
        constant=lambda v: v % R,
        fixed=q(cs.fixed_queries, lambda c: assignment.fixed[c.index]),
        advice=q(
            cs.advice_queries,
            lambda c: [0 if v is None else v for v in assignment.advice[c.index]],
        ),
        instance=q(cs.instance_queries, lambda c: assignment.instance[c.index]),
        add=lambda a, b: (a + b) % R,
        mul=lambda a, b: a * b % R,
        negate=lambda a: (-a) % R,
        scale=lambda a, v: a * v % R,
    )


def _permute_lookup(a_comp, s_comp, usable):
    """halo2's permute_expression_pair: A' = sorted A; S' pairs each new A'
    value with a matching table entry, leftovers fill repeats."""
    a_prime = sorted(a_comp[:usable])
    from collections import Counter

    leftover = Counter(s_comp[:usable])
    s_prime = [None] * usable
    repeats = []
    for i, v in enumerate(a_prime):
        if i == 0 or v != a_prime[i - 1]:
            if leftover[v] == 0:
                raise ValueError("lookup failure: input value not in table")
            leftover[v] -= 1
            s_prime[i] = v
        else:
            repeats.append(i)
    rest = list(leftover.elements())
    assert len(rest) == len(repeats)
    for i, v in zip(repeats, rest):
        s_prime[i] = v
    return a_prime, s_prime


def create_proof(
    params: Params,
    pk: ProvingKey,
    assignment: Assignment,
    instances,
    seed: int = 42,
    transcript_cls=Blake2bWrite,
) -> bytes:
    cs = pk.vk.cs
    k = pk.vk.k
    n = 1 << k
    omega = pk.vk.omega
    bf = cs.blinding_factors()
    usable = n - bf - 1  # active rows: 0..usable-1; l_last row: usable
    degree = cs.degree()
    chunk_len = degree - 2
    rng = np.random.default_rng(seed)
    t = transcript_cls()

    # row-indexed powers of omega
    omega_pows = [1] * n
    for i in range(1, n):
        omega_pows[i] = omega_pows[i - 1] * omega % R

    # --- 0. vk hash + instance commitments (verifier.rs:339-363) ----------
    t.common_scalar(pk.vk.hash_scalar())
    inst_cols = []
    for ci in range(cs.num_instance_columns):
        col = list(instances[ci]) + [0] * (n - len(instances[ci]))
        inst_cols.append(col)
        assignment.set_instance(Column(Any.INSTANCE, ci), col)
    inst_comms = [params.commit_lagrange(c) for c in inst_cols]
    for c in inst_comms:
        t.common_point(c)

    # --- 1. advice commitments (verifier.rs:365-376) -----------------------
    advice_cols = []
    for ci in range(cs.num_advice_columns):
        vals = [0 if v is None else v for v in assignment.advice[ci]]
        for row in range(usable, n):
            vals[row] = _rand_fr(rng)
        advice_cols.append(vals)
        t.write_point(params.commit_lagrange(vals))

    theta = t.squeeze_challenge()

    # --- 2. lookups: permuted commitments (verifier.rs:380-387) ------------
    lookups = []
    for arg in cs.lookups:
        a_comp = [
            _eval_expr_at_row_fold(cs, arg.input_expressions, assignment, j, n, theta)
            for j in range(n)
        ]
        s_comp = [
            _eval_expr_at_row_fold(cs, arg.table_expressions, assignment, j, n, theta)
            for j in range(n)
        ]
        ap, sp = _permute_lookup(a_comp, s_comp, usable)
        a_prime = ap + [_rand_fr(rng) for _ in range(n - usable)]
        s_prime = sp + [_rand_fr(rng) for _ in range(n - usable)]
        lookups.append(
            {"a_comp": a_comp, "s_comp": s_comp, "a_prime": a_prime, "s_prime": s_prime}
        )
        t.write_point(params.commit_lagrange(a_prime))
        t.write_point(params.commit_lagrange(s_prime))

    beta = t.squeeze_challenge()
    gamma = t.squeeze_challenge()

    # --- 3. permutation grand products (verifier.rs:401-409) ---------------
    perm_cols = cs.permutation_columns
    num_chunks = (len(perm_cols) + chunk_len - 1) // chunk_len
    deltas = [1]
    for _ in range(len(perm_cols) - 1):
        deltas.append(deltas[-1] * FR_DELTA % R)
    perm_zs = []
    prev_end = 1
    for ci in range(num_chunks):
        cols = perm_cols[ci * chunk_len : (ci + 1) * chunk_len]
        sigs = pk.sigma_columns[ci * chunk_len : (ci + 1) * chunk_len]
        colvals = [_column_values(assignment, c) for c in cols]
        z = [0] * n
        z[0] = 1 if ci == 0 else prev_end
        for j in range(usable):
            num = 1
            den = 1
            for t_i, vals in enumerate(colvals):
                kglob = ci * chunk_len + t_i
                num = num * ((vals[j] + beta * deltas[kglob] * omega_pows[j] + gamma) % R) % R
                den = den * ((vals[j] + beta * sigs[t_i][j] + gamma) % R) % R
            z[j + 1] = z[j] * num % R * pow(den, -1, R) % R
        prev_end = z[usable]
        for row in range(usable + 1, n):
            z[row] = _rand_fr(rng)
        perm_zs.append(z)
        t.write_point(params.commit_lagrange(z))

    # --- 4. lookup grand products (verifier.rs:411-417) --------------------
    for lk in lookups:
        z = [0] * n
        z[0] = 1
        for j in range(usable):
            num = (lk["a_comp"][j] + beta) * (lk["s_comp"][j] + gamma) % R
            den = (lk["a_prime"][j] + beta) * (lk["s_prime"][j] + gamma) % R
            z[j + 1] = z[j] * num % R * pow(den, -1, R) % R
        for row in range(usable + 1, n):
            z[row] = _rand_fr(rng)
        lk["z"] = z
        t.write_point(params.commit_lagrange(z))

    # --- 5. vanishing random poly (verifier.rs:419-421) --------------------
    r_vals = [_rand_fr(rng) for _ in range(n)]
    t.write_point(params.commit_lagrange(r_vals))

    y = t.squeeze_challenge()

    # --- 6. quotient h(X) (verifier.rs:427-434 reads its pieces) -----------
    ext_k = k + max(1, (degree - 1).bit_length())
    ext_n = 1 << ext_k
    g = 5  # coset shift must avoid the domain; any non-residue-ish shift
    from ..fields import FR_GENERATOR

    g = FR_GENERATOR
    step = ext_n // n

    def ext_of_lagrange(vals):
        return opoly.coset_extended_evals(opoly.lagrange_to_coeffs(vals, k), g, ext_k)

    adv_ext = [ext_of_lagrange(c) for c in advice_cols]
    fix_ext = [ext_of_lagrange(c) for c in pk.fixed_columns]
    inst_ext = [ext_of_lagrange(c) for c in inst_cols]
    sig_ext = [ext_of_lagrange(c) for c in pk.sigma_columns]
    permz_ext = [ext_of_lagrange(z) for z in perm_zs]
    lookup_ext = [
        {
            key: ext_of_lagrange(lk[key])
            for key in ("a_prime", "s_prime", "z")
        }
        for lk in lookups
    ]

    def one_hot_ext(rows):
        oh = [0] * n
        for rr in rows:
            oh[rr] = 1
        return ext_of_lagrange(oh)

    l0_ext = one_hot_ext([0])
    llast_ext = one_hot_ext([usable])
    lblind_ext = one_hot_ext(range(usable + 1, n))

    coset_x = [g * pow(fr_omega(ext_k), i, R) % R for i in range(ext_n)]

    def rolled(vals_ext, rot):
        s = (rot * step) % ext_n
        return vals_ext[s:] + vals_ext[:s]

    ops = VecIntOps()
    adv_leaf = [rolled(adv_ext[c.index], rot.value) for c, rot in cs.advice_queries]
    fix_leaf = [rolled(fix_ext[c.index], rot.value) for c, rot in cs.fixed_queries]
    inst_leaf = [
        rolled(inst_ext[c.index], rot.value) for c, rot in cs.instance_queries
    ]

    exprs = gate_expressions(ops, cs, adv_leaf, fix_leaf, inst_leaf)
    perm_sets = []
    for ci in range(num_chunks):
        perm_sets.append(
            PermutationSetEvals(
                z=permz_ext[ci],
                z_next=rolled(permz_ext[ci], 1),
                z_last=rolled(permz_ext[ci], -(bf + 1)) if ci < num_chunks - 1 else None,
            )
        )
    sigma_leaf = [sig_ext[i] for i in range(len(perm_cols))]
    exprs += permutation_expressions(
        ops,
        cs,
        perm_sets,
        sigma_leaf,
        adv_leaf,
        fix_leaf,
        inst_leaf,
        l0_ext,
        llast_ext,
        lblind_ext,
        beta,
        gamma,
        coset_x,
        chunk_len,
    )
    for li, arg in enumerate(cs.lookups):
        ev = LookupEvals(
            z=lookup_ext[li]["z"],
            z_next=rolled(lookup_ext[li]["z"], 1),
            a_prime=lookup_ext[li]["a_prime"],
            a_prime_prev=rolled(lookup_ext[li]["a_prime"], -1),
            s_prime=lookup_ext[li]["s_prime"],
        )
        exprs += lookup_expressions(
            ops,
            ev,
            arg,
            l0_ext,
            llast_ext,
            lblind_ext,
            theta,
            beta,
            gamma,
            adv_leaf,
            fix_leaf,
            inst_leaf,
        )

    num_ext = fold_y(ops, exprs, y)
    van_inv = [pow((pow(cx, n, R) - 1) % R, -1, R) for cx in coset_x]
    h_ext = [a * b % R for a, b in zip(num_ext, van_inv)]
    h_coeffs = opoly.coset_extended_to_coeffs(h_ext, g, ext_k)
    qpd = cs.quotient_poly_degree()  # number of pieces
    h_coeffs = h_coeffs[: qpd * n] + [0] * max(0, qpd * n - len(h_coeffs))
    h_pieces = [h_coeffs[i * n : (i + 1) * n] for i in range(qpd)]
    for piece in h_pieces:
        t.write_point(params.commit_lagrange(opoly.coeffs_to_lagrange(piece, k)))

    x = t.squeeze_challenge()

    # --- 7. evaluations (verifier.rs:438-510) ------------------------------
    def coeffs_of(vals):
        return opoly.lagrange_to_coeffs(vals, k)

    adv_coeffs = [coeffs_of(c) for c in advice_cols]
    fix_coeffs = [coeffs_of(c) for c in pk.fixed_columns]
    inst_coeffs = [coeffs_of(c) for c in inst_cols]
    sig_coeffs = [coeffs_of(c) for c in pk.sigma_columns]
    permz_coeffs = [coeffs_of(z) for z in perm_zs]
    lookup_coeffs = [
        {key: coeffs_of(lk[key]) for key in ("a_prime", "s_prime", "z")}
        for lk in lookups
    ]
    r_coeffs = coeffs_of(r_vals)

    def at_rot(coeffs, rot):
        if rot >= 0:
            pt = x * pow(omega, rot, R) % R
        else:
            pt = x * pow(pow(omega, -1, R), -rot, R) % R
        return opoly.eval_poly(coeffs, pt)

    inst_evals = [
        at_rot(inst_coeffs[c.index], rot.value) for c, rot in cs.instance_queries
    ]
    for e in inst_evals:
        t.write_scalar(e)
    adv_evals = [
        at_rot(adv_coeffs[c.index], rot.value) for c, rot in cs.advice_queries
    ]
    for e in adv_evals:
        t.write_scalar(e)
    fix_evals = [
        at_rot(fix_coeffs[c.index], rot.value) for c, rot in cs.fixed_queries
    ]
    for e in fix_evals:
        t.write_scalar(e)
    r_eval = at_rot(r_coeffs, 0)
    t.write_scalar(r_eval)
    sigma_evals = [at_rot(c, 0) for c in sig_coeffs]
    for e in sigma_evals:
        t.write_scalar(e)
    perm_ev = []
    for ci in range(num_chunks):
        z_x = at_rot(permz_coeffs[ci], 0)
        z_nx = at_rot(permz_coeffs[ci], 1)
        t.write_scalar(z_x)
        t.write_scalar(z_nx)
        z_last = None
        if ci < num_chunks - 1:
            z_last = at_rot(permz_coeffs[ci], -(bf + 1))
            t.write_scalar(z_last)
        perm_ev.append((z_x, z_nx, z_last))
    lookup_ev = []
    for li in range(len(cs.lookups)):
        lc = lookup_coeffs[li]
        vals = (
            at_rot(lc["z"], 0),
            at_rot(lc["z"], 1),
            at_rot(lc["a_prime"], 0),
            at_rot(lc["a_prime"], -1),
            at_rot(lc["s_prime"], 0),
        )
        for v in vals:
            t.write_scalar(v)
        lookup_ev.append(vals)

    v = t.squeeze_challenge()
    u = t.squeeze_challenge()

    # --- 8. multiopen witnesses (multiopen.rs:271-509 verifies these) ------
    xn = pow(x, n, R)
    h_folded = [0] * n
    xnp = 1
    for piece in h_pieces:
        for j in range(n):
            h_folded[j] = (h_folded[j] + xnp * piece[j]) % R
        xnp = xnp * xn % R
    h_eval = opoly.eval_poly(h_folded, x)

    sched = query_schedule(cs, num_chunks, len(cs.lookups))
    polys = {}  # Q -> (coeffs, eval)
    for q in sched:
        if q.kind == "instance":
            col, rot = cs.instance_queries[q.index]
            polys[q] = (inst_coeffs[col.index], inst_evals[q.index])
        elif q.kind == "advice":
            col, rot = cs.advice_queries[q.index]
            polys[q] = (adv_coeffs[col.index], adv_evals[q.index])
        elif q.kind == "fixed":
            col, rot = cs.fixed_queries[q.index]
            polys[q] = (fix_coeffs[col.index], fix_evals[q.index])
        elif q.kind == "perm_z":
            polys[q] = (
                permz_coeffs[q.index],
                perm_ev[q.index][0] if q.rotation == 0 else perm_ev[q.index][1],
            )
        elif q.kind == "perm_z_last":
            polys[q] = (permz_coeffs[q.index], perm_ev[q.index][2])
        elif q.kind == "lookup_z":
            polys[q] = (
                lookup_coeffs[q.index]["z"],
                lookup_ev[q.index][0] if q.rotation == 0 else lookup_ev[q.index][1],
            )
        elif q.kind == "lookup_a":
            polys[q] = (
                lookup_coeffs[q.index]["a_prime"],
                lookup_ev[q.index][2] if q.rotation == 0 else lookup_ev[q.index][3],
            )
        elif q.kind == "lookup_s":
            polys[q] = (lookup_coeffs[q.index]["s_prime"], lookup_ev[q.index][4])
        elif q.kind == "sigma":
            polys[q] = (sig_coeffs[q.index], sigma_evals[q.index])
        elif q.kind == "vanishing_h":
            polys[q] = (h_folded, h_eval)
        elif q.kind == "vanishing_r":
            polys[q] = (r_coeffs, r_eval)
        else:
            raise KeyError(q.kind)

    for rot, qs in rotation_sets(sched):
        if rot >= 0:
            z_pt = x * pow(omega, rot, R) % R
        else:
            z_pt = x * pow(pow(omega, -1, R), -rot, R) % R
        # v-fold: batch = batch * v + next  (multiopen.rs:443-462)
        fc = list(polys[qs[0]][0])
        fe = polys[qs[0]][1]
        for q in qs[1:]:
            c, e = polys[q]
            fc = [(a * v + b) % R for a, b in zip(fc, c)]
            fe = (fe * v + e) % R
        numer = list(fc)
        numer[0] = (numer[0] - fe) % R
        q_coeffs = opoly.divide_linear(numer, z_pt)
        t.write_point(params.commit_lagrange(opoly.coeffs_to_lagrange(q_coeffs, k)))

    return t.finalize()


def _eval_expr_at_row_fold(cs, exprs, assignment, row, n, theta):
    acc = 0
    for e in exprs:
        acc = (acc * theta + _eval_expr_at_row(cs, e, assignment, row, n)) % R
    return acc
