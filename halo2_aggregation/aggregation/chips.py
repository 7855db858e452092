"""In-circuit verifier chips: transcript, lookup, permutation, vanishing,
multiopen, and the verifier orchestrator.

Layer L2/L3 of the reference (SURVEY.md §1) rebuilt on our gadgets.  The
scalar algebra is NOT re-written: `GadgetOps` plugs the main gate into the
same `plonk/protocol.py` formulas used by the prover, host verifier, and
device verifier — one source of truth for the constraint formulas the
reference spreads across `src/lookup.rs`, `src/permutation.rs`,
`src/vanishing.rs`.

Fidelity notes (matching reference behavior, including its §2c gaps):
* Two transcript modes.  The DEFAULT is `PoseidonTranscriptChip`:
  challenges are derived by the in-circuit Poseidon sponge gadget, so
  Fiat-Shamir is CONSTRAINED end to end — our upgrade over the
  reference, which cannot do this at all.  `constrained_fs=False`
  selects reference-parity `TranscriptChip`: challenges computed by the
  native Blake2b transcript host-side and assigned as UNCONSTRAINED
  advice witnesses, exactly like
  `src/transcript.rs:62-85` (their "USE THIS CHIP WITH
  CAUTION" note applies to that mode only).
* fixed/sigma commitments are loaded as circuit constants (fixing the
  reference's "TODO: alloc point from constant", verifier.rs:323, :332).
* the final verdict mirrors verifier.rs:756-761.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional

from ..fields import R
from ..plonk import protocol
from ..plonk.circuit import Column, ConstraintSystem
from ..plonk.keygen import VerifyingKey
from ..plonk.protocol import (
    LookupEvals,
    PermutationSetEvals,
    ScalarOps,
    query_schedule,
    rotation_sets,
)
from ..plonk.verifier import num_perm_chunks
from ..utils.transcript import Blake2bRead, Blake2bWrite
from .gadgets.ecc import AssignedPoint, EccChip
from .gadgets.main_gate import AssignedValue, Ctx, MainGate, Term


#: placeholder for the vanishing H commitment in the query schedule — H is
#: never materialized as an AssignedPoint (see step 24/27 in verify_proof)
_H_SENTINEL = object()


class GadgetOps(ScalarOps):
    """ScalarOps backend that emits main-gate rows over AssignedValues —
    the in-circuit analog of the reference's `compute_expr` + MainGate
    calls (verifier.rs:58-151)."""

    def __init__(self, mg: MainGate, ctx: Ctx):
        self.mg = mg
        self.ctx = ctx
        self._consts = {}

    def constant(self, v: int) -> AssignedValue:
        v = v % R
        if v not in self._consts:
            self._consts[v] = self.mg.assign_constant(self.ctx, v)
        return self._consts[v]

    def add(self, a, b):
        return self.mg.add(self.ctx, a, b)

    def sub(self, a, b):
        return self.mg.sub(self.ctx, a, b)

    def mul(self, a, b):
        return self.mg.mul(self.ctx, a, b)

    def neg(self, a):
        return self.mg.neg(self.ctx, a)

    def scale(self, a, v):
        return self.mg.mul_by_constant(self.ctx, a, v)


class TranscriptChip:
    """In-circuit Fiat-Shamir bookkeeping (transcript.rs:56-149): wraps a
    native Blake2bWrite; absorbs the *values* of assigned cells and assigns
    squeezed challenges as advice witnesses (unconstrained, as upstream)."""

    def __init__(self, mg: MainGate):
        self.mg = mg
        self.native = Blake2bWrite()

    def common_scalar(self, ctx, av: AssignedValue):
        if av.value is not None:
            self.native.common_scalar(av.value)

    def common_point(self, ctx, pt: AssignedPoint):
        v = pt.value()
        if v is not None:
            self.native.common_point(v)

    def squeeze_challenge_scalar(self, ctx) -> AssignedValue:
        c = self.native.squeeze_challenge()
        return self.mg.assign_value(ctx, c)


class PoseidonTranscriptChip:
    """CONSTRAINED in-circuit Fiat-Shamir — the soundness upgrade over the
    reference's witness-only chip (transcript.rs:62-65): absorbs the
    assigned CELLS (strict-reduced coordinates, so the absorbed limbs are
    the unique canonical encoding) into a Poseidon sponge gadget and
    returns challenges as gadget-computed cells.  Challenge derivation is
    thereby enforced by main-gate rows; a prover cannot pick challenges
    independently of the absorbed commitments.

    Pairs with utils.transcript.PoseidonRead on the host side (identical
    absorb order and values — the quad-parity tests pin it)."""

    def __init__(self, mg: MainGate, ic):
        self.mg = mg
        self.ic = ic
        self._sponge = None

    def _sp(self, ctx):
        if self._sponge is None:
            from .gadgets.poseidon import PoseidonSpongeChip

            self._sponge = PoseidonSpongeChip(self.mg, ctx)
        return self._sponge

    def common_scalar(self, ctx, av: AssignedValue):
        self._sp(ctx).absorb(av)

    def common_point(self, ctx, pt: AssignedPoint):
        sp = self._sp(ctx)
        for coord in (pt.x, pt.y):
            canon = self.ic.reduce_strict(ctx, coord)
            for limb in canon.limbs:
                sp.absorb(limb)

    def squeeze_challenge_scalar(self, ctx) -> AssignedValue:
        return self._sp(ctx).squeeze(ctx)


def assign_point_from_instance(
    mg, ecc, ctx, instance_col, instance_row, known: bool
) -> "AssignedPoint":
    """8 instance limbs -> point (verifier.rs:200-225): witness advice
    limbs copied against the instance column.  With known=False
    (keygen-shape synthesis) the limbs are witnessed as unknown, exactly
    like halo2's Value::unknown(); the copy constraint is positional and
    needs no value either way."""
    cells = []
    for i in range(8):
        v = None
        if known:
            vals = ctx.assignment.instance[instance_col.index]
            v = vals[instance_row + i]
        av = mg.assign_value(ctx, v)
        ctx.assignment.copy(av.column, av.row, instance_col, instance_row + i)
        cells.append(av)
    return ecc.assign_point_from_cells(ctx, cells[:4], cells[4:])


@dataclass
class MultiopenVar:
    w: AssignedPoint
    zw: AssignedPoint
    f: AssignedPoint
    e: AssignedPoint


class VerifierChip:
    """The orchestrator (verifier.rs:227-762): replays the full verifier
    over gadgets.  `transcript=None` -> shape-only synthesis (keygen)."""

    def __init__(
        self,
        mg: MainGate,
        ecc: EccChip,
        inner_vk: VerifyingKey,
        transcript: Optional[Blake2bRead],
        mul_nbits: int = 254,
        constrained_fs: bool = False,
    ):
        self.mg = mg
        self.ecc = ecc
        self.ic = ecc.ic
        self.vk = inner_vk
        self.transcript = transcript
        # constrained_fs=True enforces challenge derivation in-circuit via
        # the Poseidon sponge gadget (pair with a PoseidonRead transcript
        # and a PoseidonWrite-produced inner proof); False mirrors the
        # reference's unconstrained witness-only transcript.
        self.constrained_fs = constrained_fs
        self.tchip = (
            PoseidonTranscriptChip(mg, ecc.ic)
            if constrained_fs
            else TranscriptChip(mg)
        )
        self.mul_nbits = mul_nbits

    # ------------------------------------------------------------------
    def _read_point(self, ctx) -> AssignedPoint:
        p = None if self.transcript is None else self.transcript.read_point()
        pt = self.ecc.assign_point(ctx, p)
        self.tchip.common_point(ctx, pt)
        return pt

    def _read_scalar(self, ctx) -> AssignedValue:
        s = None if self.transcript is None else self.transcript.read_scalar()
        av = self.mg.assign_value(ctx, s)
        self.tchip.common_scalar(ctx, av)
        return av

    def _read_comm(self, ctx) -> AssignedPoint:
        """multiopen W_i read (multiopen.rs:202-218): read WITHOUT absorb."""
        p = None if self.transcript is None else self.transcript.read_point()
        return self.ecc.assign_point(ctx, p)

    def assign_point_from_instance(self, ctx, instance_col, instance_row) -> AssignedPoint:
        """8 instance limbs -> point (verifier.rs:200-225): witness advice
        limbs copied against the instance column."""
        return assign_point_from_instance(
            self.mg,
            self.ecc,
            ctx,
            instance_col,
            instance_row,
            known=self.transcript is not None,
        )


    # ------------------------------------------------------------------
    def verify_proof(self, ctx: Ctx, instance_col: Column, instance_offset: int = 0):
        """The full §3.2 schedule.  Returns (MultiopenVar, verdict_bit);
        also pins the quad against instance rows offset+8..offset+39.
        `instance_offset` places this proof's 40-scalar instance block —
        proof i of a multi-proof circuit lives at offset 40*i
        (models/aggregation_circuit.py)."""
        vk = self.vk
        cs = vk.cs
        mg, ecc, ic = self.mg, self.ecc, self.ic
        ops = GadgetOps(mg, ctx)
        n = vk.n
        omega = vk.omega
        omega_inv = pow(omega, -1, R)
        bf = cs.blinding_factors()
        chunk_len = cs.degree() - 2
        num_chunks = num_perm_chunks(cs)
        num_lookups = len(cs.lookups)

        # 1. instance commitments from the instance column
        instance_row = instance_offset
        inst_comms = []
        for _ in range(cs.num_instance_columns):
            inst_comms.append(
                self.assign_point_from_instance(ctx, instance_col, instance_row)
            )
            instance_row += 8

        # 2. fixed + sigma commitments as constants (fixes TODO
        #    verifier.rs:323/:332)
        fixed_comms = [
            ecc.assign_constant_point(ctx, c) for c in vk.fixed_commitments
        ]
        sigma_comms = [
            ecc.assign_constant_point(ctx, c) for c in vk.sigma_commitments
        ]

        # 3. vk hash (verifier.rs:341-358)
        vk_hash = mg.assign_value(ctx, vk.hash_scalar())
        self.tchip.common_scalar(ctx, vk_hash)

        # 4. absorb instance commitments
        for c in inst_comms:
            self.tchip.common_point(ctx, c)

        # 5. advice commitments
        adv_comms = []
        for _ in range(cs.num_advice_columns):
            adv_comms.append(self._read_point(ctx))

        theta = self.tchip.squeeze_challenge_scalar(ctx)

        # 7. lookup permuted commitments
        lookups_permuted = [
            (self._read_point(ctx), self._read_point(ctx))
            for _ in range(num_lookups)
        ]
        beta = self.tchip.squeeze_challenge_scalar(ctx)
        gamma = self.tchip.squeeze_challenge_scalar(ctx)

        # 9-11
        perm_z_comms = [self._read_point(ctx) for _ in range(num_chunks)]
        lookup_z_comms = [self._read_point(ctx) for _ in range(num_lookups)]
        r_comm = self._read_point(ctx)
        y = self.tchip.squeeze_challenge_scalar(ctx)
        h_comms = [
            self._read_point(ctx) for _ in range(cs.quotient_poly_degree())
        ]
        x = self.tchip.squeeze_challenge_scalar(ctx)

        # 15-19: evals
        inst_evals = [self._read_scalar(ctx) for _ in cs.instance_queries]
        adv_evals = [self._read_scalar(ctx) for _ in cs.advice_queries]
        fix_evals = [self._read_scalar(ctx) for _ in cs.fixed_queries]
        r_eval = self._read_scalar(ctx)
        sigma_evals = [self._read_scalar(ctx) for _ in cs.permutation_columns]
        perm_sets = []
        for ci in range(num_chunks):
            z = self._read_scalar(ctx)
            z_next = self._read_scalar(ctx)
            z_last = self._read_scalar(ctx) if ci < num_chunks - 1 else None
            perm_sets.append(PermutationSetEvals(z, z_next, z_last))
        lookup_evs = []
        for _ in range(num_lookups):
            lookup_evs.append(
                LookupEvals(
                    z=self._read_scalar(ctx),
                    z_next=self._read_scalar(ctx),
                    a_prime=self._read_scalar(ctx),
                    a_prime_prev=self._read_scalar(ctx),
                    s_prime=self._read_scalar(ctx),
                )
            )

        # 20: x^n, l_evals (verifier.rs:512-591)
        xn = x
        for _ in range(vk.k):
            xn = mg.mul(ctx, xn, xn)
        one = ops.constant(1)
        xn_sub_one = mg.add_constant(ctx, xn, R - 1)
        l_evals = []
        w_pow = 1
        for _ in range(2 + bf):
            numer = mg.mul_by_constant(ctx, xn_sub_one, w_pow)
            term = mg.add_constant(ctx, x, (-w_pow) % R)
            denom = mg.mul_by_constant(ctx, term, n)
            l_evals.append(mg.div(ctx, numer, denom))
            w_pow = w_pow * omega_inv % R
        l_evals.reverse()
        l_last = l_evals[0]
        l_blind = l_evals[1]
        for i in range(2, 1 + bf):
            l_blind = mg.add(ctx, l_blind, l_evals[i])
        l_0 = l_evals[1 + bf]

        # 21-23: expression evaluation via the shared protocol formulas
        exprs = protocol.gate_expressions(ops, cs, adv_evals, fix_evals, inst_evals)
        exprs += protocol.permutation_expressions(
            ops, cs, perm_sets, sigma_evals, adv_evals, fix_evals, inst_evals,
            l_0, l_last, l_blind, beta, gamma, x, chunk_len,
        )
        for arg, ev in zip(cs.lookups, lookup_evs):
            exprs += protocol.lookup_expressions(
                ops, ev, arg, l_0, l_last, l_blind, theta, beta, gamma,
                adv_evals, fix_evals, inst_evals,
            )

        # 24: h_eval (vanishing.rs:136-201).  The H commitment is NOT
        # materialized in-circuit: its only use is as the vanishing_h
        # query in step 27's fold, so H's definition
        # H = sum_i [xn^i] h_comms[i]  is expanded INTO that MSM with
        # native xn-power scalars — the whole H fold's EC cost collapses
        # into the shared doublings of the multiopen MSM.
        h_eval = protocol.fold_y(ops, exprs, y)
        h_eval = mg.div(ctx, h_eval, xn_sub_one)
        xn_pows = [None] * len(h_comms)  # native scalars xn^i
        if h_comms:
            xn_pows[0] = mg.assign_constant(ctx, 1)
            for i in range(1, len(h_comms)):
                xn_pows[i] = mg.mul(ctx, xn_pows[i - 1], xn)
        H = _H_SENTINEL

        # 25: queries in schedule order (verifier.rs:654-715)
        sched = query_schedule(cs, num_chunks, num_lookups)
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
                resolved.append((q, fixed_comms[col.index], fix_evals[q.index]))
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
                resolved.append((q, sigma_comms[q.index], sigma_evals[q.index]))
            elif q.kind == "vanishing_h":
                resolved.append((q, H, h_eval))
            elif q.kind == "vanishing_r":
                resolved.append((q, r_comm, r_eval))
            else:
                raise KeyError(q.kind)

        v = self.tchip.squeeze_challenge_scalar(ctx)
        u = self.tchip.squeeze_challenge_scalar(ctx)

        # 27: GWC multiopen fold (multiopen.rs:271-509), restructured into
        # THREE shared-doubling in-circuit MSMs that produce the exact
        # group elements of the reference's Horner chains:
        #     f_pt  = sum_i u^{R-1-i} sum_j v^{m_i-1-j} C_ij
        #     w_pt  = sum_i u^{R-1-i} W_i
        #     zw_pt = sum_i u^{R-1-i} z_i W_i
        # The scalar algebra (u/v/xn powers, z_i = omega^rot * x) moves to
        # NATIVE one-row muls; all EC cost concentrates in msm_var, where
        # every extra point shares the accumulator doublings.  Transcript
        # read order (w_comms per sorted rotation) is unchanged.
        by_rot = {}
        for q, comm, ev in resolved:
            by_rot.setdefault(q.rotation, []).append((comm, ev))
        rots = sorted(by_rot)
        n_rots = len(rots)
        u_pows = [None] * n_rots  # u^{n_rots-1-i}
        u_pows[n_rots - 1] = mg.assign_constant(ctx, 1)
        for i in range(n_rots - 2, -1, -1):
            u_pows[i] = mg.mul(ctx, u_pows[i + 1], u)
        eval_multi = ops.constant(0)
        w_entries, zw_entries, f_entries = [], [], []
        for i, rot in enumerate(rots):
            w_exp = pow(omega, rot, R) if rot >= 0 else pow(omega_inv, -rot, R)
            pow_real_omega = ops.constant(w_exp)
            z_pt = mg.mul(ctx, pow_real_omega, x)
            wi = self._read_comm(ctx)
            w_entries.append((wi, u_pows[i]))
            zw_entries.append((wi, mg.mul(ctx, u_pows[i], z_pt)))
            eval_multi = mg.mul(ctx, eval_multi, u)
            entries = by_rot[rot]
            m = len(entries)
            v_pows = [None] * m  # v^{m-1-j}
            v_pows[m - 1] = u_pows[n_rots - 1]  # the assigned 1
            for j in range(m - 2, -1, -1):
                v_pows[j] = mg.mul(ctx, v_pows[j + 1], v)
            batch_e = None
            for j, (comm, ev) in enumerate(entries):
                s = (
                    u_pows[i]
                    if j == m - 1
                    else mg.mul(ctx, u_pows[i], v_pows[j])
                )
                if comm is _H_SENTINEL:
                    for idx in range(len(h_comms)):
                        sc = s if idx == 0 else mg.mul(ctx, s, xn_pows[idx])
                        f_entries.append((h_comms[idx], sc))
                else:
                    f_entries.append((comm, s))
                batch_e = (
                    ev
                    if batch_e is None
                    else mg.add(ctx, mg.mul(ctx, batch_e, v), ev)
                )
            eval_multi = mg.add(ctx, eval_multi, batch_e)

        one_c = u_pows[n_rots - 1]  # the assigned constant 1

        def _msm(entries):
            # unit-scalar entries skip the ladder (added once, exactly)
            return ecc.msm_var(
                ctx,
                [(p, s) for p, s in entries if s is not one_c],
                plus=[p for p, s in entries if s is one_c],
            )

        f_pt = _msm(f_entries)
        w_pt = _msm(w_entries)
        zw_pt = _msm(zw_entries)
        from ..fields import G1_GEN

        neg_e = mg.neg(ctx, eval_multi)
        e_pt = ecc.mul_fixed(ctx, G1_GEN, neg_e, self.mul_nbits)
        quad = MultiopenVar(w=w_pt, zw=zw_pt, f=f_pt, e=e_pt)

        # 28: pin the quad against the instance column (verifier.rs:739-754;
        # layout [inst_comm, e, f, w, zw], simple-example.rs:668-671)
        for pt in (quad.e, quad.f, quad.w, quad.zw):
            inp = self.assign_point_from_instance(ctx, instance_col, instance_row)
            instance_row += 8
            ecc.assert_equal(ctx, pt, inp)

        # 29: verdict bit (constant, mirroring verifier.rs:756-761)
        ret = mg.assign_bit(ctx, 0)
        return quad, ret
