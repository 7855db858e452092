"""EccChip: in-circuit BN254 G1 arithmetic over RNS integers.

Re-design of halo2wrong's `BaseFieldEccChip` (SURVEY.md §2b) — the
reference's dominant cost center (`mul_var`,
`src/multiopen.rs:393`): points are pairs of
AssignedIntegers (affine coordinates, never the identity); add/double use
witnessed slopes pinned by `assert_mul_equals` (one mul-sized constraint,
no canonical reductions), and `mul_var` is a double-and-add ladder whose
per-step "zero addend" is a fixed constant point, so the final correction
is a host-computable CONSTANT — no witness-dependent cleanup
(the identity never appears, keeping the incomplete formulas safe).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional

from ...fields import CURVE_B, Q, R
from ...oracle import curve as oc
from .integer import AssignedInteger, IntegerChip
from .main_gate import AssignedValue, Ctx, MainGate, Term


@dataclass
class AssignedPoint:
    """Affine in-circuit point (excluded: the identity)."""

    x: AssignedInteger
    y: AssignedInteger

    def value(self):
        xv, yv = self.x.value(), self.y.value()
        if xv is None or yv is None:
            return None
        return (xv % Q, yv % Q)


#: ladder constants: acc seed and the 0-digit addend.  Any fixed points
#: work (soundness never depends on them; they cancel via the constant
#: correction).
ACC_INIT = oc.g1_mul(oc.g1_generator(), 0xACC0)
ZERO_ADDEND = oc.g1_mul(oc.g1_generator(), 0x0FF5E7)


class EccChip:
    def __init__(self, integer_chip: IntegerChip):
        self.ic = integer_chip
        self.mg = integer_chip.mg

    # -- assignment ----------------------------------------------------------
    def _assert_on_curve(self, ctx, p: "AssignedPoint"):
        y2 = self.ic.square(ctx, p.y)
        x2 = self.ic.square(ctx, p.x)
        rhs = self.ic.add(ctx, self.ic.assign_constant(ctx, CURVE_B),
                          self.ic.mul(ctx, x2, p.x))
        # y^2 - x^3 - b = 0 (mod p): assert via mul-equals on y*y = rhs
        self.ic.assert_mul_equals(ctx, p.y, p.y, rhs)

    def assign_point(self, ctx: Ctx, p) -> AssignedPoint:
        """Witness an affine point, constrained to the curve."""
        x = self.ic.assign_integer(ctx, None if p is None else p[0])
        y = self.ic.assign_integer(ctx, None if p is None else p[1])
        pt = AssignedPoint(x, y)
        self._assert_on_curve(ctx, pt)
        return pt

    def assign_constant_point(self, ctx: Ctx, p) -> AssignedPoint:
        return AssignedPoint(
            self.ic.assign_constant(ctx, p[0]), self.ic.assign_constant(ctx, p[1])
        )

    def assign_point_from_cells(self, ctx, x_cells, y_cells) -> AssignedPoint:
        """Build a point from 8 existing limb cells (instance column copies)
        — the reference's `assign_point_from_instance`
        (verifier.rs:200-225)."""
        x = self.ic.assign_from_cells(ctx, x_cells)
        y = self.ic.assign_from_cells(ctx, y_cells)
        pt = AssignedPoint(x, y)
        self._assert_on_curve(ctx, pt)
        return pt

    # -- group law -----------------------------------------------------------
    def add_incomplete(self, ctx, p: AssignedPoint, q: AssignedPoint) -> AssignedPoint:
        """p + q for p != +-q.

        lambda*(x2 - x1) = y2 - y1 with a witnessed inverse of (x2 - x1)
        making x1 == x2 unsatisfiable; then
        x3 = lambda^2 - x1 - x2,  y3 = lambda*(x1 - x3) - y1."""
        ic = self.ic
        dx = ic.sub(ctx, q.x, p.x)
        dy = ic.sub(ctx, q.y, p.y)
        pv, qv = p.value(), q.value()
        if pv is None or qv is None:
            lam_v = inv_v = None
        else:
            dxv = (qv[0] - pv[0]) % Q
            assert dxv != 0, "add_incomplete on equal x-coordinates"
            inv_v = pow(dxv, -1, Q)
            lam_v = (qv[1] - pv[1]) * inv_v % Q
        # dx != 0
        inv_dx = ic.assign_integer(ctx, inv_v)
        one = ic.assign_constant(ctx, 1)
        ic.assert_mul_equals(ctx, dx, inv_dx, one)
        # slope
        lam = ic.assign_integer(ctx, lam_v)
        ic.assert_mul_equals(ctx, lam, dx, dy)
        # x3: lambda^2 = x3 + x1 + x2
        x3_v = None if lam_v is None else (lam_v * lam_v - pv[0] - qv[0]) % Q
        x3 = ic.assign_integer(ctx, x3_v)
        sum_x = ic.add(ctx, ic.add(ctx, x3, p.x), q.x)
        ic.assert_mul_equals(ctx, lam, lam, sum_x)
        # y3: lambda*(x1 - x3) = y3 + y1
        y3_v = None if lam_v is None else (lam_v * (pv[0] - x3_v) - pv[1]) % Q
        y3 = ic.assign_integer(ctx, y3_v)
        x1_sub_x3 = ic.sub(ctx, p.x, x3)
        sum_y = ic.add(ctx, y3, p.y)
        ic.assert_mul_equals(ctx, lam, x1_sub_x3, sum_y)
        return AssignedPoint(x3, y3)

    def double(self, ctx, p: AssignedPoint) -> AssignedPoint:
        """2p: lambda*(2y) = 3x^2.  y == 0 cannot occur for points on this
        curve (the group order is odd, so there is no 2-torsion)."""
        ic = self.ic
        x2 = ic.square(ctx, p.x)
        three_x2 = ic.add(ctx, ic.add(ctx, x2, x2), x2)
        two_y = ic.add(ctx, p.y, p.y)
        pv = p.value()
        if pv is None:
            lam_v = None
        else:
            lam_v = 3 * pv[0] * pv[0] * pow(2 * pv[1] % Q, -1, Q) % Q
        lam = ic.assign_integer(ctx, lam_v)
        ic.assert_mul_equals(ctx, lam, two_y, three_x2)
        x3_v = None if lam_v is None else (lam_v * lam_v - 2 * pv[0]) % Q
        x3 = ic.assign_integer(ctx, x3_v)
        sum_x = ic.add(ctx, ic.add(ctx, x3, p.x), p.x)
        ic.assert_mul_equals(ctx, lam, lam, sum_x)
        y3_v = None if lam_v is None else (lam_v * (pv[0] - x3_v) - pv[1]) % Q
        y3 = ic.assign_integer(ctx, y3_v)
        x1_sub_x3 = ic.sub(ctx, p.x, x3)
        sum_y = ic.add(ctx, y3, p.y)
        ic.assert_mul_equals(ctx, lam, x1_sub_x3, sum_y)
        return AssignedPoint(x3, y3)

    def neg(self, ctx, p: AssignedPoint) -> AssignedPoint:
        return AssignedPoint(p.x, self.ic.neg(ctx, p.y))

    def assert_equal(self, ctx, p: AssignedPoint, q: AssignedPoint):
        """The reference's `ecc_chip.assert_equal` (verifier.rs:751-754)."""
        self.ic.assert_equal(ctx, p.x, q.x)
        self.ic.assert_equal(ctx, p.y, q.y)

    # -- selection ------------------------------------------------------------
    def select(self, ctx, bit: AssignedValue, p: AssignedPoint, q: AssignedPoint) -> AssignedPoint:
        """bit ? p : q, limb-wise: out = b*p_i + (1-b)*q_i per limb."""

        def sel_int(a: AssignedInteger, b_int: AssignedInteger) -> AssignedInteger:
            cells, maxes = [], []
            for i in range(4):
                av, bv = a.limbs[i].value, b_int.limbs[i].value
                ov = None
                if av is not None and bv is not None and bit.value is not None:
                    ov = (bv + bit.value * (av - bv)) % R
                # bit*a_i - bit*b_i + b_i - out = 0
                cells5 = self.mg.combine(
                    ctx,
                    [
                        Term.from_assigned(bit, 0),
                        Term.from_assigned(a.limbs[i], 0),
                        Term.from_assigned(bit, 0),
                        Term.from_assigned(b_int.limbs[i], 1),
                        Term.unassigned(ov, R - 1),
                    ],
                    mul_ab=1,
                    mul_cd=R - 1,
                )
                cells.append(cells5[4])
                maxes.append(max(a.max_vals[i], b_int.max_vals[i]))
            native = self.ic._native_of_limbs(ctx, cells)
            return AssignedInteger(cells, native, maxes)

        return AssignedPoint(sel_int(p.x, q.x), sel_int(p.y, q.y))

    # -- scalar multiplication -------------------------------------------------
    def scalar_bits(self, ctx, scalar: AssignedValue, nbits: int) -> List[AssignedValue]:
        """Witness the bit decomposition of a native scalar cell and
        constrain its recomposition."""
        sv = scalar.value
        bits_v = [None] * nbits if sv is None else [(sv >> i) & 1 for i in range(nbits)]
        cells = [self.mg.assign_bit(ctx, b) for b in bits_v]
        terms = [Term.from_assigned(c, pow(2, i, R)) for i, c in enumerate(cells)]
        terms.append(Term.from_assigned(scalar, R - 1))
        self.ic.combine_chain(ctx, terms)
        return cells

    def _select_tree(self, ctx, bits: List[AssignedValue], tbl: List[AssignedPoint]) -> AssignedPoint:
        """tbl[sum_i bits[i]*2^i] via a branchless binary select tree
        (len(tbl) == 2^len(bits))."""
        cur = tbl
        for b in bits:
            cur = [
                self.select(ctx, b, cur[2 * j + 1], cur[2 * j])
                for j in range(len(cur) // 2)
            ]
        return cur[0]

    def _glv_halves(self, ctx, p: AssignedPoint, scalar: AssignedValue):
        """GLV-split one (point, native scalar) pair into two ~129-bit
        half-ladders [(P1, bits1), (P2, bits2)] with
        [s]P = [a1]P1 + [a2]P2  (oracle/glv.py).

        Witness (b1, a1, b2, a2) with  s == (1-2b1)*a1 + (1-2b2)*a2*LAMBDA
        (mod r)  — ONE main-gate row, since the native field IS Fr — with
        a1, a2 < 2^GLV_BITS enforced by their bit decompositions.
        P1 = +-P, P2 = +-phi(P).  Soundness needs phi(Q) == [LAMBDA]Q for
        every on-curve Q, which holds on BN254 G1 because the cofactor
        is 1."""
        from ...oracle import glv as og

        mg, ic = self.mg, self.ic
        nb = og.GLV_BITS
        sv = scalar.value
        if sv is None:
            b1v = b2v = a1v = a2v = None
        else:
            s1g, a1v, s2g, a2v = og.decompose(sv)
            b1v, b2v = (1 if s1g < 0 else 0), (1 if s2g < 0 else 0)
        b1 = mg.assign_bit(ctx, b1v)
        b2 = mg.assign_bit(ctx, b2v)
        a1 = mg.assign_value(ctx, a1v)
        a2 = mg.assign_value(ctx, a2v)
        # s - (1-2b1)a1 - LAMBDA*(1-2b2)a2 = 0   (one row, natively mod r)
        L = og.LAMBDA % R
        mg.combine(
            ctx,
            [
                Term.from_assigned(b1, 0),
                Term.from_assigned(a1, R - 1),
                Term.from_assigned(b2, 0),
                Term.from_assigned(a2, (R - L) % R),
                Term.from_assigned(scalar, 1),
            ],
            mul_ab=2,
            mul_cd=2 * L % R,
        )
        bits1 = self.scalar_bits(ctx, a1, nb)
        bits2 = self.scalar_bits(ctx, a2, nb)

        neg_y = ic.neg(ctx, p.y)
        p1 = self.select(ctx, b1, AssignedPoint(p.x, neg_y), p)
        beta_c = ic.assign_constant(ctx, og.BETA)
        x2 = ic.mul(ctx, beta_c, p.x)
        p2 = self.select(
            ctx, b2, AssignedPoint(x2, neg_y), AssignedPoint(x2, p.y)
        )
        return [(p1, bits1), (p2, bits2)]

    def _mul_var_glv(
        self, ctx, p: AssignedPoint, scalar: AssignedValue, window: int = 4
    ) -> AssignedPoint:
        """[s]P via the GLV split: the k=1 case of msm_var.  ~63K rows vs
        86K (windowed) / 122K (round-1 per-bit)."""
        return self.msm_var(ctx, [(p, scalar)], window)

    def msm_var(
        self, ctx, pairs, window: int = 4, plus=()
    ) -> AssignedPoint:
        """sum_i [s_i] P_i with SHARED doublings (in-circuit MSM).

        Each pair is GLV-split into two ~129-bit halves; every half gets
        a 2^window-entry table T[j] = j*P_half + Z, and the single
        accumulator does `window` doubles then 2k table-adds per window.
        The per-window doubling cost (4 x 225 rows) is paid ONCE for the
        whole sum instead of once per point — vs k separate mul_vars this
        saves ~29K rows per extra point.  Junk bookkeeping: every window
        adds Z exactly 2k times, so the correction stays a host constant.

        The reference has no in-circuit MSM at all — its multiopen fold
        is a chain of full-width mul_vars (multiopen.rs:443-492); this is
        the main reason the rebuilt aggregation circuit fits k=21-22
        instead of the reference's k=23.

        `plus`: extra points added once after the ladder — for the
        unit-scalar (u^0 == 1) entries of a fold, which would otherwise
        pay a full 63K-row ladder to multiply by 1."""
        from ...oracle import glv as og

        nb = og.GLV_BITS
        z_const = self.assign_constant_point(ctx, ZERO_ADDEND)
        halves = []
        for p, scalar in pairs:
            halves.extend(self._glv_halves(ctx, p, scalar))

        ladders = []
        for pt, bits in halves:
            tbl = [z_const]
            for _ in range((1 << window) - 1):
                tbl.append(self.add_incomplete(ctx, tbl[-1], pt))
            ladders.append((bits, tbl))

        acc = self.assign_constant_point(ctx, ACC_INIT)
        junk = ACC_INIT
        zk = ZERO_ADDEND
        for _ in range(len(ladders) - 1):
            zk = oc.g1_add(zk, ZERO_ADDEND)
        n_win = (nb + window - 1) // window
        for w in range(n_win - 1, -1, -1):
            lo = w * window
            wsize = min(window, nb - lo)
            for _ in range(wsize):
                acc = self.double(ctx, acc)
            junk = oc.g1_add(oc.g1_mul(junk, 1 << wsize), zk)
            for bits, tbl in ladders:
                acc = self.add_incomplete(
                    ctx,
                    acc,
                    self._select_tree(ctx, bits[lo : lo + wsize], tbl[: 1 << wsize]),
                )
        for pt in plus:
            acc = self.add_incomplete(ctx, acc, pt)
        neg_corr = self.assign_constant_point(ctx, oc.g1_neg(junk))
        return self.add_incomplete(ctx, acc, neg_corr)

    def mul_fixed(
        self, ctx, base, scalar: AssignedValue, nbits: int = 254, window: int = 4
    ) -> AssignedPoint:
        """[s]B for a host-known constant base point (the verifier's
        e-component, [−eval_multi]G1 — multiopen.rs' `e` term).

        With B constant, every window's table is a table of CONSTANTS
        T_w[j] = (j * 2^(window*w)) * B + Z, so the ladder needs NO
        doublings at all: 64 select-trees + 64 incomplete adds
        (~36K rows vs 63K for the GLV variable-base path)."""
        bits = self.scalar_bits(ctx, scalar, nbits)
        acc = self.assign_constant_point(ctx, ACC_INIT)
        junk = ACC_INIT
        n_win = (nbits + window - 1) // window
        for w in range(n_win):
            lo = w * window
            wsize = min(window, nbits - lo)
            base_w = oc.g1_mul(base, 1 << lo)
            tbl = [
                self.assign_constant_point(
                    ctx, oc.g1_add(oc.g1_mul(base_w, j), ZERO_ADDEND)
                )
                for j in range(1 << wsize)
            ]
            junk = oc.g1_add(junk, ZERO_ADDEND)
            addend = self._select_tree(ctx, bits[lo : lo + wsize], tbl)
            acc = self.add_incomplete(ctx, acc, addend)
        neg_corr = self.assign_constant_point(ctx, oc.g1_neg(junk))
        return self.add_incomplete(ctx, acc, neg_corr)

    def mul_var(
        self,
        ctx,
        p: AssignedPoint,
        scalar: AssignedValue,
        nbits: int = 254,
        window: int = 4,
        glv: Optional[bool] = None,
    ) -> AssignedPoint:
        """Variable-base scalar mul (the reference's `mul_var`,
        `src/multiopen.rs:393`), 4-bit windowed.

        MSB-first over ceil(nbits/window) windows: acc starts at the
        constant ACC_INIT; each step does `window` doublings then adds
        T[w] where the in-circuit table T[j] = j*P + Z (Z = ZERO_ADDEND, a
        fixed constant) is built with 2^window - 1 incomplete adds and the
        entry picked by a branchless select tree on the window's bit
        cells.  Every step adds Z exactly once, so the junk contribution
        is the CONSTANT  2^nbits * ACC_INIT + (sum_w 2^(w*window)) * Z,
        subtracted at the end.  Scalars whose intermediate accs collide
        with the table span are astronomically unlikely, so incomplete
        adds stay safe for honest witnesses — and a malicious witness can
        only make the proof UNsatisfiable (the dx != 0 inverse check),
        never wrong.

        window=1 degenerates to the round-1 per-bit double-and-add; at
        window=4 the 482-rows/bit ladder becomes ~330 rows/bit (the 4
        doubles stay, 3 of 4 adds drop, one 15-select tree appears),
        shrinking the outer circuit by ~1.4x.  glv=None auto-enables the
        endomorphism split (another ~1.6x) for full-width scalars."""
        if glv is None:
            glv = nbits >= 200
        if glv:
            return self._mul_var_glv(ctx, p, scalar, window)
        bits = self.scalar_bits(ctx, scalar, nbits)
        z_const = self.assign_constant_point(ctx, ZERO_ADDEND)
        acc = self.assign_constant_point(ctx, ACC_INIT)

        if window == 1:
            p_plus_z = self.add_incomplete(ctx, p, z_const)
            for i in range(nbits - 1, -1, -1):
                acc = self.double(ctx, acc)
                addend = self.select(ctx, bits[i], p_plus_z, z_const)
                acc = self.add_incomplete(ctx, acc, addend)
            corr = oc.g1_add(
                oc.g1_mul(ACC_INIT, 1 << nbits),
                oc.g1_mul(ZERO_ADDEND, (1 << nbits) - 1),
            )
            neg_corr = self.assign_constant_point(ctx, oc.g1_neg(corr))
            return self.add_incomplete(ctx, acc, neg_corr)

        # ---- windowed ladder -------------------------------------------
        # table T[j] = j*P + Z, j in [0, 2^window)
        tbl = [z_const]
        for _ in range((1 << window) - 1):
            tbl.append(self.add_incomplete(ctx, tbl[-1], p))

        n_win = (nbits + window - 1) // window
        junk = ACC_INIT  # host-side mirror of the constant contribution
        for w in range(n_win - 1, -1, -1):
            lo = w * window
            wsize = min(window, nbits - lo)  # top window may be short
            for _ in range(wsize):
                acc = self.double(ctx, acc)
            junk = oc.g1_add(oc.g1_mul(junk, 1 << wsize), ZERO_ADDEND)
            # select tree over this window's bit cells (LSB-first)
            cur = tbl[: 1 << wsize]
            for b in bits[lo : lo + wsize]:
                cur = [
                    self.select(ctx, b, cur[2 * j + 1], cur[2 * j])
                    for j in range(len(cur) // 2)
                ]
            acc = self.add_incomplete(ctx, acc, cur[0])
        neg_corr = self.assign_constant_point(ctx, oc.g1_neg(junk))
        return self.add_incomplete(ctx, acc, neg_corr)
