"""Measure in-circuit row costs of the EccChip primitives.

Run: python tools/row_costs.py
"""

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from halo2_aggregation.models import aggregation_circuit as ac
from halo2_aggregation.aggregation.gadgets.main_gate import Ctx
from halo2_aggregation.oracle import curve as oc
from halo2_aggregation.plonk.circuit import Assignment, ConstraintSystem


def main():
    cs = ConstraintSystem()
    cfg = ac.configure(cs)
    asg = Assignment(cs, 1 << 18)
    cfg.rc.load_table(asg)
    ctx = Ctx(asg)
    ecc, mg, ic = cfg.ecc, cfg.mg, cfg.ic

    g = oc.g1_generator()
    p = oc.g1_mul(g, 12345)
    q = oc.g1_mul(g, 67890)

    def cost(label, fn):
        before = ctx.offset
        out = fn()
        print(f"{label:28s} {ctx.offset - before:7d} rows")
        return out

    pa = cost("assign_point", lambda: ecc.assign_point(ctx, p))
    qa = cost("assign_point(2)", lambda: ecc.assign_point(ctx, q))
    cost("add_incomplete", lambda: ecc.add_incomplete(ctx, pa, qa))
    cost("double", lambda: ecc.double(ctx, pa))
    bit = mg.assign_bit(ctx, 1)
    cost("select(point)", lambda: ecc.select(ctx, bit, pa, qa))
    sc = mg.assign_value(ctx, 0x1234567890ABCDEF)
    cost("scalar_bits(254)", lambda: ecc.scalar_bits(ctx, sc, 254))
    cost("assign_integer", lambda: ic.assign_integer(ctx, 424242))
    a = ic.assign_integer(ctx, 10**30)
    b = ic.assign_integer(ctx, 10**29)
    cost("ic.mul", lambda: ic.mul(ctx, a, b))
    cost("ic.assert_mul_equals", lambda: ic.assert_mul_equals(ctx, a, b, ic.mul(ctx, a, b)))
    cost("ic.add", lambda: ic.add(ctx, a, b))
    cost("ic.sub", lambda: ic.sub(ctx, a, b))
    sc2 = mg.assign_value(ctx, 0xDEADBEEF)
    cost("mul_var(254)", lambda: ecc.mul_var(ctx, pa, sc2, 254))


if __name__ == "__main__":
    main()
