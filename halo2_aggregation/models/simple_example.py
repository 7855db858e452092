"""The inner test circuit: c = constant * (a*b)^2 with a mul custom gate and
a u8 range lookup.

Re-creation of the reference's `MyCircuit`
(`examples/simple-example.rs:27-392`): two advice columns,
one instance column, one constant fixed column, an s_mul custom gate
(lhs*rhs = out on the next row), and a `s_lookup * adv0 in u8_table`
lookup on the private inputs.  Same witness values as the reference demo:
constant=7, a=2, b=3, public output 252.
"""

from __future__ import annotations

from dataclasses import dataclass

from ..fields import R
from ..plonk.circuit import Assignment, ConstraintSystem, Rotation


@dataclass
class SimpleConfig:
    advice: tuple
    instance: object
    constant: object
    s_mul: object
    s_lookup: object
    u8_table: object


def configure(cs: ConstraintSystem) -> SimpleConfig:
    advice = (cs.advice_column(), cs.advice_column())
    instance = cs.instance_column()
    constant = cs.fixed_column()
    u8_table = cs.lookup_table_column()

    cs.enable_equality(instance)
    cs.enable_constant(constant)
    for c in advice:
        cs.enable_equality(c)

    s_mul = cs.selector()
    s_lookup = cs.complex_selector()

    cs.lookup(
        lambda m: [
            (
                m.query_selector(s_lookup) * m.query_advice(advice[0], Rotation.cur()),
                u8_table,
            )
        ]
    )
    cs.create_gate(
        "mul",
        lambda m: [
            m.query_selector(s_mul)
            * (
                m.query_advice(advice[0], Rotation.cur())
                * m.query_advice(advice[1], Rotation.cur())
                - m.query_advice(advice[0], Rotation.next())
            )
        ],
    )
    return SimpleConfig(advice, instance, constant, s_mul, s_lookup, u8_table)


@dataclass
class MyCircuit:
    constant: int = 7
    a: int | None = 2
    b: int | None = 3

    def public_output(self) -> int:
        assert self.a is not None and self.b is not None
        return self.constant * self.a**2 % R * (self.b**2) % R

    def without_witnesses(self) -> "MyCircuit":
        return MyCircuit(self.constant, None, None)

    def synthesize(self, cs: ConstraintSystem, cfg: SimpleConfig, asg: Assignment):
        # u8 range table (simple-example.rs:351-361)
        table = asg.table()
        for i in range(256):
            table.assign_cell(cfg.u8_table, i, i)

        adv0, adv1 = cfg.advice

        def mul_region(row, lhs_cell, rhs_cell, lhs_val, rhs_val):
            asg.enable_selector(cfg.s_mul, row)
            asg.assign_advice(adv0, row, lhs_val)
            asg.assign_advice(adv1, row, rhs_val)
            asg.copy(adv0, row, *lhs_cell)
            asg.copy(adv1, row, *rhs_cell)
            out = None if lhs_val is None or rhs_val is None else lhs_val * rhs_val % R
            asg.assign_advice(adv0, row + 1, out)
            return (adv0, row + 1), out

        # load private a, b (rows 0, 1) with the u8 lookup enabled
        asg.assign_advice(adv0, 0, self.a)
        asg.enable_selector(cfg.s_lookup, 0)
        asg.assign_advice(adv0, 1, self.b)
        asg.enable_selector(cfg.s_lookup, 1)
        # load constant (row 2), pinned to the constant fixed column
        asg.assign_fixed(cfg.constant, 0, self.constant)
        asg.assign_advice(adv0, 2, self.constant)
        asg.copy(adv0, 2, cfg.constant, 0)

        ab_cell, ab = mul_region(3, (adv0, 0), (adv0, 1), self.a, self.b)
        absq_cell, absq = mul_region(5, ab_cell, ab_cell, ab, ab)
        c_cell, c = mul_region(7, (adv0, 2), absq_cell, self.constant, absq)

        # expose c as public input row 0
        asg.copy(c_cell[0], c_cell[1], cfg.instance, 0)


def build(circuit: MyCircuit, k: int = 9):
    """configure + synthesize; returns (cs, cfg, assignment)."""
    cs = ConstraintSystem()
    cfg = configure(cs)
    asg = Assignment(cs, 1 << k)
    if circuit.a is not None:
        asg.set_instance(cfg.instance, [circuit.public_output()])
    circuit.synthesize(cs, cfg, asg)
    return cs, cfg, asg
