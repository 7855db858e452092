"""MockProver-equivalent: evaluate every constraint on the witness directly.

The reference's only fast correctness oracle is halo2's MockProver
(`examples/simple-example.rs:601-602`, `:674-675`,
SURVEY.md §4).  Ours checks gates on every row, copy constraints, and
lookup multiset inclusion, columnwise over Python ints.
"""

from __future__ import annotations

from typing import List

from ..fields import R
from .circuit import Any, Assignment, ConstraintSystem, evaluate_expr


def _column_values(assignment: Assignment, col):
    if col.kind == Any.ADVICE:
        return [0 if v is None else v for v in assignment.advice[col.index]]
    if col.kind == Any.FIXED:
        return assignment.fixed[col.index]
    return assignment.instance[col.index]


def _row_eval(cs, expr, assignment, row, n):
    def getter(queries):
        def get(qi):
            col, rot = queries[qi]
            return _column_values(assignment, col)[(row + rot.value) % n]

        return get

    return evaluate_expr(
        expr,
        constant=lambda v: v % R,
        fixed=getter(cs.fixed_queries),
        advice=getter(cs.advice_queries),
        instance=getter(cs.instance_queries),
        add=lambda a, b: (a + b) % R,
        mul=lambda a, b: a * b % R,
        negate=lambda a: (-a) % R,
        scale=lambda a, v: a * v % R,
    )


def mock_verify_fast(cs: ConstraintSystem, assignment: Assignment) -> List[str]:
    """Columnwise MockProver: evaluates each gate over whole columns with
    the vectorized int backend — O(gates) passes instead of O(rows*gates)
    Python dispatch.  Use for the large aggregation circuits (k >= 14)."""
    from .protocol import VecIntOps, eval_expression

    n = assignment.n
    usable = cs.usable_rows(n)
    failures: List[str] = []
    ops = VecIntOps()

    _colcache = {}

    def col_vals(col):
        key = (col.kind, col.index)
        if key not in _colcache:
            vals = _column_values(assignment, col)
            _colcache[key] = [0 if v is None else v for v in vals]
        return _colcache[key]

    def rolled(col, rot):
        vals = col_vals(col)
        s = rot % n
        return vals[s:] + vals[:s] if s else vals

    adv = [rolled(c, rot.value) for c, rot in cs.advice_queries]
    fix = [rolled(c, rot.value) for c, rot in cs.fixed_queries]
    inst = [rolled(c, rot.value) for c, rot in cs.instance_queries]

    for name, expr in cs.gates:
        out = eval_expression(ops, expr, adv, fix, inst)
        if isinstance(out, int):
            out = [out] * n
        bad = [i for i, v in enumerate(out) if v != 0]
        if bad:
            failures.append(
                f"gate '{name}' violated at rows {bad[:5]}{'...' if len(bad) > 5 else ''}"
            )

    for c1, r1, c2, r2 in assignment.copies:
        v1 = col_vals(c1)[r1]
        v2 = col_vals(c2)[r2]
        if v1 != v2:
            failures.append(
                f"copy ({c1.kind.value}{c1.index},{r1}) != ({c2.kind.value}{c2.index},{r2})"
            )
            if len(failures) > 20:
                break

    for li, arg in enumerate(cs.lookups):
        tbl_cols = [
            eval_expression(ops, e, adv, fix, inst) for e in arg.table_expressions
        ]
        tbl_cols = [[c] * n if isinstance(c, int) else c for c in tbl_cols]
        table = set(zip(*[c[:usable] for c in tbl_cols]))
        in_cols = [
            eval_expression(ops, e, adv, fix, inst) for e in arg.input_expressions
        ]
        in_cols = [[c] * n if isinstance(c, int) else c for c in in_cols]
        for row, tup in enumerate(zip(*[c[:usable] for c in in_cols])):
            if tup not in table:
                failures.append(f"lookup {li} failed at row {row}: {tup}")
                if len(failures) > 20:
                    return failures
    return failures


def mock_verify(cs: ConstraintSystem, assignment: Assignment) -> List[str]:
    """Returns a list of failure descriptions (empty == circuit satisfied)."""
    n = assignment.n
    failures = []
    usable = cs.usable_rows(n)

    # gates on every row (selectors gate them off where unused)
    for name, expr in cs.gates:
        for row in range(n):
            if _row_eval(cs, expr, assignment, row, n) != 0:
                failures.append(f"gate '{name}' violated at row {row}")

    # copy constraints
    for c1, r1, c2, r2 in assignment.copies:
        v1 = _column_values(assignment, c1)[r1]
        v2 = _column_values(assignment, c2)[r2]
        if v1 != v2:
            failures.append(
                f"copy ({c1.kind.value}{c1.index},{r1}) != ({c2.kind.value}{c2.index},{r2}): {v1} vs {v2}"
            )

    # lookups: tuple of input expr values must appear among table tuples
    for li, arg in enumerate(cs.lookups):
        table_rows = set()
        for row in range(usable):
            table_rows.add(
                tuple(
                    _row_eval(cs, e, assignment, row, n)
                    for e in arg.table_expressions
                )
            )
        for row in range(usable):
            tup = tuple(
                _row_eval(cs, e, assignment, row, n) for e in arg.input_expressions
            )
            if tup not in table_rows:
                failures.append(f"lookup {li} failed at row {row}: {tup}")

    return failures
