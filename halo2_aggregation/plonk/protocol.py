"""The protocol algebra, written once over an abstract scalar backend.

The reference evaluates its constraint formulas three times in different
guises (native verifier in the halo2 fork, in-circuit verifier chips in
`src/lookup.rs`/`src/permutation.rs`/`src/vanishing.rs`, and the prover's
quotient evaluation).  Here each formula is written once against a
`ScalarOps` backend and reused by:

* the prover (backend = batched limb arrays over the extended coset domain)
* the host verifier (backend = Python ints)
* the device verifier (backend = limb arrays, batched over proofs)
* round 2+: the in-circuit verifier (backend = constraint-emitting gadgets)

This mirrors — and de-duplicates — the reference's chip formulas:
  lookup constraints:      src/lookup.rs:190-310
  permutation constraints: src/permutation.rs:210-323
  y-fold + h division:     src/vanishing.rs:146-175
  query schedule:          src/verifier.rs:654-715
  rotation grouping:       src/multiopen.rs:19-45
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any as PyAny
from typing import Callable, List, Sequence, Tuple

from ..fields import FR_DELTA, R
from .circuit import Any, ConstraintSystem, Rotation, evaluate_expr


class ScalarOps:
    """Abstract field-scalar backend (values are opaque handles)."""

    def constant(self, v: int):
        raise NotImplementedError

    def add(self, a, b):
        raise NotImplementedError

    def sub(self, a, b):
        raise NotImplementedError

    def mul(self, a, b):
        raise NotImplementedError

    def neg(self, a):
        raise NotImplementedError

    def scale(self, a, v: int):
        return self.mul(a, self.constant(v))


class IntOps(ScalarOps):
    """Python ints mod r — the host/native backend."""

    def constant(self, v):
        return v % R

    def add(self, a, b):
        return (a + b) % R

    def sub(self, a, b):
        return (a - b) % R

    def mul(self, a, b):
        return a * b % R

    def neg(self, a):
        return (-a) % R

    def scale(self, a, v):
        return a * v % R


class VecIntOps(ScalarOps):
    """Lists of Python ints mod r (a whole domain at once) — used by the
    host prover's quotient evaluation.  Scalars broadcast."""

    def _bc(self, a, b):
        if isinstance(a, int) and isinstance(b, list):
            a = [a] * len(b)
        if isinstance(b, int) and isinstance(a, list):
            b = [b] * len(a)
        return a, b

    def constant(self, v):
        return v % R

    def add(self, a, b):
        a, b = self._bc(a, b)
        if isinstance(a, int):
            return (a + b) % R
        return [(x + y) % R for x, y in zip(a, b)]

    def sub(self, a, b):
        a, b = self._bc(a, b)
        if isinstance(a, int):
            return (a - b) % R
        return [(x - y) % R for x, y in zip(a, b)]

    def mul(self, a, b):
        a, b = self._bc(a, b)
        if isinstance(a, int):
            return a * b % R
        return [x * y % R for x, y in zip(a, b)]

    def neg(self, a):
        if isinstance(a, int):
            return (-a) % R
        return [(-x) % R for x in a]

    def scale(self, a, v):
        if isinstance(a, int):
            return a * v % R
        return [x * v % R for x in a]


class LimbOps(ScalarOps):
    """jnp limb arrays in Montgomery form — the device backend.  Values may be
    any mutually-broadcastable (..., 32) arrays."""

    def __init__(self):
        from ..ops import field_ops as fo

        self.fo = fo
        self.FR = fo.FR

    def constant(self, v):
        import jax.numpy as jnp

        return jnp.asarray(self.FR.to_mont(v % R))

    def add(self, a, b):
        return self.fo.add(a, b, self.FR)

    def sub(self, a, b):
        return self.fo.sub(a, b, self.FR)

    def mul(self, a, b):
        return self.fo.mont_mul(a, b, self.FR)

    def neg(self, a):
        return self.fo.neg(a, self.FR)


# ---------------------------------------------------------------------------
# expression evaluation over a backend
# ---------------------------------------------------------------------------


def eval_expression(ops: ScalarOps, expr, advice, fixed, instance):
    """The shared `compute_expr` (reference: verifier.rs:58-151): leaves
    index into per-query value lists."""
    return evaluate_expr(
        expr,
        constant=ops.constant,
        fixed=lambda qi: fixed[qi],
        advice=lambda qi: advice[qi],
        instance=lambda qi: instance[qi],
        add=ops.add,
        mul=ops.mul,
        negate=ops.neg,
        scale=ops.scale,
    )


def gate_expressions(ops, cs: ConstraintSystem, advice, fixed, instance) -> list:
    return [
        eval_expression(ops, e, advice, fixed, instance) for _, e in cs.gates
    ]


def compress_expressions(ops, exprs, theta, advice, fixed, instance):
    """theta-fold:  acc = acc * theta + eval  (lookup.rs:214-243)."""
    acc = ops.constant(0)
    for e in exprs:
        v = eval_expression(ops, e, advice, fixed, instance)
        acc = ops.add(ops.mul(acc, theta), v)
    return acc


def _register_pytree_dataclass(cls):
    """Register as a JAX pytree so batched-verifier structures shard/jit;
    harmless for the host-int backends (ints are leaves)."""
    try:
        import jax

        return jax.tree_util.register_dataclass(cls)
    except Exception:
        return cls


@_register_pytree_dataclass
@dataclass
class LookupEvals:
    """The 5 transcript evals of one lookup argument (lookup.rs:31-39)."""

    z: PyAny  # Z(x)
    z_next: PyAny  # Z(wx)
    a_prime: PyAny  # A'(x)
    a_prime_prev: PyAny  # A'(w^-1 x)
    s_prime: PyAny  # S'(x)


def lookup_expressions(
    ops,
    ev: LookupEvals,
    argument,
    l_0,
    l_last,
    l_blind,
    theta,
    beta,
    gamma,
    advice,
    fixed,
    instance,
) -> list:
    """The 5 lookup constraints, formula-for-formula with
    lookup.rs:190-310."""
    one = ops.constant(1)
    active = ops.sub(one, ops.add(l_last, l_blind))

    e1 = ops.mul(l_0, ops.sub(one, ev.z))
    e2 = ops.mul(l_last, ops.sub(ops.mul(ev.z, ev.z), ev.z))

    left = ops.mul(
        ops.mul(ops.add(ev.a_prime, beta), ops.add(ev.s_prime, gamma)), ev.z_next
    )
    inp = compress_expressions(
        ops, argument.input_expressions, theta, advice, fixed, instance
    )
    tbl = compress_expressions(
        ops, argument.table_expressions, theta, advice, fixed, instance
    )
    right = ops.mul(ops.mul(ops.add(inp, beta), ops.add(tbl, gamma)), ev.z)
    e3 = ops.mul(active, ops.sub(left, right))

    a_sub_s = ops.sub(ev.a_prime, ev.s_prime)
    e4 = ops.mul(l_0, a_sub_s)
    e5 = ops.mul(active, ops.mul(a_sub_s, ops.sub(ev.a_prime, ev.a_prime_prev)))
    return [e1, e2, e3, e4, e5]


@_register_pytree_dataclass
@dataclass
class PermutationSetEvals:
    """Per-chunk grand-product evals (permutation.rs:25-30)."""

    z: PyAny
    z_next: PyAny
    z_last: PyAny  # None for the final set


def permutation_expressions(
    ops,
    cs: ConstraintSystem,
    sets: List[PermutationSetEvals],
    sigma_evals: list,
    advice,
    fixed,
    instance,
    l_0,
    l_last,
    l_blind,
    beta,
    gamma,
    x,
    chunk_len: int,
) -> list:
    """Chunked permutation constraints (permutation.rs:190-324).

    `x` is the evaluation-point handle: the scalar challenge x for the
    verifier, or the array of coset-domain points for the prover."""
    one = ops.constant(1)
    columns = cs.permutation_columns
    assert len(sigma_evals) == len(columns)

    def column_eval(col):
        # resolve the cur-rotation query of this column
        qlists = {
            Any.ADVICE: (cs.advice_queries, advice),
            Any.FIXED: (cs.fixed_queries, fixed),
            Any.INSTANCE: (cs.instance_queries, instance),
        }
        queries, vals = qlists[col.kind]
        for qi, (c, rot) in enumerate(queries):
            if c == col and rot.value == 0:
                return vals[qi]
        raise KeyError(f"no cur query for permutation column {col}")

    exprs = []
    exprs.append(ops.mul(l_0, ops.sub(one, sets[0].z)))  # 1
    z_l = sets[-1].z
    exprs.append(ops.mul(l_last, ops.sub(ops.mul(z_l, z_l), z_l)))  # 2
    for i in range(1, len(sets)):  # 3: chunk stitching
        exprs.append(ops.mul(l_0, ops.sub(sets[i].z, sets[i - 1].z_last)))

    deltas = [1]
    for _ in range(len(columns) - 1):
        deltas.append(deltas[-1] * FR_DELTA % R)

    active = ops.sub(one, ops.add(l_last, l_blind))
    for ci in range(len(sets)):
        cols = columns[ci * chunk_len : (ci + 1) * chunk_len]
        sigs = sigma_evals[ci * chunk_len : (ci + 1) * chunk_len]
        left = sets[ci].z_next
        for col, sig in zip(cols, sigs):
            v = column_eval(col)
            term = ops.add(ops.add(ops.mul(beta, sig), v), gamma)
            left = ops.mul(left, term)
        right = sets[ci].z
        for t, col in enumerate(cols):
            v = column_eval(col)
            k = ci * chunk_len + t
            term = ops.add(
                ops.add(ops.mul(ops.scale(beta, deltas[k]), x), v), gamma
            )
            right = ops.mul(right, term)
        exprs.append(ops.mul(active, ops.sub(left, right)))
    return exprs


def fold_y(ops, exprs: Sequence, y):
    """acc = expr_0; acc = acc*y + expr_i — vanishing.rs:146-155."""
    acc = exprs[0]
    for e in exprs[1:]:
        acc = ops.add(ops.mul(acc, y), e)
    return acc


# ---------------------------------------------------------------------------
# query schedule (order is bit-exactness critical)
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class Q:
    """A symbolic multiopen query: who is opened, where."""

    kind: str  # instance|advice|fixed|perm_z|lookup_z|lookup_a|lookup_s|sigma|vanishing_h|vanishing_r
    index: int  # query_index / set index / lookup index / column index
    rotation: int  # signed rotation


def query_schedule(
    cs: ConstraintSystem, num_perm_sets: int, num_lookups: int
) -> List[Q]:
    """Query list in the reference's exact order (verifier.rs:654-715):
    instance, advice, permutation sets, lookups, fixed, sigma commitments,
    vanishing (H then r)."""
    bf = cs.blinding_factors()
    last_rot = -(bf + 1)
    out: List[Q] = []
    for qi, (_, rot) in enumerate(cs.instance_queries):
        out.append(Q("instance", qi, rot.value))
    for qi, (_, rot) in enumerate(cs.advice_queries):
        out.append(Q("advice", qi, rot.value))
    # permutation: per set (cur, next); then all-but-last sets reversed at
    # Rotation(-(bf+1))  (permutation.rs:332-358)
    for s in range(num_perm_sets):
        out.append(Q("perm_z", s, 0))
        out.append(Q("perm_z", s, 1))
    for s in range(num_perm_sets - 2, -1, -1):
        out.append(Q("perm_z_last", s, last_rot))
    # lookups: Z cur, A' cur, S' cur, A' prev, Z next  (lookup.rs:314-348)
    for li in range(num_lookups):
        out.append(Q("lookup_z", li, 0))
        out.append(Q("lookup_a", li, 0))
        out.append(Q("lookup_s", li, 0))
        out.append(Q("lookup_a", li, -1))
        out.append(Q("lookup_z", li, 1))
    for qi, (_, rot) in enumerate(cs.fixed_queries):
        out.append(Q("fixed", qi, rot.value))
    for ci in range(len(cs.permutation_columns)):
        out.append(Q("sigma", ci, 0))
    out.append(Q("vanishing_h", 0, 0))
    out.append(Q("vanishing_r", 0, 0))
    return out


def rotation_sets(queries: Sequence[Q]) -> List[Tuple[int, List[Q]]]:
    """Group by rotation, ascending signed order, preserving insertion order
    within a set (multiopen.rs:19-45: BTreeMap<Rotation, Vec<Q>>)."""
    by_rot = {}
    for q in queries:
        by_rot.setdefault(q.rotation, []).append(q)
    return sorted(by_rot.items(), key=lambda kv: kv[0])
