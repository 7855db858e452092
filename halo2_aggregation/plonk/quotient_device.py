"""Device quotient pass for the scaled prover (plain XLA).

The quotient h(X) is the prover's dominant polynomial cost at
outer-circuit scale.  Per coset the work is embarrassingly parallel over
the 2^k rows: a size-n coset NTT per committed column, then one big
pointwise constraint-expression evaluation.

This module mirrors `prover_native.create_proof_native`'s per-coset block
bit-for-bit, but runs it on the device:

  host                                  device
  ----                                  ------
  coefficient columns (mont u64) --H2D--> packed (n,32) uint8, ONCE
                                         per coset:
                                           shift-power ladder (log n muls)
                                           coset NTT per column
                                           rolled leaves (jnp.roll)
                                           gate/perm/lookup expressions
                                             via protocol.py + LimbOps
                                           fold_y, * 1/(shift^n - 1)
  h coset evals (mont u64) <--D2H-- packed uint8 slabs

Design notes:
* Columns live on the device as (n, 32) uint8 byte views of the
  (n, 4)-u64 mont limbs — the u64 LE byte layout IS the 32x8-bit LE limb
  sequence, so H2D costs 32B/row and unpack is a dtype widen
  (ops/ntt.py:unpack8).
* The expression pass runs in row slabs (default 2^17) so the unpacked
  leaf working set stays bounded regardless of k.
* Every jitted function is shape-stable across cosets AND proofs of the
  same (cs, k): challenges, shift powers and the vanishing inverse are
  arguments, not constants.

The reference's analog is the rayon-parallel `create_proof` quotient
evaluation inside its private halo2 fork (SURVEY.md §2b); the reference
itself never parallelizes beyond one CPU (SURVEY.md §2d).
"""

from __future__ import annotations

import numpy as np

from ..fields import R, fr_omega
from ..ops import field_ops as fo
from ..ops import ntt as nt
from .circuit import ConstraintSystem
from .protocol import (
    LimbOps,
    LookupEvals,
    PermutationSetEvals,
    fold_y,
    gate_expressions,
    lookup_expressions,
    permutation_expressions,
)


def leaf_schedule(cs: ConstraintSystem, bf: int, num_chunks: int):
    """The engine's stable, deduped (key, rot) leaf order and the
    distinct-column order derived from it."""
    sched: list = []
    seen = set()

    def add(key, rot):
        if (key, rot) not in seen:
            seen.add((key, rot))
            sched.append((key, rot))

    for c, rot in cs.advice_queries:
        add(("advice", c.index), rot.value)
    for c, rot in cs.fixed_queries:
        add(("fixed", c.index), rot.value)
    for c, rot in cs.instance_queries:
        add(("instance", c.index), rot.value)
    for i in range(len(cs.permutation_columns)):
        add(("sigma", i), 0)
    for ci in range(num_chunks):
        add(("perm_z", ci), 0)
        add(("perm_z", ci), 1)
        if ci < num_chunks - 1:
            add(("perm_z", ci), -(bf + 1))
    for li in range(len(cs.lookups)):
        add(("lookup_z", li), 0)
        add(("lookup_z", li), 1)
        add(("lookup_a", li), 0)
        add(("lookup_a", li), -1)
        add(("lookup_s", li), 0)
    add(("l0", 0), 0)
    add(("llast", 0), 0)
    add(("lblind", 0), 0)
    key_order = []
    seen_k = set()
    for key, _ in sched:
        if key not in seen_k:
            seen_k.add(key)
            key_order.append(key)
    return sched, key_order


def _pack_host(col_u64: np.ndarray) -> np.ndarray:
    """(n, 4) uint64 mont -> (n, 32) uint8 byte view (zero-copy)."""
    a = np.ascontiguousarray(col_u64, dtype="<u8")
    return a.view(np.uint8).reshape(a.shape[0], 32)


def _unpack_host(packed: np.ndarray) -> np.ndarray:
    """(n, 32) uint8 -> (n, 4) uint64."""
    return (
        np.ascontiguousarray(packed, dtype=np.uint8)
        .view("<u8")
        .astype(np.uint64)
    )


class DeviceQuotient:
    """One instance per (cs, k) and proof.  The prover feeds every leaf
    column once (`feed_evals`), as (n, 4)-u64 Montgomery evaluations:
      ("advice", i) / ("fixed", i) / ("instance", i)  committed columns
      ("sigma", i)                                    permutation sigmas
      ("perm_z", ci)                                  grand products
      ("lookup_a"|"lookup_s"|"lookup_z", li)          lookup polys
      ("l0"|"llast"|"lblind", 0)                      Lagrange selectors
    then calls `finalize()` and `run_coset()` once per coset."""

    def __init__(self, cs: ConstraintSystem, k: int):
        import jax
        import jax.numpy as jnp

        from .engine import NativeDomain

        self.cs = cs
        self.k = k
        self.n = 1 << k
        self.bf = cs.blinding_factors()
        self.chunk_len = cs.degree() - 2
        self.num_chunks = (
            len(cs.permutation_columns) + self.chunk_len - 1
        ) // self.chunk_len
        plan = nt.NttPlan(k, fr_omega(k))
        self.bitrev = jnp.asarray(plan.bitrev)
        self.twiddles = tuple(jnp.asarray(t) for t in plan.stage_twiddles)
        self.store = {}
        self._host_dom = NativeDomain(k)
        self._finalized = False
        # stable, deduped (key, rot) leaf order
        self.schedule, self.key_order = leaf_schedule(
            cs, self.bf, self.num_chunks
        )

        # The coset extension runs as a Python-driven pipeline of SMALL
        # jitted pieces (pre: unpack+shift-mul+bit-reverse; 3 NTT stages
        # per call; post: pack) rather than one k-stage executable, so
        # each call keeps ~3 (n, 32)-int32 stage buffers live.
        self._pre_fn = jax.jit(
            lambda p, sp, br: fo.mont_mul_big(
                nt.unpack8(p), sp, fo.FR, chunk=1 << 16
            )[br]
        )
        self._stage_fn = jax.jit(self._stage_group)
        self._pack_fn = jax.jit(nt.pack8)
        self._slab_fn = jax.jit(self._make_slab_fn())
        self._mul_pack = jax.jit(
            lambda a, b: nt.pack8(
                fo.mont_mul_big(a, jnp.broadcast_to(b, a.shape), fo.FR)
            )
        )

    @staticmethod
    def bytes_needed(cs: ConstraintSystem, k: int) -> int:
        """Device bytes one proof's engine holds at its peak: the packed
        coefficient columns, their coset extensions and the rolled leaves
        (32 B per row each), plus the int32 working set of the NTT stages
        and one expression slab."""
        bf = cs.blinding_factors()
        chunk_len = cs.degree() - 2
        num_chunks = (len(cs.permutation_columns) + chunk_len - 1) // chunk_len
        sched, keys = leaf_schedule(cs, bf, num_chunks)
        n = 1 << k
        packed = (2 * len(keys) + len(sched)) * 32 * n
        stage = 4 * n * fo.NLIMBS * 4
        slab = len(sched) * min(n, 1 << 17) * fo.NLIMBS * 4 * 4
        return packed + stage + slab

    def feed_evals(self, key, col_m):
        """Take one column as natural-order Montgomery EVALUATIONS: the
        host INTTs it and ships the packed coefficients."""
        import jax.numpy as jnp

        assert not self._finalized, "feed_evals() after finalize()"
        self.store[key] = jnp.asarray(_pack_host(self._host_dom.intt(col_m)))

    def finalize(self):
        """Check every leaf column arrived; build the omega powers."""
        import jax.numpy as jnp

        assert not self._finalized, "finalize() twice"
        missing = set(self.key_order) - set(self.store)
        assert not missing, f"finalize before feed of {sorted(missing)}"
        self._finalized = True
        # omega powers (coset_x = shift*omega^i), computed on-device
        omega_m = jnp.asarray(fo.FR.to_mont(fr_omega(self.k)))
        self.omega_pows = nt.pow_series_dev(omega_m, self.n)

    # -- per-column coset extension ----------------------------------------
    @staticmethod
    def _stage_group(x, tws):
        """Apply a group of consecutive CT butterfly stages; `tws` is a
        tuple of (2^s, 32) twiddle tables (shapes fix the stage indices)."""
        import jax.numpy as jnp

        n = x.shape[0]
        for tw in tws:
            half = tw.shape[0]
            m = half * 2
            a = x.reshape(n // m, m, fo.NLIMBS)
            lo = a[:, :half]
            hi = a[:, half:]
            t = fo.mont_mul_big(
                hi, jnp.broadcast_to(tw[None], hi.shape), fo.FR, chunk=1 << 16
            )
            x = jnp.concatenate(
                [fo.add(lo, t, fo.FR), fo.sub(lo, t, fo.FR)], axis=1
            ).reshape(n, fo.NLIMBS)
        return x

    def _extend(self, packed, shift_pows, stages_per_call=3):
        x = self._pre_fn(packed, shift_pows, self.bitrev)
        k = len(self.twiddles)
        for s0 in range(0, k, stages_per_call):
            x = self._stage_fn(x, tuple(self.twiddles[s0 : s0 + stages_per_call]))
        return self._pack_fn(x)

    # -- the pointwise expression pass over one row slab ---------------------
    def _make_slab_fn(self):
        cs = self.cs
        schedule = list(self.schedule)
        chunk_len = self.chunk_len
        num_chunks = self.num_chunks

        class _SlabOps(LimbOps):
            """Expression muls in lax.map slabs: the expression DAG holds
            ~12 independent products live, and a full-slab product's
            limb-convolution temps are ~8KB per row.  Chunked muls cap
            each product's temps at ~128MB and XLA reuses the map body's
            buffers across iterations."""

            def mul(self, a, b):
                return self.fo.mont_mul_big(
                    a, b, self.FR, chunk=1 << 14, force=True
                )

        def slab_fn(leaves, coset_x, theta, beta, gamma, y, vinv):
            ops = _SlabOps()
            vals = {
                sk: nt.unpack8(l) for sk, l in zip(map(tuple, schedule), leaves)
            }

            def leaf(kind, idx, rot=0):
                return vals[((kind, idx), rot)]

            adv = [
                leaf("advice", c.index, rot.value)
                for c, rot in cs.advice_queries
            ]
            fix = [
                leaf("fixed", c.index, rot.value)
                for c, rot in cs.fixed_queries
            ]
            inst = [
                leaf("instance", c.index, rot.value)
                for c, rot in cs.instance_queries
            ]
            sigma = [
                leaf("sigma", i) for i in range(len(cs.permutation_columns))
            ]
            l0 = leaf("l0", 0)
            llast = leaf("llast", 0)
            lblind = leaf("lblind", 0)
            x = nt.unpack8(coset_x)

            exprs = gate_expressions(ops, cs, adv, fix, inst)
            perm_sets = [
                PermutationSetEvals(
                    z=leaf("perm_z", ci),
                    z_next=leaf("perm_z", ci, 1),
                    z_last=(
                        leaf("perm_z", ci, -(self.bf + 1))
                        if ci < num_chunks - 1
                        else None
                    ),
                )
                for ci in range(num_chunks)
            ]
            exprs += permutation_expressions(
                ops, cs, perm_sets, sigma, adv, fix, inst,
                l0, llast, lblind, beta, gamma, x, chunk_len,
            )
            for li, arg in enumerate(cs.lookups):
                ev = LookupEvals(
                    z=leaf("lookup_z", li),
                    z_next=leaf("lookup_z", li, 1),
                    a_prime=leaf("lookup_a", li),
                    a_prime_prev=leaf("lookup_a", li, -1),
                    s_prime=leaf("lookup_s", li),
                )
                exprs += lookup_expressions(
                    ops, ev, arg, l0, llast, lblind,
                    theta, beta, gamma, adv, fix, inst,
                )
            num = fold_y(ops, exprs, y)
            num = ops.mul(num, vinv)
            return nt.pack8(num)

        return slab_fn

    # -- driver --------------------------------------------------------------
    def run_coset(
        self,
        shift: int,
        theta: int,
        beta: int,
        gamma: int,
        y: int,
        slab_log2: int = 17,
    ) -> np.ndarray:
        """h-numerator/vanishing evals on the {shift * omega^i} coset,
        returned as a (n, 4) uint64 Montgomery array (matches the value
        prover_native stores into h_ext_m[cj::step])."""
        import jax.numpy as jnp

        assert self._finalized, "run_coset() before finalize()"
        n = self.n
        shift_m = jnp.asarray(fo.FR.to_mont(shift))
        vinv = pow((pow(shift, n, R) - 1) % R, -1, R)

        shift_pows = nt.pow_series_dev(shift_m, n)
        ext = {}
        for key, p in self.store.items():
            # one column at a time: bounds the live stage buffers
            ext[key] = self._extend(p, shift_pows).block_until_ready()
        leaves_full = []
        for key, rot in self.schedule:
            e = ext[key]
            leaves_full.append(jnp.roll(e, -rot, axis=0) if rot else e)
        coset_x = self._mul_pack(self.omega_pows, shift_m)

        th = jnp.asarray(fo.FR.to_mont(theta))
        be = jnp.asarray(fo.FR.to_mont(beta))
        ga = jnp.asarray(fo.FR.to_mont(gamma))
        yy = jnp.asarray(fo.FR.to_mont(y))
        vi = jnp.asarray(fo.FR.to_mont(vinv))

        slab = min(1 << slab_log2, n)
        outs = []
        for s0 in range(0, n, slab):
            sl = tuple(l[s0 : s0 + slab] for l in leaves_full)
            outs.append(
                np.asarray(
                    self._slab_fn(sl, coset_x[s0 : s0 + slab], th, be, ga, yy, vi)
                )
            )
        packed = np.concatenate(outs, axis=0)
        return _unpack_host(packed)
