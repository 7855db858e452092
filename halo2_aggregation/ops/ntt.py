"""Radix-2 NTT over Fr in JAX — the device polynomial engine for the prover.

The reference delegates all polynomial work to its halo2 fork's prover
(SURVEY.md §2b: `create_proof`); here it is a batched device op:
iterative Cooley-Tukey with host-precomputed twiddle tables, every butterfly
stage a fully-vectorized batched `mont_mul` over the whole domain (no
sequential inner loops; `k` stages are statically unrolled under jit).

Values are (n, 32) Montgomery-form Fr limb arrays.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np

from ..fields import R, fr_omega
from . import field_ops as fo
from .field_ops import FR


def _bit_reverse_indices(k: int) -> np.ndarray:
    n = 1 << k
    idx = np.arange(n)
    rev = np.zeros(n, dtype=np.int64)
    for b in range(k):
        rev |= ((idx >> b) & 1) << (k - 1 - b)
    return rev


class NttPlan:
    """Host-precomputed tables for a size-2^k NTT (twiddles in mont form)."""

    def __init__(self, k: int, omega: int):
        self.k = k
        self.n = 1 << k
        self.omega = omega
        assert pow(omega, self.n, R) == 1 and pow(omega, self.n // 2, R) != 1
        self.bitrev = _bit_reverse_indices(k)
        # stage s (s = 0..k-1) uses twiddles w_m^j, m = 2^(s+1), j < 2^s,
        # where w_m = omega^(n/m)
        self.stage_twiddles = []
        for s in range(k):
            m = 1 << (s + 1)
            w_m = pow(omega, self.n // m, R)
            tw = [pow(w_m, j, R) for j in range(1 << s)]
            self.stage_twiddles.append(FR.to_mont_array(tw))


@functools.partial(jax.jit, static_argnums=(1,))
def _ntt_core(values, plan: NttPlan):
    x = values[jnp.asarray(plan.bitrev)]
    n = plan.n
    for s in range(plan.k):
        half = 1 << s
        m = half * 2
        a = x.reshape(n // m, m, fo.NLIMBS)
        lo = a[:, :half]
        hi = a[:, half:]
        tw = jnp.asarray(plan.stage_twiddles[s])[None, :, :]
        t = fo.mont_mul(hi, jnp.broadcast_to(tw, hi.shape), FR)
        x = jnp.concatenate([fo.add(lo, t, FR), fo.sub(lo, t, FR)], axis=1).reshape(
            n, fo.NLIMBS
        )
    return x


class Domain:
    """Evaluation domain of size n = 2^k with coset-extended domain for the
    quotient computation (mirrors what the fork's `EvaluationDomain`
    provides the reference via `vk.get_domain()`,
    `src/verifier.rs:252`)."""

    def __init__(self, k: int, extended_k: int | None = None):
        from ..fields import FR_GENERATOR

        self.k = k
        self.n = 1 << k
        self.omega = fr_omega(k)
        self.omega_inv = pow(self.omega, -1, R)
        self.n_inv = pow(self.n, -1, R)
        self.plan_fwd = NttPlan(k, self.omega)
        self.plan_inv = NttPlan(k, self.omega_inv)
        self.g_coset = FR_GENERATOR
        if extended_k is not None:
            self.extended_k = extended_k
            self.ext_n = 1 << extended_k
            self.ext_omega = fr_omega(extended_k)
            self.ext_plan_fwd = NttPlan(extended_k, self.ext_omega)
            self.ext_plan_inv = NttPlan(extended_k, pow(self.ext_omega, -1, R))
            # coset powers g^i and their inverses over the extended domain
            g = self.g_coset
            pw = [pow(g, i, R) for i in range(self.ext_n)]
            self.ext_coset_pows = jnp.asarray(FR.to_mont_array(pw))
            ginv = pow(g, -1, R)
            pwi = [pow(ginv, i, R) for i in range(self.ext_n)]
            self.ext_coset_pows_inv = jnp.asarray(FR.to_mont_array(pwi))
            # vanishing (X^n - 1) evaluated on the coset extended domain
            vals = [
                (pow(g, self.n, R) * pow(self.ext_omega, i * self.n, R) - 1) % R
                for i in range(self.ext_n)
            ]
            self.ext_vanishing_inv = jnp.asarray(
                FR.to_mont_array([pow(v, -1, R) for v in vals])
            )

    # -- basic transforms ---------------------------------------------------
    def ntt(self, coeffs):
        """coefficients -> evaluations on the n-domain (mont in/out)."""
        return _ntt_core(coeffs, self.plan_fwd)

    def intt(self, evals):
        out = _ntt_core(evals, self.plan_inv)
        ninv = jnp.asarray(FR.to_mont(self.n_inv))
        return fo.mont_mul(out, jnp.broadcast_to(ninv, out.shape), FR)

    def coeffs_to_extended(self, coeffs):
        """coefficients (len n or ext_n) -> evals on coset extended domain."""
        c = coeffs
        if c.shape[0] < self.ext_n:
            pad = jnp.zeros((self.ext_n - c.shape[0], fo.NLIMBS), jnp.int32)
            c = jnp.concatenate([c, pad], axis=0)
        shifted = fo.mont_mul(c, self.ext_coset_pows[: c.shape[0]], FR)
        return _ntt_core(shifted, self.ext_plan_fwd)

    def extended_to_coeffs(self, evals):
        out = _ntt_core(evals, self.ext_plan_inv)
        ninv = jnp.asarray(FR.to_mont(pow(self.ext_n, -1, R)))
        out = fo.mont_mul(out, jnp.broadcast_to(ninv, out.shape), FR)
        return fo.mont_mul(out, self.ext_coset_pows_inv, FR)

    def divide_by_vanishing(self, ext_evals):
        """Pointwise divide coset-extended evals by (X^n - 1)."""
        return fo.mont_mul(ext_evals, self.ext_vanishing_inv, FR)


_MASK8 = 0xFF


@jax.jit
def unpack8(packed):
    """(n, 32) uint8 byte view of (n, 4)-u64 little-endian limbs ->
    (n, 32) int32 8-bit limbs (the field_ops working format).  The byte
    layout of 4x64-bit LE words IS the 32x8-bit LE limb sequence, so this
    is a pure dtype widen."""
    return packed.astype(jnp.int32)


@jax.jit
def pack8(limbs):
    """(n, 32) int32 canonical 8-bit limbs -> (n, 32) uint8 for D2H
    (host views the bytes back as (n, 4) uint64)."""
    return limbs.astype(jnp.uint8)


@jax.jit
def ntt_dyn(values, twiddles, bitrev):
    """Cooley-Tukey NTT with the twiddle tables as *runtime* arguments.

    `_ntt_core` bakes the per-stage twiddles into the executable as jit
    constants — fine at verifier sizes, but at prover sizes (k=21 the
    tables total 256MB) the constants would bloat every compiled binary.
    Here `twiddles` is a tuple of (2^s, 32) mont arrays (the pytree
    structure fixes k) and `bitrev` the (n,) permutation.  Twiddle muls
    go through mont_mul_big so stage temps stay bounded at prover sizes
    (a full-width mul at n = 2^21 alone needs 32GB of conv temps)."""
    x = values[bitrev]
    n = x.shape[0]
    for s, tw in enumerate(twiddles):
        half = 1 << s
        m = half * 2
        a = x.reshape(n // m, m, fo.NLIMBS)
        lo = a[:, :half]
        hi = a[:, half:]
        t = fo.mont_mul_big(hi, jnp.broadcast_to(tw[None], hi.shape), FR)
        x = jnp.concatenate(
            [fo.add(lo, t, FR), fo.sub(lo, t, FR)], axis=1
        ).reshape(n, fo.NLIMBS)
    return x


@functools.partial(jax.jit, static_argnums=(1,))
def pow_series_dev(base, n: int):
    """[base^i]_{i<n} (mont in/out) via the bit ladder: log2(n) vector
    muls, no host-side 2^k Python-int loop.  Ladder muls are slab-bounded
    (mont_mul_big) so the series fits device memory at prover sizes."""
    idx = jnp.arange(n, dtype=jnp.int32)
    acc = jnp.broadcast_to(jnp.asarray(FR.one_mont), (n, fo.NLIMBS)).astype(
        jnp.int32
    )
    sq = base
    for b in range(max(n.bit_length() - 1, 1)):
        bit = ((idx >> b) & 1).astype(bool)
        mul = fo.mont_mul_big(acc, jnp.broadcast_to(sq, acc.shape), FR)
        acc = jnp.where(bit[:, None], mul, acc)
        sq = fo.mont_mul(sq, sq, FR)
    return acc


@functools.partial(jax.jit, static_argnums=(2,))
def poly_eval(coeffs, x, spec=FR):
    """Horner evaluation of a coefficient array (n, 32) at point x (32,),
    all Montgomery form.  Scans high-to-low."""

    def step(acc, c):
        return fo.add(fo.mont_mul(acc, x, spec), c, spec), None

    rev = coeffs[::-1]
    acc, _ = jax.lax.scan(step, rev[0], rev[1:])
    return acc
