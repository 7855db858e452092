"""Batched BN254 field arithmetic in JAX, 32x8-bit limbs, Montgomery form.

Design (SURVEY.md §7 layer 1):

* Elements are ``(..., 32)`` int32 arrays of 8-bit little-endian limbs.
  Mul chains run in Montgomery form (value stored as ``a*R mod p`` with
  ``R = 2^256``); add/sub/select are domain-agnostic.
* ``mont_mul`` = convolution + Montgomery REDC.  The 32x32 limb product is
  32 unrolled shifted multiply-accumulates (int32 VPU work; every partial
  product < 2^16, every column sum < 2^21 so int32 never overflows).
  Carry propagation is an exact `lax.scan` over the limb axis
  (vectorized over the batch).
* All ops are shape-polymorphic over leading batch dims and contain no
  data-dependent control flow, so they `jit`, `vmap`, and shard cleanly.

The reference's counterpart functionality lives in its unvendored halo2
fork's field types (`FieldExt`: SURVEY.md §2b); the oracle diff tests are
in tests/test_field_ops.py.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np
from jax import lax

from ..fields import LIMB_BITS, MONT_R, NLIMBS, Q, R
from .limbs import int_to_limbs, ints_to_limbs, limbs_to_int

_MASK = (1 << LIMB_BITS) - 1


class FieldSpec:
    """Static per-modulus constants (host numpy; captured as jit constants)."""

    def __init__(self, name: str, p: int):
        self.name = name
        self.p = p
        self.p_limbs = int_to_limbs(p)
        # p' = -p^{-1} mod 2^256 for Montgomery REDC
        self.p_inv_neg = int_to_limbs((-pow(p, -1, MONT_R)) % MONT_R)
        self.r_mod_p = MONT_R % p
        self.one_mont = int_to_limbs(self.r_mod_p)  # 1 in Montgomery form
        self.r2 = int_to_limbs((MONT_R * MONT_R) % p)  # R^2: to-Montgomery factor
        # 2^256 - p, used for the branch-free conditional subtraction
        self.comp_limbs = int_to_limbs(MONT_R - p)
        self.zero = np.zeros(NLIMBS, dtype=np.int32)

    def __repr__(self):
        return f"FieldSpec({self.name})"

    # ---- host-side codecs -------------------------------------------------
    def to_mont(self, x: int) -> np.ndarray:
        return int_to_limbs((x % self.p) * MONT_R % self.p)

    def to_mont_array(self, xs) -> np.ndarray:
        return ints_to_limbs([(int(x) % self.p) * MONT_R % self.p for x in xs])

    def from_mont_int(self, limbs) -> int:
        return limbs_to_int(limbs) * pow(MONT_R, -1, self.p) % self.p

    def from_mont_array(self, arr) -> list:
        rinv = pow(MONT_R, -1, self.p)
        a = np.asarray(arr)
        flat = a.reshape(-1, a.shape[-1])
        return [limbs_to_int(row) * rinv % self.p for row in flat]


FQ = FieldSpec("Fq", Q)
FR = FieldSpec("Fr", R)


# ---------------------------------------------------------------------------
# primitives
# ---------------------------------------------------------------------------


def _shift_up(e):
    """Shift columns one limb toward the MSB, dropping the top column."""
    pad = [(0, 0)] * (e.ndim - 1) + [(1, 0)]
    return jnp.pad(e, pad)[..., :-1]


def carry_prop(x, n_out: int):
    """Exact carry propagation, constant depth (no sequential scan).

    Input: non-negative int32 columns with values < 2^30.  Returns the
    canonical limbs (in [0, 256)) of ``value mod 2^(8*n_out)`` — i.e. any
    carry out of the top limb is dropped, which call sites use on purpose
    (Montgomery's mod-R truncation; complement-form subtraction).

    Depth: 4 relaxation passes (digit/carry split, bound: 2^30 -> 2^22 ->
    2^14 -> 320 -> 256) + carry-lookahead for the final ripple, a log2-depth
    `associative_scan` over (generate, propagate) pairs.  ~15 vector ops
    total vs a 64-step serial scan.
    """
    k = x.shape[-1]
    if k < n_out:
        pad = [(0, 0)] * (x.ndim - 1) + [(0, n_out - k)]
        x = jnp.pad(x, pad)
    elif k > n_out:
        raise ValueError("carry_prop cannot drop value-bearing columns")

    for _ in range(4):
        d = x & _MASK
        x = d + _shift_up(x >> LIMB_BITS)
    # now every column is <= 256 (digit <= 255 plus a possible +1 carry)
    s = (x & _MASK) + _shift_up(x >> LIMB_BITS)  # s_k in [0, 256]
    g = s >> LIMB_BITS  # 1 iff s_k == 256 (carry generated)
    p = (s == _MASK).astype(x.dtype)  # carry propagates through

    def combine(a, b):
        # a is the LSB-side block; carry out of [a;b] = g_b | (p_b & g_a)
        ga, pa = a
        gb, pb = b
        return (gb | (pb & ga), pa & pb)

    g_in, p_in = lax.associative_scan(combine, (g, p), axis=-1)
    carry_in = _shift_up(g_in)  # exclusive: carry INTO column k
    return (s + carry_in) & _MASK


def limb_conv(a, b):
    """Full 32x32 limb-product convolution -> 63 columns (int32, < 2^21).

    Pure int32 elementwise work and one axis-sum, exact by construction:
    no float `dot` (a float32 matmul is NOT exact under JAX's default
    reduced matmul precision)."""
    bshape = jnp.broadcast_shapes(a.shape[:-1], b.shape[:-1])
    prods = jnp.broadcast_to(
        a[..., :, None] * b[..., None, :], (*bshape, NLIMBS, NLIMBS)
    )
    # Skew trick: pad rows to width 2*NLIMBS, flatten, then re-slice with
    # row stride 2*NLIMBS-1.  Row i of the re-sliced view holds
    # flat[63*i + k] = prods[i, k-i] for k-i in [0,32), and every
    # out-of-range (k < i) term provably lands in the zero padding
    # (j' = 64-(i-k) >= 33).  Anti-diagonal sums become one axis-sum:
    # 6 HLO ops total instead of 32 unrolled slice-updates.
    padded = jnp.pad(prods, [(0, 0)] * (prods.ndim - 1) + [(0, NLIMBS)])
    flat = padded.reshape(*bshape, NLIMBS * 2 * NLIMBS)
    skew = flat[..., : NLIMBS * (2 * NLIMBS - 1)].reshape(
        *bshape, NLIMBS, 2 * NLIMBS - 1
    )
    return jnp.sum(skew, axis=-2)


def _cond_sub(a, sub_limbs: np.ndarray, comp_limbs: np.ndarray):
    """Return a - sub if a >= sub else a, for canonical 32-limb a < 2^256."""
    s = carry_prop(a + jnp.asarray(comp_limbs), NLIMBS + 1)
    ge = s[..., NLIMBS:].astype(bool)  # borrow-free <=> a >= sub
    return jnp.where(ge, s[..., :NLIMBS], a)


@functools.partial(jax.jit, static_argnums=(1,))
def cond_sub_p(a, spec: FieldSpec):
    return _cond_sub(a, spec.p_limbs, spec.comp_limbs)


# ---------------------------------------------------------------------------
# field ops (canonical limbs in/out; mul assumes Montgomery form)
# ---------------------------------------------------------------------------


@functools.partial(jax.jit, static_argnums=(2,))
def add(a, b, spec: FieldSpec):
    # a + b < 2p < 2^255: fits 32 limbs
    return cond_sub_p(carry_prop(a + b, NLIMBS), spec)


def _complement_add(a_cols, b):
    """Columns of a + (2^256 - 1 - b) + 1 = a - b + 2^256, all non-negative.

    carry_prop to 32 limbs then drops the 2^256 term, yielding a - b mod
    2^256 without ever forming negative columns."""
    t = a_cols + (_MASK - b)
    return t.at[..., 0].add(1)


@functools.partial(jax.jit, static_argnums=(2,))
def sub(a, b, spec: FieldSpec):
    # (a + p) - b in (0, 2p); complement form keeps columns in [0, 766]
    t = _complement_add(a + jnp.asarray(spec.p_limbs), b)
    return cond_sub_p(carry_prop(t, NLIMBS), spec)


@functools.partial(jax.jit, static_argnums=(1,))
def neg(a, spec: FieldSpec):
    # p - a in (0, p]; cond_sub maps p -> 0
    t = _complement_add(jnp.broadcast_to(jnp.asarray(spec.p_limbs), a.shape), a)
    return cond_sub_p(carry_prop(t, NLIMBS), spec)


@functools.partial(jax.jit, static_argnums=(2,))
def mont_mul(a, b, spec: FieldSpec):
    """REDC(a*b): inputs/outputs canonical 32-limb, Montgomery domain."""
    t = carry_prop(limb_conv(a, b), 2 * NLIMBS)  # a*b < p^2 < 2^508
    t_lo = t[..., :NLIMBS]
    # m = (t mod R) * p' mod R  — truncate conv columns before the carry:
    # upper columns never influence lower limbs.
    m_cols = limb_conv(t_lo, jnp.asarray(spec.p_inv_neg))[..., :NLIMBS]
    m = carry_prop(m_cols, NLIMBS)
    # s = t + m*p, divisible by R; s/R < 2p
    u = limb_conv(m, jnp.asarray(spec.p_limbs))  # 63 cols
    pad = [(0, 0)] * (u.ndim - 1) + [(0, 1)]
    s = t + jnp.pad(u, pad)  # 64 cols, each < 2^22
    s = carry_prop(s, 2 * NLIMBS)  # t+m*p < 2^511
    res = s[..., NLIMBS:]
    return cond_sub_p(res, spec)


#: bytes of mont_mul temporaries per row: the (rows, 32, 64) int32
#: padded skew tensor of limb_conv, twice live
_CONV_BYTES_PER_ROW = 2 * NLIMBS * 2 * NLIMBS * 4


def big_rows() -> int:
    """Rows above which mont_mul_big works in slabs: where one product's
    temporaries would take more than an eighth of the device's memory."""
    from .. import platform

    return platform.device_memory_bytes() // (8 * _CONV_BYTES_PER_ROW)


def mont_mul_big(a, b, spec: FieldSpec, chunk: int = 1 << 17, force: bool = False):
    """mont_mul with bounded convolution temps for prover-scale arrays.

    Above big_rows() total rows the product is computed in `chunk`-row
    slabs via lax.map — sequential inside one executable, so XLA reuses
    the slab temp buffers (~chunk * 8KB each) instead of materializing
    the full (rows, 32, 64) conv tensor.  Safe under jit and eager;
    falls back to plain mont_mul when rows don't divide evenly (all
    prover call sites are power-of-two sized)."""
    shape = jnp.broadcast_shapes(a.shape, b.shape)
    rows = 1
    for d in shape[:-1]:
        rows *= d
    if (rows < big_rows() and not force) or rows % chunk:
        return mont_mul(a, b, spec)
    af = jnp.broadcast_to(a, shape).reshape(rows // chunk, chunk, NLIMBS)
    bf = jnp.broadcast_to(b, shape).reshape(rows // chunk, chunk, NLIMBS)
    out = lax.map(lambda ab: mont_mul(ab[0], ab[1], spec), (af, bf))
    return out.reshape(shape)


@functools.partial(jax.jit, static_argnums=(1,))
def mont_sq(a, spec: FieldSpec):
    return mont_mul(a, a, spec)


@functools.partial(jax.jit, static_argnums=(1, 2))
def mont_pow_static(a, e: int, spec: FieldSpec):
    """a^e (Montgomery in/out) for a fixed Python-int exponent, via scan."""
    assert e >= 0
    if e == 0:
        return jnp.broadcast_to(jnp.asarray(spec.one_mont), a.shape).astype(a.dtype)
    bits = np.array([int(c) for c in bin(e)[2:]], dtype=np.int32)

    def step(acc, bit):
        acc = mont_mul(acc, acc, spec)
        take = mont_mul(acc, a, spec)
        acc = jnp.where(bit.astype(bool), take, acc)
        return acc, None

    one = jnp.broadcast_to(jnp.asarray(spec.one_mont), a.shape).astype(a.dtype)
    acc, _ = lax.scan(step, one, jnp.asarray(bits))
    return acc


@functools.partial(jax.jit, static_argnums=(1,))
def inv(a, spec: FieldSpec):
    """Montgomery-domain inverse via Fermat: (aR) -> (a^{-1})R.

    mont_pow_static(aR, p-2) = a^{p-2} R; for a == 0 returns 0^{ -} = 0."""
    return mont_pow_static(a, spec.p - 2, spec)


@functools.partial(jax.jit, static_argnums=(1,))
def to_mont(a, spec: FieldSpec):
    return mont_mul(a, jnp.asarray(spec.r2), spec)


def to_mont_chunked(a, spec: FieldSpec, chunk: int = 1 << 16):
    """to_mont over the leading axis in slabs.  The limb-convolution
    intermediates are ~64x the input; slab-wise ingest keeps temps at
    ~chunk * 32 * 64 * 4B."""
    n = a.shape[0]
    if n <= chunk:
        return to_mont(jnp.asarray(a), spec)
    parts = [
        to_mont(jnp.asarray(a[i : i + chunk]), spec)
        for i in range(0, n, chunk)
    ]
    return jnp.concatenate(parts, axis=0)


@functools.partial(jax.jit, static_argnums=(1,))
def from_mont(a, spec: FieldSpec):
    one = jnp.zeros_like(a).at[..., 0].set(1)
    return mont_mul(a, one, spec)


def is_zero(a):
    return jnp.all(a == 0, axis=-1)


def eq(a, b):
    return jnp.all(a == b, axis=-1)


def select(mask, a, b):
    """Elementwise field select; mask shape = batch shape (no limb axis)."""
    return jnp.where(mask[..., None], a, b)


def zeros_like(a):
    return jnp.zeros_like(a)


# ---------------------------------------------------------------------------
# batch helpers
# ---------------------------------------------------------------------------


def batch_inv(a, spec: FieldSpec):
    """Inverse of every element (Montgomery domain). Uses a single Fermat
    chain vectorized over the batch — O(254) muls total regardless of batch
    size, the data-parallel version of Montgomery's batch-inversion trick."""
    return inv(a, spec)


@functools.partial(jax.jit, static_argnums=(2,))
def horner_fold(values, x, spec: FieldSpec):
    """acc = v_0; acc = acc*x + v_i  — the y-/theta-/v-fold pattern used all
    over the verifier (e.g. src/vanishing.rs:148-155).

    values: (n, ..., 32) stacked along axis 0; returns (..., 32)."""

    def step(acc, v):
        return add(mont_mul(acc, x, spec), v, spec), None

    acc, _ = lax.scan(step, values[0], values[1:])
    return acc
