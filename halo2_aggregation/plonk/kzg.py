"""KZG commitment scheme: toy SRS setup + Lagrange-basis commitments.

Replaces the fork APIs `Setup::<Bn256>::new(k, rng)`,
`Setup::verifier_params`, `Params::{read,write}`, `params.commit_lagrange`
(`examples/simple-example.rs:584-693`).

Design note: the whole prover works in *Lagrange space* — every
committed polynomial has degree < n, so commitments only ever need the
Lagrange SRS ``[L_i(tau)]G1``, and opening witnesses are produced pointwise
on the domain (see prover.py) rather than by sequential synthetic division.
The monomial SRS never materializes.

Like the reference (which caches `/tmp/halo2-{k}.params`), generated params
are cached on disk keyed by k and seed, by default under the checkout's
build/ directory ($H2A_PARAMS_CACHE overrides).  The cache format is plain
numpy `.npz` (uint64 limb arrays) — never pickle — and the cache directory
is created mode 0700, so a pre-planted file can corrupt at most the SRS
values (which commit_lagrange consumers treat as data), not execute code.
"""

from __future__ import annotations

import os

import numpy as np

from ..fields import R, fr_omega
from ..oracle import curve as oc
from ..utils.u64 import (
    int_to_u64,
    ints_to_u64,
    points_to_u64,
    u64_to_int,
    u64_to_ints,
    u64_to_points,
)


def _default_cache_dir() -> str:
    from ..platform import BUILD_DIR

    return os.environ.get("H2A_PARAMS_CACHE") or os.path.join(
        BUILD_DIR, "params"
    )


CACHE_DIR = _default_cache_dir()


def _g2_to_u64(p) -> np.ndarray:
    (x0, x1), (y0, y1) = p
    return ints_to_u64([x0, x1, y0, y1]).reshape(-1)


def _g2_from_u64(arr):
    x0, x1, y0, y1 = u64_to_ints(np.asarray(arr).reshape(4, 4))
    return ((x0, x1), (y0, y1))


class Params:
    """SRS for domain size n = 2^k.

    Attributes:
      g1: generator (int pair)
      g_lagrange_u64: (n, 8) uint64 — x‖y limbs of [L_i(tau)]G1, plain form
      g_lagrange_inf: (n,) uint8 infinity flags
      g2, s_g2: G2 generator and [tau]G2 (Fq2 coordinate pairs)
    """

    def __init__(self, k: int, g_lagrange_u64, g_lagrange_inf, g2, s_g2):
        self.k = k
        self.n = 1 << k
        self.g1 = oc.g1_generator()
        self.g_lagrange_u64 = np.asarray(g_lagrange_u64, dtype=np.uint64)
        self.g_lagrange_inf = np.asarray(g_lagrange_inf, dtype=np.uint8)
        self.g2 = g2
        self.s_g2 = s_g2
        self._device_points = None
        self._g_lagrange_ints = None

    @classmethod
    def from_points(cls, k: int, g_lagrange, g2, s_g2) -> "Params":
        pts, infs = points_to_u64(g_lagrange)
        p = cls(k, pts, infs, g2, s_g2)
        p._g_lagrange_ints = list(g_lagrange)
        return p

    @property
    def g_lagrange(self) -> list:
        """Oracle-format view: list of (x, y) int pairs / None (lazy)."""
        if self._g_lagrange_ints is None:
            self._g_lagrange_ints = u64_to_points(
                self.g_lagrange_u64, self.g_lagrange_inf
            )
        return self._g_lagrange_ints

    # -- commitments ---------------------------------------------------------
    def commit_lagrange(self, values) -> tuple | None:
        """Commit to a polynomial given by its evaluations on the domain.

        `values` is a list of ints or an (n, 4) uint64 limb array.  Host
        orchestration; native C++ Pippenger by default, device MSM under
        H2A_DEVICE_MSM=1."""
        if isinstance(values, np.ndarray) and values.dtype == np.uint64:
            scalars_u64 = values
            if scalars_u64.shape[0] < self.n:
                scalars_u64 = np.vstack(
                    [
                        scalars_u64,
                        np.zeros(
                            (self.n - scalars_u64.shape[0], 4), dtype=np.uint64
                        ),
                    ]
                )
        else:
            vals = [int(v) % R for v in values]
            if len(vals) > self.n:
                raise ValueError("polynomial larger than the domain")
            vals = vals + [0] * (self.n - len(vals))
            scalars_u64 = ints_to_u64(vals)
        return self._msm(scalars_u64)

    def _msm(self, scalars_u64: np.ndarray):
        use_device = os.environ.get("H2A_DEVICE_MSM", "0") == "1"
        if not use_device:
            from ..utils import native

            return native.g1_msm_u64(
                self.g_lagrange_u64, self.g_lagrange_inf, scalars_u64
            )
        import jax.numpy as jnp

        from ..ops import curve_ops as co
        from ..ops import field_ops as fo
        from ..ops import msm as msm_mod
        from ..utils.u64 import u64_view8

        if self._device_points is None:
            # SRS points stay device-resident across commits: uint8 byte
            # views (32B/row host-to-device), widened to int32 limbs +
            # Montgomery-encoded on-device (chunked: a full-SRS to_mont
            # needs ~64x its input in convolution temps)
            xs = jnp.asarray(u64_view8(self.g_lagrange_u64[:, :4])).astype(jnp.int32)
            ys = jnp.asarray(u64_view8(self.g_lagrange_u64[:, 4:])).astype(jnp.int32)
            self._device_points = co.AffinePoint(
                fo.to_mont_chunked(xs, fo.FQ),
                fo.to_mont_chunked(ys, fo.FQ),
                jnp.asarray(self.g_lagrange_inf.astype(bool)),
            )
        res = msm_mod.msm(
            self._device_points,
            jnp.asarray(u64_view8(scalars_u64)).astype(jnp.int32),
            nbits=254,
        )
        return co.jac_to_ints(co.JacPoint(res.x[None], res.y[None], res.z[None]))[0]

    # -- persistence ---------------------------------------------------------
    def save(self, path: str):
        """Write to a temporary file and rename it into place, so a
        concurrent reader never sees a partial file."""
        path = path if path.endswith(".npz") else path + ".npz"
        tmp = f"{path}.{os.getpid()}.tmp.npz"
        np.savez(
            tmp,
            k=np.array([self.k], dtype=np.int64),
            g_lagrange=self.g_lagrange_u64,
            g_lagrange_inf=self.g_lagrange_inf,
            g2=_g2_to_u64(self.g2),
            s_g2=_g2_to_u64(self.s_g2),
        )
        os.replace(tmp, path)

    @staticmethod
    def load(path: str) -> "Params":
        with np.load(path, allow_pickle=False) as d:
            return Params(
                int(d["k"][0]),
                d["g_lagrange"],
                d["g_lagrange_inf"],
                _g2_from_u64(d["g2"]),
                _g2_from_u64(d["s_g2"]),
            )


def setup(k: int, seed: int = 0xE5BC0654) -> Params:
    """Toy (tau-known) setup, deterministic in (k, seed) — the analog of
    `Setup::new(k, XorShiftRng(seed))`.  Caches to disk (npz)."""
    os.makedirs(CACHE_DIR, mode=0o700, exist_ok=True)
    cache = os.path.join(CACHE_DIR, f"params-{k}-{seed:x}.npz")
    if os.path.exists(cache):
        return Params.load(cache)

    rng = np.random.default_rng(seed)
    tau = int.from_bytes(rng.bytes(40), "little") % R
    n = 1 << k
    omega = fr_omega(k)
    g = oc.g1_generator()
    g2 = oc.g2_generator()
    s_g2 = oc.g2_mul(g2, tau)

    from ..utils import native

    if k >= 14:
        # scaled path: L_i(tau) via native batch inversion, points via the
        # windowed fixed-base kernel — numpy end to end (minutes at k=23)
        from . import engine

        tn1_over_n = (pow(tau, n, R) - 1) * pow(n, -1, R) % R
        wi_m = engine.pow_series(engine.mont_scalar(omega), n)
        denom_m = native.fr_vec_binop(
            0, engine.mont_scalar(tau), 0, native.fr_vec_neg(wi_m), 0, n
        )
        native.fr_batch_inv_inplace(denom_m)
        s_m = native.fr_vec_binop(2, wi_m, 0, denom_m, 0, n)
        native.fr_vec_scale_inplace(s_m, engine.mont_scalar(tn1_over_n).reshape(-1))
        scalars_u64 = engine.from_mont(s_m)
        base = ints_to_u64([g[0], g[1]]).reshape(-1)
        aff, inf = native.g1_batch_mul_win(base, scalars_u64)
        params = Params(k, aff, inf, g2, s_g2)
    else:
        # L_i(tau) = omega^i (tau^n - 1) / (n (tau - omega^i))
        tn1 = (pow(tau, n, R) - 1) % R
        scalars = []
        wi = 1
        for _ in range(n):
            denom = (tau - wi) % R
            scalars.append(wi * tn1 % R * pow(denom * n, -1, R) % R)
            wi = wi * omega % R
        g_lagrange = _batch_g1_mul(g, scalars)
        params = Params.from_points(k, g_lagrange, g2, s_g2)
    params.save(cache)
    return params


def _batch_g1_mul(base, scalars):
    """Host-or-device batched fixed-base scalar mul for SRS generation."""
    n = len(scalars)
    if n <= 1 << 10 or os.environ.get("H2A_DEVICE_MSM", "0") != "1":
        from ..utils import native

        return native.g1_batch_mul(base, scalars)
    import jax.numpy as jnp

    from ..ops import curve_ops as co
    from ..ops.limbs import ints_to_limbs

    pts = co.affine_from_ints([base] * n)
    res = co.scalar_mul(co.affine_to_jac(pts), jnp.asarray(ints_to_limbs(scalars)), 254)
    return co.jac_to_ints(res)
