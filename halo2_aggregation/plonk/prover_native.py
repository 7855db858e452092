"""create_proof_native — the scaled PLONK/KZG prover over the C++ engine.

Byte-for-byte the same proofs as plonk/prover.py (same transcript schedule,
same rng draw order — tests/test_prover_native.py pins equality), but every
polynomial operation runs on (n, 4) uint64 Montgomery columns through
native/h2a_native.cpp: NTTs, grand products with batch-inverted
denominators, per-coset quotient evaluation, Horner evals, and synthetic
division.  This is what makes the reference's outer circuit size (k=23,
`examples/simple-example.rs:663`) provable — the pure-int
prover is the readable spec, this is the runtime.

Memory strategy for k=23 (ROADMAP item 4): the quotient is evaluated
coset-by-coset — the extended domain of size 2^(k+2) is the union of 4
cosets of the size-2^k domain, and a rotation by `rot` in the extended
domain is a rotation by `rot` *within* each coset, so no 2^25-sized leaf
ever materializes (only the final h evals, 1 column).
"""

from __future__ import annotations

import numpy as np

from ..fields import FR_DELTA, FR_GENERATOR, R, fr_omega
from ..utils import native
from ..utils.transcript import Blake2bWrite
from ..utils.u64 import ints_to_u64
from .circuit import Any, Assignment
from .engine import (
    Barycentric,
    NativeDomain,
    NativeVecOps,
    col_from_ints,
    eval_at,
    from_mont,
    mont_scalar,
    pow_series,
    roll,
    scalar_to_int,
    to_mont,
)
from .keygen import ProvingKey
from .kzg import Params
from .protocol import (
    LookupEvals,
    PermutationSetEvals,
    fold_y,
    gate_expressions,
    lookup_expressions,
    permutation_expressions,
    query_schedule,
    rotation_sets,
    compress_expressions,
)
from .prover import _rand_fr


def _permute_lookup_u64(a_plain: np.ndarray, s_plain: np.ndarray, usable: int):
    """Vectorized halo2 permute_expression_pair over (n, 4)-u64 plain
    canonical columns — replaces the Python-int sorted()/Counter path
    (~20s single-core at 2^21) with numpy lexsorts (~3s).

    Bit-identical to prover._permute_lookup (pinned by the
    test_prover_native byte-parity suite): A' is A sorted by integer
    value (lexsort, most-significant limb primary); each FIRST
    occurrence of a distinct A' value consumes one matching table
    entry; repeat rows are filled with the leftover table entries in
    first-occurrence-in-S order — exactly Counter.elements() insertion
    order, reproduced here via a per-run min of the original S indices.

    Raises ValueError if some input value is missing from the table
    (same contract as the reference's permute_expression_pair,
    lookup.rs)."""
    a = np.ascontiguousarray(a_plain[:usable], dtype=np.uint64)
    s = np.ascontiguousarray(s_plain[:usable], dtype=np.uint64)
    order_a = np.lexsort((a[:, 0], a[:, 1], a[:, 2], a[:, 3]))
    a_sorted = np.ascontiguousarray(a[order_a])
    order_s = np.lexsort((s[:, 0], s[:, 1], s[:, 2], s[:, 3]))
    s_sorted = np.ascontiguousarray(s[order_s])

    def rows_differ(x):  # x sorted: True where row i != row i-1
        d = np.empty(x.shape[0], dtype=bool)
        d[0] = True
        np.any(x[1:] != x[:-1], axis=1, out=d[1:])
        return d

    new_a = rows_differ(a_sorted)  # first occurrence of each distinct A'
    new_s = rows_differ(s_sorted)
    # distinct values + per-run bookkeeping for S
    s_starts = np.flatnonzero(new_s)
    s_counts = np.diff(np.append(s_starts, len(s_sorted)))
    s_first = np.minimum.reduceat(order_s, s_starts)  # original 1st index
    s_vals = s_sorted[s_starts]
    a_vals = a_sorted[new_a]
    # match each distinct A' value to its S run (both value-sorted)
    pos = _match_sorted_rows(s_vals, a_vals)
    if pos is None:
        raise ValueError("lookup failure: input value not in table")
    consumed = np.zeros(len(s_vals), dtype=np.int64)
    consumed[pos] = 1
    leftover = s_counts - consumed
    # leftovers ordered by first occurrence in the ORIGINAL S
    # (Counter insertion order), runs kept contiguous
    rest_runs = np.argsort(s_first, kind="stable")
    rest_vals = np.repeat(rest_runs, leftover[rest_runs])
    s_prime = np.empty_like(a_sorted)
    s_prime[new_a] = a_vals
    s_prime[~new_a] = s_vals[rest_vals]
    return a_sorted, s_prime


def _match_sorted_rows(s_vals: np.ndarray, a_vals: np.ndarray):
    """Index of each a_vals row inside s_vals (both sorted by the same
    integer order, rows unique); None if any row is absent.  Binary
    search over packed big-endian byte keys — bytes compare
    lexicographically, which matches the integer order."""
    be_s = _pack_be(s_vals)
    be_a = _pack_be(a_vals)
    pos = np.searchsorted(be_s, be_a)
    if np.any(pos >= len(be_s)) or np.any(be_s[pos] != be_a):
        return None
    return pos


def _pack_be(rows: np.ndarray) -> np.ndarray:
    """(n, 4) little-endian-limb u64 -> (n,) |S32 big-endian packed keys
    whose byte order sorts identically to the integer value."""
    be = rows[:, ::-1].astype(">u8")  # most-significant limb first
    return np.ascontiguousarray(be).view("S32").ravel()


def _use_device_quotient(cs, k: int) -> bool:
    """Route the per-coset quotient through the device engine
    (plonk/quotient_device.py, byte-exact vs the host C++ loop)?

    H2A_DEVICE_QUOTIENT=1 turns it on (and raises if the engine would
    not fit the device's memory); the default 0 keeps the host coset
    loop, which measured faster per coset than the XLA device engine on
    the H100 at k=16 and k=21 (PERF.md)."""
    import os

    from .. import platform
    from .quotient_device import DeviceQuotient

    v = os.environ.get("H2A_DEVICE_QUOTIENT", "0")
    if v not in ("0", "1"):
        raise ValueError(f"H2A_DEVICE_QUOTIENT={v!r}: expected 0 or 1")
    if v == "0":
        return False
    need = DeviceQuotient.bytes_needed(cs, k)
    if need > platform.device_memory_bytes():
        raise RuntimeError(
            f"device quotient at k={k} needs {need / 2**30:.1f} GiB, more "
            "than the device holds"
        )
    return True


def _as_plain_u64(col) -> np.ndarray:
    """Accept int lists (classic ProvingKey) or (n,4) u64 arrays."""
    if isinstance(col, np.ndarray):
        return np.ascontiguousarray(col, dtype=np.uint64)
    return col_from_ints(col)


def create_proof_native(
    params: Params,
    pk: ProvingKey,
    assignment: Assignment,
    instances,
    seed: int = 42,
    progress=None,
    transcript_cls=Blake2bWrite,
) -> bytes:
    log = progress or (lambda *_: None)
    cs = pk.vk.cs
    k = pk.vk.k
    n = 1 << k
    omega = pk.vk.omega
    bf = cs.blinding_factors()
    usable = n - bf - 1
    degree = cs.degree()
    chunk_len = degree - 2
    rng = np.random.default_rng(seed)
    t = transcript_cls()
    ops = NativeVecOps()
    dom = NativeDomain(k)
    one_m = mont_scalar(1)

    def commit(plain_col: np.ndarray):
        return params.commit_lagrange(plain_col)

    # The device-quotient engine is created UP FRONT and every column is
    # fed the moment its values are final (fixed/sigma immediately,
    # advice after the advice commits, lookup polys after their stage,
    # ...), so the host-to-device copies overlap the host stages.  Feeds
    # never touch the transcript or the rng, so proof bytes are unchanged
    # (pinned by tests/test_prover_native.py).
    #
    # The host keeps only the Montgomery VALUE columns (`evm`): the
    # step-7 evaluations run via engine.Barycentric dot products, and
    # the multiopen witnesses are built pointwise in the Lagrange basis
    # ((F_i - F(z)) / (x_i - z), batch-inverted denominators).
    # `get_coeffs` computes coefficients lazily for the host quotient and
    # for the astronomically unlikely case of an evaluation point landing
    # in the domain.
    dq = None
    if _use_device_quotient(cs, k):
        from .quotient_device import DeviceQuotient

        dq = DeviceQuotient(cs, k)
    dq_keys = frozenset(dq.key_order) if dq is not None else frozenset()

    evm: dict = {}  # key -> (n, 4) u64 mont VALUE column
    _coeffs: dict = {}  # key -> (n, 4) u64 mont coefficient column (lazy)

    def register(key, plain_col) -> None:
        m = to_mont(plain_col)
        evm[key] = m
        if key in dq_keys:
            dq.feed_evals(key, m)

    def get_coeffs(key) -> np.ndarray:
        if key not in _coeffs:
            _coeffs[key] = dom.intt(evm[key])
        return _coeffs[key]

    # fixed/sigma/selector columns are final from keygen — register them
    # before the transcript even opens
    fixed_plain = [_as_plain_u64(c) for c in pk.fixed_columns]
    sigma_plain = [_as_plain_u64(c) for c in pk.sigma_columns]
    for i, c in enumerate(fixed_plain):
        register(("fixed", i), c)
    for i, c in enumerate(sigma_plain):
        register(("sigma", i), c)

    def one_hot(rows, key):
        col = np.zeros((n, 4), np.uint64)
        col[list(rows), 0] = 1
        register(key, col)

    one_hot([0], ("l0", 0))
    one_hot([usable], ("llast", 0))
    one_hot(range(usable + 1, n), ("lblind", 0))

    # --- 0. vk hash + instance commitments (verifier.rs:339-363) -----------
    t.common_scalar(pk.vk.hash_scalar())
    inst_plain = []
    for ci in range(cs.num_instance_columns):
        vals = [int(v) % R for v in instances[ci]]
        col = col_from_ints(vals)
        if col.shape[0] < n:
            col = np.vstack([col, np.zeros((n - col.shape[0], 4), np.uint64)])
        inst_plain.append(col)
    inst_comms = [commit(c) for c in inst_plain]
    for c in inst_comms:
        t.common_point(c)
    for i, c in enumerate(inst_plain):
        register(("instance", i), c)

    # --- 1. advice commitments (verifier.rs:365-376) ------------------------
    # raw (pre-blind) advice is what lookup compression and the permutation
    # grand products consume, matching prover.py's use of `assignment`
    adv_raw_plain = []
    advice_plain = []
    for ci in range(cs.num_advice_columns):
        raw = col_from_ints(
            [0 if v is None else v for v in assignment.advice[ci]]
        )
        adv_raw_plain.append(raw)
        col = raw.copy()
        col[usable:] = ints_to_u64([_rand_fr(rng) for _ in range(n - usable)])
        advice_plain.append(col)
        t.write_point(commit(col))
        register(("advice", ci), col)
    log("advice committed")

    theta = t.squeeze_challenge()
    theta_m = mont_scalar(theta)

    # raw mont leaves per query (Lagrange domain) for lookup compression
    # (fixed/instance mont values are exactly the registered columns;
    # advice differs — compression reads the PRE-blind values)
    adv_raw_m = [to_mont(c) for c in adv_raw_plain]
    fix_raw_m = [evm[("fixed", i)] for i in range(len(fixed_plain))]
    inst_raw_m = [evm[("instance", i)] for i in range(len(inst_plain))]
    adv_leaf_m = [
        roll(adv_raw_m[c.index], rot.value) for c, rot in cs.advice_queries
    ]
    fix_leaf_m = [
        roll(fix_raw_m[c.index], rot.value) for c, rot in cs.fixed_queries
    ]
    inst_leaf_m = [
        roll(inst_raw_m[c.index], rot.value) for c, rot in cs.instance_queries
    ]

    # --- 2. lookups: permuted commitments (verifier.rs:380-387) -------------
    lookups = []
    for arg in cs.lookups:
        a_comp_m = compress_expressions(
            ops, arg.input_expressions, theta_m, adv_leaf_m, fix_leaf_m, inst_leaf_m
        )
        s_comp_m = compress_expressions(
            ops, arg.table_expressions, theta_m, adv_leaf_m, fix_leaf_m, inst_leaf_m
        )
        ap_u, sp_u = _permute_lookup_u64(
            from_mont(a_comp_m), from_mont(s_comp_m), usable
        )
        # rng draw order matches the spec prover: a blinds, then s blinds
        blinds_a = ints_to_u64([_rand_fr(rng) for _ in range(n - usable)])
        blinds_s = ints_to_u64([_rand_fr(rng) for _ in range(n - usable)])
        ap_plain = np.vstack([ap_u, blinds_a])
        sp_plain = np.vstack([sp_u, blinds_s])
        lookups.append(
            {
                "a_comp_m": a_comp_m,
                "s_comp_m": s_comp_m,
                "a_prime_plain": ap_plain,
                "s_prime_plain": sp_plain,
            }
        )
        t.write_point(commit(ap_plain))
        t.write_point(commit(sp_plain))
        li = len(lookups) - 1
        register(("lookup_a", li), ap_plain)
        register(("lookup_s", li), sp_plain)
    log("lookups permuted")

    beta = t.squeeze_challenge()
    gamma = t.squeeze_challenge()
    beta_m = mont_scalar(beta)
    gamma_m = mont_scalar(gamma)

    # column-value mont arrays (raw advice; fixed; instance) for products
    def column_m(col):
        if col.kind == Any.ADVICE:
            return adv_raw_m[col.index]
        if col.kind == Any.FIXED:
            return fix_raw_m[col.index]
        return inst_raw_m[col.index]

    # --- 3. permutation grand products (verifier.rs:401-409) ----------------
    perm_cols = cs.permutation_columns
    num_chunks = (len(perm_cols) + chunk_len - 1) // chunk_len
    deltas = [1]
    for _ in range(len(perm_cols) - 1):
        deltas.append(deltas[-1] * FR_DELTA % R)
    omega_pows_m = pow_series(mont_scalar(omega), n)
    perm_z_plain = []
    prev_end = 1
    for ci in range(num_chunks):
        cols = perm_cols[ci * chunk_len : (ci + 1) * chunk_len]
        sigs = sigma_plain[ci * chunk_len : (ci + 1) * chunk_len]
        num_m = None
        den_m = None
        for t_i, col in enumerate(cols):
            v_m = column_m(col)
            kglob = ci * chunk_len + t_i
            bd = mont_scalar(beta * deltas[kglob] % R)
            term_n = ops.add(ops.add(ops.mul(omega_pows_m, bd), v_m), gamma_m)
            sig_m = to_mont(sigs[t_i])
            term_d = ops.add(ops.add(ops.mul(sig_m, beta_m), v_m), gamma_m)
            num_m = term_n if num_m is None else ops.mul(num_m, term_n)
            den_m = term_d if den_m is None else ops.mul(den_m, term_d)
        z_m = native.fr_grand_product(
            num_m[:usable], den_m[:usable], mont_scalar(prev_end).reshape(-1)
        )
        prev_end = scalar_to_int(z_m[usable : usable + 1])
        zcol = from_mont(z_m)  # rows 0..usable
        blinds = ints_to_u64(
            [_rand_fr(rng) for _ in range(n - usable - 1)]
        ) if n - usable - 1 else np.zeros((0, 4), np.uint64)
        zcol = np.vstack([zcol, blinds])
        perm_z_plain.append(zcol)
        t.write_point(commit(zcol))
    for ci, c in enumerate(perm_z_plain):
        register(("perm_z", ci), c)
    log("permutation products")

    # --- 4. lookup grand products (verifier.rs:411-417) ---------------------
    for lk in lookups:
        num_m = ops.mul(
            ops.add(lk["a_comp_m"], beta_m), ops.add(lk["s_comp_m"], gamma_m)
        )
        ap_m = to_mont(lk["a_prime_plain"])
        sp_m = to_mont(lk["s_prime_plain"])
        den_m = ops.mul(ops.add(ap_m, beta_m), ops.add(sp_m, gamma_m))
        z_m = native.fr_grand_product(
            num_m[:usable], den_m[:usable], one_m.reshape(-1)
        )
        zcol = from_mont(z_m)
        blinds = ints_to_u64(
            [_rand_fr(rng) for _ in range(n - usable - 1)]
        ) if n - usable - 1 else np.zeros((0, 4), np.uint64)
        zcol = np.vstack([zcol, blinds])
        lk["z_plain"] = zcol
        t.write_point(commit(zcol))
    for li, lk in enumerate(lookups):
        register(("lookup_z", li), lk["z_plain"])
    log("lookup products")

    # --- 5. vanishing random poly (verifier.rs:419-421) ---------------------
    r_plain = ints_to_u64([_rand_fr(rng) for _ in range(n)])
    t.write_point(commit(r_plain))
    register(("vanishing_r", 0), r_plain)

    y = t.squeeze_challenge()
    y_m = mont_scalar(y)

    # --- 6. quotient h(X), per-coset (verifier.rs:427-434 reads pieces) -----
    # (with the device engine, every column was fed at its source stage)
    shift_bits = max(1, (degree - 2).bit_length())
    ext_k = k + shift_bits
    ext_n = 1 << ext_k
    step = ext_n // n
    g = FR_GENERATOR
    omega_ext = fr_omega(ext_k)

    h_ext_m = np.empty((ext_n, 4), np.uint64)
    if dq is not None:
        dq.finalize()
        log("quotient columns on device")
    for cj in range(step):
        shift = g * pow(omega_ext, cj, R) % R
        if dq is not None:
            h_ext_m[cj::step] = dq.run_coset(shift, theta, beta, gamma, y)
            log(f"quotient coset {cj + 1}/{step} (device)")
            continue

        def ext(coeffs_m):
            return dom.coset_evals(coeffs_m, shift)

        _cache = {}

        def ext_cached(key, coeffs_m):
            if key not in _cache:
                _cache[key] = ext(coeffs_m)
            return _cache[key]

        adv_leaf = [
            roll(ext_cached(("a", c.index), get_coeffs(("advice", c.index))), rot.value)
            for c, rot in cs.advice_queries
        ]
        fix_leaf = [
            roll(ext_cached(("f", c.index), get_coeffs(("fixed", c.index))), rot.value)
            for c, rot in cs.fixed_queries
        ]
        inst_leaf = [
            roll(ext_cached(("i", c.index), get_coeffs(("instance", c.index))), rot.value)
            for c, rot in cs.instance_queries
        ]
        sigma_leaf = [
            ext(get_coeffs(("sigma", i))) for i in range(len(sigma_plain))
        ]
        l0_e = ext(get_coeffs(("l0", 0)))
        llast_e = ext(get_coeffs(("llast", 0)))
        lblind_e = ext(get_coeffs(("lblind", 0)))
        coset_x = pow_series(mont_scalar(omega), n, mont_scalar(shift))

        exprs = gate_expressions(ops, cs, adv_leaf, fix_leaf, inst_leaf)
        perm_sets = []
        for ci in range(num_chunks):
            ze = ext(get_coeffs(("perm_z", ci)))
            perm_sets.append(
                PermutationSetEvals(
                    z=ze,
                    z_next=roll(ze, 1),
                    z_last=roll(ze, -(bf + 1)) if ci < num_chunks - 1 else None,
                )
            )
        exprs += permutation_expressions(
            ops, cs, perm_sets, sigma_leaf, adv_leaf, fix_leaf, inst_leaf,
            l0_e, llast_e, lblind_e, beta_m, gamma_m, coset_x, chunk_len,
        )
        for li, arg in enumerate(cs.lookups):
            ze = ext(get_coeffs(("lookup_z", li)))
            ae = ext(get_coeffs(("lookup_a", li)))
            se = ext(get_coeffs(("lookup_s", li)))
            ev = LookupEvals(
                z=ze, z_next=roll(ze, 1), a_prime=ae,
                a_prime_prev=roll(ae, -1), s_prime=se,
            )
            exprs += lookup_expressions(
                ops, ev, arg, l0_e, llast_e, lblind_e,
                theta_m, beta_m, gamma_m, adv_leaf, fix_leaf, inst_leaf,
            )
        num = fold_y(ops, exprs, y_m)
        vinv = pow((pow(shift, n, R) - 1) % R, -1, R)
        native.fr_vec_scale_inplace(num, mont_scalar(vinv).reshape(-1))
        h_ext_m[cj::step] = num
        log(f"quotient coset {cj + 1}/{step} (host)")

    import time as _time

    _t0 = _time.time()
    ext_dom = NativeDomain(ext_k)
    h_coeffs_m = ext_dom.intt(h_ext_m)
    native.fr_scale_pows_inplace(
        h_coeffs_m, mont_scalar(pow(g, -1, R)).reshape(-1)
    )
    log(f"  h ext intt+scale ({_time.time() - _t0:.1f}s)")
    qpd = cs.quotient_poly_degree()
    if h_coeffs_m.shape[0] < qpd * n:
        h_coeffs_m = np.vstack(
            [h_coeffs_m, np.zeros((qpd * n - h_coeffs_m.shape[0], 4), np.uint64)]
        )
    h_pieces_m = [h_coeffs_m[i * n : (i + 1) * n] for i in range(qpd)]
    h_piece_ev = []  # mont VALUE columns, kept for the eval-form fold
    for piece in h_pieces_m:
        _t0 = _time.time()
        ev = dom.ntt(piece)
        h_piece_ev.append(ev)
        _t1 = _time.time()
        t.write_point(commit(from_mont(ev)))
        log(f"  h piece ntt {_t1 - _t0:.1f}s commit {_time.time() - _t1:.1f}s")
    log("quotient committed")

    x = t.squeeze_challenge()

    # --- 7. evaluations (verifier.rs:438-510) --------------------------------
    omega_inv = pow(omega, -1, R)

    def z_of(rot: int) -> int:
        if rot >= 0:
            return x * pow(omega, rot, R) % R
        return x * pow(omega_inv, -rot, R) % R

    # Barycentric machinery: one batch-inverted denominator column per
    # distinct evaluation point, shared between the step-7 evaluations
    # and the step-8 eval-form multiopen witnesses — evaluations run
    # straight off the VALUE columns, so coefficients never materialize
    # on the host.  Falls back to the coefficient path (Horner +
    # synthetic division over get_coeffs) iff an evaluation point lands
    # exactly on the domain (probability ~ n/2^254).
    sched = query_schedule(cs, num_chunks, len(cs.lookups))
    bary = Barycentric(k)
    try:
        for rot, _ in rotation_sets(sched):
            bary.point(z_of(rot))
    except ZeroDivisionError:
        bary = None

    def poly_of(key):
        return evm[key] if bary is not None else get_coeffs(key)

    def at_rot(key, rot) -> int:
        if bary is not None:
            return bary.eval(evm[key], z_of(rot))
        return eval_at(get_coeffs(key), z_of(rot))

    inst_evals = [
        at_rot(("instance", c.index), rot.value)
        for c, rot in cs.instance_queries
    ]
    for e in inst_evals:
        t.write_scalar(e)
    adv_evals = [
        at_rot(("advice", c.index), rot.value)
        for c, rot in cs.advice_queries
    ]
    for e in adv_evals:
        t.write_scalar(e)
    fix_evals = [
        at_rot(("fixed", c.index), rot.value)
        for c, rot in cs.fixed_queries
    ]
    for e in fix_evals:
        t.write_scalar(e)
    r_eval = at_rot(("vanishing_r", 0), 0)
    t.write_scalar(r_eval)
    sigma_evals = [
        at_rot(("sigma", i), 0) for i in range(len(sigma_plain))
    ]
    for e in sigma_evals:
        t.write_scalar(e)
    perm_ev = []
    for ci in range(num_chunks):
        z_x = at_rot(("perm_z", ci), 0)
        z_nx = at_rot(("perm_z", ci), 1)
        t.write_scalar(z_x)
        t.write_scalar(z_nx)
        z_last = None
        if ci < num_chunks - 1:
            z_last = at_rot(("perm_z", ci), -(bf + 1))
            t.write_scalar(z_last)
        perm_ev.append((z_x, z_nx, z_last))
    lookup_ev = []
    for li in range(len(cs.lookups)):
        vals = (
            at_rot(("lookup_z", li), 0),
            at_rot(("lookup_z", li), 1),
            at_rot(("lookup_a", li), 0),
            at_rot(("lookup_a", li), -1),
            at_rot(("lookup_s", li), 0),
        )
        for vv in vals:
            t.write_scalar(vv)
        lookup_ev.append(vals)
    log("evaluations")

    v = t.squeeze_challenge()
    u = t.squeeze_challenge()
    v_m = mont_scalar(v)

    # --- 8. multiopen witnesses (multiopen.rs:271-509 verifies these) -------
    # The folded h is assembled in whatever basis step 8 runs in: VALUE
    # columns (h_piece_ev) on the barycentric path, coefficients on the
    # fallback — the fold is the same linear combination either way.
    xn = pow(x, n, R)
    h_src = h_piece_ev if bary is not None else h_pieces_m
    h_folded = h_src[-1].copy()
    for piece in reversed(h_src[:-1]):
        native.fr_fold_inplace(h_folded, piece, mont_scalar(xn).reshape(-1))
    h_eval = (
        bary.eval(h_folded, x) if bary is not None else eval_at(h_folded, x)
    )

    polys = {}
    for q in sched:
        if q.kind == "instance":
            col, rot = cs.instance_queries[q.index]
            polys[q] = (poly_of(("instance", col.index)), inst_evals[q.index])
        elif q.kind == "advice":
            col, rot = cs.advice_queries[q.index]
            polys[q] = (poly_of(("advice", col.index)), adv_evals[q.index])
        elif q.kind == "fixed":
            col, rot = cs.fixed_queries[q.index]
            polys[q] = (poly_of(("fixed", col.index)), fix_evals[q.index])
        elif q.kind == "perm_z":
            polys[q] = (
                poly_of(("perm_z", q.index)),
                perm_ev[q.index][0] if q.rotation == 0 else perm_ev[q.index][1],
            )
        elif q.kind == "perm_z_last":
            polys[q] = (poly_of(("perm_z", q.index)), perm_ev[q.index][2])
        elif q.kind == "lookup_z":
            polys[q] = (
                poly_of(("lookup_z", q.index)),
                lookup_ev[q.index][0] if q.rotation == 0 else lookup_ev[q.index][1],
            )
        elif q.kind == "lookup_a":
            polys[q] = (
                poly_of(("lookup_a", q.index)),
                lookup_ev[q.index][2] if q.rotation == 0 else lookup_ev[q.index][3],
            )
        elif q.kind == "lookup_s":
            polys[q] = (poly_of(("lookup_s", q.index)), lookup_ev[q.index][4])
        elif q.kind == "sigma":
            polys[q] = (poly_of(("sigma", q.index)), sigma_evals[q.index])
        elif q.kind == "vanishing_h":
            polys[q] = (h_folded, h_eval)
        elif q.kind == "vanishing_r":
            polys[q] = (poly_of(("vanishing_r", 0)), r_eval)
        else:
            raise KeyError(q.kind)

    for rot, qs in rotation_sets(sched):
        z_pt = z_of(rot)
        fc = polys[qs[0]][0].copy()
        fe = polys[qs[0]][1]
        for q in qs[1:]:
            c, e = polys[q]
            native.fr_fold_inplace(fc, c, v_m.reshape(-1))
            fe = (fe * v + e) % R
        if bary is not None:
            # eval-form witness: W_i = (fc_i - fe) / (x_i - z), then
            # commit straight from the Lagrange basis — no synthetic
            # division, no NTT; bit-identical commitment (the same
            # degree <= n-2 polynomial, engine.Barycentric docstring)
            t.write_point(commit(from_mont(bary.witness_evals(fc, fe, z_pt))))
        else:
            # numer = fc with constant term shifted by -fe; divide_linear
            # never reads coeff 0, so pass fc directly (same quotient)
            q_coeffs = native.fr_divide_linear(
                fc, mont_scalar(z_pt).reshape(-1)
            )
            t.write_point(commit(from_mont(dom.ntt(q_coeffs))))
    log("multiopen witnesses")

    return t.finalize()
