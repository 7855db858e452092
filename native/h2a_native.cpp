// h2a_native: the framework's native CPU runtime — BN254 G1 MSM and the
// Fr polynomial engine (NTT / vector field ops / grand products) that the
// scaled prover orchestrates from Python.
//
// The device owns the batched verification compute path; this library is the
// native runtime around it (SRS generation, commit_lagrange, the k=23
// outer-proof polynomial arithmetic, test oracles) — the role the
// reference delegates to its Rust halo2 fork's multiexp/EvaluationDomain
// (SURVEY.md §2b).
//
// Fq/Fr are 4x64-bit limbs in Montgomery form (CIOS with unsigned
// __int128); points are Jacobian with mixed-affine bucket additions; the
// MSM is windowed Pippenger with bucket suffix sums, threaded.  All Fr
// vector entry points operate on (n, 4) uint64 arrays in Montgomery form
// (numpy interchange; see halo2_aggregation/utils/native.py).
//
// Build: g++ -O3 -fopenmp -shared -fPIC -o libh2a_native.so h2a_native.cpp

#include <algorithm>
#include <cstdint>
#include <cstring>
#include <vector>
#ifdef _OPENMP
#include <omp.h>
#endif

typedef unsigned __int128 u128;
typedef uint64_t u64;

// BN254 base field modulus q, little-endian 64-bit limbs
static const u64 Q[4] = {0x3c208c16d87cfd47ULL, 0x97816a916871ca8dULL,
                         0xb85045b68181585dULL, 0x30644e72e131a029ULL};
// -q^{-1} mod 2^64
static const u64 Q_INV_NEG = 0x87d20782e4866389ULL;
// R^2 mod q (R = 2^256)
static const u64 R2[4] = {0xf32cfc5b538afa89ULL, 0xb5e71911d44501fbULL,
                          0x47ab1eff0a417ff6ULL, 0x06d89f71cab8351fULL};
// 1 in Montgomery form (R mod q)
static const u64 R1[4] = {0xd35d438dc58f0d9dULL, 0x0a78eb28f5c70b3dULL,
                          0x666ea36f7879462cULL, 0x0e0a77c19a07df2fULL};

struct Fq {
  u64 v[4];
};

static inline bool is_zero(const Fq &a) {
  return (a.v[0] | a.v[1] | a.v[2] | a.v[3]) == 0;
}

static inline int cmp(const u64 a[4], const u64 b[4]) {
  for (int i = 3; i >= 0; --i) {
    if (a[i] < b[i]) return -1;
    if (a[i] > b[i]) return 1;
  }
  return 0;
}

static inline void sub_nocarry(u64 r[4], const u64 a[4], const u64 b[4]) {
  u128 borrow = 0;
  for (int i = 0; i < 4; i++) {
    u128 d = (u128)a[i] - b[i] - borrow;
    r[i] = (u64)d;
    borrow = (d >> 64) & 1;
  }
}

static inline void add_mod(Fq &r, const Fq &a, const Fq &b) {
  u128 carry = 0;
  u64 t[4];
  for (int i = 0; i < 4; i++) {
    u128 s = (u128)a.v[i] + b.v[i] + carry;
    t[i] = (u64)s;
    carry = s >> 64;
  }
  if (carry || cmp(t, Q) >= 0) sub_nocarry(r.v, t, Q);
  else memcpy(r.v, t, 32);
}

static inline void sub_mod(Fq &r, const Fq &a, const Fq &b) {
  if (cmp(a.v, b.v) >= 0) {
    sub_nocarry(r.v, a.v, b.v);
  } else {
    u64 t[4];
    u128 carry = 0;
    for (int i = 0; i < 4; i++) {
      u128 s = (u128)a.v[i] + Q[i] + carry;
      t[i] = (u64)s;
      carry = s >> 64;
    }
    sub_nocarry(r.v, t, b.v);
  }
}

static inline void dbl_mod(Fq &r, const Fq &a) { add_mod(r, a, a); }

// CIOS Montgomery multiplication
static void mont_mul(Fq &r, const Fq &a, const Fq &b) {
  u64 t[6] = {0, 0, 0, 0, 0, 0};
  for (int i = 0; i < 4; i++) {
    u128 carry = 0;
    for (int j = 0; j < 4; j++) {
      u128 s = (u128)t[j] + (u128)a.v[i] * b.v[j] + carry;
      t[j] = (u64)s;
      carry = s >> 64;
    }
    u128 s = (u128)t[4] + carry;
    t[4] = (u64)s;
    t[5] = (u64)(s >> 64);
    u64 m = t[0] * Q_INV_NEG;
    carry = ((u128)t[0] + (u128)m * Q[0]) >> 64;
    for (int j = 1; j < 4; j++) {
      u128 s2 = (u128)t[j] + (u128)m * Q[j] + carry;
      t[j - 1] = (u64)s2;
      carry = s2 >> 64;
    }
    s = (u128)t[4] + carry;
    t[3] = (u64)s;
    t[4] = t[5] + (u64)(s >> 64);
    t[5] = 0;
  }
  if (t[4] || cmp(t, Q) >= 0) sub_nocarry(r.v, t, Q);
  else memcpy(r.v, t, 32);
}

static inline void mont_sq(Fq &r, const Fq &a) { mont_mul(r, a, a); }

static void mont_inv(Fq &r, const Fq &a) {
  // a^(q-2) via square-and-multiply (fixed exponent)
  static const u64 QM2[4] = {0x3c208c16d87cfd45ULL, 0x97816a916871ca8dULL,
                             0xb85045b68181585dULL, 0x30644e72e131a029ULL};
  Fq acc;
  memcpy(acc.v, R1, 32);
  for (int i = 3; i >= 0; --i) {
    for (int b = 63; b >= 0; --b) {
      mont_sq(acc, acc);
      if ((QM2[i] >> b) & 1) mont_mul(acc, acc, a);
    }
  }
  r = acc;
}

struct Jac {
  Fq x, y, z;  // z == 0 <=> infinity
};

static inline void jac_set_inf(Jac &p) { memset(&p, 0, sizeof(p)); }

static void jac_double(Jac &r, const Jac &p) {
  if (is_zero(p.z)) {
    r = p;
    return;
  }
  Fq a, b, c, d, e, f, t;
  mont_sq(a, p.x);
  mont_sq(b, p.y);
  mont_sq(c, b);
  add_mod(t, p.x, b);
  mont_sq(t, t);
  sub_mod(t, t, a);
  sub_mod(t, t, c);
  dbl_mod(d, t);
  dbl_mod(e, a);
  add_mod(e, e, a);
  mont_sq(f, e);
  Fq x3, y3, z3;
  dbl_mod(t, d);
  sub_mod(x3, f, t);
  Fq c8;
  dbl_mod(c8, c);
  dbl_mod(c8, c8);
  dbl_mod(c8, c8);
  sub_mod(t, d, x3);
  mont_mul(t, e, t);
  sub_mod(y3, t, c8);
  mont_mul(z3, p.y, p.z);
  dbl_mod(z3, z3);
  r.x = x3;
  r.y = y3;
  r.z = z3;
}

static void jac_add(Jac &r, const Jac &p, const Jac &q) {
  if (is_zero(p.z)) {
    r = q;
    return;
  }
  if (is_zero(q.z)) {
    r = p;
    return;
  }
  Fq z1z1, z2z2, u1, u2, s1, s2, h, rr, t;
  mont_sq(z1z1, p.z);
  mont_sq(z2z2, q.z);
  mont_mul(u1, p.x, z2z2);
  mont_mul(u2, q.x, z1z1);
  mont_mul(t, q.z, z2z2);
  mont_mul(s1, p.y, t);
  mont_mul(t, p.z, z1z1);
  mont_mul(s2, q.y, t);
  sub_mod(h, u2, u1);
  sub_mod(rr, s2, s1);
  if (is_zero(h)) {
    if (is_zero(rr)) {
      jac_double(r, p);
    } else {
      jac_set_inf(r);
    }
    return;
  }
  Fq h2, h3, u1h2, x3, y3, z3;
  mont_sq(h2, h);
  mont_mul(h3, h2, h);
  mont_mul(u1h2, u1, h2);
  mont_sq(x3, rr);
  sub_mod(x3, x3, h3);
  sub_mod(x3, x3, u1h2);
  sub_mod(x3, x3, u1h2);
  sub_mod(t, u1h2, x3);
  mont_mul(t, rr, t);
  Fq s1h3;
  mont_mul(s1h3, s1, h3);
  sub_mod(y3, t, s1h3);
  mont_mul(z3, p.z, q.z);
  mont_mul(z3, z3, h);
  r.x = x3;
  r.y = y3;
  r.z = z3;
}

// ---------------------------------------------------------------------------
// mixed (Jacobian + affine) addition — the Pippenger bucket workhorse
// ---------------------------------------------------------------------------

struct AffM {
  Fq x, y;  // Montgomery form
  uint8_t inf;
};

// r = p + q (q affine, z=1 implicit), madd-2007-bl.
static void jac_add_aff(Jac &r, const Jac &p, const AffM &q) {
  if (q.inf) {
    r = p;
    return;
  }
  if (is_zero(p.z)) {
    r.x = q.x;
    r.y = q.y;
    memcpy(r.z.v, R1, 32);
    return;
  }
  Fq z1z1, u2, s2, h, hh, i, j, rr, v, t;
  mont_sq(z1z1, p.z);
  mont_mul(u2, q.x, z1z1);
  mont_mul(t, p.z, z1z1);
  mont_mul(s2, q.y, t);
  sub_mod(h, u2, p.x);
  sub_mod(rr, s2, p.y);
  dbl_mod(rr, rr);
  if (is_zero(h)) {
    if (is_zero(rr)) {
      Jac qj;
      qj.x = q.x;
      qj.y = q.y;
      memcpy(qj.z.v, R1, 32);
      jac_double(r, qj);
    } else {
      jac_set_inf(r);
    }
    return;
  }
  mont_sq(hh, h);
  dbl_mod(i, hh);
  dbl_mod(i, i);  // i = 4*hh
  mont_mul(j, h, i);
  mont_mul(v, p.x, i);
  Fq x3, y3, z3;
  mont_sq(x3, rr);
  sub_mod(x3, x3, j);
  sub_mod(x3, x3, v);
  sub_mod(x3, x3, v);
  sub_mod(t, v, x3);
  mont_mul(t, rr, t);
  Fq y1j;
  mont_mul(y1j, p.y, j);
  dbl_mod(y1j, y1j);
  sub_mod(y3, t, y1j);
  add_mod(z3, p.z, h);
  mont_sq(z3, z3);
  sub_mod(z3, z3, z1z1);
  sub_mod(z3, z3, hh);
  r.x = x3;
  r.y = y3;
  r.z = z3;
}

// one Pippenger pass over a contiguous range of points (affine Montgomery)
static void msm_core(const AffM *pts, const u64 *scalars, size_t n, int c,
                     Jac &result) {
  int nwin = (254 + c - 1) / c;
  size_t nbuckets = ((size_t)1 << c) - 1;
  std::vector<Jac> buckets(nbuckets);
  Jac acc;
  jac_set_inf(acc);
  for (int w = nwin - 1; w >= 0; --w) {
    for (int d = 0; d < c; d++) jac_double(acc, acc);
    for (auto &b : buckets) jac_set_inf(b);
    int shift = w * c;
    for (size_t i = 0; i < n; i++) {
      if (pts[i].inf) continue;
      int limb = shift / 64, off = shift % 64;
      u64 d = scalars[i * 4 + limb] >> off;
      if (off && limb < 3) d |= scalars[i * 4 + limb + 1] << (64 - off);
      d &= nbuckets;  // mask = 2^c - 1
      if (d) jac_add_aff(buckets[d - 1], buckets[d - 1], pts[i]);
    }
    Jac run, tot;
    jac_set_inf(run);
    jac_set_inf(tot);
    for (size_t b = nbuckets; b >= 1; --b) {
      jac_add(run, run, buckets[b - 1]);
      jac_add(tot, tot, run);
    }
    jac_add(acc, acc, tot);
  }
  result = acc;
}

extern "C" {

// points: n * 8 u64 (x limbs, y limbs), plain (non-Montgomery) canonical;
// infs: n bytes; scalars: n * 4 u64; out: 12 u64 Jacobian (plain form).
void h2a_g1_msm(const u64 *points, const uint8_t *infs, const u64 *scalars,
                size_t n, int window_bits, u64 *out) {
  int c = window_bits > 0
              ? window_bits
              : (n < 32 ? 4 : (n < 4096 ? 8 : (n < (1u << 20) ? 12 : 15)));

  // convert points to Montgomery affine once
  std::vector<AffM> pts(n);
  Fq r2;
  memcpy(r2.v, R2, 32);
  // large MSMs split into one contiguous chunk per OpenMP thread
  const size_t nthreads =
      n >= (1 << 15) ? (size_t)std::max(1, omp_get_max_threads()) : 1;
#pragma omp parallel for if (n >= (1 << 15))
  for (size_t i = 0; i < n; i++) {
    pts[i].inf = infs[i];
    if (infs[i]) continue;
    Fq x, y;
    memcpy(x.v, points + i * 8, 32);
    memcpy(y.v, points + i * 8 + 4, 32);
    mont_mul(pts[i].x, x, r2);
    mont_mul(pts[i].y, y, r2);
  }

  std::vector<Jac> parts(nthreads);
#pragma omp parallel for schedule(static, 1) num_threads((int)nthreads)
  for (size_t t = 0; t < nthreads; t++) {
    const size_t lo = n * t / nthreads, hi = n * (t + 1) / nthreads;
    msm_core(pts.data() + lo, scalars + lo * 4, hi - lo, c, parts[t]);
  }
  Jac acc = parts[0];
  for (size_t t = 1; t < nthreads; t++) jac_add(acc, acc, parts[t]);

  // convert out of Montgomery (leave Jacobian; caller normalizes)
  Fq one;
  memset(one.v, 0, 32);
  one.v[0] = 1;
  Fq x, y, z;
  mont_mul(x, acc.x, one);
  mont_mul(y, acc.y, one);
  mont_mul(z, acc.z, one);
  memcpy(out, x.v, 32);
  memcpy(out + 4, y.v, 32);
  memcpy(out + 8, z.v, 32);
}

// batch-normalize n Jacobian points (plain form) to affine via one
// batched inversion; out: n*8 u64 affine + n inf flags.
void h2a_g1_normalize(const u64 *jac_in, size_t n, u64 *aff_out,
                      uint8_t *inf_out) {
  Fq r2;
  memcpy(r2.v, R2, 32);
  std::vector<Jac> pts(n);
  for (size_t i = 0; i < n; i++) {
    Fq x, y, z;
    memcpy(x.v, jac_in + i * 12, 32);
    memcpy(y.v, jac_in + i * 12 + 4, 32);
    memcpy(z.v, jac_in + i * 12 + 8, 32);
    mont_mul(pts[i].x, x, r2);
    mont_mul(pts[i].y, y, r2);
    mont_mul(pts[i].z, z, r2);
  }
  // batch inversion of the z's (Montgomery trick), zeros skipped
  std::vector<Fq> prefix(n);
  Fq run;
  memcpy(run.v, R1, 32);
  for (size_t i = 0; i < n; i++) {
    if (!is_zero(pts[i].z)) mont_mul(run, run, pts[i].z);
    prefix[i] = run;
  }
  Fq inv_run;
  mont_inv(inv_run, run);
  Fq one;
  memset(one.v, 0, 32);
  one.v[0] = 1;
  for (size_t i = n; i-- > 0;) {
    if (is_zero(pts[i].z)) {
      inf_out[i] = 1;
      memset(aff_out + i * 8, 0, 64);
      continue;
    }
    inf_out[i] = 0;
    Fq zinv;
    if (i == 0) {
      memcpy(zinv.v, inv_run.v, 32);
    } else {
      mont_mul(zinv, inv_run, prefix[i - 1]);
    }
    mont_mul(inv_run, inv_run, pts[i].z);
    Fq zi2, zi3, xa, ya;
    mont_sq(zi2, zinv);
    mont_mul(zi3, zi2, zinv);
    mont_mul(xa, pts[i].x, zi2);
    mont_mul(ya, pts[i].y, zi3);
    mont_mul(xa, xa, one);  // out of Montgomery
    mont_mul(ya, ya, one);
    memcpy(aff_out + i * 8, xa.v, 32);
    memcpy(aff_out + i * 8 + 4, ya.v, 32);
  }
}

// windowed (w=8) batched fixed-base scalar mul with batch normalization:
// out[i] = scalars[i] * base, affine plain form.  This is the SRS
// generator's hot loop (n = 2^23 at the reference's outer k).
void h2a_g1_batch_mul_win(const u64 *base_xy, const u64 *scalars, size_t n,
                          u64 *aff_out, uint8_t *inf_out) {
  Fq r2;
  memcpy(r2.v, R2, 32);
  Jac base;
  Fq bx, by;
  memcpy(bx.v, base_xy, 32);
  memcpy(by.v, base_xy + 4, 32);
  mont_mul(base.x, bx, r2);
  mont_mul(base.y, by, r2);
  memcpy(base.z.v, R1, 32);

  const int W = 8, NWIN = 32;  // 256 bits of scalar
  // table[j][d] = d * 2^(8j) * G, affine Montgomery for mixed adds
  std::vector<Jac> tj(NWIN * 256);
  Jac pj = base;
  for (int j = 0; j < NWIN; j++) {
    jac_set_inf(tj[j * 256]);
    tj[j * 256 + 1] = pj;
    for (int d = 2; d < 256; d++)
      jac_add(tj[j * 256 + d], tj[j * 256 + d - 1], pj);
    for (int b = 0; b < W; b++) jac_double(pj, pj);
  }
  // normalize the table to affine (batch inversion, Montgomery stays)
  std::vector<AffM> taff(NWIN * 256);
  {
    size_t m = tj.size();
    std::vector<Fq> prefix(m);
    Fq run;
    memcpy(run.v, R1, 32);
    for (size_t i = 0; i < m; i++) {
      if (!is_zero(tj[i].z)) mont_mul(run, run, tj[i].z);
      prefix[i] = run;
    }
    Fq inv_run;
    mont_inv(inv_run, run);
    for (size_t i = m; i-- > 0;) {
      if (is_zero(tj[i].z)) {
        taff[i].inf = 1;
        continue;
      }
      taff[i].inf = 0;
      Fq zinv;
      if (i == 0) memcpy(zinv.v, inv_run.v, 32);
      else mont_mul(zinv, inv_run, prefix[i - 1]);
      mont_mul(inv_run, inv_run, tj[i].z);
      Fq zi2, zi3;
      mont_sq(zi2, zinv);
      mont_mul(zi3, zi2, zinv);
      mont_mul(taff[i].x, tj[i].x, zi2);
      mont_mul(taff[i].y, tj[i].y, zi3);
    }
  }

  std::vector<Jac> acc(n);
#pragma omp parallel for schedule(static)
  for (size_t i = 0; i < n; i++) {
    Jac a;
    jac_set_inf(a);
    for (int j = 0; j < NWIN; j++) {
      int limb = (j * W) / 64, off = (j * W) % 64;
      u64 d = (scalars[i * 4 + limb] >> off) & 0xFF;
      if (d) jac_add_aff(a, a, taff[j * 256 + d]);
    }
    acc[i] = a;
  }

  // batch-normalize the results straight to plain affine
  std::vector<Fq> prefix(n);
  Fq run;
  memcpy(run.v, R1, 32);
  for (size_t i = 0; i < n; i++) {
    if (!is_zero(acc[i].z)) mont_mul(run, run, acc[i].z);
    prefix[i] = run;
  }
  Fq inv_run;
  mont_inv(inv_run, run);
  Fq one;
  memset(one.v, 0, 32);
  one.v[0] = 1;
  for (size_t i = n; i-- > 0;) {
    if (is_zero(acc[i].z)) {
      inf_out[i] = 1;
      memset(aff_out + i * 8, 0, 64);
      continue;
    }
    inf_out[i] = 0;
    Fq zinv;
    if (i == 0) memcpy(zinv.v, inv_run.v, 32);
    else mont_mul(zinv, inv_run, prefix[i - 1]);
    mont_mul(inv_run, inv_run, acc[i].z);
    Fq zi2, zi3, xa, ya;
    mont_sq(zi2, zinv);
    mont_mul(zi3, zi2, zinv);
    mont_mul(xa, acc[i].x, zi2);
    mont_mul(ya, acc[i].y, zi3);
    mont_mul(xa, xa, one);
    mont_mul(ya, ya, one);
    memcpy(aff_out + i * 8, xa.v, 32);
    memcpy(aff_out + i * 8 + 4, ya.v, 32);
  }
}

// batched fixed-base scalar mul: out[i] = scalars[i] * G  (for SRS gen)
void h2a_g1_batch_mul(const u64 *base_xy, const u64 *scalars, size_t n,
                      u64 *out_xyz) {
  Fq r2;
  memcpy(r2.v, R2, 32);
  Jac base;
  Fq x, y;
  memcpy(x.v, base_xy, 32);
  memcpy(y.v, base_xy + 4, 32);
  mont_mul(base.x, x, r2);
  mont_mul(base.y, y, r2);
  memcpy(base.z.v, R1, 32);
  // shared doubling table
  std::vector<Jac> table(254);
  table[0] = base;
  for (int i = 1; i < 254; i++) jac_double(table[i], table[i - 1]);
  Fq one;
  memset(one.v, 0, 32);
  one.v[0] = 1;
  for (size_t i = 0; i < n; i++) {
    Jac acc;
    jac_set_inf(acc);
    for (int b = 0; b < 254; b++) {
      if ((scalars[i * 4 + b / 64] >> (b % 64)) & 1)
        jac_add(acc, acc, table[b]);
    }
    Fq ox, oy, oz;
    mont_mul(ox, acc.x, one);
    mont_mul(oy, acc.y, one);
    mont_mul(oz, acc.z, one);
    memcpy(out_xyz + i * 12, ox.v, 32);
    memcpy(out_xyz + i * 12 + 4, oy.v, 32);
    memcpy(out_xyz + i * 12 + 8, oz.v, 32);
  }
}
}

// ===========================================================================
// Fr (BN254 scalar field) polynomial engine
//
// All vector entry points below operate on (n, 4) uint64 arrays in
// MONTGOMERY form; to_mont/from_mont convert at the Python boundary.
// This is the native runtime behind plonk/engine.py's NativeVecOps and
// the scaled prover (the role the reference's fork delegates to its
// EvaluationDomain + rayon, SURVEY.md §2b).
// ===========================================================================

// BN254 scalar field modulus r, little-endian 64-bit limbs
static const u64 FR_MOD[4] = {0x43e1f593f0000001ULL, 0x2833e84879b97091ULL,
                              0xb85045b68181585dULL, 0x30644e72e131a029ULL};
static const u64 FR_INV_NEG = 0xc2e1f593efffffffULL;
static const u64 FR_R2[4] = {0x1bb8e645ae216da7ULL, 0x53fe3ab1e35c59e3ULL,
                             0x8c49833d53bb8085ULL, 0x0216d0b17f4e44a5ULL};
static const u64 FR_R1[4] = {0xac96341c4ffffffbULL, 0x36fc76959f60cd29ULL,
                             0x666ea36f7879462eULL, 0x0e0a77c19a07df2fULL};
static const u64 FR_M2[4] = {0x43e1f593efffffffULL, 0x2833e84879b97091ULL,
                             0xb85045b68181585dULL, 0x30644e72e131a029ULL};

struct Fr {
  u64 v[4];
};

static inline bool fr_is_zero(const Fr &a) {
  return (a.v[0] | a.v[1] | a.v[2] | a.v[3]) == 0;
}

static inline void fr_add(Fr &r, const Fr &a, const Fr &b) {
  u128 carry = 0;
  u64 t[4];
  for (int i = 0; i < 4; i++) {
    u128 s = (u128)a.v[i] + b.v[i] + carry;
    t[i] = (u64)s;
    carry = s >> 64;
  }
  if (carry || cmp(t, FR_MOD) >= 0) sub_nocarry(r.v, t, FR_MOD);
  else memcpy(r.v, t, 32);
}

static inline void fr_sub(Fr &r, const Fr &a, const Fr &b) {
  if (cmp(a.v, b.v) >= 0) {
    sub_nocarry(r.v, a.v, b.v);
  } else {
    u64 t[4];
    u128 carry = 0;
    for (int i = 0; i < 4; i++) {
      u128 s = (u128)a.v[i] + FR_MOD[i] + carry;
      t[i] = (u64)s;
      carry = s >> 64;
    }
    sub_nocarry(r.v, t, b.v);
  }
}

static void fr_mont_mul(Fr &r, const Fr &a, const Fr &b) {
  u64 t[6] = {0, 0, 0, 0, 0, 0};
  for (int i = 0; i < 4; i++) {
    u128 carry = 0;
    for (int j = 0; j < 4; j++) {
      u128 s = (u128)t[j] + (u128)a.v[i] * b.v[j] + carry;
      t[j] = (u64)s;
      carry = s >> 64;
    }
    u128 s = (u128)t[4] + carry;
    t[4] = (u64)s;
    t[5] = (u64)(s >> 64);
    u64 m = t[0] * FR_INV_NEG;
    carry = ((u128)t[0] + (u128)m * FR_MOD[0]) >> 64;
    for (int j = 1; j < 4; j++) {
      u128 s2 = (u128)t[j] + (u128)m * FR_MOD[j] + carry;
      t[j - 1] = (u64)s2;
      carry = s2 >> 64;
    }
    s = (u128)t[4] + carry;
    t[3] = (u64)s;
    t[4] = t[5] + (u64)(s >> 64);
    t[5] = 0;
  }
  if (t[4] || cmp(t, FR_MOD) >= 0) sub_nocarry(r.v, t, FR_MOD);
  else memcpy(r.v, t, 32);
}

static inline void fr_sq(Fr &r, const Fr &a) { fr_mont_mul(r, a, a); }

static void fr_inv(Fr &r, const Fr &a) {
  Fr acc;
  memcpy(acc.v, FR_R1, 32);
  for (int i = 3; i >= 0; --i) {
    for (int b = 63; b >= 0; --b) {
      fr_sq(acc, acc);
      if ((FR_M2[i] >> b) & 1) fr_mont_mul(acc, acc, a);
    }
  }
  r = acc;
}

static inline Fr *frp(u64 *p) { return (Fr *)p; }
static inline const Fr *frp(const u64 *p) { return (const Fr *)p; }

extern "C" {

// in-place: a[i] -> a[i] * R mod r  (enter Montgomery form)
void h2a_fr_to_mont(u64 *a, size_t n) {
  Fr r2;
  memcpy(r2.v, FR_R2, 32);
#pragma omp parallel for schedule(static)
  for (size_t i = 0; i < n; i++) fr_mont_mul(frp(a)[i], frp(a)[i], r2);
}

// in-place: leave Montgomery form
void h2a_fr_from_mont(u64 *a, size_t n) {
  Fr one;
  memset(one.v, 0, 32);
  one.v[0] = 1;
#pragma omp parallel for schedule(static)
  for (size_t i = 0; i < n; i++) fr_mont_mul(frp(a)[i], frp(a)[i], one);
}

// elementwise binop with rotation/broadcast semantics:
//   out[i] = X op Y,  X = x[(i + xrot) mod xlen]  (broadcast if xlen == 1)
// op: 0 add, 1 sub, 2 mul.  All Montgomery form.  out may alias x or y
// only when both rotations are 0.
void h2a_fr_vec_binop(int op, const u64 *x, size_t xlen, long xrot,
                      const u64 *y, size_t ylen, long yrot, u64 *out,
                      size_t n) {
  const Fr *xv = frp(x);
  const Fr *yv = frp(y);
  Fr *ov = frp(out);
  long xr = xlen ? ((xrot % (long)xlen) + (long)xlen) % (long)xlen : 0;
  long yr = ylen ? ((yrot % (long)ylen) + (long)ylen) % (long)ylen : 0;
#pragma omp parallel for schedule(static)
  for (size_t i = 0; i < n; i++) {
    size_t ix = xlen == 1 ? 0 : (i + (size_t)xr) % xlen;
    size_t iy = ylen == 1 ? 0 : (i + (size_t)yr) % ylen;
    switch (op) {
      case 0: fr_add(ov[i], xv[ix], yv[iy]); break;
      case 1: fr_sub(ov[i], xv[ix], yv[iy]); break;
      default: fr_mont_mul(ov[i], xv[ix], yv[iy]); break;
    }
  }
}

// out[i] = -x[i]
void h2a_fr_vec_neg(const u64 *x, u64 *out, size_t n) {
  Fr zero;
  memset(zero.v, 0, 32);
#pragma omp parallel for schedule(static)
  for (size_t i = 0; i < n; i++) fr_sub(frp(out)[i], zero, frp(x)[i]);
}

// in-place a[i] *= c
void h2a_fr_vec_scale(u64 *a, size_t n, const u64 *c4) {
  Fr c = *frp(c4);
#pragma omp parallel for schedule(static)
  for (size_t i = 0; i < n; i++) fr_mont_mul(frp(a)[i], frp(a)[i], c);
}

// in-place a[i] *= g^i  (coset scaling); g in Montgomery form
void h2a_fr_scale_pows(u64 *a, size_t n, const u64 *g4) {
  Fr g = *frp(g4);
  Fr p;
  memcpy(p.v, FR_R1, 32);
  for (size_t i = 0; i < n; i++) {
    fr_mont_mul(frp(a)[i], frp(a)[i], p);
    fr_mont_mul(p, p, g);
  }
}

// in-place radix-2 NTT of size n = 2^k over Montgomery-form values.
// omega4: the size-n root of unity, PLAIN form (converted internally).
// Inverse transforms pass omega^{-1}; the caller applies the 1/n scale
// with h2a_fr_vec_scale.
void h2a_fr_ntt(u64 *data, uint32_t k, const u64 *omega4) {
  size_t n = (size_t)1 << k;
  Fr *a = frp(data);
  // bit-reverse permute
  for (size_t i = 1, j = 0; i < n; i++) {
    size_t bit = n >> 1;
    for (; j & bit; bit >>= 1) j ^= bit;
    j |= bit;
    if (i < j) {
      Fr t = a[i];
      a[i] = a[j];
      a[j] = t;
    }
  }
  // twiddle table: pows[t] = omega^t (Montgomery), t < n/2 — built by a
  // SEQUENTIAL mul chain, so cache the last (k, omega) table: a k=21
  // prove calls this dozens of times with only two distinct roots per
  // direction, and the 2^22-mul rebuild for the 2^23 ext INTT alone is
  // seconds of single-core time.  (Process-global; callers are the
  // serial prover loops.)
  static std::vector<Fr> pows;
  static uint32_t cached_k = 0;
  static u64 cached_om[4] = {0, 0, 0, 0};
  if (cached_k != k || memcmp(cached_om, omega4, 32) != 0) {
    Fr om, r2;
    memcpy(r2.v, FR_R2, 32);
    fr_mont_mul(om, *frp(omega4), r2);
    pows.assign(n / 2, Fr());
    memcpy(pows[0].v, FR_R1, 32);
    for (size_t t = 1; t < n / 2; t++) fr_mont_mul(pows[t], pows[t - 1], om);
    cached_k = k;
    memcpy(cached_om, omega4, 32);
  }

  for (uint32_t s = 0; s < k; s++) {
    size_t half = (size_t)1 << s;
    uint32_t twshift = k - 1 - s;
#pragma omp parallel for schedule(static)
    for (size_t idx = 0; idx < n / 2; idx++) {
      size_t blk = idx >> s;
      size_t t = idx & (half - 1);
      size_t i0 = (blk << (s + 1)) + t;
      size_t i1 = i0 + half;
      Fr hi;
      fr_mont_mul(hi, a[i1], pows[t << twshift]);
      Fr lo = a[i0];
      fr_add(a[i0], lo, hi);
      fr_sub(a[i1], lo, hi);
    }
  }
}

// serial Montgomery-batch-inversion core (zeros map to zero)
static void fr_batch_inv_serial(Fr *a, size_t n) {
  std::vector<Fr> prefix(n);
  Fr run;
  memcpy(run.v, FR_R1, 32);
  for (size_t i = 0; i < n; i++) {
    if (!fr_is_zero(a[i])) fr_mont_mul(run, run, a[i]);
    prefix[i] = run;
  }
  Fr inv_run;
  fr_inv(inv_run, run);
  for (size_t i = n; i-- > 0;) {
    if (fr_is_zero(a[i])) continue;
    Fr ai = a[i];
    if (i == 0) {
      a[i] = inv_run;
    } else {
      fr_mont_mul(a[i], inv_run, prefix[i - 1]);
    }
    fr_mont_mul(inv_run, inv_run, ai);
  }
}

// in-place batch inversion (Montgomery form); zeros map to zero.
// Parallel over chunks — each chunk pays one extra fr_inv (a fixed
// 254-bit modexp), negligible against the 3n sequential muls it halves
// (the prover's barycentric denominators are 2^21+ rows).
void h2a_fr_batch_inv(u64 *data, size_t n) {
  Fr *a = frp(data);
  if (n < (1 << 14)) {
    fr_batch_inv_serial(a, n);
    return;
  }
  int nthreads = 1;
#ifdef _OPENMP
  nthreads = omp_get_max_threads();
#endif
  size_t nchunks = (size_t)(nthreads > 0 ? nthreads : 1);
  size_t chunk = (n + nchunks - 1) / nchunks;
#pragma omp parallel for schedule(static)
  for (size_t c = 0; c < nchunks; c++) {
    size_t lo = c * chunk;
    if (lo < n) fr_batch_inv_serial(a + lo, std::min(chunk, n - lo));
  }
}

// grand product: z[0] = init; z[j+1] = z[j] * num[j] / den[j], j < m.
// z has m+1 entries.  Montgomery form; dens batch-inverted.
void h2a_fr_grand_product(const u64 *num, const u64 *den, const u64 *init4,
                          u64 *z_out, size_t m) {
  std::vector<Fr> dinv(m);
  memcpy(dinv.data(), den, m * 32);
  h2a_fr_batch_inv((u64 *)dinv.data(), m);
  Fr *z = frp(z_out);
  z[0] = *frp(init4);
  for (size_t j = 0; j < m; j++) {
    Fr t;
    fr_mont_mul(t, z[j], frp(num)[j]);
    fr_mont_mul(z[j + 1], t, dinv[j]);
  }
}

// Horner evaluation: out = sum coeffs[i] * x^i (ascending coeffs, mont)
void h2a_fr_horner(const u64 *coeffs, size_t n, const u64 *x4, u64 *out4) {
  Fr acc;
  memset(acc.v, 0, 32);
  const Fr *c = frp(coeffs);
  Fr x = *frp(x4);
  for (size_t i = n; i-- > 0;) {
    Fr t;
    fr_mont_mul(t, acc, x);
    fr_add(acc, t, c[i]);
  }
  *frp(out4) = acc;
}

// synthetic division: q(X) = (f(X) - f(z)) / (X - z); q has n-1 coeffs.
void h2a_fr_divide_linear(const u64 *coeffs, size_t n, const u64 *z4,
                          u64 *q_out) {
  const Fr *c = frp(coeffs);
  Fr *q = frp(q_out);
  Fr z = *frp(z4);
  Fr acc;
  memset(acc.v, 0, 32);
  for (size_t i = n; i-- > 1;) {
    Fr t;
    fr_mont_mul(t, acc, z);
    fr_add(acc, t, c[i]);
    q[i - 1] = acc;
  }
}

// in-place fold: acc[i] = acc[i] * v + x[i]  (the multiopen v-fold)
void h2a_fr_fold(u64 *acc, const u64 *x, const u64 *v4, size_t n) {
  Fr v = *frp(v4);
#pragma omp parallel for schedule(static)
  for (size_t i = 0; i < n; i++) {
    Fr t;
    fr_mont_mul(t, frp(acc)[i], v);
    fr_add(frp(acc)[i], t, frp(x)[i]);
  }
}

// dot product: out = sum_i a[i] * b[i] (Montgomery form).  Backs the
// prover's barycentric evaluations (one dot per (query, point) against
// the shared weight vector w_i = omega^i / (z - omega^i)) — unlike
// h2a_fr_horner it has no sequential dependency, so it parallelizes.
void h2a_fr_dot(const u64 *a, const u64 *b, size_t n, u64 *out4) {
  const Fr *av = frp(a);
  const Fr *bv = frp(b);
  Fr total;
  memset(total.v, 0, 32);
#pragma omp parallel
  {
    Fr local;
    memset(local.v, 0, 32);
#pragma omp for schedule(static) nowait
    for (size_t i = 0; i < n; i++) {
      Fr t;
      fr_mont_mul(t, av[i], bv[i]);
      fr_add(local, local, t);
    }
#pragma omp critical
    fr_add(total, total, local);
  }
  *frp(out4) = total;
}
}

// ===========================================================================
// BN254 optimal-ate pairing
//
// The deferred check the whole aggregation pipeline reduces to:
//   e(w, [tau]_2) == e(zw + f + e, [1]_2)
// (SURVEY.md §3.3; the reference runs it inside its Rust fork's
// verify_proof, simple-example.rs:722-730).  Strategy mirrors the Python
// oracle (halo2_aggregation/oracle/pairing.py): untwist G2 to E(Fq12)
// and run a fully generic affine Miller loop + big-exponent final
// exponentiation.  Generic is ~4x slower than sparse-line code but has no
// room for coefficient errors — and at C++ speed the whole pairing is
// ~tens of ms vs seconds in Python.  Correctness is pinned by oracle-diff
// tests (tests/test_native_engine.py).
// ===========================================================================

struct Fq2 { Fq c0, c1; };
struct Fq6 { Fq2 c0, c1, c2; };
struct Fq12 { Fq6 c0, c1; };

static inline void fq2_add(Fq2 &r, const Fq2 &a, const Fq2 &b) {
  add_mod(r.c0, a.c0, b.c0); add_mod(r.c1, a.c1, b.c1);
}
static inline void fq2_sub(Fq2 &r, const Fq2 &a, const Fq2 &b) {
  sub_mod(r.c0, a.c0, b.c0); sub_mod(r.c1, a.c1, b.c1);
}
static inline void fq2_neg(Fq2 &r, const Fq2 &a) {
  Fq z; memset(z.v, 0, 32);
  sub_mod(r.c0, z, a.c0); sub_mod(r.c1, z, a.c1);
}
// (a0 + a1 u)(b0 + b1 u) = (a0b0 - a1b1) + (a0b1 + a1b0) u   (u^2 = -1)
static void fq2_mul(Fq2 &r, const Fq2 &a, const Fq2 &b) {
  Fq t0, t1, t2, t3;
  mont_mul(t0, a.c0, b.c0);
  mont_mul(t1, a.c1, b.c1);
  mont_mul(t2, a.c0, b.c1);
  mont_mul(t3, a.c1, b.c0);
  sub_mod(r.c0, t0, t1);
  add_mod(r.c1, t2, t3);
}
static void fq2_inv(Fq2 &r, const Fq2 &a) {
  Fq t0, t1, t;
  mont_mul(t0, a.c0, a.c0);
  mont_mul(t1, a.c1, a.c1);
  add_mod(t, t0, t1);
  mont_inv(t, t);
  mont_mul(r.c0, a.c0, t);
  Fq n1; Fq z; memset(z.v, 0, 32);
  sub_mod(n1, z, a.c1);
  mont_mul(r.c1, n1, t);
}

// xi = 9 + u (the sextic-twist non-residue), Montgomery form
static Fq2 fq2_xi() {
  Fq2 xi;
  Fq nine; Fq r2; memcpy(r2.v, R2, 32);
  u64 nine_p[4] = {9, 0, 0, 0};
  Fq n; memcpy(n.v, nine_p, 32);
  mont_mul(nine, n, r2);
  xi.c0 = nine;
  memcpy(xi.c1.v, R1, 32);
  return xi;
}

static void fq6_add(Fq6 &r, const Fq6 &a, const Fq6 &b) {
  fq2_add(r.c0, a.c0, b.c0); fq2_add(r.c1, a.c1, b.c1); fq2_add(r.c2, a.c2, b.c2);
}
static void fq6_sub(Fq6 &r, const Fq6 &a, const Fq6 &b) {
  fq2_sub(r.c0, a.c0, b.c0); fq2_sub(r.c1, a.c1, b.c1); fq2_sub(r.c2, a.c2, b.c2);
}
static void fq6_neg(Fq6 &r, const Fq6 &a) {
  fq2_neg(r.c0, a.c0); fq2_neg(r.c1, a.c1); fq2_neg(r.c2, a.c2);
}
// schoolbook mul in Fq2[v]/(v^3 - xi) — mirrors oracle fq6_mul exactly
static void fq6_mul(Fq6 &r, const Fq6 &a, const Fq6 &b) {
  Fq2 xi = fq2_xi();
  Fq2 t00, t11, t22, t, s, u;
  fq2_mul(t00, a.c0, b.c0);
  fq2_mul(t11, a.c1, b.c1);
  fq2_mul(t22, a.c2, b.c2);
  // c0 = t00 + xi*(a1*b2 + a2*b1)
  fq2_mul(t, a.c1, b.c2);
  fq2_mul(s, a.c2, b.c1);
  fq2_add(t, t, s);
  fq2_mul(t, xi, t);
  fq2_add(r.c0, t00, t);
  // c1 = a0*b1 + a1*b0 + xi*t22
  fq2_mul(t, a.c0, b.c1);
  fq2_mul(s, a.c1, b.c0);
  fq2_add(t, t, s);
  fq2_mul(u, xi, t22);
  fq2_add(r.c1, t, u);
  // c2 = a0*b2 + a2*b0 + t11
  fq2_mul(t, a.c0, b.c2);
  fq2_mul(s, a.c2, b.c0);
  fq2_add(t, t, s);
  fq2_add(r.c2, t, t11);
}
// a * v : (a0 + a1 v + a2 v^2) v = xi a2 + a0 v + a1 v^2
static void fq6_mul_by_v(Fq6 &r, const Fq6 &a) {
  Fq2 xi = fq2_xi();
  Fq2 t;
  fq2_mul(t, xi, a.c2);
  Fq2 a0 = a.c0, a1 = a.c1;
  r.c0 = t; r.c1 = a0; r.c2 = a1;
}
static void fq6_inv(Fq6 &r, const Fq6 &a) {
  Fq2 xi = fq2_xi();
  Fq2 c0, c1, c2, t, s, u;
  fq2_mul(t, a.c0, a.c0);
  fq2_mul(s, a.c1, a.c2);
  fq2_mul(s, xi, s);
  fq2_sub(c0, t, s);
  fq2_mul(t, a.c2, a.c2);
  fq2_mul(t, xi, t);
  fq2_mul(s, a.c0, a.c1);
  fq2_sub(c1, t, s);
  fq2_mul(t, a.c1, a.c1);
  fq2_mul(s, a.c0, a.c2);
  fq2_sub(c2, t, s);
  // t = a0*c0 + xi*(a2*c1 + a1*c2)
  fq2_mul(t, a.c2, c1);
  fq2_mul(s, a.c1, c2);
  fq2_add(t, t, s);
  fq2_mul(t, xi, t);
  fq2_mul(s, a.c0, c0);
  fq2_add(t, s, t);
  fq2_inv(u, t);
  fq2_mul(r.c0, c0, u);
  fq2_mul(r.c1, c1, u);
  fq2_mul(r.c2, c2, u);
}

static void fq12_mul(Fq12 &r, const Fq12 &a, const Fq12 &b) {
  Fq6 t0, t1, t2, t3;
  fq6_mul(t0, a.c0, b.c0);
  fq6_mul(t1, a.c1, b.c1);
  fq6_mul(t2, a.c0, b.c1);
  fq6_mul(t3, a.c1, b.c0);
  Fq6 v;
  fq6_mul_by_v(v, t1);
  fq6_add(r.c0, t0, v);
  fq6_add(r.c1, t2, t3);
}
static void fq12_sub(Fq12 &r, const Fq12 &a, const Fq12 &b) {
  fq6_sub(r.c0, a.c0, b.c0); fq6_sub(r.c1, a.c1, b.c1);
}
static void fq12_add(Fq12 &r, const Fq12 &a, const Fq12 &b) {
  fq6_add(r.c0, a.c0, b.c0); fq6_add(r.c1, a.c1, b.c1);
}
static void fq12_neg(Fq12 &r, const Fq12 &a) {
  fq6_neg(r.c0, a.c0); fq6_neg(r.c1, a.c1);
}
static void fq12_inv(Fq12 &r, const Fq12 &a) {
  Fq6 t, s;
  fq6_mul(t, a.c0, a.c0);
  fq6_mul(s, a.c1, a.c1);
  Fq6 v;
  fq6_mul_by_v(v, s);
  fq6_sub(t, t, v);
  fq6_inv(t, t);
  fq6_mul(r.c0, a.c0, t);
  Fq6 n;
  fq6_mul(n, a.c1, t);
  fq6_neg(r.c1, n);
}
static void fq12_set_one(Fq12 &r) {
  memset(&r, 0, sizeof(r));
  memcpy(r.c0.c0.c0.v, R1, 32);
}
static bool fq12_eq(const Fq12 &a, const Fq12 &b) {
  return memcmp(&a, &b, sizeof(Fq12)) == 0;
}
static bool fq12_is_zero(const Fq12 &a) {
  static const Fq12 z = {};
  return memcmp(&a, &z, sizeof(Fq12)) == 0;
}
// r = a^e, e given as n little-endian u64 limbs (plain integer)
static void fq12_pow(Fq12 &r, const Fq12 &a, const u64 *e, int n) {
  int msb = -1;
  for (int i = n - 1; i >= 0 && msb < 0; i--)
    for (int b = 63; b >= 0; b--)
      if ((e[i] >> b) & 1) { msb = i * 64 + b; break; }
  fq12_set_one(r);
  if (msb < 0) return;
  for (int i = msb; i >= 0; i--) {
    Fq12 t;
    fq12_mul(t, r, r);
    r = t;
    if ((e[i / 64] >> (i % 64)) & 1) {
      fq12_mul(t, r, a);
      r = t;
    }
  }
}

// --- E(Fq12): y^2 = x^3 + 3, generic affine arithmetic ---------------------

struct EC12 { Fq12 x, y; bool inf; };

static void fq12_from_fq_mont(Fq12 &r, const Fq &a) {
  memset(&r, 0, sizeof(r));
  r.c0.c0.c0 = a;
}

static void ec12_add(EC12 &r, const EC12 &p, const EC12 &q) {
  if (p.inf) { r = q; return; }
  if (q.inf) { r = p; return; }
  Fq12 lam;
  if (fq12_eq(p.x, q.x)) {
    Fq12 ysum;
    fq12_add(ysum, p.y, q.y);
    if (fq12_is_zero(ysum)) { r.inf = true; return; }
    // lam = 3 x^2 / (2 y)
    Fq12 num, den, t;
    fq12_mul(t, p.x, p.x);
    fq12_add(num, t, t);
    fq12_add(num, num, t);
    fq12_add(den, p.y, p.y);
    fq12_inv(den, den);
    fq12_mul(lam, num, den);
  } else {
    Fq12 num, den;
    fq12_sub(num, q.y, p.y);
    fq12_sub(den, q.x, p.x);
    fq12_inv(den, den);
    fq12_mul(lam, num, den);
  }
  Fq12 x3, y3, t;
  fq12_mul(t, lam, lam);
  fq12_sub(t, t, p.x);
  fq12_sub(x3, t, q.x);
  fq12_sub(t, p.x, x3);
  fq12_mul(t, lam, t);
  fq12_sub(y3, t, p.y);
  r.x = x3; r.y = y3; r.inf = false;
}

// line through t and q (tangent when t == q), evaluated at p — mirrors
// oracle _line_eval
static void line_eval(Fq12 &out, const EC12 &t, const EC12 &q, const Fq12 &xp,
                      const Fq12 &yp) {
  Fq12 lam;
  if (fq12_eq(t.x, q.x) && fq12_eq(t.y, q.y)) {
    Fq12 num, den, s;
    fq12_mul(s, t.x, t.x);
    fq12_add(num, s, s);
    fq12_add(num, num, s);
    fq12_add(den, t.y, t.y);
    fq12_inv(den, den);
    fq12_mul(lam, num, den);
  } else if (fq12_eq(t.x, q.x)) {
    // vertical: x - xt
    fq12_sub(out, xp, t.x);
    return;
  } else {
    Fq12 num, den;
    fq12_sub(num, q.y, t.y);
    fq12_sub(den, q.x, t.x);
    fq12_inv(den, den);
    fq12_mul(lam, num, den);
  }
  Fq12 a, b;
  fq12_sub(a, yp, t.y);
  fq12_sub(b, xp, t.x);
  fq12_mul(b, lam, b);
  fq12_sub(out, a, b);
}

// 6x + 2 for BN254 (fields.py BN_SIX_X_PLUS_2) = 0x19d797039be763ba8
static const u64 SIX_X_PLUS_2[2] = {0x9d797039be763ba8ULL, 0x1ULL};
// (q^12 - 1) / r, 2790 bits, 44 little-endian u64 limbs
static const u64 FINAL_EXP_E[44] = {
  0x86964b64ca86f120ULL, 0x40a4efb7e54523a4ULL, 0x837fa97896e84abbULL, 0x361102b6b9b2b918ULL,
  0xc0de81def35692daULL, 0xbe04c7e8a6c3c760ULL, 0xd766f9c9d570bb7fULL, 0xc230974d83561841ULL,
  0x5bba1668c3be69a3ULL, 0x7f3811c410526294ULL, 0x29baee7ddadda71cULL, 0xbf813b8d145da900ULL,
  0x641bbadf423f9a2cULL, 0xa80bb4ea44eacc5eULL, 0xcd65664814fde37cULL, 0x4a0364b9580291d2ULL,
  0xee93dfb10826f0ddULL, 0x6b42db8dc5514724ULL, 0xbb10cf430b0f3785ULL, 0x40494e406f804216ULL,
  0x55cfe107acf3aafbULL, 0x2088ec80e0ebae87ULL, 0x846a3ed011a337a0ULL, 0x48a45a4a1e3a5195ULL,
  0xe5664568dfc50e16ULL, 0xab6a41294c0cc4ebULL, 0x82d0d602d268c7daULL, 0x6668449aed3cc48aULL,
  0x5062cd0fb2015dfcULL, 0x7f2940a8b1ddb3d1ULL, 0x77f5b63a2a226448ULL, 0xfef0781361e443aeULL,
  0xf977870e88d5c6c8ULL, 0x790364a61f676baaULL, 0x5887e72eceaddea3ULL, 0x1377e563a09a1b70ULL,
  0x0c54efee1bd8c3b2ULL, 0x3ec3d15ad524d8f7ULL, 0xdaf15466b2383a5dULL, 0xe1e30a73bb94fec0ULL,
  0x6a1c71015f3f7be2ULL, 0x842d43bf6369b1ffULL, 0x20fddadf107d20bcULL, 0x0000002f4b6dc970ULL};

// untwist (x2, y2) on E'(Fq2) to E(Fq12): (x2 w^2, y2 w^3).
// w^2 = v (so x lands in the c1 slot of the Fq6 at c0), w^3 = v w (y lands
// in the c1 slot of the Fq6 at c1) — matches oracle FQ12_W2/W3.
static void untwist(EC12 &r, const Fq2 &x2, const Fq2 &y2) {
  memset(&r, 0, sizeof(r));
  r.x.c0.c1 = x2;
  r.y.c1.c1 = y2;
  r.inf = false;
}

static void ec12_frobenius(EC12 &r, const EC12 &p) {
  fq12_pow(r.x, p.x, Q, 4);
  fq12_pow(r.y, p.y, Q, 4);
  r.inf = p.inf;
}

// f_{6x+2,Q}(P) with the two Frobenius correction lines (oracle miller_loop)
static void miller_loop_mont(Fq12 &f, const Fq &px, const Fq &py, bool p_inf,
                             const Fq2 &qx, const Fq2 &qy, bool q_inf) {
  fq12_set_one(f);
  if (p_inf || q_inf) return;
  Fq12 xp, yp;
  fq12_from_fq_mont(xp, px);
  fq12_from_fq_mont(yp, py);
  EC12 q12, t;
  untwist(q12, qx, qy);
  t = q12;
  // bits of 6x+2 below the leading one, MSB -> LSB (65-bit constant)
  for (int i = 63; i >= 0; i--) {
    Fq12 l, s;
    fq12_mul(s, f, f);
    line_eval(l, t, t, xp, yp);
    fq12_mul(f, s, l);
    EC12 t2;
    ec12_add(t2, t, t);
    t = t2;
    int bit = (i >= 64) ? (int)((SIX_X_PLUS_2[1] >> (i - 64)) & 1)
                        : (int)((SIX_X_PLUS_2[0] >> i) & 1);
    if (bit) {
      line_eval(l, t, q12, xp, yp);
      fq12_mul(f, f, l);
      ec12_add(t2, t, q12);
      t = t2;
    }
  }
  EC12 q1, q2n;
  ec12_frobenius(q1, q12);
  ec12_frobenius(q2n, q1);
  fq12_neg(q2n.y, q2n.y);
  Fq12 l;
  line_eval(l, t, q1, xp, yp);
  fq12_mul(f, f, l);
  EC12 t2;
  ec12_add(t2, t, q1);
  t = t2;
  line_eval(l, t, q2n, xp, yp);
  fq12_mul(f, f, l);
}

// --- interchange helpers ----------------------------------------------------
// Fq12 <-> 48 plain u64 (12 Fq coeffs in oracle tuple nesting order:
// c0.(c0,c1,c2).(c0,c1) then c1.(...)).

static void fq_to_mont_(Fq &r, const u64 *plain) {
  Fq a, r2;
  memcpy(a.v, plain, 32);
  memcpy(r2.v, R2, 32);
  mont_mul(r, a, r2);
}
static void fq_from_mont_(u64 *plain, const Fq &a) {
  Fq one, r;
  memset(one.v, 0, 32);
  one.v[0] = 1;
  mont_mul(r, a, one);
  memcpy(plain, r.v, 32);
}

static void fq12_load(Fq12 &r, const u64 *in48) {
  Fq *c = &r.c0.c0.c0;
  for (int i = 0; i < 12; i++) fq_to_mont_(c[i], in48 + 4 * i);
}
static void fq12_store(u64 *out48, const Fq12 &a) {
  const Fq *c = &a.c0.c0.c0;
  for (int i = 0; i < 12; i++) fq_from_mont_(out48 + 4 * i, c[i]);
}

extern "C" {

// p_xy: 8 plain u64 (G1 affine); q: 16 plain u64 (x.c0, x.c1, y.c0, y.c1);
// out48: Miller-loop value as 48 plain u64.
void h2a_miller_loop(const u64 *p_xy, int p_inf, const u64 *q, int q_inf,
                     u64 *out48) {
  Fq px, py;
  fq_to_mont_(px, p_xy);
  fq_to_mont_(py, p_xy + 4);
  Fq2 qx, qy;
  fq_to_mont_(qx.c0, q);
  fq_to_mont_(qx.c1, q + 4);
  fq_to_mont_(qy.c0, q + 8);
  fq_to_mont_(qy.c1, q + 12);
  Fq12 f;
  miller_loop_mont(f, px, py, p_inf != 0, qx, qy, q_inf != 0);
  fq12_store(out48, f);
}

void h2a_final_exp(const u64 *in48, u64 *out48) {
  Fq12 f, r;
  fq12_load(f, in48);
  fq12_pow(r, f, FINAL_EXP_E, 44);
  fq12_store(out48, r);
}

// Batch modular square root in Fq via a^((q+1)/4) (q = 3 mod 4).
// vals: n*4 plain canonical u64 (< q); out: n*4 plain u64 (one of the
// two roots; caller picks the sign bit); ok[i] = 1 iff a root exists.
// Serves the transcript replay's point decompression — the Python
// pow() it replaces was 70% of parse_proof time (VERDICT r2 item 4).
void h2a_fq_batch_sqrt(const u64 *vals, size_t n, u64 *out, uint8_t *ok) {
  static const u64 E[4] = {0x4f082305b61f3f52ULL, 0x65e05aa45a1c72a3ULL,
                           0x6e14116da0605617ULL, 0x0c19139cb84c680aULL};
#pragma omp parallel for schedule(static)
  for (size_t i = 0; i < n; i++) {
    Fq a, y2;
    fq_to_mont_(a, vals + 4 * i);
    Fq acc;
    memcpy(acc.v, R1, 32);
    for (int l = 3; l >= 0; --l)
      for (int b = 63; b >= 0; --b) {
        mont_sq(acc, acc);
        if ((E[l] >> b) & 1) mont_mul(acc, acc, a);
      }
    mont_sq(y2, acc);
    ok[i] = (memcmp(y2.v, a.v, 32) == 0) ? 1 : 0;
    Fq one_plain = {{1, 0, 0, 0}};
    mont_mul(acc, acc, one_plain);  // from Montgomery form
    memcpy(out + 4 * i, acc.v, 32);
  }
}

// prod e(P_i, Q_i) == 1?  g1: n*8 plain u64 (+ inf flags); g2: n*16 plain
// u64 (never infinity in our call sites, but a zero y marks it).
int h2a_multi_pairing_check(size_t n, const u64 *g1, const uint8_t *g1_inf,
                            const u64 *g2) {
  Fq12 acc;
  fq12_set_one(acc);
  // Miller loops are independent: one per OpenMP thread
  std::vector<Fq12> fs(n);
#pragma omp parallel for schedule(static)
  for (size_t i = 0; i < n; i++) {
    Fq px, py;
    fq_to_mont_(px, g1 + 8 * i);
    fq_to_mont_(py, g1 + 8 * i + 4);
    Fq2 qx, qy;
    fq_to_mont_(qx.c0, g2 + 16 * i);
    fq_to_mont_(qx.c1, g2 + 16 * i + 4);
    fq_to_mont_(qy.c0, g2 + 16 * i + 8);
    fq_to_mont_(qy.c1, g2 + 16 * i + 12);
    miller_loop_mont(fs[i], px, py, g1_inf[i] != 0, qx, qy, false);
  }
  for (size_t i = 0; i < n; i++) {
    Fq12 t;
    fq12_mul(t, acc, fs[i]);
    acc = t;
  }
  Fq12 r, one;
  fq12_pow(r, acc, FINAL_EXP_E, 44);
  fq12_set_one(one);
  return fq12_eq(r, one) ? 1 : 0;
}

}  // extern "C"
