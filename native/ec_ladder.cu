// Batched BN254 G1 scalar multiplication: one thread per lane, the whole
// 4-bit windowed ladder in one launch.
//
// This is the multiopen fold of the batched verifier (every (point,
// scalar) lane of B proofs; plonk/device_verifier.py:fast_device).  Under
// plain XLA the same ladder is a 254-step lax.scan whose every step is
// dozens of small fusions over int32 limb arrays (ops/curve_ops.py
// scalar_mul).  Here each lane keeps its accumulator and its 16-entry
// window table in registers and local memory, and multiplies with 8
// 32-bit words (CIOS Montgomery, 64-bit products).
//
// Representation, shared with the XLA path: Fq elements in Montgomery
// form with R = 2^256, little-endian; Jacobian (X, Y, Z) with Z == 0 for
// the identity.  The Python wrapper (ops/ec_ladder.py) only regroups the
// XLA path's 32 x 8-bit limbs into 8 x 32-bit words and back.
//
// Every formula mirrors ops/curve_ops.py: jac_double is dbl-2009-l and
// jac_add is the unified add with the same edge cases (either input the
// identity; P == Q takes the doubling; P == -Q yields Z == 0).  Outputs
// are canonical (< p).
//
// Two builds of this one file:
//   * nvcc for sm_90a: the kernel plus its XLA FFI handler H2aEcLadder
//     (ops/ec_ladder.py builds it at first use on the GPU);
//   * g++ as plain C++ (no __CUDACC__): the same arithmetic exported as
//     h2a_ladder_host / h2a_jac_add_host / h2a_fq_mul_host, which the CPU
//     tests check against the Python-int oracle.

#include <cstdint>

#ifdef __CUDACC__
#define H2A_HD __host__ __device__ __forceinline__
#else
#define H2A_HD inline
#endif

// BN254 base field modulus p, R mod p (the Montgomery one) and
// -p^{-1} mod 2^32, as little-endian 32-bit words
#define H2A_P_WORDS                                                       \
  {0xd87cfd47u, 0x3c208c16u, 0x6871ca8du, 0x97816a91u,                    \
   0x8181585du, 0xb85045b6u, 0xe131a029u, 0x30644e72u}
#define H2A_ONE_WORDS                                                     \
  {0xc58f0d9du, 0xd35d438du, 0xf5c70b3du, 0x0a78eb28u,                    \
   0x7879462cu, 0x666ea36fu, 0x9a07df2fu, 0x0e0a77c1u}
#define H2A_PINV 0xe4866389u

namespace h2a {

struct Fq {
  uint32_t v[8];
};

struct Jac {
  Fq x, y, z;
};

// t - p if (hi != 0 or t >= p), else t; t is 8 words plus a top word hi
H2A_HD Fq reduce_once(const uint32_t t[8], uint32_t hi) {
  const uint32_t p[8] = H2A_P_WORDS;
  Fq d;
  uint64_t borrow = 0;
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    uint64_t s = (uint64_t)t[i] - p[i] - borrow;
    d.v[i] = (uint32_t)s;
    borrow = s >> 63;
  }
  const bool take = hi != 0 || borrow == 0;
  Fq r;
#pragma unroll
  for (int i = 0; i < 8; ++i) r.v[i] = take ? d.v[i] : t[i];
  return r;
}

// Montgomery product a * b / 2^256 mod p (CIOS, 32-bit words)
H2A_HD Fq mul(const Fq& a, const Fq& b) {
  const uint32_t p[8] = H2A_P_WORDS;
  uint32_t t[10] = {0, 0, 0, 0, 0, 0, 0, 0, 0, 0};
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    uint64_t c = 0;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      c = (uint64_t)a.v[j] * b.v[i] + t[j] + (c >> 32);
      t[j] = (uint32_t)c;
    }
    c = (uint64_t)t[8] + (c >> 32);
    t[8] = (uint32_t)c;
    t[9] = (uint32_t)(c >> 32);
    const uint32_t m = t[0] * H2A_PINV;
    c = (uint64_t)m * p[0] + t[0];
#pragma unroll
    for (int j = 1; j < 8; ++j) {
      c = (uint64_t)m * p[j] + t[j] + (c >> 32);
      t[j - 1] = (uint32_t)c;
    }
    c = (uint64_t)t[8] + (c >> 32);
    t[7] = (uint32_t)c;
    t[8] = t[9] + (uint32_t)(c >> 32);
  }
  return reduce_once(t, t[8]);
}

H2A_HD Fq add(const Fq& a, const Fq& b) {
  uint32_t t[8];
  uint64_t c = 0;
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    c = (uint64_t)a.v[i] + b.v[i] + (c >> 32);
    t[i] = (uint32_t)c;
  }
  return reduce_once(t, (uint32_t)(c >> 32));
}

H2A_HD Fq sub(const Fq& a, const Fq& b) {
  const uint32_t p[8] = H2A_P_WORDS;
  Fq d;
  uint64_t borrow = 0;
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    uint64_t s = (uint64_t)a.v[i] - b.v[i] - borrow;
    d.v[i] = (uint32_t)s;
    borrow = s >> 63;
  }
  if (borrow) {
    uint64_t c = 0;
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      c = (uint64_t)d.v[i] + p[i] + (c >> 32);
      d.v[i] = (uint32_t)c;
    }
  }
  return d;
}

H2A_HD bool is_zero(const Fq& a) {
  uint32_t acc = 0;
#pragma unroll
  for (int i = 0; i < 8; ++i) acc |= a.v[i];
  return acc == 0;
}

H2A_HD Jac identity() {
  Jac r = {H2A_ONE_WORDS, H2A_ONE_WORDS, {{0, 0, 0, 0, 0, 0, 0, 0}}};
  return r;
}

// dbl-2009-l, as curve_ops.jac_double; Z == 0 stays Z == 0
H2A_HD Jac dbl(const Jac& p) {
  const Fq A = mul(p.x, p.x);
  const Fq B = mul(p.y, p.y);
  const Fq C = mul(B, B);
  const Fq xb = add(p.x, B);
  const Fq t = mul(xb, xb);
  Fq D = sub(sub(t, A), C);
  D = add(D, D);
  const Fq E = add(add(A, A), A);
  const Fq F = mul(E, E);
  Jac r;
  r.x = sub(F, add(D, D));
  Fq C8 = add(C, C);
  C8 = add(C8, C8);
  C8 = add(C8, C8);
  r.y = sub(mul(E, sub(D, r.x)), C8);
  r.z = mul(add(p.y, p.y), p.z);
  return r;
}

// unified add, as curve_ops.jac_add
H2A_HD Jac jadd(const Jac& p, const Jac& q) {
  if (is_zero(q.z)) return p;
  if (is_zero(p.z)) return q;
  const Fq z1z1 = mul(p.z, p.z);
  const Fq z2z2 = mul(q.z, q.z);
  const Fq u1 = mul(p.x, z2z2);
  const Fq u2 = mul(q.x, z1z1);
  const Fq s1 = mul(p.y, mul(q.z, z2z2));
  const Fq s2 = mul(q.y, mul(p.z, z1z1));
  const Fq h = sub(u2, u1);
  const Fq r = sub(s2, s1);
  if (is_zero(h) && is_zero(r)) return dbl(p);
  const Fq h2 = mul(h, h);
  const Fq h3 = mul(h2, h);
  const Fq u1h2 = mul(u1, h2);
  Jac o;
  o.x = sub(sub(mul(r, r), h3), add(u1h2, u1h2));
  o.y = sub(mul(r, sub(u1h2, o.x)), mul(s1, h3));
  o.z = mul(mul(p.z, q.z), h);
  return o;
}

H2A_HD Jac load(const uint32_t* w) {
  Jac p;
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    p.x.v[i] = w[i];
    p.y.v[i] = w[8 + i];
    p.z.v[i] = w[16 + i];
  }
  return p;
}

H2A_HD void store(const Jac& p, uint32_t* w) {
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    w[i] = p.x.v[i];
    w[8 + i] = p.y.v[i];
    w[16 + i] = p.z.v[i];
  }
}

// One lane: pt = 24 words (X, Y, Z), wins[w] = bits [4w, 4w + 4) of the
// scalar, w < n_win.  table[d] = d * P; then MSB window first,
// acc = 16 * acc + table[window].
H2A_HD void ladder_lane(const uint32_t* pt, const uint8_t* wins, int n_win,
                        uint32_t* out) {
  Jac tbl[16];
  tbl[0] = identity();
  tbl[1] = load(pt);
  for (int d = 2; d < 16; ++d)
    tbl[d] = (d & 1) ? jadd(tbl[d - 1], tbl[1]) : dbl(tbl[d >> 1]);
  Jac acc = identity();
  for (int w = n_win - 1; w >= 0; --w) {
    acc = dbl(dbl(dbl(dbl(acc))));
    acc = jadd(acc, tbl[wins[w] & 15]);
  }
  store(acc, out);
}

}  // namespace h2a

#ifdef __CUDACC__

#include "xla/ffi/api/ffi.h"

namespace ffi = xla::ffi;

constexpr int kThreadsPerBlock = 64;

__global__ void h2a_ladder_kernel(const uint32_t* __restrict__ pts,
                                  const uint8_t* __restrict__ wins,
                                  int64_t n, int n_win,
                                  uint32_t* __restrict__ out) {
  const int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  h2a::ladder_lane(pts + 24 * i, wins + (int64_t)n_win * i, n_win,
                   out + 24 * i);
}

// pts (N, 3, 8) u32, wins (N, n_win) u8 -> out (N, 3, 8) u32
static ffi::Error LadderImpl(cudaStream_t stream, ffi::Buffer<ffi::U32> pts,
                             ffi::Buffer<ffi::U8> wins,
                             ffi::ResultBuffer<ffi::U32> out) {
  const auto pd = pts.dimensions();
  const auto wd = wins.dimensions();
  if (pd.size() != 3 || pd[1] != 3 || pd[2] != 8 || wd.size() != 2 ||
      wd[0] != pd[0])
    return ffi::Error::InvalidArgument(
        "h2a_ec_ladder: expected pts (N, 3, 8) u32 and wins (N, n_win) u8");
  const int64_t n = pd[0];
  const int n_win = (int)wd[1];
  if (n == 0) return ffi::Error::Success();
  const int64_t blocks = (n + kThreadsPerBlock - 1) / kThreadsPerBlock;
  h2a_ladder_kernel<<<blocks, kThreadsPerBlock, 0, stream>>>(
      pts.typed_data(), wins.typed_data(), n, n_win, out->typed_data());
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess)
    return ffi::Error::Internal(cudaGetErrorString(err));
  return ffi::Error::Success();
}

XLA_FFI_DEFINE_HANDLER_SYMBOL(H2aEcLadder, LadderImpl,
                              ffi::Ffi::Bind()
                                  .Ctx<ffi::PlatformStream<cudaStream_t>>()
                                  .Arg<ffi::Buffer<ffi::U32>>()
                                  .Arg<ffi::Buffer<ffi::U8>>()
                                  .Ret<ffi::Buffer<ffi::U32>>());

#else  // host build for the CPU tests

extern "C" void h2a_ladder_host(const uint32_t* pts, const uint8_t* wins,
                                int64_t n, int32_t n_win, uint32_t* out) {
  for (int64_t i = 0; i < n; ++i)
    h2a::ladder_lane(pts + 24 * i, wins + (int64_t)n_win * i, n_win,
                     out + 24 * i);
}

extern "C" void h2a_jac_add_host(const uint32_t* p, const uint32_t* q,
                                 int64_t n, uint32_t* out) {
  for (int64_t i = 0; i < n; ++i)
    h2a::store(h2a::jadd(h2a::load(p + 24 * i), h2a::load(q + 24 * i)),
               out + 24 * i);
}

extern "C" void h2a_fq_mul_host(const uint32_t* a, const uint32_t* b,
                                int64_t n, uint32_t* out) {
  for (int64_t i = 0; i < n; ++i) {
    h2a::Fq x, y;
    for (int j = 0; j < 8; ++j) {
      x.v[j] = a[8 * i + j];
      y.v[j] = b[8 * i + j];
    }
    const h2a::Fq r = h2a::mul(x, y);
    for (int j = 0; j < 8; ++j) out[8 * i + j] = r.v[j];
  }
}

#endif
