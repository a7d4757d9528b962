// Device layer of the port's kernels: the BN254 base field in registers
// and the Fq2/Fq6/Fq12 tower over it.
//
// Counterpart of bn254_tpu/pallas_fused.py's in-kernel helpers (KCtx,
// kfq2_*, kfq6_*, kfq12_*), with the same formulas in the same order as
// bn254_tpu/tower.py.  (Its G2 line steps, kg2_*, run as team rounds:
// fused.cu k_g2_precompute.)
//
// Representation.  In memory an Fq value is 16 little-endian 16-bit limbs
// of its Montgomery residue (R = 2^256), one int32 per limb, at address
// (c * 16 + k) * B + lane for coordinate c, limb k: neighbouring threads
// (lanes) read neighbouring words, so every load and store is coalesced.
// In registers it is 8 little-endian 32-bit words; since R = 2^256 either
// split holds the same Montgomery value.
//
// Arithmetic.  Montgomery CIOS over 32-bit words with 64-bit accumulators
// in plain C (each step one 32x32->64 multiply-add); every value is kept
// fully reduced after each op, so the outputs are the JAX package's
// canonical limbs bit for bit.  The lazy-reduction ops, fq2_mul_lazy
// (two reductions of 512-bit products instead of three CIOS products,
// the Fq2 product of fq6_mul and the formulas above it) and fq_sqr (one
// reduction of a 512-bit square), also end canonical; their bounds are
// stated beside them.
//
// Code size.  Fq ops are forced inline; the Fq2 products and everything
// above them are static __noinline__ functions taking references, so each
// tower formula is compiled once per translation unit (static: both .cu
// files include this header and link into one library).  Their arguments
// then live in local memory (L1-cached stack): local-memory traffic from
// these spills, and the 64-bit integer multiplies, are what bound the
// kernels.
#pragma once

#include <cstdint>
#include <cuda_runtime.h>

#include "bn254_consts.h"  // generated at build time from bn254_tpu_torch.spec

namespace bn254 {

struct Fq { uint32_t v[8]; };
struct Fq2 { Fq c0, c1; };
struct Fq6 { Fq2 c0, c1, c2; };
struct Fq12 { Fq6 c0, c1; };
struct Modulus { uint32_t q[8]; uint32_t qinv; };  // qinv = -q^-1 mod 2^32

__device__ __forceinline__ Modulus fq_modulus() {
  return Modulus{{BN254_FQ_Q}, BN254_FQ_QINV};
}

// ---------------------------------------------------------------------------
// Memory layout
// ---------------------------------------------------------------------------

__device__ __forceinline__ int lane_index() {
  return blockIdx.x * blockDim.x + threadIdx.x;
}

__device__ __forceinline__ void load(Fq& r, const int32_t* base, int c, int B, int lane) {
  const int32_t* p = base + (size_t)c * 16 * B + lane;
#pragma unroll
  for (int j = 0; j < 8; ++j)
    r.v[j] = (uint32_t)p[(size_t)(2 * j) * B] | ((uint32_t)p[(size_t)(2 * j + 1) * B] << 16);
}

__device__ __forceinline__ void store(int32_t* base, int c, int B, int lane, const Fq& a) {
  int32_t* p = base + (size_t)c * 16 * B + lane;
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    p[(size_t)(2 * j) * B] = (int32_t)(a.v[j] & 0xFFFFu);
    p[(size_t)(2 * j + 1) * B] = (int32_t)(a.v[j] >> 16);
  }
}

__device__ __forceinline__ void load(Fq2& r, const int32_t* base, int c, int B, int lane) {
  load(r.c0, base, c, B, lane);
  load(r.c1, base, c + 1, B, lane);
}

__device__ __forceinline__ void store(int32_t* base, int c, int B, int lane, const Fq2& a) {
  store(base, c, B, lane, a.c0);
  store(base, c + 1, B, lane, a.c1);
}

__device__ __forceinline__ void load(Fq12& r, const int32_t* base, int B, int lane) {
  load(r.c0.c0, base, 0, B, lane); load(r.c0.c1, base, 2, B, lane);
  load(r.c0.c2, base, 4, B, lane); load(r.c1.c0, base, 6, B, lane);
  load(r.c1.c1, base, 8, B, lane); load(r.c1.c2, base, 10, B, lane);
}

__device__ __forceinline__ void store(int32_t* base, int B, int lane, const Fq12& a) {
  store(base, 0, B, lane, a.c0.c0); store(base, 2, B, lane, a.c0.c1);
  store(base, 4, B, lane, a.c0.c2); store(base, 6, B, lane, a.c1.c0);
  store(base, 8, B, lane, a.c1.c1); store(base, 10, B, lane, a.c1.c2);
}

// An Fq as 8 packed 32-bit words at a 16-byte aligned address: the MSM's
// point-major copy in device memory, the Fq12 team's slots in shared memory
__device__ __forceinline__ Fq fq_load_words(const uint32_t* p) {
  const uint4 a = reinterpret_cast<const uint4*>(p)[0], b = reinterpret_cast<const uint4*>(p)[1];
  return Fq{{a.x, a.y, a.z, a.w, b.x, b.y, b.z, b.w}};
}

__device__ __forceinline__ void fq_store_words(uint32_t* p, const Fq& v) {
  reinterpret_cast<uint4*>(p)[0] = make_uint4(v.v[0], v.v[1], v.v[2], v.v[3]);
  reinterpret_cast<uint4*>(p)[1] = make_uint4(v.v[4], v.v[5], v.v[6], v.v[7]);
}

// ---------------------------------------------------------------------------
// Fq (any modulus < 2^254 for mont_mul; the tower uses Fq's)
// ---------------------------------------------------------------------------

// t - q if t >= q else t
__device__ __forceinline__ void cond_sub(uint32_t t[8], const Modulus& m) {
  uint32_t d[8];
  uint32_t br = 0;
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    uint64_t x = (uint64_t)t[j] - m.q[j] - br;
    d[j] = (uint32_t)x;
    br = (uint32_t)(x >> 63);
  }
#pragma unroll
  for (int j = 0; j < 8; ++j) t[j] = br ? t[j] : d[j];
}

// a * b * 2^-256 mod q (CIOS); inputs reduced, output reduced.
__device__ __forceinline__ void mont_mul(Fq& r, const Fq& a, const Fq& b, const Modulus& m) {
  uint32_t t[10];
#pragma unroll
  for (int j = 0; j < 10; ++j) t[j] = 0;
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    uint64_t c = 0;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      uint64_t s = (uint64_t)a.v[j] * b.v[i] + t[j] + c;
      t[j] = (uint32_t)s;
      c = s >> 32;
    }
    uint64_t s = (uint64_t)t[8] + c;
    t[8] = (uint32_t)s;
    t[9] = (uint32_t)(s >> 32);
    uint32_t mm = t[0] * m.qinv;
    s = (uint64_t)mm * m.q[0] + t[0];
    c = s >> 32;
#pragma unroll
    for (int j = 1; j < 8; ++j) {
      s = (uint64_t)mm * m.q[j] + t[j] + c;
      t[j - 1] = (uint32_t)s;
      c = s >> 32;
    }
    s = (uint64_t)t[8] + c;
    t[7] = (uint32_t)s;
    t[8] = t[9] + (uint32_t)(s >> 32);
  }
  // t < 2q < 2^256 here, so t[8] == 0
  Fq out;
#pragma unroll
  for (int j = 0; j < 8; ++j) out.v[j] = t[j];
  cond_sub(out.v, m);
  r = out;
}

__device__ __forceinline__ void add(Fq& r, const Fq& a, const Fq& b, const Modulus& m) {
  Fq s;
  uint64_t c = 0;
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    uint64_t x = (uint64_t)a.v[j] + b.v[j] + c;
    s.v[j] = (uint32_t)x;
    c = x >> 32;
  }
  cond_sub(s.v, m);  // a + b < 2q < 2^256: no carry out
  r = s;
}

__device__ __forceinline__ void sub(Fq& r, const Fq& a, const Fq& b, const Modulus& m) {
  Fq s;
  uint32_t br = 0;
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    uint64_t x = (uint64_t)a.v[j] - b.v[j] - br;
    s.v[j] = (uint32_t)x;
    br = (uint32_t)(x >> 63);
  }
  uint64_t c = 0;  // a < b: add q back (the 2^256 wrap drops out)
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    uint64_t x = (uint64_t)s.v[j] + (br ? m.q[j] : 0u) + c;
    s.v[j] = (uint32_t)x;
    c = x >> 32;
  }
  r = s;
}

__device__ __forceinline__ void neg(Fq& r, const Fq& a, const Modulus& m) {
  Fq z;
#pragma unroll
  for (int j = 0; j < 8; ++j) z.v[j] = 0;
  sub(r, z, a, m);
}

// Fq ops on the base field
__device__ __forceinline__ void fq_mul(Fq& r, const Fq& a, const Fq& b) { mont_mul(r, a, b, fq_modulus()); }
__device__ __forceinline__ void fq_add(Fq& r, const Fq& a, const Fq& b) { add(r, a, b, fq_modulus()); }
__device__ __forceinline__ void fq_sub(Fq& r, const Fq& a, const Fq& b) { sub(r, a, b, fq_modulus()); }
__device__ __forceinline__ void fq_neg(Fq& r, const Fq& a) { neg(r, a, fq_modulus()); }

__device__ __forceinline__ Fq fq_const_one() { return Fq{{BN254_FQ_ONE}}; }
__device__ __forceinline__ Fq fq_const_zero() { return Fq{{0, 0, 0, 0, 0, 0, 0, 0}}; }

// ---------------------------------------------------------------------------
// Fq2 = Fq[i]/(i^2 + 1)
// ---------------------------------------------------------------------------

__device__ __forceinline__ void fq2_add(Fq2& r, const Fq2& a, const Fq2& b) {
  fq_add(r.c0, a.c0, b.c0); fq_add(r.c1, a.c1, b.c1);
}
__device__ __forceinline__ void fq2_sub(Fq2& r, const Fq2& a, const Fq2& b) {
  fq_sub(r.c0, a.c0, b.c0); fq_sub(r.c1, a.c1, b.c1);
}
__device__ __forceinline__ void fq2_neg(Fq2& r, const Fq2& a) {
  fq_neg(r.c0, a.c0); fq_neg(r.c1, a.c1);
}

// Karatsuba with i^2 = -1 (fq2.rs:133-149): 3 products
static __device__ __noinline__ void fq2_mul(Fq2& r, const Fq2& a, const Fq2& b) {
  Fq aa, bb, sa, sb, cross, c0, c1;
  fq_mul(aa, a.c0, b.c0);
  fq_mul(bb, a.c1, b.c1);
  fq_add(sa, a.c0, a.c1);
  fq_add(sb, b.c0, b.c1);
  fq_mul(cross, sa, sb);
  fq_sub(c0, aa, bb);
  fq_sub(c1, cross, aa);
  fq_sub(c1, c1, bb);
  r.c0 = c0; r.c1 = c1;
}

// complex squaring (fq2.rs:105-117): 2 products
static __device__ __noinline__ void fq2_sqr(Fq2& r, const Fq2& a) {
  Fq ab, s, d, t;
  fq_mul(ab, a.c0, a.c1);
  fq_add(s, a.c0, a.c1);
  fq_sub(d, a.c0, a.c1);
  fq_mul(t, s, d);
  r.c0 = t;
  fq_add(r.c1, ab, ab);
}

// ---------------------------------------------------------------------------
// Lazy-reduction Fq2 product (pallas_fused.py kfq2_mul, the TPU's default
// spelling since _LAZY_FQ2): the three Karatsuba products stay as 512-bit
// integers and each output coefficient takes one Montgomery reduction, 2
// reductions instead of fq2_mul's 3.  The TPU keeps signed 16-bit-limb
// columns; here the values are unsigned 16-word integers, made
// non-negative by their bounds:
//   sa = a0 + a1, sb = b0 + b1 are left unreduced: < 2q < 2^255, 8 words.
//   c1 = sa * sb - a0 b0 - a1 b1 = a0 b1 + a1 b0, in [0, 2q^2).
//   c0 = a0 b0 + q^2 - a1 b1, in (0, 2q^2): the offset q^2 adds q * q,
//        a multiple of q, so the residue is a0 b0 - a1 b1's.
// Both are below q * 2^256 (2q < 2^256), the bound of redc_wide, which
// then returns the canonical residue: the same value as fq2_mul.
// ---------------------------------------------------------------------------

// r = a * b: 8 x 8 words -> 16 words, schoolbook by rows
__device__ __forceinline__ void wide_mul(uint32_t r[16], const uint32_t a[8],
                                         const uint32_t b[8]) {
#pragma unroll
  for (int j = 0; j < 16; ++j) r[j] = 0;
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    uint64_t c = 0;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      uint64_t s = (uint64_t)a[j] * b[i] + r[i + j] + c;
      r[i + j] = (uint32_t)s;
      c = s >> 32;
    }
    r[i + 8] = (uint32_t)c;  // not yet written by an earlier row
  }
}

// r = a + b over 16 words; the callers' bounds leave no carry out
__device__ __forceinline__ void wide_add(uint32_t r[16], const uint32_t a[16],
                                         const uint32_t b[16]) {
  uint64_t c = 0;
#pragma unroll
  for (int j = 0; j < 16; ++j) {
    uint64_t x = (uint64_t)a[j] + b[j] + c;
    r[j] = (uint32_t)x;
    c = x >> 32;
  }
}

// r = a - b over 16 words, for a >= b
__device__ __forceinline__ void wide_sub(uint32_t r[16], const uint32_t a[16],
                                         const uint32_t b[16]) {
  uint32_t br = 0;
#pragma unroll
  for (int j = 0; j < 16; ++j) {
    uint64_t x = (uint64_t)a[j] - b[j] - br;
    r[j] = (uint32_t)x;
    br = (uint32_t)(x >> 63);
  }
}

// T * 2^-256 mod q, canonical, for a 16-word T < q * 2^256 (destroys t).
// Word-by-word Montgomery reduction: each round adds mm * q * 2^(32 i),
// which clears word i; the sum stays below T + q * 2^256 < 2q * 2^256 <
// 2^511, so no carry leaves word 15, and the upper half t[8..15] is the
// reduced value, below 2q: one conditional subtraction ends it.  A round's
// carry out of word i + 8 belongs to word i + 9, where the next round's
// carry lands, so it is added there.
__device__ __forceinline__ void redc_wide(Fq& r, uint32_t t[16], const Modulus& m) {
  uint32_t hi = 0;
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    uint32_t mm = t[i] * m.qinv;
    uint64_t c = 0;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      uint64_t s = (uint64_t)mm * m.q[j] + t[i + j] + c;
      t[i + j] = (uint32_t)s;
      c = s >> 32;
    }
    uint64_t s = (uint64_t)t[i + 8] + c + hi;
    t[i + 8] = (uint32_t)s;
    hi = (uint32_t)(s >> 32);
  }
  Fq out;
#pragma unroll
  for (int j = 0; j < 8; ++j) out.v[j] = t[j + 8];
  cond_sub(out.v, m);
  r = out;
}

// a^2 * 2^-256 mod q, canonical: the 512-bit square from its 36 distinct
// word products (the 28 cross products once, then doubled, then the 8
// squares on the diagonal) where a CIOS product takes 64, then the same
// reduction as the lazy product (a^2 < q^2 < q * 2^256).
__device__ __forceinline__ void fq_sqr(Fq& r, const Fq& a) {
  uint32_t t[16];
#pragma unroll
  for (int j = 0; j < 16; ++j) t[j] = 0;
#pragma unroll
  for (int i = 0; i < 7; ++i) {
    uint64_t c = 0;
#pragma unroll
    for (int j = i + 1; j < 8; ++j) {
      uint64_t s = (uint64_t)a.v[i] * a.v[j] + t[i + j] + c;
      t[i + j] = (uint32_t)s;
      c = s >> 32;
    }
    t[i + 8] = (uint32_t)c;  // not yet written by an earlier row
  }
  // the cross sum is below a^2 / 2 < 2^507: doubling loses no bit
#pragma unroll
  for (int j = 15; j > 0; --j) t[j] = (t[j] << 1) | (t[j - 1] >> 31);
  t[0] <<= 1;
  uint64_t c = 0;
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const uint64_t d = (uint64_t)a.v[i] * a.v[i];
    uint64_t s = (uint64_t)t[2 * i] + (uint32_t)d + c;
    t[2 * i] = (uint32_t)s;
    s = (uint64_t)t[2 * i + 1] + (uint32_t)(d >> 32) + (s >> 32);
    t[2 * i + 1] = (uint32_t)s;
    c = s >> 32;
  }
  redc_wide(r, t, fq_modulus());
}

__device__ __forceinline__ Fq2 fq2_mul_lazy_inl(const Fq2& a, const Fq2& b) {
  const Modulus m = fq_modulus();
  const uint32_t q_squared[16] = {BN254_FQ_Q_SQUARED};
  uint32_t sa[8], sb[8], m00[16], m11[16], cross[16], t[16];
  uint64_t ca = 0, cb = 0;
#pragma unroll
  for (int j = 0; j < 8; ++j) {  // < 2q < 2^255: no carry out
    uint64_t x = (uint64_t)a.c0.v[j] + a.c1.v[j] + ca;
    uint64_t y = (uint64_t)b.c0.v[j] + b.c1.v[j] + cb;
    sa[j] = (uint32_t)x;
    sb[j] = (uint32_t)y;
    ca = x >> 32;
    cb = y >> 32;
  }
  wide_mul(m00, a.c0.v, b.c0.v);
  wide_mul(m11, a.c1.v, b.c1.v);
  wide_mul(cross, sa, sb);
  wide_sub(cross, cross, m00);
  wide_sub(cross, cross, m11);  // a0 b1 + a1 b0
  wide_add(t, m00, q_squared);
  wide_sub(t, t, m11);          // a0 b0 - a1 b1 + q^2
  Fq2 r;
  redc_wide(r.c0, t, m);
  redc_wide(r.c1, cross, m);
  return r;
}

static __device__ __noinline__ void fq2_mul_lazy(Fq2& r, const Fq2& a, const Fq2& b) {
  r = fq2_mul_lazy_inl(a, b);
}

// ---------------------------------------------------------------------------
// The coordinate field's ops, overloaded on Fq and Fq2, for the code that
// is generic on its field (fq_pow_chain below, the group law of
// groups.cuh).  The products take the card's fastest spelling of each: an
// Fq square is fq_sqr (36 word products where a CIOS product takes 64), a
// general Fq2 product the lazy one (three 512-bit products, two
// reductions).  Both end fully reduced, so no limb changes.
// ---------------------------------------------------------------------------

__device__ __forceinline__ void f_add(Fq& r, const Fq& a, const Fq& b) { fq_add(r, a, b); }
__device__ __forceinline__ void f_sub(Fq& r, const Fq& a, const Fq& b) { fq_sub(r, a, b); }
__device__ __forceinline__ void f_neg(Fq& r, const Fq& a) { fq_neg(r, a); }
__device__ __forceinline__ void f_mul(Fq& r, const Fq& a, const Fq& b) { fq_mul(r, a, b); }
__device__ __forceinline__ void f_sqr(Fq& r, const Fq& a) { fq_sqr(r, a); }
__device__ __forceinline__ void f_set_zero(Fq& r) { r = fq_const_zero(); }
__device__ __forceinline__ void f_set_one(Fq& r) { r = fq_const_one(); }

__device__ __forceinline__ bool f_is_zero(const Fq& a) {
  uint32_t o = 0;
#pragma unroll
  for (int j = 0; j < 8; ++j) o |= a.v[j];
  return o == 0;
}

__device__ __forceinline__ bool f_eq(const Fq& a, const Fq& b) {
  uint32_t o = 0;
#pragma unroll
  for (int j = 0; j < 8; ++j) o |= a.v[j] ^ b.v[j];
  return o == 0;
}

__device__ __forceinline__ void f_add(Fq2& r, const Fq2& a, const Fq2& b) { fq2_add(r, a, b); }
__device__ __forceinline__ void f_sub(Fq2& r, const Fq2& a, const Fq2& b) { fq2_sub(r, a, b); }
__device__ __forceinline__ void f_neg(Fq2& r, const Fq2& a) { fq2_neg(r, a); }
__device__ __forceinline__ void f_mul(Fq2& r, const Fq2& a, const Fq2& b) {
  fq2_mul_lazy(r, a, b);
}
__device__ __forceinline__ void f_sqr(Fq2& r, const Fq2& a) { fq2_sqr(r, a); }
__device__ __forceinline__ void f_set_zero(Fq2& r) { r.c0 = fq_const_zero(); r.c1 = fq_const_zero(); }
__device__ __forceinline__ void f_set_one(Fq2& r) { r.c0 = fq_const_one(); r.c1 = fq_const_zero(); }
__device__ __forceinline__ bool f_is_zero(const Fq2& a) { return f_is_zero(a.c0) && f_is_zero(a.c1); }
__device__ __forceinline__ bool f_eq(const Fq2& a, const Fq2& b) {
  return f_eq(a.c0, b.c0) && f_eq(a.c1, b.c1);
}

// a^e over fused.py's pow_digits(e), the same digits for every lane, in Fq
// or Fq2: a table of the odd powers a, a^3, ..., a^15 (one square, seven
// products), res = a^d[0], then per further digit a square and, where
// d != 0 (odd), a product by a^d.  A window of 4 bits: about 51 products
// for a 254-bit exponent where the binary ladder takes one a set bit (109
// for q - 2).  The table is indexed by the digit, so it lives in local
// memory: 256 bytes a thread in Fq, 512 in Fq2.
struct PowDigits { const int32_t* d; int n; };
constexpr int kPowTable = 8;

template <class F>
static __device__ __noinline__ void fq_pow_chain(F& r, const F& a, PowDigits e) {
  F table[kPowTable], a2;
  table[0] = a;
  f_sqr(a2, a);
#pragma unroll 1
  for (int i = 1; i < kPowTable; ++i) f_mul(table[i], table[i - 1], a2);
  F res = table[e.d[0] >> 1];
#pragma unroll 1
  for (int i = 1; i < e.n; ++i) {
    f_sqr(res, res);
    const int d = e.d[i];
    if (d) f_mul(res, res, table[d >> 1]);
  }
  r = res;
}

// scale by an Fq element (fq2.rs:48)
static __device__ __noinline__ void fq2_scale(Fq2& r, const Fq2& a, const Fq& k) {
  Fq c0, c1;
  fq_mul(c0, a.c0, k);
  fq_mul(c1, a.c1, k);
  r.c0 = c0; r.c1 = c1;
}

// a * (9 + i) = (9 a0 - a1, 9 a1 + a0), 9x = 8x + x
__device__ __forceinline__ Fq2 fq2_mul_by_xi_inl(const Fq2& a) {
  Fq2 d, r;
  fq2_add(d, a, a);
  fq2_add(d, d, d);
  fq2_add(d, d, d);
  fq2_add(d, d, a);
  fq_sub(r.c0, d.c0, a.c1);
  fq_add(r.c1, d.c1, a.c0);
  return r;
}

static __device__ __noinline__ void fq2_mul_by_xi(Fq2& r, const Fq2& a) {
  r = fq2_mul_by_xi_inl(a);
}

// norm inversion (fq2.rs:119-130): (a0 t, -a1 t), t = (a0^2 + a1^2)^(q-2)
// on the pow chain with inv = pow_digits(q - 2); 0 -> 0 without a branch
static __device__ __noinline__ void fq2_inv(Fq2& r, const Fq2& a, PowDigits inv) {
  Fq s0, s1, t, c1;
  fq_sqr(s0, a.c0);
  fq_sqr(s1, a.c1);
  fq_add(t, s0, s1);
  fq_pow_chain(t, t, inv);
  fq_mul(r.c0, a.c0, t);
  fq_mul(c1, a.c1, t);
  fq_neg(r.c1, c1);
}

// ---------------------------------------------------------------------------
// Fq6 = Fq2[v]/(v^3 - xi)
// ---------------------------------------------------------------------------

static __device__ __noinline__ void fq6_add(Fq6& r, const Fq6& a, const Fq6& b) {
  fq2_add(r.c0, a.c0, b.c0); fq2_add(r.c1, a.c1, b.c1); fq2_add(r.c2, a.c2, b.c2);
}
static __device__ __noinline__ void fq6_sub(Fq6& r, const Fq6& a, const Fq6& b) {
  fq2_sub(r.c0, a.c0, b.c0); fq2_sub(r.c1, a.c1, b.c1); fq2_sub(r.c2, a.c2, b.c2);
}

// v * (c0 + c1 v + c2 v^2) = xi c2 + c0 v + c1 v^2 (fq6.rs:109-115)
static __device__ __noinline__ void fq6_mul_by_nonresidue(Fq6& r, const Fq6& a) {
  Fq2 c0;
  fq2_mul_by_xi(c0, a.c2);
  Fq2 c1 = a.c0, c2 = a.c1;
  r.c0 = c0; r.c1 = c1; r.c2 = c2;
}

// Devegili et al. interpolation (fq6.rs:194-208): 6 lazy Fq2 products
static __device__ __noinline__ void fq6_mul(Fq6& r, const Fq6& a, const Fq6& b) {
  Fq2 a_a, b_b, c_c, s, t, u, c0, c1, c2;
  fq2_mul_lazy(a_a, a.c0, b.c0);
  fq2_mul_lazy(b_b, a.c1, b.c1);
  fq2_mul_lazy(c_c, a.c2, b.c2);

  fq2_add(s, a.c1, a.c2);
  fq2_add(t, b.c1, b.c2);
  fq2_mul_lazy(u, s, t);
  fq2_sub(u, u, b_b);
  fq2_sub(u, u, c_c);
  fq2_mul_by_xi(u, u);
  fq2_add(c0, u, a_a);

  fq2_add(s, a.c0, a.c1);
  fq2_add(t, b.c0, b.c1);
  fq2_mul_lazy(u, s, t);
  fq2_sub(u, u, a_a);
  fq2_sub(u, u, b_b);
  fq2_mul_by_xi(s, c_c);
  fq2_add(c1, u, s);

  fq2_add(s, a.c0, a.c2);
  fq2_add(t, b.c0, b.c2);
  fq2_mul_lazy(u, s, t);
  fq2_sub(u, u, a_a);
  fq2_add(u, u, b_b);
  fq2_sub(c2, u, c_c);
  r.c0 = c0; r.c1 = c1; r.c2 = c2;
}

// CH-SQR2 squaring (fq6.rs:163-177): 3 Fq2 squares, 2 lazy products
static __device__ __noinline__ void fq6_sqr(Fq6& r, const Fq6& a) {
  Fq2 s0, s1, s2, s3, s4, t, c0, c1, c2;
  fq2_sqr(s0, a.c0);
  fq2_mul_lazy(s1, a.c0, a.c1);
  fq2_add(s1, s1, s1);
  fq2_sub(t, a.c0, a.c1);
  fq2_add(t, t, a.c2);
  fq2_sqr(s2, t);
  fq2_mul_lazy(s3, a.c1, a.c2);
  fq2_add(s3, s3, s3);
  fq2_sqr(s4, a.c2);
  fq2_mul_by_xi(t, s3);
  fq2_add(c0, s0, t);
  fq2_mul_by_xi(t, s4);
  fq2_add(c1, s1, t);
  fq2_add(c2, s1, s2);
  fq2_add(c2, c2, s3);
  fq2_sub(c2, c2, s0);
  fq2_sub(c2, c2, s4);
  r.c0 = c0; r.c1 = c1; r.c2 = c2;
}

// (fq6.rs:179-192): 3 Fq2 squares, 9 lazy products and the norm's
// fq2_inv; 0 -> 0 without a branch
static __device__ __noinline__ void fq6_inv(Fq6& r, const Fq6& a, PowDigits inv) {
  Fq2 c0, c1, c2, t, u;
  fq2_sqr(c0, a.c0);
  fq2_mul_by_xi(t, a.c2);
  fq2_mul_lazy(t, a.c1, t);
  fq2_sub(c0, c0, t);
  fq2_sqr(c1, a.c2);
  fq2_mul_by_xi(c1, c1);
  fq2_mul_lazy(t, a.c0, a.c1);
  fq2_sub(c1, c1, t);
  fq2_sqr(c2, a.c1);
  fq2_mul_lazy(t, a.c0, a.c2);
  fq2_sub(c2, c2, t);
  fq2_mul_lazy(t, a.c2, c1);
  fq2_mul_lazy(u, a.c1, c2);
  fq2_add(t, t, u);
  fq2_mul_by_xi(t, t);
  fq2_mul_lazy(u, a.c0, c0);
  fq2_add(t, t, u);
  fq2_inv(t, t, inv);
  fq2_mul_lazy(r.c0, t, c0);
  fq2_mul_lazy(r.c1, t, c1);
  fq2_mul_lazy(r.c2, t, c2);
}

// ---------------------------------------------------------------------------
// Fq12 = Fq6[w]/(w^2 - v): the final exponentiation's inverse (its products
// and squares run on the six-thread team, fq12_team.cuh)
// ---------------------------------------------------------------------------

// (fq12.rs:305-313): 2 Fq6 squares, the Fq6 inverse, 2 Fq6 products;
// 0 -> 0 without a branch
static __device__ __noinline__ void fq12_inv(Fq12& r, const Fq12& a, PowDigits inv) {
  Fq6 s0, s1, t, c0, c1;
  fq6_sqr(s0, a.c0);
  fq6_sqr(s1, a.c1);
  fq6_mul_by_nonresidue(s1, s1);
  fq6_sub(t, s0, s1);
  fq6_inv(t, t, inv);
  fq6_mul(c0, a.c0, t);
  fq6_mul(c1, a.c1, t);
  fq2_neg(c1.c0, c1.c0);
  fq2_neg(c1.c1, c1.c1);
  fq2_neg(c1.c2, c1.c2);
  r.c0 = c0; r.c1 = c1;
}

}  // namespace bn254

// Launch geometry shared by every kernel: one thread per batch lane,
// 128-thread blocks, the ragged edge masked inside the kernel.  A C entry
// launches on the caller's stream (B and stream are its last parameters)
// and returns cudaGetLastError().
#define BN254_THREADS 128
#define BN254_LAUNCH(kernel, ...)                                                        \
  kernel<<<((B) + BN254_THREADS - 1) / BN254_THREADS, BN254_THREADS, 0, stream>>>(      \
      __VA_ARGS__, B);                                                                   \
  return static_cast<int>(cudaGetLastError())
