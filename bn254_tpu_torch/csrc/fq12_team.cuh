// Fq12 ops computed by a team of six threads of one warp, with the
// operands and the partial products in shared memory.
//
// One thread holding a whole Fq12 (96 words) and its temporaries needs
// more registers than the card gives it at any useful occupancy, and the
// single-thread tower functions pass their Fq6/Fq12 arguments through
// the stack (bn254.cuh).  Here a lane's Fq12 lives in shared memory as 6
// Fq2 slots (c0.c0, c0.c1, c0.c2, c1.c0, c1.c1, c1.c2), and thread k of
// the lane's team (k = 0 .. 5) computes a sixth of each op's Fq2 products
// (the product step), then, after the caller's __syncwarp, output
// coefficient k from the exchanged products (the coefficient step).  A
// thread holds at most two Fq2 operands and one product at a time; no
// function takes an Fq6 or Fq12.
//
// The coefficient steps are the same code on every thread of the warp:
// each output coefficient is a signed sum of stored products, with one
// xi applied part way, read from a per-thread table of slot numbers and
// signs, so a warp does not run six different formulas one after the
// other.  Every value is fully reduced after each op, so the outputs are
// the single-thread formulas' (fq12_mul, fq12_cyclotomic_sqr) bit for
// bit: the same products, added in another grouping.  These are the
// building blocks for the other whole-Fq12 kernels (rows 6, 9, 13).
#pragma once

#include "bn254.cuh"

namespace bn254 {

// words of an Fq2 slot in shared memory: 16, padded to 20 so that the
// slots of a team and of neighbouring lanes start on staggered banks
constexpr int kTeamSlot = 20;
// a lane's shared words: res (6 slots), the base (6), products (18)
constexpr int kTeamLaneWords = 30 * kTeamSlot;

// Fq2 slot i of a lane's region s in shared memory (an Fq is 8 words,
// 16-byte aligned)
__device__ __forceinline__ Fq2 ld2_s(const uint32_t* s, int i) {
  return Fq2{fq_load_words(s + kTeamSlot * i), fq_load_words(s + kTeamSlot * i + 8)};
}

__device__ __forceinline__ void st2_s(uint32_t* s, int i, const Fq2& v) {
  fq_store_words(s + kTeamSlot * i, v.c0);
  fq_store_words(s + kTeamSlot * i + 8, v.c1);
}

// ---------------------------------------------------------------------------
// Inlined Fq2 ops.  The product is the lazy-reduction Karatsuba
// (bn254.cuh fq2_mul_lazy_inl: three 512-bit products, two reductions,
// 2.5 products' work), the same canonical value as three CIOS products;
// xi is bn254.cuh fq2_mul_by_xi_inl.
// ---------------------------------------------------------------------------

// a - b if neg else a + b, without a branch: b becomes q - b (in [1, q],
// so a + (q - b) < 2q and one conditional subtraction ends it, also for
// b = 0)
__device__ __forceinline__ void fq_addsub(Fq& r, const Fq& a, const Fq& b, bool neg) {
  const Modulus m = fq_modulus();
  uint32_t nb[8], br = 0;
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    uint64_t x = (uint64_t)m.q[j] - b.v[j] - br;
    nb[j] = (uint32_t)x;
    br = (uint32_t)(x >> 63);
  }
  Fq s;
  uint64_t c = 0;
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    uint64_t x = (uint64_t)a.v[j] + (neg ? nb[j] : b.v[j]) + c;
    s.v[j] = (uint32_t)x;
    c = x >> 32;
  }
  cond_sub(s.v, m);
  r = s;
}

__device__ __forceinline__ void fq2_addsub(Fq2& r, const Fq2& a, const Fq2& b, bool neg) {
  fq_addsub(r.c0, a.c0, b.c0, neg);
  fq_addsub(r.c1, a.c1, b.c1, neg);
}

__device__ __forceinline__ Fq2 fq2_select(bool c, const Fq2& a, const Fq2& b) {
  Fq2 r;
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    r.c0.v[j] = c ? a.c0.v[j] : b.c0.v[j];
    r.c1.v[j] = c ? a.c1.v[j] : b.c1.v[j];
  }
  return r;
}

// ---------------------------------------------------------------------------
// Fq12 product (fq12_mul: Karatsuba over Fq6 of Devegili's Fq6 product):
// 3 Fq6 products m (0: a.c0 b.c0, 1: a.c1 b.c1, 2: (a.c0 + a.c1)(b.c0 +
// b.c1)) of 6 Fq2 products k each (0-2: x_k y_k; 3: (x1 + x2)(y1 + y2);
// 4: (x0 + x1)(y0 + y1); 5: (x0 + x2)(y0 + y2)).  Thread k computes
// product k of each m, and stores S0_k = P0_k, S1_k = P1_k and S2_k =
// P2_k - P0_k - P1_k at slots k, 6 + k, 12 + k.
// ---------------------------------------------------------------------------

// component c (0-2) of Fq6 half m of the Fq12 at s; conj negates the c1
// half on read (conj(a) = a.c0 - a.c1 w)
__device__ __forceinline__ Fq2 team_half(const uint32_t* s, int m, int c, bool conj) {
  Fq2 r;
  if (m != 1) r = ld2_s(s, c);
  if (m != 0) {
    Fq2 hi = ld2_s(s, 3 + c);
    if (conj) fq2_neg(hi, hi);
    if (m == 1) r = hi;
    else fq2_add(r, r, hi);
  }
  return r;
}

// Devegili operand k of Fq6 half m
__device__ __forceinline__ Fq2 team_operand(const uint32_t* s, int m, int k, bool conj) {
  if (k < 3) return team_half(s, m, k, conj);
  Fq2 x = team_half(s, m, k == 3 ? 1 : 0, conj), y = team_half(s, m, k == 4 ? 1 : 2, conj);
  fq2_add(x, x, y);
  return x;
}

// product step: thread k writes slots k, 6 + k, 12 + k of P
__device__ __forceinline__ void team_fq12_mul_products(int k, uint32_t* P, const uint32_t* a,
                                                       const uint32_t* b, bool conj_b) {
#pragma unroll 1
  for (int m = 0; m < 3; ++m)
    st2_s(P, 6 * m + k, fq2_mul_lazy_inl(team_operand(a, m, k, false), team_operand(b, m, k, conj_b)));
  Fq2 s2 = ld2_s(P, 12 + k);
  fq2_sub(s2, s2, ld2_s(P, k));
  fq2_sub(s2, s2, ld2_s(P, 6 + k));
  st2_s(P, 12 + k, s2);
}

// The coefficient tables.  With Dev_0(X) = X0 + xi(X3 - X1 - X2), Dev_1(X)
// = X4 - X0 - X1 + xi(X2), Dev_2(X) = X5 - X0 + X1 - X2 (fq6_mul), the
// product is c0 = Dev(S0) + v Dev(S1) (v (x0, x1, x2) = (xi x2, x0, x1))
// and c1 = Dev(S2).  Coefficient j = xi(sum of its B terms) + sum of its
// A terms; a term is 6 bits, (slot << 1) | negate, packed low first.
#define BN254_T(slot, neg) ((uint64_t)(((slot) << 1) | (neg)))
#define BN254_T2(a, b) ((a) | ((b) << 6))
#define BN254_T4(a, b, c, d) (BN254_T2(a, b) | (BN254_T2(c, d) << 12))

__device__ __forceinline__ void team_mul_terms(int j, uint64_t& tb, int& nb, uint64_t& ta,
                                               int& na) {
  // c0.0 = S0_0 + xi(S0_3 - S0_1 - S0_2 + S1_5 - S1_0 + S1_1 - S1_2)
  const uint64_t b0 = BN254_T4(BN254_T(3, 0), BN254_T(1, 1), BN254_T(2, 1), BN254_T(11, 0)) |
                      (BN254_T2(BN254_T(6, 1), BN254_T(7, 0)) << 24) | (BN254_T(8, 1) << 36);
  const uint64_t a0 = BN254_T(0, 0);
  // c0.1 = S0_4 - S0_0 - S0_1 + S1_0 + xi(S0_2 + S1_3 - S1_1 - S1_2)
  const uint64_t b1 = BN254_T4(BN254_T(2, 0), BN254_T(9, 0), BN254_T(7, 1), BN254_T(8, 1));
  const uint64_t a1 = BN254_T4(BN254_T(4, 0), BN254_T(0, 1), BN254_T(1, 1), BN254_T(6, 0));
  // c0.2 = S0_5 - S0_0 + S0_1 - S0_2 + S1_4 - S1_0 - S1_1 + xi(S1_2)
  const uint64_t b2 = BN254_T(8, 0);
  const uint64_t a2 = BN254_T4(BN254_T(5, 0), BN254_T(0, 1), BN254_T(1, 0), BN254_T(2, 1)) |
                      (BN254_T2(BN254_T(10, 0), BN254_T(6, 1)) << 24) | (BN254_T(7, 1) << 36);
  // c1.i = Dev_i(S2)
  const uint64_t b3 = BN254_T2(BN254_T(15, 0), BN254_T(13, 1)) | (BN254_T(14, 1) << 12);
  const uint64_t a3 = BN254_T(12, 0);
  const uint64_t b4 = BN254_T(14, 0);
  const uint64_t a4 = BN254_T2(BN254_T(16, 0), BN254_T(12, 1)) | (BN254_T(13, 1) << 12);
  const uint64_t a5 = BN254_T4(BN254_T(17, 0), BN254_T(12, 1), BN254_T(13, 0), BN254_T(14, 1));
  tb = j == 0 ? b0 : j == 1 ? b1 : j == 2 ? b2 : j == 3 ? b3 : j == 4 ? b4 : 0;
  nb = j == 0 ? 7 : j == 1 ? 4 : j == 2 ? 1 : j == 3 ? 3 : j == 4 ? 1 : 0;
  ta = j == 0 ? a0 : j == 1 ? a1 : j == 2 ? a2 : j == 3 ? a3 : j == 4 ? a4 : a5;
  na = j == 0 ? 1 : j == 1 ? 4 : j == 2 ? 7 : j == 3 ? 1 : j == 4 ? 3 : 4;
}

#undef BN254_T
#undef BN254_T2
#undef BN254_T4

// coefficient step: output coefficient j of the product
__device__ __forceinline__ Fq2 team_fq12_mul_coeff(const uint32_t* P, int j) {
  uint64_t tb, ta;
  int nb, na;
  team_mul_terms(j, tb, nb, ta, na);
  Fq2 acc;
  acc.c0 = fq_const_zero();
  acc.c1 = fq_const_zero();
#pragma unroll 1
  for (int t = 0; t < nb; ++t, tb >>= 6)
    fq2_addsub(acc, acc, ld2_s(P, (int)(tb >> 1) & 31), tb & 1);
  acc = fq2_mul_by_xi_inl(acc);
#pragma unroll 1
  for (int t = 0; t < na; ++t, ta >>= 6)
    fq2_addsub(acc, acc, ld2_s(P, (int)(ta >> 1) & 31), ta & 1);
  return acc;
}

// ---------------------------------------------------------------------------
// Granger-Scott cyclotomic square (fq12_cyclotomic_sqr): three pairs (u,
// v) = (z0, z1), (z2, z3), (z4, z5), stored at coefficients (0, 4), (3,
// 2), (1, 5).  Thread k computes, for pair p = k % 3, tmp_p = u v (k < 3)
// or (u + v)(xi v + u) (k >= 3) into slot k of P.
// ---------------------------------------------------------------------------

__device__ __forceinline__ void team_cyc_sqr_products(int k, uint32_t* P, const uint32_t* a) {
  const int p = k % 3;
  const int iu = p == 0 ? 0 : (p == 1 ? 3 : 1), iv = p == 0 ? 4 : (p == 1 ? 2 : 5);
  Fq2 x = ld2_s(a, iu), y = ld2_s(a, iv);
  if (k >= 3) {
    Fq2 s;
    fq2_add(s, x, y);
    y = fq2_mul_by_xi_inl(y);
    fq2_add(y, y, x);
    x = s;
  }
  st2_s(P, k, fq2_mul_lazy_inl(x, y));
}

// coefficient step: new coefficient j from the pair products and the old
// coefficient z_j (cyc_tri: 2 (t -/+ z) + t).  Per pair p, ta = (P[3 + p]
// - P[p]) - xi P[p] and tb = 2 P[p]; coefficients 0-2 take ta of pairs
// 0-2 with a minus, 3-5 take tb of pairs 2, 0, 1 with a plus (3: xi tb =
// 2 xi P[2]).  Every thread runs the same ops and selects.
__device__ __forceinline__ Fq2 team_cyc_sqr_coeff(int j, const uint32_t* P, const uint32_t* a) {
  const bool lo = j < 3;
  const Fq2 z = ld2_s(a, j);
  const Fq2 u = ld2_s(P, lo ? j : (j + 2) % 3), w = ld2_s(P, 3 + j % 3);
  const Fq2 xu = fq2_mul_by_xi_inl(u);
  Fq2 s, t, x;
  fq2_add(s, u, xu);
  fq2_sub(s, w, s);                          // ta = w - u - xi u
  x = fq2_select(j == 3, xu, u);
  fq2_add(x, x, x);                          // tb, or xi tb for j = 3
  t = fq2_select(lo, s, x);
  fq2_addsub(x, t, z, lo);
  fq2_add(x, x, x);
  fq2_add(x, x, t);
  return x;
}

}  // namespace bn254
