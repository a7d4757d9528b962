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
// the plain versions' (fused._mul12, _cyc_sqr, _sqr12), the plain G2 line
// steps' (fused._dbl_step, _add_step) and the plain 024 fold's bit for
// bit: the same field values, added in another grouping.
//
// The team steps here and their users:
//   team_fq12_mul_products / _coeff   Fq12 product: row 9 (k_fq12_mul),
//                                     row 11's nonzero digits
//   team_cyc_sqr_products / _coeff    Granger-Scott square: row 11
//                                     (k_fq12_cyc_pow)
//   team_round over a TeamRound table the Miller steps of row 6
//                                     (k_miller_precompute): the Fq12
//                                     square, the 024 fold, the G2
//                                     doubling and mixed addition steps,
//                                     scheduled by team_schedule.py; and,
//                                     on Fq or Fq2 slots with a team of
//                                     four, the GLV ladder's double and
//                                     add (row 20, groups.cu
//                                     k_glv_ladder; ladder_schedule.py);
//                                     the square and fold rounds over a
//                                     slot map of their own, the
//                                     prepared Miller loop and rows 13
//                                     and 8 (fused.cu k_miller_loop;
//                                     loop_schedule.py); with a team of
//                                     four, the G2 doubling and addition
//                                     products alone, the prepared-G2
//                                     lines and rows 14 and 7 (fused.cu
//                                     k_g2_precompute;
//                                     precompute_schedule.py)
#pragma once

#include "bn254.cuh"

namespace bn254 {

// words of a slot in shared memory: an Fq2 is 16, padded to 20, an Fq 8,
// padded to 12, so that the slots of a team and of neighbouring lanes
// start on staggered banks
template <class F> constexpr int kSlotWords = 20;
template <> constexpr int kSlotWords<Fq> = 12;
constexpr int kTeamSlot = kSlotWords<Fq2>;
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

// Team geometry: thread k of team t of warp v holds lane (32 / T) v + t of
// the block (a team of T threads, 32 / T teams a warp: six threads five
// lanes, threads 30 and 31 idle); the threads past the warp's last team,
// and teams past B, are inactive and only keep the warp's barriers and
// shuffles.
constexpr int kTeam = 6, kTeamsPerWarp = 32 / kTeam;

struct TeamThread {
  int k, slot, lane;
  bool active;
};

template <int T = kTeam>
__device__ __forceinline__ TeamThread team_thread(int lanes_per_block, int B) {
  constexpr int per_warp = 32 / T;
  const int warp = threadIdx.x / 32, team = (threadIdx.x % 32) / T;
  TeamThread t;
  t.k = threadIdx.x % 32 - team * T;
  t.slot = warp * per_warp + team;
  t.lane = blockIdx.x * lanes_per_block + t.slot;
  t.active = team < per_warp && t.lane < B;
  return t;
}

// ---------------------------------------------------------------------------
// Field adds on the carry flag.  A PTX add.cc / addc chain carries from word
// to word in one instruction a word, where bn254.cuh's 64-bit C adds take
// about three; the team's coefficient steps and operand sums are mostly
// these adds.  The host build of the sources (no PTX) takes bn254.cuh's.
// ---------------------------------------------------------------------------

#ifdef __CUDA_ARCH__
#define BN254_OUT8(x) "=r"((x)[0]), "=r"((x)[1]), "=r"((x)[2]), "=r"((x)[3]), \
                      "=r"((x)[4]), "=r"((x)[5]), "=r"((x)[6]), "=r"((x)[7])
#define BN254_IN8(x) "r"((x)[0]), "r"((x)[1]), "r"((x)[2]), "r"((x)[3]), \
                     "r"((x)[4]), "r"((x)[5]), "r"((x)[6]), "r"((x)[7])

// s = a + b mod 2^256
__device__ __forceinline__ void add8(uint32_t s[8], const uint32_t a[8], const uint32_t b[8]) {
  asm("add.cc.u32 %0, %8, %16;\n\t"
      "addc.cc.u32 %1, %9, %17;\n\t"
      "addc.cc.u32 %2, %10, %18;\n\t"
      "addc.cc.u32 %3, %11, %19;\n\t"
      "addc.cc.u32 %4, %12, %20;\n\t"
      "addc.cc.u32 %5, %13, %21;\n\t"
      "addc.cc.u32 %6, %14, %22;\n\t"
      "addc.u32 %7, %15, %23;"
      : BN254_OUT8(s) : BN254_IN8(a), BN254_IN8(b));
}

// d = a - b mod 2^256; returns 0xFFFFFFFF if a < b, else 0
__device__ __forceinline__ uint32_t sub8(uint32_t d[8], const uint32_t a[8], const uint32_t b[8]) {
  uint32_t m;
  asm("sub.cc.u32 %0, %9, %17;\n\t"
      "subc.cc.u32 %1, %10, %18;\n\t"
      "subc.cc.u32 %2, %11, %19;\n\t"
      "subc.cc.u32 %3, %12, %20;\n\t"
      "subc.cc.u32 %4, %13, %21;\n\t"
      "subc.cc.u32 %5, %14, %22;\n\t"
      "subc.cc.u32 %6, %15, %23;\n\t"
      "subc.cc.u32 %7, %16, %24;\n\t"
      "subc.u32 %8, 0, 0;"
      : BN254_OUT8(d), "=r"(m) : BN254_IN8(a), BN254_IN8(b));
  return m;
}

// r = a + b + cin over 8 words (cin 0 or 1); returns the carry out
__device__ __forceinline__ uint32_t add8c(uint32_t r[8], const uint32_t a[8], const uint32_t b[8],
                                          uint32_t cin) {
  uint32_t c, unused;
  asm("add.cc.u32 %9, %26, 0xffffffff;\n\t"     // carry flag = cin
      "addc.cc.u32 %0, %10, %18;\n\t"
      "addc.cc.u32 %1, %11, %19;\n\t"
      "addc.cc.u32 %2, %12, %20;\n\t"
      "addc.cc.u32 %3, %13, %21;\n\t"
      "addc.cc.u32 %4, %14, %22;\n\t"
      "addc.cc.u32 %5, %15, %23;\n\t"
      "addc.cc.u32 %6, %16, %24;\n\t"
      "addc.cc.u32 %7, %17, %25;\n\t"
      "addc.u32 %8, 0, 0;"
      : BN254_OUT8(r), "=r"(c), "=r"(unused) : BN254_IN8(a), BN254_IN8(b), "r"(cin));
  return c;
}

// r = a - b - bin over 8 words (bin 0 or 1); returns the borrow out
__device__ __forceinline__ uint32_t sub8b(uint32_t r[8], const uint32_t a[8], const uint32_t b[8],
                                          uint32_t bin) {
  uint32_t m, unused;
  asm("sub.cc.u32 %9, 0, %26;\n\t"              // borrow flag = bin
      "subc.cc.u32 %0, %10, %18;\n\t"
      "subc.cc.u32 %1, %11, %19;\n\t"
      "subc.cc.u32 %2, %12, %20;\n\t"
      "subc.cc.u32 %3, %13, %21;\n\t"
      "subc.cc.u32 %4, %14, %22;\n\t"
      "subc.cc.u32 %5, %15, %23;\n\t"
      "subc.cc.u32 %6, %16, %24;\n\t"
      "subc.cc.u32 %7, %17, %25;\n\t"
      "subc.u32 %8, 0, 0;"
      : BN254_OUT8(r), "=r"(m), "=r"(unused) : BN254_IN8(a), BN254_IN8(b), "r"(bin));
  return m & 1;
}
#undef BN254_OUT8
#undef BN254_IN8
#endif

// a + b mod q for reduced a, b: a + b < 2q < 2^256, then one subtraction
__device__ __forceinline__ Fq tfq_add(const Fq& a, const Fq& b) {
  Fq r;
#ifdef __CUDA_ARCH__
  const Modulus md = fq_modulus();
  Fq s;
  add8(s.v, a.v, b.v);
  const uint32_t m = sub8(r.v, s.v, md.q);
#pragma unroll
  for (int j = 0; j < 8; ++j) r.v[j] = m ? s.v[j] : r.v[j];
#else
  fq_add(r, a, b);
#endif
  return r;
}

// a - b mod q for reduced a, b: on a borrow add q back (the 2^256 wraps)
__device__ __forceinline__ Fq tfq_sub(const Fq& a, const Fq& b) {
  Fq r;
#ifdef __CUDA_ARCH__
  const Modulus md = fq_modulus();
  uint32_t d[8], qm[8];
  const uint32_t m = sub8(d, a.v, b.v);
#pragma unroll
  for (int j = 0; j < 8; ++j) qm[j] = md.q[j] & m;
  add8(r.v, d, qm);
#else
  fq_sub(r, a, b);
#endif
  return r;
}

__device__ __forceinline__ Fq2 tfq2_add(const Fq2& a, const Fq2& b) {
  return Fq2{tfq_add(a.c0, b.c0), tfq_add(a.c1, b.c1)};
}

__device__ __forceinline__ Fq2 tfq2_sub(const Fq2& a, const Fq2& b) {
  return Fq2{tfq_sub(a.c0, b.c0), tfq_sub(a.c1, b.c1)};
}

// a * (9 + i) = (9 a0 - a1, 9 a1 + a0), 9x = 8x + x (fq2_mul_by_xi_inl's steps)
__device__ __forceinline__ Fq2 team_xi(const Fq2& a) {
  Fq2 d = tfq2_add(a, a);
  d = tfq2_add(d, d);
  d = tfq2_add(d, d);
  d = tfq2_add(d, a);
  return Fq2{tfq_sub(d.c0, a.c1), tfq_add(d.c1, a.c0)};
}

// ---------------------------------------------------------------------------
// Inlined Fq2 ops.  The product is the lazy-reduction Karatsuba of
// bn254.cuh fq2_mul_lazy_inl (three 512-bit products, two reductions, 2.5
// products' work; its bounds are stated there), the same canonical value
// as three CIOS products, with its wide sums and differences and the
// reductions' last subtraction on the carry flag.
// ---------------------------------------------------------------------------

#ifdef __CUDA_ARCH__
// fq2_mul_lazy_inl's redc_wide with the carry-flag subtraction
__device__ __forceinline__ Fq team_redc(uint32_t t[16], const Modulus& m) {
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
  Fq r;
  const uint32_t bw = sub8b(r.v, t + 8, m.q, 0);
#pragma unroll
  for (int j = 0; j < 8; ++j) r.v[j] = bw ? t[j + 8] : r.v[j];
  return r;
}
#else
__device__ __forceinline__ Fq team_redc(uint32_t t[16], const Modulus& m) {
  Fq r;
  redc_wide(r, t, m);
  return r;
}
#endif

__device__ __forceinline__ Fq2 team_fq2_mul(const Fq2& a, const Fq2& b) {
#ifdef __CUDA_ARCH__
  const Modulus md = fq_modulus();
  const uint32_t q_squared[16] = {BN254_FQ_Q_SQUARED};
  uint32_t sa[8], sb[8], m00[16], m11[16], cross[16], t[16];
  add8c(sa, a.c0.v, a.c1.v, 0);                 // < 2q < 2^255
  add8c(sb, b.c0.v, b.c1.v, 0);
  wide_mul(m00, a.c0.v, b.c0.v);
  wide_mul(m11, a.c1.v, b.c1.v);
  wide_mul(cross, sa, sb);
  sub8b(cross + 8, cross + 8, m00 + 8, sub8b(cross, cross, m00, 0));
  sub8b(cross + 8, cross + 8, m11 + 8, sub8b(cross, cross, m11, 0));   // a0 b1 + a1 b0
  add8c(t + 8, m00 + 8, q_squared + 8, add8c(t, m00, q_squared, 0));
  sub8b(t + 8, t + 8, m11 + 8, sub8b(t, t, m11, 0));                   // a0 b0 - a1 b1 + q^2
  return Fq2{team_redc(t, md), team_redc(cross, md)};
#else
  return fq2_mul_lazy_inl(a, b);
#endif
}

// ---------------------------------------------------------------------------
// The lazy Fq2 product and the Fq2 square on a team of three threads a
// lane (ten lanes a warp, threads 30 and 31 idle).  Every thread of the
// team holds the operands; thread k makes one 512-bit product with the
// inlined wide_mul (the product: a0 b0, a1 b1, (a0 + a1)(b0 + b1); the
// square: (a0 + a1)(a0 - a1) on threads 0 and 2, a0 a1 on thread 1, the
// sums left unreduced, below 2q); the product's team exchanges them by
// warp shuffles, and threads 0 and 1 reduce output coefficient 0 and 1
// (team_redc) on fq2_mul_lazy_inl's t = a0 b0 + q^2 - a1 b1 and cross =
// a0 b1 + a1 b0, or on the square's (a0 + a1)(a0 - a1) and 2 a0 a1 (thread
// 2 reduces a value no one reads).  team3_gather then hands both
// coefficients to every thread of the team.  The operands come from
// selects on k, so the three threads run one code.  A product's serial
// depth is one 512-bit product, two shuffle rounds and one reduction,
// where one thread runs three products and two reductions; the square's
// one product and one reduction, where one thread runs two CIOS products.
// Every value ends fully reduced: the same limbs as fq2_mul_lazy_inl and
// the complex square.  Every thread of the warp calls these (the
// shuffles take the whole warp); base is the warp lane of the team's
// thread 0.  Users: the probe's Fq2 chains (probes.cu k_chain_fq2) and
// row 15 (fused.cu k_fq2_mul_fused); team3_fq2_sqr_coeff also row 16's
// pair of threads (fused.cu k_fq2_sqr_fused, k < 2 only).
// ---------------------------------------------------------------------------

constexpr int kTeam3 = 3, kTeam3Warps = 4, kTeam3Lanes = 32 / kTeam3 * kTeam3Warps;   // a block

// r = the N words v of warp lane src
template <int N>
__device__ __forceinline__ void shfl_words(uint32_t (&r)[N], const uint32_t* v, int src) {
#pragma unroll
  for (int j = 0; j < N; ++j) r[j] = __shfl_sync(0xFFFFFFFFu, v[j], src);
}

// r = x + y if add, else x, over 8 words (the callers' bounds leave no carry out)
__device__ __forceinline__ void add8_if(uint32_t r[8], const uint32_t x[8], const uint32_t y[8],
                                        bool add) {
  const uint32_t m = add ? 0xFFFFFFFFu : 0u;
  uint32_t z[8];
#pragma unroll
  for (int j = 0; j < 8; ++j) z[j] = y[j] & m;
#ifdef __CUDA_ARCH__
  add8c(r, x, z, 0);
#else
  uint64_t c = 0;
  for (int j = 0; j < 8; ++j) {
    const uint64_t s = (uint64_t)x[j] + z[j] + c;
    r[j] = (uint32_t)s;
    c = s >> 32;
  }
#endif
}

// r = a + b, r = a - b over 16 words (no carry out, a >= b: the callers' bounds)
__device__ __forceinline__ void add16(uint32_t r[16], const uint32_t a[16], const uint32_t b[16]) {
#ifdef __CUDA_ARCH__
  add8c(r + 8, a + 8, b + 8, add8c(r, a, b, 0));
#else
  wide_add(r, a, b);
#endif
}

__device__ __forceinline__ void sub16(uint32_t r[16], const uint32_t a[16], const uint32_t b[16]) {
#ifdef __CUDA_ARCH__
  sub8b(r + 8, a + 8, b + 8, sub8b(r, a, b, 0));
#else
  wide_sub(r, a, b);
#endif
}

// coefficient k (k < 2) of a b on thread k of the team
__device__ __forceinline__ Fq team3_fq2_mul_coeff(int k, int base, const Fq2& a, const Fq2& b) {
  const uint32_t q_squared[16] = {BN254_FQ_Q_SQUARED};
  const bool one = k == 1;
  uint32_t x[8], y[8], p[16], r[16], s[16], t[16], u[16];
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    x[j] = one ? a.c1.v[j] : a.c0.v[j];
    y[j] = one ? b.c1.v[j] : b.c0.v[j];
  }
  add8_if(x, x, a.c1.v, k == 2);
  add8_if(y, y, b.c1.v, k == 2);
  wide_mul(p, x, y);                     // m00, m11, m22 on threads 0, 1, 2
  shfl_words(r, p, base + (k == 0));     // thread 0: m11; threads 1 and 2: m00
  shfl_words(s, p, base + 2);            // m22
  // thread 1: m22 - m00 - m11; threads 0 and 2: m00 + q^2 - m11
#pragma unroll
  for (int j = 0; j < 16; ++j) {
    t[j] = one ? s[j] : p[j];
    u[j] = one ? 0u : q_squared[j];
  }
  add16(t, t, u);
  sub16(t, t, r);
#pragma unroll
  for (int j = 0; j < 16; ++j) u[j] = one ? p[j] : 0u;
  sub16(t, t, u);
  return team_redc(t, fq_modulus());
}

// coefficient k (k < 2) of a^2 on thread k of the team (fq2.rs:105-117)
__device__ __forceinline__ Fq team3_fq2_sqr_coeff(int k, const Fq2& a) {
  const bool one = k == 1;
  const Fq d = tfq_sub(a.c0, a.c1);
  uint32_t x[8], y[8], p[16];
  add8_if(x, a.c0.v, a.c1.v, !one);
#pragma unroll
  for (int j = 0; j < 8; ++j) y[j] = one ? a.c1.v[j] : d.v[j];
  wide_mul(p, x, y);
  const uint32_t sh = one;               // 2 a0 a1 < 2q^2: doubling loses no bit
#pragma unroll
  for (int j = 15; j > 0; --j) p[j] = (p[j] << sh) | ((p[j - 1] >> 31) & sh);
  p[0] <<= sh;
  return team_redc(p, fq_modulus());
}

// (coefficient 0 of thread base, coefficient 1 of thread base + 1) on every thread
__device__ __forceinline__ Fq2 team3_gather(int base, const Fq& c) {
  Fq2 r;
  shfl_words(r.c0.v, c.v, base);
  shfl_words(r.c1.v, c.v, base + 1);
  return r;
}

// a - b if neg else a + b
__device__ __forceinline__ void fq2_addsub(Fq2& r, const Fq2& a, const Fq2& b, bool neg) {
  r = neg ? tfq2_sub(a, b) : tfq2_add(a, b);
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
    if (conj) hi = tfq2_sub(Fq2{fq_const_zero(), fq_const_zero()}, hi);
    r = m == 1 ? hi : tfq2_add(r, hi);
  }
  return r;
}

// Devegili operand k of Fq6 half m
__device__ __forceinline__ Fq2 team_operand(const uint32_t* s, int m, int k, bool conj) {
  if (k < 3) return team_half(s, m, k, conj);
  return tfq2_add(team_half(s, m, k == 3 ? 1 : 0, conj), team_half(s, m, k == 4 ? 1 : 2, conj));
}

// product step: thread k writes slots k, 6 + k, 12 + k of P
__device__ __forceinline__ void team_fq12_mul_products(int k, uint32_t* P, const uint32_t* a,
                                                       const uint32_t* b, bool conj_b) {
#pragma unroll 1
  for (int m = 0; m < 3; ++m)
    st2_s(P, 6 * m + k, team_fq2_mul(team_operand(a, m, k, false), team_operand(b, m, k, conj_b)));
  st2_s(P, 12 + k, tfq2_sub(tfq2_sub(ld2_s(P, 12 + k), ld2_s(P, k)), ld2_s(P, 6 + k)));
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
  acc = team_xi(acc);
#pragma unroll 1
  for (int t = 0; t < na; ++t, ta >>= 6)
    fq2_addsub(acc, acc, ld2_s(P, (int)(ta >> 1) & 31), ta & 1);
  return acc;
}

// ---------------------------------------------------------------------------
// Granger-Scott cyclotomic square (fq12.rs:198-247): three pairs (u,
// v) = (z0, z1), (z2, z3), (z4, z5), stored at coefficients (0, 4), (3,
// 2), (1, 5).  Thread k computes, for pair p = k % 3, tmp_p = u v (k < 3)
// or (u + v)(xi v + u) (k >= 3) into slot k of P.
// ---------------------------------------------------------------------------

__device__ __forceinline__ void team_cyc_sqr_products(int k, uint32_t* P, const uint32_t* a) {
  const int p = k % 3;
  const int iu = p == 0 ? 0 : (p == 1 ? 3 : 1), iv = p == 0 ? 4 : (p == 1 ? 2 : 5);
  Fq2 x = ld2_s(a, iu), y = ld2_s(a, iv);
  if (k >= 3) {
    const Fq2 s = tfq2_add(x, y);
    y = tfq2_add(team_xi(y), x);
    x = s;
  }
  st2_s(P, k, team_fq2_mul(x, y));
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
  const Fq2 xu = team_xi(u);
  const Fq2 s = tfq2_sub(w, tfq2_add(u, xu));           // ta = w - u - xi u
  Fq2 x = fq2_select(j == 3, xu, u);
  x = tfq2_add(x, x);                                    // tb, or xi tb for j = 3
  const Fq2 t = fq2_select(lo, s, x);
  fq2_addsub(x, t, z, lo);
  x = tfq2_add(x, x);
  return tfq2_add(x, t);
}

// ---------------------------------------------------------------------------
// Table-driven rounds (the Miller kernel, row 6, the prepared Miller
// loop, row 8l, and the prepared-G2 lines, row 14l, over Fq2 slots; the
// GLV ladder, row 20, csrc/groups.cu, over Fq or Fq2 slots).  The schedule
// (bn254_tpu_torch/team_schedule.py, loop_schedule.py,
// precompute_schedule.py, ladder_schedule.py, emitted into
// bn254_consts.h) lists a step's rounds; in a round thread k of a team of
// T computes the products k, k + T, ... and, after a __syncwarp, the
// linear combinations k, k + T, ....  An operand or combination is xi(sum
// of b) + sum of a (b is empty over Fq), each sum its positive slots
// added, then its negative slots subtracted, halved or doubled after
// (post 1, 2); a slot at BN254_TEAM_VIRT + j or above stands for slot vb +
// j of the lane (the Miller kernel: its addition's base y, Q's or -Q's;
// the prepared-G2 lines: the base's x and y; the ladder: the table point
// its digit picks).  Every thread runs this
// one code; only the table differs.
// ---------------------------------------------------------------------------

struct TeamLin {          // 16 bytes
  uint64_t terms;         // slots, 6 bits each: b's positive, b's negative, a's positive, a's negative
  uint32_t counts;        // those four counts, 4 bits each, then post (bits 16-17)
  uint32_t dst;           // 0xFF: no task
};
struct TeamMul { TeamLin x, y; };             // the product's slot is x.dst
struct TeamRound {
  TeamMul mul[18];
  TeamLin lin[12];
  int passes[4];          // product passes, combination passes, padding to 16 bytes
};

// v / 2 mod q for a reduced v: v even -> v >> 1, odd -> (v + q) >> 1 (v +
// q < 2q < 2^255, no carry out); the Montgomery form of x / 2 is the
// Montgomery form of x halved, so this is the product with 1/2, exactly
__device__ __forceinline__ void fq_half(Fq& r, const Fq& a) {
  const Modulus m = fq_modulus();
  const bool odd = a.v[0] & 1;
  uint32_t t[8];
  uint64_t c = 0;
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    uint64_t x = (uint64_t)a.v[j] + (odd ? m.q[j] : 0u) + c;
    t[j] = (uint32_t)x;
    c = x >> 32;
  }
#pragma unroll
  for (int j = 0; j < 7; ++j) r.v[j] = (t[j] >> 1) | (t[j + 1] << 31);
  r.v[7] = t[7] >> 1;
}

// The slot field's ops, overloaded on Fq and Fq2: the carry-flag adds, the
// product (fq_mul; the lazy Fq2 product), the halving
__device__ __forceinline__ void ld_s(Fq& r, const uint32_t* s, int i) {
  r = fq_load_words(s + kSlotWords<Fq> * i);
}
__device__ __forceinline__ void ld_s(Fq2& r, const uint32_t* s, int i) { r = ld2_s(s, i); }
__device__ __forceinline__ void st_s(uint32_t* s, int i, const Fq& v) {
  fq_store_words(s + kSlotWords<Fq> * i, v);
}
__device__ __forceinline__ void st_s(uint32_t* s, int i, const Fq2& v) { st2_s(s, i, v); }
__device__ __forceinline__ Fq team_add(const Fq& a, const Fq& b) { return tfq_add(a, b); }
__device__ __forceinline__ Fq2 team_add(const Fq2& a, const Fq2& b) { return tfq2_add(a, b); }
__device__ __forceinline__ Fq team_sub(const Fq& a, const Fq& b) { return tfq_sub(a, b); }
__device__ __forceinline__ Fq2 team_sub(const Fq2& a, const Fq2& b) { return tfq2_sub(a, b); }
__device__ __forceinline__ Fq team_mul(const Fq& a, const Fq& b) {
  Fq r;
  fq_mul(r, a, b);
  return r;
}
__device__ __forceinline__ Fq2 team_mul(const Fq2& a, const Fq2& b) { return team_fq2_mul(a, b); }
__device__ __forceinline__ void team_half(Fq& a) { fq_half(a, a); }
__device__ __forceinline__ void team_half(Fq2& a) {
  fq_half(a.c0, a.c0);
  fq_half(a.c1, a.c1);
}
__device__ __forceinline__ Fq team_xi_of(const Fq& a) { return a; }   // never called: no b over Fq
__device__ __forceinline__ Fq2 team_xi_of(const Fq2& a) { return team_xi(a); }

template <class F>
__device__ __forceinline__ F ld_term(const uint32_t* s, uint64_t t, int vb) {
  const int i = (int)t & 63;
  F r;
  ld_s(r, s, i >= BN254_TEAM_VIRT ? vb + (i - BN254_TEAM_VIRT) : i);
  return r;
}

// acc + sum of the next np slots of t - sum of the nn after them (t moves
// past them); with fresh, acc starts as the first positive slot (or 0)
template <class F>
__device__ __forceinline__ F team_sum(const uint32_t* s, F acc, bool fresh, uint64_t& t,
                                      int np, int nn, int vb) {
  int i = 0;
  if (fresh) {
    if (np) {
      acc = ld_term<F>(s, t, vb);
      t >>= 6;
      i = 1;
    } else {
      f_set_zero(acc);
    }
  }
#pragma unroll 1
  for (; i < np; ++i, t >>= 6) acc = team_add(acc, ld_term<F>(s, t, vb));
#pragma unroll 1
  for (int j = 0; j < nn; ++j, t >>= 6) acc = team_sub(acc, ld_term<F>(s, t, vb));
  return acc;
}

template <class F>
__device__ __forceinline__ F team_lin(const uint32_t* s, const TeamLin& c, int vb) {
  const int nbp = c.counts & 15, nbn = (c.counts >> 4) & 15;
  const int nap = (c.counts >> 8) & 15, nan = (c.counts >> 12) & 15, post = c.counts >> 16;
  const bool xi = nbp + nbn != 0;
  uint64_t t = c.terms;
  F acc;
  f_set_zero(acc);
  if (xi) acc = team_xi_of(team_sum(s, acc, true, t, nbp, nbn, vb));
  acc = team_sum(s, acc, !xi, t, nap, nan, vb);
  if (post == 1) {
    team_half(acc);
  } else if (post == 2) {
    acc = team_add(acc, acc);
  }
  return acc;
}

// one round of lane s's team of T threads (thread k); inactive threads
// only keep the barriers.  Each task is fetched one pass ahead, so that
// its load from the constant bank (T addresses a warp, served one after
// another) overlaps the product or combination before it.
template <class F, int T>
__device__ __forceinline__ void team_round(const TeamRound& r, int k, uint32_t* s, int vb,
                                           bool active) {
  const int mul_passes = r.passes[0], lin_passes = r.passes[1];
  TeamMul m = r.mul[k];
  TeamLin c = r.lin[k];
#pragma unroll 1
  for (int p = 0; p < mul_passes; ++p) {
    const TeamMul next = r.mul[p + 1 < mul_passes ? T * (p + 1) + k : k];
    if (active && m.x.dst != 0xFF)
      st_s(s, m.x.dst, team_mul(team_lin<F>(s, m.x, vb), team_lin<F>(s, m.y, vb)));
    m = next;
  }
  __syncwarp();
#pragma unroll 1
  for (int p = 0; p < lin_passes; ++p) {
    const TeamLin next = r.lin[p + 1 < lin_passes ? T * (p + 1) + k : k];
    if (active && c.dst != 0xFF) st_s(s, c.dst, team_lin<F>(s, c, vb));
    c = next;
  }
  __syncwarp();
}

}  // namespace bn254
