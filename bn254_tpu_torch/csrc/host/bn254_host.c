/* Native host engine for bn254_tpu: 64-bit-limb Montgomery arithmetic,
 * the Fq2/Fq6/Fq12 tower, the Jacobian group law, and the optimal-ate
 * pairing — the runtime-native counterpart of the reference crate's Rust
 * core, used by the scalar Python API through ctypes (bn254_tpu/native.py).
 *
 * The algebra mirrors bn254_tpu/spec (the Python oracle), which itself
 * carries the reference parity citations:
 *   - Montgomery CIOS mul        (reference arith.rs:525-545, HAC 14.32)
 *   - field tower formulas       (fields/{fp.rs,fq2.rs,fq6.rs,fq12.rs})
 *   - group law                  (groups/mod.rs:250-334)
 *   - pairing engine             (groups/mod.rs:515-777, 894-926)
 *
 * ABI: every exported function takes canonical (non-Montgomery) values as
 * little-endian u64[4] limbs; Montgomery conversion happens inside.  One
 * exception: none.  Thread-safety: all state is constant after
 * bn254_init().
 */

#include <stdint.h>
#include <stdlib.h>
#include <string.h>
#ifdef _OPENMP
#include <omp.h>
#endif

typedef unsigned __int128 u128;
typedef struct { uint64_t v[4]; } u256;
typedef struct { u256 c0, c1; } cfq2; /* canonical pair, constants only */

#include "bn254_consts.h"

/* ------------------------------------------------------------------ */
/* u256 / Montgomery core                                             */
/* ------------------------------------------------------------------ */

typedef u256 fq;  /* Montgomery-form Fq element */

static inline int u256_is_zero(const u256 *a) {
    return (a->v[0] | a->v[1] | a->v[2] | a->v[3]) == 0;
}

static inline int u256_eq(const u256 *a, const u256 *b) {
    return a->v[0] == b->v[0] && a->v[1] == b->v[1] &&
           a->v[2] == b->v[2] && a->v[3] == b->v[3];
}

static inline int u256_ge(const u256 *a, const u256 *b) {
    for (int i = 3; i >= 0; i--) {
        if (a->v[i] > b->v[i]) return 1;
        if (a->v[i] < b->v[i]) return 0;
    }
    return 1;
}

static inline void u256_sub_raw(u256 *r, const u256 *a, const u256 *b) {
    u128 borrow = 0;
    for (int i = 0; i < 4; i++) {
        u128 d = (u128)a->v[i] - b->v[i] - borrow;
        r->v[i] = (uint64_t)d;
        borrow = (d >> 64) & 1;
    }
}

static inline void mod_add(u256 *r, const u256 *a, const u256 *b,
                           const u256 *p) {
    u128 carry = 0;
    u256 t;
    for (int i = 0; i < 4; i++) {
        u128 s = (u128)a->v[i] + b->v[i] + carry;
        t.v[i] = (uint64_t)s;
        carry = s >> 64;
    }
    /* a + b < 2p < 2^256 for reduced inputs: no carry-out */
    if (carry || u256_ge(&t, p)) u256_sub_raw(&t, &t, p);
    *r = t;
}

static inline void mod_sub(u256 *r, const u256 *a, const u256 *b,
                           const u256 *p) {
    if (u256_ge(a, b)) {
        u256_sub_raw(r, a, b);
    } else {
        u256 t;
        u256_sub_raw(&t, b, a);
        u256_sub_raw(r, p, &t);
    }
}

static inline void mod_neg(u256 *r, const u256 *a, const u256 *p) {
    if (u256_is_zero(a)) { *r = *a; return; }
    u256_sub_raw(r, p, a);
}

/* CIOS Montgomery multiply, 4x64 limbs (arith.rs:525-545 analogue). */
static void mont_mul(u256 *r, const u256 *a, const u256 *b,
                     const u256 *p, uint64_t inv) {
    uint64_t t[6] = {0, 0, 0, 0, 0, 0};
    for (int i = 0; i < 4; i++) {
        u128 carry = 0;
        for (int j = 0; j < 4; j++) {
            u128 cur = (u128)t[j] + (u128)a->v[i] * b->v[j] + carry;
            t[j] = (uint64_t)cur;
            carry = cur >> 64;
        }
        u128 cur = (u128)t[4] + carry;
        t[4] = (uint64_t)cur;
        t[5] = (uint64_t)(cur >> 64);

        uint64_t m = t[0] * inv;
        u128 c0 = (u128)t[0] + (u128)m * p->v[0];
        carry = c0 >> 64;
        for (int j = 1; j < 4; j++) {
            u128 c2 = (u128)t[j] + (u128)m * p->v[j] + carry;
            t[j - 1] = (uint64_t)c2;
            carry = c2 >> 64;
        }
        u128 c3 = (u128)t[4] + carry;
        t[3] = (uint64_t)c3;
        t[4] = t[5] + (uint64_t)(c3 >> 64);
        t[5] = 0;
    }
    u256 res = {{ t[0], t[1], t[2], t[3] }};
    if (t[4] || u256_ge(&res, p)) u256_sub_raw(&res, &res, p);
    *r = res;
}

/* MSB-first square-and-multiply a^e (fields/mod.rs:35-46 analogue);
 * e is a canonical u256, `one` the Montgomery 1. */
static void mont_pow(u256 *r, const u256 *a, const u256 *e,
                     const u256 *p, uint64_t inv, const u256 *one) {
    u256 res = *one;
    int started = 0;
    for (int i = 255; i >= 0; i--) {
        if (started) mont_mul(&res, &res, &res, p, inv);
        if ((e->v[i / 64] >> (i % 64)) & 1) {
            mont_mul(&res, &res, a, p, inv);
            started = 1;
        }
    }
    *r = res;
}

/* ------------------------------------------------------------------ */
/* Fq (Montgomery) layer                                              */
/* ------------------------------------------------------------------ */

static u256 FQ_P_MINUS_2;   /* exponent for Fermat inversion */
static u256 FR_P_MINUS_2;

static inline void fq_add(fq *r, const fq *a, const fq *b) { mod_add(r, a, b, &FQ_P); }
static inline void fq_sub(fq *r, const fq *a, const fq *b) { mod_sub(r, a, b, &FQ_P); }
static inline void fq_neg(fq *r, const fq *a) { mod_neg(r, a, &FQ_P); }
static inline void fq_mul(fq *r, const fq *a, const fq *b) { mont_mul(r, a, b, &FQ_P, FQ_INV); }
static inline void fq_sqr(fq *r, const fq *a) { mont_mul(r, a, a, &FQ_P, FQ_INV); }
static inline void fq_dbl(fq *r, const fq *a) { mod_add(r, a, a, &FQ_P); }

static void fq_inv(fq *r, const fq *a) {            /* fp.rs:108-117; 0->0 */
    mont_pow(r, a, &FQ_P_MINUS_2, &FQ_P, FQ_INV, &FQ_RR);
}

static inline void fq_to_mont(fq *r, const u256 *a) {
    mont_mul(r, a, &FQ_R2, &FQ_P, FQ_INV);
}

static inline void fq_from_mont(u256 *r, const fq *a) {
    u256 one = {{1, 0, 0, 0}};
    mont_mul(r, a, &one, &FQ_P, FQ_INV);
}

/* ------------------------------------------------------------------ */
/* Fq2 = Fq[i]/(i^2+1)  (fq2.rs)                                      */
/* ------------------------------------------------------------------ */

typedef struct { fq c0, c1; } fq2;

static fq2 XI_M, B2_M, G2X_M, G2Y_M, TWIST_QX_M, TWIST_QY_M, TWO_INV_M;
static fq2 FROB6_C1_M[4], FROB6_C2_M[4], FROB12_C1_M[4];
static fq FQ_ONE_M;

static inline void fq2_add(fq2 *r, const fq2 *a, const fq2 *b) {
    fq_add(&r->c0, &a->c0, &b->c0);
    fq_add(&r->c1, &a->c1, &b->c1);
}

static inline void fq2_sub(fq2 *r, const fq2 *a, const fq2 *b) {
    fq_sub(&r->c0, &a->c0, &b->c0);
    fq_sub(&r->c1, &a->c1, &b->c1);
}

static inline void fq2_neg(fq2 *r, const fq2 *a) {
    fq_neg(&r->c0, &a->c0);
    fq_neg(&r->c1, &a->c1);
}

static inline int fq2_is_zero(const fq2 *a) {
    return u256_is_zero(&a->c0) && u256_is_zero(&a->c1);
}

static inline int fq2_eq(const fq2 *a, const fq2 *b) {
    return u256_eq(&a->c0, &b->c0) && u256_eq(&a->c1, &b->c1);
}

static void fq2_mul(fq2 *r, const fq2 *a, const fq2 *b) { /* fq2.rs:133-149 */
    fq aa, bb, s1, s2, cross;
    fq_mul(&aa, &a->c0, &b->c0);
    fq_mul(&bb, &a->c1, &b->c1);
    fq_add(&s1, &a->c0, &a->c1);
    fq_add(&s2, &b->c0, &b->c1);
    fq_mul(&cross, &s1, &s2);
    fq_sub(&r->c0, &aa, &bb);
    fq_sub(&cross, &cross, &aa);
    fq_sub(&r->c1, &cross, &bb);
}

static void fq2_sqr(fq2 *r, const fq2 *a) {          /* fq2.rs:105-117 */
    fq ab, s, d, t;
    fq_mul(&ab, &a->c0, &a->c1);
    fq_add(&s, &a->c0, &a->c1);
    fq_sub(&d, &a->c0, &a->c1);
    fq_mul(&t, &s, &d);
    r->c0 = t;
    fq_add(&r->c1, &ab, &ab);
}

static void fq2_scale(fq2 *r, const fq2 *a, const fq *k) { /* fq2.rs:48 */
    fq_mul(&r->c0, &a->c0, k);
    fq_mul(&r->c1, &a->c1, k);
}

static void fq2_mul_by_xi(fq2 *r, const fq2 *a) {    /* fq2.rs:55 */
    fq2_mul(r, a, &XI_M);
}

static void fq2_inv(fq2 *r, const fq2 *a) {          /* fq2.rs:119-130 */
    fq n, t, s;
    fq_sqr(&n, &a->c0);
    fq_sqr(&t, &a->c1);
    fq_add(&n, &n, &t);
    fq_inv(&s, &n);
    fq_mul(&r->c0, &a->c0, &s);
    fq_mul(&t, &a->c1, &s);
    fq_neg(&r->c1, &t);
}

static inline void fq2_conj(fq2 *r, const fq2 *a) {  /* fq2.rs:59-68 */
    r->c0 = a->c0;
    fq_neg(&r->c1, &a->c1);
}

static inline void fq2_frob(fq2 *r, const fq2 *a, int power) {
    if (power & 1) fq2_conj(r, a); else *r = *a;
}

/* ------------------------------------------------------------------ */
/* Fq6 = Fq2[v]/(v^3 - xi)  (fq6.rs)                                  */
/* ------------------------------------------------------------------ */

typedef struct { fq2 c0, c1, c2; } fq6;

static void fq6_add(fq6 *r, const fq6 *a, const fq6 *b) {
    fq2_add(&r->c0, &a->c0, &b->c0);
    fq2_add(&r->c1, &a->c1, &b->c1);
    fq2_add(&r->c2, &a->c2, &b->c2);
}

static void fq6_sub(fq6 *r, const fq6 *a, const fq6 *b) {
    fq2_sub(&r->c0, &a->c0, &b->c0);
    fq2_sub(&r->c1, &a->c1, &b->c1);
    fq2_sub(&r->c2, &a->c2, &b->c2);
}

static void fq6_neg(fq6 *r, const fq6 *a) {
    fq2_neg(&r->c0, &a->c0);
    fq2_neg(&r->c1, &a->c1);
    fq2_neg(&r->c2, &a->c2);
}

static void fq6_mul_by_nonresidue(fq6 *r, const fq6 *a) { /* fq6.rs:109-115 */
    fq2 t0 = a->c0, t1 = a->c1;
    fq2_mul_by_xi(&r->c0, &a->c2);
    r->c1 = t0;
    r->c2 = t1;
}

static void fq6_scale(fq6 *r, const fq6 *a, const fq2 *k) { /* fq6.rs:117 */
    fq2_mul(&r->c0, &a->c0, k);
    fq2_mul(&r->c1, &a->c1, k);
    fq2_mul(&r->c2, &a->c2, k);
}

static void fq6_mul(fq6 *r, const fq6 *a, const fq6 *b) { /* fq6.rs:194-208 */
    fq2 a_a, b_b, c_c, t, u, s;
    fq2_mul(&a_a, &a->c0, &b->c0);
    fq2_mul(&b_b, &a->c1, &b->c1);
    fq2_mul(&c_c, &a->c2, &b->c2);

    fq2 r0, r1, r2;
    fq2_add(&t, &a->c1, &a->c2);
    fq2_add(&u, &b->c1, &b->c2);
    fq2_mul(&s, &t, &u);
    fq2_sub(&s, &s, &b_b);
    fq2_sub(&s, &s, &c_c);
    fq2_mul_by_xi(&s, &s);
    fq2_add(&r0, &s, &a_a);

    fq2_add(&t, &a->c0, &a->c1);
    fq2_add(&u, &b->c0, &b->c1);
    fq2_mul(&s, &t, &u);
    fq2_sub(&s, &s, &a_a);
    fq2_sub(&s, &s, &b_b);
    fq2_mul_by_xi(&t, &c_c);
    fq2_add(&r1, &s, &t);

    fq2_add(&t, &a->c0, &a->c2);
    fq2_add(&u, &b->c0, &b->c2);
    fq2_mul(&s, &t, &u);
    fq2_sub(&s, &s, &a_a);
    fq2_add(&s, &s, &b_b);
    fq2_sub(&r2, &s, &c_c);

    r->c0 = r0; r->c1 = r1; r->c2 = r2;
}

static void fq6_sqr(fq6 *r, const fq6 *a) {          /* fq6.rs:163-177 */
    fq2 s0, ab, s1, s2, bc, s3, s4, t;
    fq2_sqr(&s0, &a->c0);
    fq2_mul(&ab, &a->c0, &a->c1);
    fq2_add(&s1, &ab, &ab);
    fq2_sub(&t, &a->c0, &a->c1);
    fq2_add(&t, &t, &a->c2);
    fq2_sqr(&s2, &t);
    fq2_mul(&bc, &a->c1, &a->c2);
    fq2_add(&s3, &bc, &bc);
    fq2_sqr(&s4, &a->c2);

    fq2 r0, r1, r2;
    fq2_mul_by_xi(&t, &s3);
    fq2_add(&r0, &s0, &t);
    fq2_mul_by_xi(&t, &s4);
    fq2_add(&r1, &s1, &t);
    fq2_add(&t, &s1, &s2);
    fq2_add(&t, &t, &s3);
    fq2_sub(&t, &t, &s0);
    fq2_sub(&r2, &t, &s4);
    r->c0 = r0; r->c1 = r1; r->c2 = r2;
}

static void fq6_inv(fq6 *r, const fq6 *a) {          /* fq6.rs:179-192 */
    fq2 c0, c1, c2, t, u;
    fq2_sqr(&c0, &a->c0);
    fq2_mul_by_xi(&t, &a->c2);
    fq2_mul(&u, &a->c1, &t);
    fq2_sub(&c0, &c0, &u);
    fq2_sqr(&t, &a->c2);
    fq2_mul_by_xi(&c1, &t);
    fq2_mul(&u, &a->c0, &a->c1);
    fq2_sub(&c1, &c1, &u);
    fq2_sqr(&c2, &a->c1);
    fq2_mul(&u, &a->c0, &a->c2);
    fq2_sub(&c2, &c2, &u);

    fq2 norm;
    fq2_mul(&t, &a->c2, &c1);
    fq2_mul(&u, &a->c1, &c2);
    fq2_add(&t, &t, &u);
    fq2_mul_by_xi(&t, &t);
    fq2_mul(&u, &a->c0, &c0);
    fq2_add(&norm, &t, &u);
    fq2_inv(&norm, &norm);
    fq2_mul(&r->c0, &norm, &c0);
    fq2_mul(&r->c1, &norm, &c1);
    fq2_mul(&r->c2, &norm, &c2);
}

static void fq6_frob(fq6 *r, const fq6 *a, int power) { /* fq6.rs:125-131 */
    fq2 t;
    /* the coefficient tables only carry powers 0-3, matching the
       reference's unimplemented!() for higher powers (fq6.rs:5-90) —
       fail fast instead of silently using the wrong coefficient */
    if (power % 6 >= 4) abort();
    fq2_frob(&r->c0, &a->c0, power);
    fq2_frob(&t, &a->c1, power);
    fq2_mul(&r->c1, &t, &FROB6_C1_M[power % 6]);
    fq2_frob(&t, &a->c2, power);
    fq2_mul(&r->c2, &t, &FROB6_C2_M[power % 6]);
}

/* ------------------------------------------------------------------ */
/* Fq12 = Fq6[w]/(w^2 - v)  (fq12.rs)                                 */
/* ------------------------------------------------------------------ */

typedef struct { fq6 c0, c1; } fq12;

static void fq12_one(fq12 *r) {
    memset(r, 0, sizeof(*r));
    r->c0.c0.c0 = FQ_ONE_M;
}

static void fq12_mul(fq12 *r, const fq12 *a, const fq12 *b) { /* :316-328 */
    fq6 aa, bb, s, t, cross;
    fq6_mul(&aa, &a->c0, &b->c0);
    fq6_mul(&bb, &a->c1, &b->c1);
    fq6_add(&s, &a->c0, &a->c1);
    fq6_add(&t, &b->c0, &b->c1);
    fq6_mul(&cross, &s, &t);
    fq6_mul_by_nonresidue(&s, &bb);
    fq6_add(&r->c0, &s, &aa);
    fq6_sub(&cross, &cross, &aa);
    fq6_sub(&r->c1, &cross, &bb);
}

static void fq12_sqr(fq12 *r, const fq12 *a) {       /* fq12.rs:295-303 */
    fq6 ab, t, u, s;
    fq6_mul(&ab, &a->c0, &a->c1);
    fq6_mul_by_nonresidue(&t, &a->c1);
    fq6_add(&t, &t, &a->c0);
    fq6_add(&u, &a->c0, &a->c1);
    fq6_mul(&s, &t, &u);
    fq6_sub(&s, &s, &ab);
    fq6_mul_by_nonresidue(&t, &ab);
    fq6_sub(&r->c0, &s, &t);
    fq6_add(&r->c1, &ab, &ab);
}

static void fq12_inv(fq12 *r, const fq12 *a) {       /* fq12.rs:305-313 */
    fq6 t, u;
    fq6_sqr(&t, &a->c0);
    fq6_sqr(&u, &a->c1);
    fq6_mul_by_nonresidue(&u, &u);
    fq6_sub(&t, &t, &u);
    fq6_inv(&t, &t);
    fq6_mul(&r->c0, &a->c0, &t);
    fq6_mul(&u, &a->c1, &t);
    fq6_neg(&r->c1, &u);
}

static void fq12_conj(fq12 *r, const fq12 *a) {      /* fq12.rs:126 */
    r->c0 = a->c0;
    fq6_neg(&r->c1, &a->c1);
}

static void fq12_frob(fq12 *r, const fq12 *a, int power) { /* :112-119 */
    fq6 t;
    if (power % 12 >= 4) abort();  /* table carries powers 0-3 only */
    fq6_frob(&r->c0, &a->c0, power);
    fq6_frob(&t, &a->c1, power);
    fq6_scale(&r->c1, &t, &FROB12_C1_M[power % 12]);
}

/* sparse line multiply, 13 fq2 muls (fq12.rs:130-196) */
static void fq12_mul_by_024(fq12 *r, const fq12 *a, const fq2 *x0,
                            const fq2 *x2, const fq2 *x4) {
    fq2 z0 = a->c0.c0, z1 = a->c0.c1, z2 = a->c0.c2;
    fq2 z3 = a->c1.c0, z4 = a->c1.c1, z5 = a->c1.c2;
    fq2 d0, d2, d4, t2, t1, t0, t3, t4, s0, s1;
    fq2 nz0, nz1, nz2, nz3, nz4, nz5;

    fq2_mul(&d0, &z0, x0);
    fq2_mul(&d2, &z2, x2);
    fq2_mul(&d4, &z4, x4);
    fq2_add(&t2, &z0, &z4);
    fq2_add(&t1, &z0, &z2);
    fq2_add(&s0, &z1, &z3);
    fq2_add(&s0, &s0, &z5);

    fq2_mul(&s1, &z1, x2);
    fq2_add(&t3, &s1, &d4);
    fq2_mul_by_xi(&t4, &t3);
    fq2_add(&nz0, &t4, &d0);

    fq2_mul(&t3, &z5, x4);
    fq2_add(&s1, &s1, &t3);
    fq2_add(&t3, &t3, &d2);
    fq2_mul_by_xi(&t4, &t3);
    fq2_mul(&t3, &z1, x0);
    fq2_add(&s1, &s1, &t3);
    fq2_add(&nz1, &t4, &t3);

    fq2_add(&t0, x0, x2);
    fq2_mul(&t3, &t1, &t0);
    fq2_sub(&t3, &t3, &d0);
    fq2_sub(&t3, &t3, &d2);
    fq2_mul(&t4, &z3, x4);
    fq2_add(&s1, &s1, &t4);
    fq2_add(&nz2, &t3, &t4);

    fq2_add(&t0, &z2, &z4);

    fq2_add(&t1, x2, x4);
    fq2_mul(&t3, &t0, &t1);
    fq2_sub(&t3, &t3, &d2);
    fq2_sub(&t3, &t3, &d4);
    fq2_mul_by_xi(&t4, &t3);
    fq2_mul(&t3, &z3, x0);
    fq2_add(&s1, &s1, &t3);
    fq2_add(&nz3, &t4, &t3);

    fq2_mul(&t3, &z5, x2);
    fq2_add(&s1, &s1, &t3);
    fq2_mul_by_xi(&t4, &t3);
    fq2_add(&t0, x0, x4);
    fq2_mul(&t3, &t2, &t0);
    fq2_sub(&t3, &t3, &d0);
    fq2_sub(&t3, &t3, &d4);
    fq2_add(&nz4, &t4, &t3);

    fq2_add(&t0, x0, x2);
    fq2_add(&t0, &t0, x4);
    fq2_mul(&t3, &s0, &t0);
    fq2_sub(&nz5, &t3, &s1);

    r->c0.c0 = nz0; r->c0.c1 = nz1; r->c0.c2 = nz2;
    r->c1.c0 = nz3; r->c1.c1 = nz4; r->c1.c2 = nz5;
}

/* Granger-Scott cyclotomic squaring (fq12.rs:198-247) */
static void cyc_sq_pair(fq2 *ta, fq2 *tb, const fq2 *u, const fq2 *v) {
    fq2 tmp, s, t;
    fq2_mul(&tmp, u, v);
    fq2_add(&s, u, v);
    fq2_mul_by_xi(&t, v);
    fq2_add(&t, &t, u);
    fq2_mul(&s, &s, &t);
    fq2_sub(&s, &s, &tmp);
    fq2_mul_by_xi(&t, &tmp);
    fq2_sub(ta, &s, &t);
    fq2_add(tb, &tmp, &tmp);
}

static void cyc_tri(fq2 *r, const fq2 *base, const fq2 *t, int sub) {
    fq2 x;
    if (sub) fq2_sub(&x, t, base); else fq2_add(&x, t, base);
    fq2_add(&x, &x, &x);
    fq2_add(r, &x, t);
}

static void fq12_cyclotomic_sqr(fq12 *r, const fq12 *a) {
    fq2 z0 = a->c0.c0, z4 = a->c0.c1, z3 = a->c0.c2;
    fq2 z2 = a->c1.c0, z1 = a->c1.c1, z5 = a->c1.c2;
    fq2 t0, t1, t2, t3, t4, t5, tmp;
    cyc_sq_pair(&t0, &t1, &z0, &z1);
    cyc_sq_pair(&t2, &t3, &z2, &z3);
    cyc_sq_pair(&t4, &t5, &z4, &z5);

    fq2 nz0, nz1, nz2, nz3, nz4, nz5;
    cyc_tri(&nz0, &z0, &t0, 1);
    cyc_tri(&nz1, &z1, &t1, 0);
    fq2_mul_by_xi(&tmp, &t5);
    cyc_tri(&nz2, &z2, &tmp, 0);
    cyc_tri(&nz3, &z3, &t4, 1);
    cyc_tri(&nz4, &z4, &t2, 1);
    cyc_tri(&nz5, &z5, &t3, 0);

    r->c0.c0 = nz0; r->c0.c1 = nz4; r->c0.c2 = nz3;
    r->c1.c0 = nz2; r->c1.c1 = nz1; r->c1.c2 = nz5;
}

/* cyclotomic a^z with found_one skip (fq12.rs:249-267, z at :122) */
static void fq12_cyclotomic_pow_z(fq12 *r, const fq12 *a) {
    fq12 res;
    fq12_one(&res);
    int found = 0;
    for (int i = 63; i >= 0; i--) {
        if (found) fq12_cyclotomic_sqr(&res, &res);
        if ((BN_Z >> i) & 1) {
            found = 1;
            fq12_mul(&res, a, &res);
        }
    }
    *r = res;
}

static void fq12_exp_by_neg_z(fq12 *r, const fq12 *a) { /* fq12.rs:121-124 */
    fq12 t;
    fq12_cyclotomic_pow_z(&t, a);
    fq12_conj(r, &t);
}

/* final exponentiation: easy + Scott et al. hard chunk (fq12.rs:62-110) */
static void fq12_final_exp(fq12 *r, const fq12 *x) {
    fq12 inv, c, f, a, b, c2, d, e, f2, g, h, i, j, k, l, m, n, o, p, q,
         rr, s, t, u;
    fq12_inv(&inv, x);
    fq12_conj(&c, x);
    fq12_mul(&c, &c, &inv);
    fq12_frob(&f, &c, 2);
    fq12_mul(&f, &f, &c);

    fq12_exp_by_neg_z(&a, &f);
    fq12_cyclotomic_sqr(&b, &a);
    fq12_cyclotomic_sqr(&c2, &b);
    fq12_mul(&d, &c2, &b);

    fq12_exp_by_neg_z(&e, &d);
    fq12_cyclotomic_sqr(&f2, &e);
    fq12_exp_by_neg_z(&g, &f2);
    fq12_conj(&h, &d);
    fq12_conj(&i, &g);

    fq12_mul(&j, &i, &e);
    fq12_mul(&k, &j, &h);
    fq12_mul(&l, &k, &b);
    fq12_mul(&m, &k, &e);
    fq12_mul(&n, &f, &m);

    fq12_frob(&o, &l, 1);
    fq12_mul(&p, &o, &n);

    fq12_frob(&q, &k, 2);
    fq12_mul(&rr, &q, &p);

    fq12_conj(&s, &f);
    fq12_mul(&t, &s, &l);
    fq12_frob(&u, &t, 3);
    fq12_mul(r, &u, &rr);
}

/* ------------------------------------------------------------------ */
/* Group law (generic over Fq / Fq2 via macros; groups/mod.rs)        */
/* ------------------------------------------------------------------ */

typedef struct { fq x, y, z; } g1_t;
typedef struct { fq2 x, y, z; } g2_t;

#define DEF_GROUP(NAME, FE, FE_ADD, FE_SUB, FE_NEG, FE_MUL, FE_SQR,     \
                  FE_IS_ZERO, FE_EQ, PT)                                 \
static void NAME##_double(PT *r, const PT *p) {   /* mod.rs:250-269 */   \
    FE a, b, c, d, e, f, x3, ec, y1z1, t;                                \
    FE_SQR(&a, &p->x);                                                   \
    FE_SQR(&b, &p->y);                                                   \
    FE_SQR(&c, &b);                                                      \
    FE_ADD(&t, &p->x, &b);                                               \
    FE_SQR(&d, &t);                                                      \
    FE_SUB(&d, &d, &a);                                                  \
    FE_SUB(&d, &d, &c);                                                  \
    FE_ADD(&d, &d, &d);                                                  \
    FE_ADD(&e, &a, &a);                                                  \
    FE_ADD(&e, &e, &a);                                                  \
    FE_SQR(&f, &e);                                                      \
    FE_ADD(&t, &d, &d);                                                  \
    FE_SUB(&x3, &f, &t);                                                 \
    FE_ADD(&ec, &c, &c);                                                 \
    FE_ADD(&ec, &ec, &ec);                                               \
    FE_ADD(&ec, &ec, &ec);                                               \
    FE_MUL(&y1z1, &p->y, &p->z);                                         \
    FE_SUB(&t, &d, &x3);                                                 \
    FE_MUL(&t, &e, &t);                                                  \
    FE_SUB(&r->y, &t, &ec);                                              \
    r->x = x3;                                                           \
    FE_ADD(&r->z, &y1z1, &y1z1);                                         \
}                                                                        \
static void NAME##_add(PT *r, const PT *p, const PT *q) { /* :294-334 */ \
    if (FE_IS_ZERO(&p->z)) { *r = *q; return; }                          \
    if (FE_IS_ZERO(&q->z)) { *r = *p; return; }                          \
    FE z1s, z2s, u1, u2, z1c, z2c, s1, s2, h, rr, i, j, v, s1j, t;       \
    FE_SQR(&z1s, &p->z);                                                 \
    FE_SQR(&z2s, &q->z);                                                 \
    FE_MUL(&u1, &p->x, &z2s);                                            \
    FE_MUL(&u2, &q->x, &z1s);                                            \
    FE_MUL(&z1c, &p->z, &z1s);                                           \
    FE_MUL(&z2c, &q->z, &z2s);                                           \
    FE_MUL(&s1, &p->y, &z2c);                                            \
    FE_MUL(&s2, &q->y, &z1c);                                            \
    if (FE_EQ(&u1, &u2) && FE_EQ(&s1, &s2)) { NAME##_double(r, p); return; } \
    FE_SUB(&h, &u2, &u1);                                                \
    FE_SUB(&t, &s2, &s1);                                                \
    FE_ADD(&rr, &t, &t);                                                 \
    FE_ADD(&t, &h, &h);                                                  \
    FE_SQR(&i, &t);                                                      \
    FE_MUL(&j, &h, &i);                                                  \
    FE_MUL(&v, &u1, &i);                                                 \
    FE_MUL(&s1j, &s1, &j);                                               \
    FE_SQR(&t, &rr);                                                     \
    FE_SUB(&t, &t, &j);                                                  \
    FE x3;                                                               \
    FE_ADD(&x3, &v, &v);                                                 \
    FE_SUB(&x3, &t, &x3);                                                \
    FE_SUB(&t, &v, &x3);                                                 \
    FE_MUL(&t, &rr, &t);                                                 \
    FE y3;                                                               \
    FE_ADD(&y3, &s1j, &s1j);                                             \
    FE_SUB(&y3, &t, &y3);                                                \
    FE_ADD(&t, &p->z, &q->z);                                            \
    FE_SQR(&t, &t);                                                      \
    FE_SUB(&t, &t, &z1s);                                                \
    FE_SUB(&t, &t, &z2s);                                                \
    FE_MUL(&r->z, &t, &h);                                               \
    r->x = x3;                                                           \
    r->y = y3;                                                           \
}                                                                        \
static void NAME##_scalar_mul(PT *r, const PT *p, const u256 *k) {       \
    /* MSB-first double-and-add, mod.rs:272-292 */                       \
    PT res;                                                              \
    memset(&res, 0, sizeof(res));                                        \
    int started = 0;                                                     \
    for (int bit = 255; bit >= 0; bit--) {                               \
        if (started) NAME##_double(&res, &res);                          \
        if ((k->v[bit / 64] >> (bit % 64)) & 1) {                        \
            if (started) NAME##_add(&res, &res, p); else { res = *p; }   \
            started = 1;                                                 \
        }                                                                \
    }                                                                    \
    if (!started) memset(&res, 0, sizeof(res));                          \
    *r = res;                                                            \
}

static inline int fq_is_zero_w(const fq *a) { return u256_is_zero(a); }
static inline int fq_eq_w(const fq *a, const fq *b) { return u256_eq(a, b); }

DEF_GROUP(g1, fq, fq_add, fq_sub, fq_neg, fq_mul, fq_sqr,
          fq_is_zero_w, fq_eq_w, g1_t)
DEF_GROUP(g2, fq2, fq2_add, fq2_sub, fq2_neg, fq2_mul, fq2_sqr,
          fq2_is_zero, fq2_eq, g2_t)

/* ------------------------------------------------------------------ */
/* GLV + wNAF scalar multiplication (same lattice/Barrett constants   */
/* as the device path, bn254_tpu/glv.py; the MSB-first double-and-add */
/* above stays the mod.rs:272-292 parity oracle)                      */
/* ------------------------------------------------------------------ */

static fq BETA_G1_M, BETA_G2_M;   /* set in bn254_init */

static inline void u256_add_raw(u256 *r, const u256 *a, const u256 *b) {
    u128 c = 0;
    for (int i = 0; i < 4; i++) {
        c += (u128)a->v[i] + b->v[i];
        r->v[i] = (uint64_t)c;
        c >>= 64;
    }
}

/* b = (k * g + 2^(GLV_SHIFT-1)) >> GLV_SHIFT  (270 = 4*64 + 14) */
static void glv_barrett(u256 *b, const u256 *k, const uint64_t g[5]) {
    uint64_t t[9] = {0};
    for (int i = 0; i < 4; i++) {
        u128 c = 0;
        for (int j = 0; j < 5; j++) {
            c += (u128)k->v[i] * g[j] + t[i + j];
            t[i + j] = (uint64_t)c;
            c >>= 64;
        }
        t[i + 5] = (uint64_t)c;
    }
    /* + 2^269: bit 13 of limb 4, carry upward */
    u128 c = (u128)1 << 13;
    for (int i = 4; i < 9 && c; i++) {
        c += t[i];
        t[i] = (uint64_t)c;
        c >>= 64;
    }
    for (int i = 0; i < 4; i++)
        b->v[i] = (t[4 + i] >> 14) | (i + 5 < 9 ? t[5 + i] << 50 : 0);
}

/* r = (a * b) mod 2^256 */
static void u256_mul_trunc(u256 *r, const u256 *a, const u256 *b) {
    uint64_t t[4] = {0};
    for (int i = 0; i < 4; i++) {
        u128 c = 0;
        for (int j = 0; i + j < 4; j++) {
            c += (u128)a->v[i] * b->v[j] + t[i + j];
            t[i + j] = (uint64_t)c;
            c >>= 64;
        }
    }
    memcpy(r->v, t, sizeof(t));
}

/* k (any 256-bit value, canonical or not) -> (|k1|, s1, |k2|, s2) with
 * k = (-1)^s1 |k1| + (-1)^s2 |k2| * lambda (mod r) and |ki| < 2^127.
 * The bound is analytical, not empirical: the Barrett rounding error is
 * <= 1/2 + 2^-15 per coefficient independent of k (GLV_GiC carry 2^271
 * scaling vs the 2^256 shift), so (k1,k2) lies within one fundamental
 * lattice cell of the rounded solution and the half-scalar bound from
 * the reduced basis (|vi| ~ sqrt(r)) holds for all inputs. */
static void glv_decompose(const u256 *k, u256 *a1, int *s1,
                          u256 *a2, int *s2) {
    u256 b1, b2, t1, t2, k1, k2, zero = {{0, 0, 0, 0}};
    glv_barrett(&b1, k, GLV_G1C);
    glv_barrett(&b2, k, GLV_G2C);
    u256_mul_trunc(&t1, &b1, &GLV_V1A);
    u256_mul_trunc(&t2, &b2, &GLV_V2A);
    u256_sub_raw(&k1, k, &t1);
    u256_sub_raw(&k1, &k1, &t2);
    /* k2 = -(b1*v1b + b2*v2b) = b1*|v1b| - b2*v2b  (v1b < 0) */
    u256_mul_trunc(&t1, &b1, &GLV_V1B_NEG);
    u256_mul_trunc(&t2, &b2, &GLV_V2B);
    u256_sub_raw(&k2, &t1, &t2);
    *s1 = (k1.v[3] >> 63) != 0;
    if (*s1) u256_sub_raw(&k1, &zero, &k1);
    *a1 = k1;
    *s2 = (k2.v[3] >> 63) != 0;
    if (*s2) u256_sub_raw(&k2, &zero, &k2);
    *a2 = k2;
}

/* width-4 NAF: odd digits in [-15, 15], LSB-first; returns length.
 * cap: the caller's buffers hold GLV_WNAF_MAX digits.  A w-NAF of an
 * n-bit value has at most n+1 digits; GLV half-scalars satisfy
 * |ki| < 2^127 even for non-canonical 256-bit k (the decomposition is
 * correct mod r for any input), so 132 leaves headroom — the cap only
 * bites if the lattice constants ever change, turning a silent stack
 * overflow into a truncated (wrong, but memory-safe) result. */
#define GLV_WNAF_MAX 132
static int glv_wnaf(int8_t *digits, const u256 *k) {
    u256 n = *k;
    int len = 0;
    while (!u256_is_zero(&n) && len < GLV_WNAF_MAX) {
        int d = 0;
        if (n.v[0] & 1) {
            d = (int)(n.v[0] & 31);           /* mod 2^(w+1) = 32 */
            if (d > 16) d -= 32;
            u256 dd = {{ (uint64_t)(d > 0 ? d : -d), 0, 0, 0 }};
            if (d > 0) u256_sub_raw(&n, &n, &dd);
            else       u256_add_raw(&n, &n, &dd);
        }
        digits[len++] = (int8_t)d;
        /* n >>= 1 */
        for (int i = 0; i < 4; i++)
            n.v[i] = (n.v[i] >> 1) | (i < 3 ? n.v[i + 1] << 63 : 0);
    }
    return len;
}

#define DEF_GLV(NAME, PT, FE_IS_ZERO, FE_NEG_Y, ENDO)                     \
static void NAME##_scalar_mul_glv(PT *r, const PT *p, const u256 *k) {    \
    /* decomposition is correct mod r for ANY 256-bit k; the half-      \
     * scalar bound |ki| < 2^127 is analytical (see glv_decompose) */    \
    if (u256_is_zero(k)) { memset(r, 0, sizeof(*r)); return; }            \
    if (FE_IS_ZERO(&p->z)) { *r = *p; return; }                           \
    u256 a1, a2;                                                          \
    int s1, s2;                                                           \
    glv_decompose(k, &a1, &s1, &a2, &s2);                                 \
    PT base1 = *p, base2;                                                 \
    ENDO(&base2, p);                                                      \
    if (s1) FE_NEG_Y(&base1.y, &base1.y);                                 \
    if (s2) FE_NEG_Y(&base2.y, &base2.y);                                 \
    /* odd-multiple tables 1P..15P */                                     \
    PT t1[8], t2[8], d1, d2;                                              \
    t1[0] = base1; t2[0] = base2;                                         \
    NAME##_double(&d1, &base1);                                           \
    NAME##_double(&d2, &base2);                                           \
    for (int i = 1; i < 8; i++) {                                         \
        NAME##_add(&t1[i], &t1[i - 1], &d1);                              \
        NAME##_add(&t2[i], &t2[i - 1], &d2);                              \
    }                                                                     \
    int8_t n1[GLV_WNAF_MAX], n2[GLV_WNAF_MAX];                            \
    int l1 = glv_wnaf(n1, &a1), l2 = glv_wnaf(n2, &a2);                   \
    int len = l1 > l2 ? l1 : l2;                                          \
    PT res, tmp;                                                          \
    memset(&res, 0, sizeof(res));                                         \
    for (int i = len - 1; i >= 0; i--) {                                  \
        NAME##_double(&res, &res);                                        \
        int d = i < l1 ? n1[i] : 0;                                       \
        if (d > 0) NAME##_add(&res, &res, &t1[d >> 1]);                   \
        else if (d < 0) {                                                 \
            tmp = t1[(-d) >> 1];                                          \
            FE_NEG_Y(&tmp.y, &tmp.y);                                     \
            NAME##_add(&res, &res, &tmp);                                 \
        }                                                                 \
        d = i < l2 ? n2[i] : 0;                                           \
        if (d > 0) NAME##_add(&res, &res, &t2[d >> 1]);                   \
        else if (d < 0) {                                                 \
            tmp = t2[(-d) >> 1];                                          \
            FE_NEG_Y(&tmp.y, &tmp.y);                                     \
            NAME##_add(&res, &res, &tmp);                                 \
        }                                                                 \
    }                                                                     \
    *r = res;                                                             \
}

static void g1_endo(g1_t *r, const g1_t *p) {
    fq_mul(&r->x, &p->x, &BETA_G1_M);
    r->y = p->y;
    r->z = p->z;
}

static void g2_endo(g2_t *r, const g2_t *p) {
    fq_mul(&r->x.c0, &p->x.c0, &BETA_G2_M);
    fq_mul(&r->x.c1, &p->x.c1, &BETA_G2_M);
    r->y = p->y;
    r->z = p->z;
}

DEF_GLV(g1, g1_t, fq_is_zero_w, fq_neg, g1_endo)
DEF_GLV(g2, g2_t, fq2_is_zero, fq2_neg, g2_endo)

/* to_affine: one inversion (mod.rs:198-217); returns 0 for infinity */
static int g1_to_affine(fq *ax, fq *ay, const g1_t *p) {
    if (u256_is_zero(&p->z)) return 0;
    fq zi, zi2, zi3;
    fq_inv(&zi, &p->z);
    fq_sqr(&zi2, &zi);
    fq_mul(&zi3, &zi2, &zi);
    fq_mul(ax, &p->x, &zi2);
    fq_mul(ay, &p->y, &zi3);
    return 1;
}

static int g2_to_affine(fq2 *ax, fq2 *ay, const g2_t *p) {
    if (fq2_is_zero(&p->z)) return 0;
    fq2 zi, zi2, zi3;
    fq2_inv(&zi, &p->z);
    fq2_sqr(&zi2, &zi);
    fq2_mul(&zi3, &zi2, &zi);
    fq2_mul(ax, &p->x, &zi2);
    fq2_mul(ay, &p->y, &zi3);
    return 1;
}

/* ------------------------------------------------------------------ */
/* Pairing engine (groups/mod.rs:515-777, 894-926)                    */
/* ------------------------------------------------------------------ */

typedef struct { fq2 ell_0, ell_vw, ell_vv; } ellcoeffs;
#define N_COEFFS 87

/* one doubling step (mod.rs:754-776) */
static void doubling_step(g2_t *rp, ellcoeffs *c) {
    fq2 a, b, cc, d, e, f, g, h, i, j, e_sq, t;
    fq2_mul(&a, &rp->x, &rp->y);
    fq2_scale(&a, &a, &TWO_INV_M.c0);
    fq2_sqr(&b, &rp->y);
    fq2_sqr(&cc, &rp->z);
    fq2_add(&d, &cc, &cc);
    fq2_add(&d, &d, &cc);
    fq2_mul(&e, &B2_M, &d);
    fq2_add(&f, &e, &e);
    fq2_add(&f, &f, &e);
    fq2_add(&g, &b, &f);
    fq2_scale(&g, &g, &TWO_INV_M.c0);
    fq2_add(&h, &rp->y, &rp->z);
    fq2_sqr(&h, &h);
    fq2_add(&t, &b, &cc);
    fq2_sub(&h, &h, &t);
    fq2_sub(&i, &e, &b);
    fq2_sqr(&j, &rp->x);
    fq2_sqr(&e_sq, &e);

    fq2_sub(&t, &b, &f);
    fq2_mul(&rp->x, &a, &t);
    fq2_sqr(&t, &g);
    fq2 t3;
    fq2_add(&t3, &e_sq, &e_sq);
    fq2_add(&t3, &t3, &e_sq);
    fq2_sub(&rp->y, &t, &t3);
    fq2_mul(&rp->z, &b, &h);

    fq2_mul_by_xi(&c->ell_0, &i);
    fq2_neg(&c->ell_vw, &h);
    fq2_add(&c->ell_vv, &j, &j);
    fq2_add(&c->ell_vv, &c->ell_vv, &j);
}

/* mixed addition step vs affine base (mod.rs:731-752) */
static void addition_step(g2_t *rp, const fq2 *bx, const fq2 *by,
                          ellcoeffs *c) {
    fq2 d, e, f, g, h, i, j, t, u;
    fq2_mul(&t, &rp->z, bx);
    fq2_sub(&d, &rp->x, &t);
    fq2_mul(&t, &rp->z, by);
    fq2_sub(&e, &rp->y, &t);
    fq2_sqr(&f, &d);
    fq2_sqr(&g, &e);
    fq2_mul(&h, &d, &f);
    fq2_mul(&i, &rp->x, &f);
    fq2_mul(&j, &rp->z, &g);
    fq2_add(&j, &j, &h);
    fq2_add(&t, &i, &i);
    fq2_sub(&j, &j, &t);

    fq2_mul(&rp->x, &d, &j);
    fq2_sub(&t, &i, &j);
    fq2_mul(&t, &e, &t);
    fq2_mul(&u, &h, &rp->y);
    fq2_sub(&rp->y, &t, &u);
    fq2_mul(&rp->z, &rp->z, &h);

    fq2_mul(&t, &e, bx);
    fq2_mul(&u, &d, by);
    fq2_sub(&t, &t, &u);
    fq2_mul_by_xi(&c->ell_0, &t);
    c->ell_vw = d;
    fq2_neg(&c->ell_vv, &e);
}

/* Frobenius on affine G2 via twist factors (mod.rs:693-699) */
static void mul_by_q(fq2 *rx, fq2 *ry, const fq2 *x, const fq2 *y) {
    fq2 t;
    fq2_conj(&t, x);
    fq2_mul(rx, &TWIST_QX_M, &t);
    fq2_conj(&t, y);
    fq2_mul(ry, &TWIST_QY_M, &t);
}

/* 87-coefficient precompute (mod.rs:701-728) */
static void precompute(ellcoeffs coeffs[N_COEFFS], const fq2 *qx,
                       const fq2 *qy) {
    g2_t r;
    r.x = *qx; r.y = *qy;
    memset(&r.z, 0, sizeof(r.z));
    r.z.c0 = FQ_ONE_M;
    fq2 qny;
    fq2_neg(&qny, qy);
    int idx = 0;
    for (int s = 0; s < 64; s++) {
        doubling_step(&r, &coeffs[idx++]);
        if (ATE_NAF[s] == 1) addition_step(&r, qx, qy, &coeffs[idx++]);
        else if (ATE_NAF[s] == -1) addition_step(&r, qx, &qny, &coeffs[idx++]);
    }
    fq2 q1x, q1y, q2x, q2y;
    mul_by_q(&q1x, &q1y, qx, qy);
    mul_by_q(&q2x, &q2y, &q1x, &q1y);
    fq2_neg(&q2y, &q2y);
    addition_step(&r, &q1x, &q1y, &coeffs[idx++]);
    addition_step(&r, &q2x, &q2y, &coeffs[idx++]);
}

static void fold_line(fq12 *f, const ellcoeffs *c, const fq *px,
                      const fq *py) {
    fq2 vw, vv;
    fq2_scale(&vw, &c->ell_vw, py);
    fq2_scale(&vv, &c->ell_vv, px);
    fq12_mul_by_024(f, f, &c->ell_0, &vv, &vw);
}

/* shared-accumulator batch Miller loop (mod.rs:609-640) */
static void miller_loop_batch_m(fq12 *f, int n, const ellcoeffs *coeffs,
                                const fq *pxs, const fq *pys) {
    fq12_one(f);
    int idx = 0;
    for (int s = 0; s < 64; s++) {
        fq12_sqr(f, f);
        for (int t = 0; t < n; t++)
            fold_line(f, &coeffs[t * N_COEFFS + idx], &pxs[t], &pys[t]);
        idx++;
        if (ATE_NAF[s] != 0) {
            for (int t = 0; t < n; t++)
                fold_line(f, &coeffs[t * N_COEFFS + idx], &pxs[t], &pys[t]);
            idx++;
        }
    }
    for (int t = 0; t < n; t++)
        fold_line(f, &coeffs[t * N_COEFFS + idx], &pxs[t], &pys[t]);
    idx++;
    for (int t = 0; t < n; t++)
        fold_line(f, &coeffs[t * N_COEFFS + idx], &pxs[t], &pys[t]);
}

/* ------------------------------------------------------------------ */
/* Init + exported canonical-ABI functions                            */
/* ------------------------------------------------------------------ */

static void fq2_to_mont(fq2 *r, const cfq2 *a) {
    fq_to_mont(&r->c0, &a->c0);
    fq_to_mont(&r->c1, &a->c1);
}

void bn254_init(void) {
    u256 two = {{2, 0, 0, 0}};
    FQ_P_MINUS_2 = FQ_P;
    u256_sub_raw(&FQ_P_MINUS_2, &FQ_P, &two);
    u256_sub_raw(&FR_P_MINUS_2, &FR_P, &two);
    FQ_ONE_M = FQ_RR;
    fq2_to_mont(&XI_M, &C_XI);
    fq2_to_mont(&B2_M, &C_B2);
    fq2_to_mont(&G2X_M, &C_G2X);
    fq2_to_mont(&G2Y_M, &C_G2Y);
    fq2_to_mont(&TWIST_QX_M, &C_TWIST_QX);
    fq2_to_mont(&TWIST_QY_M, &C_TWIST_QY);
    fq2_to_mont(&TWO_INV_M, &C_FQ_TWO_INV);
    for (int i = 0; i < 4; i++) {
        fq2_to_mont(&FROB6_C1_M[i], &C_FROB6_C1[i]);
        fq2_to_mont(&FROB6_C2_M[i], &C_FROB6_C2[i]);
        fq2_to_mont(&FROB12_C1_M[i], &C_FROB12_C1[i]);
    }
    fq_to_mont(&BETA_G1_M, &C_GLV_BETA_G1);
    fq_to_mont(&BETA_G2_M, &C_GLV_BETA_G2);
}

/* canonical <-> internal marshalling */
static void load_g1(g1_t *r, const uint64_t *in) {
    fq_to_mont(&r->x, (const u256 *)in);
    fq_to_mont(&r->y, (const u256 *)(in + 4));
    fq_to_mont(&r->z, (const u256 *)(in + 8));
}

static void store_g1(uint64_t *out, const g1_t *p) {
    fq_from_mont((u256 *)out, &p->x);
    fq_from_mont((u256 *)(out + 4), &p->y);
    fq_from_mont((u256 *)(out + 8), &p->z);
}

static void load_fq2(fq2 *r, const uint64_t *in) {
    fq_to_mont(&r->c0, (const u256 *)in);
    fq_to_mont(&r->c1, (const u256 *)(in + 4));
}

static void store_fq2(uint64_t *out, const fq2 *a) {
    fq_from_mont((u256 *)out, &a->c0);
    fq_from_mont((u256 *)(out + 4), &a->c1);
}

static void load_g2(g2_t *r, const uint64_t *in) {
    load_fq2(&r->x, in);
    load_fq2(&r->y, in + 8);
    load_fq2(&r->z, in + 16);
}

static void store_g2(uint64_t *out, const g2_t *p) {
    store_fq2(out, &p->x);
    store_fq2(out + 8, &p->y);
    store_fq2(out + 16, &p->z);
}

static void load_fq12(fq12 *r, const uint64_t *in) {
    load_fq2(&r->c0.c0, in);
    load_fq2(&r->c0.c1, in + 8);
    load_fq2(&r->c0.c2, in + 16);
    load_fq2(&r->c1.c0, in + 24);
    load_fq2(&r->c1.c1, in + 32);
    load_fq2(&r->c1.c2, in + 40);
}

static void store_fq12(uint64_t *out, const fq12 *a) {
    store_fq2(out, &a->c0.c0);
    store_fq2(out + 8, &a->c0.c1);
    store_fq2(out + 16, &a->c0.c2);
    store_fq2(out + 24, &a->c1.c0);
    store_fq2(out + 32, &a->c1.c1);
    store_fq2(out + 40, &a->c1.c2);
}

void bn254_fq_mul(const uint64_t *a, const uint64_t *b, uint64_t *out) {
    fq am, bm, rm;
    fq_to_mont(&am, (const u256 *)a);
    fq_to_mont(&bm, (const u256 *)b);
    fq_mul(&rm, &am, &bm);
    fq_from_mont((u256 *)out, &rm);
}

void bn254_fq_inv(const uint64_t *a, uint64_t *out) {
    fq am, rm;
    fq_to_mont(&am, (const u256 *)a);
    fq_inv(&rm, &am);
    fq_from_mont((u256 *)out, &rm);
}

void bn254_fr_mul(const uint64_t *a, const uint64_t *b, uint64_t *out) {
    u256 am, bm, rm;
    mont_mul(&am, (const u256 *)a, &FR_R2, &FR_P, FR_INV);
    mont_mul(&bm, (const u256 *)b, &FR_R2, &FR_P, FR_INV);
    mont_mul(&rm, &am, &bm, &FR_P, FR_INV);
    u256 one = {{1, 0, 0, 0}};
    mont_mul((u256 *)out, &rm, &one, &FR_P, FR_INV);
}

void bn254_fr_inv(const uint64_t *a, uint64_t *out) {
    u256 am, rm;
    mont_mul(&am, (const u256 *)a, &FR_R2, &FR_P, FR_INV);
    mont_pow(&rm, &am, &FR_P_MINUS_2, &FR_P, FR_INV, &FR_RR);
    u256 one = {{1, 0, 0, 0}};
    mont_mul((u256 *)out, &rm, &one, &FR_P, FR_INV);
}

void bn254_g1_add(const uint64_t *p, const uint64_t *q, uint64_t *out) {
    g1_t pm, qm, rm;
    load_g1(&pm, p);
    load_g1(&qm, q);
    g1_add(&rm, &pm, &qm);
    store_g1(out, &rm);
}

void bn254_g1_mul(const uint64_t *p, const uint64_t *k, uint64_t *out) {
    /* GLV + width-4 wNAF fast path (same group element as the
     * double-and-add oracle; Jacobian representative may differ) */
    g1_t pm, rm;
    load_g1(&pm, p);
    g1_scalar_mul_glv(&rm, &pm, (const u256 *)k);
    store_g1(out, &rm);
}

void bn254_g1_mul_oracle(const uint64_t *p, const uint64_t *k,
                         uint64_t *out) {
    g1_t pm, rm;
    load_g1(&pm, p);
    g1_scalar_mul(&rm, &pm, (const u256 *)k);
    store_g1(out, &rm);
}

void bn254_g2_add(const uint64_t *p, const uint64_t *q, uint64_t *out) {
    g2_t pm, qm, rm;
    load_g2(&pm, p);
    load_g2(&qm, q);
    g2_add(&rm, &pm, &qm);
    store_g2(out, &rm);
}

void bn254_g2_mul(const uint64_t *p, const uint64_t *k, uint64_t *out) {
    g2_t pm, rm;
    load_g2(&pm, p);
    g2_scalar_mul_glv(&rm, &pm, (const u256 *)k);
    store_g2(out, &rm);
}

void bn254_g2_mul_oracle(const uint64_t *p, const uint64_t *k,
                         uint64_t *out) {
    g2_t pm, rm;
    load_g2(&pm, p);
    g2_scalar_mul(&rm, &pm, (const u256 *)k);
    store_g2(out, &rm);
}

void bn254_fq12_mul(const uint64_t *a, const uint64_t *b, uint64_t *out) {
    fq12 am, bm, rm;
    load_fq12(&am, a);
    load_fq12(&bm, b);
    fq12_mul(&rm, &am, &bm);
    store_fq12(out, &rm);
}

void bn254_fq12_pow(const uint64_t *a, const uint64_t *e, uint64_t *out) {
    fq12 am, res;
    load_fq12(&am, a);
    fq12_one(&res);
    const u256 *ee = (const u256 *)e;
    int started = 0;
    for (int i = 255; i >= 0; i--) {
        if (started) fq12_sqr(&res, &res);
        if ((ee->v[i / 64] >> (i % 64)) & 1) {
            fq12_mul(&res, &res, &am);
            started = 1;
        }
    }
    store_fq12(out, &res);
}

void bn254_final_exp(const uint64_t *f, uint64_t *out) {
    fq12 fm, rm;
    load_fq12(&fm, f);
    fq12_final_exp(&rm, &fm);
    store_fq12(out, &rm);
}

/* miller-only batch over (G2, G1) pairs; returns -1 on an infinity point
 * (lib.rs:625-633 semantics), 0 on success. */
typedef struct {
    ellcoeffs *coeffs;
    fq *pxs, *pys;
} batch_buf;

static int batch_alloc(batch_buf *b, int n) {
    b->coeffs = malloc(sizeof(ellcoeffs) * (size_t)n * N_COEFFS);
    b->pxs = malloc(sizeof(fq) * (size_t)n);
    b->pys = malloc(sizeof(fq) * (size_t)n);
    if (!b->coeffs || !b->pxs || !b->pys) {
        free(b->coeffs); free(b->pxs); free(b->pys);
        return 0;
    }
    return 1;
}

static void batch_free(batch_buf *b) {
    free(b->coeffs); free(b->pxs); free(b->pys);
}

int bn254_miller_loop_batch(int n, const uint64_t *qs, const uint64_t *ps,
                            uint64_t *out) {
    if (n < 0) return -2;
    fq12 f;
    if (n == 0) {                 /* 64 squarings of 1 are still 1 */
        fq12_one(&f);
        store_fq12(out, &f);
        return 0;
    }
    batch_buf b;
    if (!batch_alloc(&b, n)) return -3;
    for (int t = 0; t < n; t++) {
        g2_t q;
        g1_t p;
        load_g2(&q, qs + 24 * t);
        load_g1(&p, ps + 12 * t);
        fq2 qx, qy;
        if (!g2_to_affine(&qx, &qy, &q) ||
            !g1_to_affine(&b.pxs[t], &b.pys[t], &p)) {
            batch_free(&b);
            return -1;
        }
        precompute(&b.coeffs[t * N_COEFFS], &qx, &qy);
    }
    miller_loop_batch_m(&f, n, b.coeffs, b.pxs, b.pys);
    store_fq12(out, &f);
    batch_free(&b);
    return 0;
}

/* slice worker: to_affine + precompute + Miller product over pairs
 * [lo, hi); infinity pairs silently skipped (mod.rs:911-920).  Writes
 * into the CALLER's batch_buf at slice-local offsets (disjoint per
 * slice, so slices run in parallel).  Returns the slice's live count;
 * *f is the slice's un-exponentiated Miller product (1 if empty). */
static int pairing_batch_slice(fq12 *f, batch_buf *b, int lo, int hi,
                               const uint64_t *ps, const uint64_t *qs) {
    int live = 0;
    for (int t = lo; t < hi; t++) {
        g1_t p;
        g2_t q;
        load_g1(&p, ps + 12 * t);
        load_g2(&q, qs + 24 * t);
        fq px, py;
        fq2 qx, qy;
        if (!g1_to_affine(&px, &py, &p)) continue;
        if (!g2_to_affine(&qx, &qy, &q)) continue;
        b->pxs[lo + live] = px;
        b->pys[lo + live] = py;
        precompute(&b->coeffs[(lo + live) * N_COEFFS], &qx, &qy);
        live++;
    }
    if (live == 0)
        fq12_one(f);
    else
        miller_loop_batch_m(f, live, &b->coeffs[lo * N_COEFFS],
                            &b->pxs[lo], &b->pys[lo]);
    return live;
}

/* reduced pairing batch with silent infinity skip (mod.rs:904-926).
 *
 * Parallelism (beyond the single-threaded reference): the Miller
 * product splits exactly across any partition of the pairs — each
 * OpenMP thread computes its slice's shared-squaring Miller product,
 * the partials multiply, and ONE final exponentiation finishes.  The
 * only extra work vs serial is one 64-squaring chain per extra slice
 * (negligible beyond a few dozen pairs). */
#define BN254_OMP_MIN_PER_THREAD 16
#define BN254_MAX_THREADS 64

int bn254_pairing_batch(int n, const uint64_t *ps, const uint64_t *qs,
                        uint64_t *out) {
    if (n < 0) return -2;
    fq12 f, r;
    batch_buf b;
    if (n > 0 && !batch_alloc(&b, n)) return -3;

    int nthreads = 1;
#ifdef _OPENMP
    nthreads = omp_get_max_threads();
    if (nthreads > n / BN254_OMP_MIN_PER_THREAD)
        nthreads = n / BN254_OMP_MIN_PER_THREAD;
    if (nthreads > BN254_MAX_THREADS) nthreads = BN254_MAX_THREADS;
    if (nthreads < 1) nthreads = 1;
#endif

    if (nthreads == 1) {
        int live = pairing_batch_slice(&f, &b, 0, n, ps, qs);
        if (live == 0) {
            fq12_one(&r);
            store_fq12(out, &r);
            if (n > 0) batch_free(&b);
            return 0;
        }
    } else {
#ifdef _OPENMP
        fq12 partials[BN254_MAX_THREADS];
        int lives[BN254_MAX_THREADS];
#pragma omp parallel num_threads(nthreads)
        {
            int tid = omp_get_thread_num();
            int lo = (int)((long)n * tid / nthreads);
            int hi = (int)((long)n * (tid + 1) / nthreads);
            lives[tid] = pairing_batch_slice(&partials[tid], &b, lo, hi,
                                             ps, qs);
        }
        int any = 0;
        fq12_one(&f);
        for (int t = 0; t < nthreads; t++) {
            if (!lives[t]) continue;
            fq12_mul(&f, &f, &partials[t]);
            any = 1;
        }
        if (!any) {
            fq12_one(&r);
            store_fq12(out, &r);
            batch_free(&b);
            return 0;
        }
#endif
    }
    fq12_final_exp(&r, &f);
    store_fq12(out, &r);
    batch_free(&b);
    return 0;
}

int bn254_pairing(const uint64_t *p, const uint64_t *q, uint64_t *out) {
    return bn254_pairing_batch(1, p, q, out);
}

/* Pippenger MSM over G1 — the host-side oracle for the device MSM at
 * sizes where the Python spec is too slow (ROADMAP item 10).  Window
 * width 8, windows parallel under OpenMP (each window's buckets are
 * private); classic running-sum reduction + Horner.  Inputs/outputs in
 * the canonical-ABI Jacobian format of the other entry points. */
int bn254_msm_g1(int n, const uint64_t *ps, const uint64_t *ks,
                 uint64_t *out) {
    g1_t res;
    memset(&res, 0, sizeof(res));
    if (n <= 0) {
        store_g1(out, &res);
        return 0;
    }
    g1_t *pts = (g1_t *)malloc((size_t)n * sizeof(g1_t));
    if (!pts) return -3;
    for (int t = 0; t < n; t++) load_g1(&pts[t], ps + 12 * t);
    enum { MSM_W = 32, MSM_NB = 256 };
    g1_t windows[MSM_W];
#ifdef _OPENMP
#pragma omp parallel for schedule(dynamic)
#endif
    for (int w = 0; w < MSM_W; w++) {
        g1_t buckets[MSM_NB - 1];
        memset(buckets, 0, sizeof(buckets));
        for (int t = 0; t < n; t++) {
            const uint64_t *k = ks + 4 * t;
            unsigned d = (unsigned)((k[w / 8] >> ((w % 8) * 8)) & 0xff);
            if (d) g1_add(&buckets[d - 1], &buckets[d - 1], &pts[t]);
        }
        g1_t acc, tot;
        memset(&acc, 0, sizeof(acc));
        memset(&tot, 0, sizeof(tot));
        for (int b = MSM_NB - 2; b >= 0; b--) {
            g1_add(&acc, &acc, &buckets[b]);
            g1_add(&tot, &tot, &acc);
        }
        windows[w] = tot;
    }
    res = windows[MSM_W - 1];
    for (int w = MSM_W - 2; w >= 0; w--) {
        for (int i = 0; i < 8; i++) g1_double(&res, &res);
        g1_add(&res, &res, &windows[w]);
    }
    free(pts);
    store_g1(out, &res);
    return 0;
}

/* Same Pippenger over the twist G2 (24 u64 per point). */
int bn254_msm_g2(int n, const uint64_t *ps, const uint64_t *ks,
                 uint64_t *out) {
    g2_t res;
    memset(&res, 0, sizeof(res));
    if (n <= 0) {
        store_g2(out, &res);
        return 0;
    }
    g2_t *pts = (g2_t *)malloc((size_t)n * sizeof(g2_t));
    if (!pts) return -3;
    for (int t = 0; t < n; t++) load_g2(&pts[t], ps + 24 * t);
    enum { MSM_W = 32, MSM_NB = 256 };
    g2_t windows[MSM_W];
#ifdef _OPENMP
#pragma omp parallel for schedule(dynamic)
#endif
    for (int w = 0; w < MSM_W; w++) {
        g2_t buckets[MSM_NB - 1];
        memset(buckets, 0, sizeof(buckets));
        for (int t = 0; t < n; t++) {
            const uint64_t *k = ks + 4 * t;
            unsigned d = (unsigned)((k[w / 8] >> ((w % 8) * 8)) & 0xff);
            if (d) g2_add(&buckets[d - 1], &buckets[d - 1], &pts[t]);
        }
        g2_t acc, tot;
        memset(&acc, 0, sizeof(acc));
        memset(&tot, 0, sizeof(tot));
        for (int b = MSM_NB - 2; b >= 0; b--) {
            g2_add(&acc, &acc, &buckets[b]);
            g2_add(&tot, &tot, &acc);
        }
        windows[w] = tot;
    }
    res = windows[MSM_W - 1];
    for (int w = MSM_W - 2; w >= 0; w--) {
        for (int i = 0; i < 8; i++) g2_double(&res, &res);
        g2_add(&res, &res, &windows[w]);
    }
    free(pts);
    store_g2(out, &res);
    return 0;
}
