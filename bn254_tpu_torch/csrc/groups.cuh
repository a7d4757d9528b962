// Jacobian group law of G1 (over Fq) and G2 (over Fq2), generic on the
// coordinate field F.
//
// Counterpart of bn254_tpu/pallas_fused.py's k_point_double,
// k_point_add, k_point_madd_generic and k_affine_double, with the same
// formulas in the same order as bn254_tpu/groups.py.  Every value is a
// fully reduced residue after each op (bn254.cuh), so each output is the
// JAX package's canonical limbs bit for bit.  A point at infinity is any
// point with z == 0; (0, 0, 0) is what an empty bucket holds.
#pragma once

#include "bn254.cuh"

namespace bn254 {

template <class F> struct Jac { F x, y, z; };

// coordinates per field element: 1 for Fq, 2 for Fq2
template <class F> constexpr int kCoords = sizeof(F) / sizeof(Fq);

// ---------------------------------------------------------------------------
// Memory: a point is coordinates (x, y, z) at c, c + C, c + 2C (C = coords)
// ---------------------------------------------------------------------------

template <class F>
__device__ __forceinline__ void load_pt(Jac<F>& p, const int32_t* base, int B, int lane) {
  constexpr int C = kCoords<F>;
  load(p.x, base, 0, B, lane);
  load(p.y, base, C, B, lane);
  load(p.z, base, 2 * C, B, lane);
}

template <class F>
__device__ __forceinline__ void store_pt(int32_t* base, int B, int lane, const Jac<F>& p) {
  constexpr int C = kCoords<F>;
  store(base, 0, B, lane, p.x);
  store(base, C, B, lane, p.y);
  store(base, 2 * C, B, lane, p.z);
}

// ---------------------------------------------------------------------------
// Group law.  point_double and point_add are __noinline__ templates, so a
// kernel that loops over them compiles each body once and passes points
// through the stack.  For G1 (Fq) the two overloads below them inline the
// bodies instead: 0-192 B of stack, 72-174 registers and 3-20 % faster in
// every G1 kernel that calls them (k_point_add, k_point_double,
// k_msm_combine, k_point_mul) but k_msm_bucket_reduce,
// whose two adds a step took 230 registers inlined and ran at half the
// speed: it calls point_add<F>, the __noinline__ template, by name.  G2
// keeps the calls (inlining them was not tried).
// ---------------------------------------------------------------------------

// dbl-2009-l (groups.double, k_point_double); the identity stays the
// identity (z stays 0)
template <class F>
__device__ __forceinline__ void point_double_inl(Jac<F>& r, const Jac<F>& p) {
  F a, b, c, d, e, f, t, x3, y3, z3;
  f_sqr(a, p.x);
  f_sqr(b, p.y);
  f_sqr(c, b);
  f_add(t, p.x, b);
  f_sqr(d, t);
  f_sub(d, d, a);
  f_sub(d, d, c);
  f_add(d, d, d);
  f_add(e, a, a);
  f_add(e, e, a);
  f_sqr(f, e);
  f_add(t, d, d);
  f_sub(x3, f, t);
  f_add(c, c, c);
  f_add(c, c, c);
  f_add(c, c, c);
  f_sub(t, d, x3);
  f_mul(y3, e, t);
  f_sub(y3, y3, c);
  f_mul(z3, p.y, p.z);
  f_add(z3, z3, z3);
  r.x = x3; r.y = y3; r.z = z3;
}

template <class F>
static __device__ __noinline__ void point_double(Jac<F>& r, const Jac<F>& p) {
  point_double_inl(r, p);
}
__device__ __forceinline__ void point_double(Jac<Fq>& r, const Jac<Fq>& p) {
  point_double_inl(r, p);
}

// Unified add (groups.add, k_point_add): the generic formula, then the
// three-way select in the JAX package's order — coincide -> double(p),
// q at infinity -> p, p at infinity -> q.  The double is computed only
// on coincide lanes: the select takes it nowhere else.
template <class F>
__device__ __forceinline__ void point_add_inl(Jac<F>& r, const Jac<F>& p, const Jac<F>& q) {
  const bool p_inf = f_is_zero(p.z), q_inf = f_is_zero(q.z);
  F z1s, z2s, u1, u2, z1c, z2c, s1, s2, h, rr, i, j, v, t;
  Jac<F> out;
  f_sqr(z1s, p.z);
  f_sqr(z2s, q.z);
  f_mul(u1, p.x, z2s);
  f_mul(u2, q.x, z1s);
  f_mul(z1c, p.z, z1s);
  f_mul(z2c, q.z, z2s);
  f_mul(s1, p.y, z2c);
  f_mul(s2, q.y, z1c);
  const bool coincide = f_eq(u1, u2) && f_eq(s1, s2) && !p_inf && !q_inf;

  f_sub(h, u2, u1);
  f_sub(rr, s2, s1);
  f_add(rr, rr, rr);
  f_add(t, h, h);
  f_sqr(i, t);
  f_mul(j, h, i);
  f_mul(v, u1, i);
  f_sqr(out.x, rr);
  f_sub(out.x, out.x, j);
  f_add(t, v, v);
  f_sub(out.x, out.x, t);
  f_sub(t, v, out.x);
  f_mul(out.y, rr, t);
  f_mul(t, s1, j);
  f_add(t, t, t);
  f_sub(out.y, out.y, t);
  f_add(t, p.z, q.z);
  f_sqr(out.z, t);
  f_sub(out.z, out.z, z1s);
  f_sub(out.z, out.z, z2s);
  f_mul(out.z, out.z, h);

  if (coincide) point_double<F>(out, p);   // the __noinline__ template: a rare branch
  if (q_inf) out = p;
  if (p_inf) out = q;
  r = out;
}

template <class F>
static __device__ __noinline__ void point_add(Jac<F>& r, const Jac<F>& p, const Jac<F>& q) {
  point_add_inl(r, p, q);
}
__device__ __forceinline__ void point_add(Jac<Fq>& r, const Jac<Fq>& p, const Jac<Fq>& q) {
  point_add_inl(r, p, q);
}

// Mixed add of an affine q without the doubling branch
// (k_point_madd_generic).  Returns coincide: that lane's r is wrong
// (z3 = 0) and the caller must take affine_double(q) instead.  Inlined
// into the MSM accumulate's loop, so the bucket stays in registers.
template <class F>
__device__ __forceinline__ bool point_madd_generic(Jac<F>& r, const Jac<F>& p, const F& qx,
                                                      const F& qy) {
  const bool p_inf = f_is_zero(p.z);
  F z1s, u2, s2, h, rr, i, j, v, t;
  Jac<F> out;
  f_sqr(z1s, p.z);
  f_mul(u2, qx, z1s);
  f_mul(t, p.z, z1s);
  f_mul(s2, qy, t);
  const bool coincide = f_eq(p.x, u2) && f_eq(p.y, s2) && !p_inf;

  f_sub(h, u2, p.x);
  f_sub(rr, s2, p.y);
  f_add(rr, rr, rr);
  f_add(t, h, h);
  f_sqr(i, t);
  f_mul(j, h, i);
  f_mul(v, p.x, i);
  f_sqr(out.x, rr);
  f_sub(out.x, out.x, j);
  f_add(t, v, v);
  f_sub(out.x, out.x, t);
  f_sub(t, v, out.x);
  f_mul(out.y, rr, t);
  f_mul(t, p.y, j);
  f_add(t, t, t);
  f_sub(out.y, out.y, t);
  f_mul(out.z, p.z, h);
  f_add(out.z, out.z, out.z);

  if (p_inf) {
    out.x = qx;
    out.y = qy;
    f_set_one(out.z);
  }
  r = out;
  return coincide;
}

// Jacobian double of an affine point, z = 1 (k_affine_double): the madd's
// coincide branch
template <class F>
static __device__ __noinline__ void affine_double(Jac<F>& r, const F& qx, const F& qy) {
  F a, b, c, d, e, f, t;
  Jac<F> out;
  f_sqr(a, qx);
  f_sqr(b, qy);
  f_sqr(c, b);
  f_add(t, qx, b);
  f_sqr(d, t);
  f_sub(d, d, a);
  f_sub(d, d, c);
  f_add(d, d, d);
  f_add(e, a, a);
  f_add(e, e, a);
  f_sqr(f, e);
  f_add(t, d, d);
  f_sub(out.x, f, t);
  f_add(c, c, c);
  f_add(c, c, c);
  f_add(c, c, c);
  f_sub(t, d, out.x);
  f_mul(out.y, e, t);
  f_sub(out.y, out.y, c);
  f_add(out.z, qy, qy);
  r = out;
}

}  // namespace bn254
