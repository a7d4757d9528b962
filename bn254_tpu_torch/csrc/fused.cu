// Fused tower-op kernels (queue rows 5-11, 13-16), replacing the
// bn254_tpu/pallas_fused.py kernels named beside each one below.
//
// One thread per batch lane, 128-thread blocks, the ragged edge masked,
// except k_fq12_cyc_pow (below).  A kernel reads its operands once, runs
// the whole formula (or the whole ladder / Miller schedule) with every
// intermediate on the thread's registers and stack, and writes its
// result once, as the TPU kernels keep theirs in VMEM.  Step kinds and
// ladder digits come as a small int32 device array that every lane reads
// in the same order, so a warp never diverges on them.
//
// Bound: integer multiply-adds (an Fq12 product is 54 Montgomery
// products, about 7,000 32x32->64 multiply-adds) and the local-memory
// traffic of the tower state (f alone is 12 Fq = 96 words, past what the
// register file gives one thread, and the __noinline__ tower functions
// pass their arguments through the stack).  ptxas gives fq_pow 40
// registers and no stack, but the one-thread Fq12 kernels 138-236
// registers and 1-3 KB stack frames, so only two or three 128-thread
// blocks fit an SM (H100 80GB HBM3, 700 W).
//
// k_fq12_cyc_pow (row 11, the final exponentiation's three z-ladders,
// about 2,360 Montgomery products a lane) runs a team of six threads of
// one warp per lane (fq12_team.cuh), five lanes to a warp, 20 lanes to a
// 128-thread block.  res and a sit in shared memory (2,400 bytes a lane
// with the product scratch, 48,000 a block); per digit the team computes
// the cyclotomic square's 6 Fq2 products (one a thread), exchanges them,
// and each thread writes one new coefficient; a nonzero digit adds the
// Fq12 product's 18 (three a thread), with conj(a) read by negating a.c1.
// At B = 16384 that is 98,304 threads.  Bound: the products; the team
// adds the coefficient steps' adds and leaves 2 threads of 32 idle.
// ptxas (sm_90a): 205 registers, no stack, so 8 warps on an SM; lower
// register caps spill to the stack and run slower (regcap_sweep.py,
// PERF.md).
#include "bn254.cuh"
#include "fq12_team.cuh"

using namespace bn254;

namespace {

// pallas_fused.py _pow_call_impl("fq_pow"): res = a; per digit square,
// then multiply by a on a set bit.
__global__ void k_fq_pow(const int32_t* __restrict__ digits, int n,
                         const int32_t* __restrict__ a, int32_t* __restrict__ out, int B) {
  int lane = lane_index();
  if (lane >= B) return;
  Fq base, res;
  load(base, a, 0, B, lane);
  res = base;
  for (int i = 0; i < n; ++i) {
    fq_mul(res, res, res);
    if (digits[i]) fq_mul(res, res, base);
  }
  store(out, 0, B, lane, res);
}

// pallas_fused.py _miller_call_impl: the 85 scheduled steps.  kind 0:
// f = f^2 and a doubling step; kind 1/2: mixed addition with +Q/-Q.  Each
// step then folds its line into f.
__global__ void k_miller_precompute(const int32_t* __restrict__ kinds, int n,
                                    const int32_t* __restrict__ p,
                                    const int32_t* __restrict__ q,
                                    int32_t* __restrict__ f_out,
                                    int32_t* __restrict__ r_out, int B) {
  int lane = lane_index();
  if (lane >= B) return;
  Fq px, py;
  load(px, p, 0, B, lane);
  load(py, p, 1, B, lane);
  Fq2 qx, qy, qy_neg;
  load(qx, q, 0, B, lane);
  load(qy, q, 2, B, lane);
  fq2_neg(qy_neg, qy);

  G2J r;
  r.x = qx;
  r.y = qy;
  r.z.c0 = fq_const_one();
  r.z.c1 = fq_const_zero();
  Fq12 f;
  Fq2 zero2;
  zero2.c0 = fq_const_zero();
  zero2.c1 = fq_const_zero();
  f.c0.c0 = r.z;
  f.c0.c1 = zero2; f.c0.c2 = zero2;
  f.c1.c0 = zero2; f.c1.c1 = zero2; f.c1.c2 = zero2;

  Line l;
  for (int i = 0; i < n; ++i) {
    int kind = kinds[i];
    if (kind == 0) {
      fq12_sqr(f, f);
      g2_dbl_step(r, l);
    } else {
      g2_add_step(r, l, qx, kind == 1 ? qy : qy_neg);
    }
    fold_line(f, l, px, py);
  }
  store(f_out, B, lane, f);
  store3(r_out, B, lane, r.x, r.y, r.z);
}

// pallas_fused.py _call_impl("g2_add_step")
__global__ void k_g2_add_step(const int32_t* __restrict__ r_in,
                              const int32_t* __restrict__ base,
                              int32_t* __restrict__ r_out,
                              int32_t* __restrict__ c_out, int B) {
  int lane = lane_index();
  if (lane >= B) return;
  G2J r;
  load3(r.x, r.y, r.z, r_in, B, lane);
  Fq2 bx, by;
  load(bx, base, 0, B, lane);
  load(by, base, 2, B, lane);
  Line l;
  g2_add_step(r, l, bx, by);
  store3(r_out, B, lane, r.x, r.y, r.z);
  store3(c_out, B, lane, l.ell_0, l.ell_vw, l.ell_vv);
}

// pallas_fused.py _call_impl("g2_dbl_step")
__global__ void k_g2_dbl_step(const int32_t* __restrict__ r_in, int32_t* __restrict__ r_out,
                              int32_t* __restrict__ c_out, int B) {
  int lane = lane_index();
  if (lane >= B) return;
  G2J r;
  load3(r.x, r.y, r.z, r_in, B, lane);
  Line l;
  g2_dbl_step(r, l);
  store3(r_out, B, lane, r.x, r.y, r.z);
  store3(c_out, B, lane, l.ell_0, l.ell_vw, l.ell_vv);
}

// pallas_fused.py _call_impl("fq2_mul"): kfq2_mul in its default lazy
// spelling, two Montgomery reductions of 512-bit products (bn254.cuh
// fq2_mul_lazy).  Bound by its bytes, 384 per lane, at one-op batches.
__global__ void k_fq2_mul_fused(const int32_t* __restrict__ a, const int32_t* __restrict__ b,
                                int32_t* __restrict__ out, int B) {
  int lane = lane_index();
  if (lane >= B) return;
  Fq2 x, y;
  load(x, a, 0, B, lane);
  load(y, b, 0, B, lane);
  fq2_mul_lazy(x, x, y);
  store(out, 0, B, lane, x);
}

// pallas_fused.py _call_impl("fq2_sqr"): kfq2_sqr, the eager complex
// square (two CIOS products), as row 4's kernel computes it.
__global__ void k_fq2_sqr_fused(const int32_t* __restrict__ a, int32_t* __restrict__ out,
                                int B) {
  int lane = lane_index();
  if (lane >= B) return;
  Fq2 x;
  load(x, a, 0, B, lane);
  fq2_sqr(x, x);
  store(out, 0, B, lane, x);
}

// pallas_fused.py _call_impl("fq12_sqr")
__global__ void k_fq12_sqr(const int32_t* __restrict__ a, int32_t* __restrict__ out, int B) {
  int lane = lane_index();
  if (lane >= B) return;
  Fq12 x;
  load(x, a, B, lane);
  fq12_sqr(x, x);
  store(out, B, lane, x);
}

// pallas_fused.py _call_impl("fq12_fold_line")
__global__ void k_fq12_fold_line(const int32_t* __restrict__ f_in,
                                 const int32_t* __restrict__ c,
                                 const int32_t* __restrict__ px_in,
                                 const int32_t* __restrict__ py_in,
                                 int32_t* __restrict__ out, int B) {
  int lane = lane_index();
  if (lane >= B) return;
  Fq12 f;
  load(f, f_in, B, lane);
  Line l;
  load3(l.ell_0, l.ell_vw, l.ell_vv, c, B, lane);
  Fq px, py;
  load(px, px_in, 0, B, lane);
  load(py, py_in, 0, B, lane);
  fold_line(f, l, px, py);
  store(out, B, lane, f);
}

// pallas_fused.py _call_impl("fq12_mul")
__global__ void k_fq12_mul(const int32_t* __restrict__ a, const int32_t* __restrict__ b,
                           int32_t* __restrict__ out, int B) {
  int lane = lane_index();
  if (lane >= B) return;
  Fq12 x, y;
  load(x, a, B, lane);
  load(y, b, B, lane);
  fq12_mul(x, x, y);
  store(out, B, lane, x);
}

// pallas_fused.py _call_impl("fq12_cyc_sqr")
__global__ void k_fq12_cyc_sqr(const int32_t* __restrict__ a, int32_t* __restrict__ out, int B) {
  int lane = lane_index();
  if (lane >= B) return;
  Fq12 x;
  load(x, a, B, lane);
  fq12_cyclotomic_sqr(x, x);
  store(out, B, lane, x);
}

// pallas_fused.py _pow_call_impl("fq12_cyc_pow"): res = a; per digit a
// cyclotomic square, then digit 1 multiplies by a, digit 2 by conj(a).
// Thread k of team t of warp v holds coefficient k of lane 5 v + t of the
// block; threads 30 and 31 of each warp, and teams past B, only keep the
// warp's barriers.
constexpr int kTeam = 6, kTeamsPerWarp = 5, kCycWarps = 4;
constexpr int kCycLanes = kTeamsPerWarp * kCycWarps;   // lanes a block

// No __launch_bounds__: it would make nvcc ignore -maxrregcount, which
// regcap_sweep.py sets to time the kernel under register caps.
__global__ void k_fq12_cyc_pow(const int32_t* __restrict__ digits, int n,
                               const int32_t* __restrict__ a, int32_t* __restrict__ out, int B) {
  __shared__ __align__(16) uint32_t s_lanes[kCycLanes * kTeamLaneWords];
  const int warp = threadIdx.x / 32, team = (threadIdx.x % 32) / kTeam;
  const int k = threadIdx.x % 32 - team * kTeam, slot = warp * kTeamsPerWarp + team;
  const int lane = blockIdx.x * kCycLanes + slot;
  const bool active = team < kTeamsPerWarp && lane < B;
  uint32_t* res = s_lanes + (active ? slot : 0) * kTeamLaneWords;
  uint32_t* base = res + 6 * kTeamSlot;
  uint32_t* P = res + 12 * kTeamSlot;
  if (active) {
    Fq2 v;
    load(v, a, 2 * k, B, lane);
    st2_s(res, k, v);
    st2_s(base, k, v);
  }
  __syncwarp();
  for (int i = 0; i < n; ++i) {
    if (active) team_cyc_sqr_products(k, P, res);
    __syncwarp();
    if (active) st2_s(res, k, team_cyc_sqr_coeff(k, P, res));
    __syncwarp();
    const int d = digits[i];
    if (d != 0) {
      if (active) team_fq12_mul_products(k, P, res, base, d == 2);
      __syncwarp();
      if (active) st2_s(res, k, team_fq12_mul_coeff(P, k));
      __syncwarp();
    }
  }
  if (active) store(out, 2 * k, B, lane, ld2_s(res, k));
}

}  // namespace

extern "C" {

int bn254_fq_pow(const int32_t* digits, int n, const int32_t* a, int32_t* out, int B,
                 cudaStream_t stream) {
  BN254_LAUNCH(k_fq_pow, digits, n, a, out);
}

int bn254_miller_precompute(const int32_t* kinds, int n, const int32_t* p, const int32_t* q,
                            int32_t* f, int32_t* r, int B, cudaStream_t stream) {
  BN254_LAUNCH(k_miller_precompute, kinds, n, p, q, f, r);
}

int bn254_g2_add_step(const int32_t* r, const int32_t* base, int32_t* r_out, int32_t* c_out,
                      int B, cudaStream_t stream) {
  BN254_LAUNCH(k_g2_add_step, r, base, r_out, c_out);
}

int bn254_g2_dbl_step(const int32_t* r, int32_t* r_out, int32_t* c_out, int B,
                      cudaStream_t stream) {
  BN254_LAUNCH(k_g2_dbl_step, r, r_out, c_out);
}

int bn254_fq2_mul_fused(const int32_t* a, const int32_t* b, int32_t* out, int B,
                        cudaStream_t stream) {
  BN254_LAUNCH(k_fq2_mul_fused, a, b, out);
}

int bn254_fq2_sqr_fused(const int32_t* a, int32_t* out, int B, cudaStream_t stream) {
  BN254_LAUNCH(k_fq2_sqr_fused, a, out);
}

int bn254_fq12_sqr(const int32_t* a, int32_t* out, int B, cudaStream_t stream) {
  BN254_LAUNCH(k_fq12_sqr, a, out);
}

int bn254_fq12_fold_line(const int32_t* f, const int32_t* c, const int32_t* px,
                         const int32_t* py, int32_t* out, int B, cudaStream_t stream) {
  BN254_LAUNCH(k_fq12_fold_line, f, c, px, py, out);
}

int bn254_fq12_mul(const int32_t* a, const int32_t* b, int32_t* out, int B,
                   cudaStream_t stream) {
  BN254_LAUNCH(k_fq12_mul, a, b, out);
}

int bn254_fq12_cyc_sqr(const int32_t* a, int32_t* out, int B, cudaStream_t stream) {
  BN254_LAUNCH(k_fq12_cyc_sqr, a, out);
}

int bn254_fq12_cyc_pow(const int32_t* digits, int n, const int32_t* a, int32_t* out, int B,
                       cudaStream_t stream) {
  k_fq12_cyc_pow<<<(B + kCycLanes - 1) / kCycLanes, 32 * kCycWarps, 0, stream>>>(digits, n, a,
                                                                                out, B);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
