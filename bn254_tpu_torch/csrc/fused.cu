// Fused tower-op kernels (queue rows 5-11, 13-16), replacing the
// bn254_tpu/pallas_fused.py kernels named beside each one below, the
// final exponentiation's Fq12 inverse and Frobenius maps (k_fq12_inv,
// k_fq12_frob), which replace tower glue around row 3 on the TPU's path,
// the Fq2 square root (k_fq2_sqrt), which replaces the JAX package's
// scans over rows 3-4, the prepared Miller loop (k_miller_loop), which
// replaces its scan over rows 13 and 8, and the 87 G2 lines of the
// prepared-G2 entry (k_g2_precompute), which replace its scan over rows 14
// and 7.
//
// Two designs.  One thread a lane (row 5: k_fq_pow; and k_fq12_inv and
// the codec's Fq2 square root k_fq2_sqrt; k_fq12_frob
// runs one thread a coefficient): 128-thread
// blocks, the ragged edge masked; a kernel reads its operands once, runs
// the whole formula with every intermediate on the thread's registers and
// stack, and writes its result once, as the TPU kernels keep theirs in
// VMEM.  Bound: integer multiply-adds (an Fq12 square is 12 lazy Fq2
// products, about 4,000 32x32->64 multiply-adds) and the local-memory
// traffic of the tower state (f alone is 12 Fq = 96 words, past what the
// register file gives one thread, and the __noinline__ tower functions
// pass their arguments through the stack): ptxas gives fq_pow 48
// registers and 288 bytes of stack (its table), k_fq12_inv 214 and a
// 1,952 B stack frame, k_fq12_frob 86 and none.
//
// A team of threads of one warp a lane (fq12_team.cuh): six in rows 6, 8,
// 9, 10, 11, 13 (k_miller_precompute, k_miller_loop and its one-step
// launches for rows 8 and 13, k_fq12_mul, k_fq12_cyc_sqr, k_fq12_cyc_pow),
// five lanes to a warp, threads 30 and 31 idle; four in rows 14 and 7
// (k_g2_precompute and its one-step launches), eight lanes to a warp;
// three in row 15 (k_fq2_mul_fused: one Fq2 product, its three 512-bit
// products exchanged by warp shuffles, no shared memory), ten; two in row
// 16 (k_fq2_sqr_fused: one output coefficient a thread), sixteen.  The
// lane's Fq12 or G2 state and its product scratch sit in shared memory as
// Fq2 slots, each thread computes its share of an op's Fq2 products, and
// after a __syncwarp its share of the output coefficients, so no thread
// holds more than two Fq2 operands and a product, and no stack is used.  At B = 16384 a team of
// six is 98,304 threads where one a lane gives 16,384 (fewer warps than
// the card's 528 schedulers).  ptxas (sm_90a) and shared memory:
//   k_miller_precompute  104 registers, no stack; 46 slots = 3,680 B a
//                        lane, 36,800 B a block of 2 warps (static)
//   k_miller_loop        27 slots = 2,160 B a lane, 43,200 B a block of
//                        4 warps (static)
//   k_g2_precompute      110 registers, no stack; a team of four: 25
//                        slots = 2,000 B a lane, 16,000 B a block of
//                        1 warp (static)
//   k_fq12_mul           180 registers, no stack; 2,400 B a lane, 48,000
//                        B a block of 4 warps (static)
//   k_fq12_cyc_pow       232 registers, no stack; the same 48,000 B
//   k_fq12_cyc_sqr       106 registers, no stack; 960 B a lane, 19,200
//                        B a block of 4 warps (static)
// The Miller kernel is limited to 12 warps an SM by its shared memory,
// k_fq12_mul and k_fq12_cyc_pow to 8 by their registers, k_fq12_cyc_sqr
// to 16; register caps
// spill and run slower (regcap_sweep.py, PERF.md).  Step kinds, square
// flags and ladder digits come as a small int32 device array that every
// lane reads in the same order, so a warp never diverges on them.
#include "bn254.cuh"
#include "fq12_team.cuh"

using namespace bn254;

namespace {

// pallas_fused.py _pow_call_impl("fq_pow"), which runs the binary ladder:
// here bn254.cuh fq_pow_chain, a 4-bit sliding window over digits the
// host computes (fused.py pow_digits) and a dedicated square (fq_sqr,
// 36 word products where a CIOS product takes 64).  One thread a lane: a
// chain cannot be split, so the kernel is bound by the dependent products
// of one lane (operations): 253 squares and 55 products for q - 2, 255.9
// products' work (kernel_cases.pow_chain_work), where the binary ladder
// ran 253 squares and 109 products.
__global__ void k_fq_pow(const int32_t* __restrict__ digits, int n,
                         const int32_t* __restrict__ a, int32_t* __restrict__ out, int B) {
  int lane = lane_index();
  if (lane >= B) return;
  Fq x;
  load(x, a, 0, B, lane);
  fq_pow_chain(x, x, PowDigits{digits, n});
  store(out, 0, B, lane, x);
}

// tower.fq12_inv (fq12.rs:305-313), the final exponentiation's inverse:
// on the TPU it is tower glue around row 3's Fq2 product (about 15,000
// tensor ops a call in the port's plain spelling); here one thread a lane
// runs the whole function (bn254.cuh fq12_inv: 2 Fq6 squares, the Fq6
// inverse with the norm's Fermat inverse on fq_pow's chain, 2 Fq6
// products, lazy Fq2 products throughout).  Bound by its operations: 340
// products' work a lane (kernel_cases.FQ12_INV_PRODUCTS and
// pow_chain_work), 255.9 of them the serial chain; 0 maps to 0.
__global__ void k_fq12_inv(const int32_t* __restrict__ digits, int n,
                           const int32_t* __restrict__ a, int32_t* __restrict__ out, int B) {
  int lane = lane_index();
  if (lane >= B) return;
  Fq12 x;
  load(x, a, B, lane);
  fq12_inv(x, x, PowDigits{digits, n});
  store(out, B, lane, x);
}

// tower.fq2_sqrt, the complex-method square root (fq2.rs:208-224), which
// the JAX package runs as bn254_tpu/tower.py:151 fq2_sqrt: two fixed-
// exponent powers as lax.scans over pallas_kernels.py's Fq2 square and
// product (pk:181/175) and a few products around them.  On the card the
// port ran those powers as a Python loop, about 727 one-op launches a
// decompression; here one thread a lane runs the whole function in one
// launch: a1 = a^((q-3)/4) and b = (alpha + 1)^((q-1)/2) on fq_pow_chain
// in Fq2 (row 5's 4-bit window over fused.pow_digits, the Fq2 square and
// the lazy product), a1 a, alpha = a1 (a1 a), alpha's norm conj(alpha)
// alpha = (c0^2 + c1^2, 0) as two Fq squares, and the per-lane select of
// the plain version (fused.fq2_sqrt_plain): i a1 a where alpha = -1, else
// b a1 a; ok unless the norm is -1.  Every value is a fully reduced
// residue, so root and ok are the plain version's bit for bit.  Bound by
// the dependent products of one lane (operations): about 505 Fq2 squares
// and 117 products, 1,310 products' work (kernel_cases.fq2_sqrt_work); at
// the codec's 16,384 lanes that is 128 blocks, one an SM, so the chain's
// latency, not the card's issue rate, sets the time (the next lever is a
// team over each Fq2 product's three wide products).  The window's table
// of 8 Fq2 (512 bytes a thread) stays in local memory, as fq_pow's does:
// in shared memory (word-major, so a warp's reads are conflict-free, in
// 64-thread blocks to fit) it measured no faster on the card (PERF.md),
// since its 8 writes and about 57 reads a chain are little beside the
// chain's products, and L1 serves the local reads.
__global__ void k_fq2_sqrt(const int32_t* __restrict__ d_a1, int n_a1,
                           const int32_t* __restrict__ d_b, int n_b,
                           const int32_t* __restrict__ a, int32_t* __restrict__ root,
                           uint8_t* __restrict__ ok, int B) {
  const int lane = lane_index();
  if (lane >= B) return;
  Fq2 x, a1, a1a, alpha, b;
  load(x, a, 0, B, lane);
  fq_pow_chain(a1, x, PowDigits{d_a1, n_a1});
  f_mul(a1a, a1, x);
  f_mul(alpha, a1, a1a);
  Fq n0, n1, norm, neg_one;
  fq_sqr(n0, alpha.c0);
  fq_sqr(n1, alpha.c1);
  fq_add(norm, n0, n1);
  fq_neg(neg_one, fq_const_one());
  const bool alpha_is_neg1 = f_eq(alpha.c0, neg_one) && f_is_zero(alpha.c1);
  Fq2 one;
  f_set_one(one);
  f_add(b, alpha, one);
  fq_pow_chain(b, b, PowDigits{d_b, n_b});
  f_mul(b, b, a1a);
  if (alpha_is_neg1) {            // i (c0 + c1 i) = -c1 + c0 i
    fq_neg(b.c0, a1a.c1);
    b.c1 = a1a.c0;
  }
  store(root, 0, B, lane, b);
  ok[lane] = !f_eq(norm, neg_one);
}

// tower.fq12_frob (fq12.rs:112-119) for powers 1-3, and power 6, the
// conjugation (fq12.rs:126): glue around row 3 on the TPU.  Six threads a
// lane, one per Fq2 coefficient k (blockIdx.y), 128 lanes a block, so a
// warp reads one coefficient of 32 neighbouring lanes (coalesced).  For
// power p, coefficient k is conj^p(a_k) times one constant, the product
// of the FROB6_C1/C2 and FROB12_C1 factors the tuple code applies one
// after the other (_build.frob12_consts; k = 0 takes none); the
// conjugation negates coefficients 3-5.  Bound by its bytes: each
// coefficient read once and written once.
static __constant__ uint32_t kFrob12[3 * 5 * 16] = {BN254_FROB12};

__global__ void k_fq12_frob(int power, const int32_t* __restrict__ a,
                            int32_t* __restrict__ out, int B) {
  const int lane = lane_index(), k = blockIdx.y;
  if (lane >= B) return;
  Fq2 v;
  load(v, a, 2 * k, B, lane);
  if (power == 6) {
    if (k >= 3) fq2_neg(v, v);
  } else {
    if (power & 1) fq_neg(v.c1, v.c1);
    if (k) {
      const uint32_t* c = kFrob12 + ((power - 1) * 5 + k - 1) * 16;
      Fq2 w;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        w.c0.v[j] = c[j];
        w.c1.v[j] = c[8 + j];
      }
      v = fq2_mul_lazy_inl(v, w);
    }
  }
  store(out, 2 * k, B, lane, v);
}

// tx, ty, tx conj(tx), ty conj(ty): Fq2 j at 16 j, c0's words, then c1's
static __constant__ uint32_t kTwist[4 * 16] = {BN254_TWIST};

__device__ __forceinline__ Fq2 twist_const(int j) {
  Fq2 w;
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    w.c0.v[i] = kTwist[16 * j + i];
    w.c1.v[i] = kTwist[16 * j + 8 + i];
  }
  return w;
}

// pallas_fused.py _miller_call_impl and the JAX package's Frobenius tail
// after it (bn254_tpu/pairing_jax.py:221-237): the 85 scheduled steps,
// then the 2 Frobenius additions.  kind 0: f = f^2 and a doubling step;
// kind 1-4: mixed addition with Q, -Q, pi(Q), -pi^2(Q) (fused.STEP_KINDS).
// Each step then folds its line into f.  A team of six threads a lane
// runs the schedule's rounds (team_schedule.py: 3 rounds a doubling step,
// 3 an addition after it); the lane's BN254_TEAM_SLOTS Fq2 slots (46:
// 3,680 bytes) sit in static shared memory, 2 warps = 10 lanes a block
// (36,800 bytes, under the 48 KB static limit; 6 blocks an SM, as at the
// 41 slots before the Frobenius bases; 1 and 4 warps timed within 1 %).
// The addition's base is read through vb, kind k's at slot Q1X + 2 (k -
// 1).  Where kinds 3 or 4 come, the wrapper puts a step of kind
// BN254_MILLER_FROB_KIND first (team_schedule.device_kinds): its round
// makes pi(Q) and -pi^2(Q), one lazy product on each of threads 0-3, from
// conj(qx), conj(qy) and the twist factors that the start puts in the
// product slots P0-P5 (_build.twist_consts), the same field values as
// _mul_by_q applied twice.  The bases' products run through the steps'
// own team_round: the same product spelled once more in this kernel, even
// where never reached, slowed every step (PERF.md).
constexpr int kMillerWarps = 2;
constexpr int kMillerLanes = kTeamsPerWarp * kMillerWarps;
constexpr int kMillerLaneWords = BN254_TEAM_SLOTS * kTeamSlot;
static __constant__ TeamRound kMillerRounds[BN254_MILLER_NROUNDS] = BN254_MILLER_ROUNDS;

__global__ void k_miller_precompute(const int32_t* __restrict__ kinds, int n,
                                    const int32_t* __restrict__ p,
                                    const int32_t* __restrict__ q,
                                    int32_t* __restrict__ f_out,
                                    int32_t* __restrict__ r_out, int B) {
  __shared__ __align__(16) uint32_t s_lanes[kMillerLanes * kMillerLaneWords];
  const TeamThread t = team_thread(kMillerLanes, B);
  const int k = t.k;
  uint32_t* s = s_lanes + (t.active ? t.slot : 0) * kMillerLaneWords;
  // f = 1; thread 0 Q's x, 1 its y: R = (qx, qy, 1), Q, -Q and conj(q) in
  // P0, P1; threads 2-5 twist factor k - 2 in slot Pk, and z = 1, (px, 0),
  // (py, 0), b2
  if (t.active) {
    const Fq zero = fq_const_zero(), one = fq_const_one();
    st2_s(s, k, Fq2{k == 0 ? one : zero, zero});
    Fq2 v;
    if (k < 2) {
      load(v, q, 2 * k, B, t.lane);
      st2_s(s, BN254_SLOT_RX + k, v);
      st2_s(s, BN254_SLOT_Q1X + k, v);
      if (k) fq2_neg(v, v);
      st2_s(s, BN254_SLOT_Q2X + k, v);
      if (k) fq_neg(v.c0, v.c0);
      else fq_neg(v.c1, v.c1);
      st2_s(s, BN254_SLOT_P0 + k, v);
    } else {
      st2_s(s, BN254_SLOT_P0 + k, twist_const(k - 2));
      if (k == 2) {
        st2_s(s, BN254_SLOT_RZ, Fq2{one, zero});
      } else if (k < 5) {
        load(v.c0, p, k - 3, B, t.lane);
        st2_s(s, BN254_SLOT_PX + k - 3, Fq2{v.c0, zero});
      } else {
        st2_s(s, BN254_SLOT_B2, Fq2{Fq{{BN254_B2_C0}}, Fq{{BN254_B2_C1}}});
      }
    }
  }
  __syncwarp();
  // team_schedule.step_rounds: a doubling step runs rounds 0, 1, 2, or 0,
  // 1, 3 when an addition follows (3 also takes the addition's first
  // products, against the next step's base); an addition runs 4-7, or 5-7
  // after a doubling step; the bases' step its round
  for (int i = 0; i < n; ++i) {
    const int kind = kinds[i];
    const int other = kind == 0 ? (i + 1 < n ? kinds[i + 1] : 0) : (i > 0 ? kinds[i - 1] : 1);
    const int add = kind == 0 ? other : kind;
    const int vb = BN254_SLOT_Q1X + 2 * (add ? add - 1 : 0);
    const bool frob = kind == BN254_MILLER_FROB_KIND;
    const int r0 = frob ? BN254_MILLER_R_FROB : kind == 0 ? 0 : (other == 0 ? 5 : 4);
    const int r_end = frob ? BN254_MILLER_R_FROB + 1 : kind == 0 ? 3 : 8;
#pragma unroll 1
    for (int r = r0; r < r_end; ++r)
      team_round<Fq2, kTeam>(kMillerRounds[r == 2 && other != 0 ? 3 : r], k, s, vb,
                             t.active);
  }
  if (t.active) {
    store(f_out, 2 * k, B, t.lane, ld2_s(s, k));
    if (k < 3) store(r_out, 2 * k, B, t.lane, ld2_s(s, BN254_SLOT_RX + k));
  }
}

// pairing_torch.precompute (mod.rs:701-728), which the JAX package runs as a
// lax.scan over rows 14 (pallas_fused.py _call_impl("g2_dbl_step")) and 7
// (_call_impl("g2_add_step")), then _mul_by_q twice and the 2 Frobenius
// additions (bn254_tpu/pairing_jax.py:130-177): R = (qx, qy, 1), then per
// step a doubling (kind 0) or a mixed addition of base `kind` (1: Q, 2:
// -Q, 3: pi(Q), 4: -pi^2(Q)), each step's raw line (ell_0, ell_vw,
// ell_vv) written to lines [n, 6, 16, B], the layout k_miller_loop reads.
// One launch runs all 87 steps: R stays in shared memory from the first
// step to the last, and the team stores each line's 6 Fq straight to
// device memory, fenced by a __syncwarp of its own before the next step's
// rounds write the line slots.  A team of four threads a lane (eight
// lanes a warp, no thread idle) over precompute_schedule.py's rounds (the
// Miller kernel's doubling and addition products without f, the fold and
// the px, py scalings, regrouped into rounds of at most four: 3 product
// passes a doubling step, 4 with the next addition's first products, 3
// an addition after it); 25 Fq2 slots (2,000 bytes) a lane in static
// shared memory, 16,000 bytes a one-warp block, 14 blocks an SM.  A team
// of six over the Miller kernel's grouping (262 passes, 30 slots) ran
// 3.55-3.65 ms at 16384 lanes, one thread a lane looping over the
// one-thread step formulas 3.36-3.47, this one 2.81 (PERF.md): a pass
// costs a warp the same however few of its threads have a product, and
// these steps have at most five products a level.  The addition's base
// is read through vb, kind k's at slot Q1X + 2 (k - 1).  The bases are
// made at the start, one product a part: pi(Q) = (tx conj(qx), ty
// conj(qy)) and pi^2(Q) = (tx conj(tx) qx, ty conj(ty) qy), the twist
// factors and their norms from the generated header
// (_build.twist_consts), the same field values as _mul_by_q applied
// twice.  Bound by operations: 64 doubling steps of 22 products' work and
// 23 additions of 31.5, and the 4 products of the bases, 2,142.5 a lane
// (kernel_cases.lines_work); the lines are 87 x 6 Fq a lane.
//
// Rows 14 and 7 are one-step launches of this kernel: R from r_in and no
// q (a doubling step), and R from r_in with base (an addition of base).
// kinds == nullptr: every step is an addition of base if base is given,
// else a doubling step; r_out == nullptr: R is not written.
constexpr int kLinesTeam = BN254_PRE_TEAM, kLinesWarps = 1;   // 2 warps timed 4-5 % slower
constexpr int kLinesLanes = 32 / kLinesTeam * kLinesWarps;
constexpr int kLinesLaneWords = BN254_PRE_SLOTS * kTeamSlot;
static __constant__ TeamRound kPreRounds[BN254_PRE_NROUNDS] = BN254_PRE_ROUNDS;
// Part j (0-5) of a lane's start: R = r_in or (qx, qy, 1) (j < 3); the
// bases from q (j 0: Q's and -Q's x, pi(Q)'s x; 1: Q's y, pi(Q)'s y; 2:
// -Q's y; 3: pi^2(Q)'s x; 4: its y, negated), or base as kind 1's; b2 (j 5)
__device__ __forceinline__ void lines_start(uint32_t* s, int j, const int32_t* q,
                                            const int32_t* r_in, const int32_t* base, int B,
                                            int lane) {
  const int q1 = BN254_PRE_SLOT_Q1X;
  const Fq zero = fq_const_zero(), one = fq_const_one();
  Fq2 v;
  if (j < 3) {
    if (r_in) {
      load(v, r_in, 2 * j, B, lane);
    } else if (j < 2) {
      load(v, q, 2 * j, B, lane);
    } else {
      v = Fq2{one, zero};
    }
    st2_s(s, BN254_PRE_SLOT_RX + j, v);
  }
  if (q && j < 5) {
    load(v, q, j == 0 || j == 3 ? 0 : 2, B, lane);
    if (j < 2) {
      st2_s(s, q1 + j, v);
      if (j == 0) st2_s(s, q1 + 2, v);
      fq_neg(v.c1, v.c1);
      st2_s(s, q1 + 4 + j, team_fq2_mul(v, twist_const(j)));
    } else if (j == 2) {
      fq2_neg(v, v);
      st2_s(s, q1 + 3, v);
    } else {
      v = team_fq2_mul(v, twist_const(j - 1));
      if (j == 4) fq2_neg(v, v);
      st2_s(s, q1 + 3 + j, v);
    }
  }
  if (base && j < 2) {
    load(v, base, 2 * j, B, lane);
    st2_s(s, q1 + j, v);
  }
  if (j == 5) st2_s(s, BN254_PRE_SLOT_B2, Fq2{Fq{{BN254_B2_C0}}, Fq{{BN254_B2_C1}}});
}

__global__ void k_g2_precompute(const int32_t* __restrict__ kinds, int n,
                                const int32_t* __restrict__ q, const int32_t* __restrict__ r_in,
                                const int32_t* __restrict__ base, int32_t* __restrict__ lines,
                                int32_t* __restrict__ r_out, int B) {
  __shared__ __align__(16) uint32_t s_lanes[kLinesLanes * kLinesLaneWords];
  const TeamThread t = team_thread<kLinesTeam>(kLinesLanes, B);
  const int k = t.k;
  uint32_t* s = s_lanes + (t.active ? t.slot : 0) * kLinesLaneWords;
  if (t.active)
    for (int j = k; j < 6; j += kLinesTeam) lines_start(s, j, q, r_in, base, B, t.lane);
  __syncwarp();
  // team_schedule.step_rounds: a doubling step runs rounds 0, 1, 2, or 0,
  // 1, 3 when an addition follows (3 also takes the addition's first
  // products, against the next step's base); an addition runs 4-7, or 5-7
  // after a doubling step
  for (int i = 0; i < n; ++i) {
    const int kind = kinds ? kinds[i] : (base ? 1 : 0);
    const int next = kinds && i + 1 < n ? kinds[i + 1] : 0;
    const int prev = kinds && i > 0 ? kinds[i - 1] : 1;
    const int add = kind == 0 ? next : kind;
    const int vb = BN254_PRE_SLOT_Q1X + 2 * (add ? add - 1 : 0);
    const int r0 = kind == 0 ? 0 : (prev == 0 ? 5 : 4), r_end = kind == 0 ? 3 : 8;
#pragma unroll 1
    for (int r = r0; r < r_end; ++r)
      team_round<Fq2, kLinesTeam>(kPreRounds[r == 2 && next != 0 ? 3 : r], k, s, vb,
                                  t.active);
    if (t.active)      // Fq j of the line: half j & 1 of slot E0 + j / 2
      for (int j = k; j < 6; j += kLinesTeam)
        store(lines + (size_t)i * 6 * 16 * B, j, B, t.lane,
              fq_load_words(s + kTeamSlot * (BN254_PRE_SLOT_E0 + j / 2) + 8 * (j & 1)));
    __syncwarp();
  }
  if (r_out && t.active)
    for (int j = k; j < 3; j += kLinesTeam)
      store(r_out, 2 * j, B, t.lane, ld2_s(s, BN254_PRE_SLOT_RX + j));
}

int launch_lines(const int32_t* kinds, int n, const int32_t* q, const int32_t* r_in,
                 const int32_t* base, int32_t* lines, int32_t* r_out, int B,
                 cudaStream_t stream) {
  k_g2_precompute<<<(B + kLinesLanes - 1) / kLinesLanes, 32 * kLinesWarps, 0, stream>>>(
      kinds, n, q, r_in, base, lines, r_out, B);
  return static_cast<int>(cudaGetLastError());
}

// pallas_fused.py _call_impl("fq2_mul"): kfq2_mul in its default lazy
// spelling, as one step of the three-thread Fq2 team (fq12_team.cuh
// team3_fq2_mul_coeff): thread k of a lane's team makes one of the three
// 512-bit products, threads 0 and 1 reduce and store coefficient 0 and 1,
// inlined, with no stack frame; 4 warps, 40 lanes a block.  Thread k
// loads coordinate k & 1 of a and b, and thread 2 takes coordinate 1 from
// thread 1 by shuffles: a team's three threads loading both coordinates
// ran 0.0533 ms at 262144 lanes, this 0.0457, the one-thread kernel it
// replaced 0.0500 (PERF.md).  Bound by its bytes, 384 per lane; at the
// one-op batch the wrapper's host time sets the time between back-to-back
// calls.
__global__ void k_fq2_mul_fused(const int32_t* __restrict__ a, const int32_t* __restrict__ b,
                                int32_t* __restrict__ out, int B) {
  const TeamThread t = team_thread<kTeam3>(kTeam3Lanes, B);
  const int base = threadIdx.x % 32 - t.k;
  Fq x{}, y{};
  if (t.active) {
    load(x, a, t.k & 1, B, t.lane);
    load(y, b, t.k & 1, B, t.lane);
  }
  Fq x1, y1;                     // coordinate 1, thread 1's
  shfl_words(x1.v, x.v, base + 1);
  shfl_words(y1.v, y.v, base + 1);
  const Fq c = team3_fq2_mul_coeff(t.k, base, Fq2{x, x1}, Fq2{y, y1});
  if (t.active && t.k < 2) store(out, t.k, B, t.lane, c);
}

// pallas_fused.py _call_impl("fq2_sqr"): kfq2_sqr, the complex square,
// on a pair of threads a lane: its two output coefficients are
// independent, c0 = (a0 + a1)(a0 - a1) and c1 = 2 a0 a1, so thread k of
// the pair loads coordinate k (16 lanes a warp, 4 bytes a word each:
// coalesced), takes the other from its partner by one round of 8 warp
// shuffles, and makes coefficient k with one 512-bit product and one
// reduction (fq12_team.cuh team3_fq2_sqr_coeff, the three-thread step's
// square), then stores it; 4 warps, 64 lanes a block, no idle thread.
// Bound by its bytes, 256 per lane.  At 262144 lanes it took 0.0290 ms
// (69 % of that bound), one step of the three-thread Fq2 step 0.0368 and
// the one-thread complex square it replaced 0.0343-0.0345 (PERF.md).
constexpr int kPairWarps = 4, kPairLanes = 32 / 2 * kPairWarps;   // a block

__global__ void k_fq2_sqr_fused(const int32_t* __restrict__ a, int32_t* __restrict__ out,
                                int B) {
  const TeamThread t = team_thread<2>(kPairLanes, B);
  Fq x{};
  if (t.active) load(x, a, t.k, B, t.lane);
  Fq y;                          // the other coordinate, the partner's
  shfl_words(y.v, x.v, (threadIdx.x % 32) ^ 1);
  const bool one = t.k == 1;
  Fq2 v;
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    v.c0.v[j] = one ? y.v[j] : x.v[j];
    v.c1.v[j] = one ? x.v[j] : y.v[j];
  }
  const Fq c = team3_fq2_sqr_coeff(t.k, v);
  if (t.active) store(out, t.k, B, t.lane, c);
}

// The prepared Miller loop (pairing_torch.miller_loop, mod.rs:580-606), which
// the JAX package runs as one lax.scan over rows 13 (pallas_fused.py
// _call_impl("fq12_sqr")) and 8 (_call_impl("fq12_fold_line")) inside one
// XLA program: f = 1, then per step f = f^2 where the step's flag is set
// and f = f * line, ell_vv scaled by px and ell_vw by py.  One launch runs
// all the steps, so f stays in shared memory from the first to the last
// and only the lines come from device memory.  A team of six threads a
// lane over loop_schedule.py's rounds (row 9's geometry, 20 lanes a
// block): f, (px, 0), (py, 0), two sets of line slots and 13 product
// slots, 27 Fq2 slots (2,160 bytes) a lane in static shared memory
// (43,200 bytes a block).  ptxas caps that take 4 or 5 blocks an SM (128
// registers, or 96 with spills) ran the loop 5-22 % slower than its
// 132-146 registers at 3 blocks.  Thread k moves Fq k of each step's line (ell_0, ell_vw, ell_vv) raw into
// its slot the step before it is needed (the lines alternate between the
// two sets), and the step before scales it by px, py in its fold round's
// spare tasks: 390 product passes a lane, where a scaling round of its
// own takes 476 and measured 15 % slower (PERF.md).  The line's load
// latency hides behind the other warps of the SM: holding the line after
// the next one in registers measured no faster.  Bound by operations: 64
// squares and 87 folds, 5,095.5 products' work a lane
// (kernel_cases.loop_work); the lines are 6 Fq a lane a step.
//
// The one-op kernels of rows 8 and 13 are launches of this kernel, one
// step each: with f_in and a line but no flags (the px, py scalings as a
// round of their own, then the fold), and with f_in and no line (the
// square).  flags == nullptr: no step squares, unless c == nullptr;
// f_in == nullptr: f starts at 1.
constexpr int kLoopWarps = 4;        // 2 timed 1.4 % slower
constexpr int kLoopLanes = kTeamsPerWarp * kLoopWarps;
constexpr int kLoopLaneWords = BN254_LOOP_SLOTS * kTeamSlot;
static __constant__ TeamRound kLoopRounds[BN254_LOOP_NROUNDS] = BN254_LOOP_ROUNDS;

// Fq k of step i's line in c [n, 6, 16, B] into the line set starting at
// slot `set`: half k & 1 of its slot (loop_schedule.LINE_SLOT: ell_0 ->
// x0, ell_vw -> x4, ell_vv -> x2)
__device__ __forceinline__ void line_put(uint32_t* s, int set, const int32_t* c, int i, int k,
                                         int B, int lane) {
  Fq v;
  load(v, c + (size_t)i * 6 * 16 * B, k, B, lane);
  const int slot = set + ((BN254_LOOP_LINE_SLOTS >> (2 * k)) & 3);
  fq_store_words(s + kTeamSlot * slot + 8 * (k & 1), v);
}

__global__ void k_miller_loop(const int32_t* __restrict__ flags, int n,
                              const int32_t* __restrict__ f_in,
                              const int32_t* __restrict__ c,
                              const int32_t* __restrict__ px,
                              const int32_t* __restrict__ py,
                              int32_t* __restrict__ f_out, int B) {
  __shared__ __align__(16) uint32_t s_lanes[kLoopLanes * kLoopLaneWords];
  const TeamThread t = team_thread(kLoopLanes, B);
  const int k = t.k;
  const bool line = c != nullptr;
  uint32_t* s = s_lanes + (t.active ? t.slot : 0) * kLoopLaneWords;
  if (t.active) {      // f = f_in or 1; (px, 0), (py, 0)
    const Fq zero = fq_const_zero();
    Fq2 v{k == 0 ? fq_const_one() : zero, zero};
    if (f_in) load(v, f_in, 2 * k, B, t.lane);
    st2_s(s, BN254_LOOP_SLOT_F0 + k, v);
    if (line && k < 2) {
      load(v.c0, k ? py : px, 0, B, t.lane);
      st2_s(s, BN254_LOOP_SLOT_PX + k, Fq2{v.c0, zero});
    }
    if (line) line_put(s, BN254_LOOP_SLOT_L0, c, 0, k, B, t.lane);
  }
  __syncwarp();
  if (line) team_round<Fq2, kTeam>(kLoopRounds[BN254_LOOP_R_SCALE], k, s, 0, t.active);
  // loop_schedule.step_rounds: the square where the step squares, then
  // the fold of step i's set (L for even i, M for odd), which scales line
  // i + 1, put in the other set before it
  for (int i = 0; i < n; ++i) {
    const int set = i & 1;
    if (line && i + 1 < n) {
      if (t.active)
        line_put(s, set ? BN254_LOOP_SLOT_L0 : BN254_LOOP_SLOT_M0, c, i + 1, k, B, t.lane);
      __syncwarp();
    }
    if (!line || (flags && flags[i]))
      team_round<Fq2, kTeam>(kLoopRounds[BN254_LOOP_R_SQR], k, s, 0, t.active);
    if (line)
      team_round<Fq2, kTeam>(
          kLoopRounds[(i + 1 < n ? BN254_LOOP_R_FOLD_SCALE : BN254_LOOP_R_FOLD) + set], k, s,
          0, t.active);
  }
  if (t.active) store(f_out, 2 * k, B, t.lane, ld2_s(s, BN254_LOOP_SLOT_F0 + k));
}

int launch_loop(const int32_t* flags, int n, const int32_t* f_in, const int32_t* c,
                const int32_t* px, const int32_t* py, int32_t* f_out, int B,
                cudaStream_t stream) {
  k_miller_loop<<<(B + kLoopLanes - 1) / kLoopLanes, 32 * kLoopWarps, 0, stream>>>(
      flags, n, f_in, c, px, py, f_out, B);
  return static_cast<int>(cudaGetLastError());
}

// pallas_fused.py _call_impl("fq12_mul"): a team of six threads a lane,
// 20 lanes a block (row 11's geometry); a and b in shared memory, each
// thread three of the 18 lazy Fq2 products, then one output coefficient.
// Each thread loads and stores its own coefficient (six 5-lane runs a warp
// instruction); staging a block's lanes through shared memory so that
// the loads coalesce measured slower (PERF.md).
constexpr int kCycWarps = 4;
constexpr int kCycLanes = kTeamsPerWarp * kCycWarps;   // lanes a block

__global__ void k_fq12_mul(const int32_t* __restrict__ a, const int32_t* __restrict__ b,
                           int32_t* __restrict__ out, int B) {
  __shared__ __align__(16) uint32_t s_lanes[kCycLanes * kTeamLaneWords];
  const TeamThread t = team_thread(kCycLanes, B);
  uint32_t* x = s_lanes + (t.active ? t.slot : 0) * kTeamLaneWords;
  uint32_t* y = x + 6 * kTeamSlot;
  uint32_t* P = x + 12 * kTeamSlot;
  if (t.active) {
    Fq2 v;
    load(v, a, 2 * t.k, B, t.lane);
    st2_s(x, t.k, v);
    load(v, b, 2 * t.k, B, t.lane);
    st2_s(y, t.k, v);
  }
  __syncwarp();
  if (t.active) team_fq12_mul_products(t.k, P, x, y, false);
  __syncwarp();
  if (t.active) store(out, 2 * t.k, B, t.lane, team_fq12_mul_coeff(P, t.k));
}

// pallas_fused.py _call_impl("fq12_cyc_sqr"): row 9's geometry, a in
// shared memory, each thread one of the Granger-Scott square's six Fq2
// products (the team square that row 11 runs every digit), then one
// output coefficient.  a and the products take 12 slots a lane, 19,200
// bytes a block.
constexpr int kCycSqrLaneWords = 12 * kTeamSlot;

__global__ void k_fq12_cyc_sqr(const int32_t* __restrict__ a, int32_t* __restrict__ out, int B) {
  __shared__ __align__(16) uint32_t s_lanes[kCycLanes * kCycSqrLaneWords];
  const TeamThread t = team_thread(kCycLanes, B);
  uint32_t* x = s_lanes + (t.active ? t.slot : 0) * kCycSqrLaneWords;
  uint32_t* P = x + 6 * kTeamSlot;
  if (t.active) {
    Fq2 v;
    load(v, a, 2 * t.k, B, t.lane);
    st2_s(x, t.k, v);
  }
  __syncwarp();
  if (t.active) team_cyc_sqr_products(t.k, P, x);
  __syncwarp();
  if (t.active) store(out, 2 * t.k, B, t.lane, team_cyc_sqr_coeff(t.k, P, x));
}

// pallas_fused.py _pow_call_impl("fq12_cyc_pow"): res = a; per digit a
// cyclotomic square, then digit 1 multiplies by a, digit 2 by conj(a);
// row 9's geometry.  No __launch_bounds__: it would make nvcc ignore
// -maxrregcount, which regcap_sweep.py sets to time the kernel under
// register caps.
__global__ void k_fq12_cyc_pow(const int32_t* __restrict__ digits, int n,
                               const int32_t* __restrict__ a, int32_t* __restrict__ out, int B) {
  __shared__ __align__(16) uint32_t s_lanes[kCycLanes * kTeamLaneWords];
  const TeamThread t = team_thread(kCycLanes, B);
  const int k = t.k, lane = t.lane;
  const bool active = t.active;
  uint32_t* res = s_lanes + (active ? t.slot : 0) * kTeamLaneWords;
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

int bn254_fq12_inv(const int32_t* digits, int n, const int32_t* a, int32_t* out, int B,
                   cudaStream_t stream) {
  BN254_LAUNCH(k_fq12_inv, digits, n, a, out);
}

int bn254_fq2_sqrt(const int32_t* d_a1, int n_a1, const int32_t* d_b, int n_b,
                   const int32_t* a, int32_t* root, uint8_t* ok, int B, cudaStream_t stream) {
  BN254_LAUNCH(k_fq2_sqrt, d_a1, n_a1, d_b, n_b, a, root, ok);
}

int bn254_fq12_frob(int power, const int32_t* a, int32_t* out, int B, cudaStream_t stream) {
  k_fq12_frob<<<dim3((B + BN254_THREADS - 1) / BN254_THREADS, 6), BN254_THREADS, 0, stream>>>(
      power, a, out, B);
  return static_cast<int>(cudaGetLastError());
}

// k_miller_precompute's resident blocks an SM on the current device (the
// occupancy query; its shared memory, not its registers, sets it)
int bn254_miller_blocks_per_sm(int* blocks) {
  return static_cast<int>(cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      blocks, k_miller_precompute, 32 * kMillerWarps, 0));
}

int bn254_miller_precompute(const int32_t* kinds, int n, const int32_t* p, const int32_t* q,
                            int32_t* f, int32_t* r, int B, cudaStream_t stream) {
  k_miller_precompute<<<(B + kMillerLanes - 1) / kMillerLanes, 32 * kMillerWarps, 0,
                        stream>>>(kinds, n, p, q, f, r, B);
  return static_cast<int>(cudaGetLastError());
}

// the 87 lines of pairing_torch.precompute in one launch; rows 7 and 14 as one
// step of the same kernel
int bn254_g2_precompute(const int32_t* kinds, int n, const int32_t* q, int32_t* lines, int B,
                        cudaStream_t stream) {
  return launch_lines(kinds, n, q, nullptr, nullptr, lines, nullptr, B, stream);
}

int bn254_g2_add_step(const int32_t* r, const int32_t* base, int32_t* r_out, int32_t* c_out,
                      int B, cudaStream_t stream) {
  return launch_lines(nullptr, 1, nullptr, r, base, c_out, r_out, B, stream);
}

int bn254_g2_dbl_step(const int32_t* r, int32_t* r_out, int32_t* c_out, int B,
                      cudaStream_t stream) {
  return launch_lines(nullptr, 1, nullptr, r, nullptr, c_out, r_out, B, stream);
}

int bn254_fq2_mul_fused(const int32_t* a, const int32_t* b, int32_t* out, int B,
                        cudaStream_t stream) {
  k_fq2_mul_fused<<<(B + kTeam3Lanes - 1) / kTeam3Lanes, 32 * kTeam3Warps, 0, stream>>>(
      a, b, out, B);
  return static_cast<int>(cudaGetLastError());
}

int bn254_fq2_sqr_fused(const int32_t* a, int32_t* out, int B, cudaStream_t stream) {
  k_fq2_sqr_fused<<<(B + kPairLanes - 1) / kPairLanes, 32 * kPairWarps, 0, stream>>>(a, out, B);
  return static_cast<int>(cudaGetLastError());
}

int bn254_fq12_mul(const int32_t* a, const int32_t* b, int32_t* out, int B,
                   cudaStream_t stream) {
  k_fq12_mul<<<(B + kCycLanes - 1) / kCycLanes, 32 * kCycWarps, 0, stream>>>(a, b, out, B);
  return static_cast<int>(cudaGetLastError());
}

int bn254_fq12_cyc_sqr(const int32_t* a, int32_t* out, int B, cudaStream_t stream) {
  k_fq12_cyc_sqr<<<(B + kCycLanes - 1) / kCycLanes, 32 * kCycWarps, 0, stream>>>(a, out, B);
  return static_cast<int>(cudaGetLastError());
}

int bn254_fq12_cyc_pow(const int32_t* digits, int n, const int32_t* a, int32_t* out, int B,
                       cudaStream_t stream) {
  k_fq12_cyc_pow<<<(B + kCycLanes - 1) / kCycLanes, 32 * kCycWarps, 0, stream>>>(digits, n, a,
                                                                                out, B);
  return static_cast<int>(cudaGetLastError());
}

int bn254_miller_loop(const int32_t* flags, int n, const int32_t* c, const int32_t* px,
                      const int32_t* py, int32_t* f, int B, cudaStream_t stream) {
  return launch_loop(flags, n, nullptr, c, px, py, f, B, stream);
}

// rows 13 and 8 as one step of k_miller_loop
int bn254_fq12_sqr(const int32_t* a, int32_t* out, int B, cudaStream_t stream) {
  return launch_loop(nullptr, 1, a, nullptr, nullptr, nullptr, out, B, stream);
}

int bn254_fq12_fold_line(const int32_t* f, const int32_t* c, const int32_t* px,
                         const int32_t* py, int32_t* out, int B, cudaStream_t stream) {
  return launch_loop(nullptr, 1, f, c, px, py, out, B, stream);
}

}  // extern "C"
