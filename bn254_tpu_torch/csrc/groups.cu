// Group-law, Pippenger and GLV kernels (queue rows 17-20), replacing the
// bn254_tpu/pallas_fused.py kernels named beside each one below.  Each is
// a template on the coordinate field: Fq for G1, Fq2 for G2; the C entry
// takes ncoords (1 or 2) and picks the instance.
//
// k_point_add / k_point_double: one group-law operation a launch, one
// thread per batch lane, 128-thread blocks, the ragged edge masked,
// operands read once and the result written once.  Their body is small
// (11 products and 5 squares a unified add, 2 and 5 a double), so at one
// operation a launch the launch and the wrapper's host work cost as much
// as the body or more.  They serve the one-op callers (glv.prepare's
// p1 + p2, groups.add / double).  The callers that loop over the group
// law no longer launch them step by step: k_msm_combine (Horner and the
// lane fold) and k_point_mul (the double-and-add) carry the whole loop in
// a launch, so the steps run back to back on the thread's own registers
// and stack, and the host dispatches once.
//
// Row 19 (pallas_fused.py _msm_acc_impl, the TPU's msm_accumulate) is
// three kernels here.  The TPU kernel's grid runs (window, point tile) in
// order and keeps one window's buckets in VMEM; each bucket's additions
// happen in tile order, so any thread may do them as long as it keeps
// that order, and the outputs stay bit for bit the same.
//
// k_msm_bucket_sort: one thread per (window, lane).  A stable counting
// sort of the lane's n / lanes tiles by bucket |d| (d for unsigned
// digits), dropping d = 0: pass 1 counts into the lane's column of the
// offsets output, which then holds each bucket's start; pass 2 scatters
// the tile numbers into their runs, moving each start to its bucket's
// end.  Out: offsets [W, nb, lanes] (offsets[b] = tiles with 1 <= |d| <=
// b, so bucket b's run is [offsets[b - 1], offsets[b])) and the tile list
// [W, n / lanes, lanes] int32, -1 past the last run.  The counts live in
// device memory (5.8 MB for G1 2^20, L2-resident), so nb and n / lanes
// have no limit of their own.  The digits are read coalesced (a warp
// holds 32 neighbouring lanes), twice.  Bound: the bytes, 8 per digit
// plus 4 per tile written.
//
// k_msm_accumulate: one thread per (window, bucket, lane); a warp is 32
// neighbouring lanes of one (window, bucket).  The bucket starts at
// (0, 0, 0) in the thread's registers and stays there: for each tile of
// its run the thread gathers the affine point from a point-major copy
// ([n, 2C, 8] 32-bit words, 64 bytes a G1 point, 128 a G2 point, so a
// gather is 2-4 full sectors rather than one sector per word), negates y
// for d < 0 and applies the mixed add (inlined), with the affine double
// on coincide.  The finished bucket is written once, coalesced, into
// [W, nb - 1, 3C, 16, lanes].  G1 2^20 at c = 6 is 1.41 M threads.
// Runs in a warp have similar lengths for random scalars (a warp waits
// for its longest); for skewed ones whole warps are long or empty
// together, so the serial depth never exceeds n / lanes steps.  Bound:
// the madds' Montgomery products (11 a G1 point, 30 a G2 point, per
// window).  ptxas (sm_90a): 96 registers and a 160-byte frame for G1;
// 182 registers and 1,728 bytes for G2, whose lazy Fq2 products stay
// __noinline__ (bn254.cuh).
//
// k_msm_bucket_reduce: one thread per (window, lane) reads its buckets
// coalesced and takes the running sum, b = nb - 1 .. 1 (2 full adds a
// bucket), writing its window total into [W, 3C, 16, lanes].  About a
// tenth of the accumulate's products for G1 2^20, a third for G2 2^16,
// on only W * lanes threads.
//
// k_msm_combine (serves pallas_fused.py k_point_double / k_point_add,
// pf:769/789, as bn254_tpu/msm.py's Horner lax.scan and roll fold run
// them): window totals [W, 3C, 16, lanes] -> their sum [3C, 16, 1].  One
// thread a lane runs Horner: res = totals[W - 1], then for w = W - 2 .. 0
// c doubles and one add of totals[w] (read coalesced: lanes are minor).
// Then each block folds its lanes as a tree in shared memory (128 G2
// points are 24 KB), and its thread 0 writes the block's partial; the C
// entry launches the same kernel again with W = 1 over those partials,
// until one block holds them all.  At the MSM's 1024 lanes that is 8
// blocks, then one block of 8 threads: two launches where the loop took
// 304-310 launches and 10 copies.  Bound: the serial depth.  1024 lanes
// fill 8 of the 132 SMs, so the card is far from its throughput bound;
// one lane's chain is 252 doubles and 52 adds for G1 at c = 6 (about
// 2,300 products' work) and 250 doubles and 60 adds for G2 at c = 5
// (about 6,000), each product waiting on the one before.  The design
// removes what the loop paid on top of that chain (a launch, a wrapper
// call and a round trip through device memory a step); cutting the chain
// itself needs several threads a lane.
//
// The tree equals the roll fold.  Fold step k (k = 1, 2, 4, ...) sets
// res[i] = add(res[i], res[(i + k) mod lanes]) on every lane; by
// induction lane i then holds V(i, 2k) = add(V(i, k), V(i + k, k)), with
// V(i, 1) lane i's Horner result, and lane 0 ends with V(0, lanes).  The
// tree sets s[i] = add(s[i], s[i + k]) only where i % 2k == 0; by the same
// induction its operands are V(i, k) and V(i + k, k) (i + k is a multiple
// of k, so stride k / 2 updated it): the same adds of the same operands in
// the same argument order, and point_add is a pure function of its
// operands, so lane 0's limbs are equal.  Cutting the tree at the block
// size keeps this: block b's partial is V(b T, T), and the next level's
// tree over the partials goes on with strides T, 2T, ...
//
// k_point_mul (serves pf:769/789 as bn254_tpu/groups.py's scalar_mul
// lax.scan runs them): MSB-first double-and-add, one thread a lane over
// num_bits steps, res and the base on the thread; the scalar's 16-bit
// limbs [16, B] are read one word per 16 steps, coalesced.  The add runs
// only where the bit is set, which equals the scan's add-then-select bit
// for bit: point_add is pure, and on a zero bit the select kept res (a
// k = 0 lane keeps the limbs that repeated doubling of (0, 1, 0) gives).
// For the codec's r (254 bits, 101 set) that is 101 adds a lane where the
// loop computed 254.  Every lane shares that scalar, so no warp diverges;
// with per-lane scalars a warp diverges on the add, as k_glv_ladder does.
// Bound: at the codec's 16,384 lanes (128 blocks, one an SM) the
// products, 254 doubles and 101 adds a G2 lane (about 7,600 products'
// work), which are also its serial depth.
//
// k_glv_ladder (pallas_fused.py _glv_call_impl, queue row 20): a team of
// four threads of one warp a lane, eight lanes a warp, as rows 6 and 11
// run (fq12_team.cuh team_round over ladder_schedule.py's rounds).  On one
// thread a step is a chain of 23 dependent products (the double's 7, the
// add's 16), G2's Fq2 operands passing through the stack, and each step
// gathers the digit's table point from device memory.  Here the lane's
// res, its three table points (loaded once) with their z^2 and z^3
// (computed once: the same field values at every step) and ten
// temporaries sit in shared memory as 28 slots of the coordinate field,
// and a step is six rounds of at most four products (21 products, serial
// depth six), each round's products spread over the team, then its sums,
// the same code on every thread.  The add's branches stay the one-thread
// add's, per lane, the whole team taking them: the add's rounds run only
// where neither p nor q is at infinity (digit 0 picks q = (0, 1, 0)); a
// lane whose add meets its own point (h = rr = 0 after the first add
// round) runs the double's rounds on p instead of the last two; where p
// is at infinity res becomes q.  Lanes past B and lanes that skip a round
// still join every __syncwarp and __any_sync.  Shared memory: 28 slots of
// 80 bytes (G2, Fq2 padded) or 48 (G1), 2,240 or 1,344 bytes a lane;
// blocks of two warps (16 lanes, 35,840 bytes) for G2 and four (32 lanes,
// 43,008 bytes) for G1, so shared memory holds 12 warps an SM for G2 (its
// 148 registers allow 13) and 20 for G1.  G1 takes the team too: on the
// card it ran faster than one thread a lane at 32768 lanes (PERF.md).  The
// digits differ per lane ([nsteps, B], read one word a step).  Bound: the
// Montgomery products, 7 + 16 a step for G1 and 16 + 43 for G2 (the add
// with a zero digit returns res and needs none).
//
// k_to_affine (serves pallas_kernels.py's mont_mul, mont_sqr, fq2_mul,
// fq2_sqr and pallas_fused.py's fq_pow, pk:239/247/175/181 and pf:1246,
// as bn254_tpu/groups.py to_affine and bn254_tpu/msm.py:133-156 run
// them): Jacobian points [3C, 16, B] -> affine (x, y) [2C, 16, B] and the
// infinity mask, in one launch.  The JAX MSM's shared inversion, block by
// block: each block inverts its lanes' denominators d (z for G1, the norm
// z0^2 + z1^2 for G2; d = 0, infinity, taken as 1) with one Fermat chain.
// Each thread holds K lanes, kAffineThreads apart (every load coalesced),
// and runs Montgomery's trick over them serially: its running product of
// d, kept at each lane in out's first coordinate (the lane's own slot,
// which the lane's x overwrites later), ends at the thread's total.  The
// block takes exclusive prefix and suffix products of the threads' totals
// by warp shuffles of the 8 words, then over the warps' totals (warp 0,
// through shared memory); lane 0 of warp 0 raises the block's total to
// q - 2 on fq_pow_chain, and warp 0 folds the inverse into each warp's
// factor (the warps before and after it).  A thread's total inverse is its
// two exclusive products times its warp's factor, and the backward pass
// gives each lane d^-1 from the running product of the lane before (two
// products a lane).  Then, in registers, z^-1 (d^-1, or (z0 d^-1, -z1
// d^-1), fq2_inv's form), z^-2, z^-3, x z^-2, y z^-3, written once with
// inf; a lane with d = 0 writes (0, 0) and inf = 1, as the per-lane
// route's inv(0) = 0 gives.  Every value is fully reduced, so the grouping
// of the products changes no limb.  The chain is serial on one thread
// while its block waits (about row 5's 0.19 ms), so the blocks of a wave
// run their chains side by side and waves run them one after another:
// the C entry takes the fewest lanes a thread that fit the batch in one
// wave (affine_lanes_per_thread), one lane a thread at the pairing's
// 16384.  Keeping the running products in out rather than in
// registers holds a thread's registers to the same count for any K.
// Bound: the products at 2^20 (about 3 a lane for the trick, 108/136 + 3
// G1 and 11.5 G2 for the coordinates); the serial depth is a block's
// chain, its scans and a thread's K lanes.
#include <algorithm>
#include <atomic>

#include "fq12_team.cuh"
#include "groups.cuh"

using namespace bn254;

namespace {

// pallas_fused.py _call_impl("g1_add"/"g2_add") (k_point_add)
template <class F>
__global__ void k_point_add(const int32_t* __restrict__ p, const int32_t* __restrict__ q,
                            int32_t* __restrict__ out, int B) {
  int lane = lane_index();
  if (lane >= B) return;
  Jac<F> a, b;
  load_pt(a, p, B, lane);
  load_pt(b, q, B, lane);
  point_add(a, a, b);
  store_pt(out, B, lane, a);
}

// pallas_fused.py _call_impl("g1_dbl"/"g2_dbl") (k_point_double)
template <class F>
__global__ void k_point_double(const int32_t* __restrict__ p, int32_t* __restrict__ out, int B) {
  int lane = lane_index();
  if (lane >= B) return;
  Jac<F> a;
  load_pt(a, p, B, lane);
  point_double(a, a);
  store_pt(out, B, lane, a);
}

// One affine point of the point-major copy: 2C Fq of 8 words each, x
// first, 16-byte aligned.
__device__ __forceinline__ void load_row(Fq& r, const uint32_t* p) { r = fq_load_words(p); }
__device__ __forceinline__ void load_row(Fq2& r, const uint32_t* p) {
  load_row(r.c0, p);
  load_row(r.c1, p + 8);
}

// pallas_fused.py _msm_acc_impl, the bucket order: thread (w, lane)
// sorts its tiles i (points i * lanes + lane) by bucket, stably.
__global__ void k_msm_bucket_sort(const int32_t* __restrict__ digits,
                                  int32_t* __restrict__ offsets, int32_t* __restrict__ order,
                                  int n, int W, int nb, int sgn, int lanes) {
  const int t = lane_index();
  if (t >= W * lanes) return;
  const int w = t / lanes, lane = t - w * lanes, tiles = n / lanes;
  int32_t* pos = offsets + (size_t)w * nb * lanes + lane;   // pos[b] at b * lanes
  const int32_t* dw = digits + (size_t)w * n + lane;
  for (int b = 0; b < nb; ++b) pos[(size_t)b * lanes] = 0;
  for (int i = 0; i < tiles; ++i) {
    const int d = dw[(size_t)i * lanes];
    pos[(size_t)(sgn && d < 0 ? -d : d) * lanes] += 1;
  }
  pos[0] = 0;
  int run = 0;
  for (int b = 1; b < nb; ++b) {  // pos[b] becomes the start of bucket b's run
    const int c = pos[(size_t)b * lanes];
    pos[(size_t)b * lanes] = run;
    run += c;
  }
  int32_t* ord = order + (size_t)w * tiles * lanes + lane;
  for (int i = 0; i < tiles; ++i) {  // each start moves to its bucket's end
    int d = dw[(size_t)i * lanes];
    if (sgn && d < 0) d = -d;
    if (d) ord[(size_t)(pos[(size_t)d * lanes]++) * lanes] = i;
  }
  for (int k = run; k < tiles; ++k) ord[(size_t)k * lanes] = -1;
}

// pallas_fused.py _msm_acc_impl, the accumulation: thread (w, b, lane)
// adds the points of its run, in tile order, into bucket b of window w.
template <class F>
__global__ void k_msm_accumulate(const uint32_t* __restrict__ words,
                                 const int32_t* __restrict__ digits,
                                 const int32_t* __restrict__ offsets,
                                 const int32_t* __restrict__ order,
                                 int32_t* __restrict__ buckets,
                                 int n, int W, int nb, int sgn, int lanes) {
  constexpr int C = kCoords<F>;
  const int t = lane_index();
  if (t >= W * (nb - 1) * lanes) return;
  const int wb = t / lanes, lane = t - wb * lanes;   // wb = w * (nb - 1) + b - 1
  const int w = wb / (nb - 1), b = wb - w * (nb - 1) + 1, tiles = n / lanes;
  const int32_t* off = offsets + (size_t)w * nb * lanes + lane;
  const int end = off[(size_t)b * lanes];
  const int32_t* ord = order + (size_t)w * tiles * lanes + lane;
  const int32_t* dw = digits + (size_t)w * n;
  Jac<F> acc;
  f_set_zero(acc.x); f_set_zero(acc.y); f_set_zero(acc.z);
  for (int k = off[(size_t)(b - 1) * lanes]; k < end; ++k) {
    const int idx = ord[(size_t)k * lanes] * lanes + lane;
    const uint32_t* row = words + (size_t)idx * 2 * C * 8;
    F qx, qy;
    load_row(qx, row);
    load_row(qy, row + C * 8);
    if (sgn && dw[idx] < 0) f_neg(qy, qy);
    if (point_madd_generic(acc, acc, qx, qy)) affine_double(acc, qx, qy);
  }
  store_pt(buckets + (size_t)wb * 3 * C * 16 * lanes, lanes, lane, acc);
}

// pallas_fused.py _msm_acc_impl, the reduce: thread (w, lane) takes the
// running sum of its buckets, total = sum_b b * bucket_b.
template <class F>
__global__ void k_msm_bucket_reduce(const int32_t* __restrict__ buckets,
                                    int32_t* __restrict__ out, int W, int nb, int lanes) {
  constexpr int C = kCoords<F>;
  const int t = lane_index();
  if (t >= W * lanes) return;
  const int w = t / lanes, lane = t - w * lanes;
  const size_t bucket_words = (size_t)3 * C * 16 * lanes;
  const int32_t* bk = buckets + (size_t)w * (nb - 1) * bucket_words;
  Jac<F> acc, tot;
  f_set_zero(acc.x); f_set_zero(acc.y); f_set_zero(acc.z);
  tot = acc;
  for (int b = nb - 1; b >= 1; --b) {
    Jac<F> bb;
    load_pt(bb, bk + (size_t)(b - 1) * bucket_words, lanes, lane);
    point_add<F>(acc, acc, bb);     // not inlined for G1 either (groups.cuh)
    point_add<F>(tot, tot, acc);
  }
  store_pt(out + (size_t)w * 3 * C * 16 * lanes, lanes, lane, tot);
}

// pallas_fused.py _glv_call_impl: the joint Strauss-Shamir ladder.  res
// starts at (0, 1, 0); per step it doubles, then adds the table point its
// digit picks (1: p1, 2: p2, 3: p12 at coordinates 3C (d - 1) of pts; 0:
// (0, 1, 0)), with the unified add's three-way select in its order:
// coincide -> double(p), q at infinity -> p, p at infinity -> q.
constexpr int kLadderTeam = 4, kLadderTeamsPerWarp = 32 / kLadderTeam;
template <class F> constexpr int kLadderWarps = 2;
template <> constexpr int kLadderWarps<Fq> = 4;
template <class F> constexpr int kLadderLanes = kLadderTeamsPerWarp * kLadderWarps<F>;
template <class F> constexpr int kLadderLaneWords = BN254_LADDER_SLOTS * kSlotWords<F>;
static __constant__ TeamRound kLadderRounds[BN254_LADDER_NROUNDS] = BN254_LADDER_ROUNDS;

template <class F>
__global__ void __launch_bounds__(32 * kLadderWarps<F>)
k_glv_ladder(const int32_t* __restrict__ digits, int nsteps, const int32_t* __restrict__ pts,
             int32_t* __restrict__ out, int B) {
  constexpr int C = kCoords<F>, T = kLadderTeam;
  __shared__ __align__(16) uint32_t s_lanes[kLadderLanes<F> * kLadderLaneWords<F>];
  const int k = threadIdx.x % T, slot = threadIdx.x / T;
  const int lane = blockIdx.x * kLadderLanes<F> + slot;
  const bool valid = lane < B;
  uint32_t* s = s_lanes + slot * kLadderLaneWords<F>;
  F v;
  if (valid) {         // res = (0, 1, 0); the table's 9 coordinates, k, k + 4, k + 8
    if (k < 3) {
      if (k == 1) f_set_one(v); else f_set_zero(v);
      st_s(s, BN254_LADDER_SLOT_RX + k, v);
    }
#pragma unroll 1
    for (int c = k; c < 9; c += T) {
      load(v, pts, C * c, B, lane);
      st_s(s, BN254_LADDER_SLOT_T1X + 5 * (c / 3) + c % 3, v);
    }
  }
  __syncwarp();
#pragma unroll 1
  for (int r = 0; r < BN254_LADDER_R_D1; ++r)        // the table's z^2, z^3
    team_round<F, T>(kLadderRounds[r], k, s, 0, valid);
#pragma unroll 1
  for (int i = 0; i < nsteps; ++i) {
    const int d = valid ? digits[(size_t)i * B + lane] : 0;
    const int vb = BN254_LADDER_SLOT_T1X + 5 * (d ? d - 1 : 0);   // q's slots
    bool p_inf = false, add = false, coincide = false;
    // j = 0-2: the double (every lane); 3-5: the add's rounds (3 where the
    // add runs, 4-5 where it does not coincide); 6-8: the double again on
    // the coincide lanes, if a lane of the warp has one
#pragma unroll 1
    for (int j = 0; j < 9; ++j) {
      if (j == 6 && !__any_sync(0xFFFFFFFFu, coincide)) break;
      const int r = (j < 3 || j >= 6 ? BN254_LADDER_R_D1 : BN254_LADDER_R_A1) + j % 3;
      const bool active = j < 3 ? valid : j == 3 ? add : j < 6 ? add && !coincide : coincide;
      team_round<F, T>(kLadderRounds[r], k, s, vb, active);
      if (j == 2) {
        ld_s(v, s, BN254_LADDER_SLOT_RX + 2);
        p_inf = f_is_zero(v);
        ld_s(v, s, vb + 2);
        add = valid && !p_inf && d != 0 && !f_is_zero(v);
      } else if (j == 3) {
        F rr;
        ld_s(v, s, BN254_LADDER_SLOT_S0);
        ld_s(rr, s, BN254_LADDER_SLOT_S5);
        coincide = add && f_is_zero(v) && f_is_zero(rr);
      }
    }
    if (valid && p_inf && k < 3) {      // res = q: the table point, or (0, 1, 0)
      if (d) ld_s(v, s, vb + k);
      else if (k == 1) f_set_one(v);
      else f_set_zero(v);
      st_s(s, BN254_LADDER_SLOT_RX + k, v);
    }
    __syncwarp();
  }
  if (valid && k < 3) {
    ld_s(v, s, BN254_LADDER_SLOT_RX + k);
    store(out, C * k, B, lane, v);
  }
}

// bn254_tpu/msm.py's Horner scan and roll fold over pallas_fused.py
// k_point_double / k_point_add (pf:769/789): Horner for the thread's lane,
// then the block's tree; thread 0 writes the block's partial at lane
// blockIdx.x of out [3C, 16, gridDim.x].  lanes is a multiple of the
// block size (both powers of two), so every thread has a lane.
template <class F>
__global__ void __launch_bounds__(BN254_THREADS)
k_msm_combine(const int32_t* __restrict__ totals, int W, int c, int32_t* __restrict__ out,
              int lanes) {
  constexpr int C = kCoords<F>;
  __shared__ Jac<F> s[BN254_THREADS];
  const int t = threadIdx.x, lane = lane_index();
  const size_t window = (size_t)3 * C * 16 * lanes;
  Jac<F> res, tw;
  load_pt(res, totals + (size_t)(W - 1) * window, lanes, lane);
#pragma unroll 1
  for (int w = W - 2; w >= 0; --w) {
#pragma unroll 1
    for (int j = 0; j < c; ++j) point_double(res, res);
    load_pt(tw, totals + (size_t)w * window, lanes, lane);
    point_add(res, res, tw);
  }
  s[t] = res;
  __syncthreads();
#pragma unroll 1
  for (int k = 1; k < (int)blockDim.x; k *= 2) {
    if (t % (2 * k) == 0) {
      Jac<F> a = s[t];
      const Jac<F> b = s[t + k];
      point_add(a, a, b);
      s[t] = a;
    }
    __syncthreads();
  }
  if (t == 0) store_pt(out, gridDim.x, blockIdx.x, s[0]);
}

// bn254_tpu/groups.py's scalar_mul scan over k_point_double / k_point_add
// (pf:769/789): res = (0, 1, 0); per bit, high to low, a double and, where
// the bit is set, the add of the base.
template <class F>
__global__ void k_point_mul(const int32_t* __restrict__ p, const int32_t* __restrict__ k,
                            int nbits, int32_t* __restrict__ out, int B) {
  const int lane = lane_index();
  if (lane >= B) return;
  Jac<F> base, res;
  load_pt(base, p, B, lane);
  f_set_zero(res.x); f_set_one(res.y); f_set_zero(res.z);
  uint32_t word = 0;
#pragma unroll 1
  for (int i = nbits - 1; i >= 0; --i) {
    if (i == nbits - 1 || i % 16 == 15) word = (uint32_t)k[(size_t)(i / 16) * B + lane];
    point_double(res, res);
    if ((word >> (i % 16)) & 1u) point_add(res, res, base);
  }
  store_pt(out, B, lane, res);
}

// k_to_affine's block and its cap of blocks an SM (one Fermat chain a
// scheduler; more chains an SM, or more waves, ran slower: PERF.md)
constexpr int kAffineThreads = 128, kAffineWarps = kAffineThreads / 32, kAffineBlocksPerSm = 4;

__device__ __forceinline__ Fq shfl_up(const Fq& a, int k) {
  Fq r;
#pragma unroll
  for (int j = 0; j < 8; ++j) r.v[j] = __shfl_up_sync(0xFFFFFFFFu, a.v[j], k);
  return r;
}

__device__ __forceinline__ Fq shfl_down(const Fq& a, int k) {
  Fq r;
#pragma unroll
  for (int j = 0; j < 8; ++j) r.v[j] = __shfl_down_sync(0xFFFFFFFFu, a.v[j], k);
  return r;
}

__device__ __forceinline__ Fq shfl_idx(const Fq& a, int src) {
  Fq r;
#pragma unroll
  for (int j = 0; j < 8; ++j) r.v[j] = __shfl_sync(0xFFFFFFFFu, a.v[j], src);
  return r;
}

// Exclusive products of a over the warp's first n lanes (n <= 32): pre =
// the lanes below, suf = the lanes above, each 1 at its end; the n lanes'
// product comes back in total.
__device__ __forceinline__ void warp_exclusive(Fq& pre, Fq& suf, Fq& total, const Fq& a,
                                               int n) {
  const int wl = threadIdx.x % 32;
  Fq inc = a, sinc = a;
#pragma unroll 1
  for (int k = 1; k < n; k *= 2) {
    const Fq up = shfl_up(inc, k), down = shfl_down(sinc, k);
    if (wl >= k) fq_mul(inc, inc, up);
    if (wl + k < n) fq_mul(sinc, sinc, down);
  }
  total = shfl_idx(inc, n - 1);
  pre = shfl_up(inc, 1);
  suf = shfl_down(sinc, 1);
  if (wl == 0) pre = fq_const_one();
  if (wl == n - 1) suf = fq_const_one();
}

// The lane's z and its denominator d: z itself (G1) or the norm z0^2 +
// z1^2 (G2), taken as 1 where it is 0; returns whether it was 0.
__device__ __forceinline__ void affine_denom(Fq& d, const Fq& z) { d = z; }
__device__ __forceinline__ void affine_denom(Fq& d, const Fq2& z) {
  Fq s;
  fq_sqr(d, z.c0);
  fq_sqr(s, z.c1);
  fq_add(d, d, s);
}

template <class F>
__device__ __forceinline__ bool affine_load_denom(F& z, Fq& d, const int32_t* p, int B,
                                                  int lane) {
  load(z, p, 2 * kCoords<F>, B, lane);
  affine_denom(d, z);
  const bool zero = f_is_zero(d);
  if (zero) d = fq_const_one();
  return zero;
}

// z^-1 from d^-1: d^-1 itself (G1), (z0 d^-1, -z1 d^-1) (G2, fq2_inv's form)
__device__ __forceinline__ void affine_zinv(Fq& r, const Fq& z, const Fq& dinv) { r = dinv; }
__device__ __forceinline__ void affine_zinv(Fq2& r, const Fq2& z, const Fq& dinv) {
  Fq t;
  fq_mul(r.c0, z.c0, dinv);
  fq_mul(t, z.c1, dinv);
  fq_neg(r.c1, t);
}

// bn254_tpu/groups.py to_affine with bn254_tpu/msm.py:133-156's shared
// inversion, one Fermat chain a block: lane j of thread t is
// blockIdx.x * K * kAffineThreads + j * kAffineThreads + t, j < K.  The
// thread's prefix products wait in out's first coordinate (each lane's
// own slot) between the two passes.
template <class F>
__global__ void __launch_bounds__(kAffineThreads)
k_to_affine(const int32_t* __restrict__ digits, int ndigits, const int32_t* __restrict__ p,
            int32_t* __restrict__ out, uint8_t* __restrict__ inf, int K, int B) {
  constexpr int C = kCoords<F>, T = kAffineThreads;
  __shared__ Fq s_tot[kAffineWarps];      // each warp's total, then its factor
  const int t = threadIdx.x, w = t / 32;
  const int first = blockIdx.x * K * T + t;    // K lanes a thread (affine_lanes_per_thread)
  const int n = first < B ? min(K, (B - first + T - 1) / T) : 0;   // the thread's lanes
  F z;
  Fq d, run = fq_const_one();
#pragma unroll 1
  for (int j = 0; j < n; ++j) {            // run = d[0] ... d[j], kept at lane j
    const int lane = first + j * T;
    affine_load_denom(z, d, p, B, lane);
    if (j) fq_mul(run, run, d);
    else run = d;
    store(out, 0, B, lane, run);
  }
  Fq ex_pre, ex_suf, total;
  warp_exclusive(ex_pre, ex_suf, total, run, 32);
  if (t % 32 == 0) s_tot[w] = total;
  __syncthreads();
  if (w == 0) {       // the warps' totals: each warp's factor, the block's inverse in it
    Fq wp, ws, tinv;
    warp_exclusive(wp, ws, total, t < kAffineWarps ? s_tot[t] : fq_const_one(), kAffineWarps);
    if (t == 0) fq_pow_chain(tinv, total, PowDigits{digits, ndigits});
    tinv = shfl_idx(tinv, 0);
    if (t < kAffineWarps) {
      fq_mul(wp, wp, ws);
      fq_mul(s_tot[t], wp, tinv);
    }
  }
  __syncthreads();
  Fq inv;                                  // the inverse of run, the thread's total
  fq_mul(inv, ex_pre, ex_suf);
  fq_mul(inv, inv, s_tot[w]);
#pragma unroll 1
  for (int j = n - 1; j >= 0; --j) {       // Montgomery's trick backwards
    const int lane = first + j * T;
    const bool zero = affine_load_denom(z, d, p, B, lane);
    Fq dinv = inv;
    if (j) {
      Fq prev;
      load(prev, out, 0, B, lane - T);
      fq_mul(dinv, inv, prev);
      fq_mul(inv, inv, d);
    }
    F x, y;
    if (zero) {
      f_set_zero(x);
      f_set_zero(y);
    } else {
      F zinv, zi2, zi3;
      affine_zinv(zinv, z, dinv);
      f_sqr(zi2, zinv);
      f_mul(zi3, zi2, zinv);
      load(x, p, 0, B, lane);
      load(y, p, C, B, lane);
      f_mul(x, x, zi2);
      f_mul(y, y, zi3);
    }
    store(out, 0, B, lane, x);
    store(out, C, B, lane, y);
    inf[lane] = zero;
  }
}

// K, the lanes a thread: the fewest that fit the batch in one wave of
// blocks, at most kAffineBlocksPerSm blocks an SM and no more than the
// registers let reside (the occupancy query).  One lane a thread at the
// pairing's 16384 lanes.  The wave is queried once for each device;
// returns the error of a failed query.
constexpr int kMaxDevices = 64;

template <class F>
cudaError_t affine_lanes_per_thread(int B, int& K) {
  static std::atomic<int> waves[kMaxDevices];   // blocks of one wave, 0 until queried
  int dev = 0;
  cudaError_t rc = cudaGetDevice(&dev);
  if (rc == cudaSuccess && dev >= kMaxDevices) rc = cudaErrorInvalidDevice;
  if (rc != cudaSuccess) return rc;
  int wave = waves[dev].load(std::memory_order_relaxed);
  if (!wave) {
    int sms = 0, resident = 0;
    rc = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (rc == cudaSuccess)
      rc = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&resident, k_to_affine<F>,
                                                         kAffineThreads, 0);
    if (rc == cudaSuccess && (sms < 1 || resident < 1)) rc = cudaErrorInvalidConfiguration;
    if (rc != cudaSuccess) return rc;
    wave = sms * std::min(resident, kAffineBlocksPerSm);
    waves[dev].store(wave, std::memory_order_relaxed);
  }
  const int threads = (B + kAffineThreads - 1) / kAffineThreads;
  K = threads > wave ? (threads + wave - 1) / wave : 1;
  return cudaSuccess;
}

}  // namespace

extern "C" {

int bn254_point_add(int ncoords, const int32_t* p, const int32_t* q, int32_t* out, int B,
                    cudaStream_t stream) {
  if (ncoords == 1) {
    BN254_LAUNCH(k_point_add<Fq>, p, q, out);
  }
  BN254_LAUNCH(k_point_add<Fq2>, p, q, out);
}

int bn254_point_double(int ncoords, const int32_t* p, int32_t* out, int B, cudaStream_t stream) {
  if (ncoords == 1) {
    BN254_LAUNCH(k_point_double<Fq>, p, out);
  }
  BN254_LAUNCH(k_point_double<Fq2>, p, out);
}

// B = lanes for the three MSM entries; grids of W * lanes threads (sort,
// reduce) and W * (nb - 1) * lanes threads (accumulate).
int bn254_msm_bucket_sort(const int32_t* digits, int32_t* offsets, int32_t* order, int n, int W,
                          int nb, int sgn, int B, cudaStream_t stream) {
  const int blocks = (W * B + BN254_THREADS - 1) / BN254_THREADS;
  k_msm_bucket_sort<<<blocks, BN254_THREADS, 0, stream>>>(digits, offsets, order, n, W, nb, sgn,
                                                          B);
  return static_cast<int>(cudaGetLastError());
}

int bn254_msm_accumulate(int ncoords, const uint32_t* words, const int32_t* digits,
                         const int32_t* offsets, const int32_t* order, int32_t* buckets, int n,
                         int W, int nb, int sgn, int B, cudaStream_t stream) {
  const int blocks = (W * (nb - 1) * B + BN254_THREADS - 1) / BN254_THREADS;
  if (ncoords == 1)
    k_msm_accumulate<Fq><<<blocks, BN254_THREADS, 0, stream>>>(words, digits, offsets, order,
                                                                buckets, n, W, nb, sgn, B);
  else
    k_msm_accumulate<Fq2><<<blocks, BN254_THREADS, 0, stream>>>(words, digits, offsets, order,
                                                                 buckets, n, W, nb, sgn, B);
  return static_cast<int>(cudaGetLastError());
}

int bn254_msm_bucket_reduce(int ncoords, const int32_t* buckets, int32_t* out, int W, int nb,
                            int B, cudaStream_t stream) {
  const int blocks = (W * B + BN254_THREADS - 1) / BN254_THREADS;
  if (ncoords == 1)
    k_msm_bucket_reduce<Fq><<<blocks, BN254_THREADS, 0, stream>>>(buckets, out, W, nb, B);
  else
    k_msm_bucket_reduce<Fq2><<<blocks, BN254_THREADS, 0, stream>>>(buckets, out, W, nb, B);
  return static_cast<int>(cudaGetLastError());
}

int bn254_glv_ladder(int ncoords, const int32_t* digits, int nsteps, const int32_t* pts,
                     int32_t* out, int B, cudaStream_t stream) {
  if (ncoords == 1)
    k_glv_ladder<Fq><<<(B + kLadderLanes<Fq> - 1) / kLadderLanes<Fq>, 32 * kLadderWarps<Fq>, 0,
                       stream>>>(digits, nsteps, pts, out, B);
  else
    k_glv_ladder<Fq2><<<(B + kLadderLanes<Fq2> - 1) / kLadderLanes<Fq2>, 32 * kLadderWarps<Fq2>,
                        0, stream>>>(digits, nsteps, pts, out, B);
  return static_cast<int>(cudaGetLastError());
}

// Level 0 runs Horner over the W windows and each block's tree over the
// B lanes; each further level runs the kernel with W = 1 over the block
// partials of the level before, in blocks of up to BN254_THREADS, until
// one block is left, which writes out [3C, 16, 1].  scratch holds two
// partial buffers, n1 = B / BN254_THREADS and n1 / BN254_THREADS points
// (none when B <= BN254_THREADS); the levels take them in turn.  B is a
// power of two.
int bn254_msm_combine(int ncoords, const int32_t* totals, int W, int c, int32_t* scratch,
                      int32_t* out, int B, cudaStream_t stream) {
  const size_t words = (size_t)3 * ncoords * 16;
  int32_t* partials[2] = {scratch, scratch + words * (B / BN254_THREADS)};
  const int32_t* in = totals;
  for (int n = B, level = 0;; ++level) {
    const int threads = n < BN254_THREADS ? n : BN254_THREADS, blocks = n / threads;
    int32_t* dst = blocks == 1 ? out : partials[level & 1];
    if (ncoords == 1)
      k_msm_combine<Fq><<<blocks, threads, 0, stream>>>(in, level ? 1 : W, c, dst, n);
    else
      k_msm_combine<Fq2><<<blocks, threads, 0, stream>>>(in, level ? 1 : W, c, dst, n);
    const int rc = static_cast<int>(cudaGetLastError());
    if (rc || blocks == 1) return rc;
    in = dst;
    n = blocks;
  }
}

// k_to_affine's shape at batch B on the current device: K lanes a thread
// and the threads of a block.  A failed query's error is returned, and
// cleared so that no later launch reports it.
int bn254_to_affine_geometry(int ncoords, int B, int* lanes, int* threads) {
  *threads = kAffineThreads;
  const cudaError_t rc = ncoords == 1 ? affine_lanes_per_thread<Fq>(B, *lanes)
                                      : affine_lanes_per_thread<Fq2>(B, *lanes);
  if (rc != cudaSuccess) cudaGetLastError();
  return static_cast<int>(rc);
}

// blocks of kAffineThreads threads, K * kAffineThreads lanes
int bn254_to_affine(int ncoords, const int32_t* digits, int ndigits, const int32_t* p,
                    int32_t* out, uint8_t* inf, int B, cudaStream_t stream) {
  int K = 1, threads = 0;
  if (const int rc = bn254_to_affine_geometry(ncoords, B, &K, &threads)) return rc;
  const int blocks = (B + K * kAffineThreads - 1) / (K * kAffineThreads);
  if (ncoords == 1)
    k_to_affine<Fq><<<blocks, kAffineThreads, 0, stream>>>(digits, ndigits, p, out, inf, K, B);
  else
    k_to_affine<Fq2><<<blocks, kAffineThreads, 0, stream>>>(digits, ndigits, p, out, inf, K, B);
  return static_cast<int>(cudaGetLastError());
}

int bn254_point_mul(int ncoords, const int32_t* p, const int32_t* k, int nbits, int32_t* out,
                    int B, cudaStream_t stream) {
  if (ncoords == 1) {
    BN254_LAUNCH(k_point_mul<Fq>, p, k, nbits, out);
  }
  BN254_LAUNCH(k_point_mul<Fq2>, p, k, nbits, out);
}

}  // extern "C"
