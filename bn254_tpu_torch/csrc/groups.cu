// Group-law, Pippenger and GLV kernels (queue rows 17-20), replacing the
// bn254_tpu/pallas_fused.py kernels named beside each one below.  Each is
// a template on the coordinate field: Fq for G1, Fq2 for G2; the C entry
// takes ncoords (1 or 2) and picks the instance.
//
// k_point_add / k_point_double: one thread per batch lane, 128-thread
// blocks, the ragged edge masked, operands read once and the result
// written once, as the other fused kernels.  Bound: the Montgomery
// products (16 for a G1 add, 43 for a G2 add; 7 and 16 for a double) and,
// at their one-op-per-launch size, the 6-18 words a lane moves per
// product: both are small, so at the main path's batches the launch
// itself dominates.
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
// 134 registers and 1,728 bytes for G2, whose Fq2 products stay
// __noinline__ (bn254.cuh).
//
// k_msm_bucket_reduce: one thread per (window, lane) reads its buckets
// coalesced and takes the running sum, b = nb - 1 .. 1 (2 full adds a
// bucket), writing its window total into [W, 3C, 16, lanes].  About a
// tenth of the accumulate's products for G1 2^20, a third for G2 2^16,
// on only W * lanes threads.
//
// k_glv_ladder (pallas_fused.py _glv_call_impl, queue row 20): one thread
// per lane runs all 128 steps.  The TPU kernel keeps res and the three
// table points in VMEM; four G2 points are 768 bytes a thread, past the
// register file beside the add's temporaries, so here only res stays with
// the thread and each step reads the one table point its digit picks from
// device memory (lane-minor, so the loads coalesce; the 9C x 16 words of a
// lane's table stay in L1/L2 across the steps).  The digits differ per
// lane ([nsteps, B], read one word a step), so a warp diverges only
// inside point_add (coincide) and on the load.  Bound: the Montgomery
// products, 7 + 16 a step for G1 and 16 + 43 for G2 (the add with a zero
// digit returns res and needs none).
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
    point_add(acc, acc, bb);
    point_add(tot, tot, acc);
  }
  store_pt(out + (size_t)w * 3 * C * 16 * lanes, lanes, lane, tot);
}

// pallas_fused.py _glv_call_impl: the joint Strauss-Shamir ladder.  res
// starts at (0, 1, 0); per step it doubles, then adds the table point
// its digit picks (1: p1, 2: p2, 3: p12 at coordinates 3C (d - 1) of pts;
// 0: (0, 1, 0), which point_add returns res for unless res is at infinity
// too, as the scan spelling's add).  A lane whose res meets its table
// point takes point_add's coincide branch.
template <class F>
__global__ void k_glv_ladder(const int32_t* __restrict__ digits, int nsteps,
                             const int32_t* __restrict__ pts, int32_t* __restrict__ out, int B) {
  constexpr int C = kCoords<F>;
  const int lane = lane_index();
  if (lane >= B) return;
  Jac<F> res, inf, t;
  f_set_zero(inf.x); f_set_one(inf.y); f_set_zero(inf.z);
  res = inf;
  for (int i = 0; i < nsteps; ++i) {
    point_double(res, res);
    const int d = digits[(size_t)i * B + lane];
    if (d == 0) t = inf;
    else load_pt(t, pts + (size_t)(d - 1) * 3 * C * 16 * B, B, lane);
    point_add(res, res, t);
  }
  store_pt(out, B, lane, res);
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
  if (ncoords == 1) {
    BN254_LAUNCH(k_glv_ladder<Fq>, digits, nsteps, pts, out);
  }
  BN254_LAUNCH(k_glv_ladder<Fq2>, digits, nsteps, pts, out);
}

}  // extern "C"
