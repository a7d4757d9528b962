// Group-law and Pippenger kernels (queue rows 17-19), replacing the
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
// k_msm_accumulate (pallas_fused.py _msm_acc_impl): one thread per
// (window, lane).  The TPU kernel's grid runs (window, point tile) in
// order and keeps one window's buckets in VMEM, gathering and scattering
// them with a one-hot select sweep; here each thread walks the n / lanes
// point tiles in a loop (the TPU's sequential grid axis), reads its
// bucket |d| directly from a scratch tensor in device memory laid out
// [W, nb - 1, 3C, 16, lanes] (neighbouring lanes on neighbouring words),
// adds the affine point with the mixed add, patches the coincide case
// with the affine double, and writes the bucket back; a zero digit
// (padding, infinity, zero scalars) skips the tile and writes nothing.
// Then the thread reduces its own buckets by the running sum and writes
// its window total.  Bound: the madds' Montgomery products (11 per G1
// point, 30 per G2 point, per window) and the reduce's full adds; the
// bucket traffic is uncoalesced (lanes of one warp hold different
// digits), and the G2 bucket point (18 Fq) does not fit the registers
// beside the formula's temporaries, so the __noinline__ point functions
// work through the stack.  No shared-memory buckets, no sorting: a simple
// kernel that is right first.
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

// pallas_fused.py _msm_acc_impl: thread (w, lane) accumulates the points
// i = t * lanes + lane, t = 0 .. n / lanes - 1, into window w's buckets
// of that lane, then reduces them: total = sum_b b * bucket_b.
template <class F>
__global__ void k_msm_accumulate(const int32_t* __restrict__ pts,
                                 const int32_t* __restrict__ digits,
                                 int32_t* __restrict__ buckets, int32_t* __restrict__ out,
                                 int n, int W, int nb, int sgn, int lanes) {
  constexpr int C = kCoords<F>;
  const int t = lane_index();
  if (t >= W * lanes) return;
  const int w = t / lanes, lane = t - w * lanes;
  const size_t bucket_words = (size_t)3 * C * 16 * lanes;
  int32_t* bk = buckets + (size_t)w * (nb - 1) * bucket_words;
  const int32_t* dw = digits + (size_t)w * n;
  const int tiles = n / lanes;

  for (int i = 0; i < tiles; ++i) {
    const int idx = i * lanes + lane;
    int d = dw[idx];
    if (d == 0) continue;
    F qx, qy;
    load(qx, pts, 0, n, idx);
    load(qy, pts, C, n, idx);
    if (sgn && d < 0) {
      f_neg(qy, qy);
      d = -d;
    }
    int32_t* slot = bk + (size_t)(d - 1) * bucket_words;
    Jac<F> cur;
    load_pt(cur, slot, lanes, lane);
    if (point_madd_generic(cur, cur, qx, qy)) affine_double(cur, qx, qy);
    store_pt(slot, lanes, lane, cur);
  }

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

// B = lanes; W * lanes threads
int bn254_msm_accumulate(int ncoords, const int32_t* pts, const int32_t* digits,
                         int32_t* buckets, int32_t* out, int n, int W, int nb, int sgn, int B,
                         cudaStream_t stream) {
  const int blocks = (W * B + BN254_THREADS - 1) / BN254_THREADS;
  if (ncoords == 1)
    k_msm_accumulate<Fq><<<blocks, BN254_THREADS, 0, stream>>>(pts, digits, buckets, out, n, W,
                                                                nb, sgn, B);
  else
    k_msm_accumulate<Fq2><<<blocks, BN254_THREADS, 0, stream>>>(pts, digits, buckets, out, n, W,
                                                                 nb, sgn, B);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
