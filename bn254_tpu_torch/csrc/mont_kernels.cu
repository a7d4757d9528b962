// Montgomery and Fq2 kernels (queue rows 1-4), replacing
// bn254_tpu/pallas_kernels.py:_mont_mul_kernel, _mont_sqr_kernel,
// _fq2_mul_kernel and _fq2_sqr_kernel.
//
// One thread per batch lane; the lane's operands are loaded from the
// [c, 16, B] limb layout (coalesced across the warp), repacked to 8x32-bit
// words, multiplied by CIOS and stored back as 16-bit limbs.
//
// Bound: about 130 32x32->64 multiply-adds per Montgomery product against
// 64 bytes read per Fq operand, so a single product is memory-bound on the
// card in principle; at the path's batch (16384 lanes, 3 MB moved) a call
// is bound by its wrapper's host overhead instead (about 30 us per call on
// an H100 80GB HBM3 at 700 W, against the microseconds the card needs).
// The design keeps each operand to one coalesced read and the product in
// registers (40-48 registers and no local memory for mont_mul/mont_sqr;
// the Fq2 kernels hand their operands to the __noinline__ Fq2 functions
// through a 128-192 byte stack frame).  mont_mul/mont_sqr take the modulus
// as a kernel argument (it lands in the constant bank) and serve Fr as
// well as Fq; the Fq2 kernels use Fq's modulus from the generated header.
#include "bn254.cuh"

using namespace bn254;

namespace {

__global__ void k_mont_mul(const int32_t* __restrict__ a, const int32_t* __restrict__ b,
                           int32_t* __restrict__ out, Modulus m, int B) {
  int lane = lane_index();
  if (lane >= B) return;
  Fq x, y, r;
  load(x, a, 0, B, lane);
  load(y, b, 0, B, lane);
  mont_mul(r, x, y, m);
  store(out, 0, B, lane, r);
}

__global__ void k_mont_sqr(const int32_t* __restrict__ a, int32_t* __restrict__ out,
                           Modulus m, int B) {
  int lane = lane_index();
  if (lane >= B) return;
  Fq x, r;
  load(x, a, 0, B, lane);
  mont_mul(r, x, x, m);
  store(out, 0, B, lane, r);
}

__global__ void k_fq2_mul(const int32_t* __restrict__ a, const int32_t* __restrict__ b,
                          int32_t* __restrict__ out, int B) {
  int lane = lane_index();
  if (lane >= B) return;
  Fq2 x, y, r;
  load(x, a, 0, B, lane);
  load(y, b, 0, B, lane);
  fq2_mul(r, x, y);
  store(out, 0, B, lane, r);
}

__global__ void k_fq2_sqr(const int32_t* __restrict__ a, int32_t* __restrict__ out, int B) {
  int lane = lane_index();
  if (lane >= B) return;
  Fq2 x, r;
  load(x, a, 0, B, lane);
  fq2_sqr(r, x);
  store(out, 0, B, lane, r);
}

Modulus modulus_of(const uint32_t* words) {
  Modulus m;
  for (int j = 0; j < 8; ++j) m.q[j] = words[j];
  m.qinv = words[8];
  return m;
}

}  // namespace

extern "C" {

const char* bn254_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

int bn254_mont_mul(const int32_t* a, const int32_t* b, int32_t* out, const uint32_t* words,
                   int B, cudaStream_t stream) {
  BN254_LAUNCH(k_mont_mul, a, b, out, modulus_of(words));
}

int bn254_mont_sqr(const int32_t* a, int32_t* out, const uint32_t* words, int B,
                   cudaStream_t stream) {
  BN254_LAUNCH(k_mont_sqr, a, out, modulus_of(words));
}

int bn254_fq2_mul(const int32_t* a, const int32_t* b, int32_t* out, int B,
                  cudaStream_t stream) {
  BN254_LAUNCH(k_fq2_mul, a, b, out);
}

int bn254_fq2_sqr(const int32_t* a, int32_t* out, int B, cudaStream_t stream) {
  BN254_LAUNCH(k_fq2_sqr, a, out);
}

}  // extern "C"
