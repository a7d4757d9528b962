// Throughput probes (queue rows 21-22), replacing scripts/bench_mont.py
// _chain_call and scripts/bench_tower.py _chain_call.
//
// Each lane loads its operands once, applies one op `chain` times to its
// running value (value = op(value, b)) and stores the result once, so a
// launch times the op's body without dispatch or device-memory traffic.
// The chain length is a kernel argument, so the compiler cannot fold the
// loop; every step depends on the one before, so none can be skipped.
//
// k_chain_mont: the CIOS Montgomery product (mul: value * b) or square
// (sqr: value * value) over Fq, the body of rows 1-2, with the value in
// registers.  k_chain_tower: one tower op of bench_tower.py's OPS table
// per instantiation (one kernel each, so each gets its own register
// allocation); the Fq2-and-up ops are bn254.cuh's __noinline__ functions,
// whose arguments pass through the thread's stack: that local-memory
// traffic is part of what the tower probe measures.
//
// Bound: integer multiply-adds only (a product is about 350 instructions
// of 32-bit CIOS); bytes are two operands in and one out per lane.
#include "bn254.cuh"

using namespace bn254;

namespace {

template <bool SQR>
__global__ void k_chain_mont(const int32_t* __restrict__ a, const int32_t* __restrict__ b,
                             int32_t* __restrict__ out, int chain, int B) {
  int lane = lane_index();
  if (lane >= B) return;
  Fq x, y;
  load(x, a, 0, B, lane);
  load(y, b, 0, B, lane);
  for (int i = 0; i < chain; ++i) {
    if (SQR) fq_mul(x, x, x);
    else fq_mul(x, x, y);
  }
  store(out, 0, B, lane, x);
}

// bench_tower.py OPS, in its order: value type and one step
struct OpFqMul { using T = Fq; static __device__ void step(T& x, const T& y) { fq_mul(x, x, y); } };
struct OpFq2Mul { using T = Fq2; static __device__ void step(T& x, const T& y) { fq2_mul_lazy(x, x, y); } };
struct OpFq2Sqr { using T = Fq2; static __device__ void step(T& x, const T&) { fq2_sqr(x, x); } };
struct OpFq6Mul { using T = Fq6; static __device__ void step(T& x, const T& y) { fq6_mul(x, x, y); } };
struct OpFq12Sqr { using T = Fq12; static __device__ void step(T& x, const T&) { fq12_sqr(x, x); } };
struct OpFq12Mul { using T = Fq12; static __device__ void step(T& x, const T& y) { fq12_mul(x, x, y); } };
struct OpCycloSqr { using T = Fq12; static __device__ void step(T& x, const T&) { fq12_cyclotomic_sqr(x, x); } };

// A tower value is its Fq coordinates in order (the packed layout), so it
// loads and stores as an array of Fq.
template <typename T>
__device__ __forceinline__ void load_coords(T& r, const int32_t* base, int B, int lane) {
  Fq* c = reinterpret_cast<Fq*>(&r);
#pragma unroll
  for (int k = 0; k < (int)(sizeof(T) / sizeof(Fq)); ++k) load(c[k], base, k, B, lane);
}

template <typename T>
__device__ __forceinline__ void store_coords(int32_t* base, int B, int lane, const T& a) {
  const Fq* c = reinterpret_cast<const Fq*>(&a);
#pragma unroll
  for (int k = 0; k < (int)(sizeof(T) / sizeof(Fq)); ++k) store(base, k, B, lane, c[k]);
}

template <typename Op>
__global__ void k_chain_tower(const int32_t* __restrict__ a, const int32_t* __restrict__ b,
                              int32_t* __restrict__ out, int chain, int B) {
  int lane = lane_index();
  if (lane >= B) return;
  typename Op::T x, y;
  load_coords(x, a, B, lane);
  load_coords(y, b, B, lane);
  for (int i = 0; i < chain; ++i) Op::step(x, y);
  store_coords(out, B, lane, x);
}

}  // namespace

extern "C" {

// impl: 0 = mul, 1 = sqr
int bn254_chain_mont(int impl, const int32_t* a, const int32_t* b, int32_t* out, int chain,
                     int B, cudaStream_t stream) {
  if (impl) {
    BN254_LAUNCH(k_chain_mont<true>, a, b, out, chain);
  }
  BN254_LAUNCH(k_chain_mont<false>, a, b, out, chain);
}

// op: the index in bench_tower.py's OPS (fq_mul, fq2_mul, fq2_sqr,
// fq6_mul, fq12_sqr, fq12_mul, cyclo_sqr)
int bn254_chain_tower(int op, const int32_t* a, const int32_t* b, int32_t* out, int chain,
                      int B, cudaStream_t stream) {
  switch (op) {
    case 0: { BN254_LAUNCH(k_chain_tower<OpFqMul>, a, b, out, chain); }
    case 1: { BN254_LAUNCH(k_chain_tower<OpFq2Mul>, a, b, out, chain); }
    case 2: { BN254_LAUNCH(k_chain_tower<OpFq2Sqr>, a, b, out, chain); }
    case 3: { BN254_LAUNCH(k_chain_tower<OpFq6Mul>, a, b, out, chain); }
    case 4: { BN254_LAUNCH(k_chain_tower<OpFq12Sqr>, a, b, out, chain); }
    case 5: { BN254_LAUNCH(k_chain_tower<OpFq12Mul>, a, b, out, chain); }
    case 6: { BN254_LAUNCH(k_chain_tower<OpCycloSqr>, a, b, out, chain); }
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // extern "C"
