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
// registers, one thread a lane.  It is also the tower probe's fq_mul:
// at the probe's 8192 lanes that is 256 warps for the card's 528
// schedulers, so the chain's latency, not the issue rate, sets its time
// by construction (row 21).
//
// The tower probe's other ops run on the engine the main path runs them
// on, so their in-chain rates are the ones the pairing kernels get
// (bench_tower.py's OPS; one kernel instance an op family, each with its
// own register allocation, no stack):
//   fq2_mul, fq2_sqr   k_chain_fq2: the three-thread Fq2 step
//                      (fq12_team.cuh team3_*), ten lanes a warp, the
//                      value in every team thread's registers, 40 lanes a
//                      block; a step's serial depth is one 512-bit product
//                      and one reduction, where one thread runs three
//                      products and two reductions (a square: two CIOS
//                      products)
//   fq6_mul            k_chain_team<OpFq6Mul>: one round of
//                      probe_schedule.FQ6_MUL on team_round, the six lazy
//                      Fq2 products one a thread, then the coefficients
//   fq12_mul           k_chain_team<OpFq12Mul>: team_fq12_mul_products /
//                      _coeff (rows 9 and 11)
//   cyclo_sqr          k_chain_team<OpCycloSqr>: team_cyc_sqr_products /
//                      _coeff (rows 10 and 11)
//   fq12_sqr           k_chain_team<OpFq12Sqr>: loop_schedule.SQR on
//                      team_round (rows 8l and 13)
// The six-thread ops keep the lane's value in shared memory for the whole
// chain, in row 9's geometry (five lanes a warp, 20 lanes a block).  At
// the probe's 8192 lanes each team beat the inlined one-thread body of
// its op (fq6_mul's spills at 255 registers); at 262144 lanes, where one
// thread a lane fills the card, the Fq2 team's extra instructions cost it
// a third (PERF.md).
//
// Bound: integer multiply-adds only (a product is about 350 instructions
// of 32-bit CIOS); bytes are two operands in and one out per lane.
#include "bn254.cuh"
#include "fq12_team.cuh"

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

// fq2_mul (x = x b, lazy) or fq2_sqr (x = x^2) on the three-thread step;
// thread k < 2 stores coefficient k
template <bool SQR>
__global__ void k_chain_fq2(const int32_t* __restrict__ a, const int32_t* __restrict__ b,
                            int32_t* __restrict__ out, int chain, int B) {
  const TeamThread t = team_thread<kTeam3>(kTeam3Lanes, B);
  const int base = threadIdx.x % 32 - t.k;
  Fq2 x{}, y{};
  if (t.active) {
    load(x, a, 0, B, t.lane);
    if (!SQR) load(y, b, 0, B, t.lane);
  }
  Fq c;                   // coefficient k (word selects: a selected reference would take a stack frame)
#pragma unroll
  for (int j = 0; j < 8; ++j) c.v[j] = t.k == 1 ? x.c1.v[j] : x.c0.v[j];
  for (int i = 0; i < chain; ++i) {
    if (i) x = team3_gather(base, c);
    c = SQR ? team3_fq2_sqr_coeff(t.k, x) : team3_fq2_mul_coeff(t.k, base, x, y);
  }
  if (t.active && t.k < 2) store(out, t.k, B, t.lane, c);
}

// The six-thread ops: a lane's value in Fq2 slots 0 .. kValues - 1, the
// constant operand (kTakesB) in the next kValues, the products after them
// (kSlots in all); step runs one op with its barriers.
static __constant__ TeamRound kProbeRounds[BN254_PROBE_NROUNDS] = BN254_PROBE_ROUNDS;

struct OpFq6Mul {
  static constexpr int kValues = 3, kSlots = BN254_PROBE_SLOTS;
  static constexpr bool kTakesB = true;
  static __device__ __forceinline__ void step(int k, uint32_t* s, bool active) {
    team_round<Fq2, kTeam>(kProbeRounds[BN254_PROBE_R_FQ6_MUL], k, s, 0, active);
  }
};

struct OpFq12Sqr {
  static constexpr int kValues = 6, kSlots = BN254_PROBE_SLOTS;
  static constexpr bool kTakesB = false;
  static __device__ __forceinline__ void step(int k, uint32_t* s, bool active) {
    team_round<Fq2, kTeam>(kProbeRounds[BN254_PROBE_R_SQR], k, s, 0, active);
  }
};

struct OpFq12Mul {                 // x, b, the 18 products (k_fq12_cyc_pow's digit step)
  static constexpr int kValues = 6, kSlots = 30;
  static constexpr bool kTakesB = true;
  static __device__ __forceinline__ void step(int k, uint32_t* s, bool active) {
    uint32_t* P = s + 12 * kTeamSlot;
    if (active) team_fq12_mul_products(k, P, s, s + 6 * kTeamSlot, false);
    __syncwarp();
    if (active) st2_s(s, k, team_fq12_mul_coeff(P, k));
    __syncwarp();
  }
};

struct OpCycloSqr {                // x, the 6 products (k_fq12_cyc_pow's square)
  static constexpr int kValues = 6, kSlots = 12;
  static constexpr bool kTakesB = false;
  static __device__ __forceinline__ void step(int k, uint32_t* s, bool active) {
    uint32_t* P = s + 6 * kTeamSlot;
    if (active) team_cyc_sqr_products(k, P, s);
    __syncwarp();
    if (active) st2_s(s, k, team_cyc_sqr_coeff(k, P, s));
    __syncwarp();
  }
};

constexpr int kChainWarps = 4;
constexpr int kChainLanes = kTeamsPerWarp * kChainWarps;   // row 9's 20 lanes a block

template <class Op>
__global__ void k_chain_team(const int32_t* __restrict__ a, const int32_t* __restrict__ b,
                             int32_t* __restrict__ out, int chain, int B) {
  __shared__ __align__(16) uint32_t s_lanes[kChainLanes * Op::kSlots * kTeamSlot];
  const TeamThread t = team_thread(kChainLanes, B);
  uint32_t* s = s_lanes + (t.active ? t.slot : 0) * Op::kSlots * kTeamSlot;
  if (t.active) {     // slot i: a's coefficient i, then b's
    for (int i = t.k; i < Op::kValues * (1 + Op::kTakesB); i += kTeam) {
      Fq2 v;
      load(v, i < Op::kValues ? a : b, 2 * (i % Op::kValues), B, t.lane);
      st2_s(s, i, v);
    }
  }
  __syncwarp();
  for (int i = 0; i < chain; ++i) Op::step(t.k, s, t.active);
  if (t.active && t.k < Op::kValues) store(out, 2 * t.k, B, t.lane, ld2_s(s, t.k));
}

template <class Op>
int launch_team(const int32_t* a, const int32_t* b, int32_t* out, int chain, int B,
                cudaStream_t stream) {
  k_chain_team<Op><<<(B + kChainLanes - 1) / kChainLanes, 32 * kChainWarps, 0, stream>>>(
      a, b, out, chain, B);
  return static_cast<int>(cudaGetLastError());
}

template <bool SQR>
int launch_fq2(const int32_t* a, const int32_t* b, int32_t* out, int chain, int B,
               cudaStream_t stream) {
  k_chain_fq2<SQR><<<(B + kTeam3Lanes - 1) / kTeam3Lanes, 32 * kTeam3Warps, 0, stream>>>(
      a, b, out, chain, B);
  return static_cast<int>(cudaGetLastError());
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
    case 0: { BN254_LAUNCH(k_chain_mont<false>, a, b, out, chain); }
    case 1: return launch_fq2<false>(a, b, out, chain, B, stream);
    case 2: return launch_fq2<true>(a, b, out, chain, B, stream);
    case 3: return launch_team<OpFq6Mul>(a, b, out, chain, B, stream);
    case 4: return launch_team<OpFq12Sqr>(a, b, out, chain, B, stream);
    case 5: return launch_team<OpFq12Mul>(a, b, out, chain, B, stream);
    case 6: return launch_team<OpCycloSqr>(a, b, out, chain, B, stream);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // extern "C"
