"""The lazy-reduction Fq2 product and the Fq2 square of the fused kernels
(queue rows 15-16) and the throughput probes (rows 21-22): the port's
plain versions on the CPU against the JAX package's in-kernel bodies
(pallas_fused's KCtx run on plain jnp arrays, as tests/test_pallas_fused.py
runs them) and against spec ints, on the same numpy inputs.  Exact."""

import ast
import os
import random
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bn254_tpu import limbs as JL
from bn254_tpu import pallas_fused as PF
from bn254_tpu.fields import FQ as JFQ, FR as JFR
from bn254_tpu.spec.constants import Q, R
from bn254_tpu_torch import counts
from bn254_tpu_torch import fused as FU
from bn254_tpu_torch import kernel_cases as KC
from bn254_tpu_torch import limbs as L
from bn254_tpu_torch import mont_kernels as MK
from bn254_tpu_torch import probe_schedule as PS
from bn254_tpu_torch import probes as PB
from bn254_tpu_torch import team_schedule as TS
import test_torch_tower as TT

torch.set_num_threads(1)

SEED = 0x9B0E
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# scripts/bench_tower.py's OPS bodies (importing the script would reset
# this process's JAX compilation cache); test_ops_table_matches_the_script
# holds the table equal to the script's.
JAX_OPS = {
    "fq_mul": (1, 1, lambda K, a, b: K.mul(a, b)),
    "fq2_mul": (2, 3, lambda K, a, b: PF.kfq2_mul(K, a, b)),
    "fq2_sqr": (2, 2, lambda K, a, b: PF.kfq2_sqr(K, a)),
    "fq6_mul": (6, 18, lambda K, a, b: PF.kfq6_mul(K, a, b)),
    "fq12_sqr": (12, 36, lambda K, a, b: PF.kfq12_sqr(K, a)),
    "fq12_mul": (12, 54, lambda K, a, b: PF.kfq12_mul(K, a, b)),
    "cyclo_sqr": (12, 18, lambda K, a, b: PF.kfq12_cyclotomic_sqr(K, a)),
}


def _kctx():
    return PF.KCtx(PF._fq_mod())


def _nest(t):
    """Packed port tensor [c, 16, B] -> the KCtx tree of limb lists
    (bench_tower.py _nest)."""
    flat = [[jnp.asarray(t[c, k].numpy().astype(np.uint32)) for k in range(16)]
            for c in range(t.shape[0])]
    if len(flat) == 1:
        return flat[0]
    pairs = [(flat[2 * i], flat[2 * i + 1]) for i in range(len(flat) // 2)]
    if len(pairs) == 1:
        return pairs[0]
    if len(pairs) == 3:
        return tuple(pairs)
    return (tuple(pairs[:3]), tuple(pairs[3:]))


def _flat(tree):
    """The KCtx tree -> [c, 16, B] uint32 numpy (leaves in order)."""
    leaves = jax.tree.leaves(tree, is_leaf=lambda x: isinstance(x, list))
    return np.stack([np.stack([np.asarray(v) for v in limbs]) for limbs in leaves])


def _same(port, jax_flat):
    assert np.array_equal(port.numpy().astype(np.uint32), jax_flat)


def test_ops_table_matches_the_script():
    """PB.OPS and this file's JAX_OPS carry bench_tower.py's ops, in its
    order, with its coordinate and product counts."""
    tree = ast.parse(open(os.path.join(REPO, "scripts", "bench_tower.py")).read())
    node = next(n for n in ast.walk(tree) if isinstance(n, ast.Assign)
                and getattr(n.targets[0], "id", None) == "OPS")
    script = {k.value: (v.elts[0].value, v.elts[1].value)
              for k, v in zip(node.value.keys, node.value.values)}
    assert list(script) == list(PB.OPS) == list(JAX_OPS)
    assert script == PB.OPS == {k: v[:2] for k, v in JAX_OPS.items()}


def test_fq2_mul_lazy_and_sqr_plain_vs_jax_bodies(monkeypatch):
    """fq2_mul_lazy_plain against PF.kfq2_mul in its lazy spelling, and row
    16's plain version against PF.kfq2_sqr, on the kernel case's column
    extremes (stored and canonical q - 1, 1, 0 in every sign pattern) and
    random lanes."""
    monkeypatch.setattr(PF, "_LAZY_FQ2", True)
    a, b = KC.fq2_extremes(np.random.default_rng(SEED), 64, "cpu")
    K = _kctx()
    _same(FU.fq2_mul_lazy_plain(a, b), _flat(PF.kfq2_mul(K, _nest(a), _nest(b))))
    _same(FU.fq2_sqr_fused_plain(a), _flat(PF.kfq2_sqr(K, _nest(a))))
    assert torch.equal(FU.fq2_mul_lazy_plain(a, b), MK.fq2_mul_plain(a, b))


@pytest.mark.parametrize("field", ["fq", "fr"])
def test_redc_split_keeps_mont_mul_bit_identical(field):
    """mont_mul / mont_sqr, now _product_columns + _redc, equal the JAX
    package's limbs.mont_mul / mont_sqr on edge and random operands."""
    p, jctx, mod = (Q, JFQ, MK.FQ_MOD) if field == "fq" else (R, JFR, KC.FR_MOD)
    rng = random.Random(SEED + 1)
    va = [0, 1, p - 1, p - 2] + [rng.randrange(p) for _ in range(12)]
    vb = [p - 1, 0, p - 1, 1] + [rng.randrange(p) for _ in range(12)]
    a, b = jctx.encode(va), jctx.encode(vb)
    ta, tb = (torch.from_numpy(x.astype(np.int32)) for x in (a, b))
    assert np.array_equal(L.mont_mul(ta, tb, mod).numpy().astype(np.uint32),
                          np.asarray(JL.mont_mul(jnp.asarray(a), jnp.asarray(b), jctx.mod)))
    assert np.array_equal(L.mont_sqr(ta, mod).numpy().astype(np.uint32),
                          np.asarray(JL.mont_sqr(jnp.asarray(a), jctx.mod)))


def test_signed_redc_over_its_whole_range():
    """_redc(signed=True) of signed columns equals T * 2^-256 mod q, with T
    at both ends of (-2q^2, 2q^2), at 0, and random, the columns holding
    mixed signs as the lazy differences do."""
    rng = random.Random(SEED + 2)
    lim = 2 * Q * Q
    vals = [-lim + 1, lim - 1, 0, -1, 1, -Q * Q, Q * Q] + \
        [rng.randrange(-lim + 1, lim) for _ in range(9)]
    cols = []
    for v in vals:      # |v|'s limbs with v's sign, then value-neutral moves
        sign = -1 if v < 0 else 1
        c = [sign * int(x) for x in L.limbs_from_int(abs(v), 32)]
        for k in range(31):          # lend d * 2^16 from column k + 1 to column k
            d = rng.randrange(-(1 << 18), 1 << 18)
            c[k] += d << 16
            c[k + 1] -= d
        assert sum(x << (16 * k) for k, x in enumerate(c)) == v
        cols.append(c)
    t = torch.tensor(cols, dtype=torch.int64).T.contiguous()
    out = L._redc(t, MK.FQ_MOD, signed=True)
    r_inv = pow(1 << 256, -1, Q)
    assert L._limbs_to_ints(out.numpy()) == [v * r_inv % Q for v in vals]


def test_chain_mont_plain_vs_spec_ints():
    """bench_mont.py's check at B = 8, chain 64: a * b^64 and a^(2^64)."""
    a, b = (PB.random_residues(np.random.default_rng(SEED + s), 1, 8, "cpu") for s in (3, 4))
    av, bv = MK.FQ_MOD.decode_batch(a[0]), MK.FQ_MOD.decode_batch(b[0])
    mul = PB.chain_mont("mul", a, b, 64)
    sqr = PB.chain_mont("sqr", a, b, 64)
    assert MK.FQ_MOD.decode_batch(mul[0]) == [x * pow(y, 64, Q) % Q for x, y in zip(av, bv)]
    assert MK.FQ_MOD.decode_batch(sqr[0]) == [pow(x, 1 << 64, Q) for x in av]


@pytest.mark.parametrize("op", list(JAX_OPS))
def test_chain_tower_plain_vs_jax_bodies(monkeypatch, op):
    """Each op's plain chain equals its bench_tower.py body applied 3 times
    on the emulated KCtx (lazy Fq2 spelling), at B = 8 with 0, 1 and q - 1
    on the first lanes."""
    monkeypatch.setattr(PF, "_LAZY_FQ2", True)
    coords, _, body = JAX_OPS[op]
    rng = np.random.default_rng(SEED + 5)
    a, b = KC.residues(rng, coords, 8, "cpu"), KC.residues(rng, coords, 8, "cpu")
    K = _kctx()
    x, y = _nest(a), _nest(b)
    for _ in range(3):
        x = body(K, x, y)
    _same(PB.chain_tower(op, a, b, 3), _flat(x))


@pytest.mark.parametrize("batch", [16, 3])
@pytest.mark.parametrize("label", [c.label for c in KC.CASES if c.name in
                                   ("fq2_mul_fused", "fq2_sqr_fused", "chain_mont",
                                    "chain_tower")])
def test_kernel_case_reaches_its_wrapper(monkeypatch, label, batch):
    """chip_smoke.py's case at a small batch (3: fewer lanes than a warp's
    teams): its wrapper's checks pass and it launches once (launch
    stubbed), its plain version returns the wrapper's shape, and the work
    gives a positive bound."""
    case = next(c for c in KC.CASES if c.label == label)
    args = case.make_args(np.random.default_rng(SEED + 6), batch, "cpu")
    want = case.plain(*args)
    calls = []
    for mod in (FU, PB):
        monkeypatch.setattr(mod, "on_cuda", lambda t: True)
        monkeypatch.setattr(mod, "launch", lambda name, batch, *a: calls.append((name, batch)))
    got = case.kernel(*args)
    assert calls == [(case.name, batch)]
    assert got.shape == want.shape and got.dtype == torch.int32
    products, nbytes = case.work(*args)
    ms, by = KC.bound_ms(products, nbytes)
    assert products > 0 and ms > 0
    assert by == ("operations" if case.name.startswith("chain") else "bytes")


def test_fq2_extremes_plant_their_patterns():
    """Lanes 0-49 pair the five extreme values (stored q - 1, 1, 0 and
    canonical q - 1, 1) in every order, (x, y) x (y, x) and (x, y) x (x, y);
    every value is a residue."""
    a, b = KC.fq2_extremes(np.random.default_rng(SEED + 7), 128, "cpu")
    ints = lambda t: [L._limbs_to_ints(t[c].numpy()) for c in range(2)]
    (a0, a1), (b0, b1) = ints(a), ints(b)
    m = MK.FQ_MOD
    ext = [Q - 1, 1, 0, m.encode_batch([Q - 1]), m.encode_batch([1])]
    ext = ext[:3] + [L._limbs_to_ints(e)[0] for e in ext[3:]]
    pairs = {(a0[i], a1[i], b0[i], b1[i]) for i in range(50)}
    assert pairs == {(x, y, *((y, x) if swap else (x, y)))
                     for x in ext for y in ext for swap in (True, False)}
    assert all(v < Q for vs in (a0, a1, b0, b1) for v in vs)


def test_probe_entries_on_the_cpu(monkeypatch):
    """probe_mont / probe_tower at a tiny size on the CPU: every chain's
    output and every one-op output equals its plain version, the one-op
    kernels with the chains are PROBE_PATH, the result names its device,
    and with the launches stubbed the probe path reaches every kernel of
    PROBE_PATH with valid arguments and runs no plain version."""
    mont = PB.probe_mont("cpu", batch=8, chain=4, reps=1)
    tower = PB.probe_tower("cpu", batch=4, chain=2, reps=1)
    assert mont["device"] == tower["device"] == "cpu"
    for impl, rec in mont["ops"].items():
        assert torch.equal(rec["out"], PB.chain_mont_plain(impl, mont["a"], mont["b"], 4))
        assert torch.equal(rec["one_op_out"], PB.MONT_ONE_OP[impl].plain(mont["a"], mont["b"]))
        assert rec["ms"] > 0 and rec["g_products_per_s"] > 0
    for op, rec in tower["ops"].items():
        assert torch.equal(rec["out"], PB.chain_tower_plain(op, rec["a"], rec["b"], 2))
        assert (rec["one_op_ms"] is None) == (rec["one_op_out"] is None) == (op == "fq6_mul")
        if op in PB.TOWER_ONE_OP:
            want = PB.TOWER_ONE_OP[op].plain(rec["a"], rec["b"])
            assert torch.equal(rec["one_op_out"], want)
    one_ops = {o.kernel for o in (*PB.MONT_ONE_OP.values(), *PB.TOWER_ONE_OP.values())}
    assert one_ops | {"chain_mont", "chain_tower"} == set(counts.PROBE_PATH)

    def launch(name, batch, *args):
        counts.launches[name] += 1

    for mod in (MK, FU, PB):
        monkeypatch.setattr(mod, "on_cuda", lambda t: True)
        monkeypatch.setattr(mod, "launch", launch)
    counts.reset()
    PB.probe_mont("cpu", batch=8, chain=4, reps=1)
    PB.probe_tower("cpu", batch=4, chain=2, reps=1)
    assert sorted(k for k, v in counts.launches.items() if v) == sorted(counts.PROBE_PATH)
    assert not any(counts.plain_calls.values())
    with pytest.raises(ValueError):
        PB.chain_tower("fq4_mul", mont["a"], mont["b"], 2)
    with pytest.raises(ValueError):
        PB.chain_mont("mul", mont["a"], mont["b"][:, :, :4].contiguous(), 2)


def test_regcap_sweep_reads_the_entry_usage_and_needs_the_card(monkeypatch):
    """regcap_sweep: the registers, stack and spill stores of the case's
    entry (not of another entry's or a device function's, and of the G1 or
    G2 instance of a group-law template as asked), from nvcc's -Xptxas -v
    log; without a card it exits 1 before building anything."""
    from bn254_tpu_torch import regcap_sweep as RS
    log = "\n".join([
        "ptxas info    : Compiling entry function '_ZN4k_fq12_mulEv' for 'sm_90a'",
        "    2496 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads",
        "ptxas info    : Used 220 registers, used 0 barriers",
        "ptxas info    : Compiling entry function '_ZN14k_fq12_cyc_powEPKi' for 'sm_90a'",
        "ptxas info    : Function properties for _ZN14k_fq12_cyc_powEPKi",
        "    184 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads",
        "ptxas info    : Used 128 registers, used 0 barriers, 48000 bytes smem",
        "ptxas info    : Compiling entry function '_ZN11k_point_addIN5bn2543Fq2EEEvPKi' for 'sm_90a'",
        "    1920 bytes stack frame, 8 bytes spill stores, 8 bytes spill loads",
        "ptxas info    : Used 148 registers, used 0 barriers",
        "ptxas info    : Compiling entry function '_ZN11k_point_addIN5bn2542FqEEEvPKi' for 'sm_90a'",
        "    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads",
        "ptxas info    : Used 166 registers, used 0 barriers",
    ])
    assert (RS._entry_usage(log, "k_fq12_cyc_pow")
            == "128 registers, 184 bytes stack, 0 bytes spill stores")
    assert RS._entry_usage(log, "k_msm_accumulate") == "not in the build log"
    assert (RS._entry_usage(log, "k_point_add", "IN5bn2542Fq")
            == "166 registers, 0 bytes stack, 0 bytes spill stores")
    assert (RS._entry_usage(log, "k_point_add", "IN5bn2543Fq2")
            == "148 registers, 1920 bytes stack, 8 bytes spill stores")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert RS.main([]) == 1


# The team spellings of the probe's chains (csrc/probes.cu,
# csrc/fq12_team.cuh).  The three-thread Fq2 step is modelled lane by lane
# in Python ints, as the kernel computes it: thread k's operands chosen by
# k, its 512-bit product, the shuffle exchange, the two word-by-word
# reductions (bn254.cuh redc_wide, with its bounds asserted).

_QINV32 = (-pow(Q, -1, 1 << 32)) % (1 << 32)
_M32 = (1 << 32) - 1


def _redc_wide(t: int) -> int:
    """bn254.cuh redc_wide: T 2^-256 mod q, canonical, for T < q 2^256."""
    assert 0 <= t < Q << 256
    for i in range(8):
        t += (((t >> (32 * i)) & _M32) * _QINV32 & _M32) * Q << (32 * i)
    assert t < 1 << 512 and t % (1 << 256) == 0
    r = t >> 256
    assert r < 2 * Q
    return r - Q if r >= Q else r


def _team3_lane(a0, a1, b0, b1, sqr: bool):
    """One lane's three-thread step on stored residues: (c0, c1)."""
    if sqr:     # threads 0 and 2: (a0 + a1)(a0 - a1 mod q); thread 1: a0 a1, doubled
        p = [(a0 + (a1 if k != 1 else 0)) * (a1 if k == 1 else (a0 - a1) % Q) for k in range(3)]
        t = [p[k] << (k == 1) for k in range(3)]
    else:       # thread k: a0 b0, a1 b1, (a0 + a1)(b0 + b1), the sums unreduced
        x = [(a1 if k == 1 else a0) + (a1 if k == 2 else 0) for k in range(3)]
        y = [(b1 if k == 1 else b0) + (b1 if k == 2 else 0) for k in range(3)]
        p = [x[k] * y[k] for k in range(3)]
        r = [p[1 if k == 0 else 0] for k in range(3)]        # the first shuffle
        s = [p[2] for k in range(3)]                         # the second
        t = [(s[k] if k == 1 else p[k]) + (0 if k == 1 else Q * Q) - r[k]
             - (p[k] if k == 1 else 0) for k in range(3)]
    assert all(v < 1 << 512 for v in p) and all(v >= 0 for v in t)
    return _redc_wide(t[0]), _redc_wide(t[1])


def team3_fq2(a, b=None):
    """The three-thread Fq2 product (b given) or square on packed [2, 16, B]."""
    ints = lambda t: [L._limbs_to_ints(t[c].numpy()) for c in range(2)]
    (a0, a1), (b0, b1) = ints(a), ints(a if b is None else b)
    out = [_team3_lane(*v, sqr=b is None) for v in zip(a0, a1, b0, b1)]
    return torch.from_numpy(np.stack([L._ints_to_limbs([c[i] for c in out])
                                      for i in range(2)]).astype(np.int32))


def _pair_warps() -> int:
    """csrc/fused.cu's kPairWarps: the warps of a k_fq2_sqr_fused block."""
    src = open(os.path.join(os.path.dirname(FU.__file__), "csrc", "fused.cu")).read()
    pattern = r"constexpr int kPairWarps = (\d+), kPairLanes = 32 / 2 \* kPairWarps;"
    return int(re.search(pattern, src).group(1))


def _pair_threads(batch: int):
    """k_fq2_sqr_fused's index map, team_thread<2> over its launch's blocks
    ((B + kPairLanes - 1) / kPairLanes of 32 kPairWarps threads): each
    thread's (warp lane, lane, k, active)."""
    warps = _pair_warps()
    lanes = 16 * warps
    for block in range(-(-batch // lanes)):
        for tid in range(32 * warps):
            team = (tid % 32) // 2
            lane = block * lanes + (tid // 32) * 16 + team
            yield tid % 32, lane, tid % 32 - 2 * team, team < 16 and lane < batch


def pair_fq2_sqr(a):
    """k_fq2_sqr_fused on packed [2, 16, B], warp by warp: thread k of a
    lane's pair loads coordinate k (inactive threads 0), takes the other
    from warp lane ^ 1 (the shuffle), and makes coefficient k: (a0 +
    a1)(a0 - a1 mod q) or 2 a0 a1, reduced (team3_fq2_sqr_coeff)."""
    batch = a.shape[-1]
    coords = [L._limbs_to_ints(a[c].numpy()) for c in range(2)]
    out = [[None] * batch for _ in range(2)]
    threads = list(_pair_threads(batch))
    for w in range(0, len(threads), 32):
        warp = threads[w:w + 32]
        x = [coords[k][lane] if active else 0 for _, lane, k, active in warp]
        for (wl, lane, k, active), xk in zip(warp, x):
            y = x[wl ^ 1]
            a0, a1 = (xk, y) if k == 0 else (y, xk)
            t = (a0 + a1) * ((a0 - a1) % Q) if k == 0 else (a0 * a1) << 1
            if active:
                out[k][lane] = _redc_wide(t)
    return torch.from_numpy(np.stack([L._ints_to_limbs(c) for c in out]).astype(np.int32))


@pytest.mark.parametrize("batch", [3, 1000, 16384])
def test_pair_fq2_sqr_covers_every_lane_and_equals_plain(batch):
    """Row 16's pair of threads a lane: its index map gives every lane of
    the batch exactly its two threads, k = 0 and 1, and no active thread
    past B, and the pair's coefficients equal fq2_sqr_fused_plain on the
    lazy product's column extremes."""
    seen = {}
    for _, lane, k, active in _pair_threads(batch):
        if active:
            seen[(lane, k)] = seen.get((lane, k), 0) + 1
    assert seen == {(lane, k): 1 for lane in range(batch) for k in (0, 1)}
    a = KC.fq2_extremes(np.random.default_rng(SEED), batch, "cpu")[0]
    assert torch.equal(pair_fq2_sqr(a), FU.fq2_sqr_fused_plain(a))


@pytest.mark.parametrize("op", ["mul", "sqr"])
def test_team3_fq2_step_equals_plain_and_jax(monkeypatch, op):
    """The three-thread Fq2 step's model equals the plain lazy product
    (FU._fq2_mul_lazy) and PF.kfq2_mul in its lazy spelling, or the plain
    complex square (MK._fq2_sqr) and PF.kfq2_sqr, on the lazy product's
    column extremes (stored and canonical q - 1, 1, 0 in every sign
    pattern) and random lanes."""
    monkeypatch.setattr(PF, "_LAZY_FQ2", True)
    a, b = KC.fq2_extremes(np.random.default_rng(SEED), 64, "cpu")
    K = _kctx()
    if op == "mul":
        got = team3_fq2(a, b)
        assert torch.equal(got, FU._fq2_mul_lazy(a, b))
        _same(got, _flat(PF.kfq2_mul(K, _nest(a), _nest(b))))
    else:
        got = team3_fq2(a)
        assert torch.equal(got, MK._fq2_sqr(a))
        _same(got, _flat(PF.kfq2_sqr(K, _nest(a))))


def _probe_state(a, b=None):
    """A lane's probe slots (probe_schedule.SLOT): a's Fq2 coefficients
    from F0, then b's, the products zero."""
    batch = a.shape[-1]
    vals = list(a.view(-1, 2, 16, batch)) + ([] if b is None else list(b.view(-1, 2, 16, batch)))
    zero = torch.zeros_like(vals[0])
    return vals + [zero] * (PS.N_SLOTS - len(vals))


def team_probe_step(op: str, a, b):
    """One step of the probe's team spelling of `op` on packed values."""
    if op == "fq_mul":
        return L.mont_mul(a, b, MK.FQ_MOD)
    if op in ("fq2_mul", "fq2_sqr"):
        return team3_fq2(a, b if op == "fq2_mul" else None)
    if op == "fq12_mul":
        return TT.team_fq12_mul(a, b)
    if op == "cyclo_sqr":
        return TT.team_cyc_sqr(a)
    rnd, n = (PS.FQ6_MUL, 3) if op == "fq6_mul" else (PS.SQR, 6)
    state = _probe_state(a, b if op == "fq6_mul" else None)
    TT.team_round(state, rnd, 0, PS.SLOT)
    return torch.stack(state[:n]).reshape(a.shape)


def test_fq6_round_equals_plain_and_jax(monkeypatch):
    """probe_schedule.FQ6_MUL on the team_round model equals FU._mul6 and
    PF.kfq6_mul (lazy spelling), with 0, 1 and q - 1 on the first lanes."""
    monkeypatch.setattr(PF, "_LAZY_FQ2", True)
    rng = np.random.default_rng(SEED + 5)
    a, b = KC.residues(rng, 6, 8, "cpu"), KC.residues(rng, 6, 8, "cpu")
    got = team_probe_step("fq6_mul", a, b)
    assert torch.equal(got, FU._mul6(a.view(3, 2, 16, 8), b.view(3, 2, 16, 8)).reshape(6, 16, 8))
    _same(got, _flat(PF.kfq6_mul(_kctx(), _nest(a), _nest(b))))


@pytest.mark.parametrize("index", range(len(PS.ROUNDS)))
def test_probe_rounds_are_race_free(index):
    """Each probe round passes check_round for a team of six over the
    probe's slots, one product pass and one combination pass, and the
    generated header holds the rounds."""
    rnd = PS.ROUNDS[index]
    TS.check_round(rnd, TS.TEAM, PS.SLOT)
    assert -(-len(rnd.muls) // TS.TEAM) <= 2 and len(rnd.lins) <= TS.TEAM
    assert "#define BN254_PROBE_ROUNDS" in PS.header()
    from bn254_tpu_torch import _build
    assert PS.header() in _build.consts_header()


def test_probe_round_check_refuses_a_race():
    """check_round refuses the Fq6 round with a combination that writes a
    product slot the others read, and a product that reads another's
    output."""
    bad = TS.Round(PS.FQ6_MUL.muls, PS.FQ6_MUL.lins + (TS.Comb("P0", TS.A("F0")),))
    with pytest.raises(ValueError):
        TS.check_round(bad, TS.TEAM, PS.SLOT)
    bad = TS.Round((TS.Mul("F0", TS.A("F1"), TS.A("F3")), TS.Mul("P1", TS.A("F0"), TS.A("F4"))),
                   ())
    with pytest.raises(ValueError):
        TS.check_round(bad, TS.TEAM, PS.SLOT)


@pytest.mark.parametrize("op", list(PB.OPS))
def test_team_chains_equal_plain_chains(op):
    """Each op chained 3 times in the probe kernel's spelling (fq_mul one
    thread a lane; fq2_mul and fq2_sqr the three-thread step; fq6_mul and
    fq12_sqr their rounds on team_round; fq12_mul and cyclo_sqr the
    six-thread team's products and coefficients) equals chain_tower_plain,
    at B = 5 with 0, 1 and q - 1 on the first lanes."""
    coords = PB.OPS[op][0]
    rng = np.random.default_rng(SEED + 8)
    a, b = KC.residues(rng, coords, 5, "cpu"), KC.residues(rng, coords, 5, "cpu")
    x = a
    for _ in range(3):
        x = team_probe_step(op, x, b)
    assert torch.equal(x, PB.chain_tower_plain(op, a, b, 3))
