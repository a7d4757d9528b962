"""The port's Fq2/Fq6/Fq12 tower and its fused-kernel plain versions
(bn254_tpu_torch on the CPU) against the JAX package's tower on the same
numpy inputs.  Comparisons are exact: the port's limb arrays must equal
the JAX package's, and the decoded canonical ints the spec's."""

import random

import jax
import numpy as np
import pytest
import torch

from bn254_tpu import tape
from bn254_tpu import tower as JT
from bn254_tpu.spec import field as SF
from bn254_tpu.spec.constants import Q, Z
from bn254_tpu_torch import convert
from bn254_tpu_torch import fused as FU
from bn254_tpu_torch import mont_kernels as MK
from bn254_tpu_torch import tower as T
import golden

# The plain versions run many small tensor ops: intra-op threads only add
# overhead at these batch sizes, and the test workers already run in parallel.
torch.set_num_threads(1)

SEED = 0x70F1
B = 4


def _fq2(rng):
    return (rng.randrange(Q), rng.randrange(Q))


def _fq6(rng):
    return tuple(_fq2(rng) for _ in range(3))


def _fq12(rng):
    return (_fq6(rng), _fq6(rng))


def on_tape(fn, *trees):
    """Run a JAX tower function as the JAX package runs it on the CPU: as a
    recorded instruction tape (bn254_tpu/tape.py), which compiles in
    seconds where a jit of the unrolled formula takes minutes."""
    leaves, treedef = jax.tree.flatten(trees)
    out_def = []

    def build(rec):
        ins = jax.tree.unflatten(treedef, [rec.input() for _ in leaves])
        out, od = jax.tree.flatten(fn(*ins))
        out_def.append(od)
        return out

    prog = tape._record(object(), build)
    return jax.tree.unflatten(out_def[0], tape.run(prog, leaves))


def _port(tree):
    return convert.from_numpy(tree, "cpu")


def assert_same(port_out, jax_out):
    """Port tensors and JAX arrays hold the same limbs, leaf by leaf."""
    got = convert.tree_leaves(convert.to_numpy(port_out))
    want = [np.asarray(x) for x in jax.tree.leaves(jax_out)]
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert np.array_equal(g, w)


def _cyclotomic(vals):
    """The easy part of the final exponentiation maps any invertible Fq12
    into the cyclotomic subgroup: f = (conj(a) / a)^(q^2 + 1)."""
    out = []
    for a in vals:
        c = SF.fq12_mul(SF.fq12_conj(a), SF.fq12_inv(a))
        out.append(SF.fq12_mul(SF.fq12_frob(c, 2), c))
    return out


def test_fq2_mul_sqr_vs_jax():
    """Rows 3-4 (plain versions on the CPU) with edge values."""
    rng = random.Random(SEED)
    av = [(0, 0), (1, 0), (Q - 1, Q - 1), (0, 1)] + [_fq2(rng) for _ in range(B)]
    bv = [(Q - 1, 1), (0, 0), (Q - 1, Q - 1), (5, 7)] + [_fq2(rng) for _ in range(B)]
    a_np, b_np = JT.fq2_encode(av), JT.fq2_encode(bv)
    a, b = _port(a_np), _port(b_np)
    got = T.fq2_mul(a, b)
    assert_same(got, on_tape(JT.fq2_mul, a_np, b_np))
    assert_same(T.fq2_sqr(a), on_tape(JT.fq2_sqr, a_np))
    assert T.fq2_decode(got) == [SF.fq2_mul(x, y) for x, y in zip(av, bv)]


def _fq2_frob1(x):
    """The Fq2 Frobenius as fused._frob12 applies it to coefficient 0 of
    an Fq12 (whose factor is 1)."""
    a = torch.zeros(2, 3, 2, *x[0].shape, dtype=x[0].dtype)
    a[0, 0] = torch.stack(x)
    return tuple(FU._frob12(a, 1)[0, 0])


_FQ2_UNARY = {
    "inv": (T.fq2_inv, JT.fq2_inv),
    "mul_by_xi": (T.fq2_mul_by_xi, JT.fq2_mul_by_xi),
    "conj": (T.fq2_conj, JT.fq2_conj),
    "frob1": (_fq2_frob1, lambda x: JT.fq2_frob(x, 1)),
}


@pytest.mark.parametrize("op", sorted(_FQ2_UNARY))
def test_fq2_unary_vs_jax(op):
    rng = random.Random(SEED + 1)
    a_np = JT.fq2_encode([(0, 0), (1, 0)] + [_fq2(rng) for _ in range(B)])
    ours, theirs = _FQ2_UNARY[op]
    assert_same(ours(_port(a_np)), on_tape(theirs, a_np))


def _fq6_packed(fn):
    """fused.py's plain Fq6 helper fn on stacked [3, 2, 16, B] values, as
    the kernels' plain versions call it, on tuple inputs -> its 6 leaves."""
    def run(a, b):
        batch = a[0][0].shape[-1]
        out = fn(*(convert.pack(x).view(3, 2, 16, batch) for x in (a, b)))
        return tuple(out.reshape(6, 16, batch))
    return run


def _fq6_frob(a, b, k):
    """The Fq6 Frobenius: the first half of fused._frob12 on (a, 0)."""
    return FU._frob12(torch.stack([a, torch.zeros_like(a)]), k)[0]


_FQ6_OPS = {
    "mul": (_fq6_packed(FU._mul6), JT.fq6_mul),
    "sqr": (_fq6_packed(lambda a, b: FU._sqr6(a)), lambda a, b: JT.fq6_sqr(a)),
    "inv": (_fq6_packed(lambda a, b: FU._inv6(a)), lambda a, b: JT.fq6_inv(a)),
    **{f"frob{k}": (_fq6_packed(lambda a, b, k=k: _fq6_frob(a, b, k)),
                    lambda a, b, k=k: JT.fq6_frob(a, k)) for k in (1, 2, 3)},
}


@pytest.mark.parametrize("op", sorted(_FQ6_OPS))
def test_fq6_vs_jax(op):
    rng = random.Random(SEED + 2)
    a_np = JT.fq6_encode([_fq6(rng) for _ in range(B)])
    b_np = JT.fq6_encode([_fq6(rng) for _ in range(B)])
    ours, theirs = _FQ6_OPS[op]
    assert_same(ours(_port(a_np), _port(b_np)), on_tape(theirs, a_np, b_np))


def test_fq12_mul_vs_jax():
    """Row 9 (plain version) against JAX fq12_mul and the spec."""
    rng = random.Random(SEED + 3)
    av = [_fq12(rng) for _ in range(B)]
    bv = [_fq12(rng) for _ in range(B)]
    a_np, b_np = JT.fq12_encode(av), JT.fq12_encode(bv)
    got = T.fq12_mul(_port(a_np), _port(b_np))
    assert_same(got, on_tape(JT.fq12_mul, a_np, b_np))
    assert T.fq12_decode(got) == [SF.fq12_mul(x, y) for x, y in zip(av, bv)]


def test_fq12_cyclotomic_sqr_vs_jax():
    """Row 10 (plain version): the Granger-Scott polynomial, equal to the
    JAX package's on any input, a true square on cyclotomic ones."""
    rng = random.Random(SEED + 4)
    av = [_fq12(rng) for _ in range(2)] + _cyclotomic([_fq12(rng) for _ in range(2)])
    a_np = JT.fq12_encode(av)
    got = T.fq12_cyclotomic_sqr(_port(a_np))
    assert_same(got, on_tape(JT.fq12_cyclotomic_sqr, a_np))
    assert T.fq12_decode(got)[2:] == [SF.fq12_sqr(x) for x in av[2:]]


_FQ12_UNARY = {
    "sqr": (T.fq12_sqr, JT.fq12_sqr),
    "inv": (T.fq12_inv, JT.fq12_inv),
    "conj": (T.fq12_conj, JT.fq12_conj),
    **{f"frob{k}": (lambda x, k=k: T.fq12_frob(x, k),
                    lambda x, k=k: JT.fq12_frob(x, k)) for k in (1, 2, 3)},
}


@pytest.mark.parametrize("op", sorted(_FQ12_UNARY))
def test_fq12_unary_vs_jax(op):
    rng = random.Random(SEED + 5)
    a_np = JT.fq12_encode([_fq12(rng) for _ in range(B)])
    ours, theirs = _FQ12_UNARY[op]
    assert_same(ours(_port(a_np)), on_tape(theirs, a_np))


def test_fq12_mul_by_024_vs_jax():
    """The tower's sparse line product and the stacked one inside the
    fold-line and Miller plain versions (rows 6 and 8) against JAX
    fq12_mul_by_024, argument order (ell_0, ell_vv * px, ell_vw * py)."""
    rng = random.Random(SEED + 6)
    av = [_fq12(rng) for _ in range(B)]
    e0, evv, evw = ([_fq2(rng) for _ in range(B)] for _ in range(3))
    args_np = (JT.fq12_encode(av), JT.fq2_encode(e0), JT.fq2_encode(evv),
               JT.fq2_encode(evw))
    want = on_tape(JT.fq12_mul_by_024, *args_np)
    assert_same(T.fq12_mul_by_024(*_port(args_np)), want)
    f, x0, x2, x4 = (convert.pack(x) for x in _port(args_np))
    got = FU._mul_by_024(f.view(2, 3, 2, 16, B), x0, x2, x4)
    assert_same(convert.unpack_fq12(got.reshape(12, 16, B)), want)


def test_naf_ladder_vs_jax_exp_by_neg_z_on_cyclotomic_inputs():
    """Row 11 with NAF digits (the final exponentiation's ladder) against
    JAX exp_by_neg_z, whose CPU spelling is the binary ladder: equal on
    cyclotomic inputs."""
    rng = random.Random(SEED + 7)
    a_np = JT.fq12_encode(_cyclotomic([_fq12(rng) for _ in range(3)]))
    got = T.fq12_exp_by_neg_z_unitary(_port(a_np))
    assert_same(got, jax.jit(JT.fq12_exp_by_neg_z)(a_np))


def test_binary_ladder_golden():
    """Row 11 with binary digits: the reference's exp_by_neg_z vector
    (fields/mod.rs:229-344), on a non-cyclotomic input."""
    out = T.fq12_exp_by_neg_z(_port(JT.fq12_encode([golden.CYCLOTOMIC_EXP_ORIG])))
    assert T.fq12_decode(out)[0] == golden.CYCLOTOMIC_EXP_EXPECTED


def test_naf_and_binary_digit_schedules():
    """Both schedules drop the leading 1 and spell the BN parameter z."""
    def value(digits, signed):
        v = 1
        for d in digits.ravel():
            v = 2 * v + (-1 if (signed and d == 2) else int(d))
        return v
    assert value(FU.BINARY_Z, False) == value(FU.NAF_Z, True) == Z
    assert int((FU.BINARY_Z != 0).sum()) == 27 and int((FU.NAF_Z != 0).sum()) == 23


@pytest.mark.parametrize("label", ["fq12_cyc_pow[naf]", "fq12_cyc_pow[binary]"])
def test_cyc_pow_bound_counts_lazy_fq2_products(label):
    """Rows 11-12's bound counts the team's Fq2 products, all lazy, at
    2.5 Montgomery products' work each: 6 a cyclotomic square per digit,
    18 an Fq12 product per nonzero digit; 24 Fq of bytes a lane."""
    from bn254_tpu_torch import kernel_cases as KC
    case = next(c for c in KC.CASES if c.label == label)
    a, digits = case.make_args(np.random.default_rng(SEED), 10, "cpu")
    products, nbytes = case.work(a, digits)
    d = np.asarray(digits).ravel()
    assert products == 10 * (15 * len(d) + 45 * int((d != 0).sum()))
    assert nbytes == 10 * 24 * 64


@pytest.mark.parametrize("label", ["miller_precompute", "fq12_mul", "miller_loop"])
def test_team_kernel_bounds_count_lazy_fq2_products(label):
    """Rows 6, 9 and 8l's bounds count the Fq2 products the functions need: a
    general one at 2.5 Montgomery products' work (lazy), a square or a
    scaling by (px, 0), (py, 0) at 2.  A doubling step is 88.5: the Fq12
    square's 12 products (30), the G2 step's 4 general products, 6
    squares and 2 scalings (10 + 12 + 4) and the fold's 13 (32.5); an
    addition step 68: 7 general products and 2 squares (17.5 + 4), e bx
    and d by (5), 2 scalings (4), the fold (32.5), its first 2 in the
    doubling step before it, as the kernel runs them; the 2 Frobenius
    bases of the pairing's tail 2 lazy products each (10).  An Fq12
    product is 18 at 2.5.  Their batches leave a block partly empty
    (16384 = 1638 Miller blocks of 10 lanes and 4) and rows 6 and 9 run
    below one warp's five teams (B = 3)."""
    from bn254_tpu_torch import kernel_cases as KC
    from bn254_tpu_torch import team_schedule as TS
    case = next(c for c in KC.CASES if c.label == label)
    args = case.make_args(np.random.default_rng(SEED), 10, "cpu")
    products, nbytes = case.work(*args)
    if label == "fq12_mul":
        assert (products, nbytes) == (10 * 45, 10 * 36 * 64)
        assert min(case.batches) < 5
    elif label == "miller_loop":
        # 64 squares (12 products) and 87 folds (13 products, 2 scalings)
        assert KC.loop_work(*args) == (int(10 * 5095.5), 10 * (87 * 6 + 2 + 12) * 64 + 4 * 87)
        assert 5095.5 == 64 * (12 * 2.5 + 13 * 2.5 + 2 * 2) + 23 * (13 * 2.5 + 2 * 2)
        assert min(case.batches) < 5 and 16384 % 20 == 4
    else:
        kinds = np.asarray(args[2]).ravel()
        assert [len(r.muls) for r in TS.ROUNDS] == [17, 4, 16, 18, 2, 6, 16, 4, 4]
        assert (int((kinds == 0).sum()), len(kinds), tuple(kinds[-2:])) == (64, 87, (3, 4))
        steps = TS.device_kinds(kinds)
        assert len(steps) == 88 and steps[0] == TS.FROB_KIND
        assert sum(len(TS.ROUNDS[r].muls) for i in range(88)
                   for r in TS.step_rounds(steps, i)[0]) == 64 * 37 + 23 * 28 + 4
        work = lambda rounds: sum(KC.fq2_mul_work(m) for r in rounds for m in TS.ROUNDS[r].muls)
        assert (work(TS.DBL), work(TS.DBL_THEN_ADD + TS.ADD_AFTER_DBL)) == (88.5, 88.5 + 68)
        assert [sum(KC.fq2_mul_work(m) == 2 for m in TS.ROUNDS[r].muls)
                for r in TS.DBL + TS.ADD] == [4, 2, 2, 0, 4, 0, 0]
        assert products == int(10 * (64 * 88.5 + 23 * 68 + 4 * 2.5))
        assert nbytes == 10 * 24 * 64 + 4 * 88
        assert 16384 in case.batches and 16384 % 10 == 4 and min(case.batches) < 5


def test_final_exponentiation_vs_jax():
    rng = random.Random(SEED + 8)
    av = [_fq12(rng) for _ in range(3)]
    a_np = JT.fq12_encode(av)
    got = T.fq12_final_exponentiation(_port(a_np))
    assert_same(got, jax.jit(JT.fq12_final_exponentiation)(a_np))
    assert T.fq12_decode(got) == [SF.fq12_final_exponentiation(x) for x in av]


# The team spelling of row 11 (csrc/fq12_team.cuh): six threads per lane,
# thread k computing a sixth of an op's Fq2 products, then output
# coefficient k from the exchanged products.  An Fq12 is 6 Fq2 here,
# (c0.c0, c0.c1, c0.c2, c1.c0, c1.c1, c1.c2).

def _team_half(s, m, c, conj):
    lo, hi = s[c], s[3 + c]
    if conj:
        hi = FU._neg(hi)
    return lo if m == 0 else hi if m == 1 else FU._add(lo, hi)


def _team_operand(s, m, k, conj):
    if k < 3:
        return _team_half(s, m, k, conj)
    return FU._add(_team_half(s, m, 1 if k == 3 else 0, conj),
                   _team_half(s, m, 1 if k == 4 else 2, conj))


def _team_fq6_coeff(p, i):
    if i == 0:
        return FU._add(FU._xi(FU._sub(FU._sub(p[3], p[1]), p[2])), p[0])
    if i == 1:
        return FU._add(FU._sub(FU._sub(p[4], p[0]), p[1]), FU._xi(p[2]))
    return FU._sub(FU._add(FU._sub(p[5], p[0]), p[1]), p[2])


def team_fq12_mul(a, b, conj=False):
    """18 Fq2 products (thread k: product k of each Fq6 product m), then
    coefficient j of c0 = v R1 + R0, c1 = R2 - R0 - R1."""
    s, t = a.view(6, 2, 16, -1), b.view(6, 2, 16, -1)
    P = [[MK._fq2_mul(_team_operand(s, m, k, False), _team_operand(t, m, k, conj))
          for k in range(6)] for m in range(3)]
    out = []
    for j in range(6):
        if j < 3:
            r1 = _team_fq6_coeff(P[1], 2 if j == 0 else j - 1)
            out.append(FU._add(_team_fq6_coeff(P[0], j), FU._xi(r1) if j == 0 else r1))
        else:
            i = j - 3
            out.append(FU._sub(FU._sub(_team_fq6_coeff(P[2], i), _team_fq6_coeff(P[0], i)),
                               _team_fq6_coeff(P[1], i)))
    return torch.stack(out).reshape(12, 16, -1)


def team_cyc_sqr(a):
    """6 Fq2 products (thread k: pair k % 3, u v or (u + v)(xi v + u)),
    then cyc_tri per coefficient."""
    s = a.view(6, 2, 16, -1)
    pairs = ((0, 4), (3, 2), (1, 5))
    P = []
    for k in range(6):
        u, v = (s[i] for i in pairs[k % 3])
        P.append(MK._fq2_mul(u, v) if k < 3 else
                 MK._fq2_mul(FU._add(u, v), FU._add(FU._xi(v), u)))
    out = []
    for j in range(6):
        if j < 3:
            t = FU._sub(FU._sub(P[3 + j], P[j]), FU._xi(P[j]))
            x = FU._sub(t, s[j])
        else:
            tmp = P[(j + 2) % 3]
            t = FU._add(tmp, tmp)
            t = FU._xi(t) if j == 3 else t
            x = FU._add(t, s[j])
        out.append(FU._add(FU._add(x, x), t))
    return torch.stack(out).reshape(12, 16, -1)


@pytest.mark.parametrize("op", ["mul", "mul_conj", "cyc_sqr"])
def test_team_spelling_equals_plain_version(op):
    """The team's Fq12 product (also against conj(b), digit 2 of the
    ladder) and cyclotomic square equal fq12_mul_plain and
    fq12_cyc_sqr_plain bit for bit, on random residues with 0, 1 and
    q - 1 in the first lanes of every coefficient (kernel_cases.residues,
    row 11's case inputs)."""
    from bn254_tpu_torch import kernel_cases as KC
    rng = np.random.default_rng(SEED + 9)
    a, b = KC.residues(rng, 12, 16, "cpu"), KC.residues(rng, 12, 16, "cpu")
    b[:, :, 3:6] = a[:, :, :3]          # b's edge values meet a's in other lanes
    if op == "cyc_sqr":
        assert torch.equal(team_cyc_sqr(a), FU.fq12_cyc_sqr_plain(a))
    elif op == "mul":
        assert torch.equal(team_fq12_mul(a, b), FU.fq12_mul_plain(a, b))
    else:
        conj = FU._conj12(b.view(2, 3, 2, 16, -1)).reshape(12, 16, -1)
        assert torch.equal(team_fq12_mul(a, b, conj=True), FU.fq12_mul_plain(a, conj))


# The Miller kernel's team schedule (bn254_tpu_torch/team_schedule.py,
# csrc/fused.cu k_miller_precompute): rounds of Fq2 products, then linear
# combinations, over a lane's Fq2 slots.  The model runs a round as the
# six threads do after check_round: every task of a half reads the slots
# as they were before the half, then all write.

def _team_half_mod(x):
    """The kernel's halving (fq12_team.cuh fq_half) on stored residues:
    v/2 if v is even, else (v + q)/2."""
    from bn254_tpu_torch import limbs as L
    flat = x.reshape(-1, 16, x.shape[-1])
    out = []
    for t in flat:
        vals = L._limbs_to_ints(t.numpy())
        out.append(L._ints_to_limbs([(v + (Q if v & 1 else 0)) >> 1 for v in vals]))
    return torch.from_numpy(np.stack(out).astype(np.int32)).reshape(x.shape)


def team_lin(state, lin, vb, slots=None):
    """As the kernel's team_lin: each sum its positive slots added, then
    its negative slots subtracted; xi on b's sum; then the post step; a
    virtual slot VIRT + j reads slot vb + j.  `slots` names the
    schedule's slots (the Miller kernel's by default)."""
    from bn254_tpu_torch import team_schedule as TS
    acc = torch.zeros_like(state[0])
    split = TS._split(lin, slots or TS.NAMES)
    bp, bn, ap, an = ([vb + i - TS.VIRT if i >= TS.VIRT else i for i in ts] for ts in split)
    for pos, neg, xi in ((bp, bn, True), (ap, an, False)):
        for i in pos:
            acc = FU._add(acc, state[i])
        for i in neg:
            acc = FU._sub(acc, state[i])
        if xi and (pos or neg):
            acc = FU._xi(acc)
    if lin.post == TS.HALF:
        acc = _team_half_mod(acc)
    elif lin.post == TS.DOUBLE:
        acc = FU._add(acc, acc)
    return acc


def team_round(state, rnd, vb, slots=None):
    """One round on the slot list `state` (Fq2 tensors [2, 16, B]), in place;
    the products are lazy Fq2 products, as the kernel's; virtual slots
    read from vb on."""
    from bn254_tpu_torch import team_schedule as TS
    slots = slots or TS.NAMES
    TS.check_round(rnd, TS.TEAM, slots)
    if rnd.muls:
        x = torch.stack([team_lin(state, m.x, vb, slots) for m in rnd.muls])
        y = torch.stack([team_lin(state, m.y, vb, slots) for m in rnd.muls])
        for m, v in zip(rnd.muls, FU._fq2_mul_lazy(x, y)):
            state[slots[m.dst]] = v
    new = [(c.dst, team_lin(state, c.lin, vb, slots)) for c in rnd.lins]
    for dst, v in new:
        state[slots[dst]] = v


def team_state(f=None, q=None, p=None, r=None):
    """A lane state as the kernel's start writes it: f (default 1), R = (qx,
    qy, 1) unless r is given, Q, -Q, and for the Frobenius bases' round
    conj(qx), conj(qy) and the twist factors (_build.twist_consts) in
    P0-P5; (px, 0), (py, 0), b2; packed tensors [12 / 4 / 2 / 6, 16, B]."""
    from bn254_tpu_torch import _build
    from bn254_tpu_torch import team_schedule as TS
    from bn254_tpu_torch.spec import constants as SC
    like = next(t for t in (f, q, p, r) if t is not None)
    batch = like.shape[-1]
    one = FU._fq12_one(like[0])[0, 0]
    zero = torch.zeros_like(one)
    st = [zero] * TS.N_SLOTS
    put = lambda names, vals: [st.__setitem__(TS.SLOT[n], v) for n, v in zip(names, vals)]
    put(("F0", "F1", "F2", "F3", "F4", "F5"),
        f.view(6, 2, 16, batch) if f is not None else [one] + [zero] * 5)
    if q is not None:
        qx, qy = q.view(2, 2, 16, batch)
        put(("RX", "RY", "RZ"), (qx, qy, one))
        put(("Q1X", "Q1Y", "Q2X", "Q2Y"), (qx, qy, qx, FU._neg(qy)))
        conj = lambda a: torch.stack([a[0], FU._neg(a[1])])
        put([f"P{i}" for i in range(6)],
            [conj(qx), conj(qy)] + [FU._const2(t, qx) for t in _build.twist_consts()])
    if r is not None:
        put(("RX", "RY", "RZ"), r.view(3, 2, 16, batch))
    if p is not None:
        put(("PX", "PY"), [torch.stack([c, zero[0]]) for c in p])
    st[TS.SLOT["B2"]] = torch.stack([FU._const(v, zero[0]) for v in SC.B2])
    return st


def team_slots(state, *names):
    from bn254_tpu_torch import team_schedule as TS
    return torch.stack([state[TS.SLOT[n]] for n in names]).reshape(2 * len(names), 16, -1)


def team_miller_steps(state, kinds):
    """The team Miller kernel's steps on a lane state, in place: each step
    of team_schedule.device_kinds (the Frobenius bases' round first where
    kinds 3 or 4 come) runs the rounds step_rounds picks (doubling,
    addition against Q, -Q, pi(Q) or -pi^2(Q), its base read through vb =
    base_slot(kind), an addition's first round taken into the doubling
    step before it)."""
    from bn254_tpu_torch import team_schedule as TS
    kinds = TS.device_kinds(kinds)
    for i in range(len(kinds)):
        rounds, base = TS.step_rounds(kinds, i)
        for r in rounds:
            team_round(state, TS.ROUNDS[r], TS.base_slot(base) if base else 0)


def team_miller_precompute(q, p, kinds):
    """The whole team Miller kernel on the CPU (team_miller_steps from f =
    1, R = Q); returns (f [12, 16, B], r [6, 16, B]) as
    fused.miller_precompute."""
    st = team_state(q=q, p=p)
    team_miller_steps(st, kinds)
    return (team_slots(st, "F0", "F1", "F2", "F3", "F4", "F5"),
            team_slots(st, "RX", "RY", "RZ"))


def _team_inputs(seed, batch=16):
    """kernel_cases.residues inputs (0, 1 and q - 1 in the first lanes of
    every coordinate) for f, a G2 triple, a line, Q and P."""
    from bn254_tpu_torch import kernel_cases as KC
    rng = np.random.default_rng(seed)
    return {k: KC.residues(rng, n, batch, "cpu")
            for k, n in (("f", 12), ("r", 6), ("c", 6), ("q", 4), ("p", 2))}


@pytest.mark.parametrize("index", range(9))
def test_team_schedule_round_is_race_free(index):
    """Every round of the Miller kernel's table passes check_round, fits
    the kernel's passes, and the header holds it; only the Frobenius
    bases' round (8) has no combinations."""
    from bn254_tpu_torch import team_schedule as TS
    rnd = TS.ROUNDS[index]
    TS.check_round(rnd, TS.TEAM, TS.NAMES)
    assert 0 < len(rnd.muls) <= 18 and len(rnd.lins) <= 12 and (rnd.lins or index == 8)
    used = set().union(*(TS.reads(m.x) | TS.reads(m.y) | {m.dst} for m in rnd.muls),
                       *(TS.reads(c.lin) | {c.dst} for c in rnd.lins))
    assert all(s in TS.VIRTUAL.values() or s < TS.N_SLOTS
               for s, _ in (TS.slot(t, TS.NAMES) for t in used))
    assert TS.header().count("#define BN254_MILLER_ROUNDS") == 1


def test_team_schedule_refuses_a_race():
    """check_round refuses a round whose task reads another's output."""
    from bn254_tpu_torch import team_schedule as TS
    bad = TS.Round((TS.Mul("P0", TS.A("F0"), TS.A("F1")), TS.Mul("P1", TS.A("P0"), TS.A("F1"))), ())
    with pytest.raises(ValueError):
        TS.check_round(bad, TS.TEAM, TS.NAMES)
    with pytest.raises(ValueError):
        TS.check_round(TS.Round((), (TS.Comb("F0", TS.A("P0")), TS.Comb("F0", TS.A("P1")))),
                       TS.TEAM, TS.NAMES)


def test_team_halving_equals_product_by_one_half():
    """The kernel's halving of a stored residue is the Montgomery product
    with 1/2 (fused._dbl_step's two_inv), on edge and random residues."""
    from bn254_tpu_torch import limbs as L
    x = _team_inputs(SEED + 10)["f"][:2]
    two_inv = FU._const(pow(2, Q - 2, Q), x)
    assert torch.equal(_team_half_mod(x), L.mont_mul(x, two_inv, MK.FQ_MOD))


def test_team_square_equals_plain_version():
    """The team Fq12 square (12 products, one round) equals
    fq12_sqr_plain bit for bit."""
    from bn254_tpu_torch import team_schedule as TS
    f = _team_inputs(SEED + 11)["f"]
    st = team_state(f=f)
    team_round(st, TS.Round(TS.SQR_MULS, TS.SQR_LINS), 0)
    assert torch.equal(team_slots(st, "F0", "F1", "F2", "F3", "F4", "F5"),
                       FU.fq12_sqr_plain(f))


def test_team_fold_equals_plain_version():
    """The team 024 fold (13 products) of a line with its px, py
    scalings taken as Fq2 products by (px, 0), (py, 0) equals
    fq12_fold_line_plain bit for bit."""
    from bn254_tpu_torch import team_schedule as TS
    d = _team_inputs(SEED + 12)
    st = team_state(f=d["f"], p=d["p"])
    ell_0, ell_vw, ell_vv = d["c"].view(3, 2, 16, -1)
    st[TS.SLOT["L0"]] = ell_0
    st[TS.SLOT["L2"]], st[TS.SLOT["L4"]] = FU._fq2_mul_lazy(
        torch.stack([ell_vv, ell_vw]), torch.stack([st[TS.SLOT["PX"]], st[TS.SLOT["PY"]]]))
    team_round(st, TS.Round(TS.FOLD_MULS, TS.FOLD_LINS), 0)
    assert torch.equal(team_slots(st, "F0", "F1", "F2", "F3", "F4", "F5"),
                       FU.fq12_fold_line_plain(d["f"], d["c"], *d["p"]))


# The prepared Miller loop's schedule (bn254_tpu_torch/loop_schedule.py,
# csrc/fused.cu k_miller_loop): the Miller kernel's square and fold rounds
# over a slot map of their own, two sets of line slots in turn.

def team_miller_loop(n, flags, f, c, px, py):
    """k_miller_loop on the CPU, its arguments in its order: f (or 1 for
    None) and, with lines c [n, 6, 16, B], (px, 0), (py, 0) and line 0 raw
    into the slots, then line 0's scalings; per step line i + 1 into the
    other set, then the rounds loop_schedule.step_rounds picks (the square
    where flags[i] is set, or every step without lines).  Returns f
    [12, 16, B]."""
    from bn254_tpu_torch import loop_schedule as LS
    base = px if c is not None else f[0]
    one = FU._fq12_one(base)[0, 0]
    zero = torch.zeros_like(one)
    st = [zero] * LS.N_SLOTS
    st[:6] = list(f.view(6, 2, 16, -1)) if f is not None else [one] + [zero] * 5
    run = lambda r: team_round(st, LS.ROUNDS[r], 0, LS.SLOT)

    def put(j, s):          # thread k's Fq of line j into half k & 1 of its slot
        for k in range(6):
            i = LS.SLOT[s + "0"] + LS.LINE_SLOT[k]
            v = st[i].clone()
            v[k & 1] = c[j, k]
            st[i] = v
    if c is not None:
        st[LS.SLOT["PX"]], st[LS.SLOT["PY"]] = (torch.stack([x, zero[0]]) for x in (px, py))
        put(0, LS.SETS[0])
        run(LS.R_SCALE)
    for i in range(n):
        if c is None:
            run(LS.R_SQR)
            continue
        if i + 1 < n:
            put(i + 1, LS.SETS[(i + 1) % 2])
        for r in LS.step_rounds(n, i, flags is not None and bool(flags[i])):
            run(r)
    return torch.stack(st[:6]).reshape(12, 16, -1)


@pytest.mark.parametrize("index", range(6))
def test_loop_schedule_round_is_race_free(index):
    """Every round of the loop's table passes check_round over the loop's
    slots, fits a round's passes (the fold with the next step's scalings
    in its spare tasks: 15 products, three passes), names only the lane's
    27 slots, and the header holds it."""
    from bn254_tpu_torch import loop_schedule as LS
    from bn254_tpu_torch import team_schedule as TS
    assert len(LS.ROUNDS) == 6 and LS.N_SLOTS == 27
    rnd = LS.ROUNDS[index]
    TS.check_round(rnd, TS.TEAM, LS.SLOT)
    assert [len(r.muls) for r in LS.ROUNDS] == [12, 2, 13, 13, 15, 15]
    used = set().union(*(TS.reads(m.x) | TS.reads(m.y) | {m.dst} for m in rnd.muls),
                       *(TS.reads(c.lin) | {c.dst} for c in rnd.lins))
    assert used <= set(LS.SLOT)
    assert LS.header().count("#define BN254_LOOP_ROUNDS") == 1
    passes = sum(-(-len(LS.ROUNDS[r].muls) // TS.TEAM) for i in range(87)
                 for r in LS.step_rounds(87, i, i < 64))
    assert passes + 1 == 87 * 3 + 64 * 2 + 1     # + line 0's scalings


def test_team_loop_model_equals_plain_version():
    """The whole team loop (87 lines, 64 squares) equals miller_loop_plain
    limb for limb on the kernel case's inputs at batch 8: residue lines
    and px, py with 0, 1 and q - 1 in the first lanes, lane 0 all zeros."""
    from bn254_tpu_torch import kernel_cases as KC
    case = next(c for c in KC.CASES if c.label == "miller_loop")
    c, px, py, flags = case.make_args(np.random.default_rng(SEED + 13), 8, "cpu")
    assert torch.equal(team_miller_loop(len(flags), flags, None, c, px, py),
                       FU.miller_loop_plain(c, px, py, flags))


@pytest.mark.parametrize("label", ["fq12_sqr", "fq12_fold_line"])
def test_team_loop_one_step_forms_equal_plain_versions(label):
    """Rows 13 and 8 as the one-step launches of k_miller_loop (a square
    and no line; a line and no flags) equal their plain versions."""
    from bn254_tpu_torch import kernel_cases as KC
    case = next(c for c in KC.CASES if c.label == label)
    args = case.make_args(np.random.default_rng(SEED + 14), 8, "cpu")
    if label == "fq12_sqr":
        got = team_miller_loop(1, None, args[0], None, None, None)
    else:
        f, c, px, py = args
        got = team_miller_loop(1, None, f, c.unsqueeze(0), px, py)
    assert torch.equal(got, case.plain(*args))
