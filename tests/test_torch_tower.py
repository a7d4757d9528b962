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


_FQ2_UNARY = {
    "inv": (T.fq2_inv, JT.fq2_inv),
    "mul_by_xi": (T.fq2_mul_by_xi, JT.fq2_mul_by_xi),
    "conj": (T.fq2_conj, JT.fq2_conj),
    "frob1": (lambda x: T.fq2_frob(x, 1), lambda x: JT.fq2_frob(x, 1)),
}


@pytest.mark.parametrize("op", sorted(_FQ2_UNARY))
def test_fq2_unary_vs_jax(op):
    rng = random.Random(SEED + 1)
    a_np = JT.fq2_encode([(0, 0), (1, 0)] + [_fq2(rng) for _ in range(B)])
    ours, theirs = _FQ2_UNARY[op]
    assert_same(ours(_port(a_np)), on_tape(theirs, a_np))


_FQ6_OPS = {
    "mul": (T.fq6_mul, JT.fq6_mul),
    "sqr": (lambda a, b: T.fq6_sqr(a), lambda a, b: JT.fq6_sqr(a)),
    "inv": (lambda a, b: T.fq6_inv(a), lambda a, b: JT.fq6_inv(a)),
    **{f"frob{k}": (lambda a, b, k=k: T.fq6_frob(a, k),
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
