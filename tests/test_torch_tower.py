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


def test_final_exponentiation_vs_jax():
    rng = random.Random(SEED + 8)
    av = [_fq12(rng) for _ in range(3)]
    a_np = JT.fq12_encode(av)
    got = T.fq12_final_exponentiation(_port(a_np))
    assert_same(got, jax.jit(JT.fq12_final_exponentiation)(a_np))
    assert T.fq12_decode(got) == [SF.fq12_final_exponentiation(x) for x in av]
