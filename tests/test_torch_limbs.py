"""The port's limb layer, converters and Fq/Fr fields (bn254_tpu_torch on
the CPU, plain versions) against the JAX package on the same numpy inputs.
Comparisons are exact: canonical ints and limb arrays must be equal."""

import random

import jax
import numpy as np
import pytest
import torch

from bn254_tpu import limbs as JL
from bn254_tpu import tower as JT
from bn254_tpu.fields import FQ as JFQ, FR as JFR
from bn254_tpu.spec.constants import Q, R
from bn254_tpu_torch import convert, counts
from bn254_tpu_torch import limbs as L
from bn254_tpu_torch import mont_kernels as MK
from bn254_tpu_torch.fields import FQ, FR

# The plain versions run many small tensor ops: intra-op threads only add
# overhead at these batch sizes, and the test workers already run in parallel.
torch.set_num_threads(1)

SEED = 0x7041
FIELDS = {"fq": (Q, JFQ, FQ), "fr": (R, JFR, FR)}


def _vals(p, n, seed):
    """Edge values first (0, 1, 2, p-1, p-2, 2^255 mod p), then random."""
    rng = random.Random(seed)
    return [0, 1, 2, p - 1, p - 2, (1 << 255) % p] + [rng.randrange(p) for _ in range(n)]


def test_converter_round_trip():
    rng = random.Random(SEED)
    vals = [((rng.randrange(Q), rng.randrange(Q)),) * 3 for _ in range(4)]
    vals = [(v, v) for v in vals]                        # Fq12 shape
    jax_tree = JT.fq12_encode(vals)                      # numpy uint32 leaves
    t = convert.from_numpy(jax_tree, "cpu")
    assert all(x.dtype == torch.int32 and x.shape == (16, 4)
               for x in convert.tree_leaves(t))
    back = convert.to_numpy(t)
    for a, b in zip(jax.tree.leaves(jax_tree), convert.tree_leaves(back)):
        assert b.dtype == np.uint32 and np.array_equal(a, b)
    packed = convert.pack(t)
    assert packed.shape == (12, 16, 4) and packed.is_contiguous()
    for a, b in zip(convert.tree_leaves(convert.unpack_fq12(packed)),
                    convert.tree_leaves(t)):
        assert torch.equal(a, b)
    assert convert.decode(t, FQ.mod) == convert.tree_map(JFQ.decode, jax_tree)


@pytest.mark.parametrize("field", sorted(FIELDS))
def test_mod_constants_match_jax(field):
    p, jctx, tctx = FIELDS[field]
    jm, tm = jctx.mod, tctx.mod
    assert np.array_equal(jm.q_np, tm.q_np)
    assert np.array_equal(jm.notq_np, tm.notq_np)
    assert int(jm.qinv) == int(tm.qinv)
    assert (jm.r, jm.r2, jm.r_inv) == (tm.r, tm.r2, tm.r_inv)
    assert (tm.qinv32 * p) % (1 << 32) == (1 << 32) - 1      # -p^-1 mod 2^32
    vals = _vals(p, 10, SEED)
    enc = jm.encode_batch(vals)
    assert np.array_equal(enc, tm.encode_batch(vals))
    assert tm.decode_batch(enc) == jm.decode_batch(enc) == vals


_OPS = {
    "add": (lambda a, b, m: L.add_mod(a, b, m), lambda a, b, m: JL.add_mod(a, b, m)),
    "sub": (lambda a, b, m: L.sub_mod(a, b, m), lambda a, b, m: JL.sub_mod(a, b, m)),
    "neg": (lambda a, b, m: L.neg_mod(a, m), lambda a, b, m: JL.neg_mod(a, m)),
    "mont_mul": (lambda a, b, m: L.mont_mul(a, b, m), lambda a, b, m: JL.mont_mul(a, b, m)),
    "mont_sqr": (lambda a, b, m: L.mont_sqr(a, m), lambda a, b, m: JL.mont_sqr(a, m)),
}


@pytest.mark.parametrize("op", sorted(_OPS))
@pytest.mark.parametrize("field", sorted(FIELDS))
def test_plain_limb_op_vs_jax(field, op):
    p, jctx, tctx = FIELDS[field]
    av = _vals(p, 26, SEED + 1)
    bv = list(reversed(_vals(p, 26, SEED + 2)))
    a_np, b_np = jctx.mod.encode_batch(av), jctx.mod.encode_batch(bv)
    ours, theirs = _OPS[op]
    got = ours(*convert.from_numpy((a_np, b_np), "cpu"), tctx.mod)
    want = np.asarray(jax.jit(lambda a, b: theirs(a, b, jctx.mod))(a_np, b_np))
    assert np.array_equal(convert.to_numpy(got), want)
    assert tctx.decode(got) == jctx.decode(want)


def test_plain_ops_broadcast_over_leading_axes():
    """A stacked call equals the calls one by one (what the tower relies on)."""
    a = convert.from_numpy(FQ.mod.encode_batch(_vals(Q, 10, 5)), "cpu")
    b = convert.from_numpy(FQ.mod.encode_batch(_vals(Q, 10, 6)), "cpu")
    st_a, st_b = torch.stack([a, b, a]), torch.stack([b, b, a])
    for op in (L.add_mod, L.sub_mod, L.mont_mul):
        out = op(st_a, st_b, FQ.mod)
        for k in range(3):
            assert torch.equal(out[k], op(st_a[k], st_b[k], FQ.mod))


@pytest.mark.parametrize("field", sorted(FIELDS))
def test_inv_vs_jax_zero_to_zero(field):
    p, jctx, tctx = FIELDS[field]
    vals = _vals(p, 6, SEED + 3)
    a_np = jctx.mod.encode_batch(vals)
    got = tctx.inv(convert.from_numpy(a_np, "cpu"))
    want = np.asarray(jax.jit(jctx.inv)(a_np))
    assert np.array_equal(convert.to_numpy(got), want)
    dec = tctx.decode(got)
    assert dec[0] == 0                                     # inv(0) = 0
    assert dec[1:] == [pow(v, p - 2, p) for v in vals[1:]]


def test_fq_pow_const_vs_jax():
    """fq_pow (row 5) against FQ.pow_const for exponents with 0, 1 and many
    set bits after the leading one."""
    vals = _vals(Q, 6, SEED + 4)
    a_np = JFQ.mod.encode_batch(vals)
    a = convert.from_numpy(a_np, "cpu")
    for e in (1, 2, 3, 0x10001, (Q - 3) // 4):
        got = FQ.pow_const(a, e)
        want = np.asarray(jax.jit(lambda x: JFQ.pow_const(x, e))(a_np))
        assert np.array_equal(convert.to_numpy(got), want)
        assert FQ.decode(got) == [pow(v, e, Q) for v in vals]


@pytest.mark.parametrize("field", sorted(FIELDS))
def test_consecutive_inversions(field):
    """a * a^-1 == 1 for a in 1..64 and -1..-64 (the reference's sweep,
    fields/tests.rs:4-21, cut to size for the CPU plain versions)."""
    p, _, ctx = FIELDS[field]
    vals = list(range(1, 65)) + [p - k for k in range(1, 65)]
    a = ctx.encode(vals, "cpu")
    prod = ctx.mul(a, ctx.inv(a))
    assert bool(ctx.eq(prod, ctx.ones(len(vals), "cpu")).all())


def test_wrappers_take_plain_version_on_cpu():
    counts.reset()
    a = FQ.encode(_vals(Q, 4, 7), "cpu")
    FQ.mul(a, a)
    FQ.sqr(a)
    MK.fq2_mul(torch.stack([a, a]), torch.stack([a, a]))
    assert counts.plain_calls["fq2_mul"] == 1
    assert counts.plain_calls["mont_sqr"] == 1
    assert counts.plain_calls["mont_mul"] >= 2
    assert not any(counts.launches.values())


def test_wrappers_refuse_other_devices():
    a = torch.zeros((16, 4), dtype=torch.int32, device="meta")
    with pytest.raises(ValueError, match="device meta"):
        MK.mont_mul(a, a, FQ.mod)
    with pytest.raises(ValueError, match="device meta"):
        MK.fq2_sqr(torch.zeros((2, 16, 4), dtype=torch.int32, device="meta"))
