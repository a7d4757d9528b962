"""The port's GLV scalar multiplication (bn254_tpu_torch.glv, the plain
version of the glv_ladder kernel, queue row 20, and batch.scalar_mul_g1)
against the JAX package's glv on the CPU and the spec oracle, on the same
inputs.  Comparisons with the JAX package are exact, limb for limb and
Jacobian representative included; with the spec, projective."""

import random

import jax
import numpy as np
import pytest
import torch

from bn254_tpu import glv as JGLV
from bn254_tpu import groups as JG
from bn254_tpu import limbs as JL
from bn254_tpu.spec import group as SG
from bn254_tpu.spec.constants import R
from bn254_tpu_torch import api as TA
from bn254_tpu_torch import batch as BA
from bn254_tpu_torch import convert, counts
from bn254_tpu_torch import fused as FU
from bn254_tpu_torch import glv as GLV
from bn254_tpu_torch import groups as G
from bn254_tpu_torch import kernel_cases as KC
from bn254_tpu_torch import mont_kernels as MK
from bn254_tpu_torch import msm as M
from test_torch_tower import assert_same

torch.set_num_threads(1)

SEED = 0x617
GROUPS = {"g1": (G.G1, JG.G1, SG.G1_PARAMS), "g2": (G.G2, JG.G2, SG.G2_PARAMS)}
EDGES = [0, 1, R - 1, R // 2, JGLV.LAMBDA, R - JGLV.LAMBDA]


def _mul(k, params):
    ops, gen = params[:2]
    return SG.scalar_mul((gen[0], gen[1], ops.one), k, ops)


def _scalars_np(ks):
    return np.asarray(JL.stack_ints(ks))


def _points_and_scalars(group, n):
    """n spec points with z != 1 (lane 0 at infinity) and scalars with the
    edges k = 0, 1, r - 1, lambda on lanes 1-4."""
    K, JK, params = GROUPS[group]
    ops = params[0]
    rng = random.Random(SEED + n + (group == "g2"))
    pts = [SG.add(_mul(rng.randrange(1, R), params), _mul(rng.randrange(1, R), params), ops)
           for _ in range(n)]
    pts[0] = SG.zero(ops)
    ks = [rng.randrange(R) for _ in range(n)]
    ks[1:5] = [0, 1, R - 1, JGLV.LAMBDA][:n - 1]
    return pts, ks


def test_constants_equal_the_jax_package():
    for name in ("LAMBDA", "BETA_G1", "BETA_G2", "NUM_BITS", "_V1", "_V2", "_G1C", "_G2C",
                 "_SHIFT"):
        assert getattr(GLV, name) == getattr(JGLV, name), name
    assert GLV._SHIFT == 270 and GLV.NUM_BITS == 128


def test_decompose_vs_jax():
    """Limb for limb on 64 random scalars and the edges; each split is
    k = k1 + k2 lambda (mod r) with |k1|, |k2| < 2^128."""
    rng = random.Random(SEED)
    ks = [rng.randrange(R) for _ in range(64)] + EDGES
    got = GLV.decompose(M.encode_scalars(ks, "cpu"))
    want = jax.jit(JGLV.decompose)(_scalars_np(ks))
    for g, w in zip(got, want):
        assert np.array_equal(g.numpy().astype(np.asarray(w).dtype), np.asarray(w))
    a1, s1, a2, s2 = got
    for i, (v1, v2, k) in enumerate(zip(JL.ints_from_stack(a1.numpy()),
                                        JL.ints_from_stack(a2.numpy()), ks)):
        k1, k2 = v1 * (-1 if s1[i] else 1), v2 * (-1 if s2[i] else 1)
        assert (k1 + k2 * GLV.LAMBDA) % R == k and max(v1, v2) < 1 << GLV.NUM_BITS


@pytest.mark.parametrize("group", ["g1", "g2"])
def test_endo_and_ladder_digits_vs_jax(group):
    K, JK, params = GROUPS[group]
    pts, ks = _points_and_scalars(group, 4)
    jp = jax.tree.map(np.asarray, JG.encode_points(JK, pts))
    got = GLV.endo(K, convert.from_numpy(jp, "cpu"))
    assert_same(got, JGLV.endo(JK, jp))
    for p, g in zip(pts, G.decode_points(K, got)):    # phi(P) = lambda P
        assert SG.eq(g, SG.scalar_mul(p, GLV.LAMBDA, params[0]), params[0])
    a1, _, a2, _ = GLV.decompose(M.encode_scalars(ks, "cpu"))
    want = JGLV._ladder_digits(*(np.asarray(a, np.uint32) for a in (a1, a2)))
    assert np.array_equal(GLV._ladder_digits(a1, a2).numpy(), np.asarray(want))


def _jax_glv_stepwise(JK, jp, k_np):
    """glv.scalar_mul_glv's scan spelling (glv.py:280-318), its body driven
    one step at a time with the JAX package's memo-jitted groups.double /
    groups.add: for G2 that compiles in a third of the time a jit of the
    whole scan takes."""
    a1, s1, a2, s2 = (np.asarray(a) for a in jax.jit(JGLV.decompose)(k_np))
    php = JGLV.endo(JK, jp)
    p1 = JGLV._select_point(JK, s1, JG.neg(JK, jp), jp)
    p2 = JGLV._select_point(JK, s2, JG.neg(JK, php), php)
    p12 = JG.add(JK, p1, p2)
    inf = JG.zero_point(JK, k_np.shape[-1])
    res = inf
    for i in range(JGLV.NUM_BITS - 1, -1, -1):
        res = JG.double(JK, res)
        limb, sh = divmod(i, 16)
        b1, b2 = (((a[limb] >> sh) & 1).astype(bool) for a in (a1, a2))
        hi = JGLV._select_point(JK, b1, p12, p2)
        lo = JGLV._select_point(JK, b1, p1, inf)
        res = JG.add(JK, res, JGLV._select_point(JK, b2, hi, lo))
    return res


@pytest.mark.parametrize("group", ["g1", "g2"])
def test_scalar_mul_glv_vs_jax(group):
    """The whole GLV glue and the ladder's plain version equal the JAX
    package's scalar_mul_glv (its scan spelling, which
    tests/test_plumb_ladder.py holds equal to the Pallas kernel) limb for
    limb on every lane, including p at infinity and k = 0; and the spec's
    scalar_mul projectively.  G1 against the jitted function at 8 lanes,
    G2 against its scan body step by step at 4 lanes."""
    K, JK, params = GROUPS[group]
    pts, ks = _points_and_scalars(group, 8 if group == "g1" else 4)
    jp = jax.tree.map(np.asarray, JG.encode_points(JK, pts))
    got = GLV.scalar_mul_glv(K, convert.from_numpy(jp, "cpu"), M.encode_scalars(ks, "cpu"))
    if group == "g1":
        want = jax.jit(lambda p, k: JGLV.scalar_mul_glv(JK, p, k))(jp, _scalars_np(ks))
    else:
        want = _jax_glv_stepwise(JK, jp, _scalars_np(ks))
    assert_same(got, want)
    for g, p, k in zip(G.decode_points(K, got), pts, ks):
        assert SG.eq(g, SG.scalar_mul(p, k, params[0]), params[0])


def test_batch_scalar_mul_g1_on_cpu_equals_spec():
    """The user entry over the API's objects on edge inputs: G1.zero()
    (infinity), k = 0, 1, r - 1, lambda, r - lambda, a scalar above r
    (reduced by Fr), a repeated point."""
    ops = SG.G1_PARAMS[0]
    rng = random.Random(SEED + 1)
    p = _mul(rng.randrange(1, R), SG.G1_PARAMS)
    pts = [None, p, p, p, p, p, p, _mul(5, SG.G1_PARAMS)]
    ks = [3] + EDGES[:3] + EDGES[4:] + [R + 7, rng.randrange(R)]
    out = BA.scalar_mul_g1([TA.G1.zero() if pt is None else TA.G1._wrap(pt) for pt in pts],
                           [TA.Fr(k) for k in ks], device="cpu")
    assert len(out) == len(pts) and all(isinstance(g, TA.G1) for g in out)
    for g, pt, k in zip(out, pts, ks):
        want = SG.zero(ops) if pt is None else SG.scalar_mul(pt, k % R, ops)
        assert SG.eq(g.p, want, ops)
    with pytest.raises(ValueError):
        BA.scalar_mul_g1([TA.G1._wrap(p)], [TA.Fr(1), TA.Fr(2)], device="cpu")


@pytest.mark.parametrize("group", ["g1", "g2"])
def test_glv_kernel_case_inputs(group):
    """chip_smoke.py's ladder inputs at a small size: each edge scalar sits
    on a lane whose point is finite and decomposes as claimed, lane 6's
    table is (P, 2P, 3P) and lane 7's (P, -2P, -P), both starting with
    digits (1, 2), and the ladder's plain version gives, on every lane,
    the table's own double-and-add result."""
    nc, B = (1 if group == "g1" else 2), 16
    K, _, params = GROUPS[group]
    ops = params[0]
    case = next(c for c in KC.CASES if c.label == f"glv_ladder[{group}]")
    args = case.make_args(np.random.default_rng(3), B, "cpu")
    products, nbytes = case.work(*args)
    assert products > 0 and KC.bound_ms(products, nbytes)[1] == "operations"
    _, pts, digits = args
    assert pts.shape == (9 * nc, 16, B) and digits.shape == (GLV.NUM_BITS, B)
    table = [G.decode_points(K, convert.unpack_point(nc, t)) for t in pts.view(3, 3 * nc, 16, B)]
    for lane, sign in ((6, 1), (7, -1)):
        p1, p2, p12 = (t[lane] for t in table)
        assert SG.eq(p2, SG.scalar_mul(p1, 2 if sign > 0 else R - 2, ops), ops)
        assert SG.eq(p12, SG.add(p1, p2, ops), ops)
        assert digits[:2, lane].tolist() == [1, 2]
    assert SG.is_zero(table[0][0], ops)
    # the one digit, |k1| + 2 |k2|, of each edge scalar: the last
    last_digit = {0: 0, 1: 1, R - 1: 1, GLV.LAMBDA: 2, R - GLV.LAMBDA: 2}
    assert sorted(KC.GLV_EDGES.values()) == sorted(last_digit)
    for lane, k in KC.GLV_EDGES.items():
        last = last_digit[k]
        assert not SG.is_zero(table[0][lane], ops) and not SG.is_zero(table[1][lane], ops)
        assert digits[:, lane].tolist() == [0] * (GLV.NUM_BITS - 1) + [last], lane
    out = G.decode_points(K, convert.unpack_point(nc, case.plain(*args)))
    for lane in range(B):
        want = SG.zero(ops)
        for d in digits[:, lane].tolist():
            want = SG.double(want, ops)
            if d:
                want = SG.add(want, table[d - 1][lane], ops)
        assert SG.eq(out[lane], want, ops), lane


def test_glv_path_reaches_every_kernel_with_valid_arguments(monkeypatch):
    """The GLV path with the wrappers taking their kernel branch on CPU
    tensors and the launch stubbed out: every wrapper's checks pass, the
    path's kernels are reached (one ladder launch per call) and no plain
    version runs.  Batch 3 is ragged; G1 and G2, and the user entry."""
    def launch(name, batch, *args):
        counts.launches[name] += 1

    for mod in (MK, FU):
        monkeypatch.setattr(mod, "on_cuda", lambda t: True)
        monkeypatch.setattr(mod, "launch", launch)
    counts.reset()
    for group in ("g1", "g2"):
        K, _, params = GROUPS[group]
        pts, ks = _points_and_scalars(group, 3)
        GLV.scalar_mul_glv(K, G.encode_points(K, pts, "cpu"), M.encode_scalars(ks, "cpu"))
    BA.scalar_mul_g1([TA.G1.zero(), TA.G1._wrap(_mul(3, SG.G1_PARAMS))], [TA.Fr(5), TA.Fr(7)],
                     device="cpu")
    assert sorted(k for k, v in counts.launches.items() if v) == sorted(counts.GLV_PATH)
    assert counts.launches["glv_ladder"] == 3
    assert not any(counts.plain_calls.values())
    with pytest.raises(ValueError):
        FU.glv_ladder(1, torch.zeros((9, 16, 4), dtype=torch.int32),
                      torch.full((128, 4), 4, dtype=torch.int32))
