"""The port's G1/G2 group law (bn254_tpu_torch.groups and the plain
versions of the point_add / point_double kernels, queue rows 17-18, and of
their step loops, msm_combine and point_mul) against the JAX package's
groups on the CPU and the spec oracle, on the same inputs.  Comparisons are exact, limb for limb, wherever the formula is the
same; projective only against the spec."""

import random

import jax
import numpy as np
import pytest
import torch

from bn254_tpu import groups as JG
from bn254_tpu import limbs as JL
from bn254_tpu import pallas_fused as PF
from bn254_tpu import tape
from bn254_tpu.spec import group as SG
from bn254_tpu.spec.constants import R
from bn254_tpu_torch import convert
from bn254_tpu_torch import fused as FU
from bn254_tpu_torch import groups as G
from bn254_tpu_torch import kernel_cases as KC
from bn254_tpu_torch import msm as M
from test_torch_tower import assert_same, on_tape

torch.set_num_threads(1)

SEED = 0x6A0
B = 8
GROUPS = {"g1": (G.G1, JG.G1, SG.G1_PARAMS, PF.FqA),
          "g2": (G.G2, JG.G2, SG.G2_PARAMS, PF.Fq2A)}


def _mul(k, params):
    ops, gen = params[:2]
    return SG.scalar_mul((gen[0], gen[1], ops.one), k, ops)


def _edge_pairs(params):
    """tests/test_pallas_fused.py's edge batch: p = (2 + i) G with p[0] at
    infinity and p[1] = p[2]; q = p with q[3] = -p[3] and q[4] at
    infinity; lane 5 doubles p through the other representative."""
    ops = params[0]
    pts = [_mul(2 + i, params) for i in range(B)]
    pts[0] = SG.zero(ops)
    pts[1] = pts[2]
    qts = list(pts)
    qts[3] = SG.neg(pts[3], ops)
    qts[4] = SG.zero(ops)
    qts[5] = SG.add(SG.zero(ops), _mul(7, params), ops)
    pts[5] = SG.add(_mul(3, params), _mul(4, params), ops)   # 7G, another z
    return pts, qts


def _both(K, JK, pts):
    """The same points as a JAX numpy tree and a port CPU tree."""
    j = jax.tree.map(np.asarray, JG.encode_points(JK, pts))
    return j, convert.from_numpy(j, "cpu")


@pytest.mark.parametrize("group", ["g1", "g2"])
def test_point_add_double_vs_jax(group):
    """Rows 17-18's plain versions (through groups.add / double) equal the
    JAX package's groups.add / double bit for bit on the edge lanes:
    P + inf, inf + Q, P + P, P + (-P), and coincide through another z."""
    K, JK, params, _ = GROUPS[group]
    ops = params[0]
    pts, qts = _edge_pairs(params)
    jp, p = _both(K, JK, pts)
    jq, q = _both(K, JK, qts)
    got_add, got_dbl = G.add(K, p, q), G.double(K, p)
    assert_same(got_add, on_tape(lambda a, b: JG._add_jnp(JK, a, b), jp, jq))
    assert_same(got_dbl, on_tape(lambda a: JG._double_jnp(JK, a), jp))
    for i, (s, d) in enumerate(zip(G.decode_points(K, got_add), G.decode_points(K, got_dbl))):
        assert SG.eq(s, SG.add(pts[i], qts[i], ops), ops), i
        assert SG.eq(d, SG.double(pts[i], ops), ops), i


@pytest.mark.parametrize("group", ["g1", "g2"])
def test_neg_and_eq_points_vs_jax(group):
    K, JK, params, _ = GROUPS[group]
    ops = params[0]
    pts, qts = _edge_pairs(params)
    jp, p = _both(K, JK, pts)
    jq, q = _both(K, JK, qts)
    assert_same(G.neg(K, p), JG.neg(JK, jp))
    got = G.eq_points(K, p, q)
    assert got.tolist() == np.asarray(JG.eq_points(JK, jp, jq)).tolist()
    assert got.tolist() == [SG.eq(a, b, ops) for a, b in zip(pts, qts)]
    assert G.eq_points(K, p, p).all()


@pytest.mark.parametrize("group", ["g1", "g2"])
def test_scalar_mul_16_bits(group):
    """MSB-first double-and-add over 16 bits: equal to the spec for both
    groups, and bit for bit to the JAX package's scalar_mul for G1 (the
    same generic code serves G2)."""
    K, JK, params, _ = GROUPS[group]
    ops = params[0]
    rng = random.Random(SEED)
    pts = [_mul(rng.randrange(1, R), params) for _ in range(4)] + [SG.zero(ops)]
    ks = [0, 1, 0xFFFF, rng.randrange(1 << 16), 77]
    jp, p = _both(K, JK, pts)
    k = torch.from_numpy(JL.stack_ints(ks).astype(np.int32))
    got = G.scalar_mul(K, p, k, num_bits=16)
    for g, pt, kv in zip(G.decode_points(K, got), pts, ks):
        assert SG.eq(g, SG.scalar_mul(pt, kv, ops), ops)
    if group == "g1":
        assert_same(got, JG.scalar_mul(JK, jp, np.asarray(JL.stack_ints(ks)), num_bits=16))


def _mul_unreduced(p, k, ops):
    """The spec's double-and-add (SG.scalar_mul) without its reduction of k
    mod r, which holds only inside the subgroup: k * p for any point."""
    res = SG.zero(ops)
    for i in reversed(range(k.bit_length())):
        res = SG.double(res, ops)
        if (k >> i) & 1:
            res = SG.add(res, p, ops)
    return res


@pytest.mark.parametrize("group", ["g1", "g2"])
def test_msm_combine_plain_vs_jax_horner_and_roll_fold(group):
    """msm_combine_plain equals, limb for limb, the JAX package's Horner
    scan and roll fold (msm.py:288-318) spelled with its _double_jnp /
    _add_jnp on the tape, at W = 4, c = 2, 8 lanes; the totals
    (kernel_cases.combine_points) hold infinity windows, a window equal to
    Horner's running value (coincide) and a P + (-P) fold pair.  The sum
    equals the spec's."""
    K, JK, params, _ = GROUPS[group]
    ops, nc = params[0], K.COORDS
    W, c, lanes = 4, 2, 8
    tot = KC.combine_points(np.random.default_rng(SEED), nc, lanes, W, c)
    both = [_both(K, JK, row) for row in tot]
    got = FU.msm_combine_plain(nc, torch.stack([convert.pack(p) for _, p in both]), c)
    assert got.shape == (3 * nc, 16, 1)

    def horner_fold(*windows):
        rec = tape.active()
        res = windows[-1]
        for w in range(W - 2, -1, -1):
            for _ in range(c):
                res = JG._double_jnp(JK, res)
            res = JG._add_jnp(JK, res, windows[w])
        k = 1
        while k < lanes:     # jnp.roll(a, -k): lane i <- lane i + k
            res = JG._add_jnp(JK, res, jax.tree.map(lambda a: rec.roll(a, k), res))
            k *= 2
        return res

    want = on_tape(horner_fold, *[j for j, _ in both])
    assert_same(convert.unpack_point(nc, got), jax.tree.map(lambda a: np.asarray(a)[:, :1], want))
    total = SG.zero(ops)
    for lane in range(lanes):
        res = tot[-1][lane]
        for w in range(W - 2, -1, -1):
            for _ in range(c):
                res = SG.double(res, ops)
            res = SG.add(res, tot[w][lane], ops)
        total = SG.add(total, res, ops)
    assert SG.eq(G.decode_points(K, convert.unpack_point(nc, got))[0], total, ops)


@pytest.mark.parametrize("group", ["g1", "g2"])
def test_point_mul_plain_vs_spec(group):
    """point_mul_plain (through groups.scalar_mul) over r's 254 bits at B =
    4 with k = 0, 1, r - 1, r equals the spec's double-and-add on points
    in the subgroup and, for G2, on twist points outside it, where r * P
    is not the identity (the codec's subgroup check)."""
    K, JK, params, _ = GROUPS[group]
    ops = params[0]
    rng = random.Random(SEED + 7)
    ks = [0, 1, R - 1, R]
    sets = [[_mul(rng.randrange(1, R), params) for _ in ks]]
    if group == "g2":
        sets.append(KC.twist_points(rng, len(ks)))
    k = torch.from_numpy(JL.stack_ints(ks).astype(np.int32))
    for outside, pts in enumerate(sets):
        got = G.decode_points(K, G.scalar_mul(K, G.encode_points(K, pts, "cpu"), k, 254))
        for g, pt, kv in zip(got, pts, ks):
            want = _mul_unreduced(pt, kv, ops)
            assert SG.eq(g, want, ops), (outside, kv)
            if kv == R:
                assert SG.is_zero(g, ops) != bool(outside)


def _emu(tree):
    """JAX [16, B] leaves -> in-kernel limb lists (as test_pallas_fused)."""
    return jax.tree.map(lambda a: [a[i] for i in range(16)], tree)


def _unemu(tree):
    return jax.tree.map(lambda v: np.asarray(jax.numpy.stack(v)), tree,
                        is_leaf=lambda x: isinstance(x, list))


@pytest.mark.parametrize("group", ["g1", "g2"])
def test_madd_and_affine_double_bodies_vs_jax_kernel_bodies(group):
    """The plain madd and affine-double formulas (inside row 19's plain
    version) equal pallas_fused's k_point_madd_generic and k_affine_double
    kernel bodies bit for bit, run on the CPU as tests/test_pallas_fused.py
    runs kernel bodies.  Lanes: bucket at infinity, p == q (coincide),
    p == -q, generic."""
    K, JK, params, A = GROUPS[group]
    ops = params[0]
    base = [_mul(3 + i, params) for i in range(B)]
    q_aff = [SG.to_affine(p, ops) for p in base]
    p_pts = []
    for i, (x, y) in enumerate(q_aff):
        p_pts.append([SG.zero(ops), (x, y, ops.one), (x, ops.neg(y), ops.one),
                      SG.scalar_mul(base[i], 7, ops)][i % 4])
    jp, p = _both(K, JK, p_pts)
    jqx, jqy = jax.tree.map(np.asarray, (JK.encode([x for x, _ in q_aff]),
                                         JK.encode([y for _, y in q_aff])))
    qx, qy = convert.from_numpy((jqx, jqy), "cpu")
    KC_ = PF.KCtx(PF._fq_mod())
    want, want_co = PF.k_point_madd_generic(KC_, A, _emu(jp), (_emu(jqx), _emu(jqy)))
    C = FU._coord(K.COORDS)
    stack = lambda t: t if K is G.G1 else torch.stack(t, -3)
    got, got_co = FU._point_madd_generic(C, tuple(map(stack, p)), stack(qx), stack(qy))
    unstack = lambda t: t if K is G.G1 else tuple(t.unbind(-3))
    assert_same(tuple(map(unstack, got)), _unemu(want))
    assert got_co.tolist() == np.asarray(want_co).tolist() == [i % 4 == 1 for i in range(B)]
    dbl = FU._affine_double(C, stack(qx), stack(qy))
    want_dbl = PF.k_affine_double(KC_, A, (_emu(jqx), _emu(jqy)))
    assert_same(tuple(map(unstack, dbl)), _unemu(want_dbl))


def test_affine_jacobian_curve_and_subgroup_checks():
    """to_jacobian with an infinity mask, on_curve for G1 and G2, and
    in_subgroup on G1 (a 256-bit scalar_mul on two lanes)."""
    for group in ("g1", "g2"):
        K, JK, params, _ = GROUPS[group]
        ops = params[0]
        aff = [SG.to_affine(_mul(k, params), ops) for k in (5, 9)]
        bad = (aff[0][0], ops.add(aff[0][1], ops.one))
        xy = tuple(K.encode([a[i] for a in aff + [bad]], "cpu") for i in range(2))
        assert G.on_curve(K, xy).tolist() == [True, True, False]
        jac = G.to_jacobian(K, xy, torch.tensor([False, True, False]))
        assert G.is_zero_point(K, jac).tolist() == [False, True, False]
        assert SG.eq(G.decode_points(K, jac)[0], _mul(5, params), ops)
    xy = tuple(G.G1.encode([a[i] for a in
                            [SG.to_affine(_mul(k, SG.G1_PARAMS), SG.G1_PARAMS[0]) for k in (5, 9)]],
                           "cpu") for i in range(2))
    assert G.in_subgroup(G.G1, xy).tolist() == [True, True]


def _check_combine_inputs(args, params):
    """The combine's planted totals (kernel_cases.combine_points)."""
    nc, totals, c = args
    K, ops = (G.G1, params[0]) if nc == 1 else (G.G2, params[0])
    W, lanes = totals.shape[0], totals.shape[-1]
    assert c == M.MSM_FUSED_WINDOW[nc] and W == (254 + c) // c and lanes == 16
    tot = [G.decode_points(K, convert.unpack_point(nc, t)) for t in totals]
    for row in tot:
        for pt in row:
            assert SG.is_zero(pt, ops) or SG.on_curve(*SG.to_affine(pt, ops), params[2], ops)
    assert SG.is_zero(tot[W - 1][1], ops) and SG.is_zero(tot[1][2], ops)
    for lane, at in ((3, W - 3), (4, 0)):      # Horner meets its own running value
        res = tot[W - 1][lane]
        for w in range(W - 2, at - 1, -1):
            for _ in range(c):
                res = SG.double(res, ops)
            if w > at:
                res = SG.add(res, tot[w][lane], ops)
        assert SG.eq(tot[at][lane], res, ops) and tot[at][lane] != res
    for a, b in [(6, 7)] + [(j, 8 + j) for j in range(8)]:     # P + (-P) in the fold
        assert all(SG.eq(tot[w][b], SG.neg(tot[w][a], ops), ops) for w in range(W))
    dbl, add = KC._DBL[nc], KC._ADD[nc]
    assert KC.combine_depth(*args) == (W - 1) * c * dbl + (W - 1 + 4) * add


def _check_point_mul_inputs(args, params):
    """The double-and-add's edge lanes (kernel_cases.POINT_MUL_EDGES)."""
    nc, p, k, num_bits = args
    K, ops = (G.G1, params[0]) if nc == 1 else (G.G2, params[0])
    assert num_bits == 254 and k.shape == (16, 16) and k.dtype == torch.int32
    ks = JL.ints_from_stack(k.numpy())
    pts = G.decode_points(K, convert.unpack_point(nc, p))
    for lane, (kv, kind) in enumerate(KC.POINT_MUL_EDGES):
        assert ks[lane] == kv
        pt = pts[lane]
        assert SG.is_zero(pt, ops) == (kind == "inf")
        if kind != "inf":
            assert SG.on_curve(*SG.to_affine(pt, ops), params[2], ops)
            outside = kind == "off" and nc == 2
            assert SG.is_zero(_mul_unreduced(pt, R, ops), ops) != outside, lane
    assert all(kv < R for kv in ks[len(KC.POINT_MUL_EDGES):])
    assert KC.point_mul_depth(*args) == 254 * KC._DBL[nc] + max(
        bin(kv).count("1") for kv in ks) * KC._ADD[nc]


@pytest.mark.parametrize("label", [c.label for c in KC.CASES if c.name in
                                   ("point_add", "point_double", "msm_accumulate",
                                    "msm_combine", "point_mul")])
def test_kernel_case_inputs(label):
    """chip_smoke.py's inputs for rows 17-19 and the group law's step loops
    at a small size: the point edge lanes are what they claim, the planted
    MSM duplicates share their digits, the skewed MSM puts each window in
    one bucket, the combine's totals and the double-and-add's scalars hold
    their planted edges, and the work count gives a positive bound."""
    case = next(c for c in KC.CASES if c.label == label)
    size = 1000 if case.name == "msm_accumulate" else 16
    args = case.make_args(np.random.default_rng(1), size, "cpu")
    products, nbytes = case.work(*args)
    ms, by = KC.bound_ms(products, nbytes)
    assert products > 0 and nbytes > 0 and ms > 0 and by in ("bytes", "operations")
    nc = args[0]
    K, _, params, _ = GROUPS[f"g{nc}"]
    ops = params[0]
    if case.name == "msm_combine":
        return _check_combine_inputs(args, params)
    if case.name == "point_mul":
        return _check_point_mul_inputs(args, params)
    if case.name == "msm_accumulate":
        _, pts, digits, nb, signed, lanes = args
        assert lanes == 200 and nb == (1 << (M.MSM_FUSED_WINDOW[nc] - 1)) + 1
        assert torch.equal(pts[:, :, lanes:lanes + 8], pts[:, :, :8])
        assert torch.equal(digits[:, lanes:lanes + 16], digits[:, :16])
        assert int(digits.abs().max()) <= nb - 1
        if "skew" in label:              # every lane of a window in one bucket
            assert not bool(digits[0].any())
            assert all(len(set(row.tolist())) == 1 and int(row[0]) for row in digits[1:])
        return
    p = G.decode_points(K, convert.unpack_point(nc, args[1]))
    for pt in p:
        assert SG.is_zero(pt, ops) or SG.on_curve(*SG.to_affine(pt, ops), params[2], ops)
    if case.name == "point_add":
        q = G.decode_points(K, convert.unpack_point(nc, args[2]))
        assert SG.is_zero(p[0], ops) and SG.is_zero(q[1], ops)
        assert p[3] == q[3] and SG.eq(p[4], q[4], ops) and p[4] != q[4]
        assert SG.eq(q[5], SG.neg(p[5], ops), ops) and p[6][2] == ops.one
        # the kernel's plain version agrees with the spec on every lane
        out = G.decode_points(K, convert.unpack_point(nc, FU.point_add_plain(*args)))
        for a, b, s in zip(p, q, out):
            assert SG.eq(s, SG.add(a, b, ops), ops)
