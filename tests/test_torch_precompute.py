"""The prepared-G2 lines' team schedule (bn254_tpu_torch/precompute_schedule.py,
csrc/fused.cu k_g2_precompute) on the CPU: every round race-free for a team
of four, and a model of the kernel (its start, then the rounds in its order,
each step's line read from its slots) bit-equal to the plain version
(fused.g2_precompute_plain: pairing_torch.precompute's steps) on residue inputs
with 0, 1 and q - 1 planted and on real G2 points, for the 87 steps and
for the one-step launches of rows 14 and 7.  The model runs the Miller
kernel's team model (tests/test_torch_tower.py team_round: every task of a
half reads the slots as they were before the half, then all write)."""

import random

import numpy as np
import pytest
import torch

from bn254_tpu_torch import _build, convert
from bn254_tpu_torch import fused as FU
from bn254_tpu_torch import groups as G
from bn254_tpu_torch import kernel_cases as KC
from bn254_tpu_torch import pairing_torch as P
from bn254_tpu_torch import precompute_schedule as PS
from bn254_tpu_torch import team_schedule as TS
from bn254_tpu_torch.spec import constants as SC
from bn254_tpu_torch.spec import group as SG
from test_torch_tower import _team_inputs, team_round

torch.set_num_threads(1)

SEED = 0x11E5


def _const2(pair, like):
    return torch.stack([FU._const(v, like) for v in pair])


def team_lines_state(q=None, r=None, base=None):
    """A lane's slots as k_g2_precompute' start writes them: R = r, or (qx, qy,
    1); the bases of kinds 1-4 from q (Q, -Q, and pi(Q), pi^2(Q) with its
    y negated, one lazy product by a twist constant each, as the kernel's
    threads make them), or `base` as kind 1's; b2."""
    like = next(t for t in (q, r, base) if t is not None)[0]
    one = FU._fq12_one(like)[0, 0]
    zero = torch.zeros_like(one)
    st = [zero] * PS.N_SLOTS
    put = lambda names, vals: [st.__setitem__(PS.SLOT[n], v) for n, v in zip(names, vals)]
    if q is not None:
        qx, qy = q.view(2, 2, 16, -1)
        put(("RX", "RY", "RZ"), (qx, qy, one))
        conj = lambda a: torch.stack([a[0], FU._neg(a[1])])
        tw = torch.stack([_const2(t, like) for t in _build.twist_consts()])
        q3x, q3y, q4x, q4y = FU._fq2_mul_lazy(torch.stack([conj(qx), conj(qy), qx, qy]), tw)
        put([f"Q{k}{c}" for k in range(1, 5) for c in "XY"],
            (qx, qy, qx, FU._neg(qy), q3x, q3y, q4x, FU._neg(q4y)))
    if r is not None:
        put(("RX", "RY", "RZ"), r.view(3, 2, 16, -1))
    if base is not None:
        put(("Q1X", "Q1Y"), base.view(2, 2, 16, -1))
    st[PS.SLOT["B2"]] = _const2(SC.B2, like)
    return st


def team_g2_lines(kinds, q=None, r=None, base=None):
    """k_g2_precompute on the CPU: its start, then per step the rounds
    step_rounds picks (an addition's first products in the doubling step
    before it, against that addition's base), then the step's line from
    its three slots.  Returns (lines [n, 6, 16, B], R [6, 16, B])."""
    st = team_lines_state(q, r, base)
    lines = []
    for i in range(len(kinds)):
        rounds, add = PS.step_rounds(kinds, i)
        for j in rounds:
            team_round(st, PS.ROUNDS[j], PS.base_slot(add) if add else 0, PS.NAMES)
        lines.append(torch.stack([st[PS.SLOT[n]] for n in PS.LINE]).reshape(6, 16, -1))
    return torch.stack(lines), torch.stack(st[:3]).reshape(6, 16, -1)


def _real_points(seed, count=3):
    """Affine G2 points [4, 16, count] of random multiples of the generator."""
    rnd = random.Random(seed)
    ops, gen = SG.G2_PARAMS[0], SG.G2_PARAMS[1]
    pts = [SG.to_affine(SG.scalar_mul((*gen, ops.one), rnd.randrange(1, SC.R), ops), ops)
           for _ in range(count)]
    return convert.pack(G.encode_points(G.G2, [(x, y, ops.one) for x, y in pts], "cpu"))[:4]


@pytest.mark.parametrize("index", range(len(PS.ROUNDS)))
def test_precompute_round_is_race_free(index):
    """Every round of the lines' table passes check_round for a team of
    four over the lane's 25 slots and the virtual base (BX, BY), fits two
    product passes and one of combinations, and no round writes the base;
    precompute's 87 steps take 284 product passes; the header holds the
    table."""
    rnd = PS.ROUNDS[index]
    TS.check_round(rnd, PS.TEAM, PS.NAMES)
    assert PS.TEAM == 4 and PS.N_SLOTS == 25 and max(PS.SLOT.values()) < TS.VIRT
    assert [len(r.muls) for r in PS.ROUNDS] == [4, 3, 3, 5, 2, 4, 3, 4]
    assert len(rnd.muls) <= 2 * PS.TEAM and len(rnd.lins) <= PS.TEAM
    used = set().union(*(TS.reads(m.x) | TS.reads(m.y) for m in rnd.muls),
                       *(TS.reads(c.lin) for c in rnd.lins))
    written = {m.dst for m in rnd.muls} | {c.dst for c in rnd.lins}
    assert used | written <= set(PS.NAMES)
    assert not written & (set(PS.VIRTUAL) | {n for n in PS.SLOT if n[0] == "Q"})
    kinds = P._LINE_KINDS
    assert sum(-(-len(PS.ROUNDS[r].muls) // PS.TEAM) for i in range(len(kinds))
               for r in PS.step_rounds(kinds, i)[0]) == 284
    assert PS.header().count("#define BN254_PRE_ROUNDS") == 1


@pytest.mark.parametrize("inputs", ["residues", "points"])
def test_team_lines_model_equals_plain_version(inputs):
    """The whole team kernel, precompute's 87 steps (64 doublings, 21
    additions of Q or -Q, then pi(Q) and -pi^2(Q)), equals
    g2_precompute_plain limb for limb: on kernel_cases.residues at 16
    lanes (0, 1 and q - 1 planted, lane 0 all zeros) and on 3 real affine
    G2 points."""
    q = _team_inputs(SEED)["q"] if inputs == "residues" else _real_points(SEED + 1)
    lines, _ = team_g2_lines(P._LINE_KINDS, q=q)
    assert torch.equal(lines, FU.g2_precompute_plain(q, P._LINE_KINDS))


@pytest.mark.parametrize("label", ["g2_dbl_step", "g2_add_step"])
def test_team_lines_one_step_forms_equal_plain_versions(label):
    """Rows 14 and 7 as one-step launches of k_g2_precompute (R from r_in; an
    addition of base) equal g2_dbl_step_plain and g2_add_step_plain: R'
    and the line."""
    d = _team_inputs(SEED + 2)
    if label == "g2_dbl_step":
        got, want = team_g2_lines([0], r=d["r"]), FU.g2_dbl_step_plain(d["r"])
    else:
        got, want = team_g2_lines([1], r=d["r"], base=d["q"]), FU.g2_add_step_plain(d["r"], d["q"])
    assert torch.equal(got[0][0], want[1]) and torch.equal(got[1], want[0])


@pytest.mark.parametrize("label", ["g2_precompute", "g2_dbl_step", "g2_add_step"])
def test_line_kernel_bounds_count_lazy_fq2_products(label):
    """Rows 14, 7 and the 87-step kernel's bounds count the Fq2 products
    the functions need from the schedule: a general one at 2.5 Montgomery
    products' work (lazy), a square at 2, a halving at none.  A doubling
    step is 22 (4 general products, 6 squares), an addition 31.5 (11 and
    2), their sum the same with an addition's first products in the
    doubling step before it; precompute is 64 doublings, 23 additions
    and the 4 products of the Frobenius bases, 2,142.5 a lane.  Bytes: q
    in and 87 x 6 Fq of lines out; R in and out, the line out (and the
    base in)."""
    case = next(c for c in KC.CASES if c.label == label)
    args = case.make_args(np.random.default_rng(SEED), 10, "cpu")
    products, nbytes = case.work(*args)
    rounds = lambda rs: sum(KC.fq2_mul_work(m) for r in rs for m in PS.ROUNDS[r].muls)
    assert (rounds(TS.DBL), rounds(TS.ADD)) == (22, 31.5)
    assert rounds(TS.DBL_THEN_ADD + TS.ADD_AFTER_DBL) == 22 + 31.5
    if label == "g2_precompute":
        kinds = np.asarray(args[1])
        assert kinds.tolist() == P._PRE_KINDS.tolist() + [3, 4]
        assert (int((kinds == 0).sum()), len(kinds)) == (64, 87)
        assert products == int(10 * (64 * 22 + 23 * 31.5 + 4 * 2.5)) == 10 * 2142.5
        assert nbytes == 10 * (4 + 87 * 6) * 64 + 4 * 87
        assert min(case.batches) < 8 and 16384 in case.batches
    else:
        dbl = label == "g2_dbl_step"
        assert products == int(10 * (22 if dbl else 31.5))
        assert nbytes == 10 * (18 if dbl else 22) * 64


def test_precompute_is_one_kernel_call_of_views():
    """pairing_torch.precompute hands the 87 steps to one g2_precompute call and
    returns the (ell_0, ell_vw, ell_vv) tree as views of its one output
    (no copy of the lines); g2_precompute refuses a kind it has no base
    for."""
    q = _real_points(SEED + 3, 2)
    tree = P.precompute(((q[0], q[1]), (q[2], q[3])))
    leaves = convert.tree_leaves(tree)
    assert len({x.untyped_storage().data_ptr() for x in leaves}) == 1
    lines = FU.g2_precompute_plain(q, P._LINE_KINDS)
    assert all(torch.equal(x, lines[:, i]) for i, x in enumerate(leaves))
    with pytest.raises(ValueError):
        FU.g2_precompute(q, [0, 5])
