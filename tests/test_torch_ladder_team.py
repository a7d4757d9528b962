"""The GLV ladder's team schedule (bn254_tpu_torch/ladder_schedule.py,
csrc/groups.cu k_glv_ladder) on the CPU: every round race-free for a team
of four, and a model of the kernel's control flow over the same tables,
bit-equal to the ladder's plain version (fused.glv_ladder_plain, the JAX
package's scan spelling) for G1 and G2 on kernel_cases.glv_args' edge
lanes.  The model runs a round as the four threads do after check_round:
every task of a half reads the slots as they were before the half, then
all write, and only on the lanes the kernel runs the round for."""

import numpy as np
import pytest
import torch

from bn254_tpu_torch import fused as FU
from bn254_tpu_torch import kernel_cases as KC
from bn254_tpu_torch import ladder_schedule as LS
from bn254_tpu_torch import limbs as L
from bn254_tpu_torch import mont_kernels as MK
from bn254_tpu_torch import team_schedule as TS

torch.set_num_threads(1)

SEED = 0x1ADD
ENDS = 16           # the model runs the first and the last ENDS of the 128 steps


@pytest.mark.parametrize("index", range(len(LS.ROUNDS)))
def test_ladder_round_is_race_free(index):
    """Every round passes check_round for a team of four (one pass of
    products, one of sums: at most four each), names only the lane's slots
    and the table point's virtual ones, and the header holds the table."""
    rnd = LS.ROUNDS[index]
    LS.check_round(rnd)
    assert 0 < len(rnd.muls) <= LS.TEAM and len(rnd.lins) <= LS.TEAM
    used = set().union(*(TS.reads(m.x) | TS.reads(m.y) | {m.dst} for m in rnd.muls),
                       *(TS.reads(c.lin) | {c.dst} for c in rnd.lins))
    assert used <= set(LS.NAMES)
    assert not {m.dst for m in rnd.muls} & set(LS.VIRTUAL)
    assert LS.header().count("#define BN254_LADDER_ROUNDS") == 1


def test_ladder_schedule_counts_and_refusals():
    """A step is six rounds and 21 products (the one-thread ladder's 23 less
    the table's z^2 and z^3); check_round refuses more products than four
    passes of four, an xi term (G1's slots are Fq) and a race; the header
    refuses real slots that reach the virtual ones, and slots past 6 bits."""
    step = LS.ROUNDS[LS.R_D1:]
    assert len(step) == KC.LADDER_DEPTH == 6
    assert [len(r.muls) for r in step] == [3, 4, 4, 4, 4, 2]
    mul = lambda dst: TS.Mul(dst, TS.A("RX"), TS.A("RY"))
    for bad in (TS.Round(tuple(mul(f"S{i % 10}") for i in range(17)), ()),
                TS.Round((TS.Mul("S0", TS.Lin(b=("RX",)), TS.A("RY")),), ()),
                TS.Round((mul("S0"), TS.Mul("S1", TS.A("S0"), TS.A("RY"))), ())):
        with pytest.raises(ValueError):
            LS.check_round(bad)
    assert LS.N_SLOTS <= TS.VIRT and max(LS.NAMES.values()) < 1 << TS.TERM_BITS
    with pytest.raises(ValueError):
        TS.rounds_initializer(LS.ROUNDS, LS.TEAM, LS.NAMES, TS.VIRT + 1)
    with pytest.raises(ValueError):
        TS.rounds_initializer(LS.ROUNDS, LS.TEAM, {**LS.NAMES, "S9": 1 << TS.TERM_BITS},
                              LS.N_SLOTS)


@pytest.mark.parametrize("nc", [1, 2])
def test_ladder_bound_counts_what_the_function_needs(nc):
    """kernel_cases.glv_work charges a double a step, on each nonzero digit
    the add with the table point's z^2 and z^3 known, and those two
    products once a lane for each table point its digits pick: no more
    than the team's rounds run for the same events (a product of one sum
    by itself weighed as a square), and the table's z^2 and z^3 as the
    kernel's first two rounds."""
    mul, sqr = KC._MUL[nc], KC._SQR[nc]
    w = lambda rounds: sum(sqr if m.x == m.y else mul for r in rounds for m in r.muls)
    assert w(LS.ROUNDS[:LS.R_D1]) == pytest.approx(3 * (mul + sqr))
    dbl, add = 2 * mul + 5 * sqr, 10 * mul + 4 * sqr
    assert dbl + add <= w(LS.ROUNDS[LS.R_D1:])
    # lanes pick {3}, {1}, {1, 2}, {3}: 5 table points, 7 nonzero digits
    digits = torch.tensor([[0, 1, 2, 3], [3, 0, 2, 0], [0, 0, 1, 3]], dtype=torch.int32)
    products, _ = KC.glv_work(nc, None, digits)
    assert abs(products - (12 * dbl + 7 * add + 5 * (mul + sqr))) < 1


# ---------------------------------------------------------------------------
# The model: the kernel's step over the schedule's slots
# ---------------------------------------------------------------------------

class _Field:
    """G1's slots are Fq [16, B], G2's Fq2 [2, 16, B]; products as the
    kernel's (fq_mul; the lazy Fq2 product)."""

    def __init__(self, ncoords):
        self.ncoords = ncoords

    def mul(self, x, y):
        return L.mont_mul(x, y, MK.FQ_MOD) if self.ncoords == 1 else FU._fq2_mul_lazy(x, y)

    def lanes(self, m):
        return m.view(*([1] * self.ncoords), -1)

    def is_zero(self, a):
        return (a == 0).flatten(0, -2).all(0)


def _lin(state, lin, vb):
    """team_lin over slot indices as the header lists them (positive, then
    negative terms; no xi over the ladder's slots); a virtual slot VIRT + j
    reads slot vb + j of its lane."""
    _, _, pos, neg = TS._split(lin, LS.NAMES)
    read = lambda i: state[i] if i < TS.VIRT else _virtual(state, vb, i - TS.VIRT)
    acc = torch.zeros_like(state[0])
    for i in pos:
        acc = FU._add(acc, read(i))
    for i in neg:
        acc = FU._sub(acc, read(i))
    return FU._add(acc, acc) if lin.post == TS.DOUBLE else acc


def _virtual(state, vb, j):
    t1 = LS.SLOT["T1X"]
    out = state[t1 + j]
    for base in (t1 + 5, t1 + 10):
        out = torch.where(FLD.lanes(vb == base), state[base + j], out)
    return out


def _round(state, rnd, vb, active):
    """One round on the slot list, in place, on the active lanes only."""
    m = FLD.lanes(active)
    if rnd.muls:
        x = [_lin(state, t.x, vb) for t in rnd.muls]
        y = [_lin(state, t.y, vb) for t in rnd.muls]
        for t, a, b in zip(rnd.muls, x, y):
            state[LS.SLOT[t.dst]] = torch.where(m, FLD.mul(a, b), state[LS.SLOT[t.dst]])
    new = [(c.dst, _lin(state, c.lin, vb)) for c in rnd.lins]
    for dst, v in new:
        state[LS.SLOT[dst]] = torch.where(m, v, state[LS.SLOT[dst]])


FLD = _Field(1)


def team_ladder(ncoords, pts, digits, branches):
    """k_glv_ladder on the CPU: the table and res = (0, 1, 0) into slots,
    the table's z^2 and z^3, then per step D1-D3 on every lane, A1 where
    neither p nor q is at infinity, A2-A3 where the add does not coincide,
    D1-D3 again on the coincide lanes, res = q where p is at infinity.
    Counts the lanes that take each branch into `branches`."""
    global FLD
    FLD = _Field(ncoords)
    batch = pts.shape[-1]
    shape = (2, 16, batch) if ncoords == 2 else (16, batch)
    one = FU._const(1, torch.zeros(16, batch, dtype=torch.int32))
    one = torch.stack([one, torch.zeros_like(one)]) if ncoords == 2 else one
    zero = torch.zeros(shape, dtype=torch.int32)
    state = [zero] * LS.N_SLOTS
    state[:3] = [zero, one, zero]
    table = pts.view(3, 3, *shape)
    for t, name in enumerate(LS.TABLE):
        for c in range(3):
            state[LS.SLOT[name + LS.POINT[c]]] = table[t, c]
    every = torch.ones(batch, dtype=torch.bool)
    for rnd in LS.ROUNDS[:LS.R_D1]:
        _round(state, rnd, torch.zeros(batch, dtype=torch.int64), every)
    dbl, add_rounds = LS.ROUNDS[LS.R_D1:LS.R_A1], LS.ROUNDS[LS.R_A1:]
    for d in digits:
        d = d.to(torch.int64)
        vb = LS.SLOT["T1X"] + 5 * torch.clamp(d - 1, min=0)
        for rnd in dbl:
            _round(state, rnd, vb, every)
        p_inf = FLD.is_zero(state[2])
        add = ~p_inf & (d != 0) & ~FLD.is_zero(_virtual(state, vb, 2))
        _round(state, add_rounds[0], vb, add)
        coincide = add & FLD.is_zero(state[LS.SLOT["S0"]]) & FLD.is_zero(state[LS.SLOT["S5"]])
        for rnd in add_rounds[1:]:
            _round(state, rnd, vb, add & ~coincide)
        if bool(coincide.any()):
            for rnd in dbl:
                _round(state, rnd, vb, coincide)
        q = [torch.where(FLD.lanes(d != 0), _virtual(state, vb, c), (zero, one, zero)[c])
             for c in range(3)]
        for c in range(3):
            state[c] = torch.where(FLD.lanes(p_inf), q[c], state[c])
        for name, m in (("add", add), ("coincide", coincide), ("p_inf", p_inf),
                        ("p_inf, digit 0", p_inf & (d == 0)),
                        ("digit 0", (d == 0) & ~p_inf)):
            branches[name] = branches.get(name, 0) + int(m.sum())
    return torch.stack(state[:3]).reshape(3 * ncoords, 16, batch)


@pytest.mark.parametrize("group", ["g1", "g2"])
def test_team_ladder_model_equals_plain_version(group):
    """The model over ladder_schedule's tables equals glv_ladder_plain limb
    for limb on glv_args' lanes at B = 16: tables at infinity on lanes 0
    and 2 (p at infinity, q too), lane 6's add meeting its own point
    (coincide) and lane 7's P + (-P), the scalars 0, 1, r - 1, lambda and
    r - lambda on lanes 8-12, whose leading zero digits add (0, 1, 0) to
    res at infinity; every branch is taken.  The ladder runs the first and
    the last ENDS digits of each lane (the coincide steps and the edge
    scalars' leading zeros, and their last digits), 32 steps of 128."""
    nc = 1 if group == "g1" else 2
    _, pts, digits = KC.glv_args(np.random.default_rng(SEED), nc, 16, "cpu")
    digits = torch.cat([digits[:ENDS], digits[-ENDS:]])
    branches = {}
    got = team_ladder(nc, pts, digits, branches)
    assert torch.equal(got, FU.glv_ladder_plain(nc, pts, digits))
    assert all(branches.get(k, 0) > 0 for k in ("add", "coincide", "p_inf", "p_inf, digit 0",
                                                   "digit 0")), branches
