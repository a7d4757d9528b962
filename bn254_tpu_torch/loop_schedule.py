"""The prepared Miller loop's team schedule (csrc/fused.cu k_miller_loop).

``pairing_torch.miller_loop`` (mod.rs:580-606) starts at f = 1 and, for each of
the 87 line-coefficient triples ``pairing_torch.precompute`` made, squares f
where the step's flag is set (64 steps), then folds the line into f with
ell_vv scaled by px and ell_vw by py (fused._fold, 87 steps).  Six threads
of one warp share a batch lane and run the Miller kernel's square round
(team_schedule ``SQR_MULS`` / ``SQR_LINS``: 12 lazy Fq2 products, then
f's six coefficients) and its 024 fold round (``FOLD_MULS`` /
``FOLD_LINS``: 13 products) on fq12_team.cuh's ``team_round``, over a
slot map of their own (``SLOT``): f (F0-F5), (px, 0) and (py, 0), two sets
of line slots (L0 L2 L4 and M0 M2 M4) and the products P0-P12, 27 Fq2
slots (2,160 bytes a lane, where the Miller kernel's 41 take 3,280).

A step's line arrives raw: ell_0 in its set's L0, ell_vv in L2 and ell_vw
in L4 (M0, M2, M4 for the other set).  The scalings by (px, 0) and (py,
0) are Fq2 products that read and write their own slot (a task may read
the slot it writes: it reads first), so the set holds the fold's (x0, x2,
x4) after them.  The lines alternate between the two sets (step i takes L
for even i, M for odd), so that the next step's scalings ride in the fold
round's five spare tasks (13 products of a round's 18): a fold is three
product passes, a square two, and the first step's scalings a round of
their own (``SCALE``): 87 x 3 + 64 x 2 + 1 = 390 passes a lane, where
a scaling round a step takes 476 (it measured 15 % slower on the card).  The
one-op kernels of rows 8 and 13 are launches of the same kernel: one
step with a line and no square (``SCALE``, then the fold), and one step
with a square and no line.

``header`` emits the rounds, checked race-free for a team of six
(team_schedule.check_round), into the generated constants header, so the
kernel and the CPU model in the tests read one schedule.
"""

from __future__ import annotations

from . import team_schedule as TS
from .team_schedule import A, Comb, Lin, Mul, Round

SETS = ("L", "M")                           # step i's line slots: SETS[i % 2]
SLOT = {name: i for i, name in enumerate(
    [f"F{i}" for i in range(6)] + ["PX", "PY"]
    + [s + c for s in SETS for c in "024"]
    + [f"P{i}" for i in range(13)])}
N_SLOTS = len(SLOT)
# Where the raw line's coordinates go (ell_0, ell_vw, ell_vv: Fq 0-5 of a
# step's [6, 16, B]): the slot after its set's first, x0 = ell_0, x2 =
# ell_vv, x4 = ell_vw.
LINE_SLOT = (0, 0, 2, 2, 1, 1)


def _on(rnd: Round, s: str) -> Round:
    """The round with the line slots L0 L2 L4 renamed to set s's."""
    name = lambda t: s + t[1:] if t[0] == "L" else t
    term = lambda t: ("-" if t[0] == "-" else "") + name(t.lstrip("-"))
    lin = lambda l: Lin(tuple(map(term, l.b)), tuple(map(term, l.a)), l.post)
    return Round(tuple(Mul(name(m.dst), lin(m.x), lin(m.y)) for m in rnd.muls),
                 tuple(Comb(name(c.dst), lin(c.lin)) for c in rnd.lins))


def _scalings(s: str) -> tuple:
    """x2 = ell_vv (px, 0) and x4 = ell_vw (py, 0), in place in set s."""
    return (Mul(s + "2", A(s + "2"), A("PX")), Mul(s + "4", A(s + "4"), A("PY")))


SQR = Round(TS.SQR_MULS, TS.SQR_LINS)
_FOLD = {s: _on(Round(TS.FOLD_MULS, TS.FOLD_LINS), s) for s in SETS}
ROUNDS = (SQR,
          Round(_scalings(SETS[0]), ()),                                        # SCALE
          *(_FOLD[s] for s in SETS),                                            # FOLD
          *(Round(_FOLD[s].muls + _scalings(o), _FOLD[s].lins)                  # FOLD_SCALE
            for s, o in zip(SETS, SETS[::-1])))
R_SQR, R_SCALE, R_FOLD, R_FOLD_SCALE = 0, 1, 2, 4     # the last two: + the set's index


def step_rounds(n: int, i: int, square: bool) -> tuple:
    """The rounds k_miller_loop runs for step i of n: the square where the
    step squares, then the fold of the step's set, which also scales the
    next step's line in the other set."""
    s = i % 2
    return (R_SQR,) * square + ((R_FOLD_SCALE if i + 1 < n else R_FOLD) + s,)


def header() -> str:
    """The rounds as C initializers of fq12_team.cuh's TeamRound, and the
    slots and rounds the kernel names, under BN254_LOOP_* (LINE_SLOT two
    bits a coordinate, first lowest)."""
    for rnd in ROUNDS:
        TS.check_round(rnd, TS.TEAM, SLOT)
    return "\n".join([
        f"#define BN254_LOOP_SLOTS {N_SLOTS}",
        *(f"#define BN254_LOOP_SLOT_{name} {SLOT[name]}" for name in ("F0", "PX", "L0", "M0")),
        f"#define BN254_LOOP_LINE_SLOTS 0x{sum(o << 2 * k for k, o in enumerate(LINE_SLOT)):03x}",
        f"#define BN254_LOOP_NROUNDS {len(ROUNDS)}",
        *(f"#define BN254_LOOP_{k} {v}" for k, v in (
            ("R_SQR", R_SQR), ("R_SCALE", R_SCALE), ("R_FOLD", R_FOLD),
            ("R_FOLD_SCALE", R_FOLD_SCALE))),
        f"#define BN254_LOOP_ROUNDS {TS.rounds_initializer(ROUNDS, TS.TEAM, SLOT, N_SLOTS)}",
        "",
    ])
