"""The G2 line steps' team schedule (csrc/fused.cu k_g2_precompute).

``pairing_torch.precompute`` (mod.rs:701-728) walks R from Q through the 85
scheduled steps (64 doublings, 21 additions of Q or -Q) and the 2
Frobenius additions (pi(Q), then -pi^2(Q)), and keeps each step's raw line
(ell_0, ell_vw, ell_vv): 87 lines.  Four threads of one warp share a
batch lane (eight lanes a warp) and run the Miller kernel's doubling and
addition products (team_schedule ``DBL_R*``, ``ADD_A*``) on
fq12_team.cuh's ``team_round``, without what the lines do not need: no f,
no square, no fold, no scaling by px or py.  Each step leaves its raw line
in three slots of its own (``LINE``): a doubling xi(e - b), -h and 3j, an
addition xi(e bx - d by), d and -e.

A step's products come in levels (a doubling step: y^2, z^2, (y + z)^2,
xy | e, z' = b h | e^2, g^2, x'), at most five a level, so a team of six
would leave most of its threads idle in every pass, and a pass costs the
warp the same however few threads have a product.  So the team is four
and the doubling step's products are regrouped into three rounds of at
most four (x^2 moves to the second); an addition after a doubling step
still starts in that step's last round (``step_rounds``: z bx, z by, then
d and e), which takes five, two passes.  That is 284 product passes a
lane for precompute's 87 steps.  Every product stays a lazy Fq2 product
and every slot fully reduced, so the lines are the plain steps'
(fused._dbl_step, _add_step) limb for limb.

The base of an addition is virtual in x and y (``BX``, ``BY``): the
kernel points them at one of four pairs of slots, kind k's base at
``Q1X`` + 2 (k - 1): +Q, -Q, pi(Q) and -pi^2(Q); the first Frobenius
addition, after the last doubling step, reads pi(Q)'s x in that step's
last round.  Values that live a round or two share slots, 25 in all
(2,000 bytes a lane).

``header`` emits the rounds, checked race-free for a team of four
(team_schedule.check_round), into the generated constants header, so the
kernel and the CPU model in the tests read one schedule.
"""

from __future__ import annotations

from . import team_schedule as TS
from .team_schedule import A, Comb, Lin, Mul, Round

TEAM = 4                                    # threads a lane (eight lanes a warp)
BASES = 4                                   # kinds 1-4: +Q, -Q, pi(Q), -pi^2(Q)
LINE = ("E0", "EW", "EV")                   # ell_0, ell_vw, ell_vv: Fq 2j, 2j + 1 of a line
SLOT = {name: i for i, name in enumerate(
    ["RX", "RY", "RZ"]
    + [f"Q{k}{c}" for k in range(1, BASES + 1) for c in "XY"]
    + ["B2", *LINE]
    + [f"P{i}" for i in range(12, 18)]
    + [f"T{i}" for i in range(4)])}
N_SLOTS = len(SLOT)
# the base of an addition: slots vb and vb + 1, vb = Q1X + 2 (kind - 1)
VIRTUAL = {"BX": TS.VIRT, "BY": TS.VIRT + 1}
NAMES = {**SLOT, **VIRTUAL}


def base_slot(kind: int) -> int:
    """vb of an addition of kind 1-4: its base's x."""
    return TS.base_slot(kind, SLOT)


def _renamed(rnd: Round, names: dict) -> Round:
    """The round with its slot names mapped through `names`."""
    term = lambda t: ("-" if t[0] == "-" else "") + names.get(t.lstrip("-"), t.lstrip("-"))
    lin = lambda l: Lin(tuple(map(term, l.b)), tuple(map(term, l.a)), l.post)
    return Round(tuple(Mul(names.get(m.dst, m.dst), lin(m.x), lin(m.y)) for m in rnd.muls),
                 tuple(Comb(names.get(c.dst, c.dst), lin(c.lin)) for c in rnd.lins))


# Doubling step (mod.rs:754-776, fused._dbl_step), the Miller schedule's
# products regrouped for a team of four, three rounds of at most four:
# xy, b = y^2, c = z^2, (y + z)^2 | d = 3c, h, ell_vw = -h, a = xy / 2 (in
# xy's slot) || e = b2 d, z' = b h, j = x^2 | g = (b + 3e) / 2, b - 3e,
# ell_0 = xi (e - b), ell_vv = 3j || e^2, g^2, x' = a (b - 3e) | y' = g^2 -
# 3 e^2.  Followed by an addition, the last round also takes its first
# products z bx, z by, and its d and e (e from y' directly).
DBL_R1 = Round((Mul("P12", A("RX"), A("RY")), Mul("P13", A("RY"), A("RY")),
                Mul("P14", A("RZ"), A("RZ")), Mul("P15", A("RY", "RZ"), A("RY", "RZ"))),
               (Comb("T0", A("P14", "P14", "P14")),
                Comb("T1", A("P15", "-P13", "-P14")),
                Comb("EW", A("P13", "P14", "-P15")),
                Comb("P12", Lin(a=("P12",), post=TS.HALF))))
DBL_R2 = Round((Mul("P15", A("B2"), A("T0")), Mul("RZ", A("P13"), A("T1")),
                Mul("T2", A("RX"), A("RX"))),
               (Comb("P16", Lin(a=("P13", "P15", "P15", "P15"), post=TS.HALF)),
                Comb("P17", A("P13", "-P15", "-P15", "-P15")),
                Comb("E0", Lin(b=("P15", "-P13"))),
                Comb("EV", A("T2", "T2", "T2"))))
DBL_R3 = Round((Mul("P13", A("P15"), A("P15")), Mul("P14", A("P16"), A("P16")),
                Mul("RX", A("P12"), A("P17"))),
               (Comb("RY", A("P14", "-P13", "-P13", "-P13")),))
DBL_R3A = Round(DBL_R3.muls + (Mul("T2", A("RZ"), A("BX")), Mul("T3", A("RZ"), A("BY"))),
                DBL_R3.lins + (Comb("T0", A("RX", "-T2")),
                               Comb("T1", A("P14", "-P13", "-P13", "-P13", "-T3"))))

# Mixed addition step (team_schedule ADD_A*), its short-lived products in
# slots that are free there (the doubling step's P12, T2, T3 and g's P16),
# its base virtual, without the px, py scalings; its line's ell_vw = d
# and ell_vv = -e as combinations of their own.
_B = {"P0": "T2", "P1": "T3", "P2": "P12", "P3": "P16"}
ADD_A1 = _renamed(Round(TS.ADD_A1_MULS, TS.ADD_A1_LINS), _B)
ADD_A2 = _renamed(Round(tuple(m for m in TS.ADD_A2_MULS if m.dst not in ("L2", "L4")),
                        TS.ADD_A2_LINS + (Comb("EW", A("T0")), Comb("EV", A("-T1")))),
                  {**_B, "L0": "E0"})
ADD_A3 = Round(TS.ADD_A3_MULS, TS.ADD_A3_LINS)
ADD_A4 = _renamed(Round(TS.ADD_A4_MULS, TS.ADD_A4_LINS), {"P0": "P12", "P1": "P13"})

# Indexed as the Miller kernel's rounds, so team_schedule.step_rounds picks
# a step's rounds here too (DBL, DBL_THEN_ADD, ADD, ADD_AFTER_DBL).
ROUNDS = (DBL_R1, DBL_R2, DBL_R3, DBL_R3A, ADD_A1, ADD_A2, ADD_A3, ADD_A4)
step_rounds = TS.step_rounds


def header() -> str:
    """The rounds as C initializers of fq12_team.cuh's TeamRound for a
    team of TEAM, and the slots the kernel names, under BN254_PRE_*."""
    for rnd in ROUNDS:
        TS.check_round(rnd, TEAM, NAMES)
    return "\n".join([
        f"#define BN254_PRE_TEAM {TEAM}",
        f"#define BN254_PRE_SLOTS {N_SLOTS}",
        *(f"#define BN254_PRE_SLOT_{name} {SLOT[name]}" for name in ("RX", "Q1X", "B2", "E0")),
        f"#define BN254_PRE_NROUNDS {len(ROUNDS)}",
        f"#define BN254_PRE_ROUNDS {TS.rounds_initializer(ROUNDS, TEAM, NAMES, N_SLOTS)}",
        "",
    ])
