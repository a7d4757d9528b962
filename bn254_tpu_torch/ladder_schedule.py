"""The GLV ladder's team schedule (csrc/groups.cu k_glv_ladder).

Four threads of one warp share a batch lane (eight lanes a warp).  The
lane's state lives in shared memory as slots of the coordinate field (Fq
for G1, Fq2 for G2; ``SLOT``): res (RX, RY, RZ), the three table points
p1, p2, p12 with their z^2 and z^3 (computed once, before the first step:
they are the same field values at every step), and ten temporaries.  A
ladder step is the dbl-2009-l double, then the unified add of the table
point the lane's digit picks; the kernel runs it as rounds of
``team_schedule``'s engine (fq12_team.cuh ``team_round``): in a round each
thread computes at most one product (tasks k, k + 4, ... of ``muls``),
then, after a ``__syncwarp``, at most one signed sum (``lins``).  The
table point is virtual (QX .. QZ3): the kernel points it at p1, p2 or p12
lane by lane.

A step is six rounds, at most four products each:

* D1-D3, the double (3 products, then 4, then 4): x^2, y^2, y z; b^2,
  (x + b)^2, (3a)^2 and the new z^2 for the add; e (d - x3) with three
  of the add's products, u2 = qx z1^2, u1 = x3 qz^2 (x3 as a sum) and
  qy z1.
* A1-A3, the rest of the add (4, 4, 2): s1, s2 = (qy z1) z1^2, z1 qz,
  i = (2h)^2; rr^2, (z1 qz) h, j = h i, v = u1 i; rr (v - x3), s1 j.
  z3 = 2 (z1 qz) h is the one-thread formula's ((z1 + qz)^2 - z1^2 -
  qz^2) h: the same field value.

21 products a step where the one-thread ladder takes 23 (the table's
z^2 and z^3 are not recomputed), and a serial depth of six products.
The add's branches stay at lane level, in the one-thread add's order
(groups.cuh point_add_inl): the kernel reads p's and q's z after D3
(digit 0 picks (0, 1, 0): q at infinity) and runs A1-A3 only where
neither is at infinity; after A1, h = 0 and rr = 0 (rr = 2 (s2 - s1))
mean coincide, and those lanes run D1-D3 again on p instead of A2-A3;
where p is at infinity the kernel copies q into res.  Every slot is a
fully reduced residue, so res is the one-thread ladder's limb for limb.

``check_round`` (team_schedule) proves each round race-free for a team
of four; ``header`` emits the tables into the generated constants
header, so the kernel and the CPU model in the tests read one schedule.
"""

from __future__ import annotations

from . import team_schedule as TS
from .team_schedule import A, Comb, Lin, Mul, Round

TEAM = 4
POINT = ("X", "Y", "Z", "Z2", "Z3")         # a table point's slots, in this order
TABLE = ("T1", "T2", "T3")                  # p1, p2, p12: digit d reads TABLE[d - 1]
SLOT = {name: i for i, name in enumerate(
    ["RX", "RY", "RZ"]
    + [t + c for t in TABLE for c in POINT]
    + [f"S{i}" for i in range(10)])}
N_SLOTS = len(SLOT)
# the table point the lane's digit picks: slot vb + j, vb = SLOT[T1X] + 5 (d - 1)
VIRTUAL = {"Q" + c: TS.VIRT + j for j, c in enumerate(POINT)}
NAMES = {**SLOT, **VIRTUAL}

INIT_Z2 = Round(tuple(Mul(t + "Z2", A(t + "Z"), A(t + "Z")) for t in TABLE), ())
INIT_Z3 = Round(tuple(Mul(t + "Z3", A(t + "Z"), A(t + "Z2")) for t in TABLE), ())

# the double: a = x^2 (S0), b = y^2 (S1), yz (S2); z3 = 2 yz
D1 = Round((Mul("S0", A("RX"), A("RX")), Mul("S1", A("RY"), A("RY")),
            Mul("S2", A("RY"), A("RZ"))),
           (Comb("RZ", A("S2", "S2")),))
# c = b^2 (S2), (x + b)^2 (S3), f = e^2 = (3a)^2 (S4), the add's z1^2 (S5);
# d = 2 ((x + b)^2 - a - c) (S1)
D2 = Round((Mul("S2", A("S1"), A("S1")), Mul("S3", A("RX", "S1"), A("RX", "S1")),
            Mul("S4", A("S0", "S0", "S0"), A("S0", "S0", "S0")),
            Mul("S5", A("RZ"), A("RZ"))),
           (Comb("S1", Lin(a=("S3", "-S0", "-S2"), post=TS.DOUBLE)),))
# e (d - x3) = 3a (3d - f) (S3); qy z1 (S6), u2 = qx z1^2 (S7), u1 = x3 qz^2
# (S8); x3 = f - 2d, y3 = e (d - x3) - 8c, h = u2 - u1 (S0)
D3 = Round((Mul("S3", A("S0", "S0", "S0"), A("S1", "S1", "S1", "-S4")),
            Mul("S6", A("QY"), A("RZ")), Mul("S7", A("QX"), A("S5")),
            Mul("S8", A("S4", "-S1", "-S1"), A("QZ2"))),
           (Comb("RX", A("S4", "-S1", "-S1")),
            Comb("RY", A("S3", *["-S2"] * 8)),
            Comb("S0", A("S7", "-S8"))))
# s1 = y1 qz^3 (S1), s2 = (qy z1) z1^2 (S2), z1 qz (S3), i = (2h)^2 (S4);
# rr = 2 (s2 - s1) (S5)
A1 = Round((Mul("S1", A("RY"), A("QZ3")), Mul("S2", A("S6"), A("S5")),
            Mul("S3", A("RZ"), A("QZ")), Mul("S4", A("S0", "S0"), A("S0", "S0"))),
           (Comb("S5", Lin(a=("S2", "-S1"), post=TS.DOUBLE)),))
# rr^2 (S2), (z1 qz) h (S6), j = h i (S7), v = u1 i (S9); x3 = rr^2 - j - 2v
A2 = Round((Mul("S2", A("S5"), A("S5")), Mul("S6", A("S3"), A("S0")),
            Mul("S7", A("S0"), A("S4")), Mul("S9", A("S8"), A("S4"))),
           (Comb("RX", A("S2", "-S7", "-S9", "-S9")),))
# rr (v - x3) (S0), s1 j (S2); y3 = rr (v - x3) - 2 s1 j, z3 = 2 (z1 qz) h
A3 = Round((Mul("S0", A("S5"), A("S9", "-RX")), Mul("S2", A("S1"), A("S7"))),
           (Comb("RY", A("S0", "-S2", "-S2")), Comb("RZ", A("S6", "S6"))))

ROUNDS = (INIT_Z2, INIT_Z3, D1, D2, D3, A1, A2, A3)
R_D1, R_A1 = 2, 5                   # the kernel runs rounds 0-1 once, then per step D1-D3, A1-A3
COINCIDE = ("S0", "S5")             # h and rr after A1: both zero on a coincide lane


def check_round(rnd: Round):
    """team_schedule.check_round for a team of four over these slots; and
    no xi term: the G1 slots are Fq."""
    TS.check_round(rnd, TEAM, NAMES)
    if any(lin.b for m in rnd.muls for lin in (m.x, m.y)) or any(c.lin.b for c in rnd.lins):
        raise ValueError("the ladder's slots may be Fq: no xi terms")


def _initializer() -> str:
    for rnd in ROUNDS:
        check_round(rnd)
    return TS.rounds_initializer(ROUNDS, TEAM, NAMES, N_SLOTS)


def header() -> str:
    """The rounds as C initializers of fq12_team.cuh's TeamRound, and the
    slots the kernel names, under BN254_LADDER_*."""
    return "\n".join([
        f"#define BN254_LADDER_SLOTS {N_SLOTS}",
        *(f"#define BN254_LADDER_SLOT_{name} {SLOT[name]}"
          for name in ("RX", "T1X", *COINCIDE)),
        f"#define BN254_LADDER_NROUNDS {len(ROUNDS)}",
        f"#define BN254_LADDER_R_D1 {R_D1}",
        f"#define BN254_LADDER_R_A1 {R_A1}",
        f"#define BN254_LADDER_ROUNDS {_initializer()}",
        "",
    ])
