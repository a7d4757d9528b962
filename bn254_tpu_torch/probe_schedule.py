"""The tower probe's team rounds (csrc/probes.cu k_chain_team).

The probe chains its fq6_mul and fq12_sqr ops on a team of six threads a
lane over Fq2 slots in shared memory (``SLOT``): the running value in
F0-F5 (an Fq12's six coefficients; an Fq6's three in F0-F2, with the
constant operand's three in F3-F5) and the products P0-P11.

``FQ6_MUL`` is Devegili's Fq6 product (fq6.rs:194-208, fused._mul6) as
one round: its six lazy Fq2 products, one a thread (x_k y_k for k < 3,
then (x1 + x2)(y1 + y2), (x0 + x1)(y0 + y1), (x0 + x2)(y0 + y2)), then
c0 = xi(P3 - P1 - P2) + P0, c1 = xi(P2) + P4 - P0 - P1 and c2 = P5 - P0 +
P1 - P2 on threads 0-2.  ``SQR`` is the Fq12 square round that the
prepared Miller loop runs (loop_schedule.SQR, rows 8l and 13), here over
this slot map.  Every value is fully reduced, so the chains equal the
plain ops limb for limb.

``header`` emits both rounds, checked race-free for a team of six
(team_schedule.check_round), into the generated constants header, so the
kernel and the CPU model in the tests read one schedule.
"""

from __future__ import annotations

from . import loop_schedule as LS
from . import team_schedule as TS
from .team_schedule import A, Comb, Lin, Mul, Round

SLOT = {name: i for i, name in enumerate([f"F{i}" for i in range(6)]
                                         + [f"P{i}" for i in range(12)])}
N_SLOTS = len(SLOT)

_X, _Y = [A(f"F{i}") for i in range(3)], [A(f"F{3 + i}") for i in range(3)]
FQ6_MUL = Round(
    tuple(Mul(f"P{k}", x, y) for k, (x, y) in enumerate(zip(TS._s(_X), TS._s(_Y)))),
    (Comb("F0", Lin(b=("P3", "-P1", "-P2"), a=("P0",))),
     Comb("F1", Lin(b=("P2",), a=("P4", "-P0", "-P1"))),
     Comb("F2", A("P5", "-P0", "P1", "-P2"))))
SQR = LS.SQR
ROUNDS = (FQ6_MUL, SQR)
R_FQ6_MUL, R_SQR = 0, 1


def header() -> str:
    """The rounds as C initializers of fq12_team.cuh's TeamRound and the
    slot count and round indices the kernel names, under BN254_PROBE_*."""
    return "\n".join([
        f"#define BN254_PROBE_SLOTS {N_SLOTS}",
        f"#define BN254_PROBE_NROUNDS {len(ROUNDS)}",
        f"#define BN254_PROBE_R_FQ6_MUL {R_FQ6_MUL}",
        f"#define BN254_PROBE_R_SQR {R_SQR}",
        f"#define BN254_PROBE_ROUNDS {TS.rounds_initializer(ROUNDS, TS.TEAM, SLOT, N_SLOTS)}",
        "",
    ])
