"""The Miller kernel's team schedule (csrc/fused.cu k_miller_precompute).

Six threads of one warp share a batch lane.  The lane's state lives in
shared memory as Fq2 slots (``SLOT``): f, the point R, the four addition
bases (Q, -Q, pi(Q), -pi^2(Q): a round of their own makes the last two),
(px, 0) and (py, 0), the twist coefficient b2, the line, a product
scratch and a few temporaries.  A Miller step is a short list of rounds;
in a round each thread first computes up to three Fq2 products (tasks k,
k + 6, k + 12 of the round's ``muls``), then, after a ``__syncwarp``, up to
two linear combinations (``lins``), then syncs again.  Every task is data,
not code: an operand is ``xi * (sum of b) + (sum of a)`` over signed slots
(``Lin``), so the six threads run the same instructions and a warp never
runs six formulas one after another.

A doubling step (kind 0) is three rounds: f's square with the doubling
step's first products; the products that need b2 * 3z^2 and the line's px,
py scalings; then the 024 fold of the line into f with the last products
of the step.  A mixed addition (kinds 1-4: +Q, -Q, pi(Q), -pi^2(Q)) is
four rounds, the fold in the third, its base virtual in x and y (``BX``,
``BY``: the kernel points them at kind k's pair of slots, ``base_slot``);
after a doubling step it is three, its first round's work done in the
doubling step's last (``step_rounds``), so that an
addition takes the five product passes its 28 products need and a
doubling step the seven its 37 need.  Products of 1/2 are halvings
(``post = HALF``), exact in the field, so r and f are the one-thread
square's (bn254.cuh ``fq12_sqr``), the plain steps' (fused._dbl_step,
_add_step) and the plain fold's (fused._fold) limb for limb: the same
field values, every slot fully reduced.  The prepared Miller loop runs the
square and fold rounds over a slot map of its own (loop_schedule.py), the
prepared-G2 lines the doubling and addition products
(precompute_schedule.py).

``check_round`` proves a round race-free (no slot written by one task and
read or written by another); ``header`` emits the tables as C initializers
for the generated constants header (each sum split into its positive and
its negative slots: the kernel adds the first, then subtracts the second;
16 bytes a task), so the kernel and the CPU model in the tests read the
same schedule.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np

BASES = 4                                       # kinds 1-4: +Q, -Q, pi(Q), -pi^2(Q)
# Fq2 slots of a lane: name -> index.
SLOT = {name: i for i, name in enumerate(
    ["F0", "F1", "F2", "F3", "F4", "F5",        # f = (c0.c0, c0.c1, c0.c2, c1.c0, c1.c1, c1.c2)
     "RX", "RY", "RZ"]                          # R, Jacobian
    + [f"Q{k}{c}" for k in range(1, BASES + 1) for c in "XY"]   # the bases, affine
    + ["PX", "PY",                              # (px, 0), (py, 0)
     "B2",                                      # the twist's b
     "L0", "L2", "L4"]                          # the line: ell_0, ell_vv px, ell_vw py
    + [f"P{i}" for i in range(18)]              # product scratch
    + ["T0", "T1", "T2", "T3", "T4"])}          # temporaries
N_SLOTS = len(SLOT)
TEAM = 6
# A term's slot at VIRT + j or above is virtual: the kernel reads slot
# vb + j, vb its argument for the lane (here the addition's base, BX and
# BY, vb = base_slot(kind); the GLV ladder's table point,
# ladder_schedule.py).  Real slots stay below VIRT.
VIRT = 56
VIRTUAL = {"BX": VIRT, "BY": VIRT + 1}
NAMES = {**SLOT, **VIRTUAL}
NONE = 0xFF
TERM_BITS, MAX_TERMS = 6, 10                    # a slot a term, 10 in 64 bits
HALF, DOUBLE = 1, 2                             # Lin.post


class Lin(NamedTuple):
    """xi * (sum of the signed slots b) + (sum of a), then halved or
    doubled by post; a term is a slot name, "-" in front negates it."""
    b: tuple = ()
    a: tuple = ()
    post: int = 0


class Mul(NamedTuple):
    dst: str
    x: Lin
    y: Lin


class Comb(NamedTuple):
    dst: str
    lin: Lin


class Round(NamedTuple):
    muls: tuple          # at most 18: three passes of six
    lins: tuple          # at most 12: two passes of six


def A(*terms):
    """A Lin that is a plain signed sum."""
    return Lin(a=terms)


def _s(v):
    """Devegili operands of an Fq6 product over the Lins v0, v1, v2: v_k,
    then v1 + v2, v0 + v1, v0 + v2 (concatenated lists, xi parts too)."""
    cat = lambda p, q: Lin(p.b + q.b, p.a + q.a)
    return (v[0], v[1], v[2], cat(v[1], v[2]), cat(v[0], v[1]), cat(v[0], v[2]))


# ---------------------------------------------------------------------------
# Fq12 square (fq12.rs:295-303): ab = a0 a1 and m = (a0 + v a1)(a0 + a1),
# two Devegili Fq6 products S0 (P0-P5) and S1 (P6-P11); c0 = m - ab - v ab,
# c1 = 2 ab, written as signed sums of the 12 products with one xi each.
# ---------------------------------------------------------------------------

_A0, _A1 = [A(f"F{i}") for i in range(3)], [A(f"F{3 + i}") for i in range(3)]
_SX = [Lin(b=("F5",), a=("F0",)), A("F1", "F3"), A("F2", "F4")]     # a0 + v a1
_SY = [A("F0", "F3"), A("F1", "F4"), A("F2", "F5")]                 # a0 + a1
SQR_MULS = tuple(Mul(f"P{k}", x, y) for k, (x, y) in enumerate(zip(_s(_A0), _s(_A1)))) + \
    tuple(Mul(f"P{6 + k}", x, y) for k, (x, y) in enumerate(zip(_s(_SX), _s(_SY))))


def _sqr_lins():
    s0 = lambda k, neg=False: ("-" if neg else "") + f"P{k}"
    s1 = lambda k, neg=False: ("-" if neg else "") + f"P{6 + k}"
    return (
        # m0 - ab0 - xi ab2
        Comb("F0", Lin(b=(s1(3), s1(1, 1), s1(2, 1), s0(3, 1), s0(2), s0(2), s0(5, 1), s0(0)),
                       a=(s1(0), s0(0, 1)))),
        # m1 - ab1 - ab0
        Comb("F1", Lin(b=(s1(2), s0(3, 1), s0(1)),
                       a=(s1(4), s1(0, 1), s1(1, 1), s0(4, 1), s0(1)))),
        # m2 - ab2 - ab1
        Comb("F2", Lin(b=(s0(2, 1),),
                       a=(s1(5), s1(0, 1), s1(1), s1(2, 1), s0(5, 1), s0(0), s0(0), s0(2),
                          s0(4, 1)))),
        # 2 ab
        Comb("F3", Lin(b=(s0(3), s0(1, 1), s0(2, 1)), a=(s0(0),), post=DOUBLE)),
        Comb("F4", Lin(b=(s0(2),), a=(s0(4), s0(0, 1), s0(1, 1)), post=DOUBLE)),
        Comb("F5", Lin(a=(s0(5), s0(0, 1), s0(1), s0(2, 1)), post=DOUBLE)),
    )


SQR_LINS = _sqr_lins()

# ---------------------------------------------------------------------------
# 024 fold (fq12.rs:130-196, fused._mul_by_024) of the line (x0, x2, x4) =
# (L0, L2, L4): 13 products into P0-P12, then each new coefficient.
# ---------------------------------------------------------------------------

_FOLD_OPS = (("F0", "L0"), ("F2", "L2"), ("F4", "L4"), ("F1", "L2"), ("F5", "L4"),
             ("F1", "L0"), ("F0 F2", "L0 L2"), ("F3", "L4"), ("F2 F4", "L2 L4"),
             ("F3", "L0"), ("F5", "L2"), ("F0 F4", "L0 L4"), ("F1 F3 F5", "L0 L2 L4"))
FOLD_MULS = tuple(Mul(f"P{i}", A(*x.split()), A(*y.split())) for i, (x, y) in enumerate(_FOLD_OPS))
FOLD_LINS = (
    Comb("F0", Lin(b=("P3", "P2"), a=("P0",))),
    Comb("F1", Lin(b=("P4", "P1"), a=("P5",))),
    Comb("F2", A("P6", "-P0", "-P1", "P7")),
    Comb("F3", Lin(b=("P8", "-P1", "-P2"), a=("P9",))),
    Comb("F4", Lin(b=("P10",), a=("P11", "-P0", "-P2"))),
    Comb("F5", A("P12", "-P3", "-P7", "-P4", "-P9", "-P5", "-P10")),
)

# ---------------------------------------------------------------------------
# Doubling step (mod.rs:754-776, fused._dbl_step), its polynomial kept:
# xy, b = y^2, c = z^2, (y + z)^2, j = x^2 | d = 3c, h, -h, 3j, a = xy/2 |
# e = b2 d, z' = b h, ell_vv px, ell_vw py | g = (b + 3e)/2, b - 3e, ell_0 =
# xi(e - b) | e^2, g^2, x' = a (b - 3e) | y' = g^2 - 3 e^2.  Slots P12-P17
# carry what the square's products (P0-P11) and the fold's (P0-P12) leave.
# ---------------------------------------------------------------------------

DBL_R1_MULS = (Mul("P12", A("RX"), A("RY")), Mul("P13", A("RY"), A("RY")),
               Mul("P14", A("RZ"), A("RZ")), Mul("P15", A("RY", "RZ"), A("RY", "RZ")),
               Mul("P16", A("RX"), A("RX")))
DBL_R1_LINS = (Comb("T0", A("P14", "P14", "P14")),         # d = 3c
               Comb("T1", A("P15", "-P13", "-P14")),       # h
               Comb("T2", A("P13", "P14", "-P15")),        # ell_vw = -h
               Comb("T3", A("P16", "P16", "P16")),         # ell_vv = 3j
               Comb("T4", Lin(a=("P12",), post=HALF)))     # a = xy / 2
DBL_R2_MULS = (Mul("P15", A("B2"), A("T0")),               # e
               Mul("RZ", A("P13"), A("T1")),               # z' = b h
               Mul("L2", A("T3"), A("PX")),
               Mul("L4", A("T2"), A("PY")))
DBL_R2_LINS = (Comb("P16", Lin(a=("P13", "P15", "P15", "P15"), post=HALF)),   # g
               Comb("P17", A("P13", "-P15", "-P15", "-P15")),                 # b - 3e
               Comb("L0", Lin(b=("P15", "-P13"))))                            # xi (e - b)
DBL_R3_MULS = (Mul("P13", A("P15"), A("P15")),             # e^2
               Mul("P14", A("P16"), A("P16")),             # g^2
               Mul("RX", A("T4"), A("P17")))               # x' = a (b - 3e)
DBL_R3_LINS = (Comb("RY", A("P14", "-P13", "-P13", "-P13")),)

# ---------------------------------------------------------------------------
# Mixed addition step (mod.rs:731-752, fused._add_step) against (BX, BY):
# z bx, z by | d = x - z bx, e = y - z by | d^2, e^2, e bx, d by, ell_vv px
# = -e px, ell_vw py = d py | ell_0 = xi(e bx - d by) | h = d f, i = x f,
# z g | j = z g + h - 2i | x' = d j, e (i - j), h y, z' = z h | y' = e (i -
# j) - h y.
# ---------------------------------------------------------------------------

ADD_A1_MULS = (Mul("P0", A("RZ"), A("BX")), Mul("P1", A("RZ"), A("BY")))
ADD_A1_LINS = (Comb("T0", A("RX", "-P0")),                  # d
               Comb("T1", A("RY", "-P1")))                  # e
ADD_A2_MULS = (Mul("P13", A("T0"), A("T0")), Mul("P14", A("T1"), A("T1")),
               Mul("P2", A("T1"), A("BX")), Mul("P3", A("T0"), A("BY")),
               Mul("L2", A("-T1"), A("PX")), Mul("L4", A("T0"), A("PY")))
ADD_A2_LINS = (Comb("L0", Lin(b=("P2", "-P3"))),)
ADD_A3_MULS = (Mul("P15", A("T0"), A("P13")),               # h = d f
               Mul("P16", A("RX"), A("P13")),               # i = x f
               Mul("P17", A("RZ"), A("P14")))               # z g
ADD_A3_LINS = (Comb("T2", A("P17", "P15", "-P16", "-P16")),)  # j
ADD_A4_MULS = (Mul("RX", A("T0"), A("T2")), Mul("P0", A("T1"), A("P16", "-T2")),
               Mul("P1", A("P15"), A("RY")), Mul("RZ", A("RZ"), A("P15")))
ADD_A4_LINS = (Comb("RY", A("P0", "-P1")),)

# A doubling step followed by an addition takes the addition's first
# products (z bx, z by) into its last round, and the addition's d and e
# into that round's combinations (e from y' = g^2 - 3 e^2 directly, since
# y' is written beside it): the addition then starts at its second round.
DBL_R3A_MULS = (Mul("T2", A("RZ"), A("BX")), Mul("T3", A("RZ"), A("BY")))
DBL_R3A_LINS = (Comb("T0", A("RX", "-T2")),                              # d
                Comb("T1", A("P14", "-P13", "-P13", "-P13", "-T3")))     # e

# The Frobenius bases (mod.rs:693-699, fused._mul_by_q applied twice),
# where a step adds pi(Q) or -pi^2(Q): the kernel's start puts conj(qx),
# conj(qy) and the twist factors tx, ty, tx conj(tx), ty conj(ty)
# (_build.twist_consts) into P0-P5, free until the first step; this round
# makes pi(Q) = (tx conj(qx), ty conj(qy)) and -pi^2(Q) = (tx conj(tx) qx,
# ty conj(ty) (-qy)), one product a thread.  It runs as a step of kind
# FROB_KIND, first (device_kinds), through the steps' own round code: a
# product spelled anywhere else in the kernel, even where never reached,
# slowed every step (PERF.md).
FROB_MULS = (Mul("Q3X", A("P0"), A("P2")), Mul("Q3Y", A("P1"), A("P3")),
             Mul("Q4X", A("Q1X"), A("P4")), Mul("Q4Y", A("Q2Y"), A("P5")))
FROB_KIND = 5

ROUNDS = (Round(SQR_MULS + DBL_R1_MULS, SQR_LINS + DBL_R1_LINS),                  # 0
          Round(DBL_R2_MULS, DBL_R2_LINS),                                        # 1
          Round(FOLD_MULS + DBL_R3_MULS, FOLD_LINS + DBL_R3_LINS),                # 2
          Round(FOLD_MULS + DBL_R3_MULS + DBL_R3A_MULS,
                FOLD_LINS + DBL_R3_LINS + DBL_R3A_LINS),                          # 3
          Round(ADD_A1_MULS, ADD_A1_LINS),                                        # 4
          Round(ADD_A2_MULS, ADD_A2_LINS),                                        # 5
          Round(FOLD_MULS + ADD_A3_MULS, FOLD_LINS + ADD_A3_LINS),                # 6
          Round(ADD_A4_MULS, ADD_A4_LINS),                                        # 7
          Round(FROB_MULS, ()))                                                   # 8
DBL, DBL_THEN_ADD, ADD, ADD_AFTER_DBL = (0, 1, 2), (0, 1, 3), (4, 5, 6, 7), (5, 6, 7)
FROB = (8,)


def device_kinds(kinds):
    """The kinds k_miller_precompute runs: FROB_KIND first where a step
    adds a Frobenius base (kind 3 or 4), then `kinds`."""
    kinds = np.asarray(kinds, dtype=np.int32).ravel()
    return np.concatenate([[FROB_KIND], kinds]).astype(np.int32) if (kinds >= 3).any() else kinds


def step_rounds(kinds, i: int) -> tuple:
    """(the rounds of step i of the schedule `kinds`, the kind whose base
    BX, BY stand for), as k_miller_precompute picks them: a doubling step ends
    with round 3 when an addition follows, an addition after a doubling
    step starts at its second round; FROB_KIND runs the bases' round."""
    kind = int(kinds[i])
    if kind == FROB_KIND:
        return FROB, 0
    if kind == 0:
        nxt = int(kinds[i + 1]) if i + 1 < len(kinds) else 0
        return (DBL_THEN_ADD if nxt else DBL), nxt
    return (ADD_AFTER_DBL if i and int(kinds[i - 1]) == 0 else ADD), kind


def base_slot(kind: int, slots: dict = SLOT) -> int:
    """vb of an addition of kind 1-4: the slot of its base's x, Q1X + 2
    (kind - 1); its y is the next."""
    return slots["Q1X"] + 2 * (kind - 1)


def slot(term: str, slots: dict) -> tuple:
    """(slot index, negate) of a term; ``slots`` maps a schedule's names,
    virtual ones included (``NAMES`` for this one)."""
    return slots[term.lstrip("-")], term.startswith("-")


def reads(lin: Lin) -> set:
    return {t.lstrip("-") for t in lin.b + lin.a}


def check_round(rnd: Round, team: int, slots: dict):
    """Raise unless the round is race-free and fits the kernel's passes for
    a team of `team` threads (fq12_team.cuh team_round: task k + team p on
    thread k, at most 18 products and 12 combinations, whole passes):
    within each half (products, then combinations) no slot is written by
    two tasks, and no task reads a slot another task of that half writes
    (a task may read the slot it writes: it reads first)."""
    most = (18 // team * team, 12 // team * team)
    if len(rnd.muls) > most[0] or len(rnd.lins) > most[1]:
        raise ValueError(f"a round of a {team}-thread team has at most {most[0]} products "
                         f"and {most[1]} combinations")
    halves = ([(m.dst, reads(m.x) | reads(m.y)) for m in rnd.muls],
              [(c.dst, reads(c.lin)) for c in rnd.lins])
    for tasks in halves:
        dsts = [d for d, _ in tasks]
        if len(set(dsts)) != len(dsts):
            raise ValueError(f"two tasks of a round write one slot: {dsts}")
        for i, (d, _) in enumerate(tasks):
            for j, (_, rd) in enumerate(tasks):
                if i != j and d in rd:
                    raise ValueError(f"task {j} reads {d}, which task {i} writes")
    for lin in [m.x for m in rnd.muls] + [m.y for m in rnd.muls] + [c.lin for c in rnd.lins]:
        if sum(len(ts) for ts in _split(lin, slots)) > MAX_TERMS:
            raise ValueError(f"more than {MAX_TERMS} terms in {lin}")


def _split(lin: Lin, slots: dict) -> tuple:
    """The kernel's four term lists: b's positive and negative slots, a's."""
    sign = lambda ts, neg: [slot(t, slots)[0] for t in ts if slot(t, slots)[1] == neg]
    return sign(lin.b, False), sign(lin.b, True), sign(lin.a, False), sign(lin.a, True)


def _c_lin(lin: Lin, dst, slots: dict) -> str:
    """fq12_team.cuh TeamLin: the four lists' slots in one word, first
    lowest; their counts 4 bits each, then post; the destination."""
    lists = _split(lin, slots)
    terms = sum(s << (TERM_BITS * i) for i, s in enumerate(sum(lists, [])))
    counts = sum(len(ts) << (4 * i) for i, ts in enumerate(lists)) | (lin.post << 16)
    dst = NONE if dst is None else slots[dst]
    return f"{{0x{terms:016x}ull, 0x{counts:05x}u, {dst}u}}"


def rounds_initializer(rounds, team: int, slots: dict, n_slots: int) -> str:
    """The rounds as a C initializer of fq12_team.cuh's TeamRound array:
    products and combinations by pass (task k + team p on thread k),
    absent tasks with dst 0xFF; each round checked first, and the
    schedule's `n_slots` real slots below VIRT, its virtual ones below
    the term's 6 bits."""
    if n_slots > VIRT or max(slots.values()) >= 1 << TERM_BITS:
        raise ValueError(f"real slots must lie below {VIRT}, every slot below {1 << TERM_BITS}")
    empty = _c_lin(Lin(), None, slots)
    out = []
    for rnd in rounds:
        check_round(rnd, team, slots)
        muls = [f"{{{_c_lin(m.x, m.dst, slots)}, {_c_lin(m.y, None, slots)}}}" for m in rnd.muls]
        muls += [f"{{{empty}, {empty}}}"] * (18 - len(muls))
        lins = [_c_lin(c.lin, c.dst, slots) for c in rnd.lins] + [empty] * (12 - len(rnd.lins))
        passes = (-(-len(rnd.muls) // team), -(-len(rnd.lins) // team))
        out.append(f"{{{{{', '.join(muls)}}}, {{{', '.join(lins)}}}, "
                   f"{{{passes[0]}, {passes[1]}, 0, 0}}}}")
    return "{ \\\n  " + ", \\\n  ".join(out) + " }"


def header() -> str:
    """The Miller rounds as C initializers (``rounds_initializer``) and the
    slots the kernel names."""
    return "\n".join([
        f"#define BN254_TEAM_SLOTS {N_SLOTS}",
        f"#define BN254_TEAM_VIRT {VIRT}",
        *(f"#define BN254_SLOT_{name} {i}" for name, i in SLOT.items()
          if name == "P0" or not (name[0] in "PT" and name[1:].isdigit())),
        f"#define BN254_MILLER_NROUNDS {len(ROUNDS)}",
        f"#define BN254_MILLER_FROB_KIND {FROB_KIND}",
        f"#define BN254_MILLER_R_FROB {FROB[0]}",
        f"#define BN254_MILLER_ROUNDS {rounds_initializer(ROUNDS, TEAM, NAMES, N_SLOTS)}",
        "",
    ])
