"""One case per kernel and variant (Fq or Fr modulus, NAF or binary
digits, G1 or G2): its wrapper, its plain version, inputs at the shapes the
main path gives it and the work those inputs need — what ``chip_smoke.py``
compares bit for bit on the card and holds against the card's bound.

Field inputs are drawn from a numpy seed as random Montgomery residues
(limbs below q's top limb), with the first lanes of every coordinate set
through ``Mod.encode`` to 0, 1 and q - 1; lane 0 is all zeros, which is
also what ``to_affine`` hands the Miller kernels for a point at infinity.
Point inputs are real points (``point_batch``) with the group law's edge
lanes; MSM inputs are distinct affine points with planted duplicates, so
the coincide patch runs, and a skewed variant with every lane of a window
in one bucket (``msm_args``); the bucket sort takes their digits, signed
and unsigned (``sort_args``), the bucket reduce their buckets
(``reduce_args``); GLV ladder inputs are real tables
and digits from the port's decomposition, with edge scalars and planted
tables whose adds meet their own point or its negative (``glv_args``);
the combine's window totals plant infinity windows, Horner's own running
value and P + (-P) fold pairs (``combine_points``), and the
double-and-add's scalars r, r - 1, 0 and 1 on points in and outside the
G2 subgroup (``point_mul_args``); the Fq2 square root takes random
elements and squares with 0, the alpha = -1 lanes, a non-residue and
x^3 + b2 of real G2 points planted (``fq2_sqrt_args``); the affine
conversion random coordinates with z = 0 on every block's ends, on a
whole span of blocks and on the last lane (``to_affine_args``).
The lazy Fq2 product's inputs plant the extremes of its columns
(``fq2_extremes``); the probes chain each op at its script's batch and
chain length (``probe_args``).

The bound (``bound_ms``) is the larger of two times: the Montgomery
products the inputs need at ~350 integer instructions each (32-bit CIOS
over 8 words) over the card's integer issue rate, and each input read
once and each output written once over its memory rate.
"""

from __future__ import annotations

import functools
import random
from dataclasses import dataclass
from typing import Callable

import numpy as np
import torch

from . import fused as FU
from . import glv as GLV
from . import groups as G
from . import ladder_schedule as LS
from . import limbs as L
from . import mont_kernels as MK
from . import msm as M
from . import precompute_schedule as PS
from . import probes as PB
from . import team_schedule as TS
from .convert import pack
from .fields import FR
from .pairing_torch import _LINE_KINDS, _SQR_FLAGS
from .spec import constants as C
from .spec import field as SF
from .spec import group as SG

FR_MOD = FR.mod

# H100 SXM: 132 SMs x 64 INT32 lanes per clock (half the 128 FP32 lanes
# behind the data sheet's 67 TFLOP/s) x 1.98 GHz; HBM3 at 3.35 TB/s.
INT_OPS_PER_S = 132 * 64 * 1.98e9
INSTR_PER_PRODUCT = 350
HBM_BYTES_PER_S = 3.35e12
FQ_BYTES = 16 * 4                   # one Fq value: 16 int32 limbs


@dataclass(frozen=True)
class KernelCase:
    name: str                   # key in counts.KERNELS
    label: str                  # name plus the variant, if any
    source: str                 # CUDA source in the repo
    replaces: str               # file:line of the TPU kernel
    kernel: Callable
    plain: Callable
    make_args: Callable         # (rng, batch, device) -> args
    work: Callable              # args -> (Montgomery products, bytes moved)
    batches: tuple = (16384, 1000)   # the main batch, then a ragged one
    depth: Callable | None = None    # args -> products' work on one lane's chain


def residues(rng, coords: int, batch: int, device, mod: L.Mod = MK.FQ_MOD):
    """[coords, 16, B] int32 random residues mod `mod`, edge values first."""
    a = PB.random_residues(rng, coords, batch, "cpu", mod)
    edges = mod.encode_batch([0, 1, mod.modulus - 1])[:, :batch]
    a[:, :, :edges.shape[1]] = torch.from_numpy(edges.astype(np.int32))
    return a.to(device)


def _fq(c):
    return lambda rng, b, d: tuple(residues(rng, n, b, d) for n in c)


# ---------------------------------------------------------------------------
# Group-law and MSM inputs
# ---------------------------------------------------------------------------

_SPEC = {1: SG.G1_PARAMS, 2: SG.G2_PARAMS}
_GROUP = {1: G.G1, 2: G.G2}


def _spec_bases(ncoords: int, rnd: random.Random, count: int = 8):
    ops, gen = _SPEC[ncoords][:2]
    return ops, [SG.scalar_mul((gen[0], gen[1], ops.one), rnd.randrange(1, C.R), ops)
                 for _ in range(count)]


def _rescale(p, lam, ops):
    """The same projective point with z scaled by lam: (x l^2, y l^3, z l)."""
    l2 = ops.sqr(lam)
    return (ops.mul(p[0], l2), ops.mul(p[1], ops.mul(l2, lam)), ops.mul(p[2], lam))


def _affine(p, ops):
    """The same point with z = 1."""
    x, y = SG.to_affine(p, ops)
    return (x, y, ops.one)


def point_batch(rng, ncoords: int, batch: int):
    """Spec Jacobian pairs (p, q) for the point kernels: random z on every
    lane, and the edge lanes of the unified add first — p at infinity, q at
    infinity, both, q = p (same coordinates), q = p with another z (the
    coincide branch), q = -p, p with z = 1, q = -p with another z."""
    rnd = random.Random(int(rng.integers(1 << 62)))
    ops, bases = _spec_bases(ncoords, rnd)
    lam = lambda: (rnd.randrange(1, C.Q) if ncoords == 1
                   else (rnd.randrange(C.Q), rnd.randrange(1, C.Q)))
    ps = [_rescale(bases[i % 8], lam(), ops) for i in range(batch)]
    qs = [_rescale(bases[(3 * i + 1) % 8], lam(), ops) for i in range(batch)]
    zero = SG.zero(ops)
    edges = [(zero, qs[0]), (ps[1], zero), (zero, zero), (ps[3], ps[3]),
             (ps[4], _rescale(ps[4], lam(), ops)), (ps[5], SG.neg(ps[5], ops)),
             (_affine(ps[6], ops), qs[6]), (ps[7], _rescale(SG.neg(ps[7], ops), lam(), ops))]
    for i, (p, q) in enumerate(edges[:batch]):
        ps[i], qs[i] = p, q
    return ps, qs


def _points_args(ncoords: int, both: bool):
    K = _GROUP[ncoords]

    def make(rng, batch, device):
        ps, qs = point_batch(rng, ncoords, batch)
        p = pack(G.encode_points(K, ps, device))
        return (ncoords, p, pack(G.encode_points(K, qs, device))) if both else (ncoords, p)
    return make


def msm_lanes(n: int) -> int:
    """The kernel case's lane count: 1024 when it divides n, else n / 5."""
    return 1024 if n % 1024 == 0 else n // 5


@functools.lru_cache(maxsize=8)
def _msm_points(ncoords: int, n: int, seed: int):
    """n distinct affine spec points (chained additions of 8 random
    multiples of the generator), the same for the same seed: the cases
    that share msm_args' inputs build them once."""
    ops, bases = _spec_bases(ncoords, random.Random(seed))
    pts, p = [], bases[0]
    for i in range(n):
        p = SG.add(p, bases[i % 8], ops)
        pts.append(SG.to_affine(p, ops))
    return tuple(pts)


def msm_args(rng, ncoords: int, n: int, device, skew: bool = False):
    """(ncoords, affine points [2c, 16, n], signed digits [W, n], nb, True,
    lanes) at the main path's window (c = MSM_FUSED_WINDOW).  The points
    are distinct (chained spec additions); about a tenth of the digits are
    0.  Lanes 0-7 of tile 1 repeat tile 0's points and digits, so each of
    their buckets meets its own point (the coincide patch); lanes 8-15 of
    tile 1 hold the negated points with the same digits (P + (-P)).  With
    skew, every digit of a window is the same (window 0 all 0, the others
    one random bucket and sign each): one run a lane holds every tile of
    the window, and the window's other buckets are empty."""
    ops = _SPEC[ncoords][0]
    pts = list(_msm_points(ncoords, n, int(rng.integers(1 << 62))))
    c = M.MSM_FUSED_WINDOW[ncoords]
    lanes, half = msm_lanes(n), 1 << (c - 1)
    W = (254 + 1 + c - 1) // c
    digits = rng.integers(-(half - 1), half + 1, size=(W, n)).astype(np.int32)
    digits[rng.random((W, n)) < 0.1] = 0
    if skew:
        digits[:] = rng.integers(-(half - 1), half + 1, size=(W, 1))
        digits[:, :] = np.where(digits == 0, half, digits)
        digits[0] = 0
    for j in range(16):
        x, y = pts[j]
        pts[lanes + j] = (x, y) if j < 8 else (x, ops.neg(y))
        digits[:, lanes + j] = digits[:, j]
    K = _GROUP[ncoords]
    packed = pack((K.encode([x for x, _ in pts], device), K.encode([y for _, y in pts], device)))
    return (ncoords, packed, torch.from_numpy(digits).to(device), half + 1, True, lanes)


def sort_args(ncoords: int, signed: bool, skew: bool = False):
    """(digits, nb, signed, lanes) for the bucket sort: msm_args' digits,
    or for unsigned buckets their base-2^c value d mod 2^c in [0, 2^c)."""
    def make(rng, n, device):
        _, _, digits, nb, _, lanes = msm_args(rng, ncoords, n, device, skew)
        if signed:
            return digits, nb, True, lanes
        c = M.MSM_FUSED_WINDOW[ncoords]
        return digits % (1 << c), 1 << c, False, lanes
    return make


def reduce_args(ncoords: int):
    """(ncoords, buckets [W, nb-1, 3c, 16, lanes]): msm_args' buckets,
    tile by tile in order (some of them empty: (0, 0, 0))."""
    def make(rng, n, device):
        _, points, digits, nb, signed, lanes = msm_args(rng, ncoords, n, device)
        A = FU._coord(ncoords)
        pts = points.view(2, *([2] if ncoords == 2 else []), L.N_LIMBS, n)
        sums = FU._bucket_sums(A, pts, digits, nb, signed, lanes)[1:]
        W = digits.shape[0]
        return ncoords, (sums.reshape(nb - 1, 3 * ncoords, L.N_LIMBS, W, lanes)
                         .permute(3, 0, 1, 2, 4).contiguous())
    return make


def combine_points(rng, ncoords: int, lanes: int, W: int, c: int):
    """Spec window totals [W][lanes] for the combine (Horner, then the lane
    fold): real points with random z, and planted lanes — lane 1's top
    window at infinity (Horner starts at infinity), lane 2's window 1 at
    infinity, lane 3's window W - 3 and lane 4's window 0 equal to Horner's
    running value there with another z (the add's coincide branch), lane 7
    the negation of lane 6 in every window (the fold's first step adds
    P + (-P)), and, from 16 lanes, lanes 8-15 the negations of lanes 0-7
    (P + (-P) at stride 8)."""
    rnd = random.Random(int(rng.integers(1 << 62)))
    ops, bases = _spec_bases(ncoords, rnd)
    lam = lambda: (rnd.randrange(1, C.Q) if ncoords == 1
                   else (rnd.randrange(C.Q), rnd.randrange(1, C.Q)))
    tot = [[_rescale(bases[rnd.randrange(8)], lam(), ops) for _ in range(lanes)]
           for _ in range(W)]
    zero = SG.zero(ops)
    tot[W - 1][1] = zero
    tot[1][2] = zero
    for lane, at in ((3, W - 3), (4, 0)):
        res = tot[W - 1][lane]
        for w in range(W - 2, at - 1, -1):
            for _ in range(c):
                res = SG.double(res, ops)
            if w > at:
                res = SG.add(res, tot[w][lane], ops)
        tot[at][lane] = _rescale(res, lam(), ops)
    pairs = [(6, 7)] + ([(j, 8 + j) for j in range(8)] if lanes >= 16 else [])
    for a, b in pairs:
        for w in range(W):
            tot[w][b] = SG.neg(tot[w][a], ops)
    return tot


def combine_args(ncoords: int):
    """(ncoords, window totals [W, 3c, 16, lanes], c) at the MSM's window
    c = MSM_FUSED_WINDOW (W = 43 for G1, 51 for G2), the totals from
    ``combine_points``."""
    def make(rng, lanes, device):
        c = M.MSM_FUSED_WINDOW[ncoords]
        W = (254 + 1 + c - 1) // c
        K = _GROUP[ncoords]
        tot = combine_points(rng, ncoords, lanes, W, c)
        return ncoords, torch.stack([pack(G.encode_points(K, row, device)) for row in tot]), c
    return make


# point_mul_args' first lanes: (k, the point: in the subgroup, outside it
# (G2 only; a G1 lane takes a point in it) or at infinity)
POINT_MUL_EDGES = ((C.R, "in"), (C.R - 1, "off"), (0, "in"), (1, "in"), (C.R, "off"),
                   (C.R - 1, "in"), (1, "off"), (0, "off"), (5, "inf"))


def twist_points(rnd: random.Random, count: int):
    """Affine points of the twist y^2 = x^3 + b2 from random x: outside the
    G2 subgroup (r P != 0), as a random twist point is but for a 1 / h
    chance, h the twist's cofactor."""
    ops = SG.G2_PARAMS[0]
    out = []
    while len(out) < count:
        x = (rnd.randrange(C.Q), rnd.randrange(C.Q))
        y = SF.fq2_sqrt(SF.fq2_add(SF.fq2_mul(SF.fq2_sqr(x), x), C.B2))
        if y is not None:
            out.append((x, y, ops.one))
    return out


def point_mul_args(ncoords: int):
    """(ncoords, points [3c, 16, B], scalar limbs [16, B], num_bits): real
    points with random z and random scalars below r, the first lanes as
    ``POINT_MUL_EDGES`` says (k = r, r - 1, 0, 1 on points in and outside
    the G2 subgroup, a point at infinity) and, for G2, a twist point
    outside the subgroup on every eighth lane after them.  The limbs are
    not reduced mod r, so k = r stays r.  num_bits is 254 (r's bit
    length), or 64 from 16384 lanes on, where the plain version's 2 x 254
    steps would take most of a minute on the card."""
    def make(rng, batch, device):
        K, ops = _GROUP[ncoords], _SPEC[ncoords][0]
        rnd = random.Random(int(rng.integers(1 << 62)))
        _, bases = _spec_bases(ncoords, rnd)
        off = twist_points(rnd, 4) if ncoords == 2 else bases[:4]
        lam = lambda: (rnd.randrange(1, C.Q) if ncoords == 1
                       else (rnd.randrange(C.Q), rnd.randrange(1, C.Q)))
        pts = [_rescale(off[i % 4] if i % 8 == 5 else bases[i % 8], lam(), ops)
               for i in range(batch)]
        ks = [rnd.randrange(C.R) for _ in range(batch)]
        for lane, (k, kind) in enumerate(POINT_MUL_EDGES[:batch]):
            ks[lane] = k
            pts[lane] = (SG.zero(ops) if kind == "inf" else
                         _rescale((off if kind == "off" else bases)[lane % 4], lam(), ops))
        limbs = torch.from_numpy(L._ints_to_limbs(ks).astype(np.int32)).to(device)
        return (ncoords, pack(G.encode_points(K, pts, device)), limbs,
                64 if batch >= 16384 else 254)
    return make


# glv_args' edge scalars by lane; point_batch puts finite points there
GLV_EDGES = dict(zip(range(8, 13), (0, 1, C.R - 1, GLV.LAMBDA, C.R - GLV.LAMBDA)))


def glv_args(rng, ncoords: int, batch: int, device):
    """(ncoords, table p1 | p2 | p12 [9c, 16, B], digits [128, B]): the
    port's own decomposition and sign-selected table (``glv.prepare``)
    of real points with random z (``point_batch``: lanes 0 and 2 at
    infinity) and random scalars below r, with k = 0, 1, r - 1, lambda,
    r - lambda on lanes 8-12 (``GLV_EDGES``).  Lane 6 holds the table
    (P, 2P, 3P) and lane 7 (P, -2P, -P), both with digits (1, 2, ...): on
    step 2 lane 6's add meets its own point (the coincide branch) and lane
    7's gives P + (-P)."""
    K, ops = _GROUP[ncoords], _SPEC[ncoords][0]
    rnd = random.Random(int(rng.integers(1 << 62)))
    ps, _ = point_batch(rng, ncoords, batch)
    ks = [rnd.randrange(C.R) for _ in range(batch)]
    for lane, k in GLV_EDGES.items():
        if lane < batch:
            ks[lane] = k
    pts, digits = GLV.prepare(K, G.encode_points(K, ps, device), M.encode_scalars(ks, device))
    lam = lambda: (rnd.randrange(1, C.Q) if ncoords == 1
                   else (rnd.randrange(C.Q), rnd.randrange(1, C.Q)))
    for lane, sign in ((6, 1), (7, -1)):
        if lane >= batch:
            break
        p = ps[lane]
        p2 = _rescale(SG.double(p, ops), lam(), ops)
        if sign < 0:
            p2 = SG.neg(p2, ops)
        table = [pack(G.encode_points(K, [t], device)) for t in (p, p2, SG.add(p, p2, ops))]
        pts[:, :, lane] = torch.cat(table)[..., 0]
        digits[0, lane], digits[1, lane] = 1, 2
    return ncoords, pts, digits


def fq2_sqrt_args(rng, batch: int, device):
    """(a [2, 16, B],) for the Fq2 square root: random elements (about half
    of them non-residues) on the first half of the lanes, random squares
    on the rest, and planted first lanes: 0, (1, 1), (q - 1, q - 1) (the
    edges of ``residues``), (q - 1, 0) and (n, 0) for the least
    non-residue n of Fq (alpha = -1: branch A), a non-residue of Fq2, and
    x^3 + b2 of eight real G2 points (the codec's g2_rhs)."""
    a = residues(rng, 2, batch, device)
    half = batch // 2
    a[..., half:] = MK._fq2_sqr(a[..., half:])
    rnd = random.Random(int(rng.integers(1 << 62)))
    n = next(x for x in range(2, 100) if SF.fq_sqrt(x) is None)
    nonres = next(v for v in ((rnd.randrange(C.Q), rnd.randrange(C.Q)) for _ in range(64))
                  if SF.fq2_sqrt(v) is None)
    ops, bases = _spec_bases(2, rnd)
    rhs = [SF.fq2_add(SF.fq2_mul(SF.fq2_sqr(x), x), C.B2)
           for x, _ in (SG.to_affine(p, ops) for p in bases)]
    planted = [(C.Q - 1, 0), (n, 0), nonres] + rhs
    for lane, (c0, c1) in enumerate(planted[:max(batch - 3, 0)], start=3):
        for c, v in enumerate((c0, c1)):
            a[c, :, lane] = torch.from_numpy(MK.FQ_MOD.encode(v).astype(np.int32)).to(device)
    return (a,)


AFFINE_ZERO_SPAN = 1024     # 8 whole k_to_affine blocks at 16384 lanes (K = 1)


def to_affine_args(rng, ncoords: int, batch: int, device):
    """(ncoords, Jacobian points [3c, 16, B]) for the affine conversion:
    random residues (the edge values 0, 1, q - 1 on lanes 0-2; at B = 1 a
    finite lane), and, past B = 1, z = 0 on the first and last lane of
    every 128 (so on every block's first and last lane for any block of a
    multiple of 128 lanes), on lane B - 1, and on the whole last span of
    AFFINE_ZERO_SPAN lanes where B holds two (all-infinity blocks, as
    msm._pad makes); for G2, z = (0, z1) on lane 3 and (z0, 0) on lane 4,
    finite lanes whose norm is a square."""
    if batch == 1:
        return ncoords, PB.random_residues(rng, 3 * ncoords, 1, "cpu", MK.FQ_MOD).to(device)
    p = residues(rng, 3 * ncoords, batch, "cpu")
    lane = torch.arange(batch)
    zero = (lane % 128 == 0) | (lane % 128 == 127) | (lane == batch - 1)
    if batch >= 2 * AFFINE_ZERO_SPAN:
        zero |= lane // AFFINE_ZERO_SPAN == batch // AFFINE_ZERO_SPAN - 1
    p[2 * ncoords:, :, zero] = 0
    if ncoords == 2 and batch > 4:
        p[4, :, 3] = 0
        p[5, :, 4] = 0
    return ncoords, p.to(device)


def fq2_extremes(rng, batch: int, device):
    """Fq2 operands (a, b) [2, 16, B] that drive the lazy product's column
    differences to their extremes (tests/test_pallas_fused.py's
    _fq12_adversarial, for one Fq2): on lanes 0-49 every pair (x, y) of
    the values q - 1, 1 and 0 as stored residues and q - 1 and 1 as
    canonical values (Montgomery-encoded) gives a = (x, y) with b = (y, x)
    (the (q - 1, 1) sign patterns) and with b = (x, y); on the lanes up to
    B/2 each coordinate is one of those values or random; the rest are
    random residues."""
    m = MK.FQ_MOD
    a = residues(rng, 2, batch, device).cpu().numpy()
    b = residues(rng, 2, batch, device).cpu().numpy()
    vals = np.concatenate([np.stack([L.limbs_from_int(m.modulus - 1), L.limbs_from_int(1),
                                     L.limbs_from_int(0)]).T,
                           m.encode_batch([m.modulus - 1, 1])], axis=1).astype(np.int32)
    nv = vals.shape[1]
    pairs = [(x, y) for x in range(nv) for y in range(nv)]
    lanes = [(x, y, swap) for x, y in pairs for swap in (True, False)]
    for lane, (x, y, swap) in enumerate(lanes[:batch]):
        a[0, :, lane], a[1, :, lane] = vals[:, x], vals[:, y]
        b[0, :, lane], b[1, :, lane] = (vals[:, y], vals[:, x]) if swap else (vals[:, x], vals[:, y])
    for lane in range(len(lanes), batch // 2):
        for t in (a, b):
            for c in range(2):
                k = int(rng.integers(nv + 1))
                if k < nv:
                    t[c, :, lane] = vals[:, k]
    return torch.from_numpy(a).to(device), torch.from_numpy(b).to(device)


def probe_args(name: str, variant: str, chain: int):
    """(variant, a, b, chain): random residues as the probe entries make
    them, with 0, 1 and q - 1 on the first lanes."""
    coords = 1 if name == "chain_mont" else PB.OPS[variant][0]

    def make(rng, batch, device):
        return variant, residues(rng, coords, batch, device), residues(rng, coords, batch, device), chain
    return make


# ---------------------------------------------------------------------------
# Work the inputs need: (Montgomery products, bytes read once and written once)
# ---------------------------------------------------------------------------

def _lanes(t) -> int:
    return t.shape[-1]


def _io(b, coords_in_out: int):
    return coords_in_out * FQ_BYTES * b


# Every bound counts the Montgomery products' work that the function
# needs, whatever spelling its kernel runs (an Fq product is 1):
# - an Fq square, FQ_SQR_PRODUCTS: bn254.cuh fq_sqr's 36 word products
#   (28 cross products, doubled, and 8 on the diagonal) and the 72 of the
#   reduction, where a CIOS product does 64 and 72;
# - a general Fq2 product, FQ2_MUL_LAZY_PRODUCTS: the lazy product (row
#   15) does 3 wide 256x256 products and 2 Montgomery reductions, where a
#   CIOS product is one of each at about half its instructions apiece.
#   bench_tower.py's OPS (and the probes' G Fq-products/s) count it as 3;
# - an Fq2 square, 2 (the complex square's two products), and an Fq2
#   scaled by an Fq, 2.
FQ_SQR_PRODUCTS = (36 + 72) / (64 + 72)
FQ2_MUL_LAZY_PRODUCTS = 2.5
FQ2_SQR_PRODUCTS = _FQ2_SCALE = 2
_MUL = {1: 1, 2: FQ2_MUL_LAZY_PRODUCTS}        # by coordinates: Fq, Fq2
_SQR = {1: FQ_SQR_PRODUCTS, 2: FQ2_SQR_PRODUCTS}

# The group law (csrc/groups.cuh, the same formulas over Fq and Fq2):
# unified add (generic formula, no double) 11 products and 5 squares,
# 10 and 4 where the second point's z^2 and z^3 are known, dbl-2009-l 2
# and 5, the mixed add 8 and 3
_ADD = {c: 11 * _MUL[c] + 5 * _SQR[c] for c in (1, 2)}
_ADD_KNOWN_Z = {c: 10 * _MUL[c] + 4 * _SQR[c] for c in (1, 2)}
_DBL = {c: 2 * _MUL[c] + 5 * _SQR[c] for c in (1, 2)}
_MADD = {c: 8 * _MUL[c] + 3 * _SQR[c] for c in (1, 2)}
# The tower and line functions (rows 8, 10, 13): an Fq12 square 12 Fq2
# products (its 2 Fq6 products), the fold 13 products and 2 scalings; the
# team kernels (csrc/fq12_team.cuh, rows 9, 11): 6 Fq2 products a
# Granger-Scott square, 18 an Fq12 product; the G2 line steps (rows 14
# and 7) from their schedule (lines_work)
_FQ12_SQR = 12 * FQ2_MUL_LAZY_PRODUCTS
_FOLD = 13 * FQ2_MUL_LAZY_PRODUCTS + 2 * _FQ2_SCALE
_CYC_SQR_FQ2, _FQ12_MUL_FQ2 = 6, 18


def _per_lane(work: float, t) -> int:
    return int(work * _lanes(t))


def _w_mont(a, b, mod):
    return _lanes(a), _io(_lanes(a), 3)


def _w_mont_sqr(a, mod):
    return _per_lane(FQ_SQR_PRODUCTS, a), _io(_lanes(a), 2)


def pow_chain_work(e: int) -> float:
    """The chain the kernel runs for e (fused.pow_chain_counts), each
    square at FQ_SQR_PRODUCTS: 253 squares and 55 products for q - 2,
    255.9 products' work, where the binary ladder's 253 squares and 109
    products need 309.9."""
    squares, products = FU.pow_chain_counts(e)
    return squares * FQ_SQR_PRODUCTS + products


def _w_fq_pow(a, e):
    return _per_lane(pow_chain_work(e), a), _io(_lanes(a), 2)


# Montgomery products' work of the Fq12 inverse apart from the Fermat
# chain (bn254.cuh fq12_inv): 2 Fq6 squares (3 Fq2 squares + 2 products:
# 11 each), the Fq6 inverse without its norm's inverse (3 squares + 9
# products: 28.5), the Fq2 norm (2 Fq squares) and its 2 scalings, 2 Fq6
# products (6 products: 15 each)
FQ12_INV_PRODUCTS = 2 * 11 + 28.5 + 2 * FQ_SQR_PRODUCTS + 2 + 2 * 15


def fq2_sqrt_work_per_lane() -> float:
    """Products' work of one lane of the Fq2 square root: the two window
    chains in Fq2 (fused.pow_chain_counts: each square an Fq2 square, each
    product a lazy Fq2 product) for (q - 3) / 4 and (q - 1) / 2, the lazy
    products a1 a, alpha and b a1 a, and alpha's norm (two Fq squares):
    about 1,310."""
    chains = sum(s * FQ2_SQR_PRODUCTS + p * FQ2_MUL_LAZY_PRODUCTS
                 for s, p in map(FU.pow_chain_counts, (C.FQ_MINUS3_DIV4, C.FQ_MINUS1_DIV2)))
    return chains + 3 * FQ2_MUL_LAZY_PRODUCTS + 2 * FQ_SQR_PRODUCTS


def fq2_sqrt_work(a):
    """Reads a, writes the root and one byte of ok a lane."""
    return _per_lane(fq2_sqrt_work_per_lane(), a), _io(_lanes(a), 4) + _lanes(a)


def _w_fq12_inv(a):
    return _per_lane(FQ12_INV_PRODUCTS + pow_chain_work(C.Q - 2), a), _io(_lanes(a), 24)


def _w_fq12_frob(a, power):
    """A lazy product by a constant on coefficients 1-5 (none for the
    conjugation); bound by its bytes either way."""
    products = 0 if power == FU.CONJ else 5 * FQ2_MUL_LAZY_PRODUCTS
    return _per_lane(products, a), _io(_lanes(a), 24)


def fq2_mul_work(m) -> float:
    """Montgomery products' work that the function needs for one of the
    team schedule's Fq2 products: a square (both operands one sum), a
    scaling by (px, 0) or (py, 0), or a general product."""
    if m.x == m.y:
        return FQ2_SQR_PRODUCTS
    if TS.A("PX") in (m.x, m.y) or TS.A("PY") in (m.x, m.y):
        return _FQ2_SCALE
    return FQ2_MUL_LAZY_PRODUCTS


def _w_miller(q, p, kinds):
    """The Fq2 products of the rounds the team kernel runs for these kinds
    (team_schedule.step_rounds over device_kinds), each at fq2_mul_work:
    88.5 Montgomery products a doubling step, 68 an addition, and, where a
    Frobenius addition (kind 3 or 4) needs them, 10 for the 4 lazy
    products of pi(Q) and -pi^2(Q).  Reads q, p and the kinds once,
    writes f and R."""
    k = TS.device_kinds(kinds)
    work = sum(fq2_mul_work(m) for i in range(len(k))
               for r in TS.step_rounds(k, i)[0] for m in TS.ROUNDS[r].muls)
    return int(_lanes(p) * work), _io(_lanes(p), 4 + 2 + 12 + 6) + 4 * len(k)


def line_steps_work(kinds) -> float:
    """Products' work a lane of the G2 line steps of these kinds, the Fq2
    products of the rounds k_g2_precompute runs (precompute_schedule.step_rounds)
    at fq2_mul_work: 22 a doubling step (4 general products, 6 squares;
    its two halvings are no products), 31.5 an addition (11 and 2), the
    first products of an addition after a doubling step in its rounds."""
    k = np.asarray(kinds).ravel()
    return sum(fq2_mul_work(m) for i in range(len(k))
               for r in PS.step_rounds(k, i)[0] for m in PS.ROUNDS[r].muls)


def lines_work(q, kinds):
    """precompute's steps (line_steps_work: 64 x 22 + 23 x 31.5) and the 4
    lazy products of its Frobenius bases, 2,142.5 products' work a lane.
    Reads q and the kinds once, writes the lines: 4 + 87 x 6 Fq a lane."""
    work = line_steps_work(kinds) + 4 * FQ2_MUL_LAZY_PRODUCTS
    return _per_lane(work, q), _io(_lanes(q), 4 + 6 * len(kinds)) + 4 * len(kinds)


def loop_work(coeffs, px, py, flags):
    """A square (_FQ12_SQR) where the step's flag is set and a fold
    (_FOLD) every step: 64 x 66.5 + 23 x 36.5 = 5,095.5 products' work a
    lane for the prepared Miller loop.  Reads the lines, px and py once,
    writes f."""
    fl = np.asarray(flags).ravel()
    work = int(fl.sum()) * _FQ12_SQR + len(fl) * _FOLD
    return _per_lane(work, px), _io(_lanes(px), 6 * len(fl) + 2 + 12) + 4 * len(fl)


def _w_cyc_pow(a, digits):
    d = np.asarray(digits).ravel()
    fq2 = _CYC_SQR_FQ2 * len(d) + _FQ12_MUL_FQ2 * int((d != 0).sum())
    return int(_lanes(a) * fq2 * FQ2_MUL_LAZY_PRODUCTS), _io(_lanes(a), 24)


# The team ladder's serial depth: the rounds of a step (ladder_schedule.py),
# at most one product each on a thread
LADDER_DEPTH = len(LS.ROUNDS) - LS.R_D1


def glv_depth(ncoords, pts, digits):
    """Products' work on one thread's chain: a product a round, six rounds
    a step (the coincide branch's three more are rare)."""
    return digits.shape[0] * LADDER_DEPTH * _MUL[ncoords]


def glv_work(ncoords, pts, digits):
    """A double every step; an add only where the digit is not 0 (adding
    (0, 1, 0) needs no product), its table point's z^2 and z^3 known: they
    are computed once a lane for each table point its digits pick."""
    steps, b = digits.shape
    picked = sum(int((digits == d).any(0).sum()) for d in (1, 2, 3))
    products = (steps * b * _DBL[ncoords] + int((digits != 0).sum()) * _ADD_KNOWN_Z[ncoords]
                + picked * (_SQR[ncoords] + _MUL[ncoords]))
    return int(products), _io(b, 12 * ncoords) + 4 * steps * b


def msm_work(ncoords, points, digits, nb, signed, lanes):
    W, n = digits.shape
    products = (int((digits != 0).sum()) * _MADD[ncoords]
                + W * lanes * (nb - 1) * 2 * _ADD[ncoords])
    return int(products), (_io(n, 2 * ncoords) + 4 * W * n + _io(W * lanes, 3 * ncoords))


def _finite(t, ncoords):
    """[.., 3c, 16, B] packed points -> [.., B] True where z != 0."""
    return (t[..., 2 * ncoords:, :, :] != 0).flatten(-3, -2).any(-2)


def combine_work(ncoords, totals, c):
    """Every lane doubles c times a window (W - 1 windows); an add where
    the window's total is finite (adding (0, 1, 0) needs no product); the
    fold's lanes - 1 adds.  Reads the totals, writes one point."""
    W, _, _, lanes = totals.shape
    products = ((W - 1) * c * lanes * _DBL[ncoords]
                + (int(_finite(totals[:-1], ncoords).sum()) + lanes - 1) * _ADD[ncoords])
    return int(products), _io(W * lanes, 3 * ncoords) + _io(1, 3 * ncoords)


def combine_depth(ncoords, totals, c):
    """Products' work on one lane's chain: (W - 1) c doubles and W - 1
    adds of Horner, then log2(lanes) adds of the fold."""
    W, lanes = totals.shape[0], totals.shape[-1]
    return (W - 1) * c * _DBL[ncoords] + (W - 1 + lanes.bit_length() - 1) * _ADD[ncoords]


_AFFINE_COORDS = {1: FQ_SQR_PRODUCTS + 3,                           # z^-2, z^-3, x, y
                  2: 2 + FQ2_SQR_PRODUCTS + 3 * FQ2_MUL_LAZY_PRODUCTS}  # and z^-1 from d^-1
_NORM = {1: 0, 2: 2 * FQ_SQR_PRODUCTS}


def to_affine_work(ncoords, p):
    """The shared inversion: 3 products a finite lane (the prefix, two in
    the backward pass) and one Fermat chain for the batch; G2's norm (two
    Fq squares) on every lane; on each finite lane z^-1 (G2: two
    products), z^-2, z^-3, x z^-2 and y z^-3.  Reads the points, writes
    (x, y) and one byte of inf a lane."""
    b = p.shape[-1]
    finite = int(_finite(p, ncoords).sum())
    products = (finite * (3 + _AFFINE_COORDS[ncoords]) + _NORM[ncoords] * b
                + pow_chain_work(C.Q - 2))
    return int(products), _io(b, 5 * ncoords) + b


def to_affine_depth(ncoords, p):
    """Products' work on the chain of a block's first lane: its thread's K
    lanes (fused.to_affine_geometry on the card; off it, where no kernel
    runs, one lane a thread and to_affine_plain's block) each with its
    norm and a prefix product, the two warp scans (5 products each), warp
    0's two scans over the block's warps, the block's Fermat chain, the
    warp's factor and the thread's inverse (2 each), then K lanes of the
    backward pass (the norm again and two products) and coordinates."""
    k, threads = (FU.to_affine_geometry(ncoords, p.shape[-1]) if p.is_cuda
                  else (1, FU.AFFINE_PLAIN_BLOCK))
    warps = threads // 32
    return (k * (2 * _NORM[ncoords] + 3 + _AFFINE_COORDS[ncoords]) + 2 * 5
            + 2 * (warps.bit_length() - 1) + pow_chain_work(C.Q - 2) + 4)


def _scalar_bits(k, num_bits):
    """[num_bits, B] bool: bit i of each lane's scalar limbs [16, B]."""
    i = torch.arange(num_bits, device=k.device)
    return ((k[i // L.LIMB_BITS] >> (i % L.LIMB_BITS)[:, None]) & 1) > 0


def point_mul_work(ncoords, p, k, num_bits):
    """A double every step; an add where the bit is set and the base is
    finite.  Reads the points and the scalars, writes the results."""
    b = p.shape[-1]
    adds = int((_scalar_bits(k, num_bits) & _finite(p, ncoords)).sum())
    return (int(num_bits * b * _DBL[ncoords] + adds * _ADD[ncoords]),
            _io(b, 6 * ncoords + 1))


def point_mul_depth(ncoords, p, k, num_bits):
    """num_bits doubles and the most adds any lane runs."""
    adds = int(_scalar_bits(k, num_bits).sum(0).max())
    return num_bits * _DBL[ncoords] + adds * _ADD[ncoords]


def sort_work(digits, nb, signed, lanes):
    """No products; the digits read, the offsets and the tile list written."""
    W, n = digits.shape
    return 0, 4 * W * n + 4 * W * nb * lanes + 4 * W * n


def reduce_work(ncoords, buckets):
    W, nb1, _, _, lanes = buckets.shape
    return (int(W * lanes * nb1 * 2 * _ADD[ncoords]),
            _io(W * lanes, 3 * ncoords * (nb1 + 1)))


# Montgomery products' work of one op of each probe, as the bounds count
# it (PB.OPS keeps bench_tower.py's eager count for the G Fq-products/s)
_PROBE_WORK = {
    "mul": 1, "sqr": FQ_SQR_PRODUCTS, "fq_mul": 1,
    "fq2_mul": FQ2_MUL_LAZY_PRODUCTS, "fq2_sqr": FQ2_SQR_PRODUCTS,
    "fq6_mul": 6 * FQ2_MUL_LAZY_PRODUCTS, "fq12_sqr": _FQ12_SQR,
    "fq12_mul": _FQ12_MUL_FQ2 * FQ2_MUL_LAZY_PRODUCTS,
    "cyclo_sqr": _CYC_SQR_FQ2 * FQ2_MUL_LAZY_PRODUCTS,
}


def body_products(variant) -> float:
    """Fq products' work of one op of a probe, as its bound counts it."""
    return _PROBE_WORK[variant]


def probe_work(variant, a, b, chain):
    """batch * chain * body_products; a square reads one operand."""
    reads = 1 if variant in ("sqr", "fq2_sqr", "fq12_sqr", "cyclo_sqr") else 2
    return (int(_lanes(a) * chain * body_products(variant)),
            _io(_lanes(a), (reads + 1) * a.shape[0]))


def bound_ms(products: int, nbytes: int):
    """(ms, "operations" or "bytes"): the least time the card could take."""
    ops_ms = products * INSTR_PER_PRODUCT / INT_OPS_PER_S * 1e3
    bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
    return (ops_ms, "operations") if ops_ms >= bytes_ms else (bytes_ms, "bytes")


_PK = "bn254_tpu/pallas_kernels.py"
_PF = "bn254_tpu/pallas_fused.py"
_MK_CU = "bn254_tpu_torch/csrc/mont_kernels.cu"
_FU_CU = "bn254_tpu_torch/csrc/fused.cu"
_GR_CU = "bn254_tpu_torch/csrc/groups.cu"
_PR_CU = "bn254_tpu_torch/csrc/probes.cu"
_FINAL_EXP_BATCHES = (16384, 1000, 3, 1)

CASES = (
    KernelCase("mont_mul", "mont_mul[fq]", _MK_CU, f"{_PK}:239", MK.mont_mul, L.mont_mul,
               lambda rng, b, d: (residues(rng, 1, b, d)[0], residues(rng, 1, b, d)[0],
                                  MK.FQ_MOD), _w_mont),
    KernelCase("mont_mul", "mont_mul[fr]", _MK_CU, f"{_PK}:239", MK.mont_mul, L.mont_mul,
               lambda rng, b, d: (residues(rng, 1, b, d, FR_MOD)[0],
                                  residues(rng, 1, b, d, FR_MOD)[0], FR_MOD), _w_mont),
    KernelCase("mont_sqr", "mont_sqr[fq]", _MK_CU, f"{_PK}:247", MK.mont_sqr, L.mont_sqr,
               lambda rng, b, d: (residues(rng, 1, b, d)[0], MK.FQ_MOD), _w_mont_sqr),
    KernelCase("mont_sqr", "mont_sqr[fr]", _MK_CU, f"{_PK}:247", MK.mont_sqr, L.mont_sqr,
               lambda rng, b, d: (residues(rng, 1, b, d, FR_MOD)[0], FR_MOD), _w_mont_sqr),
    KernelCase("fq2_mul", "fq2_mul", _MK_CU, f"{_PK}:175", MK.fq2_mul, MK.fq2_mul_plain,
               _fq((2, 2)), lambda a, b: (_per_lane(FQ2_MUL_LAZY_PRODUCTS, a), _io(_lanes(a), 6))),
    KernelCase("fq2_sqr", "fq2_sqr", _MK_CU, f"{_PK}:181", MK.fq2_sqr, MK.fq2_sqr_plain,
               _fq((2,)), lambda a: (_per_lane(FQ2_SQR_PRODUCTS, a), _io(_lanes(a), 4))),
    KernelCase("fq_pow", "fq_pow", _FU_CU, f"{_PF}:1253", FU.fq_pow, FU.fq_pow_plain,
               lambda rng, b, d: (residues(rng, 1, b, d)[0], C.Q - 2), _w_fq_pow,
               batches=_FINAL_EXP_BATCHES),
    # the 85 scheduled steps and the 2 Frobenius additions, as the pairing
    # runs them; 16384 = 1638 blocks of 10 lanes and 4: the last block
    # partly empty; 3 and 1: fewer lanes than a warp's five teams
    KernelCase("miller_precompute", "miller_precompute", _FU_CU, f"{_PF}:1395",
               FU.miller_precompute, FU.miller_precompute_plain,
               lambda rng, b, d: (residues(rng, 4, b, d), residues(rng, 2, b, d), _LINE_KINDS),
               _w_miller, batches=(16384, 1000, 3, 1)),
    # one step of k_g2_precompute, four threads a lane (3: fewer lanes than
    # a warp's eight teams)
    KernelCase("g2_add_step", "g2_add_step", _FU_CU, f"{_PF}:1151", FU.g2_add_step,
               FU.g2_add_step_plain, _fq((6, 4)),
               lambda r, base: (_per_lane(line_steps_work([1]), r), _io(_lanes(r), 22)),
               batches=(16384, 1000, 3)),
    # one step of k_miller_loop, six threads a lane (3: fewer lanes than a
    # warp's five teams)
    KernelCase("fq12_fold_line", "fq12_fold_line", _FU_CU, f"{_PF}:1029",
               FU.fq12_fold_line, FU.fq12_fold_line_plain,
               lambda rng, b, d: (residues(rng, 12, b, d), residues(rng, 6, b, d),
                                  *residues(rng, 2, b, d)),
               lambda f, c, px, py: (_per_lane(_FOLD, f), _io(_lanes(f), 32)),
               batches=(16384, 1000, 3)),
    KernelCase("fq12_mul", "fq12_mul", _FU_CU, f"{_PF}:1022", FU.fq12_mul,
               FU.fq12_mul_plain, _fq((12, 12)),
               lambda a, b: (_per_lane(_FQ12_MUL_FQ2 * FQ2_MUL_LAZY_PRODUCTS, a),
                             _io(_lanes(a), 36)),
               batches=(16384, 1000, 3)),      # 3: fewer lanes than a warp's 5 teams
    KernelCase("fq12_cyc_sqr", "fq12_cyc_sqr", _FU_CU, f"{_PF}:1027", FU.fq12_cyc_sqr,
               FU.fq12_cyc_sqr_plain, _fq((12,)),
               lambda a: (_per_lane(_CYC_SQR_FQ2 * FQ2_MUL_LAZY_PRODUCTS, a), _io(_lanes(a), 24)),
               batches=(16384, 1000, 3)),      # 3: fewer lanes than a warp's 5 teams
    KernelCase("fq12_cyc_pow", "fq12_cyc_pow[naf]", _FU_CU, f"{_PF}:1267", FU.fq12_cyc_pow,
               FU.fq12_cyc_pow_plain,
               lambda rng, b, d: (residues(rng, 12, b, d), FU.NAF_Z), _w_cyc_pow),
    KernelCase("fq12_cyc_pow", "fq12_cyc_pow[binary]", _FU_CU, f"{_PF}:1267", FU.fq12_cyc_pow,
               FU.fq12_cyc_pow_plain,
               lambda rng, b, d: (residues(rng, 12, b, d), FU.BINARY_Z), _w_cyc_pow),
    *(KernelCase("point_add", f"point_add[g{nc}]", _GR_CU, f"{_PF}:789", FU.point_add,
                 FU.point_add_plain, _points_args(nc, True),
                 lambda ncoords, p, q: (_per_lane(_ADD[ncoords], p), _io(_lanes(p), 9 * ncoords)))
      for nc in (1, 2)),
    *(KernelCase("point_double", f"point_double[g{nc}]", _GR_CU, f"{_PF}:769",
                 FU.point_double, FU.point_double_plain, _points_args(nc, False),
                 lambda ncoords, p: (_per_lane(_DBL[ncoords], p), _io(_lanes(p), 6 * ncoords)))
      for nc in (1, 2)),
    *(KernelCase("msm_accumulate", f"msm_accumulate[g{nc}{',skew' * skew}]", _GR_CU,
                 f"{_PF}:1635", FU.msm_accumulate, FU.msm_accumulate_plain,
                 lambda rng, b, d, nc=nc, skew=skew: msm_args(rng, nc, b, d, skew), msm_work,
                 batches=(16384, 5000))
      for nc, skew in ((1, False), (2, False), (1, True))),
    KernelCase("fq12_sqr", "fq12_sqr", _FU_CU, f"{_PF}:1025", FU.fq12_sqr,
               FU.fq12_sqr_plain, _fq((12,)),
               lambda a: (_per_lane(_FQ12_SQR, a), _io(_lanes(a), 24)),
               batches=(16384, 1000, 3)),
    KernelCase("g2_dbl_step", "g2_dbl_step", _FU_CU, f"{_PF}:1145", FU.g2_dbl_step,
               FU.g2_dbl_step_plain, _fq((6,)),
               lambda r: (_per_lane(line_steps_work([0]), r), _io(_lanes(r), 18)),
               batches=(16384, 1000, 3)),
    *(KernelCase("glv_ladder", f"glv_ladder[g{nc}]", _GR_CU, f"{_PF}:1760", FU.glv_ladder,
                 FU.glv_ladder_plain, lambda rng, b, d, nc=nc: glv_args(rng, nc, b, d),
                 glv_work, depth=glv_depth)
      for nc in (1, 2)),
    # the three-thread Fq2 step (3: fewer lanes than a warp's ten teams)
    KernelCase("fq2_mul_fused", "fq2_mul_fused", _FU_CU, f"{_PF}:990", FU.fq2_mul,
               FU.fq2_mul_lazy_plain, fq2_extremes,
               lambda a, b: (_per_lane(FQ2_MUL_LAZY_PRODUCTS, a), _io(_lanes(a), 6)),
               batches=(16384, 1000, 3)),
    # a pair of threads a lane (3: fewer lanes than a warp's sixteen pairs)
    KernelCase("fq2_sqr_fused", "fq2_sqr_fused", _FU_CU, f"{_PF}:990", FU.fq2_sqr,
               FU.fq2_sqr_fused_plain, lambda rng, b, d: fq2_extremes(rng, b, d)[:1],
               lambda a: (_per_lane(FQ2_SQR_PRODUCTS, a), _io(_lanes(a), 4)),
               batches=(16384, 1000, 3)),
    *(KernelCase("chain_mont", f"chain_mont[{impl}]", _PR_CU, "scripts/bench_mont.py:39",
                 PB.chain_mont, PB.chain_mont_plain, probe_args("chain_mont", impl, 64),
                 probe_work, batches=(32768, 1000))
      for impl in PB.MONT_IMPLS),
    # 3: fewer lanes than a warp's teams (ten of three, five of six)
    *(KernelCase("chain_tower", f"chain_tower[{op}]", _PR_CU, "scripts/bench_tower.py:74",
                 PB.chain_tower, PB.chain_tower_plain, probe_args("chain_tower", op, 32),
                 probe_work, batches=(8192, 1000, 3))
      for op in PB.OPS),
    *(KernelCase("msm_bucket_sort", f"msm_bucket_sort[{label}]", _GR_CU, f"{_PF}:1635",
                 FU.msm_bucket_sort, FU.msm_bucket_sort_plain, sort_args(1, signed, skew),
                 sort_work, batches=(16384, 5000))
      for label, signed, skew in (("signed", True, False), ("unsigned", False, False),
                                  ("skew", True, True))),
    *(KernelCase("msm_bucket_reduce", f"msm_bucket_reduce[g{nc}]", _GR_CU, f"{_PF}:1635",
                 FU.msm_bucket_reduce, FU.msm_bucket_reduce_plain, reduce_args(nc),
                 reduce_work, batches=(16384, 5000))
      for nc in (1, 2)),
    # the final exponentiation's inverse and Frobenius maps, glue around
    # row 3 on the TPU; B = 1 is pairing_batch's final exponentiation
    KernelCase("fq12_inv", "fq12_inv", _FU_CU, f"{_PK}:175", FU.fq12_inv, FU.fq12_inv_plain,
               _fq((12,)), _w_fq12_inv, batches=_FINAL_EXP_BATCHES),
    *(KernelCase("fq12_frob", f"fq12_frob[{'conj' if p == FU.CONJ else p}]", _FU_CU,
                 f"{_PK}:175", FU.fq12_frob, FU.fq12_frob_plain,
                 lambda rng, b, d, p=p: (residues(rng, 12, b, d), p), _w_fq12_frob,
                 batches=_FINAL_EXP_BATCHES)
      for p in FU.FROB_POWERS),
    # the codec's Fq2 square root in one launch (the JAX package's scans
    # over rows 3-4)
    KernelCase("fq2_sqrt", "fq2_sqrt", _FU_CU, f"{_PK}:181/175", FU.fq2_sqrt,
               FU.fq2_sqrt_plain, fq2_sqrt_args, fq2_sqrt_work, batches=(16384, 1000, 3),
               depth=lambda a: fq2_sqrt_work_per_lane()),
    # the group law's step loops, one launch each (rows 17-18's callers)
    *(KernelCase("msm_combine", f"msm_combine[g{nc}]", _GR_CU, f"{_PF}:769/789",
                 FU.msm_combine, FU.msm_combine_plain, combine_args(nc), combine_work,
                 batches=(1024, 128, 8), depth=combine_depth)
      for nc in (1, 2)),
    *(KernelCase("point_mul", f"point_mul[g{nc}]", _GR_CU, f"{_PF}:769/789",
                 FU.point_mul, FU.point_mul_plain, point_mul_args(nc), point_mul_work,
                 batches=_FINAL_EXP_BATCHES, depth=point_mul_depth)
      for nc in (1, 2)),
    # the prepared Miller loop in one launch (the JAX package's scan over
    # rows 13 and 8); 16384 = 819 blocks of 20 lanes and 4
    KernelCase("miller_loop", "miller_loop", _FU_CU, f"{_PF}:1025/1029", FU.miller_loop,
               FU.miller_loop_plain,
               lambda rng, b, d: (residues(rng, 87 * 6, b, d).view(87, 6, 16, b),
                                  *residues(rng, 2, b, d), _SQR_FLAGS),
               loop_work, batches=(16384, 1000, 3)),
    # the 87 lines of the prepared-G2 entry in one launch (the JAX package's
    # scan over rows 14 and 7 and its 2 Frobenius additions); 3 lanes leave
    # most of a one-warp block of 8 empty
    KernelCase("g2_precompute", "g2_precompute", _FU_CU, f"{_PF}:1145/1151",
               FU.g2_precompute, FU.g2_precompute_plain,
               lambda rng, b, d: (residues(rng, 4, b, d), _LINE_KINDS),
               lines_work, batches=(16384, 1000, 3)),
    # the affine conversion in one launch (the JAX package's Fermat
    # inversion and products over rows 1-5, with msm.py's shared inversion)
    *(KernelCase("to_affine", f"to_affine[g{nc}]", _GR_CU,
                 f"{_PK}:239/247/175/181, {_PF}:1246", FU.to_affine, FU.to_affine_plain,
                 lambda rng, b, d, nc=nc: to_affine_args(rng, nc, b, d), to_affine_work,
                 batches=(16384, 1000, 1), depth=to_affine_depth)
      for nc in (1, 2)),
)


def outputs(x) -> tuple:
    return x if isinstance(x, tuple) else (x,)


def max_abs_err(a, b) -> int:
    """Largest |kernel - plain| over all outputs (limbs as integers)."""
    return max(int((x.to(torch.int64) - y.to(torch.int64)).abs().max())
               for x, y in zip(outputs(a), outputs(b)))
