"""The frozen roofline counts against counts of the reference's own formulas,
and the bucket count against a plain simulation."""

import random

import numpy as np
import pytest

from benchlib import inputs as I
from benchlib import limbs as L
from benchlib import roofline as RF
from bnref import bn254 as B

Q = B.Q


class Counting:
    """Counts Fq products made through the reference's Fq2 functions."""

    def __init__(self, monkeypatch):
        self.n = 0
        mul, sqr, scale = B.fq2_mul, B.fq2_sqr, B.fq2_scale

        def cmul(a, b):
            self.n += 3
            return mul(a, b)

        def csqr(a):
            self.n += 2
            return sqr(a)

        def cscale(a, k):
            self.n += 0 if k == B.TWO_INV else 2        # a halving is additions
            return scale(a, k)

        for name, f in (("fq2_mul", cmul), ("fq2_sqr", csqr), ("fq2_scale", cscale)):
            monkeypatch.setattr(B, name, f)


def _fq2(rng):
    return (rng.randrange(Q), rng.randrange(Q))


def test_one_doubling_step_and_one_addition_step(monkeypatch):
    rng = random.Random(1)
    c = Counting(monkeypatch)
    B._doubling_step((_fq2(rng), _fq2(rng), _fq2(rng)))
    assert c.n == RF.MILLER["doubling_step"] == 24
    c.n = 0
    B._addition_step((_fq2(rng), _fq2(rng), _fq2(rng)), (_fq2(rng), _fq2(rng)))
    assert c.n == RF.MILLER["addition_step"] == 37


def test_one_fold_one_square_and_the_line_scaling(monkeypatch):
    rng = random.Random(2)
    f = tuple(tuple(_fq2(rng) for _ in range(3)) for _ in range(2))
    c = Counting(monkeypatch)
    B.fq12_mul_by_024(f, _fq2(rng), _fq2(rng), _fq2(rng))
    assert c.n == RF.MILLER["fold"] == 39
    c.n = 0
    B.fq12_sqr(f)
    assert c.n == RF.MILLER["square"] == 36
    assert RF.MILLER["line_scaling"] == 2 * RF.SPEC["fq2"]["by_fq"]
    assert RF.MILLER["frobenius_bases"] == 2 * RF.SPEC["fq2"]["mul"] + 2 * RF.SPEC["fq2"]["by_fq"]


def test_the_miller_schedule_and_totals():
    m = RF.MILLER
    assert m["doublings"] == len(B.ATE_NAF) == m["squarings"]
    assert m["additions"] == sum(1 for d in B.ATE_NAF if d) + 2
    assert m["lines"] == m["doublings"] + m["additions"] == 87
    assert RF.miller_steps() == 64 * 24 + 23 * 37 + 10 + 87 * 4
    assert RF.miller_products("pairing", 1) == RF.miller_steps() + 86 * 39 + 63 * 36 == 8367
    assert RF.miller_products("pairing_batch", 2) == 2 * (RF.miller_steps() + 87 * 39) - 39 + 63 * 36
    assert RF.miller_products("pairing", 0) == 0


class CountingOps:
    """Fq or Fq2 on Python ints that counts products, for the group law."""

    def __init__(self, ncoords):
        self.nc, self.n = ncoords, 0
        K = B.FqOps if ncoords == 1 else B.Fq2Ops
        self.K, self.zero, self.one = K, K.zero, K.one
        self.add, self.sub, self.inv = K.add, K.sub, K.inv

    def mul(self, a, b):
        self.n += 1 if self.nc == 1 else 3
        return self.K.mul(a, b)

    def sqr(self, a):
        self.n += 1 if self.nc == 1 else 2
        return self.K.sqr(a)


@pytest.mark.parametrize("ncoords", [1, 2])
def test_one_mixed_addition_and_one_general_addition(ncoords):
    K, g = (B.FqOps, B.G1_ONE) if ncoords == 1 else (B.Fq2Ops, B.G2_ONE)
    p = B.scalar_mul((g[0], g[1], K.one), 1234567, K)
    q = B.to_affine(B.scalar_mul((g[0], g[1], K.one), 7654321, K), K)
    ops = CountingOps(ncoords)
    s = L.madd(ops, p, q)
    assert ops.n == RF.SPEC["group"]["madd"][str(ncoords)] == (11 if ncoords == 1 else 29)
    assert B.to_affine(s, K) == B.to_affine(B.scalar_mul((g[0], g[1], K.one), 1234567 + 7654321, K), K)
    ops.n = 0
    B.add(p, B.scalar_mul((g[0], g[1], K.one), 99, K), ops)
    assert ops.n == RF.SPEC["group"]["add"][str(ncoords)] == (16 if ncoords == 1 else 43)


def _simulate(k, c, lanes, nbits):
    """Bucket method by hand: count additions that combine two non-identity values."""
    ks = I.scalar_ints(k, range(k.shape[1]))
    nwin = (nbits + c) // c
    half = 1 << (c - 1)
    digits = []
    for v in ks:
        row, carry = [], 0
        for w in range(nwin):
            d = ((v >> (w * c)) & ((1 << c) - 1)) + carry
            carry = int(d > half)
            row.append(d - (1 << c) if carry else d)
        assert sum(d << (w * c) for w, d in enumerate(row)) == v
        digits.append(row)
    mixed = general = 0
    for w in range(nwin):
        for lane in range(lanes):
            occupied = {}
            for i in range(lane, len(ks), lanes):
                b = abs(digits[i][w])
                if b:
                    mixed += b in occupied
                    occupied[b] = True
            running = total = False
            for b in range(half, 0, -1):
                if b in occupied:
                    general += running
                    running = True
                if running:
                    general += total
                    total = True
    return mixed, general


@pytest.mark.parametrize("c,lanes,n", [(6, 4, 64), (5, 2, 30), (4, 8, 8)])
def test_bucket_work_against_a_plain_simulation(c, lanes, n):
    k = I.scalars(n, np.random.default_rng(c * 100 + n), n_zero=1, n_top=1)
    assert RF.bucket_work(k, c, lanes, 254) == _simulate(k, c, lanes, 254)


def test_least_time_and_the_peak():
    p = RF.PEAK
    assert p["int32_ops_per_s"] == p["sms"] * p["int32_lanes_per_sm"] * p["boost_clock_hz"]
    assert RF.SPEC["instructions_per_product"] == 38 + 8
    assert RF.least_seconds(1e9, 0) == pytest.approx(1e9 * 46 / 16.72704e12)
    assert RF.least_seconds(0, 3.35e12) == pytest.approx(1.0)
