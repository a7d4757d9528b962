"""What the benchmark's reference expects, and how the program's outputs are read.

The benchmark makes every input point as a known multiple of a generator
(benchlib.inputs), so the plain reference knows each point's discrete log:

* a pairing of P = a G1 and Q = c G2 is g^(a c), with g = e(G1, G2) computed
  once by the reference's own Miller loop and final exponentiation
  (bn254.pairing), and a product of pairings is g^(sum of a c);
* an MSM sum_i k_i (a_i G) is (sum_i k_i a_i) G.

Field arithmetic is written once over a base-field object, so the same code
serves the reference (``CANON``: canonical residues) and the control
(``LAZY``: Montgomery residues kept in [0, 2q), the final subtraction of each
product skipped, as a lazy-reduction implementation would leave them).  The
program's outputs are Montgomery limbs; ``decode`` reads them and refuses a
residue that is not fully reduced, which is what the configuration
guarantees (bit-exact to the crate's fully reduced Montgomery form).
"""

from __future__ import annotations

import numpy as np

from . import bn254 as B

Q, R = B.Q, B.R
MONT = 1 << 256
MONT_INV = pow(MONT, Q - 2, Q)


class Canon:
    """Fq as canonical ints."""
    zero, one = 0, 1

    @staticmethod
    def add(a, b):
        return (a + b) % Q

    @staticmethod
    def sub(a, b):
        return (a - b) % Q

    @staticmethod
    def mul(a, b):
        return a * b % Q

    @staticmethod
    def enc(v):
        return v % Q


class Lazy:
    """Fq as Montgomery residues in [0, 2q): the control's arithmetic."""
    zero = 0
    one = MONT % Q
    _QINV = (-pow(Q, -1, MONT)) % MONT

    @staticmethod
    def add(a, b):
        s = a + b
        return s - 2 * Q if s >= 2 * Q else s

    @staticmethod
    def sub(a, b):
        d = a - b
        return d + 2 * Q if d < 0 else d

    @classmethod
    def mul(cls, a, b):                      # REDC without its final subtraction
        t = a * b
        m = (t * cls._QINV) % MONT
        return (t + m * Q) >> 256

    @staticmethod
    def enc(v):
        return v * MONT % Q


CANON, LAZY = Canon, Lazy


class Tower:
    """Fq2, Fq12 products and the Jacobian group law over a base field F,
    in the crate's formulas (fq2.rs:133-149, fq6.rs:194-208,
    fq12.rs:316-328, mod.rs:250-334)."""

    def __init__(self, F):
        self.F = F

    # Fq2
    def f2_add(self, a, b):
        F = self.F
        return (F.add(a[0], b[0]), F.add(a[1], b[1]))

    def f2_sub(self, a, b):
        F = self.F
        return (F.sub(a[0], b[0]), F.sub(a[1], b[1]))

    def f2_mul(self, a, b):
        F = self.F
        aa, bb = F.mul(a[0], b[0]), F.mul(a[1], b[1])
        return (F.sub(aa, bb), F.sub(F.sub(F.mul(F.add(a[0], a[1]), F.add(b[0], b[1])), aa), bb))

    def f2_xi(self, a):                      # a (9 + u)
        F = self.F
        x8 = [a[0], a[1]]
        for _ in range(3):
            x8 = [F.add(x8[0], x8[0]), F.add(x8[1], x8[1])]
        return (F.sub(F.add(x8[0], a[0]), a[1]), F.add(F.add(x8[1], a[1]), a[0]))

    # Fq6, Fq12
    def f6_add(self, a, b):
        return tuple(self.f2_add(x, y) for x, y in zip(a, b))

    def f6_sub(self, a, b):
        return tuple(self.f2_sub(x, y) for x, y in zip(a, b))

    def f6_xi(self, a):
        return (self.f2_xi(a[2]), a[0], a[1])

    def f6_mul(self, a, b):
        m, ad, sb = self.f2_mul, self.f2_add, self.f2_sub
        a_a, b_b, c_c = m(a[0], b[0]), m(a[1], b[1]), m(a[2], b[2])
        c0 = ad(self.f2_xi(sb(sb(m(ad(a[1], a[2]), ad(b[1], b[2])), b_b), c_c)), a_a)
        c1 = ad(sb(sb(m(ad(a[0], a[1]), ad(b[0], b[1])), a_a), b_b), self.f2_xi(c_c))
        c2 = sb(ad(sb(m(ad(a[0], a[2]), ad(b[0], b[2])), a_a), b_b), c_c)
        return (c0, c1, c2)

    def f12_mul(self, a, b):
        aa, bb = self.f6_mul(a[0], b[0]), self.f6_mul(a[1], b[1])
        return (self.f6_add(self.f6_xi(bb), aa),
                self.f6_sub(self.f6_sub(self.f6_mul(self.f6_add(a[0], a[1]),
                                                    self.f6_add(b[0], b[1])), aa), bb))

    def f12_enc(self, a):
        return tuple(tuple((self.F.enc(x[0]), self.F.enc(x[1])) for x in f6) for f6 in a)

    # the group law over Fq (ncoords 1) or Fq2 (ncoords 2)
    def group_ops(self, ncoords: int):
        F = self.F
        if ncoords == 1:
            return _Ops(F.zero, F.one, F.add, F.sub, F.mul)
        return _Ops((F.zero, F.zero), (F.one, F.zero), self.f2_add, self.f2_sub, self.f2_mul)


class _Ops:
    def __init__(self, zero, one, add, sub, mul):
        self.zero, self.one, self.add, self.sub, self.mul = zero, one, add, sub, mul

    def sqr(self, a):
        return self.mul(a, a)


def scalar_mul(tower: Tower, ncoords: int, base_affine, k: int):
    """k * base (affine, canonical ints) in the tower's arithmetic, MSB-first
    double-and-add (mod.rs:272-292) -> Jacobian triple in that arithmetic."""
    K = tower.group_ops(ncoords)
    enc = tower.F.enc
    if ncoords == 1:
        p = (enc(base_affine[0]), enc(base_affine[1]), K.one)
    else:
        p = tuple((enc(c[0]), enc(c[1])) for c in base_affine) + (K.one,)
    res = (K.zero, K.one, K.zero)
    for i in reversed(range(k.bit_length())):
        res = B.double(res, K)
        if (k >> i) & 1:
            res = B.add(res, p, K)
    return res


class FixedBase:
    """g^s for many s < r with one table of g^(d 2^(6j)), in one tower's
    arithmetic (g given as canonical Fq12)."""
    BITS = 6

    def __init__(self, tower: Tower, g):
        self.t = tower
        one = tower.f12_enc(B.FQ12_ONE)
        self.one = one
        base = tower.f12_enc(g)
        self.table = []
        for _ in range((R.bit_length() + self.BITS - 1) // self.BITS):
            row = [one, base]
            for _ in range((1 << self.BITS) - 2):
                row.append(tower.f12_mul(row[-1], base))
            self.table.append(row)
            base = tower.f12_mul(row[-1], base)          # g^(2^(6(j+1)))

    def pow(self, s: int):
        s %= R
        acc = None
        for j, row in enumerate(self.table):
            d = (s >> (self.BITS * j)) & ((1 << self.BITS) - 1)
            if d:
                acc = row[d] if acc is None else self.t.f12_mul(acc, row[d])
        return self.one if acc is None else acc


# --------------------------------------------------------------------------
# Reading the program's outputs
# --------------------------------------------------------------------------

def limbs_to_ints(arr) -> list:
    """[16, n] 16-bit limbs (any integer dtype; little-endian limb order) ->
    n Python ints."""
    a = np.ascontiguousarray(np.asarray(arr).astype("<u2").T)
    raw = a.tobytes()
    return [int.from_bytes(raw[i:i + 32], "little") for i in range(0, len(raw), 32)]


def decode(m: int):
    """A Montgomery residue as the program holds it -> the canonical value,
    or None where it is not fully reduced (m >= q)."""
    return None if m >= Q else m * MONT_INV % Q


def fq12_from_flat(c):
    """12 coefficients, depth first -> the Fq12 tuple tree."""
    return tuple(tuple((c[6 * h + 2 * k], c[6 * h + 2 * k + 1]) for k in range(3))
                 for h in range(2))


def jacobian_to_affine(ncoords: int, coords):
    """Canonical Jacobian coordinates (flat: 3 for G1, 6 for G2) -> affine
    (x, y) in the reference's form, or None for the point at infinity."""
    if ncoords == 1:
        p, K = (coords[0], coords[1], coords[2]), B.FqOps
    else:
        p = ((coords[0], coords[1]), (coords[2], coords[3]), (coords[4], coords[5]))
        K = B.Fq2Ops
    return B.to_affine(p, K)


def gt_generator():
    """e(G1, G2) by the reference's own pairing."""
    g2 = (B.G2_ONE[0], B.G2_ONE[1], B.FQ2_ONE)
    return B.pairing((B.G1_ONE[0], B.G1_ONE[1], 1), g2)


def group_generator(ncoords: int):
    return B.G1_ONE if ncoords == 1 else B.G2_ONE
