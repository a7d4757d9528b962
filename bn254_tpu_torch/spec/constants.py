"""BN254 (alt_bn128) curve constants.

All values are plain Python integers (canonical residues, NOT Montgomery form).
Derived constants (Frobenius coefficient tables, twist factors, G2 curve
coefficient) are *computed* here from the primitive curve parameters rather
than transcribed, and are validated against the reference crate's golden test
vectors in tests/.

Reference parity: src/fields/fp.rs:166-222 (moduli),
src/groups/mod.rs:9-14 (ate NAF schedule), :372-472 (curve
params), src/fields/fq2.rs:19-34 (xi), fq6.rs:5-90 and
fq12.rs:6-48 (Frobenius tables), mod.rs:516-564 (twist constants).
"""

# Base field modulus q and scalar field (group order) r.
Q = 21888242871839275222246405745257275088696311157297823662689037894645226208583
R = 21888242871839275222246405745257275088548364400416034343698204186575808495617

# BN parameter z: q = 36 z^4 + 36 z^3 + 24 z^2 + 6 z + 1.
Z = 4965661367192848881
ATE_LOOP_COUNT = 6 * Z + 2  # 0x19d797039be763ba8

# Signed-digit schedule for the optimal-ate Miller loop, MSB-first with the
# leading 1 skipped.  This exact (non-canonical) recoding is an algorithm
# constant: it fixes the doubling/addition step schedule and hence the
# 87-entry line-coefficient layout.  (reference: groups/mod.rs:14)
ATE_NAF = [1, 0, 1, 0, 0, 0, -1, 0, -1, 0, 0, 0, -1, 0, 1, 0, -1, 0, 0, -1,
           0, 0, 0, 0, 0, 1, 0, 0, -1, 0, 1, 0, 0, -1, 0, 0, 0, 0, -1, 0,
           1, 0, 0, 0, -1, 0, -1, 0, 0, 1, 0, 0, 0, -1, 0, 0, -1, 0, 1, 0,
           1, 0, 0, 0]

_expected = 0
for _d in [1] + ATE_NAF:
    _expected = _expected * 2 + _d
assert _expected == ATE_LOOP_COUNT

# Number of line-evaluation coefficient triples produced by the G2 precompute:
# one per schedule digit, one extra per nonzero digit, plus the two final
# Frobenius addition steps.  (reference: groups/mod.rs:701-728, test :891)
N_COEFFS = len(ATE_NAF) + sum(1 for d in ATE_NAF if d != 0) + 2
assert N_COEFFS == 87

# --- Fq2 = Fq[i]/(i^2 + 1) ------------------------------------------------
# Quadratic non-residue used to build Fq2 is -1; the sextic twist is defined
# by xi = 9 + i.  (reference: fq2.rs:7-34)
FQ_NON_RESIDUE = Q - 1
XI = (9, 1)


def _fq2_mul(a, b):
    a0, a1 = a
    b0, b1 = b
    return ((a0 * b0 - a1 * b1) % Q, (a0 * b1 + a1 * b0) % Q)


def _fq2_pow(a, e):
    res = (1, 0)
    while e:
        if e & 1:
            res = _fq2_mul(res, a)
        a = _fq2_mul(a, a)
        e >>= 1
    return res


# --- Frobenius coefficient tables ------------------------------------------
# Fq6 = Fq2[v]/(v^3 - xi):  frob^n(v) = xi^((q^n-1)/3) * v.
# Fq12 = Fq6[w]/(w^2 - v):  frob^n(w) = xi^((q^n-1)/6) * w.
# Only powers 0..3 are ever used by the pairing.  (fq6.rs:5-90, fq12.rs:6-48)
FROB6_C1 = tuple(_fq2_pow(XI, (Q ** n - 1) // 3) for n in range(4))
FROB6_C2 = tuple(_fq2_pow(XI, 2 * (Q ** n - 1) // 3) for n in range(4))
FROB12_C1 = tuple(_fq2_pow(XI, (Q ** n - 1) // 6) for n in range(4))

# Twist Frobenius factors used by AffineG2::mul_by_q (groups/mod.rs:531-564):
# untwisting, applying Frobenius, re-twisting scales x by xi^((q-1)/3) and
# y by xi^((q-1)/2).
TWIST_MUL_BY_Q_X = _fq2_pow(XI, (Q - 1) // 3)
TWIST_MUL_BY_Q_Y = _fq2_pow(XI, (Q - 1) // 2)

# --- Curve parameters -------------------------------------------------------
# G1: y^2 = x^3 + 3 over Fq, generator (1, 2).  (groups/mod.rs:372-402)
B1 = 3
G1_ONE = (1, 2)

# G2: y^2 = x^3 + b2 over Fq2 with b2 = 3 / xi (the D-type sextic twist).
# Generator from groups/mod.rs:408-450 (decimal form in mod.rs:1008-1020).
_xi_inv = _fq2_pow(XI, Q * Q - 2)
B2 = _fq2_mul((3, 0), _xi_inv)
G2_ONE = (
    (10857046999023057135944570762232829481370756359578518086990519993285655852781,
     11559732032986387107991004021392285783925812861821192530917403151452391805634),
    (8495653923123431417604973247489272438418190587263600148770280649306958101930,
     4082367875863433681332203403145435568316851327593401208105741076214120093531),
)

# Montgomery-domain constants (R = 2^256), matching the reference's internal
# representation (fp.rs:166-222).  The device path stores limbs of values in
# this domain; the spec stores canonical ints and only uses these at the
# boundary.
MONT_R = (1 << 256) % Q
MONT_R2 = (MONT_R * MONT_R) % Q
MONT_R3 = (MONT_R2 * MONT_R) % Q
MONT_R_FR = (1 << 256) % R
MONT_R2_FR = (MONT_R_FR * MONT_R_FR) % R

# sqrt exponents for q ≡ 3 (mod 4)  (fp.rs:224-243)
FQ_MINUS3_DIV4 = (Q - 3) // 4
FQ_MINUS1_DIV2 = (Q - 1) // 2
