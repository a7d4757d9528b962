"""Pure-Python (arbitrary-precision int) implementation of the BN254 field
tower.  This is the bit-exactness oracle for the JAX/Pallas device path and
the host-side scalar engine behind the public API.

Representation: Fq/Fr are canonical ints in [0, modulus); Fq2 is a pair
(c0, c1); Fq6 a triple of Fq2; Fq12 a pair of Fq6.  All formulas match the
reference crate's algebra (see file:line citations) but are written directly
over ints — no Montgomery form is needed at this layer because Python ints
are exact.

Reference parity: src/fields/{fp.rs,fq2.rs,fq6.rs,fq12.rs}.
"""

from .constants import (
    Q, R, XI, FROB6_C1, FROB6_C2, FROB12_C1, FQ_MINUS3_DIV4, FQ_MINUS1_DIV2, Z,
)

# --------------------------------------------------------------------------
# Fq / Fr (prime fields)
# --------------------------------------------------------------------------

def fp_inv(a, p):
    """Modular inverse; returns None for 0 (reference: fp.rs:108-117)."""
    if a % p == 0:
        return None
    return pow(a, p - 2, p)


def fq_sqrt(a):
    """Square root in Fq (q ≡ 3 mod 4); None if non-residue.

    Mirrors fp.rs:246-259: a1 = a^((q-3)/4); candidate a1*a; Euler check.
    """
    a %= Q
    a1 = pow(a, FQ_MINUS3_DIV4, Q)
    a1a = a1 * a % Q
    a0 = a1 * a1a % Q  # == a^((q-1)/2)
    if a0 == Q - 1:
        return None
    return a1a


def fq_from_str(s):
    """Decimal parse, reducing mod q on the fly (fp.rs:23-43)."""
    if not s or any(c not in "0123456789" for c in s):
        return None
    return int(s) % Q


def fr_from_str(s):
    if not s or any(c not in "0123456789" for c in s):
        return None
    return int(s) % R


# --------------------------------------------------------------------------
# Fq2 = Fq[i]/(i^2+1)
# --------------------------------------------------------------------------

FQ2_ZERO = (0, 0)
FQ2_ONE = (1, 0)
FQ2_I = (0, 1)


def fq2_add(a, b):
    return ((a[0] + b[0]) % Q, (a[1] + b[1]) % Q)


def fq2_sub(a, b):
    return ((a[0] - b[0]) % Q, (a[1] - b[1]) % Q)


def fq2_neg(a):
    return (-a[0] % Q, -a[1] % Q)


def fq2_scale(a, k):
    return (a[0] * k % Q, a[1] * k % Q)


def fq2_mul(a, b):
    # Karatsuba with i^2 = -1  (fq2.rs:133-149)
    aa = a[0] * b[0] % Q
    bb = a[1] * b[1] % Q
    return ((aa - bb) % Q, ((a[0] + a[1]) * (b[0] + b[1]) - aa - bb) % Q)


def fq2_sqr(a):
    # complex squaring (fq2.rs:105-117)
    ab = a[0] * a[1] % Q
    return ((a[0] + a[1]) * (a[0] - a[1]) % Q, (ab + ab) % Q)


def fq2_mul_by_nonresidue(a):
    # multiply by xi = 9 + i  (fq2.rs:55)
    return fq2_mul(a, XI)


def fq2_inv(a):
    # norm-based inversion (fq2.rs:119-130); None for 0
    t = fp_inv((a[0] * a[0] + a[1] * a[1]) % Q, Q)
    if t is None:
        return None
    return (a[0] * t % Q, -a[1] * t % Q)


def fq2_frob(a, power):
    # conjugation for odd powers (fq2.rs:59-68)
    if power % 2 == 0:
        return a
    return (a[0], -a[1] % Q)


def fq2_pow(a, e):
    res = FQ2_ONE
    while e:
        if e & 1:
            res = fq2_mul(res, a)
        a = fq2_sqr(a)
        e >>= 1
    return res


def fq2_to_u512(a):
    """Pack as c1*q + c0 (fq2.rs:226-232)."""
    return a[1] * Q + a[0]


def fq2_sqrt(a):
    """Complex-method sqrt (fq2.rs:208-224); None if non-residue."""
    a1 = fq2_pow(a, FQ_MINUS3_DIV4)
    a1a = fq2_mul(a1, a)
    alpha = fq2_mul(a1, a1a)
    a0 = fq2_mul(fq2_pow(alpha, Q), alpha)
    neg_one = (Q - 1, 0)
    if a0 == neg_one:
        return None
    if alpha == neg_one:
        return fq2_mul(FQ2_I, a1a)
    b = fq2_pow(fq2_add(alpha, FQ2_ONE), FQ_MINUS1_DIV2)
    return fq2_mul(b, a1a)


# --------------------------------------------------------------------------
# Fq6 = Fq2[v]/(v^3 - xi), elements (c0, c1, c2)
# --------------------------------------------------------------------------

FQ6_ZERO = (FQ2_ZERO, FQ2_ZERO, FQ2_ZERO)
FQ6_ONE = (FQ2_ONE, FQ2_ZERO, FQ2_ZERO)


def fq6_add(a, b):
    return tuple(fq2_add(x, y) for x, y in zip(a, b))


def fq6_sub(a, b):
    return tuple(fq2_sub(x, y) for x, y in zip(a, b))


def fq6_neg(a):
    return tuple(fq2_neg(x) for x in a)


def fq6_scale(a, k2):
    return tuple(fq2_mul(x, k2) for x in a)


def fq6_mul_by_nonresidue(a):
    # v * (c0 + c1 v + c2 v^2) = xi c2 + c0 v + c1 v^2  (fq6.rs:109-115)
    return (fq2_mul_by_nonresidue(a[2]), a[0], a[1])


def fq6_mul(a, b):
    # Toom/Karatsuba (Devegili et al.)  (fq6.rs:194-208)
    a_a = fq2_mul(a[0], b[0])
    b_b = fq2_mul(a[1], b[1])
    c_c = fq2_mul(a[2], b[2])
    c0 = fq2_add(fq2_mul_by_nonresidue(
        fq2_sub(fq2_sub(fq2_mul(fq2_add(a[1], a[2]), fq2_add(b[1], b[2])), b_b), c_c)), a_a)
    c1 = fq2_add(fq2_sub(fq2_sub(fq2_mul(fq2_add(a[0], a[1]), fq2_add(b[0], b[1])), a_a), b_b),
                 fq2_mul_by_nonresidue(c_c))
    c2 = fq2_sub(fq2_add(fq2_sub(fq2_mul(fq2_add(a[0], a[2]), fq2_add(b[0], b[2])), a_a), b_b), c_c)
    return (c0, c1, c2)


def fq6_sqr(a):
    # CH-SQR2 (fq6.rs:163-177)
    s0 = fq2_sqr(a[0])
    ab = fq2_mul(a[0], a[1])
    s1 = fq2_add(ab, ab)
    s2 = fq2_sqr(fq2_add(fq2_sub(a[0], a[1]), a[2]))
    bc = fq2_mul(a[1], a[2])
    s3 = fq2_add(bc, bc)
    s4 = fq2_sqr(a[2])
    return (
        fq2_add(s0, fq2_mul_by_nonresidue(s3)),
        fq2_add(s1, fq2_mul_by_nonresidue(s4)),
        fq2_sub(fq2_sub(fq2_add(fq2_add(s1, s2), s3), s0), s4),
    )


def fq6_inv(a):
    # (fq6.rs:179-192)
    c0 = fq2_sub(fq2_sqr(a[0]), fq2_mul(a[1], fq2_mul_by_nonresidue(a[2])))
    c1 = fq2_sub(fq2_mul_by_nonresidue(fq2_sqr(a[2])), fq2_mul(a[0], a[1]))
    c2 = fq2_sub(fq2_sqr(a[1]), fq2_mul(a[0], a[2]))
    t = fq2_inv(fq2_add(
        fq2_mul_by_nonresidue(fq2_add(fq2_mul(a[2], c1), fq2_mul(a[1], c2))),
        fq2_mul(a[0], c0)))
    if t is None:
        return None
    return (fq2_mul(t, c0), fq2_mul(t, c1), fq2_mul(t, c2))


def fq6_frob(a, power):
    # (fq6.rs:125-131)
    return (
        fq2_frob(a[0], power),
        fq2_mul(fq2_frob(a[1], power), FROB6_C1[power % 6]),
        fq2_mul(fq2_frob(a[2], power), FROB6_C2[power % 6]),
    )


# --------------------------------------------------------------------------
# Fq12 = Fq6[w]/(w^2 - v), elements (c0, c1)
# --------------------------------------------------------------------------

FQ12_ZERO = (FQ6_ZERO, FQ6_ZERO)
FQ12_ONE = (FQ6_ONE, FQ6_ZERO)


def fq12_add(a, b):
    return (fq6_add(a[0], b[0]), fq6_add(a[1], b[1]))


def fq12_sub(a, b):
    return (fq6_sub(a[0], b[0]), fq6_sub(a[1], b[1]))


def fq12_neg(a):
    return (fq6_neg(a[0]), fq6_neg(a[1]))


def fq12_mul(a, b):
    # Karatsuba over Fq6 (fq12.rs:316-328)
    aa = fq6_mul(a[0], b[0])
    bb = fq6_mul(a[1], b[1])
    return (
        fq6_add(fq6_mul_by_nonresidue(bb), aa),
        fq6_sub(fq6_sub(fq6_mul(fq6_add(a[0], a[1]), fq6_add(b[0], b[1])), aa), bb),
    )


def fq12_sqr(a):
    # (fq12.rs:295-303)
    ab = fq6_mul(a[0], a[1])
    return (
        fq6_sub(fq6_sub(fq6_mul(fq6_add(fq6_mul_by_nonresidue(a[1]), a[0]),
                                fq6_add(a[0], a[1])), ab),
                fq6_mul_by_nonresidue(ab)),
        fq6_add(ab, ab),
    )


def fq12_inv(a):
    # (fq12.rs:305-313)
    t = fq6_inv(fq6_sub(fq6_sqr(a[0]), fq6_mul_by_nonresidue(fq6_sqr(a[1]))))
    if t is None:
        return None
    return (fq6_mul(a[0], t), fq6_neg(fq6_mul(a[1], t)))


def fq12_frob(a, power):
    # (fq12.rs:112-119)
    return (
        fq6_frob(a[0], power),
        fq6_scale(fq6_frob(a[1], power), FROB12_C1[power % 12]),
    )


def fq12_conj(a):
    """Unitary inverse (fq12.rs:126)."""
    return (a[0], fq6_neg(a[1]))


def fq12_pow(a, e):
    res = FQ12_ONE
    while e:
        if e & 1:
            res = fq12_mul(res, a)
        a = fq12_sqr(a)
        e >>= 1
    return res


def fq12_mul_by_024(a, ell_0, ell_vw, ell_vv):
    """Sparse multiplication by x0 + x2 v^2(?) line element — the hot op of
    the Miller loop; 13 Fq2 muls (fq12.rs:130-196)."""
    (z0, z1, z2), (z3, z4, z5) = a
    x0, x2, x4 = ell_0, ell_vv, ell_vw

    d0 = fq2_mul(z0, x0)
    d2 = fq2_mul(z2, x2)
    d4 = fq2_mul(z4, x4)
    t2 = fq2_add(z0, z4)
    t1 = fq2_add(z0, z2)
    s0 = fq2_add(fq2_add(z1, z3), z5)

    s1 = fq2_mul(z1, x2)
    t3 = fq2_add(s1, d4)
    t4 = fq2_add(fq2_mul_by_nonresidue(t3), d0)
    nz0 = t4

    t3 = fq2_mul(z5, x4)
    s1 = fq2_add(s1, t3)
    t3 = fq2_add(t3, d2)
    t4 = fq2_mul_by_nonresidue(t3)
    t3 = fq2_mul(z1, x0)
    s1 = fq2_add(s1, t3)
    t4 = fq2_add(t4, t3)
    nz1 = t4

    t0 = fq2_add(x0, x2)
    t3 = fq2_sub(fq2_sub(fq2_mul(t1, t0), d0), d2)
    t4 = fq2_mul(z3, x4)
    s1 = fq2_add(s1, t4)
    t3 = fq2_add(t3, t4)

    t0 = fq2_add(z2, z4)
    nz2 = t3

    t1 = fq2_add(x2, x4)
    t3 = fq2_sub(fq2_sub(fq2_mul(t0, t1), d2), d4)
    t4 = fq2_mul_by_nonresidue(t3)
    t3 = fq2_mul(z3, x0)
    s1 = fq2_add(s1, t3)
    t4 = fq2_add(t4, t3)
    nz3 = t4

    t3 = fq2_mul(z5, x2)
    s1 = fq2_add(s1, t3)
    t4 = fq2_mul_by_nonresidue(t3)
    t0 = fq2_add(x0, x4)
    t3 = fq2_sub(fq2_sub(fq2_mul(t2, t0), d0), d4)
    t4 = fq2_add(t4, t3)
    nz4 = t4

    t0 = fq2_add(fq2_add(x0, x2), x4)
    t3 = fq2_sub(fq2_mul(s0, t0), s1)
    nz5 = t3

    return ((nz0, nz1, nz2), (nz3, nz4, nz5))


def fq12_cyclotomic_sqr(a):
    """Granger–Scott squaring in the cyclotomic subgroup (fq12.rs:198-247)."""
    (z0, z4, z3), (z2, z1, z5) = a

    def _sq_pair(u, v):
        tmp = fq2_mul(u, v)
        t_a = fq2_sub(fq2_sub(
            fq2_mul(fq2_add(u, v), fq2_add(fq2_mul_by_nonresidue(v), u)), tmp),
            fq2_mul_by_nonresidue(tmp))
        t_b = fq2_add(tmp, tmp)
        return t_a, t_b

    t0, t1 = _sq_pair(z0, z1)
    t2, t3 = _sq_pair(z2, z3)
    t4, t5 = _sq_pair(z4, z5)

    def _tri(base, t, sub):
        x = fq2_sub(t, base) if sub else fq2_add(t, base)
        x = fq2_add(x, x)
        return fq2_add(x, t)

    nz0 = _tri(z0, t0, True)
    nz1 = _tri(z1, t1, False)
    tmp = fq2_mul_by_nonresidue(t5)
    nz2 = _tri(z2, tmp, False)
    nz3 = _tri(z3, t4, True)
    nz4 = _tri(z4, t2, True)
    nz5 = _tri(z5, t3, False)

    return ((nz0, nz4, nz3), (nz2, nz1, nz5))


def fq12_cyclotomic_pow(a, e):
    """Square-and-multiply with cyclotomic squarings (fq12.rs:249-267)."""
    res = FQ12_ONE
    found_one = False
    for i in reversed(range(e.bit_length())):
        if found_one:
            res = fq12_cyclotomic_sqr(res)
        if (e >> i) & 1:
            found_one = True
            res = fq12_mul(a, res)
    return res


def fq12_exp_by_neg_z(a):
    # (fq12.rs:121-124)
    return fq12_conj(fq12_cyclotomic_pow(a, Z))


def fq12_final_exponentiation(a):
    """Easy chunk + Scott et al. hard chunk (fq12.rs:62-110); None for
    non-invertible input."""
    inv = fq12_inv(a)
    if inv is None:
        return None
    c = fq12_mul(fq12_conj(a), inv)
    f = fq12_mul(fq12_frob(c, 2), c)

    a_ = fq12_exp_by_neg_z(f)
    b = fq12_cyclotomic_sqr(a_)
    c2 = fq12_cyclotomic_sqr(b)
    d = fq12_mul(c2, b)

    e = fq12_exp_by_neg_z(d)
    f2 = fq12_cyclotomic_sqr(e)
    g = fq12_exp_by_neg_z(f2)
    h = fq12_conj(d)
    i = fq12_conj(g)

    j = fq12_mul(i, e)
    k = fq12_mul(j, h)
    l = fq12_mul(k, b)
    m = fq12_mul(k, e)
    n = fq12_mul(f, m)

    o = fq12_frob(l, 1)
    p = fq12_mul(o, n)

    q = fq12_frob(k, 2)
    r = fq12_mul(q, p)

    s = fq12_conj(f)
    t = fq12_mul(s, l)
    u = fq12_frob(t, 3)
    v = fq12_mul(u, r)
    return v
