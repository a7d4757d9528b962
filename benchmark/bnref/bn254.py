"""BN254 (alt_bn128) in plain Python ints: the benchmark's frozen reference.

A trimmed, frozen copy of the pure-int oracle of the crate `substrate-bn`
0.6 (fields `src/fields/{fp,fq2,fq6,fq12}.rs`, groups and pairing
`src/groups/mod.rs`), kept inside the benchmark so that no change to the
measured program can move it.  It imports nothing but the standard library.

Representation: Fq values are canonical ints in [0, q); Fq2 a pair (c0, c1);
Fq6 a triple of Fq2; Fq12 a pair of Fq6; a point a Jacobian triple
(x, y, z) with z = 0 for the point at infinity.
"""

Q = 21888242871839275222246405745257275088696311157297823662689037894645226208583
R = 21888242871839275222246405745257275088548364400416034343698204186575808495617
Z = 4965661367192848881                      # the BN parameter (fq12.rs:122)

# The optimal-ate loop's signed digits, MSB first, leading 1 skipped (mod.rs:14)
ATE_NAF = (1, 0, 1, 0, 0, 0, -1, 0, -1, 0, 0, 0, -1, 0, 1, 0, -1, 0, 0, -1,
           0, 0, 0, 0, 0, 1, 0, 0, -1, 0, 1, 0, 0, -1, 0, 0, 0, 0, -1, 0,
           1, 0, 0, 0, -1, 0, -1, 0, 0, 1, 0, 0, 0, -1, 0, 0, -1, 0, 1, 0,
           1, 0, 0, 0)
XI = (9, 1)                                  # Fq6 = Fq2[v]/(v^3 - xi) (fq2.rs:34)


def _fq2_mul_raw(a, b):
    return ((a[0] * b[0] - a[1] * b[1]) % Q, (a[0] * b[1] + a[1] * b[0]) % Q)


def _fq2_pow_raw(a, e):
    res = (1, 0)
    while e:
        if e & 1:
            res = _fq2_mul_raw(res, a)
        a = _fq2_mul_raw(a, a)
        e >>= 1
    return res


# Frobenius tables (fq6.rs:5-90, fq12.rs:6-48) and twist factors (mod.rs:531-564)
FROB6_C1 = tuple(_fq2_pow_raw(XI, (Q ** n - 1) // 3) for n in range(4))
FROB6_C2 = tuple(_fq2_pow_raw(XI, 2 * (Q ** n - 1) // 3) for n in range(4))
FROB12_C1 = tuple(_fq2_pow_raw(XI, (Q ** n - 1) // 6) for n in range(4))
TWIST_X = _fq2_pow_raw(XI, (Q - 1) // 3)
TWIST_Y = _fq2_pow_raw(XI, (Q - 1) // 2)

# Curves (mod.rs:372-472): G1 y^2 = x^3 + 3, G2 y^2 = x^3 + 3/xi
B1 = 3
B2 = _fq2_mul_raw((3, 0), _fq2_pow_raw(XI, Q * Q - 2))
G1_ONE = (1, 2)
G2_ONE = (
    (10857046999023057135944570762232829481370756359578518086990519993285655852781,
     11559732032986387107991004021392285783925812861821192530917403151452391805634),
    (8495653923123431417604973247489272438418190587263600148770280649306958101930,
     4082367875863433681332203403145435568316851327593401208105741076214120093531),
)
TWO_INV = pow(2, Q - 2, Q)

# --------------------------------------------------------------------------
# Fq2
# --------------------------------------------------------------------------

FQ2_ZERO, FQ2_ONE = (0, 0), (1, 0)


def fq2_add(a, b):
    return ((a[0] + b[0]) % Q, (a[1] + b[1]) % Q)


def fq2_sub(a, b):
    return ((a[0] - b[0]) % Q, (a[1] - b[1]) % Q)


def fq2_neg(a):
    return (-a[0] % Q, -a[1] % Q)


def fq2_scale(a, k):
    return (a[0] * k % Q, a[1] * k % Q)


def fq2_mul(a, b):                           # Karatsuba (fq2.rs:133-149)
    aa = a[0] * b[0] % Q
    bb = a[1] * b[1] % Q
    return ((aa - bb) % Q, ((a[0] + a[1]) * (b[0] + b[1]) - aa - bb) % Q)


def fq2_sqr(a):                              # complex squaring (fq2.rs:105-117)
    ab = a[0] * a[1] % Q
    return ((a[0] + a[1]) * (a[0] - a[1]) % Q, (ab + ab) % Q)


def fq2_xi(a):                               # a * (9 + u) (fq2.rs:55)
    return ((9 * a[0] - a[1]) % Q, (a[0] + 9 * a[1]) % Q)


def fq2_inv(a):                              # fq2.rs:119-130
    t = pow((a[0] * a[0] + a[1] * a[1]) % Q, Q - 2, Q)
    return (a[0] * t % Q, -a[1] * t % Q)


def fq2_conj(a):
    return (a[0], -a[1] % Q)


# --------------------------------------------------------------------------
# Fq6, Fq12
# --------------------------------------------------------------------------

FQ6_ZERO = (FQ2_ZERO, FQ2_ZERO, FQ2_ZERO)
FQ6_ONE = (FQ2_ONE, FQ2_ZERO, FQ2_ZERO)
FQ12_ONE = (FQ6_ONE, FQ6_ZERO)


def fq6_add(a, b):
    return (fq2_add(a[0], b[0]), fq2_add(a[1], b[1]), fq2_add(a[2], b[2]))


def fq6_sub(a, b):
    return (fq2_sub(a[0], b[0]), fq2_sub(a[1], b[1]), fq2_sub(a[2], b[2]))


def fq6_neg(a):
    return (fq2_neg(a[0]), fq2_neg(a[1]), fq2_neg(a[2]))


def fq6_xi(a):                               # v * a (fq6.rs:109-115)
    return (fq2_xi(a[2]), a[0], a[1])


def fq6_mul(a, b):                           # fq6.rs:194-208
    a_a = fq2_mul(a[0], b[0])
    b_b = fq2_mul(a[1], b[1])
    c_c = fq2_mul(a[2], b[2])
    c0 = fq2_add(fq2_xi(fq2_sub(fq2_sub(
        fq2_mul(fq2_add(a[1], a[2]), fq2_add(b[1], b[2])), b_b), c_c)), a_a)
    c1 = fq2_add(fq2_sub(fq2_sub(
        fq2_mul(fq2_add(a[0], a[1]), fq2_add(b[0], b[1])), a_a), b_b), fq2_xi(c_c))
    c2 = fq2_sub(fq2_add(fq2_sub(
        fq2_mul(fq2_add(a[0], a[2]), fq2_add(b[0], b[2])), a_a), b_b), c_c)
    return (c0, c1, c2)


def fq6_sqr(a):                              # CH-SQR2 (fq6.rs:163-177)
    s0 = fq2_sqr(a[0])
    ab = fq2_mul(a[0], a[1])
    s1 = fq2_add(ab, ab)
    s2 = fq2_sqr(fq2_add(fq2_sub(a[0], a[1]), a[2]))
    bc = fq2_mul(a[1], a[2])
    s3 = fq2_add(bc, bc)
    s4 = fq2_sqr(a[2])
    return (fq2_add(s0, fq2_xi(s3)), fq2_add(s1, fq2_xi(s4)),
            fq2_sub(fq2_sub(fq2_add(fq2_add(s1, s2), s3), s0), s4))


def fq6_inv(a):                              # fq6.rs:179-192
    c0 = fq2_sub(fq2_sqr(a[0]), fq2_mul(a[1], fq2_xi(a[2])))
    c1 = fq2_sub(fq2_xi(fq2_sqr(a[2])), fq2_mul(a[0], a[1]))
    c2 = fq2_sub(fq2_sqr(a[1]), fq2_mul(a[0], a[2]))
    t = fq2_inv(fq2_add(fq2_xi(fq2_add(fq2_mul(a[2], c1), fq2_mul(a[1], c2))),
                        fq2_mul(a[0], c0)))
    return (fq2_mul(t, c0), fq2_mul(t, c1), fq2_mul(t, c2))


def fq6_frob(a, p):                          # fq6.rs:125-131
    conj = fq2_conj if p % 2 else (lambda x: x)
    return (conj(a[0]), fq2_mul(conj(a[1]), FROB6_C1[p]), fq2_mul(conj(a[2]), FROB6_C2[p]))


def fq12_mul(a, b):                          # fq12.rs:316-328
    aa = fq6_mul(a[0], b[0])
    bb = fq6_mul(a[1], b[1])
    return (fq6_add(fq6_xi(bb), aa),
            fq6_sub(fq6_sub(fq6_mul(fq6_add(a[0], a[1]), fq6_add(b[0], b[1])), aa), bb))


def fq12_sqr(a):                             # fq12.rs:295-303
    ab = fq6_mul(a[0], a[1])
    return (fq6_sub(fq6_sub(fq6_mul(fq6_add(fq6_xi(a[1]), a[0]), fq6_add(a[0], a[1])), ab),
                    fq6_xi(ab)),
            fq6_add(ab, ab))


def fq12_inv(a):                             # fq12.rs:305-313
    t = fq6_inv(fq6_sub(fq6_sqr(a[0]), fq6_xi(fq6_sqr(a[1]))))
    return (fq6_mul(a[0], t), fq6_neg(fq6_mul(a[1], t)))


def fq12_frob(a, p):                         # fq12.rs:112-119
    c1 = fq6_frob(a[1], p)
    return (fq6_frob(a[0], p), tuple(fq2_mul(x, FROB12_C1[p]) for x in c1))


def fq12_conj(a):                            # fq12.rs:126
    return (a[0], fq6_neg(a[1]))


def fq12_mul_by_024(a, x0, x4, x2):
    """The sparse product by a line (fq12.rs:130-196), 13 Fq2 products; the
    crate passes x0 = ell_0, x4 = ell_vw * y_P, x2 = ell_vv * x_P."""
    (z0, z1, z2), (z3, z4, z5) = a
    d0, d2, d4 = fq2_mul(z0, x0), fq2_mul(z2, x2), fq2_mul(z4, x4)
    t2, t1 = fq2_add(z0, z4), fq2_add(z0, z2)
    s0 = fq2_add(fq2_add(z1, z3), z5)
    s1 = fq2_mul(z1, x2)
    n0 = fq2_add(fq2_xi(fq2_add(s1, d4)), d0)
    t3 = fq2_mul(z5, x4)
    s1 = fq2_add(s1, t3)
    t4 = fq2_xi(fq2_add(t3, d2))
    t3 = fq2_mul(z1, x0)
    s1 = fq2_add(s1, t3)
    n1 = fq2_add(t4, t3)
    t3 = fq2_sub(fq2_sub(fq2_mul(t1, fq2_add(x0, x2)), d0), d2)
    t4 = fq2_mul(z3, x4)
    s1 = fq2_add(s1, t4)
    n2 = fq2_add(t3, t4)
    t3 = fq2_sub(fq2_sub(fq2_mul(fq2_add(z2, z4), fq2_add(x2, x4)), d2), d4)
    t4 = fq2_xi(t3)
    t3 = fq2_mul(z3, x0)
    s1 = fq2_add(s1, t3)
    n3 = fq2_add(t4, t3)
    t3 = fq2_mul(z5, x2)
    s1 = fq2_add(s1, t3)
    t4 = fq2_xi(t3)
    n4 = fq2_add(t4, fq2_sub(fq2_sub(fq2_mul(t2, fq2_add(x0, x4)), d0), d4))
    n5 = fq2_sub(fq2_mul(s0, fq2_add(fq2_add(x0, x2), x4)), s1)
    return ((n0, n1, n2), (n3, n4, n5))


def fq12_cyc_sqr(a):                         # Granger-Scott (fq12.rs:198-247)
    (z0, z4, z3), (z2, z1, z5) = a

    def pair(u, v):
        t = fq2_mul(u, v)
        return (fq2_sub(fq2_sub(fq2_mul(fq2_add(u, v), fq2_add(fq2_xi(v), u)), t), fq2_xi(t)),
                fq2_add(t, t))

    def tri(base, t, sub):
        x = fq2_sub(t, base) if sub else fq2_add(t, base)
        return fq2_add(fq2_add(x, x), t)

    t0, t1 = pair(z0, z1)
    t2, t3 = pair(z2, z3)
    t4, t5 = pair(z4, z5)
    return ((tri(z0, t0, True), tri(z4, t2, True), tri(z3, t4, True)),
            (tri(z2, fq2_xi(t5), False), tri(z1, t1, False), tri(z5, t3, False)))


def fq12_exp_by_neg_z(a):                    # fq12.rs:121-124, 249-267
    res, found = FQ12_ONE, False
    for i in reversed(range(Z.bit_length())):
        if found:
            res = fq12_cyc_sqr(res)
        if (Z >> i) & 1:
            found = True
            res = fq12_mul(a, res)
    return fq12_conj(res)


def fq12_final_exponentiation(a):            # fq12.rs:62-110
    c = fq12_mul(fq12_conj(a), fq12_inv(a))
    f = fq12_mul(fq12_frob(c, 2), c)
    a_ = fq12_exp_by_neg_z(f)
    b = fq12_cyc_sqr(a_)
    d = fq12_mul(fq12_cyc_sqr(b), b)
    e = fq12_exp_by_neg_z(d)
    g = fq12_exp_by_neg_z(fq12_cyc_sqr(e))
    k = fq12_mul(fq12_mul(fq12_conj(g), e), fq12_conj(d))
    l_ = fq12_mul(k, b)
    n = fq12_mul(f, fq12_mul(k, e))
    p = fq12_mul(fq12_frob(l_, 1), n)
    r = fq12_mul(fq12_frob(k, 2), p)
    return fq12_mul(fq12_frob(fq12_mul(fq12_conj(f), l_), 3), r)


# --------------------------------------------------------------------------
# Groups (mod.rs:229-334): one code for G1 (Fq) and G2 (Fq2)
# --------------------------------------------------------------------------

class FqOps:
    zero, one = 0, 1
    add = staticmethod(lambda a, b: (a + b) % Q)
    sub = staticmethod(lambda a, b: (a - b) % Q)
    mul = staticmethod(lambda a, b: a * b % Q)
    sqr = staticmethod(lambda a: a * a % Q)
    inv = staticmethod(lambda a: pow(a, Q - 2, Q))


class Fq2Ops:
    zero, one = FQ2_ZERO, FQ2_ONE
    add = staticmethod(fq2_add)
    sub = staticmethod(fq2_sub)
    mul = staticmethod(fq2_mul)
    sqr = staticmethod(fq2_sqr)
    inv = staticmethod(fq2_inv)


G1 = (FqOps, G1_ONE)
G2 = (Fq2Ops, G2_ONE)


def double(p, K):                            # mod.rs:250-269
    x, y, z = p
    a, b = K.sqr(x), K.sqr(y)
    c = K.sqr(b)
    d = K.sub(K.sub(K.sqr(K.add(x, b)), a), c)
    d = K.add(d, d)
    e = K.add(K.add(a, a), a)
    x3 = K.sub(K.sqr(e), K.add(d, d))
    c8 = K.add(c, c)
    c8 = K.add(c8, c8)
    c8 = K.add(c8, c8)
    yz = K.mul(y, z)
    return (x3, K.sub(K.mul(e, K.sub(d, x3)), c8), K.add(yz, yz))


def add(p, q, K):                            # mod.rs:294-334
    if p[2] == K.zero:
        return q
    if q[2] == K.zero:
        return p
    z1s, z2s = K.sqr(p[2]), K.sqr(q[2])
    u1, u2 = K.mul(p[0], z2s), K.mul(q[0], z1s)
    s1 = K.mul(p[1], K.mul(q[2], z2s))
    s2 = K.mul(q[1], K.mul(p[2], z1s))
    if u1 == u2 and s1 == s2:
        return double(p, K)
    h = K.sub(u2, u1)
    rr = K.add(K.sub(s2, s1), K.sub(s2, s1))
    i = K.sqr(K.add(h, h))
    j = K.mul(h, i)
    v = K.mul(u1, i)
    s1j = K.mul(s1, j)
    x3 = K.sub(K.sub(K.sqr(rr), j), K.add(v, v))
    y3 = K.sub(K.mul(rr, K.sub(v, x3)), K.add(s1j, s1j))
    z3 = K.mul(K.sub(K.sub(K.sqr(K.add(p[2], q[2])), z1s), z2s), h)
    return (x3, y3, z3)


def scalar_mul(p, k, K):                     # mod.rs:272-292
    res = (K.zero, K.one, K.zero)
    for i in reversed(range((k % R).bit_length())):
        res = double(res, K)
        if (k % R >> i) & 1:
            res = add(res, p, K)
    return res


def to_affine(p, K):
    """(x, y), or None for the point at infinity (mod.rs:198-217)."""
    if p[2] == K.zero:
        return None
    zi = K.inv(p[2])
    zi2 = K.sqr(zi)
    return (K.mul(p[0], zi2), K.mul(p[1], K.mul(zi2, zi)))


# --------------------------------------------------------------------------
# The optimal-ate pairing (mod.rs:580-606, 701-776, 894-902)
# --------------------------------------------------------------------------

def _doubling_step(r):                       # mod.rs:754-776
    x, y, z = r
    a = fq2_scale(fq2_mul(x, y), TWO_INV)
    b, c = fq2_sqr(y), fq2_sqr(z)
    e = fq2_mul(B2, fq2_add(fq2_add(c, c), c))
    f = fq2_add(fq2_add(e, e), e)
    g = fq2_scale(fq2_add(b, f), TWO_INV)
    h = fq2_sub(fq2_sqr(fq2_add(y, z)), fq2_add(b, c))
    j = fq2_sqr(x)
    e2 = fq2_sqr(e)
    r2 = (fq2_mul(a, fq2_sub(b, f)), fq2_sub(fq2_sqr(g), fq2_add(fq2_add(e2, e2), e2)),
          fq2_mul(b, h))
    return r2, (fq2_xi(fq2_sub(e, b)), fq2_neg(h), fq2_add(fq2_add(j, j), j))


def _addition_step(r, base):                 # mod.rs:731-752
    x, y, z = r
    bx, by = base
    d = fq2_sub(x, fq2_mul(z, bx))
    e = fq2_sub(y, fq2_mul(z, by))
    f, g = fq2_sqr(d), fq2_sqr(e)
    h, i = fq2_mul(d, f), fq2_mul(x, f)
    j = fq2_sub(fq2_add(fq2_mul(z, g), h), fq2_add(i, i))
    r2 = (fq2_mul(d, j), fq2_sub(fq2_mul(e, fq2_sub(i, j)), fq2_mul(h, y)), fq2_mul(z, h))
    return r2, (fq2_xi(fq2_sub(fq2_mul(e, bx), fq2_mul(d, by))), d, fq2_neg(e))


def _mul_by_q(pt):                           # mod.rs:693-699
    return (fq2_mul(TWIST_X, fq2_conj(pt[0])), fq2_mul(TWIST_Y, fq2_conj(pt[1])))


def miller_loop(pa, qa):
    """f of one pair, the 87 line steps folded as the crate's prepared loop
    does (mod.rs:580-606, 701-728)."""
    px, py = pa
    r = (qa[0], qa[1], FQ2_ONE)
    neg_q = (qa[0], fq2_neg(qa[1]))
    f = FQ12_ONE

    def fold(f, c):
        return fq12_mul_by_024(f, c[0], fq2_scale(c[1], py), fq2_scale(c[2], px))

    for d in ATE_NAF:
        r, c = _doubling_step(r)
        f = fold(fq12_sqr(f), c)
        if d:
            r, c = _addition_step(r, qa if d == 1 else neg_q)
            f = fold(f, c)
    q1 = _mul_by_q(qa)
    q2 = _mul_by_q(q1)
    r, c = _addition_step(r, q1)
    f = fold(f, c)
    r, c = _addition_step(r, (q2[0], fq2_neg(q2[1])))
    return fold(f, c)


def pairing(p, q):
    """The reduced pairing of Jacobian points; infinity in either slot gives
    the identity of GT (mod.rs:894-902)."""
    pa, qa = to_affine(p, FqOps), to_affine(q, Fq2Ops)
    if pa is None or qa is None:
        return FQ12_ONE
    return fq12_final_exponentiation(miller_loop(pa, qa))


def fq12_flat(a):
    """The 12 Fq coefficients in the order of the tuple tree, depth first."""
    return [c for fq6 in a for fq2 in fq6 for c in fq2]
