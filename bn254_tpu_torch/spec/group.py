"""Pure-Python BN254 group law and optimal-ate pairing engine (the oracle).

Points are Jacobian triples (x, y, z) of field elements; the field is
abstracted through a tiny op table so one implementation serves G1 (base Fq)
and G2 (base Fq2), mirroring the reference's generic G<P: GroupParams>
(src/groups/mod.rs:34-50) without its trait machinery.

Pairing engine parity: groups/mod.rs:515-777 (precompute + steps),
:580-640 (Miller loops), :894-926 (pairing/pairing_batch).
"""

from . import field as F
from .constants import (
    Q, R, B1, B2, G1_ONE, G2_ONE, ATE_NAF,
    TWIST_MUL_BY_Q_X, TWIST_MUL_BY_Q_Y, XI,
)


class FqOps:
    zero = 0
    one = 1
    add = staticmethod(lambda a, b: (a + b) % Q)
    sub = staticmethod(lambda a, b: (a - b) % Q)
    neg = staticmethod(lambda a: -a % Q)
    mul = staticmethod(lambda a, b: a * b % Q)
    sqr = staticmethod(lambda a: a * a % Q)
    inv = staticmethod(lambda a: F.fp_inv(a, Q))
    is_zero = staticmethod(lambda a: a == 0)


class Fq2Ops:
    zero = F.FQ2_ZERO
    one = F.FQ2_ONE
    add = staticmethod(F.fq2_add)
    sub = staticmethod(F.fq2_sub)
    neg = staticmethod(F.fq2_neg)
    mul = staticmethod(F.fq2_mul)
    sqr = staticmethod(F.fq2_sqr)
    inv = staticmethod(F.fq2_inv)
    is_zero = staticmethod(lambda a: a == F.FQ2_ZERO)


# Group parameter bundles: (field ops, generator, coeff b, check_order)
G1_PARAMS = (FqOps, G1_ONE, B1, False)
G2_PARAMS = (Fq2Ops, G2_ONE, B2, True)


def zero(K):
    """Point at infinity: (0, 1, 0) (mod.rs:229-236)."""
    return (K.zero, K.one, K.zero)


def is_zero(p, K):
    return K.is_zero(p[2])


def double(p, K):
    """dbl-2009-l-style Jacobian doubling (mod.rs:250-269)."""
    x, y, z = p
    a = K.sqr(x)
    b = K.sqr(y)
    c = K.sqr(b)
    d = K.sub(K.sub(K.sqr(K.add(x, b)), a), c)
    d = K.add(d, d)
    e = K.add(K.add(a, a), a)
    f = K.sqr(e)
    x3 = K.sub(f, K.add(d, d))
    ec = K.add(c, c)
    ec = K.add(ec, ec)
    ec = K.add(ec, ec)
    y1z1 = K.mul(y, z)
    return (x3, K.sub(K.mul(e, K.sub(d, x3)), ec), K.add(y1z1, y1z1))


def add(p, q, K):
    """Jacobian addition with the reference's zero/equal handling
    (mod.rs:294-334)."""
    if is_zero(p, K):
        return q
    if is_zero(q, K):
        return p
    z1s = K.sqr(p[2])
    z2s = K.sqr(q[2])
    u1 = K.mul(p[0], z2s)
    u2 = K.mul(q[0], z1s)
    z1c = K.mul(p[2], z1s)
    z2c = K.mul(q[2], z2s)
    s1 = K.mul(p[1], z2c)
    s2 = K.mul(q[1], z1c)
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


def neg(p, K):
    if is_zero(p, K):
        return p
    return (p[0], K.neg(p[1]), p[2])


def scalar_mul(p, k, K):
    """MSB-first double-and-add over the canonical scalar (mod.rs:272-292)."""
    res = zero(K)
    k %= R
    for i in reversed(range(k.bit_length())):
        res = double(res, K)
        if (k >> i) & 1:
            res = add(res, p, K)
    return res


def eq(p, q, K):
    """Projective equality (mod.rs:169-195)."""
    if is_zero(p, K):
        return is_zero(q, K)
    if is_zero(q, K):
        return False
    z1s = K.sqr(p[2])
    z2s = K.sqr(q[2])
    if K.mul(p[0], z2s) != K.mul(q[0], z1s):
        return False
    return K.mul(p[1], K.mul(z2s, q[2])) == K.mul(q[1], K.mul(z1s, p[2]))


def to_affine(p, K):
    """(x, y) or None for infinity; one field inversion (mod.rs:198-217)."""
    if is_zero(p, K):
        return None
    zinv = K.inv(p[2])
    zi2 = K.sqr(zinv)
    return (K.mul(p[0], zi2), K.mul(p[1], K.mul(zi2, zinv)))


def on_curve(x, y, b, K):
    return K.sqr(y) == K.add(K.mul(K.sqr(x), x), b)


def in_subgroup(x, y, K):
    """Order check used for G2 decode: p*(-1) + p == 0 under Fr scalar
    (mod.rs:104-107) — i.e. (r-1)·p + p is infinity."""
    p = (x, y, K.one)
    return is_zero(add(scalar_mul(p, R - 1, K), p, K), K)


# --------------------------------------------------------------------------
# Optimal-ate pairing
# --------------------------------------------------------------------------

TWO_INV = pow(2, Q - 2, Q)


def _mul_by_q(pt):
    """Frobenius endomorphism on an affine G2 point via twist factors
    (mod.rs:693-699)."""
    x, y = pt
    return (F.fq2_mul(TWIST_MUL_BY_Q_X, F.fq2_frob(x, 1)),
            F.fq2_mul(TWIST_MUL_BY_Q_Y, F.fq2_frob(y, 1)))


def _doubling_step(r):
    """One Miller doubling step; returns (new_r, ell coeffs)
    (mod.rs:754-776)."""
    x, y, z = r
    a = F.fq2_scale(F.fq2_mul(x, y), TWO_INV)
    b = F.fq2_sqr(y)
    c = F.fq2_sqr(z)
    d = F.fq2_add(F.fq2_add(c, c), c)
    e = F.fq2_mul(B2, d)
    f = F.fq2_add(F.fq2_add(e, e), e)
    g = F.fq2_scale(F.fq2_add(b, f), TWO_INV)
    h = F.fq2_sub(F.fq2_sqr(F.fq2_add(y, z)), F.fq2_add(b, c))
    i = F.fq2_sub(e, b)
    j = F.fq2_sqr(x)
    e_sq = F.fq2_sqr(e)

    nx = F.fq2_mul(a, F.fq2_sub(b, f))
    ny = F.fq2_sub(F.fq2_sqr(g), F.fq2_add(F.fq2_add(e_sq, e_sq), e_sq))
    nz = F.fq2_mul(b, h)

    ell_0 = F.fq2_mul(XI, i)
    ell_vw = F.fq2_neg(h)
    ell_vv = F.fq2_add(F.fq2_add(j, j), j)
    return (nx, ny, nz), (ell_0, ell_vw, ell_vv)


def _addition_step(r, base):
    """Mixed addition step against an affine base (mod.rs:731-752)."""
    x, y, z = r
    bx, by = base
    d = F.fq2_sub(x, F.fq2_mul(z, bx))
    e = F.fq2_sub(y, F.fq2_mul(z, by))
    f = F.fq2_sqr(d)
    g = F.fq2_sqr(e)
    h = F.fq2_mul(d, f)
    i = F.fq2_mul(x, f)
    j = F.fq2_sub(F.fq2_add(F.fq2_mul(z, g), h), F.fq2_add(i, i))

    nx = F.fq2_mul(d, j)
    ny = F.fq2_sub(F.fq2_mul(e, F.fq2_sub(i, j)), F.fq2_mul(h, y))
    nz = F.fq2_mul(z, h)

    ell_0 = F.fq2_mul(XI, F.fq2_sub(F.fq2_mul(e, bx), F.fq2_mul(d, by)))
    ell_vw = d
    ell_vv = F.fq2_neg(e)
    return (nx, ny, nz), (ell_0, ell_vw, ell_vv)


def precompute(q_affine):
    """87 line-coefficient triples for an affine G2 point
    (mod.rs:701-728)."""
    r = (q_affine[0], q_affine[1], F.FQ2_ONE)
    q_neg = (q_affine[0], F.fq2_neg(q_affine[1]))
    coeffs = []
    for d in ATE_NAF:
        r, c = _doubling_step(r)
        coeffs.append(c)
        if d == 1:
            r, c = _addition_step(r, q_affine)
            coeffs.append(c)
        elif d == -1:
            r, c = _addition_step(r, q_neg)
            coeffs.append(c)
    q1 = _mul_by_q(q_affine)
    q2 = _mul_by_q(q1)
    q2 = (q2[0], F.fq2_neg(q2[1]))
    r, c = _addition_step(r, q1)
    coeffs.append(c)
    r, c = _addition_step(r, q2)
    coeffs.append(c)
    assert len(coeffs) == 87
    return coeffs


def _fold_line(f, coeff, px, py):
    ell_0, ell_vw, ell_vv = coeff
    return F.fq12_mul_by_024(f, ell_0, F.fq2_scale(ell_vw, py),
                             F.fq2_scale(ell_vv, px))


def miller_loop(coeffs, p_affine):
    """Single-pair Miller loop (mod.rs:580-606)."""
    px, py = p_affine
    f = F.FQ12_ONE
    idx = 0
    for d in ATE_NAF:
        f = _fold_line(F.fq12_sqr(f), coeffs[idx], px, py)
        idx += 1
        if d != 0:
            f = _fold_line(f, coeffs[idx], px, py)
            idx += 1
    f = _fold_line(f, coeffs[idx], px, py)
    f = _fold_line(f, coeffs[idx + 1], px, py)
    return f


def miller_loop_batch(coeffs_list, p_affines):
    """Shared-accumulator batch Miller loop: one squaring chain for all
    pairs (mod.rs:609-640)."""
    f = F.FQ12_ONE
    idx = 0
    for d in ATE_NAF:
        f = F.fq12_sqr(f)
        for cs, (px, py) in zip(coeffs_list, p_affines):
            f = _fold_line(f, cs[idx], px, py)
        idx += 1
        if d != 0:
            for cs, (px, py) in zip(coeffs_list, p_affines):
                f = _fold_line(f, cs[idx], px, py)
            idx += 1
    for cs, (px, py) in zip(coeffs_list, p_affines):
        f = _fold_line(f, cs[idx], px, py)
    for cs, (px, py) in zip(coeffs_list, p_affines):
        f = _fold_line(f, cs[idx + 1], px, py)
    return f


def pairing(p, q):
    """Reduced pairing of Jacobian G1 × G2; infinity in either slot gives the
    GT identity (mod.rs:894-902)."""
    pa = to_affine(p, FqOps)
    qa = to_affine(q, Fq2Ops)
    if pa is None or qa is None:
        return F.FQ12_ONE
    f = miller_loop(precompute(qa), pa)
    out = F.fq12_final_exponentiation(f)
    assert out is not None, "miller loop cannot produce zero"
    return out


def pairing_batch(ps, qs):
    """Batch pairing with silent skip of infinity pairs and one shared final
    exponentiation (mod.rs:904-926)."""
    p_affines = []
    coeffs_list = []
    for p, q in zip(ps, qs):
        pa = to_affine(p, FqOps)
        qa = to_affine(q, Fq2Ops)
        if pa is None or qa is None:
            continue
        p_affines.append(pa)
        coeffs_list.append(precompute(qa))
    if not coeffs_list:
        return F.FQ12_ONE
    f = miller_loop_batch(coeffs_list, p_affines)
    out = F.fq12_final_exponentiation(f)
    assert out is not None
    return out
