"""Fused tower-op and group-law kernel wrappers — counterpart of
bn254_tpu/pallas_fused.py (queue rows 5-11, 13-20).

Every wrapper takes packed contiguous ``[c, 16, B]`` int32 tensors (the
``pallas_fused.pack`` layout: the tower pytree's Fq leaves stacked in
order).  For a CUDA tensor it launches its kernel from csrc/fused.cu (rows
5-11, 13-16, the Fq2 square root, which serves rows 3-4, the prepared
Miller loop, which serves rows 13 and 8, and the prepared-G2 lines, which
serve rows 14 and 7) or csrc/groups.cu (rows 17-20, and the affine
conversion, which serves rows 1-5);
for a CPU tensor it runs its plain version below; any other device
raises.

The plain versions are the same formulas as bn254_tpu.tower and
pallas_fused's in-kernel helpers (kfq*, kg2_*), written over stacked
tensors — Fq2 ``[..., 2, 16, B]``, Fq6 ``[..., 3, 2, 16, B]``, Fq12
``[..., 2, 3, 2, 16, B]`` — so that the independent products of a formula
go into one Montgomery call and its additions into a few.  Values are
exact residues, so the regrouping does not change a single output bit.

Pow ladders and the Miller schedule take their digits as a small int32
array (the same for every lane, so warps do not diverge on the card); the
GLV ladder's digits differ per lane, an int32 [nsteps, B] array.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from . import counts
from . import limbs as L
from . import mont_kernels as MK
from . import team_schedule as TS
from ._build import check, launch, on_cuda
from .spec import constants as C

_F = MK.FQ_MOD
N = L.N_LIMBS


# ---------------------------------------------------------------------------
# Digit schedules (pallas_fused.py:1314-1335)
# ---------------------------------------------------------------------------

def _msb_bits(e: int) -> np.ndarray:
    """MSB-first bits of e with the leading 1 dropped -> [nbits, 1] i32."""
    nb = e.bit_length()
    return np.array([[(e >> i) & 1] for i in range(nb - 2, -1, -1)],
                    dtype=np.int32).reshape(-1, 1)


def _naf_digits(e: int) -> np.ndarray:
    """MSB-first NAF digits of e, leading 1 dropped -> [n, 1] i32 with
    values {0, 1, 2}; 2 encodes -1 (multiply by the conjugate)."""
    d = []
    while e:
        if e & 1:
            w = 2 - (e % 4)           # 1 or -1
            d.append(w)
            e -= w
        else:
            d.append(0)
        e >>= 1
    assert d[-1] == 1
    return np.array([[x if x >= 0 else 2] for x in reversed(d[:-1])],
                    dtype=np.int32)


BINARY_Z = _msb_bits(C.Z)      # 62 digits, 27 multiplies: any Fq12
NAF_Z = _naf_digits(C.Z)       # 62 digits, 23 multiplies: cyclotomic only

POW_WINDOW = 4                 # fq_pow's table: the 8 odd powers a, a^3, ..., a^15
POW_TABLE = 1 << (POW_WINDOW - 1)


@functools.lru_cache(maxsize=None)
def pow_digits(e: int) -> np.ndarray:
    """Sliding-window digits of e >= 1, MSB first -> read-only [n, 1] i32:
    digit 0 is the leading window, then one digit a bit, 0 or odd and
    below 2^POW_WINDOW, nonzero digits at least POW_WINDOW bits apart.
    The chain (k_fq_pow, fq_pow_plain): res = a^d0, then per digit a
    square and, where d != 0, a product by a^d from the table."""
    if e < 1:
        raise ValueError(f"pow_digits: want e >= 1, got {e}")
    d = []
    while e:
        x = e & ((1 << POW_WINDOW) - 1) if e & 1 else 0
        d.append(x)
        e = (e - x) >> 1
    out = np.array(d[::-1], dtype=np.int32).reshape(-1, 1)
    out.flags.writeable = False
    return out


def pow_chain_counts(e: int) -> tuple:
    """(squares, products) of pow_digits(e)'s chain: the table's square
    and 7 products, then a square a digit after the first and a product a
    nonzero one."""
    d = pow_digits(e).ravel()
    return len(d), POW_TABLE - 1 + int((d[1:] != 0).sum())

_DIGITS = {}


def _digits_on(digits: np.ndarray, device):
    key = (digits.tobytes(), device)
    t = _DIGITS.get(key)
    if t is None:
        t = torch.tensor(np.ascontiguousarray(digits, dtype=np.int32).ravel(),
                         device=device)
        _DIGITS[key] = t
    return t


# ---------------------------------------------------------------------------
# Plain tower over stacked tensors
# ---------------------------------------------------------------------------

def _add(a, b):
    return L.add_mod(a, b, _F)


def _sub(a, b):
    return L.sub_mod(a, b, _F)


def _neg(a):
    return L.neg_mod(a, _F)


def _s(*xs, dim=-4):
    return torch.stack(xs, dim)


def _const(v: int, like):
    """Montgomery form of the canonical int v, broadcast like [..., 16, B]."""
    col = torch.tensor(_F.encode(v).astype(np.int32), device=like.device)[:, None]
    return col.expand(like.shape).contiguous()


def _xi(a):
    """Fq2 times xi = 9 + i: (9 a0 - a1, 9 a1 + a0)."""
    d = _add(a, a)
    d = _add(d, d)
    d = _add(d, d)
    n0, n1 = _add(d, a).unbind(-3)
    a0, a1 = a.unbind(-3)
    return _s(_sub(n0, a1), _add(n1, a0), dim=-3)


def _fq2_mul_lazy(a, b):
    """Lazy-reduction Karatsuba (pallas_fused.kfq2_mul, its default
    spelling): the three products stay as int64 columns, and each output
    coefficient is reduced once, c0 = redc(m00 - m11) and c1 = redc(cross
    - m00 - m11): 2 reductions where ``mont_kernels._fq2_mul`` takes 3.
    The sums are reduced as in the JAX body, so the differences are
    signed (|T| < 2q^2); ``limbs._redc(signed=True)`` offsets them."""
    a0, a1 = a.unbind(-3)
    b0, b1 = b.unbind(-3)
    sa, sb = _add(torch.stack([a0, b0]), torch.stack([a1, b1])).unbind(0)
    cols = L._product_columns(L._i64(torch.stack([a0, a1, sa], -3)),
                              L._i64(torch.stack([b0, b1, sb], -3)))
    m00, m11, cross = cols.unbind(-3)
    return L._redc(torch.stack([m00 - m11, cross - m00 - m11], -3), _F, signed=True)


def _mul6(a, b):
    """Devegili Fq6 product (fq6.rs:194-208): all 6 Fq2 products in one call."""
    a0, a1, a2 = a.unbind(-4)
    b0, b1, b2 = b.unbind(-4)
    sa, sb = _add(_s(a1, a0, a0, b1, b0, b0), _s(a2, a1, a2, b2, b1, b2)).split(3, -4)
    p = MK._fq2_mul(torch.cat([a, sa], -4), torch.cat([b, sb], -4))
    a_a, b_b, c_c, x_bc, x_ab, x_ac = p.unbind(-4)
    t_bc, t_ab, t_ac = _sub(_s(x_bc, x_ab, x_ac), _s(b_b, a_a, a_a)).unbind(-4)
    u0, u1 = _sub(_s(t_bc, t_ab), _s(c_c, b_b)).unbind(-4)
    xu0, xcc = _xi(_s(u0, c_c)).unbind(-4)
    c0, c1 = _add(_s(xu0, u1), _s(a_a, xcc)).unbind(-4)
    c2 = _sub(_add(t_ac, b_b), c_c)
    return _s(c0, c1, c2)


def _nonres6(a):
    """v * (c0 + c1 v + c2 v^2) = xi c2 + c0 v + c1 v^2."""
    a0, a1, a2 = a.unbind(-4)
    return _s(_xi(a2), a0, a1)


def _mul12(a, b):
    """Karatsuba over Fq6 (fq12.rs:316-328): 3 Fq6 products in one call."""
    a0, a1 = a.unbind(-5)
    b0, b1 = b.unbind(-5)
    sa, sb = _add(_s(a0, b0, dim=-5), _s(a1, b1, dim=-5)).unbind(-5)
    aa, bb, cross = _mul6(_s(a0, a1, sa, dim=-5), _s(b0, b1, sb, dim=-5)).unbind(-5)
    return _s(_add(_nonres6(bb), aa), _sub(_sub(cross, aa), bb), dim=-5)


def _sqr12(a):
    """Fq12 squaring (fq12.rs:295-303): its 2 Fq6 products in one call."""
    a0, a1 = a.unbind(-5)
    x, y = _add(_s(_nonres6(a1), a0, dim=-5), _s(a0, a1, dim=-5)).unbind(-5)
    ab, m = _mul6(_s(a0, x, dim=-5), _s(a1, y, dim=-5)).unbind(-5)
    return _s(_sub(_sub(m, ab), _nonres6(ab)), _add(ab, ab), dim=-5)


def _conj12(a):
    a0, a1 = a.unbind(-5)
    return _s(a0, _neg(a1), dim=-5)


def _pow_chain(a, e: int):
    """a^e on pow_digits(e)'s chain, k_fq_pow's order: a [..., 16, B]."""
    d = pow_digits(e).ravel()
    a2 = L.mont_sqr(a, _F)
    table = [a]
    for _ in range(POW_TABLE - 1):
        table.append(L.mont_mul(table[-1], a2, _F))
    res = table[d[0] >> 1]
    for x in d[1:]:
        res = L.mont_sqr(res, _F)
        if x:
            res = L.mont_mul(res, table[x >> 1], _F)
    return res


def _const2(pair, like):
    """An Fq2 constant (canonical ints) broadcast like [..., 2, 16, B]."""
    return _s(_const(pair[0], like[..., 0, :, :]), _const(pair[1], like[..., 0, :, :]), dim=-3)


def _inv2(a):
    """Norm inversion (tower.fq2_inv, fq2.rs:119-130) on the pow chain."""
    s0, s1 = L.mont_sqr(a, _F).unbind(-3)
    t = _pow_chain(_add(s0, s1), C.Q - 2)
    c0, c1 = L.mont_mul(a, _s(t, t, dim=-3), _F).unbind(-3)
    return _s(c0, _neg(c1), dim=-3)


def _sqr6(a):
    """CH-SQR2 squaring (fq6.rs:163-177), the JAX tower.fq6_sqr."""
    a0, a1, a2 = a.unbind(-4)
    s0, s2, s4 = MK._fq2_sqr(_s(a0, _add(_sub(a0, a1), a2), a2)).unbind(-4)
    ab, bc = MK._fq2_mul(_s(a0, a1), _s(a1, a2)).unbind(-4)
    s1, s3 = _add(_s(ab, bc), _s(ab, bc)).unbind(-4)
    xs3, xs4 = _xi(_s(s3, s4)).unbind(-4)
    c0, c1 = _add(_s(s0, s1), _s(xs3, xs4)).unbind(-4)
    c2 = _sub(_sub(_add(_add(s1, s2), s3), s0), s4)
    return _s(c0, c1, c2)


def _inv6(a):
    """Fq6 inverse (fq6.rs:179-192), the JAX tower.fq6_inv; 0 -> 0."""
    a0, a1, a2 = a.unbind(-4)
    q0, q2, q1 = MK._fq2_sqr(_s(a0, a2, a1)).unbind(-4)
    p0, p1, p2 = MK._fq2_mul(_s(a1, a0, a0), _s(_xi(a2), a1, a2)).unbind(-4)
    c0, c1, c2 = _sub(_s(q0, _xi(q2), q1), _s(p0, p1, p2)).unbind(-4)
    r1, r2, r0 = MK._fq2_mul(_s(a2, a1, a0), _s(c1, c2, c0)).unbind(-4)
    t = _inv2(_add(_xi(_add(r1, r2)), r0))
    return MK._fq2_mul(_s(t, t, t), _s(c0, c1, c2))


def _inv12(a):
    """(tower.fq12_inv, fq12.rs:305-313); 0 -> 0."""
    s0, s1 = _sqr6(a).unbind(-5)
    t = _inv6(_sub(s0, _nonres6(s1)))
    c0, c1 = _mul6(a, _s(t, t, dim=-5)).unbind(-5)
    return _s(c0, _neg(c1), dim=-5)


def _frob12(a, power: int):
    """tower.fq12_frob (fq12.rs:112-119; fq6.rs:125-131; fq2.rs:59-68):
    each Fq2 conjugated on odd powers, c1 and c2 of each half times
    FROB6_C1/C2, then the second half times FROB12_C1.  Power 6 is the
    conjugation (fq12.rs:126)."""
    if power == CONJ:
        return _conj12(a)
    x = a
    if power % 2:
        x0, x1 = a.unbind(-3)
        x = _s(x0, _neg(x1), dim=-3)
    h0, h1, h2 = x.unbind(-4)
    y1, y2 = MK._fq2_mul(_s(h1, h2), _s(_const2(C.FROB6_C1[power], h1),
                                        _const2(C.FROB6_C2[power], h2))).unbind(-4)
    f0, f1 = _s(h0, y1, y2).unbind(-5)
    return _s(f0, MK._fq2_mul(f1, _const2(C.FROB12_C1[power], f1)), dim=-5)


def _mul_by_024(a, x0, x2, x4):
    """Sparse line product (tower.fq12_mul_by_024, fq12.rs:130-196): the 13
    Fq2 products in one call."""
    (z0, z1, z2), (z3, z4, z5) = (t.unbind(-4) for t in a.unbind(-5))
    z02, z24, z04, z13, x02, x24, x04 = _add(
        _s(z0, z2, z0, z1, x0, x2, x0), _s(z2, z4, z4, z3, x2, x4, x4)).unbind(-4)
    s0, x024 = _add(_s(z13, x02), _s(z5, x4)).unbind(-4)
    p = MK._fq2_mul(_s(z0, z2, z4, z1, z5, z1, z02, z3, z24, z3, z5, z04, s0),
                    _s(x0, x2, x4, x2, x4, x0, x02, x4, x24, x0, x2, x04, x024))
    (d0, d2, d4, z1x2, z5x4, z1x0, t1t0, z3x4, t0t1, z3x0, z5x2, t2t0,
     s0t0) = p.unbind(-4)
    a0, a1 = _add(_s(z1x2, z5x4), _s(d4, d2)).unbind(-4)
    b0, b1, b2 = _sub(_s(t1t0, t0t1, t2t0), _s(d0, d2, d0)).unbind(-4)
    n2, c3, c4 = _sub(_s(b0, b1, b2), _s(d2, d4, d4)).unbind(-4)
    x0_, x1_, x3_, x4_ = _xi(_s(a0, a1, c3, z5x2)).unbind(-4)
    nz0, nz1, nz2, nz3, nz4 = _add(_s(x0_, x1_, n2, x3_, x4_),
                                   _s(d0, z1x0, z3x4, z3x0, c4)).unbind(-4)
    q0, q1, q2 = _add(_s(z1x2, z5x4, z1x0), _s(z3x4, z3x0, z5x2)).unbind(-4)
    nz5 = _sub(s0t0, _add(_add(q0, q1), q2))
    return _s(_s(nz0, nz1, nz2), _s(nz3, nz4, nz5), dim=-5)


def _cyc_sqr(a):
    """Granger-Scott cyclotomic squaring (fq12.rs:198-247), the same
    polynomial as tower.fq12_cyclotomic_sqr (so equal on any input)."""
    (z0, z4, z3), (z2, z1, z5) = (t.unbind(-4) for t in a.unbind(-5))
    u, v = _s(z0, z2, z4), _s(z1, z3, z5)
    s1, s2 = _add(_s(u, _xi(v), dim=-5), _s(v, u, dim=-5)).unbind(-5)
    tmp, p = MK._fq2_mul(torch.cat([u, s1], -4), torch.cat([v, s2], -4)).split(3, -4)
    t0, t2, t4 = _sub(_sub(p, tmp), _xi(tmp)).unbind(-4)
    t1, t3, t5 = _add(tmp, tmp).unbind(-4)
    tm, tp = _s(t0, t4, t2), _s(t1, _xi(t5), t3)
    x = torch.cat([_sub(tm, _s(z0, z3, z4)), _add(tp, _s(z1, z2, z5))], -4)
    nz0, nz3, nz4, nz1, nz2, nz5 = _add(_add(x, x), torch.cat([tm, tp], -4)).unbind(-4)
    return _s(_s(nz0, nz4, nz3), _s(nz2, nz1, nz5), dim=-5)


def _dbl_step(r):
    """Miller doubling step (pairing_jax._doubling_step, mod.rs:754-776) on a
    stacked G2 triple [..., 3, 2, 16, B] -> (new r, (ell_0, ell_vw, ell_vv))."""
    x, y, z = r.unbind(-4)
    yz = _add(y, z)
    xy, b, c, j, yz2 = MK._fq2_mul(_s(x, y, z, x, yz), _s(y, y, z, x, yz)).unbind(-4)
    c2, bc = _add(_s(c, b), _s(c, c)).unbind(-4)
    d = _add(c2, c)
    e = MK._fq2_mul(_s(_const(C.B2[0], d[..., 0, :, :]),
                       _const(C.B2[1], d[..., 0, :, :]), dim=-3), d)
    f = _add(_add(e, e), e)
    bf, bmf = _add(b, f), _sub(b, f)
    i, h = _sub(_s(e, yz2), _s(b, bc)).unbind(-4)
    two_inv = _const(pow(2, C.Q - 2, C.Q), xy)
    a_, g = L.mont_mul(_s(xy, bf), _s(two_inv, two_inv), _F).unbind(-4)
    nx, g2, e2, nz = MK._fq2_mul(_s(a_, g, e, b), _s(bmf, g, e, h)).unbind(-4)
    t = _s(e2, j)
    e3, j3 = _add(_add(t, t), t).unbind(-4)
    ny = _sub(g2, e3)
    return _s(nx, ny, nz), _s(_xi(i), _neg(h), j3)


def _add_step(r, base):
    """Mixed addition step (pairing_jax._addition_step, mod.rs:731-752)
    against an affine base [..., 2, 2, 16, B]."""
    x, y, z = r.unbind(-4)
    bx, by = base.unbind(-4)
    d, e = _sub(_s(x, y), MK._fq2_mul(_s(z, z), _s(bx, by))).unbind(-4)
    f, g = MK._fq2_mul(_s(d, e), _s(d, e)).unbind(-4)
    h, i, zg = MK._fq2_mul(_s(d, x, z), _s(f, f, g)).unbind(-4)
    j = _sub(_add(zg, h), _add(i, i))
    nx, eij, hy, nz, ebx, dby = MK._fq2_mul(_s(d, e, h, z, e, d),
                                            _s(j, _sub(i, j), y, h, bx, by)).unbind(-4)
    return _s(nx, _sub(eij, hy), nz), _s(_xi(_sub(ebx, dby)), d, _neg(e))


def _fold(f, c, px, py):
    """f * line, with ell_vv*px and ell_vw*py folded in (pallas_fused
    fq12_fold_line): c = (ell_0, ell_vw, ell_vv)."""
    ell_0, ell_vw, ell_vv = c.unbind(-4)
    x2, x4 = L.mont_mul(_s(ell_vv, ell_vw), _s(px, py, dim=-3).unsqueeze(-3),
                        _F).unbind(-4)
    return _mul_by_024(f, ell_0, x2, x4)


def _fq12_one(like):
    one = _const(1, like)
    zero = torch.zeros_like(one)
    return torch.stack([one] + [zero] * 11).view(2, 3, 2, N, like.shape[-1])


# ---------------------------------------------------------------------------
# Plain versions of the kernels (packed tensors in and out)
# ---------------------------------------------------------------------------

def fq_pow_plain(a, e: int):
    counts.plain_calls["fq_pow"] += 1
    return _pow_chain(a, e)


def _fq2_pow(a, e: int):
    """a^e of packed Fq2 [2, 16, B] for a static exponent e >= 1: MSB-first
    square-and-multiply over the plain Fq2 square and product (rows 3-4's
    formulas), from the leading 1 and multiplying only on set bits.  The
    JAX package's scan (bn254_tpu/tower.py _fq2_pow_scan) starts from 1
    and selects the product on every step; the canonical values are the
    same."""
    res = a
    for i in reversed(range(e.bit_length() - 1)):
        res = MK._fq2_sqr(res)
        if (e >> i) & 1:
            res = MK._fq2_mul(res, a)
    return res


def fq2_sqrt_plain(a):
    """(root, ok) of packed Fq2 [2, 16, B]: the complex-method square root
    (fq2.rs:208-224) as bn254_tpu/tower.py fq2_sqrt computes it,
    branchless.  The reference's root wherever a is a residue (0
    included); ok is False exactly on non-residues.

    a1 = a^((q-3)/4), alpha = a1^2 a; ok unless alpha^(q+1) = -1, where
    alpha^q is the Frobenius map, conjugation (the JAX package spells it
    as a 254-bit power; the canonical values are the same).  Branch A,
    alpha = -1: i * a1 a.  Branch B: (alpha + 1)^((q-1)/2) * a1 a.  Both
    are computed and selected per lane, as in the JAX package."""
    counts.plain_calls["fq2_sqrt"] += 1
    a1 = _fq2_pow(a, C.FQ_MINUS3_DIV4)
    a1a = MK._fq2_mul(a1, a)
    alpha = MK._fq2_mul(a1, a1a)
    a0 = MK._fq2_mul(_s(alpha[0], _neg(alpha[1]), dim=-3), alpha)
    neg_one = _const2((C.Q - 1, 0), a)
    is_nonres = (a0 == neg_one).flatten(0, 1).all(0)
    alpha_is_neg1 = (alpha == neg_one).flatten(0, 1).all(0)
    root_a = MK._fq2_mul(_const2((0, 1), a), a1a)
    b = _fq2_pow(_add(alpha, _const2((1, 0), a)), C.FQ_MINUS1_DIV2)
    root_b = MK._fq2_mul(b, a1a)
    return torch.where(alpha_is_neg1, root_a, root_b), ~is_nonres


def fq12_inv_plain(a):
    counts.plain_calls["fq12_inv"] += 1
    batch = a.shape[-1]
    return _inv12(a.view(2, 3, 2, N, batch)).reshape(12, N, batch)


def fq12_frob_plain(a, power: int):
    counts.plain_calls["fq12_frob"] += 1
    batch = a.shape[-1]
    return _frob12(a.view(2, 3, 2, N, batch), power).reshape(12, N, batch)


def miller_precompute_plain(q, p, kinds):
    """The Miller steps of `kinds` (STEP_KINDS) with their folds: f = 1, R =
    (qx, qy, 1), then per kind f = f^2 and a doubling step (0) or a mixed
    addition of the kind's base (_step_bases), and f = f * line.  Returns
    (f [12, 16, B], R [6, 16, B])."""
    counts.plain_calls["miller_precompute"] += 1
    batch = p.shape[-1]
    px, py = p.unbind(0)
    bases = _step_bases(q)
    f = _fq12_one(px)
    r = _s(*bases[1], f[0, 0])                  # z = (1, 0)
    for kind in np.asarray(kinds).ravel():
        if kind == 0:
            f = _sqr12(f)
            r, c = _dbl_step(r)
        else:
            r, c = _add_step(r, bases[kind])
        f = _fold(f, c, px, py)
    return f.reshape(12, N, batch), r.reshape(6, N, batch)


def fq2_mul_lazy_plain(a, b):
    counts.plain_calls["fq2_mul_fused"] += 1
    return _fq2_mul_lazy(a, b)


def fq2_sqr_fused_plain(a):
    """Row 16's plain version: pallas_fused.kfq2_sqr is the eager complex
    square, ``mont_kernels._fq2_sqr``."""
    counts.plain_calls["fq2_sqr_fused"] += 1
    return MK._fq2_sqr(a)


def fq12_sqr_plain(a):
    counts.plain_calls["fq12_sqr"] += 1
    batch = a.shape[-1]
    return _sqr12(a.view(2, 3, 2, N, batch)).reshape(12, N, batch)


def g2_dbl_step_plain(r):
    counts.plain_calls["g2_dbl_step"] += 1
    batch = r.shape[-1]
    nr, c = _dbl_step(r.view(3, 2, N, batch))
    return nr.reshape(6, N, batch), c.reshape(6, N, batch)


def g2_add_step_plain(r, base):
    counts.plain_calls["g2_add_step"] += 1
    batch = r.shape[-1]
    nr, c = _add_step(r.view(3, 2, N, batch), base.view(2, 2, N, batch))
    return nr.reshape(6, N, batch), c.reshape(6, N, batch)


def _mul_by_q(x, y):
    """The twist Frobenius of affine G2 coordinates (pairing_torch._mul_by_q,
    mod.rs:693-699): (tx conj(x), ty conj(y)), Fq2 [2, 16, B] each."""
    conj = lambda a: _s(a[0], _neg(a[1]), dim=-3)
    return MK._fq2_mul(_s(conj(x), conj(y)), _s(_const2(C.TWIST_MUL_BY_Q_X, x),
                                                 _const2(C.TWIST_MUL_BY_Q_Y, y))).unbind(0)


STEP_KINDS = range(5)          # 0: doubling; additions of 1: Q, 2: -Q, 3: pi(Q), 4: -pi^2(Q)


def _step_bases(q):
    """The addition base [2, 2, 16, B] of each step kind (None for the
    doubling) of an affine G2 q [4, 16, B]: Q, -Q, and the Frobenius bases
    by _mul_by_q applied twice (mod.rs:717-721)."""
    qx, qy = q.view(2, 2, N, q.shape[-1]).unbind(0)
    q1 = _mul_by_q(qx, qy)
    q2x, q2y = _mul_by_q(*q1)
    return (None, _s(qx, qy), _s(qx, _neg(qy)), _s(*q1), _s(q2x, _neg(q2y)))


def g2_precompute_plain(q, kinds):
    """pairing_torch.precompute's steps (mod.rs:701-728) over stacked tensors: R
    = (qx, qy, 1), then per kind a doubling step or a mixed addition of its
    base (_dbl_step's and _add_step's formulas, _step_bases).  Returns the
    lines [n, 6, 16, B]."""
    counts.plain_calls["g2_precompute"] += 1
    batch = q.shape[-1]
    bases = _step_bases(q)
    r = _s(*bases[1], _fq12_one(q[0])[0, 0])    # z = (1, 0)
    lines = []
    for kind in np.asarray(kinds).ravel():
        r, c = _dbl_step(r) if kind == 0 else _add_step(r, bases[kind])
        lines.append(c)
    return torch.stack(lines).reshape(len(lines), 6, N, batch)


def fq12_fold_line_plain(f, c, px, py):
    counts.plain_calls["fq12_fold_line"] += 1
    batch = f.shape[-1]
    out = _fold(f.view(2, 3, 2, N, batch), c.view(3, 2, N, batch), px, py)
    return out.reshape(12, N, batch)


def miller_loop_plain(coeffs, px, py, flags):
    """The prepared Miller loop (mod.rs:580-606): f = 1, then per step f =
    f^2 where its flag is set and f = f * line (fq12_sqr_plain's and
    fq12_fold_line_plain's formulas).  coeffs [n, 6, 16, B]."""
    counts.plain_calls["miller_loop"] += 1
    batch = px.shape[-1]
    f = _fq12_one(px)
    for c, flag in zip(coeffs, np.asarray(flags).ravel()):
        if flag:
            f = _sqr12(f)
        f = _fold(f, c.view(3, 2, N, batch), px, py)
    return f.reshape(12, N, batch)


def fq12_mul_plain(a, b):
    counts.plain_calls["fq12_mul"] += 1
    batch = a.shape[-1]
    return _mul12(a.view(2, 3, 2, N, batch), b.view(2, 3, 2, N, batch)).reshape(12, N, batch)


def fq12_cyc_sqr_plain(a):
    counts.plain_calls["fq12_cyc_sqr"] += 1
    batch = a.shape[-1]
    return _cyc_sqr(a.view(2, 3, 2, N, batch)).reshape(12, N, batch)


def fq12_cyc_pow_plain(a, digits):
    counts.plain_calls["fq12_cyc_pow"] += 1
    batch = a.shape[-1]
    a6 = a.view(2, 3, 2, N, batch)
    aconj = _conj12(a6)
    res = a6
    for d in np.asarray(digits).ravel():
        res = _cyc_sqr(res)
        if d == 1:
            res = _mul12(res, a6)
        elif d == 2:
            res = _mul12(res, aconj)
    return res.reshape(12, N, batch)


# ---------------------------------------------------------------------------
# Plain group law (pallas_fused k_point_double / k_point_add /
# k_point_madd_generic / k_affine_double) over stacked coordinates
# ---------------------------------------------------------------------------

class _Coord:
    """A point coordinate's field for the plain point formulas: Fq
    elements are [..., 16, B] (ncoords 1), Fq2 elements [..., 2, 16, B]
    (ncoords 2).  Values stay exact residues, so products may be stacked
    and squares taken as products without changing a bit."""

    def __init__(self, ncoords: int):
        self.ncoords = ncoords
        self.elem = -3 if ncoords == 1 else -4       # stacking axis
        self._mul = ((lambda a, b: L.mont_mul(a, b, _F)) if ncoords == 1
                     else MK._fq2_mul)
        self._sqr = ((lambda a: L.mont_sqr(a, _F)) if ncoords == 1 else MK._fq2_sqr)

    def mul(self, *pairs):
        """Products of (a, b) pairs, all in one call."""
        if len(pairs) == 1:
            return self._mul(*pairs[0])
        out = self._mul(torch.stack([a for a, _ in pairs], self.elem),
                        torch.stack([b for _, b in pairs], self.elem))
        return out.unbind(self.elem)

    def sqr(self, *xs):
        """Squares, all in one call (2 products per Fq2 square, not 3)."""
        if len(xs) == 1:
            return self._sqr(xs[0])
        return self._sqr(torch.stack(xs, self.elem)).unbind(self.elem)

    def mask(self, m):
        """[..., B] lane mask -> broadcastable over [..., (2,) 16, B]."""
        m = m.unsqueeze(-2)
        return m if self.ncoords == 1 else m.unsqueeze(-2)

    def is_zero(self, a):
        z = (a == 0).all(-2)
        return z if self.ncoords == 1 else z.all(-2)

    def eq(self, a, b):
        e = (a == b).all(-2)
        return e if self.ncoords == 1 else e.all(-2)

    def select(self, m, a, b):
        return torch.where(self.mask(m), a, b)

    def one(self, like):
        one = _const(1, like if self.ncoords == 1 else like[..., 0, :, :])
        if self.ncoords == 1:
            return one
        return torch.stack([one, torch.zeros_like(one)], -3)

    def point(self, arr):
        """Packed [3c, 16, B] -> stacked [3, (2,) 16, B]."""
        return arr.view(3, *([2] if self.ncoords == 2 else []), N, arr.shape[-1])


_COORD = {1: _Coord(1), 2: _Coord(2)}


def _coord(ncoords: int) -> _Coord:
    if ncoords not in _COORD:
        raise ValueError(f"ncoords must be 1 (G1) or 2 (G2), got {ncoords}")
    return _COORD[ncoords]


def _point_double(A, x, y, z):
    """dbl-2009-l (groups.double, k_point_double) -> (x3, y3, z3)."""
    a, b = A.sqr(x, y)
    c, xb2 = A.sqr(b, _add(x, b))
    d = _sub(_sub(xb2, a), c)
    d = _add(d, d)
    e = _add(_add(a, a), a)
    f = A.sqr(e)
    x3 = _sub(f, _add(d, d))
    ec = _add(c, c)
    ec = _add(ec, ec)
    ec = _add(ec, ec)
    t, yz = A.mul((e, _sub(d, x3)), (y, z))
    return x3, _sub(t, ec), _add(yz, yz)


def _point_add(A, p, q):
    """Unified Jacobian add with the 3-way select (groups.add,
    k_point_add): coincide -> double(p), q at infinity -> p, p at
    infinity -> q.  p, q: (x, y, z).  Like the kernel, it doubles only
    when some lane coincides."""
    (x1, y1, z1), (x2, y2, z2) = p, q
    p_inf, q_inf = A.is_zero(z1), A.is_zero(z2)
    z1s, z2s, z12s = A.sqr(z1, z2, _add(z1, z2))
    u1, u2, z1c, z2c = A.mul((x1, z2s), (x2, z1s), (z1, z1s), (z2, z2s))
    s1, s2 = A.mul((y1, z2c), (y2, z1c))
    coincide = A.eq(u1, u2) & A.eq(s1, s2) & ~p_inf & ~q_inf
    h = _sub(u2, u1)
    d = _sub(s2, s1)
    rr = _add(d, d)
    i, rr2 = A.sqr(_add(h, h), rr)
    zz = _sub(_sub(z12s, z1s), z2s)
    j, v, z3 = A.mul((h, i), (u1, i), (zz, h))
    x3 = _sub(_sub(rr2, j), _add(v, v))
    t, s1j = A.mul((rr, _sub(v, x3)), (s1, j))
    out = (x3, _sub(t, _add(s1j, s1j)), z3)
    if bool(coincide.any()):        # the select takes the double nowhere else
        dbl = _point_double(A, x1, y1, z1)
        out = tuple(A.select(coincide, a, b) for a, b in zip(dbl, out))
    out = tuple(A.select(q_inf, a, b) for a, b in zip(p, out))
    return tuple(A.select(p_inf, a, b) for a, b in zip(q, out))


def _point_madd_generic(A, p, qx, qy):
    """Mixed add of an affine q without the doubling branch
    (k_point_madd_generic) -> (out, coincide): lanes with coincide hold a
    wrong value (z3 = 0) that the caller patches with the affine double."""
    x1, y1, z1 = p
    p_inf = A.is_zero(z1)
    z1s = A.sqr(z1)
    u2, z1c = A.mul((qx, z1s), (z1, z1s))
    s2 = A.mul((qy, z1c))
    coincide = A.eq(x1, u2) & A.eq(y1, s2) & ~p_inf
    h = _sub(u2, x1)
    d = _sub(s2, y1)
    rr = _add(d, d)
    i, rr2 = A.sqr(_add(h, h), rr)
    j, v, zh = A.mul((h, i), (x1, i), (z1, h))
    x3 = _sub(_sub(rr2, j), _add(v, v))
    t, s1j = A.mul((rr, _sub(v, x3)), (y1, j))
    y3 = _sub(t, _add(s1j, s1j))
    q_jac = (qx, qy, A.one(qx))
    out = tuple(A.select(p_inf, a, b) for a, b in zip(q_jac, (x3, y3, _add(zh, zh))))
    return out, coincide


def _affine_double(A, qx, qy):
    """Jacobian double of an affine point (z = 1; k_affine_double)."""
    a, b = A.sqr(qx, qy)
    c, xb2 = A.sqr(b, _add(qx, b))
    d2 = _sub(_sub(xb2, a), c)
    d2 = _add(d2, d2)
    e = _add(_add(a, a), a)
    f = A.sqr(e)
    xd = _sub(f, _add(d2, d2))
    c8 = _add(c, c)
    c8 = _add(c8, c8)
    c8 = _add(c8, c8)
    yd = _sub(A.mul((e, _sub(d2, xd))), c8)
    return xd, yd, _add(qy, qy)


def point_add_plain(ncoords: int, p, q):
    counts.plain_calls["point_add"] += 1
    A = _coord(ncoords)
    out = _point_add(A, A.point(p).unbind(0), A.point(q).unbind(0))
    return torch.stack(out).reshape(p.shape)


def point_double_plain(ncoords: int, p):
    counts.plain_calls["point_double"] += 1
    A = _coord(ncoords)
    return torch.stack(_point_double(A, *A.point(p).unbind(0))).reshape(p.shape)


def msm_combine_plain(ncoords: int, totals, c: int):
    """msm.py's loop, as the JAX package runs it (msm.py:288-301 and the
    roll fold after it): Horner over the window totals [W, 3c, 16, lanes],
    high to low (c doubles, then the add of the window's total), then
    log2(lanes) adds of res and res rolled by k = 1, 2, 4, ... lanes;
    lane 0 holds the sum -> [3c, 16, 1]."""
    counts.plain_calls["msm_combine"] += 1
    A = _coord(ncoords)
    lanes = _combine_lanes(totals)
    res = A.point(totals[-1]).unbind(0)
    for w in range(totals.shape[0] - 2, -1, -1):
        for _ in range(c):
            res = _point_double(A, *res)
        res = _point_add(A, res, A.point(totals[w]).unbind(0))
    k = 1
    while k < lanes:
        res = _point_add(A, res, tuple(torch.roll(x, -k, -1) for x in res))
        k *= 2
    return torch.stack(res).reshape(3 * ncoords, N, lanes)[..., :1].contiguous()


def point_mul_plain(ncoords: int, p, k_limbs, num_bits: int):
    """The JAX package's scalar_mul scan (groups.py:294-307): res starts at
    (0, 1, 0); per bit, high to low, a double, then the add of the base
    selected on the bit.  k_limbs: canonical scalar limbs [16, B].  A step
    where no lane's bit is set skips the add: the select keeps res."""
    counts.plain_calls["point_mul"] += 1
    A = _coord(ncoords)
    base = A.point(p).unbind(0)
    zero = torch.zeros_like(base[0])
    res = (zero, A.one(zero), zero)
    for i in range(num_bits - 1, -1, -1):
        res = _point_double(A, *res)
        bit = ((k_limbs[i // L.LIMB_BITS] >> (i % L.LIMB_BITS)) & 1) > 0
        if bool(bit.any()):
            res = tuple(A.select(bit, a, b) for a, b in zip(_point_add(A, res, base), res))
    return torch.stack(res).reshape(p.shape)


AFFINE_PLAIN_BLOCK = 1024      # to_affine_plain's lanes a block


def to_affine_geometry(ncoords: int, batch: int) -> tuple[int, int]:
    """(K lanes a thread, threads a block) of k_to_affine at this batch on
    the current card: its C entry picks K from the card's SMs and the
    kernel's residency.  Raises if the card's queries fail."""
    import ctypes

    from ._build import library

    lib, lanes, threads = library(), ctypes.c_int(), ctypes.c_int()
    rc = lib.bn254_to_affine_geometry(ncoords, batch, ctypes.byref(lanes),
                                      ctypes.byref(threads))
    if rc:
        raise RuntimeError(f"to_affine geometry query failed: "
                           f"{lib.bn254_error_string(rc).decode()}")
    return lanes.value, threads.value


def _block_prefix(d):
    """Inclusive products along the last axis of d [..., 16, n] (a
    Hillis-Steele scan: log2(n) rounds of products)."""
    k, n = 1, d.shape[-1]
    while k < n:
        d = torch.cat([d[..., :k], L.mont_mul(d[..., k:], d[..., :-k], _F)], -1)
        k *= 2
    return d


def to_affine_plain(ncoords: int, p, block: int = AFFINE_PLAIN_BLOCK):
    """(affine (x, y) [2c, 16, B], inf [B] bool) of Jacobian points p
    [3c, 16, B]: bn254_tpu/msm.py:133-156's shared inversion, block by
    block, as k_to_affine runs it (its blocks hold K lanes a thread:
    to_affine_geometry; no block size changes a limb).  Each block of
    `block` lanes (the last one short) inverts its denominators d (z, or
    the norm z0^2 + z1^2 for G2; d = 0 taken as 1) with one Fermat chain
    on the product of the block, and each lane's d^-1 is the product of
    the block's lanes before it, after it and that inverse.  Then z^-1 =
    d^-1 (G1) or (z0 d^-1, -z1 d^-1) (G2), x z^-2 and y z^-3; lanes with
    z = 0 give (0, 0) and inf True, as the per-lane Fermat route's
    inv(0) = 0 does."""
    counts.plain_calls["to_affine"] += 1
    A = _coord(ncoords)
    batch = p.shape[-1]
    x, y, z = A.point(p).unbind(0)
    if ncoords == 1:
        d = z
    else:
        s0, s1 = L.mont_sqr(z, _F).unbind(-3)
        d = _add(s0, s1)
    inf = L.is_zero(d)
    one = _const(1, d)
    nb = -(-batch // block)
    d = torch.cat([torch.where(inf, one, d), one[:, :1].expand(N, nb * block - batch)], -1)
    d = d.view(N, nb, block).transpose(0, 1)                        # [nb, 16, block]
    pre = _block_prefix(d)
    suf = _block_prefix(d.flip(-1)).flip(-1)
    ones = one[:, :1].expand(nb, N, 1)
    pre_ex = torch.cat([ones, pre[..., :-1]], -1)
    suf_ex = torch.cat([suf[..., 1:], ones], -1)
    tinv = _pow_chain(pre[..., -1:], C.Q - 2)
    dinv = L.mont_mul(L.mont_mul(pre_ex, suf_ex, _F), tinv.expand(nb, N, block), _F)
    dinv = dinv.transpose(0, 1).reshape(N, nb * block)[:, :batch]
    if ncoords == 1:
        zinv = dinv
    else:
        c0, c1 = L.mont_mul(z, _s(dinv, dinv, dim=-3), _F).unbind(-3)
        zinv = _s(c0, _neg(c1), dim=-3)
    zinv = A.select(inf, torch.zeros_like(zinv), zinv)
    zi2 = A.sqr(zinv)
    zi3 = A.mul((zi2, zinv))
    ax, ay = A.mul((x, zi2), (y, zi3))
    return torch.stack([ax, ay]).reshape(2 * ncoords, N, batch), inf


def glv_ladder_plain(ncoords: int, pts, digits):
    """The JAX package's scan spelling (glv.py:302-319): res starts at
    (0, 1, 0); per digit a double, the two-level table select (digit 0
    picks (0, 1, 0)) and the unified add."""
    counts.plain_calls["glv_ladder"] += 1
    A = _coord(ncoords)
    p1, p2, p12 = (A.point(t).unbind(0) for t in pts.view(3, 3 * ncoords, N, -1).unbind(0))
    zero = torch.zeros_like(p1[0])
    inf = (zero, A.one(zero), zero)
    res = inf
    for d in digits:
        res = _point_double(A, *res)
        b1, b2 = (d & 1) > 0, d >= 2
        hi = tuple(A.select(b1, a, b) for a, b in zip(p12, p2))
        lo = tuple(A.select(b1, a, b) for a, b in zip(p1, inf))
        res = _point_add(A, res, tuple(A.select(b2, a, b) for a, b in zip(hi, lo)))
    return torch.stack(res).reshape(3 * ncoords, N, pts.shape[-1])


def _bucket_sums(A, pts, digits, nb: int, signed: bool, lanes: int):
    """Every window's buckets, tile by tile in order: the batch axis is
    (window, lane), window-major.  Tile i feeds point i*lanes + lane to
    lane `lane` of every window; the bucket gather and scatter are
    indexing (bucket 0, the discard bucket, is written and cleared again)
    -> [nb, 3, (2,) 16, W * lanes]."""
    W, n = digits.shape
    m, wl = n // lanes, W * lanes
    buckets = torch.zeros((nb, 3) + tuple(pts.shape[1:-1]) + (wl,),
                          dtype=torch.int32, device=pts.device)
    for i in range(m):
        d = digits[:, i * lanes:(i + 1) * lanes].reshape(wl)
        qx, qy = pts[..., i * lanes:(i + 1) * lanes].repeat(
            (1,) * (pts.dim() - 1) + (W,)).unbind(0)
        if signed:
            neg = d < 0
            qy = A.select(neg, _neg(qy), qy)
            d = d.abs()
        idx = d.view((1,) * (buckets.dim() - 1) + (wl,)).expand(
            (1,) + tuple(buckets.shape[1:])).to(torch.int64)
        cur = buckets.gather(0, idx)[0].unbind(0)
        new, coincide = _point_madd_generic(A, cur, qx, qy)
        if bool(coincide.any()):
            dbl = _affine_double(A, qx, qy)
            new = tuple(A.select(coincide, a, b) for a, b in zip(dbl, new))
        buckets.scatter_(0, idx, torch.stack(new)[None])
        buckets[0] = 0
    return buckets


def _bucket_reduce(A, buckets):
    """Each lane's running sum over its buckets b = nb-1 .. 1 -> its
    window total (x, y, z).  buckets: [nb, 3, (2,) 16, W * lanes]."""
    zero = tuple(torch.zeros_like(buckets[0, 0]) for _ in range(3))
    acc = tot = zero
    for b in range(buckets.shape[0] - 1, 0, -1):
        acc = _point_add(A, acc, buckets[b].unbind(0))
        tot = _point_add(A, tot, acc)
    return tot


def _totals(tot, ncoords: int, W: int, lanes: int):
    """Window totals (x, y, z) over (window, lane) -> [W, 3c, 16, lanes]."""
    return (torch.stack(tot).reshape(3 * ncoords, N, W, lanes)
            .permute(2, 0, 1, 3).contiguous())


def msm_accumulate_plain(ncoords: int, points, digits, nb: int, signed: bool = True,
                         lanes: int = 1024):
    """All windows at once: the buckets tile by tile in order, then each
    lane reduces its own buckets by the running sum."""
    counts.plain_calls["msm_accumulate"] += 1
    A = _coord(ncoords)
    pts = points.view(2, *([2] if ncoords == 2 else []), N, points.shape[-1])
    buckets = _bucket_sums(A, pts, digits, nb, signed, lanes)
    return _totals(_bucket_reduce(A, buckets), ncoords, digits.shape[0], lanes)


def msm_bucket_sort_plain(digits, nb: int, signed: bool = True, lanes: int = 1024):
    """Each (window, lane)'s tiles i (points i*lanes + lane) sorted by
    bucket |d| (d if unsigned), stably, tiles with d = 0 dropped ->
    (offsets int32 [W, nb, lanes], order int32 [W, n/lanes, lanes]).
    offsets[w, b, lane] counts the lane's tiles with 1 <= |d| <= b, so
    bucket b's run is order[w, offsets[b-1]:offsets[b], lane]; order is
    -1 past the last run."""
    counts.plain_calls["msm_bucket_sort"] += 1
    W, n = digits.shape
    key = digits.view(W, n // lanes, lanes).to(torch.int64)
    key = key.abs() if signed else key
    key = torch.where(key == 0, nb, key)             # d = 0 sorts last
    sk, idx = torch.sort(key, dim=1, stable=True)
    order = torch.where(sk == nb, -1, idx).to(torch.int32)
    count = torch.zeros((W, nb + 1, lanes), dtype=torch.int64, device=digits.device)
    count.scatter_add_(1, key, torch.ones_like(key))
    offsets = count[:, :nb].cumsum(1).to(torch.int32)   # count[:, 0] is 0
    return offsets, order


def msm_bucket_reduce_plain(ncoords: int, buckets):
    """The running-sum reduce of every (window, lane): buckets [W, nb-1,
    3c, 16, lanes] (bucket b at b - 1) -> totals [W, 3c, 16, lanes]."""
    counts.plain_calls["msm_bucket_reduce"] += 1
    A = _coord(ncoords)
    W, nb1, _, _, lanes = buckets.shape
    stacked = (buckets.permute(1, 2, 3, 0, 4)
               .reshape(nb1, 3, *([2] if ncoords == 2 else []), N, W * lanes))
    stacked = torch.cat([torch.zeros_like(stacked[:1]), stacked])   # bucket 0
    return _totals(_bucket_reduce(A, stacked), ncoords, W, lanes)


def msm_point_words(points):
    """Affine points [2c, 16, n] (16-bit limbs) -> the point-major copy
    [n, 2c, 8] of 32-bit words (limb 2j in the low half of word j) that
    the accumulate kernel gathers a point from."""
    return (points[:, 0::2] | (points[:, 1::2] << 16)).permute(2, 0, 1).contiguous()


# ---------------------------------------------------------------------------
# Kernel wrappers
# ---------------------------------------------------------------------------

def fq_pow(a, e: int):
    """a^e for a static exponent e >= 1, one whole-chain kernel over
    pow_digits(e) (a 4-bit sliding window).  a: [16, B] Fq.  Kernel:
    csrc/fused.cu k_fq_pow, replacing pallas_fused.py
    _pow_call_impl("fq_pow")."""
    if e == 1:
        return a
    digits = pow_digits(e)
    if not on_cuda(a):
        return fq_pow_plain(a, e)
    batch = a.shape[-1]
    check("fq_pow", batch, a.device, (a, ()))
    out = torch.empty_like(a)
    launch("fq_pow", batch, _digits_on(digits, a.device).data_ptr(), len(digits),
           a.data_ptr(), out.data_ptr())
    return out


def fq2_sqrt(a):
    """(root [2, 16, B], ok [B] bool) of packed Fq2 a [2, 16, B]: the whole
    complex-method square root in one kernel, fq2_sqrt_plain's values.
    Kernel: csrc/fused.cu k_fq2_sqrt (one thread a lane, both powers on
    fq_pow's window over pow_digits), serving pallas_kernels.py's Fq2
    square and product (pk:181/175) as bn254_tpu/tower.py fq2_sqrt runs
    them."""
    if not on_cuda(a):
        return fq2_sqrt_plain(a)
    batch = a.shape[-1]
    check("fq2_sqrt", batch, a.device, (a, (2,)))
    d_a1, d_b = (_digits_on(pow_digits(e), a.device)
                 for e in (C.FQ_MINUS3_DIV4, C.FQ_MINUS1_DIV2))
    root = torch.empty_like(a)
    ok = torch.empty(batch, dtype=torch.bool, device=a.device)
    launch("fq2_sqrt", batch, d_a1.data_ptr(), d_a1.numel(), d_b.data_ptr(), d_b.numel(),
           a.data_ptr(), root.data_ptr(), ok.data_ptr())
    return root, ok


def fq12_inv(a):
    """Fq12 inverse [12, 16, B] (fq12.rs:305-313); 0 maps to 0.  Kernel:
    csrc/fused.cu k_fq12_inv, one thread a lane, the norm's Fermat inverse
    on fq_pow's chain: the final exponentiation's inverse, which the
    JAX package runs as tower glue around pallas_kernels.py's fq2_mul."""
    if not on_cuda(a):
        return fq12_inv_plain(a)
    batch = a.shape[-1]
    check("fq12_inv", batch, a.device, (a, (12,)))
    digits = pow_digits(C.Q - 2)
    out = torch.empty_like(a)
    launch("fq12_inv", batch, _digits_on(digits, a.device).data_ptr(), len(digits),
           a.data_ptr(), out.data_ptr())
    return out


CONJ = 6                        # a^(q^6), the conjugation w -> -w of Fq12
FROB_POWERS = (1, 2, 3, CONJ)


def fq12_frob(a, power: int):
    """a^(q^power) of [12, 16, B] for power 1, 2, 3 (fq12.rs:112-119) or
    CONJ (fq12.rs:126).  Kernel: csrc/fused.cu k_fq12_frob, one thread a
    Fq2 coefficient, one product by a constant each: the final
    exponentiation's Frobenius maps and conjugations, which the JAX package
    runs as tower glue around pallas_kernels.py's fq2_mul."""
    if power not in FROB_POWERS:
        raise ValueError(f"fq12_frob: power must be one of {FROB_POWERS}, got {power}")
    if not on_cuda(a):
        return fq12_frob_plain(a, power)
    batch = a.shape[-1]
    check("fq12_frob", batch, a.device, (a, (12,)))
    out = torch.empty_like(a)
    launch("fq12_frob", batch, power, a.data_ptr(), out.data_ptr())
    return out


def _step_kinds(name: str, kinds) -> np.ndarray:
    """kinds as int32, or ValueError unless each lies in STEP_KINDS."""
    kinds = np.asarray(kinds, dtype=np.int32).ravel()
    if not np.isin(kinds, STEP_KINDS).all():
        raise ValueError(f"{name}: step kinds must lie in {STEP_KINDS}, got {kinds}")
    return kinds


def miller_precompute(q, p, kinds):
    """The Miller steps in one kernel: kind 0 squares f and takes a G2
    doubling step, kind 1-4 a mixed addition with Q, -Q, pi(Q), -pi^2(Q)
    (STEP_KINDS); each step then folds its line (scaled by px, py) into f.

    q: affine G2 [4, 16, B]; p: affine G1 [2, 16, B]; kinds: n ints, the
    same for every lane.  Returns (f [12, 16, B], r [6, 16, B]).  Kernel:
    csrc/fused.cu k_miller_precompute (six threads a lane over
    team_schedule.py's rounds, the Frobenius bases made in the kernel),
    replacing pallas_fused.py:_miller_call_impl and the JAX package's
    Frobenius tail after it."""
    kinds = _step_kinds("miller_precompute", kinds)
    if not on_cuda(p):
        return miller_precompute_plain(q, p, kinds)
    batch = p.shape[-1]
    check("miller_precompute", batch, p.device, (q, (4,)), (p, (2,)))
    f = torch.empty((12, N, batch), dtype=torch.int32, device=p.device)
    r = torch.empty((6, N, batch), dtype=torch.int32, device=p.device)
    steps = TS.device_kinds(kinds)
    launch("miller_precompute", batch, _digits_on(steps, p.device).data_ptr(),
           len(steps), p.data_ptr(), q.data_ptr(), f.data_ptr(), r.data_ptr())
    return f, r


def fq2_mul(a, b):
    """Fq2 product [2, 16, B] x [2, 16, B] in the lazy-reduction spelling
    (2 Montgomery reductions).  Kernel: csrc/fused.cu k_fq2_mul_fused,
    replacing pallas_fused.py _call_impl("fq2_mul")."""
    if not on_cuda(a):
        return fq2_mul_lazy_plain(a, b)
    batch = a.shape[-1]
    check("fq2_mul_fused", batch, a.device, (a, (2,)), (b, (2,)))
    out = torch.empty_like(a)
    launch("fq2_mul_fused", batch, a.data_ptr(), b.data_ptr(), out.data_ptr())
    return out


def fq2_sqr(a):
    """Complex Fq2 square [2, 16, B].  Kernel: csrc/fused.cu
    k_fq2_sqr_fused (a pair of threads a lane, one output coefficient a
    thread), replacing pallas_fused.py _call_impl("fq2_sqr")."""
    if not on_cuda(a):
        return fq2_sqr_fused_plain(a)
    batch = a.shape[-1]
    check("fq2_sqr_fused", batch, a.device, (a, (2,)))
    out = torch.empty_like(a)
    launch("fq2_sqr_fused", batch, a.data_ptr(), out.data_ptr())
    return out


def fq12_sqr(a):
    """Fq12 square [12, 16, B] (fq12.rs:295-303). Kernel: one step of
    csrc/fused.cu k_miller_loop with a square and no line (six threads a
    lane), replacing pallas_fused.py _call_impl("fq12_sqr")."""
    if not on_cuda(a):
        return fq12_sqr_plain(a)
    batch = a.shape[-1]
    check("fq12_sqr", batch, a.device, (a, (12,)))
    out = torch.empty_like(a)
    launch("fq12_sqr", batch, a.data_ptr(), out.data_ptr())
    return out


def g2_precompute(q, kinds):
    """The lines of pairing_torch.precompute in one kernel: R = (qx, qy, 1), then
    per kind a G2 doubling step (0) or a mixed addition of the kind's base
    (STEP_KINDS), and each step's raw line (ell_0, ell_vw, ell_vv).

    q: affine G2 [4, 16, B]; kinds: n ints, the same for every lane.
    Returns the lines [n, 6, 16, B], the layout miller_loop takes.  Kernel:
    csrc/fused.cu k_g2_precompute (four threads a lane over
    precompute_schedule.py's rounds, the Frobenius bases made in the
    kernel), serving rows 14 and 7 as pairing_jax.precompute's scan runs
    them."""
    kinds = _step_kinds("g2_precompute", kinds)
    if not on_cuda(q):
        return g2_precompute_plain(q, kinds)
    batch, n = q.shape[-1], len(kinds)
    check("g2_precompute", batch, q.device, (q, (4,)))
    lines = torch.empty((n, 6, N, batch), dtype=torch.int32, device=q.device)
    launch("g2_precompute", batch, _digits_on(kinds, q.device).data_ptr(), n, q.data_ptr(),
           lines.data_ptr())
    return lines


def g2_dbl_step(r):
    """G2 Miller doubling step and its line: r [6, 16, B] Jacobian ->
    (r' [6, 16, B], (ell_0, ell_vw, ell_vv) [6, 16, B]).  Kernel: one step
    of csrc/fused.cu k_g2_precompute (four threads a lane), replacing
    pallas_fused.py _call_impl("g2_dbl_step")."""
    if not on_cuda(r):
        return g2_dbl_step_plain(r)
    batch = r.shape[-1]
    check("g2_dbl_step", batch, r.device, (r, (6,)))
    nr, c = torch.empty_like(r), torch.empty_like(r)
    launch("g2_dbl_step", batch, r.data_ptr(), nr.data_ptr(), c.data_ptr())
    return nr, c


def g2_add_step(r, base):
    """G2 mixed addition step and its line: r [6, 16, B] Jacobian, base
    [4, 16, B] affine -> (r' [6, 16, B], (ell_0, ell_vw, ell_vv) [6, 16, B]).
    Kernel: one step of csrc/fused.cu k_g2_precompute (four threads a
    lane), replacing pallas_fused.py _call_impl("g2_add_step")."""
    if not on_cuda(r):
        return g2_add_step_plain(r, base)
    batch = r.shape[-1]
    check("g2_add_step", batch, r.device, (r, (6,)), (base, (4,)))
    nr, c = torch.empty_like(r), torch.empty_like(r)
    launch("g2_add_step", batch, r.data_ptr(), base.data_ptr(), nr.data_ptr(),
           c.data_ptr())
    return nr, c


def fq12_fold_line(f, c, px, py):
    """f * line with ell_vv*px and ell_vw*py fused in: f [12, 16, B], c
    (ell_0, ell_vw, ell_vv) [6, 16, B], px, py [16, B] -> [12, 16, B].
    Kernel: one step of csrc/fused.cu k_miller_loop with a line and no
    square (six threads a lane), replacing pallas_fused.py
    _call_impl("fq12_fold_line")."""
    if not on_cuda(f):
        return fq12_fold_line_plain(f, c, px, py)
    batch = f.shape[-1]
    check("fq12_fold_line", batch, f.device, (f, (12,)), (c, (6,)), (px, ()), (py, ()))
    out = torch.empty_like(f)
    launch("fq12_fold_line", batch, f.data_ptr(), c.data_ptr(), px.data_ptr(),
           py.data_ptr(), out.data_ptr())
    return out


def miller_loop(coeffs, px, py, flags):
    """The prepared Miller loop in one kernel: f = 1, then for each of the
    n line-coefficient triples f = f^2 where its flag is set and f = f *
    line, ell_vv scaled by px and ell_vw by py.

    coeffs: [n, 6, 16, B] (ell_0, ell_vw, ell_vv a step, as
    pairing_torch.precompute stacks them); px, py: [16, B]; flags: n square
    flags, the same for every lane.  Returns f [12, 16, B].  Kernel:
    csrc/fused.cu k_miller_loop (six threads a lane over
    loop_schedule.py's rounds), serving rows 13 and 8 as
    pairing_jax.miller_loop's scan runs them."""
    if not on_cuda(px):
        return miller_loop_plain(coeffs, px, py, flags)
    batch, n = px.shape[-1], len(flags)
    check("miller_loop", batch, px.device, (coeffs, (n, 6)), (px, ()), (py, ()))
    f = torch.empty((12, N, batch), dtype=torch.int32, device=px.device)
    d_flags = _digits_on(np.asarray(flags, dtype=np.int32), px.device)
    launch("miller_loop", batch, d_flags.data_ptr(), n, coeffs.data_ptr(), px.data_ptr(),
           py.data_ptr(), f.data_ptr())
    return f


def fq12_mul(a, b):
    """Fq12 product [12, 16, B] x [12, 16, B]. Kernel: csrc/fused.cu
    k_fq12_mul (six threads a lane), replacing pallas_fused.py
    _call_impl("fq12_mul")."""
    if not on_cuda(a):
        return fq12_mul_plain(a, b)
    batch = a.shape[-1]
    check("fq12_mul", batch, a.device, (a, (12,)), (b, (12,)))
    out = torch.empty_like(a)
    launch("fq12_mul", batch, a.data_ptr(), b.data_ptr(), out.data_ptr())
    return out


def fq12_cyc_sqr(a):
    """Granger-Scott cyclotomic square [12, 16, B]. Kernel: csrc/fused.cu
    k_fq12_cyc_sqr, replacing pallas_fused.py _call_impl("fq12_cyc_sqr")."""
    if not on_cuda(a):
        return fq12_cyc_sqr_plain(a)
    batch = a.shape[-1]
    check("fq12_cyc_sqr", batch, a.device, (a, (12,)))
    out = torch.empty_like(a)
    launch("fq12_cyc_sqr", batch, a.data_ptr(), out.data_ptr())
    return out


def fq12_cyc_pow(a, digits):
    """Cyclotomic-square ladder a^e over MSB-first digits (leading digit
    dropped): digit 1 multiplies by a, digit 2 by its conjugate.  With NAF
    digits the result is a^e only in the cyclotomic subgroup; with binary
    digits it is the formula-pinned ladder for any Fq12.  a: [12, 16, B].
    Kernel: csrc/fused.cu k_fq12_cyc_pow, replacing pallas_fused.py
    _pow_call_impl("fq12_cyc_pow")."""
    if not on_cuda(a):
        return fq12_cyc_pow_plain(a, digits)
    batch = a.shape[-1]
    check("fq12_cyc_pow", batch, a.device, (a, (12,)))
    out = torch.empty_like(a)
    launch("fq12_cyc_pow", batch, _digits_on(digits, a.device).data_ptr(),
           len(digits), a.data_ptr(), out.data_ptr())
    return out


def point_add(ncoords: int, p, q):
    """Unified Jacobian add of packed points [3c, 16, B] (c = ncoords: 1 for
    G1 over Fq, 2 for G2 over Fq2).  Kernel: csrc/groups.cu k_point_add,
    replacing pallas_fused.py _call_impl("g1_add"/"g2_add") (k_point_add)."""
    if not on_cuda(p):
        return point_add_plain(ncoords, p, q)
    _coord(ncoords)
    batch = p.shape[-1]
    check("point_add", batch, p.device, (p, (3 * ncoords,)), (q, (3 * ncoords,)))
    out = torch.empty_like(p)
    launch("point_add", batch, ncoords, p.data_ptr(), q.data_ptr(), out.data_ptr())
    return out


def point_double(ncoords: int, p):
    """dbl-2009-l doubling of packed points [3c, 16, B].  Kernel:
    csrc/groups.cu k_point_double, replacing pallas_fused.py
    _call_impl("g1_dbl"/"g2_dbl") (k_point_double)."""
    if not on_cuda(p):
        return point_double_plain(ncoords, p)
    _coord(ncoords)
    batch = p.shape[-1]
    check("point_double", batch, p.device, (p, (3 * ncoords,)))
    out = torch.empty_like(p)
    launch("point_double", batch, ncoords, p.data_ptr(), out.data_ptr())
    return out


def _combine_lanes(totals) -> int:
    """The lane count of window totals [W, 3c, 16, lanes]: a power of two,
    which the lane fold needs."""
    lanes = totals.shape[-1]
    if lanes < 1 or lanes & (lanes - 1):
        raise ValueError(f"msm_combine: the lane fold needs a power-of-two lane count, "
                         f"got {lanes}")
    return lanes


COMBINE_BLOCK = 128             # csrc/groups.cu's block size (BN254_THREADS)


def msm_combine(ncoords: int, totals, c: int):
    """The window totals [W, 3c, 16, lanes] (lanes a power of two) summed:
    Horner over the windows, high to low (c doubles and one add a window),
    then the lane fold -> [3c, 16, 1].  Kernel: csrc/groups.cu
    k_msm_combine (one thread a lane, then a tree over each block's lanes
    and, from 256 lanes, a second launch over the block partials), serving
    pallas_fused.py k_point_double / k_point_add (pf:769/789) as msm.py's
    Horner scan and roll fold run them."""
    lanes = _combine_lanes(totals)
    if not on_cuda(totals):
        return msm_combine_plain(ncoords, totals, c)
    _coord(ncoords)
    W = totals.shape[0]
    _want("msm_combine", totals, torch.int32, (W, 3 * ncoords, N, lanes), totals.device)
    if W < 1 or c < 0 or totals.numel() >= 1 << 31:
        raise ValueError(f"msm_combine: want W >= 1 windows and c >= 0, got "
                         f"{tuple(totals.shape)}, c={c}")
    blocks = lanes // COMBINE_BLOCK if lanes > COMBINE_BLOCK else 0
    scratch = torch.empty(3 * ncoords * N * (blocks + blocks // COMBINE_BLOCK),
                          dtype=torch.int32, device=totals.device)
    out = torch.empty((3 * ncoords, N, 1), dtype=torch.int32, device=totals.device)
    launch("msm_combine", lanes, ncoords, totals.data_ptr(), W, c, scratch.data_ptr(),
           out.data_ptr())
    return out


def point_mul(ncoords: int, p, k_limbs, num_bits: int):
    """k * p by MSB-first double-and-add over a fixed num_bits (at most
    256): packed points [3c, 16, B], canonical scalar limbs [16, B] int32.
    Leading zero bits keep res at (0, 1, 0).  Kernel: csrc/groups.cu
    k_point_mul (one thread a lane, the add only where the bit is set),
    serving pallas_fused.py k_point_double / k_point_add (pf:769/789) as
    the JAX package's scalar_mul scan runs them."""
    if not 0 <= num_bits <= N * L.LIMB_BITS:
        raise ValueError(f"point_mul: num_bits must be in [0, {N * L.LIMB_BITS}], got "
                         f"{num_bits}")
    if not on_cuda(p):
        return point_mul_plain(ncoords, p, k_limbs, num_bits)
    _coord(ncoords)
    batch = p.shape[-1]
    check("point_mul", batch, p.device, (p, (3 * ncoords,)), (k_limbs, ()))
    out = torch.empty_like(p)
    launch("point_mul", batch, ncoords, p.data_ptr(), k_limbs.data_ptr(), num_bits,
           out.data_ptr())
    return out


def to_affine(ncoords: int, p):
    """(affine (x, y) [2c, 16, B], inf [B] bool) of packed Jacobian points
    [3c, 16, B]; points at infinity give (0, 0).  Kernel: csrc/groups.cu
    k_to_affine (one Fermat chain a block, Montgomery's trick within it,
    K lanes a thread: to_affine_geometry), serving
    pallas_kernels.py's mont_mul, mont_sqr, fq2_mul, fq2_sqr and
    pallas_fused.py's fq_pow (pk:239/247/175/181, pf:1246) as
    bn254_tpu/groups.py to_affine and bn254_tpu/msm.py:133-156 run them."""
    if not on_cuda(p):
        return to_affine_plain(ncoords, p)
    _coord(ncoords)
    batch = p.shape[-1]
    check("to_affine", batch, p.device, (p, (3 * ncoords,)))
    digits = _digits_on(pow_digits(C.Q - 2), p.device)
    out = torch.empty((2 * ncoords, N, batch), dtype=torch.int32, device=p.device)
    inf = torch.empty(batch, dtype=torch.bool, device=p.device)
    launch("to_affine", batch, ncoords, digits.data_ptr(), digits.numel(), p.data_ptr(),
           out.data_ptr(), inf.data_ptr())
    return out, inf


def glv_ladder(ncoords: int, pts, digits):
    """The joint GLV ladder over a per-lane table, one kernel.

    pts: p1 | p2 | p12 packed [9c, 16, B] (signs applied); digits: int32
    [nsteps, B] in {0, 1, 2, 3} = bit(k1) + 2 bit(k2), MSB first, one
    column per lane.  Returns the Jacobian result [3c, 16, B]; res starts
    at (0, 1, 0).  Kernel: csrc/groups.cu k_glv_ladder, replacing
    pallas_fused.py _glv_call_impl (glv_ladder)."""
    if not on_cuda(pts):
        return glv_ladder_plain(ncoords, pts, digits)
    _coord(ncoords)
    batch = pts.shape[-1]
    check("glv_ladder", batch, pts.device, (pts, (9 * ncoords,)))
    if (digits.dtype != torch.int32 or digits.dim() != 2 or digits.shape[1] != batch
            or digits.device != pts.device or not digits.is_contiguous()):
        raise ValueError(f"glv_ladder: want contiguous int32 digits [nsteps, {batch}] on "
                         f"{pts.device}, got {digits.dtype} {tuple(digits.shape)} on "
                         f"{digits.device}")
    lo, hi = (int(v) for v in torch.aminmax(digits))
    if lo < 0 or hi > 3:
        raise ValueError(f"glv_ladder: digits in [{lo}, {hi}], want [0, 3]")
    out = torch.empty((3 * ncoords, N, batch), dtype=torch.int32, device=pts.device)
    launch("glv_ladder", batch, ncoords, digits.data_ptr(), digits.shape[0],
           pts.data_ptr(), out.data_ptr())
    return out


def _msm_shape(name, digits, nb, lanes):
    """(W, n) of int32 digits [W, n] that the three MSM kernels take."""
    if digits.dtype != torch.int32 or digits.dim() != 2 or not digits.is_contiguous():
        raise ValueError(f"{name}: digits must be a contiguous int32 [W, n] tensor, got "
                         f"{digits.dtype} {tuple(digits.shape)}")
    W, n = digits.shape
    if lanes < 1 or n % lanes or nb < 2 or W * n >= 1 << 31 or W * nb * lanes >= 1 << 31:
        raise ValueError(f"{name}: want lanes dividing n and nb >= 2, got n={n}, "
                         f"lanes={lanes}, nb={nb}, W={W}")
    return W, n


def _want(name, t, dtype, shape, device):
    if t.dtype != dtype or tuple(t.shape) != tuple(shape) or t.device != device \
            or not t.is_contiguous():
        raise ValueError(f"{name}: want a contiguous {dtype} tensor of shape {tuple(shape)} on "
                         f"{device}, got {t.dtype} {tuple(t.shape)} on {t.device}")


def msm_bucket_sort(digits, nb: int, signed: bool = True, lanes: int = 1024):
    """Stable counting sort of each (window, lane)'s tiles by bucket ->
    (offsets int32 [W, nb, lanes], order int32 [W, n/lanes, lanes]), as
    ``msm_bucket_sort_plain`` spells out.  Kernel: csrc/groups.cu
    k_msm_bucket_sort, serving pallas_fused.py _msm_acc_impl."""
    if not on_cuda(digits):
        return msm_bucket_sort_plain(digits, nb, signed, lanes)
    W, n = _msm_shape("msm_bucket_sort", digits, nb, lanes)
    lo, hi = (int(v) for v in torch.aminmax(digits))
    if lo < (-(nb - 1) if signed else 0) or hi > nb - 1:
        raise ValueError(f"msm_bucket_sort: digits in [{lo}, {hi}] do not fit "
                         f"{nb} {'signed' if signed else 'unsigned'} buckets")
    offsets = torch.empty((W, nb, lanes), dtype=torch.int32, device=digits.device)
    order = torch.empty((W, n // lanes, lanes), dtype=torch.int32, device=digits.device)
    launch("msm_bucket_sort", lanes, digits.data_ptr(), offsets.data_ptr(), order.data_ptr(),
           n, W, nb, int(signed))
    return offsets, order


def _msm_buckets(ncoords: int, words, digits, offsets, order, nb: int, signed: bool,
                 lanes: int):
    """Every (window, bucket, lane)'s run added up in tile order ->
    buckets [W, nb-1, 3c, 16, lanes].  Kernel: csrc/groups.cu
    k_msm_accumulate (row 19's accumulation); no plain version of its own:
    ``msm_accumulate_plain`` holds the three kernels together."""
    W, n = _msm_shape("msm_accumulate", digits, nb, lanes)
    dev = digits.device
    _want("msm_accumulate", words, torch.int32, (n, 2 * ncoords, 8), dev)
    _want("msm_accumulate", offsets, torch.int32, (W, nb, lanes), dev)
    _want("msm_accumulate", order, torch.int32, (W, n // lanes, lanes), dev)
    buckets = torch.empty((W, nb - 1, 3 * ncoords, N, lanes), dtype=torch.int32, device=dev)
    launch("msm_accumulate", lanes, ncoords, words.data_ptr(), digits.data_ptr(),
           offsets.data_ptr(), order.data_ptr(), buckets.data_ptr(), n, W, nb, int(signed))
    return buckets


def msm_bucket_reduce(ncoords: int, buckets):
    """Running-sum reduce of buckets [W, nb-1, 3c, 16, lanes] -> window
    totals [W, 3c, 16, lanes].  Kernel: csrc/groups.cu
    k_msm_bucket_reduce, serving pallas_fused.py _msm_acc_impl."""
    if not on_cuda(buckets):
        return msm_bucket_reduce_plain(ncoords, buckets)
    _coord(ncoords)
    if buckets.dim() != 5:
        raise ValueError(f"msm_bucket_reduce: want buckets [W, nb-1, 3c, 16, lanes], got "
                         f"{tuple(buckets.shape)}")
    W, nb1, _, _, lanes = buckets.shape
    _want("msm_bucket_reduce", buckets, torch.int32, (W, nb1, 3 * ncoords, N, lanes),
          buckets.device)
    if nb1 < 1 or W * lanes >= 1 << 31:
        raise ValueError(f"msm_bucket_reduce: no buckets in {tuple(buckets.shape)}")
    out = torch.empty((W, 3 * ncoords, N, lanes), dtype=torch.int32, device=buckets.device)
    launch("msm_bucket_reduce", lanes, ncoords, buckets.data_ptr(), out.data_ptr(), W, nb1 + 1)
    return out


def msm_accumulate(ncoords: int, points, digits, nb: int, signed: bool = True,
                   lanes: int = 1024):
    """Bucket-accumulate and reduce every window of a Pippenger MSM.

    points: affine [2c, 16, n] (infinity, padding and masked points must
    carry digit 0); digits: int32 [W, n], in (-nb, nb) if signed (bucket
    |d|, y negated for d < 0), else in [0, nb); bucket 0 discards.  Each
    of the `lanes` lanes is an independent Pippenger sub-problem over the
    points i with i % lanes == lane.  Returns the window totals
    [W, 3c, 16, lanes].  On the card (pallas_fused.py _msm_acc_impl,
    msm_accumulate): the bucket sort, the point-major copy
    (``msm_point_words``), the accumulation (csrc/groups.cu
    k_msm_accumulate) and the reduce, three kernels."""
    if not on_cuda(points):
        return msm_accumulate_plain(ncoords, points, digits, nb, signed, lanes)
    _coord(ncoords)
    W, n = _msm_shape("msm_accumulate", digits, nb, lanes)
    check("msm_accumulate", n, points.device, (points, (2 * ncoords,)))
    if digits.device != points.device:
        raise ValueError("msm_accumulate: digits must be on the points' device")
    offsets, order = msm_bucket_sort(digits, nb, signed, lanes)
    buckets = _msm_buckets(ncoords, msm_point_words(points), digits, offsets, order, nb,
                           signed, lanes)
    return msm_bucket_reduce(ncoords, buckets)
