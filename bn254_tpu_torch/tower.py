"""Batched field tower Fq2/Fq6/Fq12 on tensors — counterpart of
bn254_tpu/tower.py, the same formulas in the same order.

Elements are nested tuples of Montgomery Fq batches ([16, B] int32):

* Fq2  = (c0, c1)              — Fq[i]/(i^2+1)
* Fq6  = (c0, c1, c2) of Fq2   — Fq2[v]/(v^3 - xi), xi = 9+i
* Fq12 = (c0, c1) of Fq6       — Fq6[w]/(w^2 - v)

Where the JAX package runs a Pallas kernel on the TPU, this module always
calls the port's kernel wrapper (which takes the plain version on the
CPU): ``fq2_mul``/``fq2_sqr`` (rows 3-4), ``fq12_mul`` (row 9),
``fq12_cyclotomic_sqr`` (row 10), the cyclotomic z-ladders (row 11) and
``fq12_sqr`` (row 13).  ``fq2_sqrt`` (the JAX package's scans over rows
3-4), ``fq12_inv``, ``fq12_frob`` and ``fq12_conj``, tower glue on the
TPU, are kernels of their own here, and
the final exponentiation runs on packed tensors from kernel to kernel.
The rest composes them with plain tensor adds, as the JAX package
composes them with jnp.
"""

from __future__ import annotations

from . import fused as FU
from . import mont_kernels as MK
from .convert import pack, unpack_fq12
from .fields import FQ

F = FQ  # the base-field context


# ---------------------------------------------------------------------------
# Fq2
# ---------------------------------------------------------------------------

def fq2_encode(vals, device):
    """Iterable of (c0, c1) int pairs -> Fq2 batch on device."""
    vals = list(vals)
    return (F.encode([v[0] for v in vals], device),
            F.encode([v[1] for v in vals], device))


def fq2_decode(a):
    return list(zip(F.decode(a[0]), F.decode(a[1])))


def fq2_zeros(batch, device):
    return (F.zeros(batch, device), F.zeros(batch, device))


def fq2_ones(batch, device):
    return (F.ones(batch, device), F.zeros(batch, device))


def fq2_const(pair, batch, device):
    return (F.const(pair[0], batch, device), F.const(pair[1], batch, device))


def fq2_add(a, b):
    return (F.add(a[0], b[0]), F.add(a[1], b[1]))


def fq2_sub(a, b):
    return (F.sub(a[0], b[0]), F.sub(a[1], b[1]))


def fq2_neg(a):
    return (F.neg(a[0]), F.neg(a[1]))


def fq2_scale(a, k):
    """Scale by an Fq batch (fq2.rs:48)."""
    return (F.mul(a[0], k), F.mul(a[1], k))


def fq2_mul(a, b):
    """Karatsuba with i^2 = -1 (fq2.rs:133-149): the fq2_mul kernel."""
    out = MK.fq2_mul(pack(a), pack(b))
    return (out[0], out[1])


def fq2_sqr(a):
    """Complex squaring (fq2.rs:105-117): the fq2_sqr kernel."""
    out = MK.fq2_sqr(pack(a))
    return (out[0], out[1])


def _mul9(x):
    d = F.double(F.double(F.double(x)))
    return F.add(d, x)


def fq2_mul_by_xi(a):
    """a * (9 + i) via shift-add (value-identical to fq2.rs:55)."""
    return (F.sub(_mul9(a[0]), a[1]), F.add(_mul9(a[1]), a[0]))


def fq2_inv(a):
    """Norm inversion (fq2.rs:119-130); 0 -> 0 branchlessly."""
    t = F.inv(F.add(F.sqr(a[0]), F.sqr(a[1])))
    return (F.mul(a[0], t), F.neg(F.mul(a[1], t)))


def fq2_conj(a):
    """Frobenius for odd powers = conjugation (fq2.rs:59-68)."""
    return (a[0], F.neg(a[1]))


def fq2_is_zero(a):
    return F.is_zero(a[0]) & F.is_zero(a[1])


def fq2_eq(a, b):
    return F.eq(a[0], b[0]) & F.eq(a[1], b[1])


def fq2_select(mask, a, b):
    return (F.select(mask, a[0], b[0]), F.select(mask, a[1], b[1]))


def fq2_sqrt(a):
    """(root, ok): the complex-method square root (fq2.rs:208-224), the
    fq2_sqrt kernel (fused.fq2_sqrt: one launch, the plain version on the
    CPU).  The reference's root wherever a is a residue (0 included); ok
    is False exactly on non-residues."""
    out, ok = FU.fq2_sqrt(pack(a))
    return (out[0], out[1]), ok


# ---------------------------------------------------------------------------
# Fq6
# ---------------------------------------------------------------------------

def fq6_encode(vals, device):
    vals = list(vals)
    return tuple(fq2_encode([v[k] for v in vals], device) for k in range(3))


def fq6_decode(a):
    cs = [fq2_decode(c) for c in a]
    return list(zip(*cs))


def fq6_zeros(batch, device):
    return tuple(fq2_zeros(batch, device) for _ in range(3))


def fq6_ones(batch, device):
    return (fq2_ones(batch, device), fq2_zeros(batch, device),
            fq2_zeros(batch, device))


def fq6_select(mask, a, b):
    return tuple(fq2_select(mask, x, y) for x, y in zip(a, b))


# ---------------------------------------------------------------------------
# Fq12
# ---------------------------------------------------------------------------

def fq12_encode(vals, device):
    vals = list(vals)
    return (fq6_encode([v[0] for v in vals], device),
            fq6_encode([v[1] for v in vals], device))


def fq12_decode(a):
    return list(zip(fq6_decode(a[0]), fq6_decode(a[1])))


def fq12_ones(batch, device):
    return (fq6_ones(batch, device), fq6_zeros(batch, device))


def fq12_mul(a, b):
    """Karatsuba over Fq6 (fq12.rs:316-328): the fq12_mul kernel."""
    return unpack_fq12(FU.fq12_mul(pack(a), pack(b)))


def fq12_sqr(a):
    """(fq12.rs:295-303): the fq12_sqr kernel."""
    return unpack_fq12(FU.fq12_sqr(pack(a)))


def fq12_inv(a):
    """(fq12.rs:305-313); 0 -> 0 branchlessly: the fq12_inv kernel."""
    return unpack_fq12(FU.fq12_inv(pack(a)))


def fq12_conj(a):
    """Unitary inverse (fq12.rs:126): the fq12_frob kernel's conjugation."""
    return unpack_fq12(FU.fq12_frob(pack(a), FU.CONJ))


def fq12_frob(a, power: int):
    """(fq12.rs:112-119), power 1, 2 or 3: the fq12_frob kernel."""
    return unpack_fq12(FU.fq12_frob(pack(a), power))


def fq12_select(mask, a, b):
    return (fq6_select(mask, a[0], b[0]), fq6_select(mask, a[1], b[1]))


def fq12_mul_by_024(a, ell_0, ell_vv, ell_vw):
    """Sparse line multiplication, 13 Fq2 muls (fq12.rs:130-196); argument
    order (x0, x2, x4) = (ell_0, ell_vv, ell_vw) as the JAX package.  The
    Miller loops fold lines on the fold kernel (row 8) instead, whose plain
    version (fused._mul_by_024) is the same formula."""
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
    t4 = fq2_add(fq2_mul_by_xi(t3), d0)
    nz0 = t4

    t3 = fq2_mul(z5, x4)
    s1 = fq2_add(s1, t3)
    t3 = fq2_add(t3, d2)
    t4 = fq2_mul_by_xi(t3)
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
    t4 = fq2_mul_by_xi(t3)
    t3 = fq2_mul(z3, x0)
    s1 = fq2_add(s1, t3)
    t4 = fq2_add(t4, t3)
    nz3 = t4

    t3 = fq2_mul(z5, x2)
    s1 = fq2_add(s1, t3)
    t4 = fq2_mul_by_xi(t3)
    t0 = fq2_add(x0, x4)
    t3 = fq2_sub(fq2_sub(fq2_mul(t2, t0), d0), d4)
    t4 = fq2_add(t4, t3)
    nz4 = t4

    t0 = fq2_add(fq2_add(x0, x2), x4)
    t3 = fq2_sub(fq2_mul(s0, t0), s1)
    nz5 = t3

    return ((nz0, nz1, nz2), (nz3, nz4, nz5))


def fq12_cyclotomic_sqr(a):
    """Granger-Scott squaring in the cyclotomic subgroup (fq12.rs:198-247):
    the fq12_cyc_sqr kernel."""
    return unpack_fq12(FU.fq12_cyc_sqr(pack(a)))


def fq12_cyclotomic_pow_z(a):
    """a^z for the BN parameter z (fq12.rs:249-267): the cyclotomic ladder
    kernel over z's binary digits (27 multiplies), formula-pinned and so
    valid for any Fq12, like the reference's cyclotomic_pow."""
    return unpack_fq12(FU.fq12_cyc_pow(pack(a), FU.BINARY_Z))


def fq12_exp_by_neg_z(a):
    """(fq12.rs:121-124)."""
    return fq12_conj(fq12_cyclotomic_pow_z(a))


def _exp_by_neg_z_unitary(x):
    """fq12_exp_by_neg_z_unitary on a packed [12, 16, B] Fq12."""
    return FU.fq12_frob(FU.fq12_cyc_pow(x, FU.NAF_Z), FU.CONJ)


def fq12_exp_by_neg_z_unitary(a):
    """exp_by_neg_z for inputs known to lie in the cyclotomic subgroup
    G_phi6(q^2) — every call site inside the final exponentiation.  The
    NAF ladder (23 multiplies; digit -1 multiplies by the conjugate, the
    free inverse there).  NOT valid for arbitrary Fq12."""
    return unpack_fq12(_exp_by_neg_z_unitary(pack(a)))


def final_exp_easy(x):
    """The easy part (conj(a) / a)^(q^2 + 1) on a packed [12, 16, B] Fq12:
    the inverse, the conjugation, a Frobenius map and two products."""
    c = FU.fq12_mul(FU.fq12_frob(x, FU.CONJ), FU.fq12_inv(x))
    return FU.fq12_mul(FU.fq12_frob(c, 2), c)


def final_exp_hard(f):
    """The hard part (Scott et al.) on a packed cyclotomic [12, 16, B] Fq12:
    three NAF z-ladders, three cyclotomic squares, nine products, three
    Frobenius maps and three conjugations (besides the ladders' three)."""
    mul, frob, cyc_sqr = FU.fq12_mul, FU.fq12_frob, FU.fq12_cyc_sqr
    a_ = _exp_by_neg_z_unitary(f)
    b = cyc_sqr(a_)
    c2 = cyc_sqr(b)
    d = mul(c2, b)

    e = _exp_by_neg_z_unitary(d)
    f2 = cyc_sqr(e)
    g = _exp_by_neg_z_unitary(f2)
    h = frob(d, FU.CONJ)
    i = frob(g, FU.CONJ)

    j = mul(i, e)
    k = mul(j, h)
    l = mul(k, b)
    m = mul(k, e)
    n = mul(f, m)

    o = frob(l, 1)
    p = mul(o, n)

    q = frob(k, 2)
    r = mul(q, p)

    s = frob(f, FU.CONJ)
    t = mul(s, l)
    u = frob(t, 3)
    return mul(u, r)


def fq12_final_exponentiation(a):
    """Easy chunk + Scott et al. hard chunk (fq12.rs:62-110), on one packed
    [12, 16, B] tensor from the input to the output: every step is a
    kernel wrapper (fq12_inv, fq12_frob, fq12_mul, fq12_cyc_sqr,
    fq12_cyc_pow).

    Branchless: a non-invertible (zero) input yields 0, never produced by
    the Miller loop."""
    return unpack_fq12(final_exp_hard(final_exp_easy(pack(a))))
