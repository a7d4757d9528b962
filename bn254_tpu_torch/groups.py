"""Batched G1/G2 group law on tensors — counterpart of bn254_tpu/groups.py.

A point batch is a Jacobian triple (x, y, z) of base-field batches: Fq
``[16, B]`` tensors for G1, Fq2 pairs of them for G2.  The identity is
(0, 1, 0), carried by z == 0 alone, as in the reference (mod.rs:229-236).

The base field is abstracted by an op table (DevFq / DevFq2), as in the
JAX package.  ``double`` and ``add`` are one kernel each (fused.py
``point_double`` / ``point_add``, queue rows 17-18), for G1 and for G2,
where the JAX package runs ``pallas_fused.point_double`` / ``point_add`` on
the TPU; ``scalar_mul``, the JAX package's scan over them, is one kernel
too (``point_mul``), and so is ``to_affine`` (``to_affine``, a Fermat
inversion a block of lanes); on CPU tensors the wrappers take their plain
versions, which are the JAX package's jnp formulas.  ``add`` is the
unified branchless add (3-way select): it agrees with the reference on
P + inf, inf + Q, P + P, P + (-P) and the generic case.
"""

from __future__ import annotations

from . import fused as FU
from . import limbs as L
from . import tower as T
from .convert import pack, unpack_point
from .fields import FQ
from .spec import constants as C


# ---------------------------------------------------------------------------
# Base-field op tables
# ---------------------------------------------------------------------------

class DevFq:
    """Fq ops in the shape the generic group law wants."""
    COORDS = 1
    add = staticmethod(FQ.add)
    sub = staticmethod(FQ.sub)
    neg = staticmethod(FQ.neg)
    mul = staticmethod(FQ.mul)
    sqr = staticmethod(FQ.sqr)
    inv = staticmethod(FQ.inv)
    is_zero = staticmethod(FQ.is_zero)
    eq = staticmethod(FQ.eq)
    select = staticmethod(FQ.select)
    zeros = staticmethod(FQ.zeros)
    ones = staticmethod(FQ.ones)
    encode = staticmethod(FQ.encode)
    decode = staticmethod(FQ.decode)

    @staticmethod
    def batch_of(a):
        return a.shape[-1]

    # curve parameters (y^2 = x^3 + 3, generator (1, 2); mod.rs:372-402)
    @staticmethod
    def coeff_b(batch, device):
        return FQ.const(C.B1, batch, device)

    @staticmethod
    def generator(batch, device):
        return (FQ.const(C.G1_ONE[0], batch, device), FQ.const(C.G1_ONE[1], batch, device))


class DevFq2:
    """Fq2 ops in the same shape (the G2 twist's base field)."""
    COORDS = 2
    add = staticmethod(T.fq2_add)
    sub = staticmethod(T.fq2_sub)
    neg = staticmethod(T.fq2_neg)
    mul = staticmethod(T.fq2_mul)
    sqr = staticmethod(T.fq2_sqr)
    inv = staticmethod(T.fq2_inv)
    is_zero = staticmethod(T.fq2_is_zero)
    eq = staticmethod(T.fq2_eq)
    select = staticmethod(T.fq2_select)
    zeros = staticmethod(T.fq2_zeros)
    ones = staticmethod(T.fq2_ones)
    encode = staticmethod(T.fq2_encode)
    decode = staticmethod(T.fq2_decode)

    @staticmethod
    def batch_of(a):
        return a[0].shape[-1]

    # y^2 = x^3 + b2, b2 = 3/xi (D-type twist; mod.rs:408-472)
    @staticmethod
    def coeff_b(batch, device):
        return T.fq2_const(C.B2, batch, device)

    @staticmethod
    def generator(batch, device):
        return (T.fq2_const(C.G2_ONE[0], batch, device),
                T.fq2_const(C.G2_ONE[1], batch, device))


# ---------------------------------------------------------------------------
# Host codecs for point batches
# ---------------------------------------------------------------------------

def encode_points(K, pts, device):
    """Iterable of spec Jacobian triples (or None for infinity) -> point
    batch on device.  None becomes (0, 1, 0)."""
    xs, ys, zs = [], [], []
    zero_v, one_v = _spec_zero_one(K)
    for p in pts:
        if p is None:
            xs.append(zero_v); ys.append(one_v); zs.append(zero_v)
        else:
            xs.append(p[0]); ys.append(p[1]); zs.append(p[2])
    return (K.encode(xs, device), K.encode(ys, device), K.encode(zs, device))


def decode_points(K, p):
    """Point batch -> list of spec Jacobian triples."""
    return list(zip(K.decode(p[0]), K.decode(p[1]), K.decode(p[2])))


def _spec_zero_one(K):
    return ((0, 1) if K is DevFq else ((0, 0), (1, 0)))


# ---------------------------------------------------------------------------
# Branchless Jacobian group law
# ---------------------------------------------------------------------------

def _device(K, p):
    return (p[0] if K is DevFq else p[0][0]).device


def zero_point(K, batch, device):
    """(0, 1, 0) (mod.rs:229-236)."""
    return (K.zeros(batch, device), K.ones(batch, device), K.zeros(batch, device))


def generator(K, batch, device):
    g = K.generator(batch, device)
    return (g[0], g[1], K.ones(batch, device))


def is_zero_point(K, p):
    return K.is_zero(p[2])


def double(K, p):
    """dbl-2009-l Jacobian doubling (mod.rs:250-269); maps the identity to
    the identity without branching (z stays 0).  One point_double kernel."""
    return unpack_point(K.COORDS, FU.point_double(K.COORDS, pack(p)))


def add(K, p, q):
    """Unified branchless Jacobian add (mod.rs:294-334): the generic add,
    then p == inf -> q, q == inf -> p, u1 == u2 and s1 == s2 -> double(p);
    the generic formula gives z3 == 0 for P + (-P), like the reference's
    fallthrough.  One point_add kernel."""
    return unpack_point(K.COORDS, FU.point_add(K.COORDS, pack(p), pack(q)))


def neg(K, p):
    """(mod.rs:336-350); the identity is kept by the z == 0 predicate."""
    return (p[0], K.neg(p[1]), p[2])


def eq_points(K, p, q):
    """Projective equality (mod.rs:169-195), branchless -> [B] bool."""
    p_inf = is_zero_point(K, p)
    q_inf = is_zero_point(K, q)
    z1s = K.sqr(p[2])
    z2s = K.sqr(q[2])
    x_eq = K.eq(K.mul(p[0], z2s), K.mul(q[0], z1s))
    y_eq = K.eq(K.mul(p[1], K.mul(z2s, q[2])), K.mul(q[1], K.mul(z1s, p[2])))
    return (p_inf & q_inf) | (~p_inf & ~q_inf & x_eq & y_eq)


def scalar_mul(K, p, k_limbs, num_bits: int = 256):
    """MSB-first double-and-add over a fixed num_bits (mod.rs:272-292), one
    point_mul kernel: per bit a double and, where the bit is set, the add
    of p.  k_limbs: canonical (not Montgomery) scalar limbs [16, B] int32.
    Leading zero bits keep res at the identity, so the result equals the
    reference's bit_length()-bounded loop."""
    return unpack_point(K.COORDS, FU.point_mul(K.COORDS, pack(p), k_limbs, num_bits))


def to_affine(K, p):
    """((x, y), inf_mask) (mod.rs:198-217), one to_affine kernel: the
    inverses of z come from one Fermat inversion a block of lanes shared
    by Montgomery's trick (bn254_tpu/msm.py:133-156), where the JAX
    package's to_affine runs one a point; the values are the same.

    Infinity slots (z = 0, inverted to 0) return (0, 0) and inf_mask True;
    callers select on the mask (the pairing maps them to f = 1, the MSM
    sends them to digit 0)."""
    xy, inf = FU.to_affine(K.COORDS, pack(p))
    if K is DevFq:
        return (xy[0], xy[1]), inf
    return ((xy[0], xy[1]), (xy[2], xy[3])), inf


def to_jacobian(K, xy, inf_mask=None):
    """Affine -> Jacobian; an optional inf_mask puts identities back."""
    batch, device = K.batch_of(xy[0]), _device(K, xy)
    one = K.ones(batch, device)
    z = one if inf_mask is None else K.select(inf_mask, K.zeros(batch, device), one)
    return (xy[0], xy[1], z)


def on_curve(K, xy):
    """y^2 == x^3 + b (mod.rs:94-103) -> [B] bool."""
    batch, device = K.batch_of(xy[0]), _device(K, xy)
    rhs = K.add(K.mul(K.sqr(xy[0]), xy[0]), K.coeff_b(batch, device))
    return K.eq(K.sqr(xy[1]), rhs)


def in_subgroup(K, xy):
    """Order check p*(r-1) + p == identity (mod.rs:104-107) -> [B] bool."""
    batch, device = K.batch_of(xy[0]), _device(K, xy)
    p = to_jacobian(K, xy)
    k = L.broadcast_const(L.limbs_from_int(C.R - 1), batch, device)
    return is_zero_point(K, add(K, scalar_mul(K, p, k), p))


# Convenience aliases
G1 = DevFq
G2 = DevFq2
