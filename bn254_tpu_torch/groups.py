"""Batched G1/G2 points on tensors — counterpart of bn254_tpu/groups.py,
the part the pairing needs: the op tables, the point codecs, to_affine and
the infinity predicate.  The group law (add, double, scalar_mul) is not
ported yet.

A point batch is a Jacobian triple (x, y, z) of base-field batches; the
identity is (0, 1, 0), carried by z == 0 alone, as in the reference
(mod.rs:229-236).
"""

from __future__ import annotations

from . import tower as T
from .fields import FQ


# ---------------------------------------------------------------------------
# Base-field op tables (the ops to_affine and the codecs use; the group law
# adds its own when it is ported)
# ---------------------------------------------------------------------------

class DevFq:
    """Fq ops in the shape the generic point code wants."""
    mul = staticmethod(FQ.mul)
    sqr = staticmethod(FQ.sqr)
    inv = staticmethod(FQ.inv)
    is_zero = staticmethod(FQ.is_zero)
    encode = staticmethod(FQ.encode)
    decode = staticmethod(FQ.decode)


class DevFq2:
    """Fq2 ops in the same shape (the G2 twist's base field)."""
    mul = staticmethod(T.fq2_mul)
    sqr = staticmethod(T.fq2_sqr)
    inv = staticmethod(T.fq2_inv)
    is_zero = staticmethod(T.fq2_is_zero)
    encode = staticmethod(T.fq2_encode)
    decode = staticmethod(T.fq2_decode)


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


def is_zero_point(K, p):
    return K.is_zero(p[2])


def to_affine(K, p):
    """((x, y), inf_mask): one Fermat inversion per element (mod.rs:198-217).

    Infinity slots (z = 0, inverted to 0) return (0, 0) and inf_mask True;
    callers select on the mask (the pairing maps them to f = 1)."""
    zinv = K.inv(p[2])
    zi2 = K.sqr(zinv)
    x = K.mul(p[0], zi2)
    y = K.mul(p[1], K.mul(zi2, zinv))
    return (x, y), is_zero_point(K, p)


# Convenience aliases
G1 = DevFq
G2 = DevFq2
