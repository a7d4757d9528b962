"""Byte codecs: canonical big-endian field encodings, U512 interpretation,
and compressed-point formats, with the reference crate's exact semantics.

Formats (reference src/lib.rs):
  * Fr from 32B:  UNREDUCED — implicitly reduced mod r (lib.rs:45-49 via
    fp.rs:57 new_mul_factor).
  * Fq from 32B:  values >= q are rejected (lib.rs:154-159).
  * interpret 64B: 512-bit value reduced via divrem (lib.rs:42-44, :151-153).
  * Fq2 from 64B: decoded as c1*q + c0 via divrem; quotient must be < q
    (lib.rs:260-267).
  * G1 compressed 33B: prefix 0x02/0x03 selects y parity (lib.rs:359-376).
  * G2 compressed 65B: prefix 0x0a/0x0b selects lexicographically smaller /
    larger y as U512 packing c1*q + c0 (lib.rs:506-527).
"""

from . import field as F
from . import group as G
from .constants import Q, R, B1, B2
from ..errors import (
    InvalidSliceLength, InvalidU512Encoding, NotMemberFieldError,
    InvalidEncoding, NotMemberCurveError, NotOnCurve, NotInSubgroup,
)


# --- scalars / base field ---------------------------------------------------

def fr_from_slice(b):
    if len(b) != 32:
        raise InvalidSliceLength("expected 32 bytes")
    return int.from_bytes(b, "big") % R


def fr_to_bytes(a):
    return (a % R).to_bytes(32, "big")


def fq_from_slice(b):
    if len(b) != 32:
        raise InvalidSliceLength("expected 32 bytes")
    v = int.from_bytes(b, "big")
    if v >= Q:
        raise NotMemberFieldError("value >= q")
    return v


def fq_to_bytes(a):
    return (a % Q).to_bytes(32, "big")


def fr_interpret(b):
    if len(b) != 64:
        raise InvalidSliceLength("expected 64 bytes")
    return int.from_bytes(b, "big") % R


def fq_interpret(b):
    if len(b) != 64:
        raise InvalidSliceLength("expected 64 bytes")
    return int.from_bytes(b, "big") % Q


def fq2_from_slice(b):
    """64B -> Fq2 decoded as c1*q + c0 (lib.rs:260-267)."""
    if len(b) != 64:
        raise InvalidU512Encoding("expected 64 bytes")
    v = int.from_bytes(b, "big")
    c1, c0 = divmod(v, Q)
    if c1 >= Q:
        raise NotMemberFieldError("quotient >= q")
    return (c0, c1)


def fq2_to_slice(a):
    return F.fq2_to_u512(a).to_bytes(64, "big")


# --- affine construction with checks ----------------------------------------

def affine_g1_new(x, y):
    """On-curve check; G1 has no subgroup check (groups/mod.rs:95-113 with
    G1Params::check_order = false)."""
    if not G.on_curve(x, y, B1, G.FqOps):
        raise NotOnCurve("G1 point not on curve")
    return (x, y)


def affine_g2_new(x, y):
    """On-curve check plus full order check (G2Params::check_order = true,
    groups/mod.rs:469)."""
    if not G.on_curve(x, y, B2, G.Fq2Ops):
        raise NotOnCurve("G2 point not on curve")
    if not G.in_subgroup(x, y, G.Fq2Ops):
        raise NotInSubgroup("G2 point not in the r-order subgroup")
    return (x, y)


# --- compressed points -------------------------------------------------------

def g1_from_compressed(b):
    """33B, prefix 0x02 (even y) / 0x03 (odd y) (lib.rs:359-376)."""
    if len(b) != 33:
        raise InvalidEncoding("expected 33 bytes")
    sign = b[0]
    try:
        x = fq_from_slice(b[1:])
    except NotMemberFieldError:
        raise NotMemberCurveError("x >= q")
    y2 = (x * x % Q * x + B1) % Q
    y = F.fq_sqrt(y2)
    if y is None:
        raise NotMemberCurveError("x^3 + b is a non-residue")
    if sign == 2:
        if y & 1:
            y = Q - y
    elif sign == 3:
        if not (y & 1):
            y = Q - y
    else:
        raise InvalidEncoding("bad G1 sign prefix")
    try:
        return affine_g1_new(x, y)
    except (NotOnCurve, NotInSubgroup):
        raise NotMemberCurveError("not on curve")


def g1_to_compressed(pt):
    x, y = pt
    prefix = 3 if (y & 1) else 2
    return bytes([prefix]) + fq_to_bytes(x)


def g2_from_compressed(b):
    """65B, prefix 0x0a (lexicographically smaller y) / 0x0b (larger y)
    (lib.rs:506-527)."""
    if len(b) != 65:
        raise InvalidEncoding("expected 65 bytes")
    sign = b[0]
    x = fq2_from_slice(b[1:])
    y2 = F.fq2_add(F.fq2_mul(F.fq2_sqr(x), x), B2)
    y = F.fq2_sqrt(y2)
    if y is None:
        raise NotMemberCurveError("x^3 + b is a non-residue in Fq2")
    y_neg = F.fq2_neg(y)
    y_gt = F.fq2_to_u512(y) > F.fq2_to_u512(y_neg)
    if sign == 10:
        e_y = y_neg if y_gt else y
    elif sign == 11:
        e_y = y if y_gt else y_neg
    else:
        raise InvalidEncoding("bad G2 sign prefix")
    try:
        return affine_g2_new(x, e_y)
    except (NotOnCurve, NotInSubgroup):
        raise NotMemberCurveError("decoded G2 point invalid")


def g2_to_compressed(pt):
    x, y = pt
    y_gt = F.fq2_to_u512(y) > F.fq2_to_u512(F.fq2_neg(y))
    prefix = 11 if y_gt else 10
    return bytes([prefix]) + fq2_to_slice(x)
