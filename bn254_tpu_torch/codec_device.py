"""Batched compressed-point decompression — counterpart of
bn254_tpu/codec_device.py (the ingest path behind G1/G2 from_compressed).

The reference decodes one point at a time on the CPU (lib.rs:359-376 G1
33B, :506-527 G2 65B); the host codec (``spec/codec.py``) matches it
exactly, exceptions and all.  This module is the throughput variant: N
compressed points -> one batched device program (square roots, parity or
lexicographic y selection, the G2 subgroup check), returning Jacobian
batches plus validity masks instead of exceptions — the vector analogue of
the reference's error taxonomy (``errors.py``):

    ok == False covers   InvalidEncoding (bad prefix, wrong length)
                       | NotMember (x >= q, Fq2 quotient >= q,
                                    non-residue, outside the G2 subgroup)

A lane that is not ok holds the identity (z = 0).  Byte parsing (fixed
slicing, the U512 divrem of the Fq2 packing) stays on the host; the field
and curve math runs on the kernels: ``FQ.sqrt`` on row 5 (``fq_pow``),
``tower.fq2_sqrt`` on one launch of its own (``fq2_sqrt``, where the JAX
package scans rows 3-4), the curve equation and the canonical
conversion on rows 1-4, the subgroup check r * P == inf on rows 17-18
(``groups.scalar_mul``).  The entries run on the card unless
``device="cpu"``, where every wrapper takes its plain version.
"""

from __future__ import annotations

import numpy as np
import torch

from . import groups as G
from . import limbs as L
from . import tower as T
from ._build import resolve_device
from .fields import FQ
from .spec import constants as C

__all__ = ["g1_decompress_batch", "g2_decompress_batch",
           "g1_from_compressed_batch", "g2_from_compressed_batch"]


def _limb_gt(a, b):
    """a > b on canonical [n, B] limbs (unsigned): the highest limb where
    they differ decides; equal values give False."""
    top = (a != b).flip(-2).to(torch.int32).argmax(-2, keepdim=True)  # first from the top
    return (a.flip(-2).gather(-2, top) > b.flip(-2).gather(-2, top)).squeeze(-2)


def _canonical(a):
    """Montgomery form -> canonical limbs: a R * 1 * R^-1 = a (row 1)."""
    one = L.broadcast_const(L.limbs_from_int(1), a.shape[-1], a.device)
    return FQ.mul(a, one)


def g1_rhs(xs):
    """x^3 + 3, the G1 curve equation's right side."""
    return FQ.add(FQ.mul(FQ.sqr(xs), xs), FQ.const(C.B1, xs.shape[-1], xs.device))


def g1_select_y(prefixes, y):
    """The root whose parity the prefix names: 0x02 even, 0x03 odd."""
    odd = (_canonical(y)[0] & 1).bool()
    return FQ.select(odd ^ (prefixes == 3), FQ.neg(y), y)


def g1_decompress_batch(prefixes, xs):
    """prefixes: [B] int32 (0x02/0x03); xs: [16, B] Montgomery Fq (x < q is
    the host parser's check).  Returns (Jacobian point, ok).

    Semantics of lib.rs:359-376: y = sqrt(x^3 + 3) with the prefix's
    parity; G1 has no subgroup check (mod.rs:40-42)."""
    y, is_res = FQ.sqrt(g1_rhs(xs))
    y = g1_select_y(prefixes, y)
    ok = is_res & ((prefixes == 2) | (prefixes == 3))
    return G.to_jacobian(G.G1, (xs, y), inf_mask=~ok), ok


def g2_rhs(xs):
    """x^3 + b2 over Fq2."""
    batch, device = xs[0].shape[-1], xs[0].device
    return T.fq2_add(T.fq2_mul(T.fq2_sqr(xs), xs), T.fq2_const(C.B2, batch, device))


def g2_select_y(prefixes, y):
    """y or -y by the U512 packing c1 q + c0 (lib.rs:506-527): 0x0a takes
    the smaller, 0x0b the larger.  Canonical c0 < q, so the packing
    orders as the 32 limbs (c0 low, c1 high) do."""
    y_neg = T.fq2_neg(y)
    packed = lambda v: torch.cat([_canonical(v[0]), _canonical(v[1])], -2)
    y_gt = _limb_gt(packed(y), packed(y_neg))
    return T.fq2_select(y_gt ^ (prefixes == 0x0B), y_neg, y)


def g2_in_subgroup(pt):
    """r * P == inf, a 254-bit double-and-add on the point kernels (the
    twist's cofactor is not 1: G2Params::check_order, mod.rs:469)."""
    batch, device = pt[0][0].shape[-1], pt[0][0].device
    r = L.broadcast_const(L.limbs_from_int(C.R), batch, device)
    return G.is_zero_point(G.G2, G.scalar_mul(G.G2, pt, r, num_bits=254))


def g2_decompress_batch(prefixes, xs, subgroup_check: bool = True):
    """prefixes: [B] int32 (0x0a/0x0b); xs: Fq2 pair of [16, B] Montgomery
    batches.  Returns (Jacobian point, ok).

    Semantics of lib.rs:506-527: y = sqrt(x^3 + b2), y or -y by the U512
    order; with subgroup_check, ok also needs r * P == inf (AffineG2::new,
    mod.rs:104-107)."""
    y, is_res = T.fq2_sqrt(g2_rhs(xs))
    y = g2_select_y(prefixes, y)
    ok = is_res & ((prefixes == 0x0A) | (prefixes == 0x0B))
    pt = G.to_jacobian(G.G2, (xs, y), inf_mask=~ok)
    if subgroup_check:
        ok = ok & g2_in_subgroup(pt)
        pt = G.to_jacobian(G.G2, (pt[0], pt[1]), inf_mask=~ok)
    return pt, ok


# ---------------------------------------------------------------------------
# Host parsers and the entries
# ---------------------------------------------------------------------------

def _tensors(pre, okh, device):
    return (torch.tensor(np.asarray(pre, np.int32), device=device),
            torch.tensor(np.asarray(okh, bool), device=device))


def parse_g1_compressed(blobs, device):
    """33-byte blobs -> (prefixes [B], xs [16, B], ok_host [B]) on device.

    x >= q and wrong lengths are marked invalid here (the device sees
    x mod q, or 0, and ok_host turns the lane off)."""
    pre, xv, okh = [], [], []
    for b in blobs:
        b = bytes(b)
        good = len(b) == 33
        x = int.from_bytes(b[1:33], "big") if good else 0
        okh.append(good and x < C.Q)
        pre.append(b[0] if good else 0)
        xv.append(x % C.Q)
    pre, okh = _tensors(pre, okh, device)
    return pre, FQ.encode(xv, device), okh


def parse_g2_compressed(blobs, device):
    """65-byte blobs -> (prefixes [B], Fq2 xs, ok_host [B]) on device.

    The 64-byte payload is the U512 value c1 q + c0 (divrem, lib.rs:260-267);
    a quotient >= q is invalid."""
    pre, c0v, c1v, okh = [], [], [], []
    for b in blobs:
        b = bytes(b)
        good = len(b) == 65
        v = int.from_bytes(b[1:65], "big") if good else 0
        c1, c0 = divmod(v, C.Q)
        okh.append(good and c1 < C.Q)
        pre.append(b[0] if good else 0)
        c0v.append(c0)
        c1v.append(c1 % C.Q)
    pre, okh = _tensors(pre, okh, device)
    return pre, (FQ.encode(c0v, device), FQ.encode(c1v, device)), okh


def g1_from_compressed_batch(blobs, device=None):
    """33-byte blobs -> (Jacobian G1 batch, ok [B]): the batched analogue
    of G1::from_compressed, on the card unless device="cpu"."""
    pre, xs, okh = parse_g1_compressed(blobs, resolve_device(device))
    pt, ok = g1_decompress_batch(pre, xs)
    ok = ok & okh
    return G.to_jacobian(G.G1, (pt[0], pt[1]), inf_mask=~ok), ok


def g2_from_compressed_batch(blobs, subgroup_check: bool = True, device=None):
    """65-byte blobs -> (Jacobian G2 batch, ok [B]), on the card unless
    device="cpu"."""
    pre, xs, okh = parse_g2_compressed(blobs, resolve_device(device))
    pt, ok = g2_decompress_batch(pre, xs, subgroup_check=subgroup_check)
    ok = ok & okh
    return G.to_jacobian(G.G2, (pt[0], pt[1]), inf_mask=~ok), ok
