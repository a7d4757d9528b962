"""Pippenger multi-scalar multiplication on tensors — counterpart of
bn254_tpu/msm.py, its fused design (``_msm_fused``).

sum_i k_i * P_i over G1 or G2, in four steps:

1. ``prepare``: pad the batch to a multiple of ``lanes`` with infinity
   points and zero scalars; cut each scalar into W signed base-2^c digits
   (W covers num_bits + 1 bits, so the top window takes the last carry);
   send infinity inputs to digit 0; convert the points to affine.  The
   affine conversion is ``fused.to_affine`` on the packed points (the
   kernel of ``groups.to_affine``, its packed output kept): the
   JAX package's shared inversion with prefix/suffix products
   (msm.py:133-156), one Fermat chain a block of lanes instead of one for
   the batch.  Affine coordinates are unique, so the accumulate kernel
   gets the same bits for every finite point either way; infinity lanes
   get (0, 0) where the JAX package leaves (x, y), and carry digit 0.
2. ``fused.msm_accumulate`` (queue row 19): every lane of every window
   accumulates its own buckets and reduces them -> [W, 3c, 16, lanes].
3. Horner over the windows, high to low (c doubles and one add per
   window), at full lane width,
4. then the fold of the lanes (the JAX package's roll-and-add); steps 3
   and 4 are one ``fused.msm_combine`` call -> [3c, 16, 1].

Every group op runs on the card.  The JAX package's scan design (its
``tiles=`` path, for XLA:CPU and the tape) is not carried over.
"""

from __future__ import annotations

import numpy as np
import torch

from . import fused as FU
from . import groups as G
from . import limbs as L
from .convert import pack, unpack_point
from .spec import constants as C

__all__ = ["msm", "MSM_FUSED_WINDOW", "LANES"]

MSM_FUSED_WINDOW = {1: 6, 2: 5}   # window bits c per ncoords (G1, G2), as msm.py:182
LANES = 1024                       # independent Pippenger lanes (the TPU's sub * 128)


def encode_scalars(vals, device):
    """Iterable of ints -> canonical (not Montgomery) limbs [16, n] int32,
    each reduced mod r (a scalar is an element of Fr)."""
    limbs = L._ints_to_limbs([int(v) % C.R for v in vals])
    return torch.from_numpy(limbs.astype(np.int32)).to(device)


def _all_digits(scalars, c: int, nwindows: int):
    """All base-2^c digits of each scalar -> [W, n] int32; c divides the
    limb width.  scalars: canonical limbs [16, n]."""
    assert L.LIMB_BITS % c == 0, "window size must divide the limb width"
    rows = []
    for w in range(nwindows):
        limb = scalars[(w * c) // L.LIMB_BITS]
        rows.append((limb >> ((w * c) % L.LIMB_BITS)) & ((1 << c) - 1))
    return torch.stack(rows).to(torch.int32)


def _digits_any_c(scalars, c: int, nwindows: int):
    """Base-2^c digits for any c (limb-straddling) -> [W, n] int32."""
    rows = []
    for w in range(nwindows):
        l0, sh = divmod(w * c, L.LIMB_BITS)
        v = scalars[l0] >> sh
        if sh + c > L.LIMB_BITS and l0 + 1 < L.N_LIMBS:
            v = v | (scalars[l0 + 1] << (L.LIMB_BITS - sh))
        rows.append(v & ((1 << c) - 1))
    return torch.stack(rows).to(torch.int32)


def _signed_digits(dgs, c: int):
    """Unsigned digit rows [W, n] -> signed digits in
    [-(2^(c-1) - 1), 2^(c-1)] by carry propagation (the kernel takes
    bucket |d| and negates y for d < 0)."""
    half = 1 << (c - 1)
    rows = []
    carry = torch.zeros_like(dgs[0])
    for w in range(dgs.shape[0]):
        d = dgs[w] + carry
        over = d > half
        rows.append(torch.where(over, d - (1 << c), d))
        carry = over.to(torch.int32)
    return torch.stack(rows)


def _pad(K, points, scalars, lanes: int):
    n = K.batch_of(points[0])
    pad = (-n) % lanes
    if not pad:
        return points, scalars
    zp = G.zero_point(K, pad, scalars.device)
    cat = lambda a, z: torch.cat([a, z], -1)
    points = tuple((cat(a[0], z[0]), cat(a[1], z[1])) if isinstance(a, tuple) else cat(a, z)
                   for a, z in zip(points, zp))
    return points, torch.nn.functional.pad(scalars, (0, pad))


def prepare(K, points, scalars, c: int, num_bits: int = 254, lanes: int = LANES):
    """Step 1: (affine points packed [2c, 16, n'], signed digits [W, n'])
    with n' the batch padded to a multiple of lanes."""
    points, scalars = _pad(K, points, scalars, lanes)
    nwindows = (num_bits + 1 + c - 1) // c        # +1 bit: signed-carry headroom
    dgs = _signed_digits(_digits_any_c(scalars, c, nwindows), c)
    xy, inf = FU.to_affine(K.COORDS, pack(points))
    dgs = torch.where(inf[None, :], 0, dgs)       # infinity inputs add nothing
    return xy, dgs


def _msm_fused(K, points, scalars, c: int, num_bits: int = 254, lanes: int = LANES):
    packed, dgs = prepare(K, points, scalars, c, num_bits, lanes)
    totals = FU.msm_accumulate(K.COORDS, packed, dgs, (1 << (c - 1)) + 1,
                               signed=True, lanes=lanes)
    return unpack_point(K.COORDS, FU.msm_combine(K.COORDS, totals, c))


def msm(K, points, scalars, c: int | None = None, num_bits: int = 256,
        lanes: int | None = None):
    """sum_i scalars[i] * points[i] over group K -> a batch-1 Jacobian point.

    points: Jacobian point batch [.., n]; scalars: canonical limbs [16, n]
    int32 (``encode_scalars``).  num_bits is a static bound on the scalar
    bit length, trusted as-is (bits at or above it are dropped); scalars
    mod r need 254, which is what the default 256 becomes.  c defaults to
    MSM_FUSED_WINDOW; lanes, a power of two, defaults to LANES."""
    if c is None:
        c = MSM_FUSED_WINDOW[K.COORDS]
    return _msm_fused(K, points, scalars, c, min(num_bits, 254), lanes or LANES)
