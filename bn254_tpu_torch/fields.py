"""Batched prime fields Fq and Fr on tensors — counterpart of
bn254_tpu/fields.py.

An element batch is an int32 tensor [16, B] of Montgomery limbs, fully
reduced.  ``mul``/``sqr`` go to the Montgomery kernels (mont_kernels.py,
rows 1-2) and ``pow_const`` on Fq to the whole-ladder ``fq_pow`` kernel
(fused.py, row 5); add/sub/neg/select are plain tensor ops, as they are
plain jnp ops in the JAX package.  The inverse is Fermat's a^(p-2), which
maps 0 to 0 without branching; the square root (p = 3 mod 4) is one
power and two products, with Euler's criterion as its validity mask.
"""

from __future__ import annotations

import numpy as np
import torch

from . import fused as FU
from . import limbs as L
from . import mont_kernels as MK
from .spec import constants as C

__all__ = ["FieldCtx", "FQ", "FR"]


class FieldCtx:
    """Context for one prime field: its Mod and the vector ops."""

    def __init__(self, mod: L.Mod):
        self.mod = mod
        self.p = mod.modulus
        self.one_np = mod.encode(1)           # R mod p (Montgomery one)

    # ---- host codecs ----
    def encode(self, vals, device):
        """Iterable of canonical ints -> [16, B] Montgomery limbs on device."""
        return torch.from_numpy(
            self.mod.encode_batch(list(vals)).astype(np.int32)).to(device)

    def decode(self, a) -> list:
        """[16, B] Montgomery limbs -> list of canonical ints."""
        return self.mod.decode_batch(a)

    # ---- constants ----
    def zeros(self, batch: int, device):
        return L.zeros(batch, device)

    def ones(self, batch: int, device):
        return L.broadcast_const(self.one_np, batch, device)

    def const(self, v: int, batch: int, device):
        """Canonical int -> broadcast Montgomery [16, B] constant."""
        return L.broadcast_const(self.mod.encode(v), batch, device)

    # ---- arithmetic ----
    def add(self, a, b):
        return L.add_mod(a, b, self.mod)

    def sub(self, a, b):
        return L.sub_mod(a, b, self.mod)

    def neg(self, a):
        return L.neg_mod(a, self.mod)

    def double(self, a):
        return L.add_mod(a, a, self.mod)

    def mul(self, a, b):
        return MK.mont_mul(a, b, self.mod)

    def sqr(self, a):
        return MK.mont_sqr(a, self.mod)

    def is_zero(self, a):
        return L.is_zero(a)

    def eq(self, a, b):
        return L.eq(a, b)

    def select(self, mask, a, b):
        return L.select(mask, a, b)

    # ---- fixed-exponent power ladder ----
    def pow_const(self, a, e: int):
        """a^e for a static exponent (MSB-first square-and-multiply,
        fields/mod.rs:35-46): one fq_pow kernel on Fq, a loop of Montgomery
        kernels on Fr.  Leading zero bits keep 1, so starting the loop at
        the leading 1 with a gives the JAX ladder's values."""
        if e == 0:
            return self.ones(a.shape[-1], a.device)
        if self is FQ:
            return FU.fq_pow(a, e)
        res = a
        for i in reversed(range(e.bit_length() - 1)):
            res = self.sqr(res)
            if (e >> i) & 1:
                res = self.mul(res, a)
        return res

    def inv(self, a):
        """Fermat inverse a^(p-2); maps 0 -> 0 (branchless)."""
        return self.pow_const(a, self.p - 2)

    def sqrt(self, a):
        """(root, ok): a^((p+1)/4), a root of a wherever ok; only for
        p = 3 mod 4 (fp.rs:246-259).  One pow_const of (p-3)/4 (the fq_pow
        kernel on Fq), then two products: a1 * a = a^((p+1)/4), and
        a1 * a1a = a^((p-1)/2), whose value -1 marks a non-residue (Euler's
        criterion); 0 is a residue with root 0."""
        assert self.p % 4 == 3
        a1 = self.pow_const(a, (self.p - 3) // 4)
        a1a = self.mul(a1, a)
        a0 = self.mul(a1, a1a)
        is_nonres = self.eq(a0, self.const(self.p - 1, a.shape[-1], a.device))
        return a1a, ~is_nonres


FQ = FieldCtx(MK.FQ_MOD)
FR = FieldCtx(L.Mod(C.R))
