"""Montgomery and Fq2 kernel wrappers — counterpart of
bn254_tpu/pallas_kernels.py (queue rows 1-4).

Each wrapper launches its CUDA kernel (csrc/mont_kernels.cu) for a CUDA
tensor and runs its plain version for a CPU tensor; any other device
raises.  ``mont_mul``/``mont_sqr`` take the modulus as an argument and
serve Fr as well as Fq, like the TPU kernel; the Fq2 kernels are Fq-only.

Plain versions: ``limbs.mont_mul``/``limbs.mont_sqr`` and
``fq2_mul_plain``/``fq2_sqr_plain`` below, which work on any leading shape
``[..., 2, 16, B]`` (the fused plain versions stack their independent Fq2
products into one call).
"""

from __future__ import annotations

import ctypes
import functools

import torch

from . import counts
from . import limbs as L
from ._build import check, launch, on_cuda
from .spec import constants as C

FQ_MOD = L.Mod(C.Q)


@functools.lru_cache(maxsize=None)
def _words_arg(mod: L.Mod):
    """The modulus's 9 words (q, then -q^-1 mod 2^32) as the host array the
    C entry reads, built once per Mod."""
    return (ctypes.c_uint32 * 9)(*mod.words())


def mont_mul(a, b, mod: L.Mod):
    """a*b*R^-1 mod q of reduced [16, B] operands.

    Kernel: csrc/mont_kernels.cu k_mont_mul, replacing
    bn254_tpu/pallas_kernels.py:_mont_mul_kernel."""
    if not on_cuda(a):
        return L.mont_mul(a, b, mod)
    batch = a.shape[-1]
    check("mont_mul", batch, a.device, (a, ()), (b, ()))
    out = torch.empty_like(a)
    launch("mont_mul", batch, a.data_ptr(), b.data_ptr(), out.data_ptr(),
           ctypes.addressof(_words_arg(mod)))
    return out


def mont_sqr(a, mod: L.Mod):
    """a^2*R^-1 mod q. Kernel: csrc/mont_kernels.cu k_mont_sqr, replacing
    bn254_tpu/pallas_kernels.py:_mont_sqr_kernel."""
    if not on_cuda(a):
        return L.mont_sqr(a, mod)
    batch = a.shape[-1]
    check("mont_sqr", batch, a.device, (a, ()))
    out = torch.empty_like(a)
    launch("mont_sqr", batch, a.data_ptr(), out.data_ptr(), ctypes.addressof(_words_arg(mod)))
    return out


def fq2_mul(a, b):
    """Karatsuba Fq2 product of packed [2, 16, B] operands. Kernel:
    csrc/mont_kernels.cu k_fq2_mul, replacing
    bn254_tpu/pallas_kernels.py:_fq2_mul_kernel."""
    if not on_cuda(a):
        return fq2_mul_plain(a, b)
    batch = a.shape[-1]
    check("fq2_mul", batch, a.device, (a, (2,)), (b, (2,)))
    out = torch.empty_like(a)
    launch("fq2_mul", batch, a.data_ptr(), b.data_ptr(), out.data_ptr())
    return out


def fq2_sqr(a):
    """Complex Fq2 square of a packed [2, 16, B] operand. Kernel:
    csrc/mont_kernels.cu k_fq2_sqr, replacing
    bn254_tpu/pallas_kernels.py:_fq2_sqr_kernel."""
    if not on_cuda(a):
        return fq2_sqr_plain(a)
    batch = a.shape[-1]
    check("fq2_sqr", batch, a.device, (a, (2,)))
    out = torch.empty_like(a)
    launch("fq2_sqr", batch, a.data_ptr(), out.data_ptr())
    return out


# ---------------------------------------------------------------------------
# Plain versions ([..., 2, 16, B]; the formulas of bn254_tpu.tower)
# ---------------------------------------------------------------------------

def _fq2_mul(a, b):
    """Karatsuba with i^2 = -1 (fq2.rs:133-149): the 3 products in one call."""
    m = FQ_MOD
    a0, a1 = a.unbind(-3)
    b0, b1 = b.unbind(-3)
    sa, sb = L.add_mod(torch.stack([a0, b0]), torch.stack([a1, b1]), m).unbind(0)
    prods = L.mont_mul(torch.stack([a0, a1, sa], -3), torch.stack([b0, b1, sb], -3), m)
    aa, bb, cross = prods.unbind(-3)
    c0, t = L.sub_mod(torch.stack([aa, cross]), torch.stack([bb, aa]), m).unbind(0)
    return torch.stack([c0, L.sub_mod(t, bb, m)], -3)


def _fq2_sqr(a):
    """Complex squaring (fq2.rs:105-117): ab and (a0+a1)(a0-a1) in one call."""
    m = FQ_MOD
    a0, a1 = a.unbind(-3)
    s, d = L.add_mod(a0, a1, m), L.sub_mod(a0, a1, m)
    ab, t = L.mont_mul(torch.stack([a0, s], -3), torch.stack([a1, d], -3), m).unbind(-3)
    return torch.stack([t, L.add_mod(ab, ab, m)], -3)


def fq2_mul_plain(a, b):
    counts.plain_calls["fq2_mul"] += 1
    return _fq2_mul(a, b)


def fq2_sqr_plain(a):
    counts.plain_calls["fq2_sqr"] += 1
    return _fq2_sqr(a)
