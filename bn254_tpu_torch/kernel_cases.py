"""One case per kernel and variant (Fq or Fr modulus, NAF or binary
digits): its wrapper, its plain version and inputs at the shapes the main
path gives it — what ``chip_smoke.py`` compares bit for bit on the card.

Inputs are drawn from a numpy seed as random Montgomery residues (limbs
below q's top limb), with the first lanes of every coordinate set through
``Mod.encode`` to 0, 1 and q - 1; lane 0 is all zeros, which is also what
``to_affine`` hands the Miller kernels for a point at infinity.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable

import numpy as np
import torch

from . import fused as FU
from . import limbs as L
from . import mont_kernels as MK
from .fields import FR
from .pairing import _PRE_KINDS
from bn254_tpu.spec import constants as C

FR_MOD = FR.mod


@dataclass(frozen=True)
class KernelCase:
    name: str                   # key in counts.KERNELS
    label: str                  # name plus the variant, if any
    source: str                 # CUDA source in the repo
    replaces: str               # file:line of the TPU kernel
    kernel: Callable
    plain: Callable
    make_args: Callable         # (rng, batch, device) -> args


def residues(rng, coords: int, batch: int, device, mod: L.Mod = MK.FQ_MOD):
    """[coords, 16, B] int32 random residues mod `mod`, edge values first."""
    a = rng.integers(0, 1 << 16, size=(coords, L.N_LIMBS, batch), dtype=np.int64)
    a[:, -1] %= int(mod.q_np[-1])
    edges = mod.encode_batch([0, 1, mod.modulus - 1])[:, :batch]
    a[:, :, :edges.shape[1]] = edges.astype(np.int64)
    return torch.from_numpy(a.astype(np.int32)).to(device)


def _fq(c):
    return lambda rng, b, d: tuple(residues(rng, n, b, d) for n in c)


_PK = "bn254_tpu/pallas_kernels.py"
_PF = "bn254_tpu/pallas_fused.py"
_MK_CU = "bn254_tpu_torch/csrc/mont_kernels.cu"
_FU_CU = "bn254_tpu_torch/csrc/fused.cu"

CASES = (
    KernelCase("mont_mul", "mont_mul[fq]", _MK_CU, f"{_PK}:239", MK.mont_mul, L.mont_mul,
               lambda rng, b, d: (residues(rng, 1, b, d)[0], residues(rng, 1, b, d)[0],
                                  MK.FQ_MOD)),
    KernelCase("mont_mul", "mont_mul[fr]", _MK_CU, f"{_PK}:239", MK.mont_mul, L.mont_mul,
               lambda rng, b, d: (residues(rng, 1, b, d, FR_MOD)[0],
                                  residues(rng, 1, b, d, FR_MOD)[0], FR_MOD)),
    KernelCase("mont_sqr", "mont_sqr[fq]", _MK_CU, f"{_PK}:247", MK.mont_sqr, L.mont_sqr,
               lambda rng, b, d: (residues(rng, 1, b, d)[0], MK.FQ_MOD)),
    KernelCase("mont_sqr", "mont_sqr[fr]", _MK_CU, f"{_PK}:247", MK.mont_sqr, L.mont_sqr,
               lambda rng, b, d: (residues(rng, 1, b, d, FR_MOD)[0], FR_MOD)),
    KernelCase("fq2_mul", "fq2_mul", _MK_CU, f"{_PK}:175", MK.fq2_mul, MK.fq2_mul_plain,
               _fq((2, 2))),
    KernelCase("fq2_sqr", "fq2_sqr", _MK_CU, f"{_PK}:181", MK.fq2_sqr, MK.fq2_sqr_plain,
               _fq((2,))),
    KernelCase("fq_pow", "fq_pow", _FU_CU, f"{_PF}:1253", FU.fq_pow, FU.fq_pow_plain,
               lambda rng, b, d: (residues(rng, 1, b, d)[0], C.Q - 2)),
    KernelCase("miller_precompute", "miller_precompute", _FU_CU, f"{_PF}:1395",
               FU.miller_precompute, FU.miller_precompute_plain,
               lambda rng, b, d: (residues(rng, 4, b, d), residues(rng, 2, b, d),
                                  _PRE_KINDS.reshape(-1, 1))),
    KernelCase("g2_add_step", "g2_add_step", _FU_CU, f"{_PF}:1151", FU.g2_add_step,
               FU.g2_add_step_plain, _fq((6, 4))),
    KernelCase("fq12_fold_line", "fq12_fold_line", _FU_CU, f"{_PF}:1029",
               FU.fq12_fold_line, FU.fq12_fold_line_plain,
               lambda rng, b, d: (residues(rng, 12, b, d), residues(rng, 6, b, d),
                                  *residues(rng, 2, b, d))),
    KernelCase("fq12_mul", "fq12_mul", _FU_CU, f"{_PF}:1022", FU.fq12_mul,
               FU.fq12_mul_plain, _fq((12, 12))),
    KernelCase("fq12_cyc_sqr", "fq12_cyc_sqr", _FU_CU, f"{_PF}:1027", FU.fq12_cyc_sqr,
               FU.fq12_cyc_sqr_plain, _fq((12,))),
    KernelCase("fq12_cyc_pow", "fq12_cyc_pow[naf]", _FU_CU, f"{_PF}:1267", FU.fq12_cyc_pow,
               FU.fq12_cyc_pow_plain,
               lambda rng, b, d: (residues(rng, 12, b, d), FU.NAF_Z)),
    KernelCase("fq12_cyc_pow", "fq12_cyc_pow[binary]", _FU_CU, f"{_PF}:1267", FU.fq12_cyc_pow,
               FU.fq12_cyc_pow_plain,
               lambda rng, b, d: (residues(rng, 12, b, d), FU.BINARY_Z)),
)


def outputs(x) -> tuple:
    return x if isinstance(x, tuple) else (x,)


def max_abs_err(a, b) -> int:
    """Largest |kernel - plain| over all outputs (limbs as integers)."""
    return max(int((x.to(torch.int64) - y.to(torch.int64)).abs().max())
               for x, y in zip(outputs(a), outputs(b)))
