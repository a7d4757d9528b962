"""Build, load and launch the port's CUDA kernels.

The sources under ``csrc/`` are compiled by ``nvcc`` for ``sm_90a`` into a
shared library with a plain C interface, loaded with ``ctypes``.  The
build happens at first use, into ``bn254_tpu_torch/_build/`` (listed in
.gitignore), and is redone whenever a source, the generated constants
header or the flags change (the library's file name carries their hash).

Field constants reach the kernels through ``_build/bn254_consts.h``,
generated here from ``bn254_tpu_torch.spec.constants`` (the port's copy of
the oracle) through the port's ``Mod``: the Fq modulus, -q^-1 mod 2^32,
q^2 (16 words: the lazy Fq2 product's offset) and the Montgomery forms
of 1, 1/2 and the twist coefficient b2, the Frobenius factors of Fq12
(``frob12_consts``), and the team schedules of the Miller kernel
(``team_schedule.header``), the prepared Miller loop
(``loop_schedule.header``) and the GLV ladder (``ladder_schedule.header``).
(The Montgomery kernels take their modulus as an argument instead, so they
serve Fr as well.)

Every C entry returns ``cudaGetLastError()`` right after its launch;
``launch`` raises if it is not 0 and otherwise adds one to the kernel's
launch count.
"""

from __future__ import annotations

import ctypes
import hashlib
import subprocess
import time
from pathlib import Path

import torch

from . import counts, ladder_schedule, loop_schedule, team_schedule
from .limbs import Mod
from .spec import constants as C
from .spec import field as SF

_PKG = Path(__file__).resolve().parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"
SOURCES = ("mont_kernels.cu", "fused.cu", "groups.cu", "probes.cu")
ARCH = ["-gencode", "arch=compute_90a,code=sm_90a"]
FLAGS = ARCH + ["-std=c++17", "-O3", "-Xptxas", "-v", "-Xcompiler", "-fPIC"]

# C signature of each entry after its name: p = pointer, i = int.  Every
# entry ends with (int B, cudaStream_t stream).
_SIGS = {
    "mont_mul": "pppp",          # a, b, out, modulus words (host)
    "mont_sqr": "ppp",           # a, out, modulus words (host)
    "fq2_mul": "ppp",            # a, b, out
    "fq2_sqr": "pp",             # a, out
    "fq_pow": "pipp",            # digits, n, a, out
    "miller_precompute": "pipppp",  # kinds, n, p, q, f, r
    "g2_add_step": "pppp",       # r, base, r_out, coeff_out
    "fq12_fold_line": "ppppp",   # f, coeffs, px, py, out
    "fq12_mul": "ppp",           # a, b, out
    "fq12_cyc_sqr": "pp",        # a, out
    "fq12_cyc_pow": "pipp",      # digits, n, a, out
    "point_add": "ippp",         # ncoords, p, q, out
    "point_double": "ipp",       # ncoords, p, out
    "msm_accumulate": "ipppppiiii",  # ncoords, words, digits, offsets, order, buckets, n, W, nb, signed
    "fq12_sqr": "pp",            # a, out
    "g2_dbl_step": "ppp",        # r, r_out, coeff_out
    "glv_ladder": "ipipp",       # ncoords, digits, nsteps, pts, out
    "fq2_mul_fused": "ppp",      # a, b, out
    "fq2_sqr_fused": "pp",       # a, out
    "chain_mont": "ipppi",       # impl, a, b, out, chain
    "chain_tower": "ipppi",      # op, a, b, out, chain
    "msm_bucket_sort": "pppiiii",   # digits, offsets, order, n, W, nb, signed
    "msm_bucket_reduce": "ippii",   # ncoords, buckets, out, W, nb
    "fq12_inv": "pipp",          # inverse digits, n, a, out
    "fq12_frob": "ipp",          # power (1-3, or 6: the conjugation), a, out
    "msm_combine": "ipiipp",     # ncoords, totals, W, c, scratch, out (B = lanes)
    "point_mul": "ippip",        # ncoords, p, scalar limbs, num_bits, out
    "fq2_sqrt": "pipippp",       # digits of (q-3)/4, n, of (q-1)/2, n, a, root, ok
    "miller_loop": "pipppp",     # square flags, n, coeffs [n, 6, 16, B], px, py, f
}
assert tuple(_SIGS) == counts.KERNELS

_LIB = None


def _words(v: int, n: int = 8) -> str:
    return ", ".join(f"0x{(v >> (32 * j)) & 0xFFFFFFFF:08x}u" for j in range(n))


def frob12_consts(power: int) -> list:
    """The six Fq2 factors (canonical int pairs) of the Frobenius map of
    Fq12 to the q^power (power 1-3), one a coefficient in the packed
    order: tower.fq12_frob multiplies coefficient k of each half by
    FROB6_C1 (k = 1) or FROB6_C2 (k = 2) and every coefficient of the
    second half by FROB12_C1; the kernel multiplies once by their product."""
    c6 = [SF.FQ2_ONE, C.FROB6_C1[power], C.FROB6_C2[power]]
    return c6 + [SF.fq2_mul(c, C.FROB12_C1[power]) for c in c6]


def consts_header() -> str:
    """The generated constants header (Montgomery forms, 32-bit words)."""
    fq = Mod(C.Q)
    mont = lambda v: (v % C.Q) * fq.r % C.Q
    frob = ", ".join(_words(mont(x)) for p in (1, 2, 3) for c in frob12_consts(p)[1:]
                     for x in c)
    return "\n".join([
        "// Generated by bn254_tpu_torch/_build.py from bn254_tpu_torch.spec.constants.",
        "#pragma once",
        f"#define BN254_FQ_Q {_words(C.Q)}",
        f"#define BN254_FQ_QINV 0x{fq.qinv32:08x}u",
        f"#define BN254_FQ_Q_SQUARED {_words(C.Q ** 2, 16)}",
        f"#define BN254_FQ_ONE {_words(mont(1))}",
        f"#define BN254_FQ_TWO_INV {_words(mont(pow(2, C.Q - 2, C.Q)))}",
        f"#define BN254_B2_C0 {_words(mont(C.B2[0]))}",
        f"#define BN254_B2_C1 {_words(mont(C.B2[1]))}",
        f"#define BN254_FROB12 {frob}",
        team_schedule.header(),
        loop_schedule.header(),
        ladder_schedule.header(),
    ])


def _nvcc() -> str:
    from torch.utils.cpp_extension import CUDA_HOME

    if CUDA_HOME is None or not (Path(CUDA_HOME) / "bin" / "nvcc").exists():
        raise RuntimeError("nvcc not found: the CUDA toolkit is needed to build "
                           "the kernels (torch.utils.cpp_extension.CUDA_HOME = "
                           f"{CUDA_HOME!r})")
    return str(Path(CUDA_HOME) / "bin" / "nvcc")


def library_path() -> Path:
    """Where the library for the current sources lives (built or not)."""
    h = hashlib.sha256()
    for f in sorted(CSRC.iterdir()):
        h.update(f.name.encode())
        h.update(f.read_bytes())
    h.update(consts_header().encode())
    h.update(" ".join(FLAGS).encode())
    return BUILD_DIR / f"libbn254_{h.hexdigest()[:16]}.so"


def build() -> Path:
    """Compile the kernels unless the library for these sources exists.

    The translation units compile in parallel; nvcc's output (with
    ptxas's register and spill report) goes to ``_build/build.log``."""
    lib = library_path()
    if lib.exists():
        return lib
    nvcc = _nvcc()
    BUILD_DIR.mkdir(exist_ok=True)
    (BUILD_DIR / "bn254_consts.h").write_text(consts_header())
    t0 = time.perf_counter()
    jobs = []
    for src in SOURCES:
        obj = BUILD_DIR / (Path(src).stem + ".o")
        cmd = [nvcc, *FLAGS, "-I", str(BUILD_DIR), "-c", str(CSRC / src), "-o", str(obj)]
        jobs.append((src, obj, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
    log, failed = [], []
    for src, _, proc in jobs:            # wait for every job before raising
        out, _ = proc.communicate()
        log.append(f"== {src}\n{out}")
        if proc.returncode:
            failed.append(src)
    if not failed:
        tmp = lib.with_suffix(".tmp")
        link = subprocess.run([nvcc, *ARCH, "-shared", "-o", str(tmp),
                               *(str(obj) for _, obj, _ in jobs)],
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                              text=True)
        log.append(f"== link\n{link.stdout}")
        if link.returncode:
            failed.append("link")
        else:
            tmp.replace(lib)
    log.append(f"== seconds {time.perf_counter() - t0:.1f}")
    (BUILD_DIR / "build.log").write_text("\n".join(log))
    if failed:
        raise RuntimeError(f"kernel build failed ({', '.join(failed)}):\n"
                           + "\n".join(log))
    return lib


def library():
    """The loaded kernel library (built first if needed)."""
    global _LIB
    if _LIB is None:
        lib = ctypes.CDLL(str(build()))
        for name, sig in _SIGS.items():
            fn = getattr(lib, "bn254_" + name)
            fn.argtypes = ([ctypes.c_void_p if c == "p" else ctypes.c_int for c in sig]
                           + [ctypes.c_int, ctypes.c_void_p])
            fn.restype = ctypes.c_int
        lib.bn254_error_string.argtypes = [ctypes.c_int]
        lib.bn254_error_string.restype = ctypes.c_char_p
        _LIB = lib
    return _LIB


def launch(name: str, batch: int, *args):
    """Launch kernel `name` on PyTorch's current stream; raise on a refused
    launch, count it otherwise."""
    lib = library()
    stream = torch.cuda.current_stream().cuda_stream
    rc = getattr(lib, "bn254_" + name)(*args, batch, stream)
    if rc:
        raise RuntimeError(f"{name} kernel launch failed: "
                           f"{lib.bn254_error_string(rc).decode()}")
    counts.launches[name] += 1


def resolve_device(device) -> torch.device:
    """An entry point's device: the card unless the caller names another."""
    return torch.device("cuda" if device is None else device)


def on_cuda(t: torch.Tensor) -> bool:
    """True for a CUDA tensor (launch the kernel), False for a CPU tensor
    (take the plain version); any other device raises."""
    if t.device.type == "cuda":
        return True
    if t.device.type == "cpu":
        return False
    raise ValueError(f"no kernel and no plain version for device {t.device}")


def check(name: str, batch: int, device, *specs):
    """Each spec is (tensor, leading shape): the tensor must be int32,
    contiguous, on `device`, of shape leading + (16, batch)."""
    if batch < 1:
        raise ValueError(f"{name}: empty batch")
    for t, lead in specs:
        want = tuple(lead) + (16, batch)
        if (t.dtype != torch.int32 or tuple(t.shape) != want
                or t.device != device or not t.is_contiguous()):
            raise ValueError(
                f"{name}: want a contiguous int32 tensor of shape {want} on "
                f"{device}, got {t.dtype} {tuple(t.shape)} on {t.device} "
                f"(contiguous={t.is_contiguous()})")
