"""The native host engine: ``csrc/host/bn254_host.c`` through ctypes —
counterpart of bn254_tpu/native.py.

The engine is a C counterpart of the reference crate's Rust core:
64-bit-limb Montgomery arithmetic, the full tower, the group law (GLV +
wNAF scalar multiplication), the pairing (OpenMP over a batch's pairs)
and a Pippenger MSM.  The scalar API (``api``) hands its hot paths to it:
``G1/G2 * Fr``, ``Gt.pow``, ``pairing``, ``pairing_batch`` and
``miller_loop_batch``.  Every value crosses as canonical little-endian
u64 limbs.

Build: at the first call, never at import, ``gcc -O3 -shared -fPIC -Wall
-fopenmp`` (native/build.sh's flags) compiles the C source with the
constants header that ``consts_header`` writes from the port's own spec
and GLV constants, into ``_build/host/`` (listed in .gitignore).  The
library's file name carries a hash of the source, the header and the
flags; it is written under a temporary name and renamed into place under
a file lock, so processes that reach the first call together build it
once.  A failed build raises with the compiler's output: there is no
silent fallback.  ``BN254_NO_NATIVE=1`` (any non-empty value) is the one
route to the spec: ``enabled()`` is then False and ``api`` runs the pure
``spec``.
"""

from __future__ import annotations

import ctypes
import fcntl
import hashlib
import os
import subprocess
import time
from pathlib import Path

from .spec import constants as C

_PKG = Path(__file__).resolve().parent
SOURCE = _PKG / "csrc" / "host" / "bn254_host.c"
BUILD_DIR = _PKG / "_build" / "host"
CC = "gcc"             # native/build.sh's compiler, from PATH
FLAGS = ["-O3", "-shared", "-fPIC", "-Wall", "-fopenmp"]

_LIB = None
_WORDS = 4  # u64 limbs per 256-bit value
build_seconds = None    # the compile's seconds, where this process built the library


# ---- the constants header (native/gen_consts.py on the port's constants) ----

def _u256(v):
    return "{{ " + ", ".join(
        f"0x{(v >> (64 * i)) & ((1 << 64) - 1):016x}ULL" for i in range(4)) + " }}"


def _u320(v):
    assert 0 <= v < (1 << 320)
    return "{ " + ", ".join(
        f"0x{(v >> (64 * i)) & ((1 << 64) - 1):016x}ULL" for i in range(5)) + " }"


def _fq2(pair):
    return "{ " + _u256(pair[0]) + ", " + _u256(pair[1]) + " }"


def consts_header() -> str:
    """``bn254_consts.h`` for the C engine: canonical little-endian u64
    limbs of the BN254 constants (the C engine converts them to Montgomery
    form in bn254_init), from ``spec.constants`` and the GLV constants
    ``glv`` computes; the same declarations and values as
    native/bn254_consts.h."""
    from . import glv as GLV       # imports torch: only where a build needs the header

    out = []
    w = out.append
    w("/* Generated by bn254_tpu_torch/native.py (consts_header) — do not edit.")
    w("   Canonical little-endian u64 limbs of the BN254 constants")
    w("   (see bn254_tpu_torch/spec/constants.py and the reference citations")
    w("   there: fp.rs:166-222, fq2.rs:19-34, fq6.rs:5-90, fq12.rs:6-48,")
    w("   groups/mod.rs:9-14,372-472,516-564). */")
    w("#pragma once")
    w("")
    inv_q = (-pow(C.Q, -1, 1 << 64)) & ((1 << 64) - 1)
    inv_r = (-pow(C.R, -1, 1 << 64)) & ((1 << 64) - 1)
    w(f"static const u256 FQ_P   = {_u256(C.Q)};")
    w(f"static const u256 FQ_R2  = {_u256((1 << 512) % C.Q)};")
    w(f"static const u256 FQ_RR  = {_u256((1 << 256) % C.Q)};")
    w(f"static const uint64_t FQ_INV = 0x{inv_q:016x}ULL;")
    w(f"static const u256 FR_P   = {_u256(C.R)};")
    w(f"static const u256 FR_R2  = {_u256((1 << 512) % C.R)};")
    w(f"static const u256 FR_RR  = {_u256((1 << 256) % C.R)};")
    w(f"static const uint64_t FR_INV = 0x{inv_r:016x}ULL;")
    w("")
    w("/* canonical curve/tower constants (converted to Montgomery in"
      " bn254_init) */")
    w(f"static const cfq2 C_XI = {_fq2(C.XI)};")
    w(f"static const cfq2 C_B2 = {_fq2(C.B2)};")
    w(f"static const cfq2 C_G2X = {_fq2(C.G2_ONE[0])};")
    w(f"static const cfq2 C_G2Y = {_fq2(C.G2_ONE[1])};")
    w(f"static const cfq2 C_TWIST_QX = {_fq2(C.TWIST_MUL_BY_Q_X)};")
    w(f"static const cfq2 C_TWIST_QY = {_fq2(C.TWIST_MUL_BY_Q_Y)};")
    for name, tab in (("FROB6_C1", C.FROB6_C1), ("FROB6_C2", C.FROB6_C2),
                      ("FROB12_C1", C.FROB12_C1)):
        w(f"static const cfq2 C_{name}[4] = {{")
        for p in tab:
            w(f"  {_fq2(p)},")
        w("};")
    w("")
    naf = ", ".join(str(d) for d in C.ATE_NAF)
    w(f"static const int ATE_NAF[{len(C.ATE_NAF)}] = {{ {naf} }};")
    w(f"static const uint64_t BN_Z = {C.Z}ULL;  /* fq12.rs:122 */")
    w(f"static const cfq2 C_FQ_TWO_INV = "
      f"{_fq2((pow(2, C.Q - 2, C.Q), 0))};  /* groups/mod.rs:521 */")
    w("")
    # the GLV lattice and Barrett reciprocals at shift 270, as glv.py
    # computes and asserts them for the ladder kernel
    assert GLV._SHIFT == 270
    assert GLV._V1[0] > 0 and GLV._V1[1] < 0
    assert GLV._V2[0] > 0 and GLV._V2[1] > 0
    w("/* GLV endomorphism (bn254_tpu_torch/glv.py; canonical, Montgomery-ized")
    w("   in bn254_init).  k = k1 + k2*lambda, phi(x,y) = (beta*x, y). */")
    w(f"static const u256 C_GLV_BETA_G1 = {_u256(GLV.BETA_G1)};")
    w(f"static const u256 C_GLV_BETA_G2 = {_u256(GLV.BETA_G2)};")
    w(f"static const u256 GLV_V1A = {_u256(GLV._V1[0])};")
    w(f"static const u256 GLV_V1B_NEG = {_u256(-GLV._V1[1])};")
    w(f"static const u256 GLV_V2A = {_u256(GLV._V2[0])};")
    w(f"static const u256 GLV_V2B = {_u256(GLV._V2[1])};")
    w(f"static const uint64_t GLV_G1C[5] = {_u320(GLV._G1C)};")
    w(f"static const uint64_t GLV_G2C[5] = {_u320(GLV._G2C)};")
    return "\n".join(out) + "\n"


# ---- build and load ----

def library_path() -> Path:
    """Where the library for the current source, header and flags lives
    (built or not)."""
    h = hashlib.sha256()
    h.update(SOURCE.read_bytes())
    h.update(consts_header().encode())
    h.update(" ".join([CC, *FLAGS]).encode())
    return BUILD_DIR / f"libbn254_host_{h.hexdigest()[:16]}.so"


def build() -> Path:
    """Compile the engine unless the library for this source exists.  The
    header goes to ``_build/host/bn254_consts.h`` (``-I`` points there, so
    the copied source stays verbatim and never sees the CUDA kernels'
    header of the same name in ``_build/``)."""
    global build_seconds
    lib = library_path()
    if lib.exists():
        return lib
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    with open(BUILD_DIR / ".lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)        # released when the file closes
        if lib.exists():                        # another process built it meanwhile
            return lib
        header = BUILD_DIR / "bn254_consts.h"
        tmp_header = header.with_name(f"bn254_consts.h.{os.getpid()}")
        tmp_header.write_text(consts_header())
        tmp_header.replace(header)
        tmp = lib.with_name(f"{lib.name}.{os.getpid()}.tmp")
        t0 = time.perf_counter()
        try:
            out = subprocess.run([CC, *FLAGS, "-I", str(BUILD_DIR), "-o", str(tmp),
                                  str(SOURCE)],
                                 stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        except OSError as e:
            raise RuntimeError(f"native host engine: cannot run {CC!r}: {e}") from e
        if out.returncode:
            tmp.unlink(missing_ok=True)
            raise RuntimeError(f"native host engine build failed ({CC} exit "
                               f"{out.returncode}):\n{out.stdout}")
        tmp.replace(lib)
        build_seconds = time.perf_counter() - t0
    return lib


_P = ctypes.POINTER(ctypes.c_uint64)
_SIGS = {     # C entry -> (argument types, result type)
    "bn254_init": ([], None),
    "bn254_g1_mul": ([_P, _P, _P], None),
    "bn254_g2_mul": ([_P, _P, _P], None),
    "bn254_g1_add": ([_P, _P, _P], None),
    "bn254_g2_add": ([_P, _P, _P], None),
    "bn254_fq12_pow": ([_P, _P, _P], None),
    "bn254_final_exp": ([_P, _P], None),
    "bn254_pairing": ([_P, _P, _P], ctypes.c_int),
    "bn254_pairing_batch": ([ctypes.c_int, _P, _P, _P], ctypes.c_int),
    "bn254_miller_loop_batch": ([ctypes.c_int, _P, _P, _P], ctypes.c_int),
    "bn254_msm_g1": ([ctypes.c_int, _P, _P, _P], ctypes.c_int),
    "bn254_msm_g2": ([ctypes.c_int, _P, _P, _P], ctypes.c_int),
}


def load():
    """The loaded, initialised library, built first if needed.  Raises
    where the build fails."""
    global _LIB
    if _LIB is None:
        lib = ctypes.CDLL(str(build()))
        for name, (args, res) in _SIGS.items():
            fn = getattr(lib, name)
            fn.argtypes, fn.restype = args, res
        lib.bn254_init()
        _LIB = lib
    return _LIB


def enabled() -> bool:
    """Whether the scalar API runs on the engine: True unless
    BN254_NO_NATIVE is set (read on every call).  The first True builds
    and loads the library, and raises where that fails."""
    if os.environ.get("BN254_NO_NATIVE"):
        return False
    load()
    return True


# ---- marshalling: canonical int <-> u64[4] little-endian ----

def _buf(n_words):
    return (ctypes.c_uint64 * n_words)()


def _put(buf, offset, v: int):
    for i in range(_WORDS):
        buf[offset + i] = (v >> (64 * i)) & 0xFFFFFFFFFFFFFFFF


def _get(buf, offset) -> int:
    return sum(int(buf[offset + i]) << (64 * i) for i in range(_WORDS))


def _put_fq2(buf, off, a):
    _put(buf, off, a[0])
    _put(buf, off + 4, a[1])


def _get_fq2(buf, off):
    return (_get(buf, off), _get(buf, off + 4))


def _put_g1(buf, off, p):
    _put(buf, off, p[0])
    _put(buf, off + 4, p[1])
    _put(buf, off + 8, p[2])


def _put_g2(buf, off, p):
    _put_fq2(buf, off, p[0])
    _put_fq2(buf, off + 8, p[1])
    _put_fq2(buf, off + 16, p[2])


def _get_g1(buf, off=0):
    return (_get(buf, off), _get(buf, off + 4), _get(buf, off + 8))


def _get_g2(buf, off=0):
    return (_get_fq2(buf, off), _get_fq2(buf, off + 8),
            _get_fq2(buf, off + 16))


def _get_fq12(buf):
    return ((_get_fq2(buf, 0), _get_fq2(buf, 8), _get_fq2(buf, 16)),
            (_get_fq2(buf, 24), _get_fq2(buf, 32), _get_fq2(buf, 40)))


def _put_fq12(buf, f):
    (c00, c01, c02), (c10, c11, c12) = f
    _put_fq2(buf, 0, c00)
    _put_fq2(buf, 8, c01)
    _put_fq2(buf, 16, c02)
    _put_fq2(buf, 24, c10)
    _put_fq2(buf, 32, c11)
    _put_fq2(buf, 40, c12)


# ---- operations (spec values in, spec values out) ----

def g1_scalar_mul(p, k: int):
    lib = load()
    pb, kb, ob = _buf(12), _buf(4), _buf(12)
    _put_g1(pb, 0, p)
    _put(kb, 0, k)
    lib.bn254_g1_mul(pb, kb, ob)
    return _get_g1(ob)


def g2_scalar_mul(p, k: int):
    lib = load()
    pb, kb, ob = _buf(24), _buf(4), _buf(24)
    _put_g2(pb, 0, p)
    _put(kb, 0, k)
    lib.bn254_g2_mul(pb, kb, ob)
    return _get_g2(ob)


def g1_add(p, q):
    lib = load()
    pb, qb, ob = _buf(12), _buf(12), _buf(12)
    _put_g1(pb, 0, p)
    _put_g1(qb, 0, q)
    lib.bn254_g1_add(pb, qb, ob)
    return _get_g1(ob)


def g2_add(p, q):
    lib = load()
    pb, qb, ob = _buf(24), _buf(24), _buf(24)
    _put_g2(pb, 0, p)
    _put_g2(qb, 0, q)
    lib.bn254_g2_add(pb, qb, ob)
    return _get_g2(ob)


def pairing(p, q):
    """Reduced pairing of spec Jacobian points -> spec fq12."""
    lib = load()
    pb, qb, ob = _buf(12), _buf(24), _buf(48)
    _put_g1(pb, 0, p)
    _put_g2(qb, 0, q)
    rc = lib.bn254_pairing(pb, qb, ob)
    assert rc == 0, f"native pairing rc={rc}"
    return _get_fq12(ob)


def pairing_batch(ps, qs):
    lib = load()
    n = len(ps)
    pb, qb, ob = _buf(12 * max(n, 1)), _buf(24 * max(n, 1)), _buf(48)
    for t, (p, q) in enumerate(zip(ps, qs)):
        _put_g1(pb, 12 * t, p)
        _put_g2(qb, 24 * t, q)
    rc = lib.bn254_pairing_batch(n, pb, qb, ob)
    assert rc == 0, f"native pairing_batch rc={rc}"
    return _get_fq12(ob)


def msm_g1(points, scalars):
    """Pippenger MSM over G1 in C: points = spec Jacobian triples,
    scalars = canonical ints."""
    lib = load()
    n = len(points)
    assert n == len(scalars)
    pb, kb, ob = _buf(12 * max(n, 1)), _buf(4 * max(n, 1)), _buf(12)
    for t, p in enumerate(points):
        _put_g1(pb, 12 * t, p)
    for t, k in enumerate(scalars):
        _put(kb, 4 * t, k)
    rc = lib.bn254_msm_g1(n, pb, kb, ob)
    assert rc == 0, f"native msm rc={rc}"
    return _get_g1(ob)


def msm_g2(points, scalars):
    """Pippenger MSM over G2 in C (see msm_g1)."""
    lib = load()
    n = len(points)
    assert n == len(scalars)
    pb, kb, ob = _buf(24 * max(n, 1)), _buf(4 * max(n, 1)), _buf(24)
    for t, p in enumerate(points):
        _put_g2(pb, 24 * t, p)
    for t, k in enumerate(scalars):
        _put(kb, 4 * t, k)
    rc = lib.bn254_msm_g2(n, pb, kb, ob)
    assert rc == 0, f"native msm rc={rc}"
    return _get_g2(ob)


def miller_loop_batch(qs, ps):
    """Returns the un-exponentiated fq12, or raises ValueError on an
    infinity point (lib.rs:625-633 semantics)."""
    lib = load()
    n = len(ps)
    pb, qb, ob = _buf(12 * max(n, 1)), _buf(24 * max(n, 1)), _buf(48)
    for t, (q, p) in enumerate(zip(qs, ps)):
        _put_g1(pb, 12 * t, p)
        _put_g2(qb, 24 * t, q)
    rc = lib.bn254_miller_loop_batch(n, qb, pb, ob)
    if rc == -1:
        raise ValueError("point at infinity")
    assert rc == 0, f"native miller_loop_batch rc={rc}"
    return _get_fq12(ob)


def fq12_pow(f, e: int):
    lib = load()
    fb, eb, ob = _buf(48), _buf(4), _buf(48)
    _put_fq12(fb, f)
    _put(eb, 0, e)
    lib.bn254_fq12_pow(fb, eb, ob)
    return _get_fq12(ob)


def final_exp(f):
    lib = load()
    fb, ob = _buf(48), _buf(48)
    _put_fq12(fb, f)
    lib.bn254_final_exp(fb, ob)
    return _get_fq12(ob)
