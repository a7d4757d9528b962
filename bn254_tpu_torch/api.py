"""Public scalar API mirroring the reference crate's surface
(src/lib.rs): Fr, Fq, Fq2, G1, G2, AffineG1, AffineG2, Gt, pairing,
pairing_batch, miller_loop_batch — counterpart of bn254_tpu/api.py, with
the same names and semantics.

This layer is host-side (exact Python ints via the port's own
``bn254_tpu_torch.spec``); it is the ergonomic, single-value interface.
For throughput, use the batched API over its objects (``batch``:
``pairing_batch``, ``pairing_each``, ``msm_g1``, ``msm_g2``,
``scalar_mul_g1``), which runs the same math on the card and is
bit-exact against this layer.  The hot scalar paths (``G1/G2 * Fr``,
``Gt.pow``, ``pairing``, ``pairing_batch``, ``miller_loop_batch``) run on
the port's native host engine (``native``: C through ctypes, built at the
first such call), as the JAX package's do on its own; with
``BN254_NO_NATIVE=1`` set they run the spec.  The choice is read at each
call, never at import, and a failed build raises.
"""

import random as _random

from .spec import constants as _C
from .spec import field as _F
from .spec import group as _G
from .spec import codec as _codec
from .errors import (
    InvalidSliceLength, NotMemberFieldError, ToAffineConversion,
)
from . import native as _native

__all__ = [
    "Fr", "Fq", "Fq2", "G1", "G2", "AffineG1", "AffineG2", "Gt",
    "pairing", "pairing_batch", "miller_loop_batch",
]


def _rng_u512(rng):
    """512 random bits reduced mod m — matches U256::random's
    U512-divrem sampling (arith.rs:243-246)."""
    if isinstance(rng, _random.Random):
        return rng.getrandbits(512)
    if hasattr(rng, "getrandbits"):
        return rng.getrandbits(512)
    # numpy Generator
    return int.from_bytes(rng.bytes(64), "big")


class _Fp:
    """Common prime-field wrapper; value is a canonical int."""

    __slots__ = ("v",)
    _mod = None

    def __init__(self, v):
        self.v = v % self._mod

    # constructors -----------------------------------------------------
    @classmethod
    def zero(cls):
        return cls(0)

    @classmethod
    def one(cls):
        return cls(1)

    @classmethod
    def random(cls, rng=None):
        rng = rng if rng is not None else _random
        return cls(_rng_u512(rng) % cls._mod)

    @classmethod
    def from_str(cls, s):
        if not s or any(c not in "0123456789" for c in s):
            return None
        return cls(int(s))

    @classmethod
    def interpret(cls, buf):
        """64 bytes -> reduce mod modulus (fp.rs:62-64)."""
        if len(buf) != 64:
            raise InvalidSliceLength("expected 64 bytes")
        return cls(int.from_bytes(bytes(buf), "big"))

    # arithmetic --------------------------------------------------------
    def __add__(self, o):
        return type(self)(self.v + o.v)

    def __sub__(self, o):
        return type(self)(self.v - o.v)

    def __mul__(self, o):
        return type(self)(self.v * o.v)

    def __neg__(self):
        return type(self)(-self.v)

    def pow(self, exp):
        return type(self)(pow(self.v, exp.v, self._mod))

    def inverse(self):
        if self.v == 0:
            return None
        return type(self)(pow(self.v, self._mod - 2, self._mod))

    def is_zero(self):
        return self.v == 0

    def __eq__(self, o):
        return type(self) is type(o) and self.v == o.v

    def __hash__(self):
        return hash((type(self).__name__, self.v))

    def __repr__(self):
        return f"{type(self).__name__}({self.v})"

    def to_big_endian(self):
        return self.v.to_bytes(32, "big")

    def into_int(self):
        return self.v


class Fr(_Fp):
    """Scalar field element (mod r)."""
    __slots__ = ()
    _mod = _C.R

    @classmethod
    def from_slice(cls, b):
        """32 bytes, UNREDUCED — implicitly reduced (lib.rs:45-49)."""
        return cls(_codec.fr_from_slice(bytes(b)))

    @classmethod
    def new_mul_factor(cls, v):
        return cls(v)

    @classmethod
    def new(cls, v):
        if v >= cls._mod:
            return None
        return cls(v)

    def set_bit(self, bit, to):
        """Set bit `bit` of the MONTGOMERY representation (lib.rs:65-67,
        fp.rs:83-85: the reference mutates the raw U256 repr, which holds
        v*R mod r).  We store canonical ints, so: enter Montgomery form,
        set the bit, exit.  Out-of-range bits are ignored, like
        arith.rs:252-262's false return.  Mutates self, returns None
        (reference parity).

        Divergence for NON-CANONICAL reprs: the reference keeps the raw
        U256 unreduced, so a set bit can push the repr >= r and a later
        get_bit/equality/round-trip sees those raw bits (e.g.
        set_bit(255, True) then set_bit(255, False) restores the
        original there).  We re-canonicalize (reduce mod r) after every
        mutation, so such out-of-field intermediate states are folded
        immediately; behavior matches the reference exactly whenever the
        mutated repr stays < r (the canonical-construction use case)."""
        if not 0 <= bit < 256:
            return
        m = (self.v * _C.MONT_R_FR) % self._mod
        m = (m | (1 << bit)) if to else (m & ~(1 << bit))
        self.v = (m * pow(_C.MONT_R_FR, -1, self._mod)) % self._mod


class Fq(_Fp):
    """Base field element (mod q)."""
    __slots__ = ()
    _mod = _C.Q

    @classmethod
    def from_slice(cls, b):
        """32 bytes; values >= q rejected (lib.rs:154-159)."""
        return cls(_codec.fq_from_slice(bytes(b)))

    @classmethod
    def from_u256(cls, v):
        if v >= cls._mod:
            raise NotMemberFieldError("value >= q")
        return cls(v)

    @classmethod
    def modulus(cls):
        return _C.Q

    def sqrt(self):
        r = _F.fq_sqrt(self.v)
        return None if r is None else Fq(r)


class Fq2:
    """Quadratic extension element c0 + c1*i."""

    __slots__ = ("c",)

    def __init__(self, a, b):
        a = a if isinstance(a, Fq) else Fq(a)
        b = b if isinstance(b, Fq) else Fq(b)
        self.c = (a.v, b.v)

    @classmethod
    def _wrap(cls, t):
        o = cls.__new__(cls)
        o.c = (t[0] % _C.Q, t[1] % _C.Q)
        return o

    @classmethod
    def zero(cls):
        return cls._wrap(_F.FQ2_ZERO)

    @classmethod
    def one(cls):
        return cls._wrap(_F.FQ2_ONE)

    @classmethod
    def i(cls):
        return cls._wrap(_F.FQ2_I)

    @classmethod
    def from_slice(cls, b):
        return cls._wrap(_codec.fq2_from_slice(bytes(b)))

    def real(self):
        return Fq(self.c[0])

    def imaginary(self):
        return Fq(self.c[1])

    def is_zero(self):
        return self.c == (0, 0)

    def pow(self, exp):
        return Fq2._wrap(_F.fq2_pow(self.c, int(exp)))

    def sqrt(self):
        r = _F.fq2_sqrt(self.c)
        return None if r is None else Fq2._wrap(r)

    def inverse(self):
        r = _F.fq2_inv(self.c)
        return None if r is None else Fq2._wrap(r)

    def to_u512(self):
        return _F.fq2_to_u512(self.c)

    def __add__(self, o):
        return Fq2._wrap(_F.fq2_add(self.c, o.c))

    def __sub__(self, o):
        return Fq2._wrap(_F.fq2_sub(self.c, o.c))

    def __mul__(self, o):
        return Fq2._wrap(_F.fq2_mul(self.c, o.c))

    def __neg__(self):
        return Fq2._wrap(_F.fq2_neg(self.c))

    def __eq__(self, o):
        return isinstance(o, Fq2) and self.c == o.c

    def __hash__(self):
        return hash(("Fq2", self.c))

    def __repr__(self):
        return f"Fq2({self.c[0]}, {self.c[1]})"


class _Point:
    """Jacobian point wrapper; subclass fixes the params."""

    __slots__ = ("p",)
    _K = None
    _gen = None
    _b = None
    _name = None

    def __init__(self, x, y, z):
        self.p = (self._unwrap(x), self._unwrap(y), self._unwrap(z))

    @classmethod
    def _wrap(cls, p):
        o = cls.__new__(cls)
        o.p = p
        return o

    @classmethod
    def zero(cls):
        return cls._wrap(_G.zero(cls._K))

    @classmethod
    def one(cls):
        g = cls._gen
        return cls._wrap((g[0], g[1], cls._K.one))

    @classmethod
    def random(cls, rng=None):
        return cls.one() * Fr.random(rng)

    @classmethod
    def b(cls):
        return cls._wrapf(cls._b)

    def is_zero(self):
        return _G.is_zero(self.p, self._K)

    def double(self):
        return self._wrap(_G.double(self.p, self._K))

    def normalize(self):
        a = _G.to_affine(self.p, self._K)
        if a is None:
            return
        self.p = (a[0], a[1], self._K.one)

    def x(self):
        return self._wrapf(self.p[0])

    def y(self):
        return self._wrapf(self.p[1])

    def z(self):
        return self._wrapf(self.p[2])

    def __add__(self, o):
        return self._wrap(_G.add(self.p, o.p, self._K))

    def __sub__(self, o):
        return self._wrap(_G.add(self.p, _G.neg(o.p, self._K), self._K))

    def __neg__(self):
        return self._wrap(_G.neg(self.p, self._K))

    def __mul__(self, fr):
        if _native.enabled():
            mul = (_native.g1_scalar_mul if self._K is _G.FqOps
                   else _native.g2_scalar_mul)
            return self._wrap(mul(self.p, fr.v))
        return self._wrap(_G.scalar_mul(self.p, fr.v, self._K))

    def __eq__(self, o):
        return type(self) is type(o) and _G.eq(self.p, o.p, self._K)

    def __hash__(self):  # projective classes: hash via affine coords
        a = _G.to_affine(self.p, self._K)
        return hash((self._name, a))

    def __repr__(self):
        return f"{self._name}{self.p}"


class G1(_Point):
    __slots__ = ()
    _K = _G.FqOps
    _gen = _C.G1_ONE
    _b = _C.B1
    _name = "G1"

    @staticmethod
    def _unwrap(v):
        return v.v if isinstance(v, Fq) else int(v)

    @staticmethod
    def _wrapf(v):
        return Fq(v)

    @classmethod
    def from_compressed(cls, b):
        x, y = _codec.g1_from_compressed(bytes(b))
        return cls._wrap((x, y, 1))


class G2(_Point):
    __slots__ = ()
    _K = _G.Fq2Ops
    _gen = _C.G2_ONE
    _b = _C.B2
    _name = "G2"

    @staticmethod
    def _unwrap(v):
        return v.c if isinstance(v, Fq2) else tuple(v)

    @staticmethod
    def _wrapf(v):
        return Fq2._wrap(v)

    @classmethod
    def from_compressed(cls, b):
        x, y = _codec.g2_from_compressed(bytes(b))
        return cls._wrap((x, y, _F.FQ2_ONE))


class AffineG1:
    __slots__ = ("a",)

    def __init__(self, x, y):
        self.a = _codec.affine_g1_new(G1._unwrap(x), G1._unwrap(y))

    @classmethod
    def from_jacobian(cls, g):
        aff = _G.to_affine(g.p, _G.FqOps)
        if aff is None:
            return None
        o = cls.__new__(cls)
        o.a = aff
        return o

    def x(self):
        return Fq(self.a[0])

    def y(self):
        return Fq(self.a[1])

    def to_jacobian(self):
        return G1._wrap((self.a[0], self.a[1], 1))

    def __neg__(self):
        o = AffineG1.__new__(AffineG1)
        o.a = (self.a[0], -self.a[1] % _C.Q)
        return o

    def __eq__(self, o):
        return isinstance(o, AffineG1) and self.a == o.a

    def __hash__(self):
        return hash(("AffineG1", self.a))


class AffineG2:
    __slots__ = ("a",)

    def __init__(self, x, y):
        self.a = _codec.affine_g2_new(G2._unwrap(x), G2._unwrap(y))

    @classmethod
    def from_jacobian(cls, g):
        aff = _G.to_affine(g.p, _G.Fq2Ops)
        if aff is None:
            return None
        o = cls.__new__(cls)
        o.a = aff
        return o

    def x(self):
        return Fq2._wrap(self.a[0])

    def y(self):
        return Fq2._wrap(self.a[1])

    def to_jacobian(self):
        return G2._wrap((self.a[0], self.a[1], _F.FQ2_ONE))

    def __neg__(self):
        o = AffineG2.__new__(AffineG2)
        o.a = (self.a[0], _F.fq2_neg(self.a[1]))
        return o

    def __eq__(self, o):
        return isinstance(o, AffineG2) and self.a == o.a

    def __hash__(self):
        return hash(("AffineG2", self.a))


class Gt:
    """Target-group element (unitary subgroup of Fq12)."""

    __slots__ = ("f",)

    def __init__(self, f):
        self.f = f

    @classmethod
    def one(cls):
        return cls(_F.FQ12_ONE)

    def pow(self, exp):
        if _native.enabled():
            return Gt(_native.fq12_pow(self.f, exp.v))
        return Gt(_F.fq12_pow(self.f, exp.v))

    def inverse(self):
        r = _F.fq12_inv(self.f)
        return None if r is None else Gt(r)

    def final_exponentiation(self):
        r = _F.fq12_final_exponentiation(self.f)
        return None if r is None else Gt(r)

    def is_zero(self):
        return self.f == _F.FQ12_ZERO

    def __mul__(self, o):
        return Gt(_F.fq12_mul(self.f, o.f))

    def __eq__(self, o):
        return isinstance(o, Gt) and self.f == o.f

    def __hash__(self):
        return hash(("Gt", self.f))


def pairing(p, q):
    """Reduced optimal-ate pairing e(p, q); infinity in either slot yields
    Gt::one (lib.rs:611-613)."""
    if _native.enabled():
        return Gt(_native.pairing(p.p, q.p))
    return Gt(_G.pairing(p.p, q.p))


def pairing_batch(pairs):
    """Batch pairing, silently skipping infinity pairs; one shared final
    exponentiation (lib.rs:615-623)."""
    if _native.enabled():
        return Gt(_native.pairing_batch([p.p for p, _ in pairs],
                                        [q.p for _, q in pairs]))
    return Gt(_G.pairing_batch([p.p for p, _ in pairs], [q.p for _, q in pairs]))


def miller_loop_batch(pairs):
    """Un-exponentiated batch Miller loop over (G2, G1) pairs; raises
    ToAffineConversion on points at infinity (lib.rs:625-633)."""
    if _native.enabled():
        try:
            return Gt(_native.miller_loop_batch(
                [q.p for q, _ in pairs], [p.p for _, p in pairs]))
        except ValueError:
            raise ToAffineConversion("point at infinity")
    coeffs_list = []
    p_affines = []
    for q, p in pairs:
        qa = _G.to_affine(q.p, _G.Fq2Ops)
        pa = _G.to_affine(p.p, _G.FqOps)
        if qa is None or pa is None:
            raise ToAffineConversion("point at infinity")
        coeffs_list.append(_G.precompute(qa))
        p_affines.append(pa)
    return Gt(_G.miller_loop_batch(coeffs_list, p_affines))
