"""Radix-2^16 multi-limb modular arithmetic on torch tensors — the plain
(non-kernel) limb layer of the port, counterpart of bn254_tpu/limbs.py.

A 256-bit value is 16 little-endian 16-bit limbs in a ``torch.int32``
tensor of shape ``[..., 16, B]``: the limb axis second to last, the batch
axis last, any leading axes (stacked independent operands).  Values are
Montgomery residues (R = 2^256, as the JAX package), fully reduced, every
limb < 2^16 — the JAX package's uint32 limbs bit for bit, so converting
between the two is a numpy cast.

The ops compute in int64 internally (torch on the CPU has no uint32
``add``/``>>``/``sum``).  Carry chains are resolved without a per-limb
Python loop: a few split-and-shift rounds bound every limb by 2^16, then
one carry-lookahead pass (generate/propagate bits summed into one int64
per lane) settles the ripple.  So every op is a fixed, small number of
torch calls whatever the leading shape, which is what keeps a whole plain
pairing cheap on the CPU when the tower stacks its independent products.

These ops run on any device.  ``mont_mul``/``mont_sqr`` are the plain
versions of the Montgomery kernels (mont_kernels.py); add/sub/neg are not
kernels on either side (the JAX package leaves them to XLA).
"""

from __future__ import annotations

import numpy as np
import torch

from . import counts

LIMB_BITS = 16
N_LIMBS = 16
MASK = (1 << LIMB_BITS) - 1

_U32 = np.uint32


# ---------------------------------------------------------------------------
# Host codecs (numpy; exact Python ints at the boundary)
# ---------------------------------------------------------------------------

def limbs_from_int(v: int, n: int = N_LIMBS) -> np.ndarray:
    """Little-endian 16-bit limb decomposition of a Python int -> [n] uint32."""
    assert 0 <= v < (1 << (LIMB_BITS * n))
    return np.array([(v >> (LIMB_BITS * k)) & MASK for k in range(n)], dtype=_U32)


def int_from_limbs(a) -> int:
    """Inverse of limbs_from_int; accepts any array-like of limbs."""
    a = np.asarray(a, dtype=np.uint64)
    return sum(int(x) << (LIMB_BITS * k) for k, x in enumerate(a))


def _ints_to_limbs(vals) -> np.ndarray:
    """Canonical ints (< 2^256) -> C-contiguous [16, B] uint32 limbs, via bytes."""
    data = b"".join(int(v).to_bytes(2 * N_LIMBS, "little") for v in vals)
    return np.ascontiguousarray(np.frombuffer(data, dtype="<u2").reshape(-1, N_LIMBS).T,
                                dtype=_U32)


def _limbs_to_ints(a) -> list:
    """[16, B] limbs -> list of B Python ints."""
    raw = np.ascontiguousarray(np.asarray(a).astype("<u2").T).tobytes()
    n = 2 * N_LIMBS
    return [int.from_bytes(raw[i:i + n], "little") for i in range(0, len(raw), n)]


# ---------------------------------------------------------------------------
# Modulus context
# ---------------------------------------------------------------------------

class Mod:
    """Per-modulus constants, the same as bn254_tpu.limbs.Mod (the modulus
    limbs, -q^-1 mod 2^16, ~q, R mod q, R^2, R^-1) plus -q^-1 mod 2^32 for
    the kernels' 32-bit CIOS words, and per-device constant tensors."""

    def __init__(self, modulus: int):
        self.modulus = modulus
        self.q_np = limbs_from_int(modulus)
        self.notq_np = np.array([(~int(x)) & MASK for x in self.q_np], dtype=_U32)
        self.qinv = _U32((-pow(modulus, -1, 1 << LIMB_BITS)) & MASK)
        self.qinv32 = (-pow(modulus, -1, 1 << 32)) % (1 << 32)
        self.r = (1 << (LIMB_BITS * N_LIMBS)) % modulus  # Montgomery R mod q
        self.r2 = (self.r * self.r) % modulus
        self.r_inv = pow(self.r, modulus - 2, modulus)
        self._dev = {}

    def consts(self, device):
        """{"q", "notq"}: int64 [16, 1] tensors on `device`, and "q2x2":
        2q^2 as int64 [32, 1] limbs (cached)."""
        key = torch.device(device)
        c = self._dev.get(key)
        if c is None:
            col = lambda a: torch.tensor(a.astype(np.int64), device=key)[:, None]
            c = {"q": col(self.q_np), "notq": col(self.notq_np),
                 "q2x2": col(limbs_from_int(2 * self.modulus ** 2, 2 * N_LIMBS))}
            self._dev[key] = c
        return c

    def words(self) -> list:
        """[q as 8 little-endian 32-bit words] + [-q^-1 mod 2^32]: the
        modulus argument of the Montgomery kernels."""
        q = self.modulus
        return [(q >> (32 * j)) & 0xFFFFFFFF for j in range(8)] + [self.qinv32]

    # -- host codecs (Montgomery domain) --
    def encode(self, v: int) -> np.ndarray:
        """Canonical int -> Montgomery-form limbs [N] (enter: *R mod q)."""
        return limbs_from_int((v % self.modulus) * self.r % self.modulus)

    def decode(self, a) -> int:
        """Montgomery-form limbs -> canonical int (exit: *R^-1 mod q)."""
        return int_from_limbs(np.asarray(a)) * self.r_inv % self.modulus

    def encode_batch(self, vals) -> np.ndarray:
        m, r = self.modulus, self.r
        return _ints_to_limbs([(v % m) * r % m for v in vals])

    def decode_batch(self, a) -> list:
        if isinstance(a, torch.Tensor):
            a = a.cpu().numpy()
        m, ri = self.modulus, self.r_inv
        return [v * ri % m for v in _limbs_to_ints(a)]


# ---------------------------------------------------------------------------
# Carry resolution
# ---------------------------------------------------------------------------

_LOOKAHEAD = {}


def _lookahead_consts(device, n: int):
    c = _LOOKAHEAD.get((device, n))
    if c is None:
        sh = torch.arange(n, dtype=torch.int64, device=device)[:, None]
        c = (sh, torch.ones_like(sh) << sh)
        _LOOKAHEAD[(device, n)] = c
    return c


def _shift_up(hi):
    """Move each limb's carry one limb up (the top carry leaves)."""
    return torch.nn.functional.pad(hi[..., :-1, :], (0, 0, 1, 0))


def _carry(x, rounds: int):
    """Carry-normalise non-negative int64 limbs [..., n, B] (16 for a field
    element; any n up to 60, for the GLV decomposition's wider products).

    `rounds` split-and-shift passes must bring every limb to <= 2^16 (one
    pass for limbs < 2^17, three for limbs < 2^38).  Returns (limbs in
    [0, 2^16), carry out of the top limb as [..., B])."""
    n = x.shape[-2]
    out = None
    for _ in range(rounds):
        hi = x >> LIMB_BITS
        top = hi[..., -1, :]
        out = top if out is None else out + top
        x = (x & MASK) + _shift_up(hi)
    # every limb is now <= 2^16: limb == 2^16 generates a carry, limb ==
    # 2^16 - 1 propagates one.  Adding the generate and generate|propagate
    # bit vectors as integers runs the whole ripple in one int64 add.
    sh, w = _lookahead_consts(x.device, n)
    g = x >> LIMB_BITS
    p = (x == MASK).to(torch.int64)
    s = ((g | p) * w).sum(-2) + (g * w).sum(-2)
    cin = ((s.unsqueeze(-2) >> sh) & 1) ^ p
    return (x + cin) & MASK, out + (s >> n)


def _cond_sub(x, c):
    """x - q if x >= q else x, for reduced-up-to-2q int64 limbs."""
    t = x + c["notq"]
    t[..., 0, :] += 1
    s, ge = _carry(t, 1)
    return torch.where(ge.unsqueeze(-2) > 0, s, x)


def _i64(a):
    return a.to(torch.int64)


# ---------------------------------------------------------------------------
# Plain field ops ([..., 16, B] int32 in, int32 out; broadcast over leading axes)
# ---------------------------------------------------------------------------

def add_mod(a, b, mod: Mod):
    """(a + b) mod q; inputs reduced, output reduced."""
    c = mod.consts(a.device)
    s, _ = _carry(_i64(a) + _i64(b), 1)     # a + b < 2q < 2^256
    return _cond_sub(s, c).to(torch.int32)


def sub_mod(a, b, mod: Mod):
    """(a - b) mod q via a + q + ~b + 1 (mod 2^256)."""
    c = mod.consts(a.device)
    t = _i64(a) + c["q"] + (MASK - _i64(b))  # limbs < 3 * 2^16
    t[..., 0, :] += 1
    s, _ = _carry(t, 2)                      # drop the 2^256 wrap carry
    return _cond_sub(s, c).to(torch.int32)


def neg_mod(a, mod: Mod):
    """(-a) mod q, branchless incl. a == 0 (q - 0 -> q -> cond_sub -> 0)."""
    c = mod.consts(a.device)
    t = (MASK - _i64(a)) + c["q"]
    t[..., 0, :] += 1
    s, _ = _carry(t, 1)
    return _cond_sub(s, c).to(torch.int32)


def _product_columns(a, b):
    """Schoolbook columns of [..., 16, B] x [..., 16, B] -> [..., 32, B]
    int64 (column k = sum over i + j = k of a_i b_j, < 2^36; column 31 is
    0).  The anti-diagonal sums come from one skewed view: rows of the
    padded [16, 32] product table laid out with stride 31 put a_i b_j at
    column i + j."""
    n = N_LIMBS
    prod = a.unsqueeze(-2) * b.unsqueeze(-3)                 # [..., 16(i), 16(j), B]
    prod = torch.nn.functional.pad(prod, (0, 0, 0, n))       # [..., 16, 32, B]
    lead, bsz = prod.shape[:-3], prod.shape[-1]
    flat = prod.reshape(*lead, n * 2 * n, bsz)[..., : n * (2 * n - 1), :]
    cols = flat.reshape(*lead, n, 2 * n - 1, bsz).sum(-3)   # [..., 31, B]
    return torch.nn.functional.pad(cols, (0, 0, 0, 1))


def _signed_to_limbs(t, mod: Mod):
    """Signed int64 columns [..., 32, B] of a value T in (-2q^2, 2q^2) ->
    the 16-bit limbs of T + 2q^2, which is in (0, 4q^2) and has T's
    residue mod q.  One ripple over the columns: ``& MASK`` and the
    arithmetic ``>>`` split a negative column exactly (two's complement),
    and the final carry is 0 because the value is non-negative."""
    t = t + mod.consts(t.device)["q2x2"]
    out, carry = [], 0
    for k in range(2 * N_LIMBS):
        v = t[..., k, :] + carry
        out.append(v & MASK)
        carry = v >> LIMB_BITS
    return torch.stack(out, -2)


def _redc(t, mod: Mod, signed: bool = False):
    """Montgomery-reduce 32 int64 columns: T * 2^-256 mod q, canonical
    [..., 16, B] int32.

    Unsigned (the default): columns >= 0 with T < q * 2^256, as a
    product's columns are; the loop adds m q per column, the upper half
    ends with columns < 2^38 and a value < 2q < 2^256, and one
    conditional subtraction finishes.  ``signed=True`` takes the signed
    column differences of the lazy Fq2 product (|T| < 2q^2) and first
    adds 2q^2 (``_signed_to_limbs``): T + 2q^2 < 4q^2 < q * 2^256 since
    4q < 2^256, so the same loop and one subtraction give the canonical
    value (the sum is below 4q^2 / 2^256 + q < 2q)."""
    c = mod.consts(t.device)
    if signed:
        t = _signed_to_limbs(t, mod)
    q = c["q"]
    qinv = int(mod.qinv)
    for i in range(N_LIMBS):
        m = ((t[..., i, :] & MASK) * qinv) & MASK
        t[..., i:i + N_LIMBS, :] += m.unsqueeze(-2) * q
        t[..., i + 1, :] += t[..., i, :] >> LIMB_BITS
    r, _ = _carry(t[..., N_LIMBS:, :], 3)
    return _cond_sub(r, c).to(torch.int32)


def _mont(a, b, mod: Mod):
    return _redc(_product_columns(_i64(a), _i64(b)), mod)


def mont_mul(a, b, mod: Mod):
    """Montgomery product a*b*R^-1 mod q of reduced [..., 16, B] operands:
    the plain version of the mont_mul kernel (row 1)."""
    counts.plain_calls["mont_mul"] += 1
    return _mont(a, b, mod)


def mont_sqr(a, mod: Mod):
    """Montgomery square, the product with a = b (plain version of row 2)."""
    counts.plain_calls["mont_sqr"] += 1
    return _mont(a, a, mod)


def is_zero(a):
    """[..., 16, B] -> [..., B] bool."""
    return (a == 0).all(-2)


def eq(a, b):
    """[..., 16, B] x [..., 16, B] -> [..., B] bool (values reduced => rep equality)."""
    return (a == b).all(-2)


def select(mask, a, b):
    """Branchless per-lane select: mask [..., B] -> [..., 16, B]."""
    return torch.where(mask.unsqueeze(-2), a, b)


def zeros(batch: int, device):
    return torch.zeros((N_LIMBS, batch), dtype=torch.int32, device=device)


def broadcast_const(limbs_np: np.ndarray, batch: int, device):
    """[N] host constant -> [N, B] tensor (contiguous)."""
    col = torch.tensor(limbs_np.astype(np.int32), device=device)[:, None]
    return col.expand(N_LIMBS, batch).contiguous()
