"""Plain PyTorch Montgomery arithmetic over BN254's Fq, for making inputs.

The benchmark's own field code, independent of the measured program: a value
is 16 little-endian 16-bit limbs of its Montgomery residue (R = 2^256) in an
int64 tensor ``[16, n]``, the layout the program takes (as int32).  Products
are word-by-word Montgomery (CIOS) over 16 limbs; every result is fully
reduced.  It runs on any device, in a few hundred small tensor operations a
product, which is plenty for making tables of points at set-up.
"""

from __future__ import annotations

import numpy as np
import torch

from bnref.bn254 import Q

MASK = 0xFFFF
QINV16 = (-pow(Q, -1, 1 << 16)) % (1 << 16)
MONT = 1 << 256


def int_limbs(v: int) -> list:
    return [(v >> (16 * j)) & MASK for j in range(16)]


def mont(v: int) -> int:
    return v % Q * MONT % Q


def const(v: int, device) -> torch.Tensor:
    """A canonical int -> its Montgomery limbs as a [16, 1] column."""
    return torch.tensor(int_limbs(mont(v)), dtype=torch.int64, device=device)[:, None]


def column(vals, device) -> torch.Tensor:
    """Canonical ints -> Montgomery limbs [16, len(vals)]."""
    data = b"".join(mont(v).to_bytes(32, "little") for v in vals)
    a = np.frombuffer(data, dtype="<u2").reshape(-1, 16).T.astype(np.int64)
    return torch.from_numpy(np.ascontiguousarray(a)).to(device)


class Fq:
    """Montgomery arithmetic on [16, n] int64 limb tensors of one device."""

    def __init__(self, device):
        self.q = torch.tensor(int_limbs(Q), dtype=torch.int64, device=device)[:, None]

    def _carry(self, u):
        """Limbs of any sign and size -> limbs in [0, 2^16), the excess in u[-1]."""
        for j in range(u.shape[0] - 1):
            u[j + 1] += u[j] >> 16
            u[j] &= MASK
        return u

    def _reduce(self, u):
        """u [17, n], carried, value < 2q -> the fully reduced [16, n]."""
        d = u[:16] - self.q
        borrow = torch.zeros_like(d[0])
        for j in range(16):
            d[j] += borrow
            borrow = d[j] >> 16
            d[j] &= MASK
        keep = (u[16] + borrow) < 0                       # u < q
        return torch.where(keep, u[:16], d)

    def _widen(self, u):
        return torch.cat([u, torch.zeros_like(u[:1])])

    def add(self, a, b):
        return self._reduce(self._carry(self._widen(a + b)))

    def sub(self, a, b):
        return self._reduce(self._carry(self._widen(a - b + self.q)))

    def mul(self, a, b):
        n = max(a.shape[1], b.shape[1])
        t = torch.zeros((33, n), dtype=torch.int64, device=self.q.device)
        for i in range(16):
            t[i:i + 16] += a[i] * b
            m = (t[i] * QINV16) & MASK
            t[i:i + 16] += m * self.q
            t[i + 1] += t[i] >> 16
        return self._reduce(self._carry(t[16:].contiguous()))

    def sqr(self, a):
        return self.mul(a, a)


class Fq2:
    """Fq2 = Fq[u]/(u^2 + 1) over pairs of limb tensors."""

    def __init__(self, fq: Fq):
        self.f = fq

    def add(self, a, b):
        return (self.f.add(a[0], b[0]), self.f.add(a[1], b[1]))

    def sub(self, a, b):
        return (self.f.sub(a[0], b[0]), self.f.sub(a[1], b[1]))

    def mul(self, a, b):
        f = self.f
        aa, bb = f.mul(a[0], b[0]), f.mul(a[1], b[1])
        return (f.sub(aa, bb), f.sub(f.sub(f.mul(f.add(a[0], a[1]), f.add(b[0], b[1])), aa), bb))

    def sqr(self, a):
        f = self.f
        ab = f.mul(a[0], a[1])
        return (f.mul(f.add(a[0], a[1]), f.sub(a[0], a[1])), f.add(ab, ab))


def madd(K, p, q):
    """Jacobian p + affine q, madd-2007-bl (7M + 4S); p and q neither equal,
    opposite nor at infinity."""
    x1, y1, z1 = p
    x2, y2 = q
    z1z1 = K.sqr(z1)
    h = K.sub(K.mul(x2, z1z1), x1)
    hh = K.sqr(h)
    i = K.add(hh, hh)
    i = K.add(i, i)
    j = K.mul(h, i)
    r = K.sub(K.mul(y2, K.mul(z1, z1z1)), y1)
    r = K.add(r, r)
    v = K.mul(x1, i)
    x3 = K.sub(K.sub(K.sqr(r), j), K.add(v, v))
    y1j = K.mul(y1, j)
    y3 = K.sub(K.mul(r, K.sub(v, x3)), K.add(y1j, y1j))
    z3 = K.sub(K.sub(K.sqr(K.add(z1, h)), z1z1), hh)
    return x3, y3, z3
