"""The benchmark's inputs, made from the seed.

Points are tables of known multiples of a generator: P_i = (a0 + i d) G for
i < n.  The first few thousand are chained additions by the reference's own
group law on the host (as the JAX package's bench.py makes its pairs); the
table is then doubled on the device by the benchmark's own limb code
(``limbs``), P[m : 2m] = P[0 : m] + (m d) G, one mixed addition a point.
P_0 starts at z = lam, so no point has z = 1.
Knowing a_i = a0 + i d mod r is what lets the plain reference check a pairing
or an MSM without redoing the program's work (bnref.check).

Scalars are numpy limbs from the seed, each below r.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from bnref import bn254 as B

from . import limbs as L


@dataclass
class Table:
    """n points a_i G of one group, a_i = (a0 + i d) mod r, except the lanes
    in ``infinity``, which hold the point at infinity (a_i = 0)."""
    ncoords: int
    coords: list            # 3 * ncoords int64 limb tensors [16, n]: x, y, z (Fq2 as c0, c1)
    a0: int
    d: int
    infinity: np.ndarray    # lane indices

    def log(self, i: int) -> int:
        return 0 if i in self._inf else (self.a0 + i * self.d) % B.R

    def __post_init__(self):
        self._inf = set(int(i) for i in self.infinity)


def _ops(ncoords: int):
    return (B.FqOps, B.G1_ONE) if ncoords == 1 else (B.Fq2Ops, B.G2_ONE)


def _flat(ncoords: int, x):
    return [x] if ncoords == 1 else [x[0], x[1]]


def point_table(ncoords: int, n: int, rng: np.random.Generator, device,
                n_infinity: int = 0, host: int = 2048) -> Table:
    """n points of G1 (ncoords 1) or G2 (ncoords 2) on ``device``: the first
    ``host`` by the reference's own additions on the host, P_(i+1) = P_i +
    dG, the rest doubled on the device."""
    fq = L.Fq(device)
    K = fq if ncoords == 1 else L.Fq2(fq)
    Kp, g = _ops(ncoords)
    lift = (lambda v: v) if ncoords == 1 else (lambda v: (v, 0))
    enc = ((lambda v: L.const(v, device)) if ncoords == 1 else
           (lambda v: (L.const(v[0], device), L.const(v[1], device))))
    a0, d = (int(rng.integers(1, 1 << 62)) * int(rng.integers(1, 1 << 62)) % B.R for _ in range(2))
    lam = lift(int(rng.integers(2, 1 << 62)))
    x, y = B.to_affine(B.scalar_mul((g[0], g[1], Kp.one), a0, Kp), Kp)
    lam2 = Kp.mul(lam, lam)
    p = (Kp.mul(x, lam2), Kp.mul(y, Kp.mul(lam2, lam)), lam)      # z = lam, not 1
    step = B.scalar_mul((g[0], g[1], Kp.one), d, Kp)
    m = min(n, host)
    head = [p]
    for _ in range(m - 1):
        head.append(B.add(head[-1], step, Kp))
    cols = [torch.empty((16, n), dtype=torch.int64, device=device) for _ in range(3 * ncoords)]
    flat = [[w for coord in pt for w in _flat(ncoords, coord)] for pt in head]
    for j, c in enumerate(cols):
        c[:, :m] = L.column([f[j] for f in flat], device)

    def coord(j, cnt):
        return cols[j][:, :cnt] if ncoords == 1 else (cols[2 * j][:, :cnt], cols[2 * j + 1][:, :cnt])

    step = B.scalar_mul(step, m, Kp)                       # (m d) G, doubled each round
    while m < n:
        cnt = min(m, n - m)
        addend = tuple(enc(v) for v in B.to_affine(step, Kp))
        out = L.madd(K, tuple(coord(j, cnt) for j in range(3)), addend)
        parts = [w for o in out for w in _flat(ncoords, o)]
        for c, part in zip(cols, parts):
            c[:, m:m + cnt] = part
        step = B.double(step, Kp)
        m *= 2
    inf = np.sort(rng.choice(n, size=n_infinity, replace=False)) if n_infinity else np.zeros(0, int)
    if n_infinity:
        idx = torch.as_tensor(inf, device=device)
        for c in cols[2 * ncoords:]:                       # z = 0 marks infinity
            c[:, idx] = 0
    return Table(ncoords, cols, a0, d, inf)


def as_int32(t: torch.Tensor) -> torch.Tensor:
    return t.to(torch.int32).contiguous()


def batch_points(table: Table, lo: int, hi: int):
    """Lanes [lo, hi) of a table as the program's Jacobian tuple of
    contiguous int32 [16, n] tensors (Fq2 as (c0, c1) pairs)."""
    c = [as_int32(col[:, lo:hi]) for col in table.coords]
    if table.ncoords == 1:
        return (c[0], c[1], c[2])
    return ((c[0], c[1]), (c[2], c[3]), (c[4], c[5]))


def scalars(n: int, rng: np.random.Generator, n_zero: int = 0, n_top: int = 0) -> np.ndarray:
    """n scalars below r as canonical 16-bit limbs, int64 [16, n]; n_zero of
    them 0 and n_top of them r - 1, at lanes drawn from the seed."""
    k = rng.integers(0, 1 << 16, size=(16, n), dtype=np.int64)
    k[15] %= B.R >> 240                                    # top limb below r's: k < r
    lanes = rng.choice(n, size=n_zero + n_top, replace=False)
    k[:, lanes[:n_zero]] = 0
    k[:, lanes[n_zero:]] = np.array(L.int_limbs(B.R - 1), dtype=np.int64)[:, None]
    return k


def scalar_ints(k: np.ndarray, lanes) -> list:
    return [sum(int(k[j, i]) << (16 * j) for j in range(16)) for i in lanes]


def weighted_log_sum(k: np.ndarray, table: Table) -> int:
    """sum_i k_i a_i mod r for a table's logs a_i = a0 + i d (0 at infinity):
    a0 sum k_i + d sum i k_i, the limb sums exact in int64."""
    n = k.shape[1]
    idx = np.arange(n, dtype=np.int64)
    s0 = sum(int(k[j].sum()) << (16 * j) for j in range(16))
    s1 = sum(int((k[j] * idx).sum()) << (16 * j) for j in range(16))
    total = table.a0 * s0 + table.d * s1
    for i, ki in zip(table.infinity, scalar_ints(k, table.infinity)):
        total -= ki * ((table.a0 + int(i) * table.d) % B.R)
    return total % B.R
