"""Batched API over the scalar API's objects — counterpart of
bn254_tpu/batch.py: ``pairing_batch`` and ``pairing_each`` over (G1, G2)
pairs, the Pippenger MSMs ``msm_g1`` / ``msm_g2`` and the GLV
``scalar_mul_g1`` over G1/G2 and Fr lists.

They take and return the objects of ``api`` (``G1``, ``G2``, ``Fr``,
``Gt``), with the same semantics as the scalar API (``pairing_batch``
silently skips infinity pairs), and run on the card unless the caller
passes ``device="cpu"``, where every kernel wrapper takes its plain
version.  The objects cross to tensors and back on the host
(``pairs_in``, ``gt_out``): Python ints to Montgomery limbs, one point or
Fq12 at a time.
"""

from __future__ import annotations

from . import api as A
from . import glv as GLV
from . import groups as G
from . import msm as M
from . import pairing_torch as P
from . import tower as T

__all__ = ["pairing_batch", "pairing_each", "msm_g1", "msm_g2", "scalar_mul_g1",
           "PAIRING_CHUNK"]

# pairs a Miller launch at most (bench.py's batch).  The JAX package cuts
# at 1024 because a Mosaic kernel recompiles per shape; the card's kernels
# do not, and the Fq12 product is exact, so any chunking gives the same Gt.
PAIRING_CHUNK = 16384


def pairs_in(pairs, device):
    """(G1, G2) objects -> (G1 batch, G2 batch) of Jacobian points."""
    return (G.encode_points(G.G1, [p.p for p, _ in pairs], device),
            G.encode_points(G.G2, [q.p for _, q in pairs], device))


def gt_out(f) -> list:
    """Fq12 batch -> [Gt]."""
    return [A.Gt(v) for v in T.fq12_decode(f)]


def pairing_batch(pairs, device="cuda") -> "A.Gt":
    """Product of pairings with one shared final exponentiation (the
    scalar ``pairing_batch``'s semantics, lib.rs:615; infinity pairs are
    skipped): one Miller launch and product reduction a chunk of at most
    PAIRING_CHUNK pairs, the chunks' products multiplied, then one final
    exponentiation, all on the device."""
    pairs = list(pairs)
    if not pairs:
        return A.Gt.one()
    acc = None
    for i in range(0, len(pairs), PAIRING_CHUNK):
        p, q = pairs_in(pairs[i:i + PAIRING_CHUNK], device)
        f = P.miller_loop_batch(q, p)
        acc = f if acc is None else T.fq12_mul(acc, f)
    return gt_out(T.fq12_final_exponentiation(acc))[0]


def pairing_each(pairs, device="cuda") -> list:
    """Independent reduced pairings [e(P_i, Q_i)], infinity in either
    slot giving Gt.one()."""
    pairs = list(pairs)
    if not pairs:
        return []
    return gt_out(P.pairing(*pairs_in(pairs, device)))


def _inputs(K, points, scalars, device):
    points, scalars = list(points), list(scalars)
    if not points or len(points) != len(scalars):
        raise ValueError(f"want as many scalars as points, at least one; got "
                         f"{len(points)} points and {len(scalars)} scalars")
    return (G.encode_points(K, [p.p for p in points], device),
            M.encode_scalars([k.v for k in scalars], device))


def _msm(K, wrap, points, scalars, device, lanes):
    out = M.msm(K, *_inputs(K, points, scalars, device), lanes=lanes)
    return wrap(G.decode_points(K, out)[0])


def msm_g1(points, scalars, device="cuda", lanes=None) -> "A.G1":
    """sum_i scalars[i] * points[i] in G1 (Pippenger).  lanes, a power of
    two, is msm.LANES unless given (the JAX package's ``tiles``)."""
    return _msm(G.G1, A.G1._wrap, points, scalars, device, lanes)


def msm_g2(points, scalars, device="cuda", lanes=None) -> "A.G2":
    """sum_i scalars[i] * points[i] in G2 (Pippenger)."""
    return _msm(G.G2, A.G2._wrap, points, scalars, device, lanes)


def scalar_mul_g1(points, scalars, device="cuda") -> list:
    """[scalars[i] * points[i]] in G1, independent per point (GLV: one
    128-step joint ladder kernel for the batch)."""
    out = GLV.scalar_mul_glv(G.G1, *_inputs(G.G1, points, scalars, device))
    return [A.G1._wrap(p) for p in G.decode_points(G.G1, out)]
