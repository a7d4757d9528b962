"""The least time a layer's work can take on the card, from the frozen
counts in ``benchmark/roofline/roofline.json``.

A roofline share is that least time over the measured device time: the work
is counted from the mathematics of the call (the crate's formulas and the
inputs' digits), never from the program's kernels, so the same work is
counted whatever implements it, and a share cannot pass 100 % unless the
measured time leaves out part of the work.
"""

from __future__ import annotations

import json
from pathlib import Path

import numpy as np

SPEC = json.loads((Path(__file__).resolve().parent.parent / "roofline" / "roofline.json").read_text())
PEAK = SPEC["peak"]
MILLER = SPEC["miller"]


def least_seconds(products: float, nbytes: float) -> float:
    """The larger of the compute bound and the bytes bound."""
    compute = products * SPEC["instructions_per_product"] / PEAK["int32_ops_per_s"]
    return max(compute, nbytes / PEAK["hbm_bytes_per_s"])


def miller_steps() -> int:
    """Fq products of the 87 G2 line steps of one pair, their Frobenius bases
    and the scaling of the 87 lines by P."""
    m = MILLER
    return (m["doublings"] * m["doubling_step"] + m["additions"] * m["addition_step"]
            + m["frobenius_bases"] + m["lines"] * m["line_scaling"])


def miller_products(entry: str, finite_pairs: int) -> int:
    """Fq products of the Miller layer of one call over finite pairs (an
    infinity pair needs none).  ``pairing``: one f a pair, its 64 squares
    and 87 folds (the first square and fold act on f = 1 and are free).
    ``pairing_batch``: the crate's shared accumulator (mod.rs:609-640), the
    64 squares once for the batch and every pair's 87 lines folded in."""
    m = MILLER
    if finite_pairs == 0:
        return 0
    if entry == "pairing":
        per = miller_steps() + (m["lines"] - 1) * m["fold"] + (m["squarings"] - 1) * m["square"]
        return finite_pairs * per
    if entry == "pairing_batch":
        return (finite_pairs * (miller_steps() + m["lines"] * m["fold"]) - m["fold"]
                + (m["squarings"] - 1) * m["square"])
    raise ValueError(f"no Miller count for entry {entry!r}")


def miller_bytes(pairs: int) -> int:
    """Affine P (2 Fq) and Q (4 Fq) in, f (12 Fq) out, a pair."""
    return pairs * 18 * SPEC["fq_bytes"]


def signed_digits(k: np.ndarray, c: int, nbits: int) -> np.ndarray:
    """Signed base-2^c digits of scalars given as 16-bit limbs [16, n]:
    W = ceil((nbits + 1) / c) rows, each in [-(2^(c-1) - 1), 2^(c-1)]."""
    nwin = (nbits + 1 + c - 1) // c
    bits = np.unpackbits(np.ascontiguousarray(k.T.astype("<u2")).view(np.uint8),
                         axis=1, bitorder="little")             # [n, 256]
    weights = (1 << np.arange(c, dtype=np.int64))
    half = 1 << (c - 1)
    out = np.empty((nwin, k.shape[1]), dtype=np.int64)
    carry = np.zeros(k.shape[1], dtype=np.int64)
    for w in range(nwin):
        chunk = bits[:, w * c:(w + 1) * c].astype(np.int64)
        d = chunk @ weights[:chunk.shape[1]] + carry
        over = d > half
        out[w] = np.where(over, d - (1 << c), d)
        carry = over.astype(np.int64)
    return out


def bucket_work(k: np.ndarray, c: int, lanes: int, nbits: int) -> tuple:
    """(mixed additions, general additions) that the bucket method needs for
    scalars k [16, n], point i in lane i mod lanes: into each bucket of each
    (window, lane), every point after its first is one mixed addition; the
    running sum over buckets m..1 costs one addition a bucket below the
    highest occupied one, into the running sum where that bucket is occupied
    and into the total at every step (additions with the identity are free)."""
    dg = np.abs(signed_digits(k, c, nbits))                      # [W, n]
    nwin, n = dg.shape
    m = 1 << (c - 1)
    lane = np.arange(n) % lanes
    key = (np.arange(nwin)[:, None] * lanes + lane[None, :]) * (m + 1) + dg
    occ = np.bincount(key.ravel(), minlength=nwin * lanes * (m + 1)).reshape(nwin * lanes, m + 1)
    nonzero = occ[:, 1:].sum()
    used = occ[:, 1:] > 0
    n_used = used.sum(1)
    top = np.where(used.any(1), m - np.argmax(used[:, ::-1], axis=1), 0)
    mixed = int(nonzero - n_used.sum())
    general = int(np.maximum(n_used - 1, 0).sum() + np.maximum(top - 1, 0).sum())
    return mixed, general


def accumulate_products(ncoords: int, mixed: int, general: int) -> int:
    g = SPEC["group"]
    return mixed * g["madd"][str(ncoords)] + general * g["add"][str(ncoords)]


def accumulate_bytes(ncoords: int, n: int, nwin: int, lanes: int) -> int:
    """Affine points (2 coordinates) and 32-byte scalars in; one Jacobian
    total (3 coordinates) a (window, lane) out."""
    fq = SPEC["fq_bytes"]
    return n * (2 * ncoords * fq + 32) + nwin * lanes * 3 * ncoords * fq
