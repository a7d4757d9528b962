"""Batched entry points over host values — counterpart of the MSM part of
bn254_tpu/batch.py (``msm_g1`` / ``msm_g2``, batch.py:115-138).

They take the spec's Jacobian triples (or None for infinity) and int
scalars and return a spec Jacobian triple; the scalar-API objects of the
JAX package (``Fr``, ``G1``, ...) wait for the slice that ports the API
and its codecs.  They run on the card unless the caller passes
``device="cpu"``, where every kernel wrapper takes its plain version.
"""

from __future__ import annotations

from . import groups as G
from . import msm as M


def _msm(K, points, scalars, device):
    points, scalars = list(points), list(scalars)
    if not points or len(points) != len(scalars):
        raise ValueError(f"msm: want as many scalars as points, at least one; got "
                         f"{len(points)} points and {len(scalars)} scalars")
    out = M.msm(K, G.encode_points(K, points, device), M.encode_scalars(scalars, device))
    return G.decode_points(K, out)[0]


def msm_g1(points, scalars, device="cuda"):
    """sum_i scalars[i] * points[i] in G1 (Pippenger), as a spec triple."""
    return _msm(G.G1, points, scalars, device)


def msm_g2(points, scalars, device="cuda"):
    """sum_i scalars[i] * points[i] in G2 (Pippenger), as a spec triple."""
    return _msm(G.G2, points, scalars, device)
