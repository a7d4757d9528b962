"""The port's Pippenger MSM (bn254_tpu_torch.msm, batch.msm_g1/msm_g2 and
the plain version of the msm_accumulate kernel, queue row 19) against the
JAX package's digit extraction, its jnp reference of the accumulate kernel
(tests/test_pallas_fused.py) and the spec oracle.  Digits are compared
exactly; group elements projectively, since the bucket sums may take
another Jacobian representative."""

import random

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bn254_tpu import groups as JG
from bn254_tpu import limbs as JL
from bn254_tpu import msm as JM
from bn254_tpu import pallas_fused as PF
from bn254_tpu.spec import group as SG
from bn254_tpu.spec.constants import R
from bn254_tpu_torch import batch as BA
from bn254_tpu_torch import convert, counts
from bn254_tpu_torch import fused as FU
from bn254_tpu_torch import groups as G
from bn254_tpu_torch import msm as M
from test_pallas_fused import _msm_accumulate_jnp

torch.set_num_threads(1)

SEED = 0x3511
PARAMS = {1: SG.G1_PARAMS, 2: SG.G2_PARAMS}


def _mul(k, nc):
    ops, gen = PARAMS[nc][:2]
    return SG.scalar_mul((gen[0], gen[1], ops.one), k, ops)


def _scalars(rng, n):
    ks = [rng.randrange(R) for _ in range(n)]
    ks[:4] = [0, 1, R - 1, (1 << 253) + 5]
    return ks


@pytest.mark.parametrize("c", [4, 5, 6])
def test_signed_digits_vs_jax(c):
    """_signed_digits(_digits_any_c(...)) equals the JAX package's for the
    window widths the MSM uses (c = 5 and 6 straddle limbs); _all_digits
    too where c divides the limb width."""
    ks = _scalars(random.Random(SEED + c), 64)
    limbs = JL.stack_ints(ks)
    port = M.encode_scalars(ks, "cpu")
    W = (254 + 1 + c - 1) // c
    got = M._signed_digits(M._digits_any_c(port, c, W), c)
    want = JM._signed_digits(JM._digits_any_c(jnp.asarray(limbs), c, W), c)
    assert got.dtype == torch.int32
    assert np.array_equal(got.numpy(), np.asarray(want))
    if 16 % c == 0:
        assert np.array_equal(M._all_digits(port, c, W).numpy(),
                              np.asarray(JM._all_digits(jnp.asarray(limbs), c, W)))
    half = 1 << (c - 1)
    assert int(got.min()) >= -(half - 1) and int(got.max()) <= half
    for j, k in enumerate(ks):      # the digits recompose the scalar
        assert sum(int(d) << (c * w) for w, d in enumerate(got[:, j])) == k


@pytest.mark.parametrize("signed", [True, False])
def test_msm_accumulate_vs_jnp_reference(monkeypatch, signed):
    """Row 19's plain version: every window total of every lane equals the
    JAX jnp reference of pallas_fused.msm_accumulate projectively (G1,
    lanes = 128, two point tiles, W = 2).  Lanes 0-3 of tile 1 repeat tile
    0's point and digits (the coincide patch), lanes 4-7 hold its negation
    (P + (-P)); a tenth of the digits are 0."""
    monkeypatch.setattr(PF, "_TILE_S", 1)            # the reference's 128 lanes
    lanes, n, W, c = 128, 256, 2, 3
    nb = (1 << (c - 1)) + 1 if signed else 1 << c
    rng = np.random.default_rng(SEED)
    ops = PARAMS[1][0]
    pts = [SG.to_affine(_mul(3 + i, 1), ops) for i in range(n)]
    for j in range(8):
        x, y = pts[j]
        pts[lanes + j] = (x, y) if j < 4 else (x, ops.neg(y))
    lo = -(nb - 1) if signed else 0
    digits = rng.integers(lo, nb, size=(W, n)).astype(np.int32)
    digits[rng.random((W, n)) < 0.1] = 0
    digits[:, lanes:lanes + 8] = digits[:, :8]
    packed_np = np.stack([JG.G1.encode([p[i] for p in pts]) for i in range(2)])
    want = np.asarray(_msm_accumulate_jnp(1, jnp.asarray(packed_np), jnp.asarray(digits),
                                          nb, signed=signed))
    got = FU.msm_accumulate_plain(1, torch.from_numpy(packed_np.astype(np.int32)),
                                  torch.from_numpy(digits), nb, signed, lanes)
    assert got.shape == want.shape == (W, 3, 16, lanes)
    for w in range(W):
        g = G.decode_points(G.G1, convert.unpack_point(1, got[w]))
        e = G.decode_points(G.G1, convert.unpack_point(1, torch.from_numpy(
            want[w].astype(np.int32))))
        for lane, (a, b) in enumerate(zip(g, e)):
            assert SG.eq(a, b, ops), (w, lane)


def _msm_case(nc, n=200):
    """n points (ragged against 128 lanes): random multiples, an infinity
    input, zero scalars, r - 1 and a duplicate point in the same lane of
    the next tile."""
    rng = random.Random(SEED + nc)
    pts = [_mul(rng.randrange(1, R), nc) for _ in range(n)]
    ks = _scalars(rng, n)
    pts[5] = None
    pts[128 + 6] = pts[6]
    ks[128 + 6] = ks[6]
    ks[9] = R - 1
    return pts, ks


def _spec_sum(nc, pts, ks):
    ops = PARAMS[nc][0]
    want = SG.zero(ops)
    for p, k in zip(pts, ks):
        if p is not None:
            want = SG.add(want, SG.scalar_mul(p, k, ops), ops)
    return want


def test_msm_g1_on_cpu_equals_spec(monkeypatch):
    """batch.msm_g1(..., device="cpu") end to end at the default window
    (c = 6: windows straddle limbs), with 128 lanes in place of 1024 to
    keep the CPU run short."""
    monkeypatch.setattr(M, "LANES", 128)
    pts, ks = _msm_case(1)
    got = BA.msm_g1(pts, ks, device="cpu")
    assert SG.eq(got, _spec_sum(1, pts, ks), PARAMS[1][0])


def test_msm_g2_on_cpu_equals_spec():
    pts, ks = _msm_case(2)
    K = G.G2
    out = M.msm(K, G.encode_points(K, pts, "cpu"), M.encode_scalars(ks, "cpu"), c=2, lanes=128)
    assert SG.eq(G.decode_points(K, out)[0], _spec_sum(2, pts, ks), PARAMS[2][0])


def test_msm_path_reaches_every_kernel_with_valid_arguments(monkeypatch):
    """The MSM path with the wrappers taking their kernel branch on CPU
    tensors and the launch stubbed out: every wrapper's argument checks
    pass, each kernel of the path is reached, no plain version runs (what
    chip_smoke.py asserts on the card); bad arguments raise."""
    def launch(name, batch, *args):
        counts.launches[name] += 1

    from bn254_tpu_torch import mont_kernels as MK
    for mod in (MK, FU):
        monkeypatch.setattr(mod, "on_cuda", lambda t: True)
        monkeypatch.setattr(mod, "launch", launch)
    counts.reset()
    for nc in (1, 2):
        K = G.G1 if nc == 1 else G.G2
        pts, ks = _msm_case(nc)
        M.msm(K, G.encode_points(K, pts, "cpu"), M.encode_scalars(ks, "cpu"), lanes=128)
    assert sorted(k for k, v in counts.launches.items() if v) == sorted(counts.MSM_PATH)
    assert not any(counts.plain_calls.values())
    assert counts.launches["msm_accumulate"] == 2
    c1, c2 = M.MSM_FUSED_WINDOW[1], M.MSM_FUSED_WINDOW[2]
    w1, w2 = (255 + c1 - 1) // c1, (255 + c2 - 1) // c2
    assert counts.launches["point_double"] == (w1 - 1) * c1 + (w2 - 1) * c2
    assert counts.launches["point_add"] == (w1 - 1) + (w2 - 1) + 2 * 7

    pts = torch.zeros((2, 16, 256), dtype=torch.int32)
    dg = torch.zeros((3, 256), dtype=torch.int32)
    with pytest.raises(ValueError):          # lanes must divide n
        FU.msm_accumulate(1, pts, dg, 5, lanes=100)
    with pytest.raises(ValueError):          # a digit past the buckets
        FU.msm_accumulate(1, pts, dg + 5, 5, lanes=128)
    with pytest.raises(ValueError):          # G2 points need 4 coordinates
        FU.msm_accumulate(2, pts, dg, 5, lanes=128)
    with pytest.raises(ValueError):
        FU.point_add(1, pts[:, :, ::2], pts[:, :, ::2])
    with pytest.raises(ValueError):
        FU.point_double(3, pts)
