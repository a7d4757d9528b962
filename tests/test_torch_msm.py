"""The port's Pippenger MSM (bn254_tpu_torch.msm, batch.msm_g1/msm_g2 and
the plain version of the msm_accumulate kernel, queue row 19) against the
JAX package's digit extraction, its jnp reference of the accumulate kernel
(tests/test_pallas_fused.py) and the spec oracle.  Digits are compared
exactly; group elements projectively, since the bucket sums may take
another Jacobian representative.  The card's split of row 19 (bucket
sort, per-bucket runs, reduce) is held against the port's own plain
version bit for bit."""

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
from bn254_tpu_torch import api as TA
from bn254_tpu_torch import batch as BA
from bn254_tpu_torch import convert, counts
from bn254_tpu_torch import fused as FU
from bn254_tpu_torch import groups as G
from bn254_tpu_torch import kernel_cases as KC
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


def test_msm_g1_on_cpu_equals_spec():
    """batch.msm_g1(..., device="cpu") end to end over the API's objects
    (G1 with G1.zero() for infinity, Fr) at the default window (c = 6:
    windows straddle limbs), with lanes=128 in place of 1024 to keep the
    CPU run short."""
    pts, ks = _msm_case(1)
    got = BA.msm_g1([TA.G1.zero() if p is None else TA.G1._wrap(p) for p in pts],
                    [TA.Fr(k) for k in ks], device="cpu", lanes=128)
    assert isinstance(got, TA.G1)
    assert SG.eq(got.p, _spec_sum(1, pts, ks), PARAMS[1][0])


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
    scratch, got = {}, {}
    real_sort, real_buckets = FU.msm_bucket_sort, FU._msm_buckets

    def record_sort(digits, nb, signed, lanes):
        out = real_sort(digits, nb, signed, lanes)
        scratch[len(scratch) + 1] = (*digits.shape, nb, lanes)
        got[len(scratch)] = out
        return out

    def record_buckets(ncoords, *args):
        out = real_buckets(ncoords, *args)
        got[ncoords] = (*got[ncoords], out)
        return out

    monkeypatch.setattr(FU, "msm_bucket_sort", record_sort)
    monkeypatch.setattr(FU, "_msm_buckets", record_buckets)
    counts.reset()
    for nc in (1, 2):
        K = G.G1 if nc == 1 else G.G2
        pts, ks = _msm_case(nc)
        M.msm(K, G.encode_points(K, pts, "cpu"), M.encode_scalars(ks, "cpu"), lanes=128)
    assert sorted(k for k, v in counts.launches.items() if v) == sorted(counts.MSM_PATH)
    assert not any(counts.plain_calls.values())
    for name in ("msm_bucket_sort", "msm_accumulate", "msm_bucket_reduce"):
        assert counts.launches[name] == 2
    for nc, (W, n, nb, lanes) in scratch.items():     # the kernels' scratch
        offsets, order, buckets = got[nc]
        assert offsets.dtype == torch.int32 and offsets.shape == (W, nb, lanes)
        assert order.dtype == torch.int32 and order.shape == (W, n // lanes, lanes)
        assert buckets.dtype == torch.int32 and buckets.shape == (W, nb - 1, 3 * nc, 16, lanes)
    # to_affine and Horner + lane fold: one call an MSM, no one-op field or
    # group-law launch
    assert counts.launches["to_affine"] == counts.launches["msm_combine"] == 2
    assert not any(counts.launches[k] for k in counts.TO_AFFINE_ONE_OPS + ("fq2_mul",))
    assert counts.launches["point_add"] == counts.launches["point_double"] == 0

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
    totals = torch.zeros((4, 3, 16, 128), dtype=torch.int32)
    assert FU.msm_combine(1, totals, 6).shape == (3, 16, 1)
    for args in ((1, totals[..., :100].contiguous(), 6),    # the fold needs 2^m lanes
                 (2, totals, 6),                            # G2 totals have 6 coordinates
                 (1, totals.long(), 6), (1, totals[0], 6), (1, totals, -1)):
        with pytest.raises(ValueError):
            FU.msm_combine(*args)
    with pytest.raises(ValueError):                         # the plain version too
        FU.msm_combine_plain(1, totals[..., :100].contiguous(), 6)
    k = torch.zeros((16, 256), dtype=torch.int32)
    assert FU.point_mul(1, pts[:1].expand(3, -1, -1).contiguous(), k, 254).shape == (3, 16, 256)
    for args in ((1, pts[:1].expand(3, -1, -1).contiguous(), k, 257),   # at most 256 bits
                 (1, pts[:1].expand(3, -1, -1).contiguous(), k[:, :128].contiguous(), 254),
                 (2, pts[:1].expand(3, -1, -1).contiguous(), k, 254)):
        with pytest.raises(ValueError):
            FU.point_mul(*args)
    # no limit of the kernels' own on the tiles a lane or the buckets (c = 10)
    offsets, order = real_sort(torch.zeros((1, 40000), dtype=torch.int32), 5, True, 1)
    assert order.dtype == torch.int32 and order.shape == (1, 40000, 1)
    offsets, order = real_sort(dg, 513, True, 128)
    assert offsets.shape == (3, 513, 128)
    assert real_buckets(1, FU.msm_point_words(pts), dg, offsets, order, 513, True,
                        128).shape == (3, 512, 3, 16, 128)
    with pytest.raises(ValueError):          # int64 digits
        real_sort(dg.long(), 5, True, 128)
    offsets, order = real_sort(dg, 5, True, 128)
    assert offsets.shape == (3, 5, 128) and order.shape == (3, 2, 128)
    words = FU.msm_point_words(pts)
    assert words.shape == (256, 2, 8) and words.dtype == torch.int32
    bad = ((words[:, :1].contiguous(), offsets, order),          # G1 words need 2 coordinates
           (words, offsets[:, :4].contiguous(), order),          # offsets [W, nb, lanes]
           (words, offsets, order.to(torch.int16)))              # the tile list is int32
    for args in bad:
        with pytest.raises(ValueError):
            real_buckets(1, args[0], dg, args[1], args[2], 5, True, 128)
    bk = real_buckets(1, words, dg, offsets, order, 5, True, 128)
    assert bk.shape == (3, 4, 3, 16, 128)
    assert FU.msm_bucket_reduce(1, bk).shape == (3, 3, 16, 128)
    with pytest.raises(ValueError):          # G2 buckets have 6 coordinates
        FU.msm_bucket_reduce(2, bk)
    with pytest.raises(ValueError):
        FU.msm_bucket_reduce(1, bk.long())


@pytest.mark.parametrize("kind", ["signed", "unsigned", "skew", "wide"])
def test_bucket_sort_plain_is_a_stable_sort(kind):
    """msm_bucket_sort_plain: each (window, lane)'s tiles with d != 0 in a
    numpy stable argsort's order by |d| (d if unsigned), -1 after them,
    and offsets[b] counting the tiles with 1 <= |d| <= b.  "wide": c = 10
    buckets and more tiles a lane than an int16 holds."""
    rng = np.random.default_rng(SEED)
    W, lanes, tiles, nb = (2, 2, 33000, 513) if kind == "wide" else (4, 24, 37, 17)
    signed = kind != "unsigned"
    lo = -(nb - 1) if signed else 0
    digits = rng.integers(lo, nb, size=(W, tiles * lanes)).astype(np.int32)
    if kind == "skew":                        # every lane of a window in one bucket
        digits[:] = rng.integers(1, nb, size=(W, 1)) * rng.choice([-1, 1], size=(W, 1))
        digits[0] = 0
    offsets, order = FU.msm_bucket_sort_plain(torch.from_numpy(digits), nb, signed, lanes)
    assert offsets.dtype == torch.int32 and offsets.shape == (W, nb, lanes)
    assert order.dtype == torch.int32 and order.shape == (W, tiles, lanes)
    key = digits.reshape(W, tiles, lanes)
    key = np.abs(key) if signed else key
    for w in range(W):
        for lane in range(lanes):
            k = key[w, :, lane]
            want = np.argsort(k, kind="stable")
            want = want[k[want] != 0]
            got = order[w, :, lane].numpy()
            assert np.array_equal(got[:len(want)], want) and (got[len(want):] == -1).all()
            assert offsets[w, :, lane].tolist() == [int(((k >= 1) & (k <= b)).sum())
                                                    for b in range(nb)]


def _runs_in_kernel_order(nc, points, digits, nb, signed, lanes):
    """The accumulate kernel's order in plain PyTorch: thread (w, b, lane)
    walks its run of the sorted tile list, all threads one step at a time,
    each adding its tile's point (y negated for d < 0) with the mixed add
    and the affine-double patch -> buckets [W, nb-1, 3c, 16, lanes]."""
    A = FU._coord(nc)
    W, n = digits.shape
    offsets, order = FU.msm_bucket_sort_plain(digits, nb, signed, lanes)
    start, length = offsets[:, :-1].long(), (offsets[:, 1:] - offsets[:, :-1]).long()
    pts = points.view(2, *([2] if nc == 2 else []), 16, n)
    acc = torch.zeros((3,) + tuple(pts.shape[1:-1]) + (W * (nb - 1) * lanes,),
                      dtype=torch.int32)
    lane = torch.arange(lanes).expand(W, nb - 1, lanes)
    for k in range(int(length.max())):
        sel = (k < length).flatten().nonzero()[:, 0]
        pos = (start + k).clamp(max=n // lanes - 1)
        idx = (order.long().gather(1, pos) * lanes + lane).flatten()[sel]
        d = digits.long().gather(1, (order.long().gather(1, pos) * lanes + lane)
                                 .view(W, -1).clamp(min=0)).flatten()[sel]
        qx, qy = pts[..., idx].unbind(0)
        if signed:
            qy = A.select(d < 0, FU._neg(qy), qy)
        new, coincide = FU._point_madd_generic(A, tuple(acc[..., sel].unbind(0)), qx, qy)
        if bool(coincide.any()):
            dbl = FU._affine_double(A, qx, qy)
            new = tuple(A.select(coincide, a, b) for a, b in zip(dbl, new))
        acc[..., sel] = torch.stack(new)
    return (acc.reshape(3 * nc, 16, W, nb - 1, lanes).permute(2, 3, 0, 1, 4).contiguous())


@pytest.mark.parametrize("skew", [False, True])
def test_sorted_runs_and_reduce_equal_accumulate_plain(skew):
    """Row 19 as the card splits it: the bucket sort, each (window, bucket,
    lane)'s run added up in the kernel's order, then the bucket reduce,
    all in plain PyTorch, equal msm_accumulate_plain bit for bit.  The
    kernel case's inputs (kernel_cases.msm_args: coincide and P + (-P)
    lanes) at n = 5000 on 1000 lanes, window 1 (a random window, or with
    skew one bucket and sign for every lane)."""
    nc, points, digits, nb, signed, lanes = KC.msm_args(np.random.default_rng(SEED), 1, 5000,
                                                        "cpu", skew)
    assert lanes == 1000
    digits = digits[1:2].contiguous()
    if skew:
        assert len(set(digits.flatten().tolist())) == 1
    runs = _runs_in_kernel_order(nc, points, digits, nb, signed, lanes)
    got = FU.msm_bucket_reduce_plain(nc, runs)
    assert torch.equal(got, FU.msm_accumulate_plain(nc, points, digits, nb, signed, lanes))


@pytest.mark.parametrize("label", [c.label for c in KC.CASES
                                   if c.name in ("msm_bucket_sort", "msm_bucket_reduce")])
def test_bucket_kernel_case_inputs(label):
    """chip_smoke.py's inputs for the bucket sort and the bucket reduce at
    a small size: the sort's digits fit its buckets (unsigned ones in
    [0, 2^c)), the reduce's buckets are msm_args' tile-order bucket sums
    (some empty), and the work count gives a positive bound."""
    case = next(c for c in KC.CASES if c.label == label)
    args = case.make_args(np.random.default_rng(1), 1000, "cpu")
    products, nbytes = case.work(*args)
    ms, by = KC.bound_ms(products, nbytes)
    assert nbytes > 0 and ms > 0
    c = M.MSM_FUSED_WINDOW[1]
    if case.name == "msm_bucket_sort":
        digits, nb, signed, lanes = args
        assert by == "bytes" and products == 0 and lanes == 200
        assert signed == (label != "msm_bucket_sort[unsigned]")
        assert nb == ((1 << (c - 1)) + 1 if signed else 1 << c)
        lo, hi = int(digits.min()), int(digits.max())
        assert (lo >= -(nb - 1) if signed else lo >= 0) and hi <= nb - 1
        return
    nc, buckets = args
    c = M.MSM_FUSED_WINDOW[nc]
    W = (255 + c - 1) // c
    assert by == "operations" and buckets.dtype == torch.int32
    assert buckets.shape == (W, 1 << (c - 1), 3 * nc, 16, 200)
    empty = (buckets[:, :, 2 * nc:] == 0).all(2).all(2)   # z = 0: [W, nb-1, lanes]
    assert bool(empty.any()) and not bool(empty.all())
