"""The port's affine conversion (bn254_tpu_torch.groups.to_affine, the
to_affine kernel's wrapper and its plain version, which serve queue rows
1-5) on the CPU: the block-wise shared inversion against the spec oracle
and the port's per-lane Fermat route, with points at infinity on a
block's first and last lane, a block of them and a short last block; the
wrapper's arguments with the launch stubbed; the kernel case's planted
lanes.  Comparisons are exact.  The JAX package's to_affine is held
against the block route in tests/test_torch_pairing.py."""

import random

import numpy as np
import pytest
import torch

from bn254_tpu.spec import group as SG
from bn254_tpu.spec.constants import Q, R
from bn254_tpu_torch import _build, counts
from bn254_tpu_torch import fused as FU
from bn254_tpu_torch import groups as G
from bn254_tpu_torch import kernel_cases as KC
from bn254_tpu_torch.convert import pack, unpack_point

torch.set_num_threads(1)

SEED = 0xAF1
GROUPS = {"g1": (G.G1, SG.G1_PARAMS), "g2": (G.G2, SG.G2_PARAMS)}
INF_LANES = (0, 1, 2, 3, 4, 7, 10)     # at block 4: all of block 0, block 1's ends, lane B - 1


def _points(group):
    """11 spec Jacobian points: k G with z scaled by a random lambda, and
    INF_LANES at infinity; for G2, z = (0, z1) on lane 5 and (z0, 0) on
    lane 6 (finite lanes with one coordinate of z zero)."""
    K, params = GROUPS[group]
    ops, gen = params[:2]
    rng = random.Random(SEED + K.COORDS)
    pts = []
    for i in range(11):
        p = SG.to_affine(SG.scalar_mul((gen[0], gen[1], ops.one), rng.randrange(1, R), ops),
                         ops)
        if K is G.G1:
            lam = rng.randrange(1, Q)
        else:
            lam = {5: (0, rng.randrange(1, Q)), 6: (rng.randrange(1, Q), 0)}.get(
                i, (rng.randrange(Q), rng.randrange(1, Q)))
        l2 = ops.sqr(lam)
        pts.append(SG.zero(ops) if i in INF_LANES else
                   (ops.mul(p[0], l2), ops.mul(p[1], ops.mul(l2, lam)), lam))
    return K, ops, pts


def _per_lane(K, p):
    """The port's per-lane route: one Fermat inversion of z a lane (0 -> 0)."""
    zinv = K.inv(p[2])
    zi2 = K.sqr(zinv)
    return pack((K.mul(p[0], zi2), K.mul(p[1], K.mul(zi2, zinv))))


@pytest.mark.parametrize("block", [4, 1, 16])
@pytest.mark.parametrize("group", ["g1", "g2"])
def test_block_plain_equals_spec_and_per_lane_route(group, block):
    """At block 4 the 11 lanes are blocks [0, 4), [4, 8) and the short
    [8, 11): the first all at infinity, the second with infinity at both
    ends, the last ending on one; block 1 inverts every lane on its own,
    block 16 all in one short block."""
    K, ops, pts = _points(group)
    p = G.encode_points(K, pts, "cpu")
    xy, inf = FU.to_affine_plain(K.COORDS, pack(p), block)
    assert xy.shape == (2 * K.COORDS, 16, 11) and xy.dtype == torch.int32
    assert torch.equal(xy, _per_lane(K, p))
    assert inf.tolist() == [i in INF_LANES for i in range(11)]
    x, y = (xy[0], xy[1]) if K is G.G1 else ((xy[0], xy[1]), (xy[2], xy[3]))
    zero = 0 if K is G.G1 else (0, 0)
    for lane, (xv, yv, pt) in enumerate(zip(K.decode(x), K.decode(y), pts)):
        assert (xv, yv) == (SG.to_affine(pt, ops) or (zero, zero)), lane


@pytest.mark.parametrize("group", ["g1", "g2"])
def test_groups_to_affine_runs_the_plain_version_on_the_cpu(group):
    """groups.to_affine on CPU tensors: one plain to_affine call at the
    kernel's block (no one-op field route, no launch), the same limbs."""
    K, _, pts = _points(group)
    p = G.encode_points(K, pts, "cpu")
    counts.reset()
    (x, y), inf = G.to_affine(K, p)
    assert counts.plain_calls["to_affine"] == 1
    assert not any(counts.launches.values())
    assert torch.equal(pack((x, y)), FU.to_affine_plain(K.COORDS, pack(p))[0])
    assert torch.equal(inf, G.is_zero_point(K, p))


@pytest.mark.parametrize("group", ["g1", "g2"])
def test_to_affine_wrapper_arguments(monkeypatch, group):
    """The kernel branch on CPU tensors with the launch stubbed: one
    to_affine launch with its C entry's arguments and the Fermat chain's
    digits of q - 2; outputs [2c, 16, B] int32 and [B] bool; bad shapes
    and ncoords raise."""
    K, _, pts = _points(group)
    nc = K.COORDS
    p = pack(G.encode_points(K, pts, "cpu"))
    calls = []

    def launch(name, batch, *args):
        assert len(args) == len(_build._SIGS[name])
        calls.append((name, batch, args[0], args[2]))

    monkeypatch.setattr(FU, "on_cuda", lambda t: True)
    monkeypatch.setattr(FU, "launch", launch)
    xy, inf = FU.to_affine(nc, p)
    assert calls == [("to_affine", 11, nc, len(FU.pow_digits(Q - 2)))]
    assert xy.shape == (2 * nc, 16, 11) and xy.dtype == torch.int32
    assert inf.shape == (11,) and inf.dtype == torch.bool
    with pytest.raises(ValueError):
        FU.to_affine(3 - nc, p)                 # the other group's coordinates
    with pytest.raises(ValueError):
        FU.to_affine(nc, p[:, :, ::2])          # not contiguous
    with pytest.raises(ValueError):
        FU.to_affine(3, torch.zeros((9, 16, 11), dtype=torch.int32))


@pytest.mark.parametrize("nc", [1, 2])
def test_kernel_case_plants_infinity_at_block_ends(nc):
    """chip_smoke.py's inputs: z = 0 on the first and last lane of every
    128 and on lane B - 1, a whole span of AFFINE_ZERO_SPAN lanes at
    infinity from two spans on, G2's one-coordinate z finite, B = 1 finite; the
    plain version equals the per-lane route on them, and the work and
    depth give a positive bound."""
    L = KC.AFFINE_ZERO_SPAN
    for batch in (2 * L + 5, 300, 1):
        _, p = KC.to_affine_args(np.random.default_rng(5), nc, batch, "cpu")
        inf = (p[2 * nc:] == 0).flatten(0, 1).all(0)
        lane = torch.arange(batch)
        ends = ((lane % 128 == 0) | (lane % 128 == 127) | (lane == batch - 1)) & (batch > 1)
        block = (lane >= L) & (lane < 2 * L) & (batch >= 2 * L)
        assert torch.equal(inf, ends | block)
        if nc == 2 and batch > 4:
            assert bool((p[4, :, 3] == 0).all()) and bool((p[5, :, 4] == 0).all())
            assert not bool(inf[3]) and not bool(inf[4])
        products, nbytes = KC.to_affine_work(nc, p)
        assert products > 0 and nbytes == batch * (5 * nc * 64 + 1)
    _, p = KC.to_affine_args(np.random.default_rng(6), nc, 300, "cpu")
    K = G.G1 if nc == 1 else G.G2
    assert torch.equal(FU.to_affine_plain(nc, p)[0], _per_lane(K, unpack_point(nc, p)))
    assert KC.to_affine_depth(nc, p) > KC.pow_chain_work(Q - 2)


@pytest.mark.parametrize("rc", [0, 2])
def test_to_affine_geometry_reads_the_c_entry(monkeypatch, rc):
    """fused.to_affine_geometry with the library stubbed: (K, threads) as
    the C entry writes them, or a RuntimeError naming the entry's error;
    the serial depth off the card takes one lane a thread and the plain
    version's block."""
    class Lib:
        def bn254_to_affine_geometry(self, ncoords, batch, lanes, threads):
            assert (ncoords, batch) == (2, 1 << 20)
            lanes._obj.value, threads._obj.value = 16, 128
            return rc

        def bn254_error_string(self, code):
            return b"out of memory"

    monkeypatch.setattr(_build, "library", lambda: Lib())
    if rc:
        with pytest.raises(RuntimeError, match="out of memory"):
            FU.to_affine_geometry(2, 1 << 20)
    else:
        assert FU.to_affine_geometry(2, 1 << 20) == (16, 128)
    _, p = KC.to_affine_args(np.random.default_rng(7), 1, 64, "cpu")
    warps = FU.AFFINE_PLAIN_BLOCK // 32
    assert KC.to_affine_depth(1, p) == (3 + KC._AFFINE_COORDS[1] + 2 * 5
                                        + 2 * (warps.bit_length() - 1)
                                        + KC.pow_chain_work(Q - 2) + 4)
