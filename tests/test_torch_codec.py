"""The port's batched point decompression (bn254_tpu_torch.codec_device)
and the square roots under it (FQ.sqrt, tower.fq2_sqrt), on the CPU,
against the JAX package's codec_device, fields and tower on the same
inputs, and against the host codec (spec/codec.py).  Exact: limbs and
masks must be equal."""

import random

import jax
import numpy as np
import pytest
import torch

from bn254_tpu import codec_device as JCD
from bn254_tpu import tower as JT
from bn254_tpu.fields import FQ as JFQ
from bn254_tpu.errors import BNError
from bn254_tpu.spec import codec as SC
from bn254_tpu.spec import field as SF
from bn254_tpu.spec import group as SG
from bn254_tpu.spec.constants import B2, Q
from bn254_tpu_torch import codec_device as CD
from bn254_tpu_torch import convert, counts
from bn254_tpu_torch import fused as FU
from bn254_tpu_torch import groups as G
from bn254_tpu_torch import mont_kernels as MK
from bn254_tpu_torch import tower as T
from bn254_tpu_torch.fields import FQ
from test_codec_device import _rand_g1_blobs
import golden

torch.set_num_threads(1)

SEED = 0xC0DE5


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _same(port_tree, jax_tree):
    got = convert.tree_leaves(convert.to_numpy(port_tree))
    want = jax.tree.leaves(_np(jax_tree))
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert np.array_equal(g, w)


def test_fq_sqrt_vs_jax():
    """Roots and masks on residues, non-residues (-x^2, since q = 3 mod 4)
    and 0; on residues the root squares back."""
    rng = random.Random(SEED)
    xs = [rng.randrange(1, Q) for _ in range(5)]
    vals = [x * x % Q for x in xs] + [(-x * x) % Q for x in xs] + [0, 1, Q - 1]
    a = JFQ.encode(vals)
    root, ok = FQ.sqrt(torch.from_numpy(a.astype(np.int32)))
    jroot, jok = JFQ.sqrt(a)
    _same(root, jroot)
    assert ok.tolist() == np.asarray(jok).tolist() == [True] * 5 + [False] * 5 + [True, True, False]
    for r, v, o in zip(FQ.decode(root), vals, ok.tolist()):
        assert not o or r * r % Q == v


def _twist_points(rng, n, subgroup):
    """n affine points on the twist: in the subgroup (multiples of the
    generator) or not (a random x whose x^3 + b2 is a square)."""
    ops, gen = SG.G2_PARAMS[0], SG.G2_PARAMS[1]
    out = []
    while len(out) < n:
        if subgroup:
            out.append(SG.to_affine(SG.scalar_mul((gen[0], gen[1], ops.one),
                                                  rng.randrange(1, 1 << 60), ops), ops))
            continue
        x = (rng.randrange(Q), rng.randrange(Q))
        y = SF.fq2_sqrt(SF.fq2_add(SF.fq2_mul(SF.fq2_sqr(x), x), B2))
        if y is not None:
            out.append((x, y))
    return out


def test_fq2_sqrt_vs_jax_with_both_branches():
    """Roots and masks on residues, non-residues, 0, and inputs in Fq that
    are non-residues there ((q - 1, 0), (n, 0)): for those alpha = -1, the
    rare branch A (i * a1 a)."""
    rng = random.Random(SEED + 1)
    sq = [SF.fq2_sqr((rng.randrange(Q), rng.randrange(Q))) for _ in range(3)]
    nonres = []
    while len(nonres) < 3:
        v = (rng.randrange(Q), rng.randrange(Q))
        if SF.fq2_sqrt(v) is None:
            nonres.append(v)
    n = next(x for x in range(2, 100) if SF.fq_sqrt(x) is None)
    branch_a = [(Q - 1, 0), (n, 0)]
    vals = sq + nonres + [(0, 0), (1, 0)] + branch_a
    a = JT.fq2_encode(vals)
    port_a = convert.from_numpy(a, "cpu")
    root, ok = T.fq2_sqrt(port_a)
    jroot, jok = JT.fq2_sqrt(a)
    _same(root, jroot)
    assert ok.tolist() == np.asarray(jok).tolist() == [True] * 3 + [False] * 3 + [True] * 4
    packed = convert.pack(port_a)
    a1 = FU._fq2_pow(packed, (Q - 3) // 4)
    alpha = MK._fq2_mul(a1, MK._fq2_mul(a1, packed))
    assert T.fq2_decode(tuple(alpha))[-2:] == [(Q - 1, 0)] * 2
    for r, v in zip(T.fq2_decode(root), vals):
        assert v in nonres or SF.fq2_sqr(r) == v


def test_fq2_sqrt_plain_vs_spec_on_planted_lanes():
    """fused.fq2_sqrt_plain, the kernel's plain version, on its kernel case's
    inputs at B = 16 (0, (1, 1), (q - 1, q - 1); (q - 1, 0) and (n, 0),
    where alpha = -1 takes branch A; a non-residue; x^3 + b2 of real G2
    points; random elements and random squares) against the spec's
    fq2_sqrt lane by lane: ok exactly where the spec finds a root, and the
    spec's root there."""
    from bn254_tpu_torch import kernel_cases as KC
    (a,) = KC.fq2_sqrt_args(np.random.default_rng(SEED + 3), 16, "cpu")
    root, ok = FU.fq2_sqrt_plain(a)
    vals = T.fq2_decode(tuple(a))
    roots = T.fq2_decode(tuple(root))
    for lane, (v, r, o) in enumerate(zip(vals, roots, ok.tolist())):
        want = SF.fq2_sqrt(v)
        assert o == (want is not None), lane
        assert want is None or r == want, lane
    assert vals[0] == (0, 0) and roots[0] == (0, 0) and ok[0]
    assert not ok[5] and all(ok[6:14].tolist())
    a1 = FU._fq2_pow(a[..., 3:5], (Q - 3) // 4)
    alpha = MK._fq2_mul(a1, MK._fq2_mul(a1, a[..., 3:5]))
    assert T.fq2_decode(tuple(alpha)) == [(Q - 1, 0)] * 2


def _g1_blobs():
    """tests/test_codec_device.py's G1 blobs, plus x = 2^256 - 1 and two
    wrong lengths."""
    blobs = _rand_g1_blobs(random.Random(0xC0DEC), 12)
    blobs.append(bytes.fromhex(golden.G1_COMPRESSED_HEX))
    blobs.append(bytes([0x05]) + blobs[0][1:])
    blobs.append(bytes([0x02]) + b"\x00" * 32)
    blobs.append(bytes([0x02]) + Q.to_bytes(32, "big"))
    blobs += [bytes([0x03]) + b"\xff" * 32, blobs[1][:32], blobs[2] + b"\x00"]
    return blobs


def _g2_blobs():
    """tests/test_codec_device.py's G2 blobs, plus a twist point outside
    the subgroup, x = 0, an Fq2 quotient >= q and a wrong length."""
    blobs = [SC.g2_to_compressed(p) for p in _twist_points(random.Random(0xC0DE2), 6, True)]
    blobs += [bytes.fromhex(h) for h in (golden.G2_COMPRESSED_HEX,
                                         golden.G2_COMPRESSED_HEX_REFLECT,
                                         golden.G2_COMPRESSED_HEX_BADPREFIX)]
    blobs += [SC.g2_to_compressed(p) for p in _twist_points(random.Random(SEED + 2), 1, False)]
    blobs += [bytes([0x0A]) + b"\x00" * 64, bytes([0x0B]) + (Q * Q).to_bytes(64, "big"),
              blobs[0][:64]]
    return blobs


def _host(fn, b):
    try:
        return fn(b)
    except BNError:
        return None


@pytest.mark.parametrize("group", ["g1", "g2"])
def test_from_compressed_batch_vs_jax_and_host(group):
    """g1/g2_from_compressed_batch(device="cpu") against the JAX package's
    entries on the same blobs: point limbs and masks bit for bit; and the
    mask and points against the host codec."""
    if group == "g1":
        blobs, K = _g1_blobs(), G.G1
        pts, ok = CD.g1_from_compressed_batch(blobs, device="cpu")
        jpts, jok = JCD.g1_from_compressed_batch(blobs)
        host, one = SC.g1_from_compressed, 1
    else:
        blobs, K = _g2_blobs(), G.G2
        pts, ok = CD.g2_from_compressed_batch(blobs, device="cpu")
        jpts, jok = JCD.g2_from_compressed_batch(blobs)
        host, one = SC.g2_from_compressed, (1, 0)
    _same(pts, jpts)
    assert ok.tolist() == np.asarray(jok).tolist()
    for i, (b, p, o) in enumerate(zip(blobs, G.decode_points(K, pts), ok.tolist())):
        want = _host(host, b)
        assert o == (want is not None), i
        assert want is None or p == (*want, one), i
    assert not all(ok.tolist()) and any(ok.tolist())


def test_parsers_vs_jax():
    """Host parsers on wrong lengths, x >= q and quotient >= q: prefixes,
    field limbs and host masks equal the JAX package's."""
    g1 = [bytes([0x02]) + Q.to_bytes(32, "big"), bytes([0x03]) + b"\xff" * 32,
          bytes([0x02]) * 32, bytes([0x02]) * 34, bytes([0x03]) + (Q - 1).to_bytes(32, "big")]
    g2 = [bytes([0x0A]) + (Q * Q).to_bytes(64, "big"), bytes([0x0B]) + b"\xff" * 64,
          bytes([0x0A]) * 64, bytes([0x0A]) * 66, bytes([0x0B]) + (Q * Q - 1).to_bytes(64, "big")]
    for parse, jparse, blobs in ((CD.parse_g1_compressed, JCD.parse_g1_compressed, g1),
                                 (CD.parse_g2_compressed, JCD.parse_g2_compressed, g2)):
        pre, xs, okh = parse(blobs, "cpu")
        jpre, jxs, jokh = jparse(blobs)
        assert pre.tolist() == np.asarray(jpre).tolist()
        _same(xs, jxs)
        assert okh.tolist() == np.asarray(jokh).tolist() == [False] * 4 + [True]


def test_codec_path_reaches_every_kernel_with_valid_arguments(monkeypatch):
    """Both entries with the wrappers taking their kernel branch on CPU
    tensors and the launch stubbed out: every wrapper's checks pass, the
    path reaches each kernel of CODEC_PATH, and no plain version runs."""
    calls = {}

    def launch(name, batch, *args):
        counts.launches[name] += 1
        calls[name] = (batch, args)

    for mod in (MK, FU):
        monkeypatch.setattr(mod, "on_cuda", lambda t: True)
        monkeypatch.setattr(mod, "launch", launch)
    counts.reset()
    CD.g1_from_compressed_batch(_g1_blobs()[:3], device="cpu")
    CD.g2_from_compressed_batch(_g2_blobs()[:3], device="cpu")
    assert sorted(k for k, v in counts.launches.items() if v) == sorted(counts.CODEC_PATH)
    assert not any(counts.plain_calls.values())
    assert counts.launches["fq_pow"] == 1
    assert counts.launches["point_mul"] == 1               # the G2 subgroup check
    # the G2 square root: one launch, no per-bit loop over the one-op Fq2 kernels
    # (g2_rhs's x^2 and x^2 x are their only launches)
    assert counts.launches["fq2_sqrt"] == 1
    assert counts.launches["fq2_sqr"] == counts.launches["fq2_mul"] == 1
    batch, (_, n_a1, _, n_b, *ptrs) = calls["fq2_sqrt"]
    assert batch == 3 and len(ptrs) == 3 and all(ptrs)
    assert (n_a1, n_b) == (len(FU.pow_digits((Q - 3) // 4)), len(FU.pow_digits((Q - 1) // 2)))
