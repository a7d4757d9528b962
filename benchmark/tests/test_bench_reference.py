"""The plain reference against the port on the CPU at tiny sizes: every tiny
cell's run compares the port's plain versions with the reference and must
come out correct; the reference's pairing and the input generator also
against the port's own spec."""

import random

import numpy as np
import pytest
import torch

import bench_tiny
from benchlib import inputs as I
from bnref import bn254 as B
from bnref import check as C


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    return bench_tiny.make_root(tmp_path_factory.mktemp("bench"))


@pytest.mark.parametrize("cell", list(bench_tiny.CELLS))
def test_a_tiny_run_of_the_port_is_correct(root, cell, monkeypatch):
    r = bench_tiny.run(root, cell, monkeypatch=monkeypatch)
    assert r["correct"], r["check"]
    assert r["attempted"] >= 1 and r["failed"] == 0
    assert all(v["value"] == 0 == v["limit"] for v in r["check"].values())
    assert set(r["metrics"]) >= {"call_p95_ms", "setup_s"}


def test_reference_pairing_equals_the_ports_spec():
    from bn254_tpu_torch.spec import group as SG
    rng = random.Random(5)
    (o1, g1), (o2, g2) = SG.G1_PARAMS[:2], SG.G2_PARAMS[:2]
    for _ in range(2):
        p = SG.scalar_mul((*g1, o1.one), rng.randrange(1, B.R), o1)
        q = SG.scalar_mul((*g2, o2.one), rng.randrange(1, B.R), o2)
        assert B.pairing(p, q) == SG.pairing(p, q)


def test_fixed_base_powers_follow_bilinearity():
    g = C.gt_generator()
    fb = C.FixedBase(C.Tower(C.CANON), g)
    a, c = 2**200 + 12345, 3**100
    p = B.scalar_mul((1, 2, 1), a, B.FqOps)
    q = B.scalar_mul((B.G2_ONE[0], B.G2_ONE[1], B.FQ2_ONE), c, B.Fq2Ops)
    assert B.pairing(p, q) == fb.pow(a * c)
    assert fb.pow(0) == C.Tower(C.CANON).f12_enc(B.FQ12_ONE)


@pytest.mark.parametrize("ncoords,host", [(1, 2048), (1, 3), (2, 5)])
def test_generated_points_are_their_logs_times_the_generator(ncoords, host):
    from bn254_tpu_torch import groups as G
    from bn254_tpu_torch.spec import group as SG
    tab = I.point_table(ncoords, 33, np.random.default_rng(9), "cpu", n_infinity=2, host=host)
    pts = I.batch_points(tab, 0, 33)
    K = G.G1 if ncoords == 1 else G.G2
    ops, gen = (SG.G1_PARAMS if ncoords == 1 else SG.G2_PARAMS)[:2]
    got = G.decode_points(K, pts)                       # the port's own decoder
    for i in range(33):
        want = SG.scalar_mul((*gen, ops.one), tab.log(i), ops)
        assert SG.eq(got[i], want, ops), i
        assert (got[i][2] == ops.zero) == (i in tab.infinity)
        assert i in tab.infinity or got[i][2] != ops.one        # z != 1


def test_decode_refuses_residues_that_are_not_fully_reduced():
    assert C.decode(C.Q - 1) is not None
    assert C.decode(C.Q) is None and C.decode(C.Q + 5) is None
    m = 7 * C.MONT % C.Q
    assert C.decode(m) == 7


def test_lazy_arithmetic_is_right_modulo_q_and_not_fully_reduced():
    rng = random.Random(3)
    lz, high = C.LAZY, 0
    for _ in range(200):
        a, b = rng.randrange(2 * C.Q), rng.randrange(2 * C.Q)
        for got, want in ((lz.mul(a, b), a * b * C.MONT_INV), (lz.add(a, b), a + b),
                          (lz.sub(a, b), a - b)):
            assert 0 <= got < 2 * C.Q and got % C.Q == want % C.Q
            high += got >= C.Q
    assert high > 50
    limbs = torch.tensor([[1], [2]] + [[0]] * 14, dtype=torch.int32)
    assert C.limbs_to_ints(limbs.numpy()) == [1 + (2 << 16)]
