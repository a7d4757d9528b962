"""The port's sharded pairing and MSM (bn254_tpu_torch.parallel) on
spawned gloo ranks on the CPU: entry.dryrun_multichip(2); a 2-rank run
with ragged shards (rank 0 one pair, at infinity; rank 1 two pairs)
against bn254_tpu.api.pairing_batch on all three pairs; the sharded G1
MSM with a rank that has no points, against the JAX package's spec,
projectively; and the raise where no process group exists."""

import random

import pytest
import torch

import bn254_tpu.api as JA
from bn254_tpu.spec import group as JSG
from bn254_tpu.spec.constants import R
from bn254_tpu_torch import entry as E
from bn254_tpu_torch import groups as G
from bn254_tpu_torch import msm as M
from bn254_tpu_torch import parallel as PAR

torch.set_num_threads(1)

SEED = 0x5A4D
OPS1, OPS2 = JSG.G1_PARAMS[0], JSG.G2_PARAMS[0]


def _mul(params, k):
    ops, gen = params[:2]
    return JSG.scalar_mul((gen[0], gen[1], ops.one), k, ops)


def test_dryrun_multichip_two_ranks():
    """Two spawned ranks, 2 pairs and 4 points each: every rank's sharded
    pairing and MSM equal the spec (dryrun_multichip asserts it), and the
    ranks hold the same values."""
    results = E.dryrun_multichip(2, device="cpu")
    assert len(results) == 2 and all(len(r) == 2 for r in results)
    assert results[0][0]["value"] == results[1][0]["value"]
    assert results[0][1]["value"] == results[1][1]["value"]


@pytest.fixture(scope="module")
def ragged():
    """One 2-rank run of both jobs: the pairs (P0 at infinity | P1, P2)
    and the MSM's points (three, one at infinity, with the scalars 0,
    r - 1 and a random one | none)."""
    rng = random.Random(SEED)
    ps = [JSG.zero(OPS1)] + [_mul(JSG.G1_PARAMS, rng.randrange(1, R)) for _ in range(2)]
    qs = [_mul(JSG.G2_PARAMS, rng.randrange(1, R)) for _ in range(3)]
    pts = [_mul(JSG.G1_PARAMS, rng.randrange(1, R)), JSG.zero(OPS1),
           _mul(JSG.G1_PARAMS, rng.randrange(1, R))]
    ks = [R - 1, rng.randrange(R), 0]
    jobs = [[E.pairing_job(ps[:1], qs[:1]), E.msm_job(G.G1, pts, ks, lanes=4)],
            [E.pairing_job(ps[1:], qs[1:]), E.msm_job(G.G1, [], [], lanes=4)]]
    return ps, qs, pts, ks, E.run_ranks(2, jobs, device="cpu")


def test_ragged_sharded_pairing_equals_the_jax_api(ragged):
    ps, qs, _, _, results = ragged
    want = JA.pairing_batch([(JA.G1._wrap(p), JA.G2._wrap(q)) for p, q in zip(ps, qs)])
    assert want != JA.Gt.one()
    for rank in results:
        assert rank[0]["value"] == want.f


def test_sharded_msm_with_an_empty_rank_equals_the_spec(ragged):
    _, _, pts, ks, results = ragged
    want = JSG.zero(OPS1)
    for p, k in zip(pts, ks):
        want = JSG.add(want, JSG.scalar_mul(p, k, OPS1), OPS1)
    assert not JSG.is_zero(want, OPS1)
    assert JSG.eq(results[0][1]["value"], want, OPS1)
    assert results[0][1]["value"] == results[1][1]["value"]     # the same limbs on every rank


def test_sharded_calls_raise_without_a_process_group():
    g1 = G.encode_points(G.G1, [_mul(JSG.G1_PARAMS, 3)], "cpu")
    g2 = G.encode_points(G.G2, [_mul(JSG.G2_PARAMS, 5)], "cpu")
    with pytest.raises(RuntimeError, match="no process group"):
        PAR.pairing_batch_sharded(g1, g2)
    with pytest.raises(RuntimeError, match="no process group"):
        PAR.msm_sharded(G.G1, g1, M.encode_scalars([7], "cpu"))
