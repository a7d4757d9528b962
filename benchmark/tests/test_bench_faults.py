"""A run with the timed path broken underneath must come out not correct: the
harness's look for a card skipped, the rest of a run driven on the port's
CPU path at a tiny size, one fault at a time where it can arise in the cell."""

import pytest
import torch

import bench_tiny


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    return bench_tiny.make_root(tmp_path_factory.mktemp("bench"))


def _flip(t):
    t = t.clone()
    t.view(-1)[0] ^= 1                       # one bit of one limb of one lane
    return t


def half_the_batch_left_out(monkeypatch):
    """Only the first half of each call's pairs or points counts; a product
    over the rest is squared, a sum has no rescaling to do."""
    from bn254_tpu_torch import msm as M
    from bn254_tpu_torch import pairing_torch as P
    from bn254_tpu_torch import tower as T
    from bn254_tpu_torch.convert import tree_map

    reduce, prepare = P.fq12_product_reduce, M.prepare

    def product_of_half(f):
        n = f[0][0][0].shape[-1]
        h = reduce(tree_map(lambda a: a[..., :max(1, n // 2)].contiguous(), f))
        return T.fq12_mul(h, h)

    miller = P._miller_f

    def lanes_of_half(g2, g1):
        f = miller(g2, g1)
        n = f[0][0][0].shape[-1]
        return tree_map(lambda a: torch.cat([a[..., :n // 2], a[..., :n - n // 2]], -1), f)

    def digits_of_half(K, points, scalars, *a, **k):
        xy, dgs = prepare(K, points, scalars, *a, **k)
        n = K.batch_of(points[0])
        dgs = dgs.clone()
        dgs[:, n // 2:] = 0
        return xy, dgs

    monkeypatch.setattr(P, "fq12_product_reduce", product_of_half)
    monkeypatch.setattr(P, "_miller_f", lanes_of_half)
    monkeypatch.setattr(M, "prepare", digits_of_half)


def an_answer_altered_where_it_is_produced(monkeypatch):
    from bn254_tpu_torch import fused as FU
    from bn254_tpu_torch import tower as T
    from bn254_tpu_torch.convert import tree_leaves, unpack_fq12

    final_exp, combine = T.fq12_final_exponentiation, FU.msm_combine

    def altered(f):
        out = torch.stack(tree_leaves(final_exp(f)))
        return unpack_fq12(_flip(out))

    monkeypatch.setattr(T, "fq12_final_exponentiation", altered)
    monkeypatch.setattr(FU, "msm_combine", lambda *a, **k: _flip(combine(*a, **k)))


def a_stage_returns_its_input_unchanged(monkeypatch):
    """The final exponentiation hands its input back (pairings only)."""
    from bn254_tpu_torch import tower as T
    monkeypatch.setattr(T, "fq12_final_exponentiation", lambda f: f)


FAULTS = {
    "half_the_batch_left_out": (half_the_batch_left_out, ["tiny.product", "tiny.each", "tiny.g1"]),
    "an_answer_altered": (an_answer_altered_where_it_is_produced,
                          ["tiny.product", "tiny.each", "tiny.g1"]),
    "a_stage_unchanged": (a_stage_returns_its_input_unchanged, ["tiny.product", "tiny.each"]),
}


@pytest.mark.parametrize("fault,cell", [(f, c) for f, (_, cells) in FAULTS.items() for c in cells])
def test_a_broken_timed_path_is_not_correct(root, fault, cell, monkeypatch):
    FAULTS[fault][0](monkeypatch)
    r = bench_tiny.run(root, cell, monkeypatch=monkeypatch)
    assert r["correct"] is False, r["check"]
    assert any(v["value"] > v["limit"] for v in r["check"].values())


@pytest.mark.parametrize("cell", ["tiny.product", "tiny.each", "tiny.g1"])
def test_inputs_off_reads_a_generator_whose_logs_are_wrong(root, cell, monkeypatch):
    from benchlib import inputs as I
    log = I.Table.log
    monkeypatch.setattr(I.Table, "log", lambda self, i: (log(self, i) + 1) % I.B.R)
    r = bench_tiny.run(root, cell, monkeypatch=monkeypatch)
    assert r["correct"] is False
    assert r["check"]["inputs_off"]["value"] >= 1, r["check"]
