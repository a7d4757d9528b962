"""The comparison separates the program from its control: on the port's CPU
path at a tiny size every number of the program reads 0, and the control
(the reference's answers in the lazy arithmetic, not fully reduced) fails
one of them."""

import pytest
import torch

import bench_tiny
import control


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    return bench_tiny.make_root(tmp_path_factory.mktemp("bench"))


@pytest.mark.parametrize("cell", ["tiny.product", "tiny.each", "tiny.g1"])
def test_the_control_fails_where_the_program_passes(root, cell, monkeypatch):
    if cell.startswith("tiny.g"):
        from bn254_tpu_torch import msm as M
        monkeypatch.setattr(M, "LANES", bench_tiny.LANES)
    r = control.readings(root, cell, 2**31 + 5, 0.0, torch.device("cpu"))
    assert all(v == 0 for v in r["program"].values()), r
    assert any(v > r["limits"][k] for k, v in r["control"].items()), r
