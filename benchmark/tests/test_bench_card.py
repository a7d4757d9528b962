"""On the card: every cell of BENCHMARK.json runs short and correct, and its
control fails on three seeds.  Skipped without a card; on the card, from
the repo's root: ``python -m pytest benchmark/tests/test_bench_card.py -o
addopts="" -q`` (about 6 minutes)."""

import json
import subprocess
import sys

import pytest

import bench_tiny
from benchlib.catalog import Catalog

CELLS = [w["name"] for w in Catalog(bench_tiny.REPO).bench["workloads"]]


@pytest.mark.card
@pytest.mark.parametrize("cell", CELLS)
def test_a_short_run_of_each_cell_is_correct(card, cell):
    out = subprocess.run([sys.executable, "benchmark/run.py", "--workload", cell, "--seed",
                          "3141592653", "--seconds", "3", "--trace", "0"],
                         cwd=bench_tiny.REPO, capture_output=True, text=True, timeout=900)
    assert out.returncode == 0, out.stderr[-4000:]
    r = json.loads(out.stdout.strip().splitlines()[-1])
    assert r["correct"] and r["device"]["platform"] == "gpu", r


@pytest.mark.card
@pytest.mark.parametrize("cell", CELLS)
def test_the_control_fails_at_the_cells_size(card, cell):
    out = subprocess.run([sys.executable, "benchmark/control.py", "--workload", cell,
                          "--seeds", "2718281828,1618033988,1414213562", "--seconds", "3"],
                         cwd=bench_tiny.REPO, capture_output=True, text=True, timeout=1800)
    assert out.returncode == 0, out.stderr[-4000:]
    for line in out.stdout.strip().splitlines():
        r = json.loads(line)
        assert all(v == 0 for v in r["program"].values()), r
        assert any(v > r["limits"][k] for k, v in r["control"].items()), r
