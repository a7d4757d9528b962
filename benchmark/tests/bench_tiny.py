"""A copy of the benchmark with tiny cells added as files only, for the CPU
tests: the harness and the reference drive the port's plain versions."""

import json
import shutil
from pathlib import Path

BENCH = Path(__file__).resolve().parent.parent
REPO = BENCH.parent

LANES = 8     # the tiny MSM config's lanes; msm.LANES is set to it while a test runs

CELLS = {
    "tiny.product": ("ecpairing", "tiny-product", {
        "entry": "pairing_batch", "pairs": 3, "batches": 2, "infinity_g1": 1, "infinity_g2": 0,
        "warmup_calls": 0, "trace_skip": 0, "trace_calls": 1}),
    "tiny.each": ("ecpairing", "tiny-each", {
        "entry": "pairing", "pairs": 3, "batches": 2, "infinity_g1": 0, "infinity_g2": 1,
        "keep_every": 1, "sample_lanes": 2, "warmup_calls": 0, "trace_skip": 0, "trace_calls": 1}),
    "tiny.g1": ("tiny-msm", "tiny-g1", {
        "entry": "msm", "group": "G1", "points": 40, "batches": 2, "infinity_points": 1,
        "zero_scalars": 1, "top_scalars": 1, "warmup_calls": 0, "trace_skip": 0, "trace_calls": 1}),
    "tiny.g2": ("tiny-msm", "tiny-g2", {
        "entry": "msm", "group": "G2", "points": 20, "batches": 2, "infinity_points": 1,
        "zero_scalars": 1, "top_scalars": 1, "warmup_calls": 0, "trace_skip": 0, "trace_calls": 1}),
}


def make_root(dest: Path, cells=CELLS) -> Path:
    """dest holds BENCHMARK.json and benchmark/ as the repo has them, plus
    each tiny cell: a traffic file, a workload entry, and its name in every
    metric list of its kind of cell."""
    shutil.copytree(BENCH, dest / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__", ".cache", "tests"))
    b = json.loads((REPO / "BENCHMARK.json").read_text())
    cfg = json.loads((BENCH / "configs" / "groth16-msm.json").read_text())
    cfg["lanes"] = LANES
    (dest / "benchmark" / "configs" / "tiny-msm.json").write_text(json.dumps(cfg))
    for name, (config, traffic, spec) in cells.items():
        (dest / "benchmark" / "traffic" / f"{traffic}.json").write_text(json.dumps(spec))
        b["workloads"].append({"name": name, "config": config, "traffic": traffic, "chips": 1,
                               "why": "a tiny cell for the CPU tests"})
        msm = spec["entry"] == "msm"
        for m in b["end_to_end"] + b["per_layer"]:
            if "workloads" in m and any(w.startswith("msm.") for w in m["workloads"]) == msm:
                m["workloads"].append(name)
    (dest / "BENCHMARK.json").write_text(json.dumps(b, indent=1))
    return dest


def run(root: Path, cell: str, trace: bool = False, seed: int = 2**31 + 77, monkeypatch=None):
    """One CPU run of a cell of the tiny root, a window of one call."""
    import torch

    from benchlib.harness import run_cell
    if cell.startswith("tiny.g") and monkeypatch is not None:
        from bn254_tpu_torch import msm as M
        monkeypatch.setattr(M, "LANES", LANES)
    return run_cell(root, cell, seed, 0.0, trace, torch.device("cpu"), log=lambda *a, **k: None)
