"""The harness finds a cell, a configuration, a span and a per-layer metric
that were added as files and entries only."""

import json

import bench_tiny
from benchlib.catalog import Catalog


def _add_files(root):
    b = root / "benchmark"
    cfg = json.loads((b / "configs" / "ecpairing.json").read_text())
    cfg["name"] = "ecpairing-copy"
    (b / "configs" / "ecpairing-copy.json").write_text(json.dumps(cfg))
    (b / "traffic" / "tiny-new.json").write_text(json.dumps({
        "entry": "pairing_batch", "pairs": 2, "batches": 2, "infinity_g1": 0,
        "infinity_g2": 0, "warmup_calls": 0, "trace_skip": 0, "trace_calls": 1}))
    (b / "layers" / "new_span.json").write_text(json.dumps(
        {"module": "bn254_tpu_torch.pairing_torch", "attr": "miller_loop_batch"}))
    (b / "metrics" / "new.calls_traced.json").write_text(json.dumps({"reader": "py", "span": "new_span"}))
    (b / "metrics" / "new.calls_traced.py").write_text(
        "def read(trace, ctx, spec):\n"
        "    return float(len(trace.spans.get(spec['span'], []))) or None\n")
    bench = json.loads((root / "BENCHMARK.json").read_text())
    bench["configs"].append({"name": "ecpairing-copy", "source": "https://eips.ethereum.org/EIPS/eip-197",
                             "file": "benchmark/configs/ecpairing-copy.json", "reduced": [],
                             "why": "a configuration added as a file"})
    bench["workloads"].append({"name": "new.cell", "config": "ecpairing-copy", "traffic": "tiny-new",
                               "chips": 1, "why": "a cell added as files"})
    for m in bench["end_to_end"] + bench["per_layer"]:
        if m["name"] in ("pairings_per_s", "pairing.miller_ms"):
            m["workloads"].append("new.cell")
    bench["per_layer"].append({"name": "new.calls_traced", "unit": "calls", "better": "higher",
                               "source": "program_span", "layer": "pairing_torch.miller_loop_batch",
                               "moves": "pairings_per_s", "workloads": ["new.cell"]})
    (root / "BENCHMARK.json").write_text(json.dumps(bench))


def test_a_cell_config_span_and_metric_added_as_files_are_found_and_run(tmp_path, monkeypatch):
    root = bench_tiny.make_root(tmp_path)
    _add_files(root)
    cat = Catalog(root)
    assert cat.config(cat.workload("new.cell")["config"])["name"] == "ecpairing-copy"
    assert "new_span" in cat.layers()
    assert {m["name"] for m in cat.per_layer("new.cell")} == {"pairing.miller_ms", "new.calls_traced"}
    assert {m["name"] for m in cat.end_to_end("new.cell")} == {"pairings_per_s", "call_p95_ms", "setup_s"}
    r = bench_tiny.run(root, "new.cell", trace=True, monkeypatch=monkeypatch)
    assert r["correct"], r["check"]
    assert r["metrics"]["new.calls_traced"] == {"value": 1.0, "unit": "calls"}
    assert "pairing.miller_ms" not in r["metrics"]       # no device: the reader finds nothing
    assert r["device"]["window_s"] > 0 and "breakdown" in r
    r = bench_tiny.run(root, "new.cell", monkeypatch=monkeypatch)
    assert set(r["metrics"]) == {"pairings_per_s", "call_p95_ms", "setup_s"}
    assert list(r)[-1] == "check"


def test_every_name_of_the_benchmark_has_its_file():
    cat = Catalog(bench_tiny.REPO)
    for w in cat.bench["workloads"]:
        tr = cat.traffic(w["traffic"])
        cat.config(w["config"])
        cat.entry(tr["entry"])
        assert w["chips"] == 1
        assert cat.per_layer(w["name"]) and len(cat.end_to_end(w["name"])) >= 2
    for m in cat.bench["end_to_end"]:
        cat.reader("end_to_end", m["name"])
    for m in cat.bench["per_layer"]:
        spec, mod = cat.reader("metrics", m["name"])
        assert mod is not None or spec["reader"] in ("span_ms", "idle_pct")
    for c in cat.bench["configs"]:
        assert (bench_tiny.REPO / c["file"]).is_file()
