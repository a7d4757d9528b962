"""Everything the harness runs, found by name in data files.

``BENCHMARK.json`` at the root of the checkout names the cells and the
metrics; the files under ``benchmark/`` say what each name means:

* ``configs/<config>.json``: a deployment (what the cell stands for);
* ``traffic/<traffic>.json``: a traffic mix, whose ``entry`` names the
  driver ``entries/<entry>.py`` that makes its inputs and calls the program;
* ``layers/<span>.json``: a span, the program's module attribute that a
  traced run wraps;
* ``end_to_end/<metric>.json`` and ``metrics/<metric>.json`` (with
  ``metrics/<metric>.py`` where it needs arithmetic): how a metric is read.

A later change adds a cell, a configuration, a span or a metric by adding
files and entries; nothing here changes.
"""

from __future__ import annotations

import importlib.util
import json
from pathlib import Path


class Catalog:
    def __init__(self, root):
        self.root = Path(root)
        self.dir = self.root / "benchmark"
        self.bench = self._json(self.root / "BENCHMARK.json")
        self._modules = {}

    @staticmethod
    def _json(path: Path) -> dict:
        if not path.is_file():
            raise FileNotFoundError(f"missing {path}")
        return json.loads(path.read_text())

    def workload(self, name: str) -> dict:
        for w in self.bench["workloads"]:
            if w["name"] == name:
                return w
        raise KeyError(f"no workload {name!r} in BENCHMARK.json")

    def config(self, name: str) -> dict:
        return self._json(self.dir / "configs" / f"{name}.json")

    def traffic(self, name: str) -> dict:
        return self._json(self.dir / "traffic" / f"{name}.json")

    def layers(self) -> dict:
        """span name -> {"module": ..., "attr": ...}, one file a span."""
        return {p.stem: self._json(p) for p in sorted((self.dir / "layers").glob("*.json"))}

    def end_to_end(self, workload: str) -> list:
        return [m for m in self.bench["end_to_end"]
                if "workloads" not in m or workload in m["workloads"]]

    def per_layer(self, workload: str) -> list:
        """The per-layer metrics a traced run of the workload reports: those
        that list it, and those without a list whose end-to-end metric the
        workload reports."""
        moves = {m["name"] for m in self.end_to_end(workload)}
        return [m for m in self.bench["per_layer"]
                if (workload in m["workloads"] if "workloads" in m else m["moves"] in moves)]

    def reader(self, kind: str, name: str) -> tuple:
        """(the metric's file as a dict, its module or None)."""
        spec = self._json(self.dir / kind / f"{name}.json")
        return spec, self._module(self.dir / kind / f"{name}.py")

    def entry(self, name: str):
        mod = self._module(self.dir / "entries" / f"{name}.py")
        if mod is None:
            raise FileNotFoundError(f"no driver benchmark/entries/{name}.py")
        return mod

    def _module(self, path: Path):
        if not path.is_file():
            return None
        if path not in self._modules:
            spec = importlib.util.spec_from_file_location(
                "bench_" + path.parent.name + "_" + path.stem.replace(".", "_").replace("-", "_"),
                path)
            mod = importlib.util.module_from_spec(spec)
            spec.loader.exec_module(mod)
            self._modules[path] = mod
        return self._modules[path]
