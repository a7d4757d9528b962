"""No module that the harness, the program it drives or the reference loads
is JAX's or the JAX package's, compared by whole top-level names; the
reference loads nothing of the program."""

import ast
import json
import subprocess
import sys
import types
from pathlib import Path

import pytest

import bench_tiny
from benchlib import harness as H

BENCH = Path(__file__).resolve().parent.parent
FORBIDDEN = {"jax", "jaxlib", "flax", "bn254_tpu"}

_LOADED = """
import json, sys
sys.argv = ["run.py"]
import run                                     # the harness's own start: caches, import path
from benchlib import catalog, harness, inputs, limbs, pairs, roofline, stats, trace
from bnref import bn254, check
cat = catalog.Catalog(run.ROOT)
for w in cat.bench["workloads"]:
    cat.entry(cat.traffic(w["traffic"])["entry"])
for m in cat.bench["per_layer"]:
    cat.reader("metrics", m["name"])
harness._Spans(cat.layers()).remove()          # imports every module a span names
import bn254_tpu_torch
from bn254_tpu_torch import msm, pairing_torch, groups, tower, fused
print(json.dumps(sorted({m.split(".")[0] for m in sys.modules})))
"""

_REFERENCE = """
import json, sys
sys.path.insert(0, sys.argv[1])
from bnref import bn254, check
print(json.dumps(sorted({m.split(".")[0] for m in sys.modules})))
"""


def _top_level(code: str, *args) -> set:
    out = subprocess.run([sys.executable, "-c", code, *args], cwd=BENCH, capture_output=True,
                         text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    return set(json.loads(out.stdout.strip().splitlines()[-1]))


def test_harness_and_program_load_neither_jax_nor_the_jax_package():
    names = _top_level(_LOADED)
    assert "bn254_tpu_torch" in names          # the program is loaded, and its name
    assert not names & FORBIDDEN               # begins with the JAX package's


def test_reference_loads_nothing_of_the_program():
    names = _top_level(_REFERENCE, str(BENCH))
    assert not names & (FORBIDDEN | {"bn254_tpu_torch", "torch", "benchlib"})


@pytest.mark.parametrize("path", sorted((BENCH / "bnref").glob("*.py")), ids=lambda p: p.name)
def test_reference_imports_name_only_the_standard_library_numpy_and_itself(path):
    allowed = {"__future__", "numpy"} | set(sys.stdlib_module_names)
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            tops = {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom):
            tops = set() if node.level else {node.module.split(".")[0]}
        else:
            continue
        assert tops <= allowed, f"{path.name} imports {tops - allowed}"


def test_foreign_modules_compares_whole_top_level_names(monkeypatch):
    monkeypatch.setitem(sys.modules, "bn254_tpu_torch_lookalike", types.ModuleType("x"))
    monkeypatch.setitem(sys.modules, "jaxtyping_lookalike.sub", types.ModuleType("y"))
    assert H.foreign_modules() == [m for m in H.foreign_modules() if m in FORBIDDEN]
    assert "bn254_tpu" not in H.foreign_modules()
    monkeypatch.setitem(sys.modules, "bn254_tpu.spec", types.ModuleType("z"))
    assert "bn254_tpu" in H.foreign_modules()


def test_a_run_that_finds_jax_loaded_prints_no_result(tmp_path, monkeypatch):
    root = bench_tiny.make_root(tmp_path)
    monkeypatch.setitem(sys.modules, "jax", types.ModuleType("jax"))
    with pytest.raises(SystemExit, match="jax"):
        bench_tiny.run(root, "tiny.g1", monkeypatch=monkeypatch)
