"""Run one cell once: set up, warm up, a closed loop for the window, then the
comparison with the plain reference, and the result line.

A closed loop: one caller, each call waited on (its output synchronized on
the device) before the next starts, as a verifier or a prover waits on its
verdict or its point.  Calls cycle through the cell's input batches, so no
call repeats the inputs of the one before it.  The window ends with the
first call that completes at or after ``seconds``; every call completed is
counted, and the window runs to that call's end.

With ``trace`` the run is the same, and a stretch of calls inside the window
runs under torch.profiler with every span of ``benchmark/layers/`` wrapped
around its module attribute; the per-layer metrics are read from that trace.
"""

from __future__ import annotations

import functools
import importlib
import os
import sys
import tempfile
import time
from dataclasses import dataclass, field

import numpy as np

from . import stats
from .catalog import Catalog
from .trace import CALL_SPAN, Trace

FORBIDDEN = ("jax", "jaxlib", "flax", "bn254_tpu")


@dataclass
class Ctx:
    """What a driver is given: the cell's data, the seed, the device."""
    config: dict
    traffic: dict
    seed: int
    device: object
    rng: np.random.Generator = field(init=False)

    def __post_init__(self):
        self.rng = np.random.default_rng(self.seed)


def foreign_modules() -> list:
    """Loaded modules whose top-level name, compared whole, is JAX's or the
    JAX package's."""
    return sorted({m.split(".")[0] for m in list(sys.modules)} & set(FORBIDDEN))


def _sync(device):
    import torch
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


class _Spans:
    """The layers' spans, wrapped around their module attributes for a traced
    run and taken off after it."""

    def __init__(self, layers: dict):
        import torch
        self._undo = []
        for span, where in layers.items():
            mod = importlib.import_module(where["module"])
            orig = getattr(mod, where["attr"])

            def wrapped(*a, _orig=orig, _span=span, **k):
                with torch.profiler.record_function(_span):
                    return _orig(*a, **k)

            setattr(mod, where["attr"], functools.wraps(orig)(wrapped))
            self._undo.append((mod, where["attr"], orig))

    def remove(self):
        for mod, attr, orig in self._undo:
            setattr(mod, attr, orig)


def _profile(device):
    import torch
    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.device(device).type == "cuda":
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    return torch.profiler.profile(activities=acts)


def run_window(driver, st, seconds: float, device, trace_at=None):
    """The closed loop.  Returns (latencies in s, batch of each call, window
    in s, the traced calls' batches, the profiler or None).  trace_at =
    (first traced call, number of calls) puts that stretch under the
    profiler."""
    import torch
    nb = st.n_batches
    lat, batch = [], []
    prof, traced = None, []
    span = torch.profiler.record_function
    t0 = time.perf_counter()
    i = 0
    while True:
        k = i % nb
        if trace_at and i == trace_at[0]:
            prof = _profile(device)
            prof.start()
        tracing = prof is not None and len(traced) < (trace_at[1] if trace_at else 0)
        ts = time.perf_counter()
        if tracing:
            with span(CALL_SPAN):
                out = driver.call(st, k)
                _sync(device)
        else:
            out = driver.call(st, k)
            _sync(device)
        te = time.perf_counter()
        if tracing:
            traced.append(k)
            if len(traced) == trace_at[1]:
                prof.stop()
        lat.append(te - ts)
        batch.append(k)
        driver.keep(st, i, k, out)
        del out
        i += 1
        if te - t0 >= seconds:
            break
    if prof is not None and len(traced) < trace_at[1]:
        prof.stop()
    return lat, batch, te - t0, traced, prof


def _trace_of(prof) -> Trace:
    with tempfile.TemporaryDirectory() as d:
        path = os.path.join(d, "trace.json")
        prof.export_chrome_trace(path)
        return Trace.from_file(path)


def _device_info(device, trace=None) -> dict:
    import torch
    dev = torch.device(device)
    if dev.type == "cuda":
        info = {"platform": "gpu", "kind": torch.cuda.get_device_name(dev),
                "count": 1, "memory_peak_bytes": int(torch.cuda.max_memory_allocated(dev))}
    else:
        info = {"platform": "cpu", "kind": "cpu", "count": 1, "memory_peak_bytes": 0}
    if trace is not None:
        info["busy_s"] = trace.busy_s()
        info["window_s"] = trace.window_s()
    return info


def run_cell(root, workload: str, seed: int, seconds: float, trace: bool, device,
             t_start: float | None = None, log=print) -> dict:
    """One run of one cell; returns the result line as a dict."""
    import torch
    t_start = time.perf_counter() if t_start is None else t_start
    cat = Catalog(root)
    wl = cat.workload(workload)
    ctx = Ctx(cat.config(wl["config"]), cat.traffic(wl["traffic"]), seed, device)
    driver = cat.entry(ctx.traffic["entry"])
    t_inputs = time.perf_counter()
    st = driver.setup(ctx)
    _sync(device)
    t_warm = time.perf_counter()
    if torch.device(device).type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)
    for i in range(int(ctx.traffic.get("warmup_calls", 2))):
        driver.call(st, i % st.n_batches)
        _sync(device)
    log("setup: %.3f s to the inputs, %.3f s inputs, %.3f s warm-up" % (
        t_inputs - t_start, t_warm - t_inputs, time.perf_counter() - t_warm), file=sys.stderr)
    spans_names = set(cat.layers()) | {CALL_SPAN}
    spans = _Spans(cat.layers()) if trace else None
    trace_at = (int(ctx.traffic["trace_skip"]), int(ctx.traffic["trace_calls"])) if trace else None
    setup_s = time.perf_counter() - t_start
    try:
        lat, batch, window_s, traced, prof = run_window(driver, st, seconds, device, trace_at)
    finally:
        if spans is not None:
            spans.remove()
    fifths = [lat[len(lat) * j // 5:len(lat) * (j + 1) // 5] for j in range(5)]
    log("window: %d calls in %.3f s; mean ms by fifth %s" % (
        len(lat), window_s, " ".join(f"{1e3 * sum(f) / len(f):.3f}" for f in fifths if f)),
        file=sys.stderr)
    dev_info = _device_info(device)
    foreign = foreign_modules()
    if foreign:
        raise SystemExit(f"modules of JAX or the JAX package loaded: {', '.join(foreign)}")
    numbers, failed = driver.check(st)
    correct = all(v is not None and v <= lim for v, lim in numbers.values())
    result = {"correct": correct, "attempted": len(lat), "failed": failed}
    if trace:
        tr = _trace_of(prof) if prof is not None else Trace([])
        placed = sum(1 for d in tr.device if d[3] is not None)
        log(f"trace: {tr.n_calls} calls, {len(tr.device)} device operations, {placed} placed "
            f"on the host, spans {sorted((k, len(v)) for k, v in tr.spans.items() if k in spans_names)}",
            file=sys.stderr)
        rctx = ReadCtx(driver, st, traced)
        metrics = {}
        for m in cat.per_layer(workload):
            spec, mod = cat.reader("metrics", m["name"])
            v = (mod.read(tr, rctx, spec) if mod is not None else GENERIC[spec["reader"]](tr, rctx, spec))
            if v is not None:
                metrics[m["name"]] = {"value": v, "unit": m["unit"]}
        result["metrics"] = metrics
        result["device"] = _device_info(device, tr)
        result["device"]["memory_peak_bytes"] = dev_info["memory_peak_bytes"]
        result["breakdown"] = {"device_ops": tr.device_ops(), "idle_gaps": tr.idle_gaps()}
    else:
        wctx = WindowCtx(driver, st, lat, batch, window_s, setup_s)
        metrics = {}
        for m in cat.end_to_end(workload):
            spec, _ = cat.reader("end_to_end", m["name"])
            metrics[m["name"]] = {"value": E2E[spec["reader"]](wctx, spec), "unit": m["unit"]}
        result["metrics"] = metrics
        result["device"] = dev_info
    result["check"] = {k: {"value": v, "limit": lim} for k, (v, lim) in numbers.items()}
    return result


# --------------------------------------------------------------------------
# Readers
# --------------------------------------------------------------------------

@dataclass
class WindowCtx:
    driver: object
    state: object
    latencies: list
    batches: list
    window_s: float
    setup_s: float


@dataclass
class ReadCtx:
    driver: object
    state: object
    traced_batches: list

    def facts(self) -> list:
        """The driver's facts of each traced call's batch (what the work of
        the call is), in call order."""
        return [self.driver.facts(self.state, k) for k in self.traced_batches]


def _rate(w: WindowCtx, spec) -> float:
    return stats.rate(sum(w.driver.work(w.state, k) for k in w.batches), w.window_s)


def _quantile(w: WindowCtx, spec) -> float:
    return stats.quantile(w.latencies, spec["q"]) * spec.get("scale", 1.0)


E2E = {
    "rate": _rate,
    "quantile": _quantile,
    "setup": lambda w, spec: w.setup_s,
}


def _span_ms(tr: Trace, ctx: ReadCtx, spec):
    s = tr.span_device_s(spec["span"])
    return None if s is None or not tr.n_calls else 1e3 * s / tr.n_calls


def _idle_pct(tr: Trace, ctx: ReadCtx, spec):
    w = tr.window_s()
    busy = tr.busy_s()
    return None if w <= 0 or busy <= 0 else 100.0 * (1.0 - busy / w)


GENERIC = {"span_ms": _span_ms, "idle_pct": _idle_pct}
