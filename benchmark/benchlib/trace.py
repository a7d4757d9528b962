"""A torch.profiler trace read back into the benchmark's terms.

The traced run wraps every call in a span named ``call`` and every layer
named under ``benchmark/layers/`` in a span of its own (torch's
``record_function``).  The trace is exported as Chrome trace JSON and read
here: device operations (kernels, copies, sets) with their times, the host
time of each operation's launch (through the runtime call that shares its
correlation id, or else the host operation that shares its external id), and
the host spans.  A device operation belongs to a span when its launch falls
inside the span on the host.
"""

from __future__ import annotations

import bisect
import json
from collections import defaultdict

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
HOST_CATS = ("cpu_op", "user_annotation")
CALL_SPAN = "call"


def short_name(name: str) -> str:
    """A kernel's name without its return type, namespaces, argument list
    or template arguments: ``void (anonymous namespace)::k_fq12_mul(int
    const*, ...)`` -> ``k_fq12_mul``."""
    name = name.removeprefix("void ").replace("(anonymous namespace)::", "")
    for sep in ("(", "<"):
        if sep in name and not name.startswith(sep):
            name = name.split(sep, 1)[0]
    return name.strip().rsplit("::", 1)[-1]


class Trace:
    def __init__(self, events: list):
        xs = [e for e in events if e.get("ph") == "X"]
        calls = [e for e in xs if e.get("cat") == "user_annotation" and e["name"] == CALL_SPAN]
        self.thread = calls[0]["tid"] if calls else None
        self.calls = sorted((float(e["ts"]), float(e["ts"]) + float(e["dur"])) for e in calls)
        launch = {}
        for e in xs:
            if e.get("cat") in ("cuda_runtime", "cuda_driver"):
                corr = e.get("args", {}).get("correlation")
                if corr is not None:
                    launch[corr] = float(e["ts"])
        host = [e for e in xs if e.get("cat") in HOST_CATS and e.get("tid") == self.thread]
        ext = {}
        for e in host:
            eid = e.get("args", {}).get("External id")
            if eid is not None:
                ext.setdefault(eid, float(e["ts"]))
        self.host = sorted((float(e["ts"]), float(e["ts"]) + float(e["dur"]), e["name"]) for e in host)
        self._host_starts = [h[0] for h in self.host]
        self.spans = defaultdict(list)
        for ts, end, name in self.host:
            self.spans[name].append((ts, end))
        self.device = []          # (start, end, short name, launch host time or None)
        for e in xs:
            if e.get("cat") in DEVICE_CATS:
                args = e.get("args", {})
                t = launch.get(args.get("correlation"))
                if t is None:
                    t = ext.get(args.get("External id"))
                ts = float(e["ts"])
                self.device.append((ts, ts + float(e["dur"]), short_name(e["name"]), t))
        self.device.sort()

    @classmethod
    def from_file(cls, path) -> "Trace":
        with open(path) as fh:
            data = json.load(fh)
        return cls(data["traceEvents"] if isinstance(data, dict) else data)

    # ------------------------------------------------------------------
    @property
    def n_calls(self) -> int:
        return len(self.calls)

    @property
    def window(self):
        """(start, end) in microseconds: the traced calls on the host."""
        return (self.calls[0][0], self.calls[-1][1]) if self.calls else None

    def window_s(self) -> float:
        w = self.window
        return (w[1] - w[0]) * 1e-6 if w else 0.0

    def _in_window(self):
        w = self.window
        if w is None:
            return []
        return [d for d in self.device if d[1] > w[0] and d[0] < w[1]]

    def busy_s(self) -> float:
        """Seconds of the traced window in which some device operation ran."""
        w = self.window
        busy, cur = 0.0, None
        for s, e, _, _ in self._in_window():
            s, e = max(s, w[0]), min(e, w[1])
            if cur is None or s > cur[1]:
                if cur is not None:
                    busy += cur[1] - cur[0]
                cur = [s, e]
            else:
                cur[1] = max(cur[1], e)
        if cur is not None:
            busy += cur[1] - cur[0]
        return busy * 1e-6

    def span_device_s(self, span: str) -> float | None:
        """Device seconds of the operations launched inside the span, or None
        where the span never ran or no launch could be placed."""
        iv = sorted(self.spans.get(span, []))
        if not iv:
            return None
        starts = [s for s, _ in iv]
        total, placed = 0.0, False
        for s, e, _, t in self._in_window():
            if t is None:
                continue
            k = bisect.bisect_right(starts, t) - 1
            if k >= 0 and t <= iv[k][1]:
                total += e - s
                placed = True
        return total * 1e-6 if placed else None

    def kernel_device_s(self, names) -> float | None:
        """Device seconds of the kernels whose short name is one of names."""
        want = set(names)
        ds = [e - s for s, e, n, _ in self._in_window() if n in want]
        return sum(ds) * 1e-6 if ds else None

    def device_ops(self, top: int = 10) -> list:
        acc = defaultdict(float)
        for s, e, n, _ in self._in_window():
            acc[n] += (e - s) * 1e-6
        return sorted(([n, v] for n, v in acc.items()), key=lambda x: -x[1])[:top]

    def _host_at(self, t: float) -> str:
        """The innermost host operation of the calling thread running at t."""
        k = bisect.bisect_right(self._host_starts, t) - 1
        while k >= 0:
            s, e, name = self.host[k]
            if e >= t:
                return name
            k -= 1
            if t - s > 5e6:           # nothing open for 5 s before t
                break
        return "host (no traced operation)"

    def idle_gaps(self, top: int = 10) -> list:
        """Idle device time inside the window, by what the host was doing."""
        w = self.window
        if w is None:
            return []
        acc = defaultdict(float)
        cur = w[0]
        for s, e, _, _ in self._in_window() + [(w[1], w[1], "", None)]:
            if s > cur:
                acc[self._host_at((cur + s) / 2)] += (s - cur) * 1e-6
            cur = max(cur, e)
        return sorted(([n, v] for n, v in acc.items()), key=lambda x: -x[1])[:top]
