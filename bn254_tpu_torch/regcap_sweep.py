"""Time kernels under several builds, on the card.

    python3 -m bn254_tpu_torch.regcap_sweep [label[@B][,label[@B]...]] [variant ...]

A variant is ``none`` (the default build), a ptxas register cap (a
number: ``nvcc -maxrregcount=<cap>``), any other nvcc flag (``-D...``
defines a macro for a trial build of a changed source), or several of
these joined by commas.  For each, the kernels are built with it (a
library of their own in ``_build/``, beside the default one), and each
kernel case `label` of ``kernel_cases`` (default ``fq12_cyc_pow[naf]``,
TPU row 11) is checked against its plain version at its batches
(tolerance 0) and timed at its first batch, or at B where the label says
``@B``: CUDA events around 10 back-to-back calls after a warm-up (a
one-op kernel's wrapper host time shows there below a batch that shows
its body), and around 10 more enqueued behind a device sleep, where the
host's dispatch hides behind the queue (the kernels' device time).  One line per
variant and label: ptxas's registers, stack and spill stores of the
case's entry, ms, and the bound its inputs give.  A label the checkout
does not have is skipped, so the same command times an older checkout
(copy this file into it) beside this one.  Default variants: none 168
128 96.
"""

from __future__ import annotations

import subprocess
import sys

import numpy as np
import torch

from . import _build
from . import kernel_cases as KC

SEED = 7            # chip_smoke.py's seed: the same inputs


def _entry_usage(log: str, kernel: str, field: str = "") -> str:
    """'<registers> registers, <stack> bytes stack, <spill> bytes spill
    stores' of the first entry whose mangled name holds `kernel` and, for
    a group-law template, the instance's field (``IN5bn2542Fq`` or
    ``IN5bn2543Fq2``), from nvcc's -Xptxas -v log."""
    entry, stack, spill = None, "?", "?"
    for line in log.splitlines():
        if "Compiling entry function" in line:
            entry = line.split("'")[1] if kernel in line and field in line else None
            stack, spill = "?", "?"
        elif entry and "bytes stack frame" in line:
            stack, spill = line.split()[0], line.split(",")[1].split()[0]
        elif entry and "Used" in line and "registers" in line:
            regs = line.split("Used")[1].split("registers")[0].strip()
            return f"{regs} registers, {stack} bytes stack, {spill} bytes spill stores"
    return "not in the build log"


def _ms(fn, reps: int = 10) -> float:
    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def _queued_ms(fn, reps: int = 10) -> float:
    """ms a call of `reps` back-to-back calls enqueued behind a ~1 ms
    device sleep: the host's dispatch hides behind the queue, so this is
    the kernels' device time (with the gaps between launches)."""
    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(2_000_000)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def main(argv) -> int:
    if not torch.cuda.is_available():
        print("regcap_sweep: no CUDA device", file=sys.stderr)
        return 1
    labels = (argv[0] if argv else "fq12_cyc_pow[naf]").split(",")
    variants = argv[1:] or ["none", "168", "128", "96"]
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True,
                          check=True).stdout.strip().splitlines()[0]
    print(card, flush=True)
    dev = torch.device("cuda")
    base = list(_build.FLAGS)
    for variant in variants:
        _build.FLAGS = base + [f"-maxrregcount={v}" if v.isdigit() else v
                               for v in variant.split(",") if v != "none"]
        _build._LIB = None
        _build.library_path().unlink(missing_ok=True)     # build, so that the log is this variant's
        _build.library()
        log = (_build.BUILD_DIR / "build.log").read_text()
        for spec in labels:
            label, _, at = spec.partition("@")
            case = next((c for c in KC.CASES if c.label == label), None)
            if case is None:
                print(f"{label} {variant}: no such kernel case here", flush=True)
                continue
            field = "IN5bn2543Fq2" if "[g2" in label else "IN5bn2542Fq" if "[g1" in label else ""
            usage = _entry_usage(log, "k_" + case.name, field)
            for batch in case.batches:
                args = case.make_args(np.random.default_rng(SEED), batch, dev)
                err = KC.max_abs_err(case.kernel(*args), case.plain(*args))
                if err:
                    raise RuntimeError(f"{label} at {variant}, B={batch}: differs by {err}")
            batch = int(at) if at else case.batches[0]
            args = case.make_args(np.random.default_rng(SEED), batch, dev)
            ms = _ms(lambda: case.kernel(*args))
            device = _queued_ms(lambda: case.kernel(*args))
            bound, by = KC.bound_ms(*case.work(*args))
            print(f"{label} {variant}: {usage}; max_abs_err 0 at B={case.batches}; "
                  f"{ms:.4f} ms at B={batch}, device {device:.4f} ms (bound {bound:.4f} ms, "
                  f"{by}) [{card}]", flush=True)
    _build.FLAGS = base
    _build._LIB = None
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
