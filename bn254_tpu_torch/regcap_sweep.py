"""Time one kernel under several builds, on the card.

    python3 -m bn254_tpu_torch.regcap_sweep [label] [variant ...]

A variant is ``none`` (the default build), a ptxas register cap (a
number: ``nvcc -maxrregcount=<cap>``), any other nvcc flag (``-D...``
defines a macro for a trial build of a changed source), or several of
these joined by commas.  For each, the kernels are built with it (a
library of their own in ``_build/``, beside the default one), and the
kernel case `label` of ``kernel_cases`` (default ``fq12_cyc_pow[naf]``,
TPU row 11) is checked against its plain version at its batches
(tolerance 0) and timed at its first batch (CUDA events, mean of 10 after
a warm-up).  One line per variant: ptxas's registers and stack of the
case's entry, ms, and the bound its inputs give.  Default variants: none
168 128 96.
"""

from __future__ import annotations

import subprocess
import sys

import numpy as np
import torch

from . import _build
from . import kernel_cases as KC

SEED = 7            # chip_smoke.py's seed: the same inputs


def _entry_usage(log: str, kernel: str) -> str:
    """'<registers> registers, <stack> bytes stack' of the first entry
    whose mangled name holds `kernel`, from nvcc's -Xptxas -v log."""
    entry, stack = None, "?"
    for line in log.splitlines():
        if "Compiling entry function" in line:
            entry, stack = (line.split("'")[1] if kernel in line else None), "?"
        elif entry and "bytes stack frame" in line:
            stack = line.split()[0]
        elif entry and "Used" in line and "registers" in line:
            regs = line.split("Used")[1].split("registers")[0].strip()
            return f"{regs} registers, {stack} bytes stack"
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


def main(argv) -> int:
    if not torch.cuda.is_available():
        print("regcap_sweep: no CUDA device", file=sys.stderr)
        return 1
    label = argv[0] if argv else "fq12_cyc_pow[naf]"
    variants = argv[1:] or ["none", "168", "128", "96"]
    case = next(c for c in KC.CASES if c.label == label)
    kernel = "k_" + case.name
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
        usage = _entry_usage((_build.BUILD_DIR / "build.log").read_text(), kernel)
        for batch in case.batches:
            args = case.make_args(np.random.default_rng(SEED), batch, dev)
            err = KC.max_abs_err(case.kernel(*args), case.plain(*args))
            if err:
                raise RuntimeError(f"{label} at {variant}, B={batch}: differs by {err}")
        args = case.make_args(np.random.default_rng(SEED), case.batches[0], dev)
        ms = _ms(lambda: case.kernel(*args))
        bound, by = KC.bound_ms(*case.work(*args))
        print(f"{label} {variant}: {usage}; max_abs_err 0 at B={case.batches}; "
              f"{ms:.4f} ms at B={case.batches[0]} (bound {bound:.4f} ms, {by}) [{card}]",
              flush=True)
    _build.FLAGS = base
    _build._LIB = None
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
