"""The comparison's two readings for one cell: the program's, and its
control's, on several seeds in one process.

    python benchmark/control.py --workload <cell> --seeds 11,12,13 --seconds 3

For each seed: the cell's set-up, a short window at the cell's own load
(each call a full-size call, as a run makes them), then the comparison of
what the window produced with the plain reference (the program's reading),
and the same comparison with the control in the program's place: the
reference's answers computed in the lazy arithmetic (bnref.check.LAZY, every
Montgomery product left in [0, 2q)), which breaks the configurations'
guarantee of fully reduced, bit-exact outputs.  The control computes the
answers that the comparison reads.  One JSON line a seed.  The benchmark's
own runs never run the control.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402

import run as _run  # noqa: E402  (sets the caches and the import path)


def readings(root, workload: str, seed: int, seconds: float, device) -> dict:
    import torch

    from benchlib.catalog import Catalog
    from benchlib.harness import Ctx, run_window

    cat = Catalog(root)
    wl = cat.workload(workload)
    ctx = Ctx(cat.config(wl["config"]), cat.traffic(wl["traffic"]), seed, device)
    driver = cat.entry(ctx.traffic["entry"])
    st = driver.setup(ctx)
    for i in range(int(ctx.traffic.get("warmup_calls", 2))):
        driver.call(st, i % st.n_batches)
    lat, _, window_s, _, _ = run_window(driver, st, seconds, device)
    t = time.perf_counter()
    program, _ = driver.check(st)
    t_ref = time.perf_counter() - t
    control, _ = driver.check(st, control=True)
    del st
    if torch.device(device).type == "cuda":
        torch.cuda.empty_cache()
    return {"seed": seed, "calls": len(lat), "window_s": window_s, "reference_s": t_ref,
            "program": {k: v[0] for k, v in program.items()},
            "control": {k: v[0] for k, v in control.items()},
            "limits": {k: v[1] for k, v in program.items()}}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True, help="comma-separated")
    ap.add_argument("--seconds", type=float, default=3.0)
    args = ap.parse_args(argv)
    import torch

    if not torch.cuda.is_available():
        print("needs a CUDA card", file=sys.stderr)
        return 2
    for seed in (int(s) for s in args.seeds.split(",")):
        print(json.dumps(readings(_run.ROOT, args.workload, seed, args.seconds,
                                  torch.device("cuda", 0))), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
