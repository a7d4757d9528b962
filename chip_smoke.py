"""Drive the PyTorch + CUDA port's batched reduced pairing once on one
NVIDIA GPU and check it.

    python3 chip_smoke.py

Phases (any failure raises, so the exit code is not 0):

1. Print the card (nvidia-smi name and power limit), build the eleven CUDA
   kernels from bn254_tpu_torch/csrc/ and print the build's seconds.
2. Kernel vs plain version: each kernel on CUDA tensors made from a seed
   (lanes 0, 1 and 2 of every coordinate hold 0, 1 and q - 1; lane 0 all
   zero is what to_affine hands the Miller kernels for a point at
   infinity) at B = 16384 and at a ragged B = 1000, against its plain
   PyTorch version on the same tensors.  Tolerance 0: these are integers.
   Each kernel's and each plain version's time at B = 16384 (CUDA events).
3. Main path, with every launch and plain-call counter reset first:
   ``pairing`` on 16384 Jacobian pairs (z != 1) made by spec additions as
   bench.py makes them, 8 lanes checked against the spec pairing; the
   golden pair through ``pairing_batch``; ``pairing_batch`` on 5 pairs
   with two infinity pairs against the spec; and an ECPAIRING-style check
   e(aP, bQ) * e(-ab P, Q) = 1.  Then every kernel must have launched and
   no plain version may have run.
4. Timing: pairings/s of ``pairing`` at B = 16384 and the time of each of
   its layers on its own: to_affine, Miller loop (without the infinity
   select) and final exponentiation (CUDA events, mean of 3 after a
   warm-up).

The line before the last is the kernels' JSON record; the last line is
{"ok": true, "device": {...}}.  Needs one CUDA card; fails without one.
"""

import json
import os
import random
import subprocess
import sys
import time

import torch

N_MAIN = 16384
N_RAGGED = 1000
SEED = 7


def require(ok, what: str):
    """Fail the run (a raise, so the exit code is not 0) unless ok."""
    if not ok:
        raise RuntimeError(f"chip_smoke.py: {what}")


def card_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]


def cuda_ms(fn, reps: int) -> float:
    """Mean ms per call over `reps` calls after one warm-up (CUDA events)."""
    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def spec_pairs(n: int, seed: int = SEED):
    """bench.py's pairs: 8 spec scalar muls, then chained additions (z != 1)."""
    from bn254_tpu.spec import group as SG
    from bn254_tpu.spec.constants import R

    rng = random.Random(seed)
    (ops1, gen1), (ops2, gen2) = SG.G1_PARAMS[:2], SG.G2_PARAMS[:2]
    base_p = [SG.scalar_mul((gen1[0], gen1[1], ops1.one), rng.randrange(1, R), ops1)
              for _ in range(8)]
    base_q = [SG.scalar_mul((gen2[0], gen2[1], ops2.one), rng.randrange(1, R), ops2)
              for _ in range(8)]
    ps, qs = [], []
    p, q = base_p[0], base_q[0]
    for i in range(n):
        p = SG.add(p, base_p[i % 8], ops1)
        q = SG.add(q, base_q[i % 8], ops2)
        ps.append(p)
        qs.append(q)
    return ps, qs


def phase_kernels(dev):
    """Every kernel against its plain version; returns {name: record}."""
    import numpy as np
    from bn254_tpu_torch import kernel_cases as KC

    records = {}
    for case in KC.CASES:
        err = 0
        for batch in (N_MAIN, N_RAGGED):
            args = case.make_args(np.random.default_rng(SEED), batch, dev)
            got, want = case.kernel(*args), case.plain(*args)
            torch.cuda.synchronize()
            require(all(g.shape == w.shape for g, w in zip(KC.outputs(got), KC.outputs(want))),
                    f"{case.label}: kernel and plain version differ in shape")
            err = max(err, KC.max_abs_err(got, want))
        require(err == 0, f"{case.label}: kernel differs from its plain version by {err}")
        line = f"kernel {case.label:20s} B={N_MAIN} and {N_RAGGED}: max_abs_err {err}"
        rec = records.get(case.name)
        if rec is None:           # time the first variant (Fq, NAF) at the main batch
            args = case.make_args(np.random.default_rng(SEED), N_MAIN, dev)
            ms = cuda_ms(lambda: case.kernel(*args), 10)
            plain_ms = cuda_ms(lambda: case.plain(*args), 1)
            records[case.name] = rec = {
                "name": case.name, "route": "cuda", "source": case.source,
                "replaces": case.replaces, "launches": 0, "max_abs_err": err,
                "ms": ms, "plain_ms": plain_ms}
            line += f"; kernel {ms:.4f} ms, plain {plain_ms:.4f} ms"
        rec["max_abs_err"] = max(rec["max_abs_err"], err)
        print(line, flush=True)
    return records


def phase_main_path(dev, ps, qs):
    """The main path once, with the counters reset around it."""
    import golden
    from bn254_tpu.spec import field as SF
    from bn254_tpu.spec import group as SG
    from bn254_tpu.spec.constants import R
    from bn254_tpu_torch import convert, counts
    from bn254_tpu_torch import groups as G
    from bn254_tpu_torch import pairing as P
    from bn254_tpu_torch import tower as T

    ops1, ops2 = SG.G1_PARAMS[0], SG.G2_PARAMS[0]
    gen1 = (SG.G1_PARAMS[1][0], SG.G1_PARAMS[1][1], ops1.one)
    gen2 = (SG.G2_PARAMS[1][0], SG.G2_PARAMS[1][1], ops2.one)
    g1 = G.encode_points(G.G1, ps, dev)
    g2 = G.encode_points(G.G2, qs, dev)
    rng = random.Random(SEED + 1)
    small_p = [SG.scalar_mul(gen1, rng.randrange(1, R), ops1) for _ in range(5)]
    small_q = [SG.scalar_mul(gen2, rng.randrange(1, R), ops2) for _ in range(5)]
    small_p[1], small_q[3] = SG.zero(ops1), SG.zero(ops2)
    a, b = rng.randrange(1, R), rng.randrange(1, R)
    ec_p = [SG.scalar_mul(gen1, a, ops1), SG.scalar_mul(gen1, (-a * b) % R, ops1)]
    ec_q = [SG.scalar_mul(gen2, b, ops2), gen2]

    counts.reset()
    torch.cuda.synchronize()
    out = P.pairing(g1, g2)
    batch = lambda p1, q2: P.pairing_batch(G.encode_points(G.G1, p1, dev),
                                           G.encode_points(G.G2, q2, dev))
    gold = batch([SG.scalar_mul(gen1, golden.MILLER_G1_SCALAR, ops1)],
                 [SG.scalar_mul(gen2, golden.MILLER_G2_SCALAR, ops2)])
    small = batch(small_p, small_q)
    ec = batch(ec_p, ec_q)
    torch.cuda.synchronize()
    launches, plain = dict(counts.launches), dict(counts.plain_calls)

    leaves = convert.tree_leaves(out)
    require(all(x.shape == (16, N_MAIN) and x.dtype == torch.int32 for x in leaves),
            "pairing output has the wrong shape or dtype")
    require(all(bool(((x >= 0) & (x < 1 << 16)).all()) for x in leaves),
            "pairing output limbs out of range")
    lanes = [0, 1, 2, 3, N_MAIN // 2, N_MAIN - 3, N_MAIN - 2, N_MAIN - 1]
    got = T.fq12_decode(convert.tree_map(lambda c: c[:, lanes], out))
    for k, lane in enumerate(lanes):
        require(got[k] == SG.pairing(ps[lane], qs[lane]), f"pairing lane {lane} differs from the spec")
    require(T.fq12_decode(gold)[0] == golden.REDUCED_PAIRING_EXPECTED,
            "golden reduced pairing differs")
    require(T.fq12_decode(small)[0] == SG.pairing_batch(small_p, small_q),
            "5-pair batch with infinity pairs differs from the spec")
    require(T.fq12_decode(ec)[0] == SF.FQ12_ONE, "ECPAIRING identity does not hold")
    print(f"main path: pairing B={N_MAIN} (8 lanes = spec), golden pair, "
          f"5-pair batch with 2 infinity pairs, ECPAIRING check: all agree", flush=True)

    missing = [k for k, v in launches.items() if v < 1]
    require(not missing, f"kernels not launched on the main path: {missing}")
    ran_plain = {k: v for k, v in plain.items() if v}
    require(not ran_plain, f"plain versions ran on the main path: {ran_plain}")
    print("launches on the main path:", json.dumps(launches), flush=True)
    return launches


def phase_timing(dev, ps, qs, card):
    """pairings/s at N_MAIN and the split into the path's three layers."""
    from bn254_tpu_torch import groups as G
    from bn254_tpu_torch import pairing as P
    from bn254_tpu_torch import tower as T

    g1 = G.encode_points(G.G1, ps, dev)
    g2 = G.encode_points(G.G2, qs, dev)
    total_ms = cuda_ms(lambda: P.pairing(g1, g2), 3)
    (pa, _), (qa, _) = G.to_affine(G.G1, g1), G.to_affine(G.G2, g2)
    f = P._miller_f_fused(qa, pa)
    split = (cuda_ms(lambda: (G.to_affine(G.G1, g1), G.to_affine(G.G2, g2)), 3),
             cuda_ms(lambda: P._miller_f_fused(qa, pa), 3),
             cuda_ms(lambda: T.fq12_final_exponentiation(f), 3))
    print(f"pairing B={N_MAIN}: {total_ms:.2f} ms = {N_MAIN / total_ms * 1e3:.0f} pairings/s; "
          f"to_affine {split[0]:.2f} ms, Miller {split[1]:.2f} ms, final exp {split[2]:.2f} ms "
          f"[{card}]", flush=True)


def main():
    if not torch.cuda.is_available():
        sys.exit("chip_smoke.py: no CUDA device; this script runs the port on the card only")
    root = os.path.dirname(os.path.abspath(__file__))
    sys.path[:0] = [root, os.path.join(root, "tests")]
    from bn254_tpu_torch import _build, counts

    dev = torch.device("cuda", 0)
    card = card_line()
    print(card, flush=True)
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"device {torch.cuda.get_device_name(0)}", flush=True)
    t0 = time.perf_counter()
    _build.library()
    print(f"kernel build: {time.perf_counter() - t0:.1f} s", flush=True)

    records = phase_kernels(dev)
    ps, qs = spec_pairs(N_MAIN)
    launches = phase_main_path(dev, ps, qs)
    phase_timing(dev, ps, qs, card)

    for name, rec in records.items():
        rec["launches"] = launches[name]
    require(sorted(records) == sorted(counts.KERNELS), "a kernel has no comparison record")
    print(card)
    print(json.dumps({"kernels": [records[k] for k in counts.KERNELS]}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
