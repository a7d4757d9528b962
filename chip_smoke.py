"""Drive the PyTorch + CUDA port's two main paths, the batched reduced
pairing and the Pippenger MSM, once on one NVIDIA GPU and check them.

    python3 chip_smoke.py

Phases (any failure raises, so the exit code is not 0):

1. Print the card (nvidia-smi name and power limit), build the fourteen
   CUDA kernels from bn254_tpu_torch/csrc/ and print the build's seconds.
2. Kernel vs plain version: each kernel on CUDA tensors made from a seed
   (bn254_tpu_torch/kernel_cases.py: field residues with 0, 1 and q - 1
   in the first lanes; real G1/G2 points with the group law's edge lanes;
   MSM digits over distinct affine points with planted duplicates) at
   B = 16384 and at a ragged B = 1000 (n = 5000 for the MSM accumulate),
   against its plain PyTorch version on the same tensors.  Tolerance 0:
   these are integers.  Each kernel's and each plain version's time at
   the main batch (CUDA events), beside the bound its inputs give.
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
5. MSM path, with the counters reset first: ``msm`` over G1 at n = 2^20
   and over G2 at n = 2^16, points P_i = (i + 1) G built on the card by
   doubling the batch with point_add, random scalars from a numpy seed,
   and planted infinity points, zero scalars, r - 1 and duplicate points;
   each result is checked projectively against (sum k_i a_i mod r) G from
   the spec, a_i the multiple lane i holds.  Then ``batch.msm_g1`` /
   ``msm_g2`` on 64 random points against the spec's sum.  Every kernel
   of the path must have launched and no plain version may have run.
6. MSM timing: ms per MSM and points/s for G1 2^20 and G2 2^16, and the
   split into prepare (digits and affine conversion), accumulate and
   Horner + lane fold (CUDA events, mean of 3 after a warm-up).  On the
   same prepared inputs (all 1024 point tiles a lane for G1, 64 for G2)
   the accumulate kernel must equal its plain version bit for bit; the
   kernels line takes row 19's times and bound from the G1 2^20 inputs.

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


def cuda_once(fn):
    """(fn(), its ms) for one call, timed with CUDA events."""
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    out = fn()
    end.record()
    torch.cuda.synchronize()
    return out, start.elapsed_time(end)


def spec_pairs(n: int, seed: int = SEED):
    """bench.py's pairs: 8 spec scalar muls, then chained additions (z != 1)."""
    from bn254_tpu_torch.spec import group as SG
    from bn254_tpu_torch.spec.constants import R

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
        for batch in case.batches:
            args = case.make_args(np.random.default_rng(SEED), batch, dev)
            got, want = case.kernel(*args), case.plain(*args)
            torch.cuda.synchronize()
            require(all(g.shape == w.shape for g, w in zip(KC.outputs(got), KC.outputs(want))),
                    f"{case.label}: kernel and plain version differ in shape")
            err = max(err, KC.max_abs_err(got, want))
        require(err == 0, f"{case.label}: kernel differs from its plain version by {err}")
        main_b = case.batches[0]
        line = (f"kernel {case.label:22s} B={'/'.join(map(str, case.batches))}: "
                f"max_abs_err {err}")
        rec = records.get(case.name)
        if rec is None:           # time the first variant (Fq, NAF, G1) at the main batch
            args = case.make_args(np.random.default_rng(SEED), main_b, dev)
            ms = cuda_ms(lambda: case.kernel(*args), 10)
            plain_ms = cuda_ms(lambda: case.plain(*args), 1)
            bound_ms, bound_by = KC.bound_ms(*case.work(*args))
            records[case.name] = rec = {
                "name": case.name, "route": "cuda", "source": case.source,
                "replaces": case.replaces, "launches": 0, "max_abs_err": err,
                "ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
                "bound_by": bound_by, "library_ms": None}
            line += (f"; kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, "
                     f"bound {bound_ms:.4f} ms ({bound_by}) at B={main_b}")
        rec["max_abs_err"] = max(rec["max_abs_err"], err)
        print(line, flush=True)
    return records


def check_launches(path: str, kernels, launches, plain):
    """Fail unless every kernel of the path launched and no plain version
    ran; return the path's launch counts."""
    missing = [k for k in kernels if launches[k] < 1]
    require(not missing, f"kernels not launched on the {path} path: {missing}")
    ran_plain = {k: v for k, v in plain.items() if v}
    require(not ran_plain, f"plain versions ran on the {path} path: {ran_plain}")
    print(f"launches on the {path} path:", json.dumps(launches), flush=True)
    return launches


def phase_main_path(dev, ps, qs):
    """The main path once, with the counters reset around it."""
    import golden
    from bn254_tpu_torch import convert, counts
    from bn254_tpu_torch import groups as G
    from bn254_tpu_torch import pairing as P
    from bn254_tpu_torch import tower as T
    from bn254_tpu_torch.spec import field as SF
    from bn254_tpu_torch.spec import group as SG
    from bn254_tpu_torch.spec.constants import R

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

    return check_launches("pairing", counts.PAIRING_PATH, launches, plain)


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


MSM_SIZES = {1: 1 << 20, 2: 1 << 16}   # G1 at BASELINE.md's 2^20 points; G2 at 2^16


def msm_inputs(K, dev, n: int, rng):
    """Points P_i = (i + 1) G built on the card (P[2^k : 2^(k+1)] =
    P[0 : 2^k] + 2^k G, one point_add each), scalars from a numpy seed
    (limbs below r's top limb), and planted edges.  Returns (point batch,
    scalar limbs [16, n], the multiples a_i, the scalars k_i)."""
    import numpy as np
    from bn254_tpu_torch import fused as FU
    from bn254_tpu_torch import groups as G
    from bn254_tpu_torch import limbs as L
    from bn254_tpu_torch import msm as M
    from bn254_tpu_torch.convert import pack, unpack_point
    from bn254_tpu_torch.spec import group as SG
    from bn254_tpu_torch.spec.constants import R

    nc = K.COORDS
    ops, gen = (SG.G1_PARAMS if nc == 1 else SG.G2_PARAMS)[:2]
    g = (gen[0], gen[1], ops.one)
    pts = torch.empty((3 * nc, 16, n), dtype=torch.int32, device=dev)
    pts[:, :, :1] = pack(G.encode_points(K, [g], dev))
    m = 1
    while m < n:
        step = pack(G.encode_points(K, [SG.scalar_mul(g, m, ops)], dev))
        pts[:, :, m:2 * m] = FU.point_add(nc, pts[:, :, :m].contiguous(),
                                          step.expand(-1, -1, m).contiguous())
        m *= 2
    mult = list(range(1, n + 1))
    limbs = rng.integers(0, 1 << 16, size=(16, n), dtype=np.int64)
    limbs[15] %= (R >> 240)                     # below r's top limb: k < r
    ks = L._limbs_to_ints(limbs)
    lanes = M.LANES
    for j in range(4):      # a point meets its own bucket: same lane, same scalar
        pts[:, :, lanes + j] = pts[:, :, j]
        mult[lanes + j], ks[lanes + j] = mult[j], ks[j]
    pts[:, :, 2 * lanes + 5] = pts[:, :, 5]     # a duplicate with another scalar
    mult[2 * lanes + 5] = mult[5]
    for j in (7, n // 3, n - 1):                # infinity points
        pts[2 * nc:, :, j] = 0
        mult[j] = 0
    for j in (8, n // 2):
        ks[j] = 0
    for j in (9, n // 5, n - 2):
        ks[j] = R - 1
    return unpack_point(nc, pts), M.encode_scalars(ks, dev), mult, ks


def phase_msm(dev):
    """The MSM path once, with the counters reset around it."""
    import numpy as np
    from bn254_tpu_torch import batch as BA
    from bn254_tpu_torch import counts
    from bn254_tpu_torch import groups as G
    from bn254_tpu_torch import msm as M
    from bn254_tpu_torch.spec import group as SG
    from bn254_tpu_torch.spec.constants import R

    rng = np.random.default_rng(SEED + 2)
    inputs = {K: msm_inputs(K, dev, MSM_SIZES[K.COORDS], rng) for K in (G.G1, G.G2)}
    rnd = random.Random(SEED + 3)
    small = {}
    for K, (ops, gen) in ((G.G1, SG.G1_PARAMS[:2]), (G.G2, SG.G2_PARAMS[:2])):
        g = (gen[0], gen[1], ops.one)
        pts = [SG.scalar_mul(g, rnd.randrange(1, R), ops) for _ in range(64)]
        pts[3] = None
        ks = [rnd.randrange(R) for _ in range(64)]
        ks[4], ks[5] = 0, R - 1
        pts[6] = pts[10]
        small[K] = (pts, ks)

    counts.reset()
    torch.cuda.synchronize()
    out = {K: M.msm(K, pts, k) for K, (pts, k, _, _) in inputs.items()}
    small_out = {K: (BA.msm_g1 if K is G.G1 else BA.msm_g2)(pts, ks)
                 for K, (pts, ks) in small.items()}
    torch.cuda.synchronize()
    launches, plain = dict(counts.launches), dict(counts.plain_calls)

    for K, (_, _, mult, ks) in inputs.items():
        ops, gen = (SG.G1_PARAMS if K is G.G1 else SG.G2_PARAMS)[:2]
        total = sum(k * a for k, a in zip(ks, mult)) % R
        want = SG.scalar_mul((gen[0], gen[1], ops.one), total, ops)
        got = G.decode_points(K, out[K])[0]
        require(SG.eq(got, want, ops),
                f"msm G{K.COORDS} n={len(mult)} differs from (sum k_i a_i) G")
        pts, ks = small[K]
        want = SG.zero(ops)
        for p, k in zip(pts, ks):
            if p is not None:
                want = SG.add(want, SG.scalar_mul(p, k, ops), ops)
        require(SG.eq(small_out[K], want, ops), f"64-point msm G{K.COORDS} differs from the spec")
    print(f"MSM path: G1 n={MSM_SIZES[1]} and G2 n={MSM_SIZES[2]} = (sum k_i a_i) G; "
          f"64-point G1 and G2 MSMs = spec sums", flush=True)
    return check_launches("MSM", counts.MSM_PATH, launches, plain), inputs


def phase_msm_timing(inputs, card):
    """ms per MSM, points/s, the split into its three steps; and the
    accumulate kernel on the path's own inputs against its plain version
    (tolerance 0), timed beside its bound.  Returns {ncoords: record}."""
    from bn254_tpu_torch import fused as FU
    from bn254_tpu_torch import kernel_cases as KC
    from bn254_tpu_torch import msm as M

    records = {}
    for K, (pts, ks, _, _) in inputs.items():
        n, c, nc = ks.shape[-1], M.MSM_FUSED_WINDOW[K.COORDS], K.COORDS
        nb = (1 << (c - 1)) + 1
        total = cuda_ms(lambda: M.msm(K, pts, ks), 3)
        packed, dgs = M.prepare(K, pts, ks, c)
        acc = lambda: FU.msm_accumulate(nc, packed, dgs, nb, lanes=M.LANES)
        totals = acc()
        split = (cuda_ms(lambda: M.prepare(K, pts, ks, c), 3), cuda_ms(acc, 3),
                 cuda_ms(lambda: M.combine(K, totals, c), 3))
        bound, by = KC.bound_ms(*KC.msm_work(nc, packed, dgs, nb, True, M.LANES))
        print(f"msm G{nc} n={n} c={c} lanes={M.LANES}: {total:.2f} ms = "
              f"{n / total * 1e3:.0f} points/s; prepare {split[0]:.2f} ms, accumulate "
              f"{split[1]:.2f} ms (bound {bound:.2f} ms, {by}), Horner + fold "
              f"{split[2]:.2f} ms [{card}]", flush=True)
        want, plain_ms = cuda_once(lambda: FU.msm_accumulate_plain(nc, packed, dgs, nb,
                                                                    lanes=M.LANES))
        err = KC.max_abs_err(totals, want)
        require(err == 0, f"msm_accumulate[g{nc}] on the MSM path's inputs (n={n}) "
                          f"differs from its plain version by {err}")
        print(f"kernel msm_accumulate[g{nc}] on the path's inputs n={n}: max_abs_err 0; "
              f"kernel {split[1]:.4f} ms, plain {plain_ms:.4f} ms, bound {bound:.4f} ms "
              f"({by}) [{card}]", flush=True)
        records[nc] = {"max_abs_err": err, "ms": split[1], "plain_ms": plain_ms,
                       "bound_ms": bound, "bound_by": by}
    return records


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
    msm_launches, inputs = phase_msm(dev)
    records["msm_accumulate"].update(phase_msm_timing(inputs, card)[1])   # G1 2^20
    print(f"all phases: {time.perf_counter() - t0:.0f} s from the build's start", flush=True)

    for name, rec in records.items():      # launches over both main-path runs
        rec["launches"] = launches[name] + msm_launches[name]
    require(sorted(records) == sorted(counts.KERNELS), "a kernel has no comparison record")
    print(card)
    print(json.dumps({"kernels": [records[k] for k in counts.KERNELS]}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
