"""Drive the PyTorch + CUDA port's eleven main paths, the batched reduced
pairing, the Pippenger MSM, the GLV scalar multiplication, the
prepared-G2 Miller loop, the throughput probes, the batched point
decompression, the field inversions, the batched API over the scalar
API's objects, the scalar API on the native host engine, the sharded
pairing and MSM over torch.distributed and the shootout, once on one
NVIDIA GPU and check them.

    python3 chip_smoke.py

Phases (any failure raises, so the exit code is not 0):

1. Print the card (nvidia-smi name and power limit), build every CUDA
   kernel of counts.KERNELS (thirty-one) from bn254_tpu_torch/csrc/ (and
   the native host engine from csrc/host/ with gcc, its seconds) and
   print the build's seconds and ptxas's registers, stack and shared
   memory of the MSM kernels, of the group law's five (one add, one
   double, the MSM's Horner + lane fold, the double-and-add and the GLV
   ladder, a team of four threads a lane), of the five kernels that run
   a team of six threads a lane (csrc/fq12_team.cuh): the cyclotomic
   ladder (row 11) and square (row 10), the Miller kernel (row 6), the
   Fq12 product (row 9) and the prepared Miller loop (row 8l, whose
   one-step launches are rows 8 and 13), of the prepared-G2 lines (row
   14l, a team of four, whose one-step launches are rows 14 and 7), and
   of the Fermat chain (row 5), the Fq2 square root, the final
   exponentiation's Fq12 inverse and Frobenius maps and the affine
   conversion (one Fermat chain a block, which serves rows 1-5), of row
   15's Fq2 product (the three-thread Fq2 step), of row 16's Fq2 square
   (a pair of threads a lane) and of the tower probe's
   team chains (the Fq2 chains on three threads a lane, the Fq6 and Fq12
   chains on six, one instance an op); every
   other kernel runs one thread a lane (every entry's numbers stay in
   bn254_tpu_torch/_build/build.log).  Then the Miller kernel's resident
   blocks an SM (the occupancy query).
2. Kernel vs plain version: each kernel on CUDA tensors made from a seed
   (bn254_tpu_torch/kernel_cases.py: field residues with 0, 1 and q - 1
   in the first lanes; real G1/G2 points with the group law's edge lanes;
   MSM digits over distinct affine points with planted duplicates, and a
   skewed variant with every lane of a window in one bucket; the bucket
   sort on signed, unsigned and skewed digits; the bucket reduce; GLV
   tables and digits from the port's decomposition with edge scalars and
   planted coincide and P + (-P) lanes; the MSM's window totals with
   infinity windows, a window equal to Horner's running value and P + (-P)
   fold pairs; scalars r, r - 1, 0, 1 on points in and outside the G2
   subgroup; the Fq2 square root's planted lanes (0, alpha = -1, a
   non-residue, x^3 + b2 of real G2 points) among random elements and
   squares; the lazy Fq2 product's column extremes; the affine
   conversion's random points with z = 0 on the first and last lane of
   every 128, on the last lane and on a whole block, and G2's z with one
   coordinate 0; the probes at their
   scripts' batches, 32768 and 8192) at B = 16384 and at a ragged B =
   1000 (n = 5000 for the MSM kernels; the Fq12 product, the cyclotomic
   square, the prepared Miller loop and its one-step forms, the fold and
   the Fq12 square, the prepared-G2 lines and theirs, the doubling and
   addition steps, also at B = 3, fewer lanes than a warp's five teams;
   the tower probe's chains, row 15's Fq2 product and row 16's Fq2
   square also at B = 3, fewer lanes than a warp's teams, and at 262144
   (one call, its first and last 4096 lanes against the plain version,
   then timed: rows 15 and 16 and the Fq2 chains, where one thread a lane
   fills the card);
   the Miller kernel over the pairing's 87 kinds, the Fermat chain, the
   Fq12 inverse, each Frobenius map and the double-and-add also at B = 3
   and at pairing_batch's B = 1, the Fq2 square root also at B = 3, the
   affine conversion at 16384, 1000 and 1, the
   double-and-add over 64 bits at 16384
   lanes and r's 254 at the others; the Horner + lane fold at the MSM's
   1024 lanes and at 128 and 8), against its plain PyTorch version on the
   same tensors.  Tolerance 0: these are integers.  The first variant of
   each kernel (Fq, NAF, G1, mul, fq_mul, signed, Frobenius power 1),
   fq12_cyc_pow's binary digits (TPU row 12), the conjugation, the skewed
   MSM and the G2 variants of the group law's five and of the affine
   conversion, and every op of the tower probe, timed at the main batch
   (CUDA events; the plain version once), beside the bound its inputs
   give and, for the step loops, the square root and the affine
   conversion, the serial depth (products on one lane's chain); the
   Miller kernel's line also gives the min and max of its 10 timed calls.
3. Main path, with every launch and plain-call counter reset first:
   ``pairing`` on 16384 Jacobian pairs (z != 1) made by spec additions as
   bench.py makes them, 8 lanes checked against the spec pairing; the
   golden pair through ``pairing_batch``; ``pairing_batch`` on 5 pairs
   with two infinity pairs against the spec; and an ECPAIRING-style check
   e(aP, bQ) * e(-ab P, Q) = 1.  Then every kernel must have launched
   (the final exponentiation's Fq12 inverse and Frobenius maps among
   them), to_affine once a group a call and none of the one-op field
   kernels it replaced (mont_mul, mont_sqr, fq2_sqr, fq_pow), the Miller
   kernel once a call and none of the one-op kernels its Frobenius tail
   replaced (fq2_mul, g2_add_step, fq12_fold_line), and no plain version
   may have run.
4. Timing: pairings/s of ``pairing`` at B = 16384 and the time of each of
   its layers on its own: to_affine, Miller loop (without the infinity
   select; one Miller launch) and final exponentiation, split into its
   easy part (the inverse, the conjugation, a Frobenius map, two
   products) and its hard part (CUDA events, mean of 3 after a
   warm-up).  The one-launch Miller layer must equal, on all 16384
   lanes, the route it replaced (``frobenius_tail_route``: the Miller
   kernel over the 85 scheduled kinds, the Frobenius bases by tower ops,
   two one-step addition and fold launches), whose additions and folds
   must equal their plain versions on the same inputs; both routes are
   timed.  Then one pairing call under torch.profiler: its count of CUDA
   kernels (and of copies) and the device-busy share, the union of their
   device intervals over the call's span.
5. MSM path, with the counters reset first: ``msm`` over G1 at n = 2^20
   and over G2 at n = 2^16, points P_i = (i + 1) G built on the card by
   doubling the batch with point_add, random scalars from a numpy seed,
   and planted infinity points, zero scalars, r - 1 and duplicate points;
   each result is checked projectively against (sum k_i a_i mod r) G from
   the spec, a_i the multiple lane i holds.  Then ``batch.msm_g1`` /
   ``msm_g2`` on 64 random points (the scalar API's G1/G2 and Fr objects)
   against the spec's sum.  Every kernel
   of the path must have launched, one to_affine and one Horner + lane
   fold call an MSM, no one-op field kernel, add or double, and no plain
   version may have run.
6. MSM timing: ms per MSM and points/s for G1 2^20 and G2 2^16, and the
   split into prepare (digits and affine conversion; with the pad, the
   digits and to_affine each timed alone), accumulate and Horner + lane
   fold (CUDA events, mean of 3 after a warm-up).  On the
   same prepared inputs (all 1024 point tiles a lane for G1, 64 for G2)
   the accumulate (row 19: the bucket sort, the point-major copy, the
   accumulation and the reduce) must equal its plain version bit for bit,
   and so must the sort, the reduce, the Horner + lane fold and the
   affine conversion (on the padded points) on their own; each is timed
   beside its bound, and the kernels line takes the
   times and bounds of row 19, of the sort, the reduce and the Horner +
   lane fold from the G1 2^20 inputs.  Then the
   G1 accumulate is timed on its worst case at that size: every nonzero
   digit of a window in one bucket (phase 2 holds that case against its
   plain version at n = 16384).
7. GLV path, with the counters reset first: ``glv.scalar_mul_glv`` over
   G1 and G2 at B = 32768 on msm_inputs' points and scalars (infinity
   points, k = 0, 1, r - 1, lambda, r - lambda planted), every lane
   checked projectively against the double-and-add ``groups.scalar_mul``
   (one point_mul kernel) and 19 lanes against the spec;
   ``batch.scalar_mul_g1`` on 64 G1 and Fr objects against the spec.
   Then each kernel of the path (mont_mul for beta x, point_add for p1 +
   p2, the ladder) against its plain version on the
   path's own inputs, and ms per call and scalar-muls/s split into
   decompose + table and the ladder beside its bound and its serial
   depth (six rounds a step); the kernels line takes row 20's times from
   the G1 inputs.
8. Prepared-G2 Miller loop, with the counters reset first:
   ``miller_loop(precompute(qa), pa)`` on the pairing's 16384 pairs equal
   to the fused Miller loop limb for limb, all 87 coefficient triples of
   every lane equal to the one-op route's (rows 14 and 7 chained as
   one-step launches, the Frobenius bases on row 3) and of 4 lanes to the
   spec's, and each call timed; ``precompute`` is one g2_precompute
   launch and the loop one miller_loop launch (no g2_dbl_step,
   g2_add_step, fq2_mul, fq12_sqr or fq12_fold_line).  Then the
   g2_precompute kernel against its plain version on the pairs' Q and
   the miller_loop kernel on the path's own lines, both at tolerance 0,
   and timed beside their bounds.
9. Throughput probes, with the counters reset first: ``probe_mont``
   (B = 32768, chain 64) and ``probe_tower`` (B = 8192, chain 32, the
   seven ops of bench_tower.py).  Every chain, and every op's one call
   as a kernel of its own (mont_mul, mont_sqr, fq2_mul_fused,
   fq2_sqr_fused, fq12_sqr, fq12_mul, fq12_cyc_sqr on the probe's
   operands), equal to its plain version bit for bit; the Fq chains equal
   to the spec's a * b^64 and a^(2^64) on every lane.  Prints each op's G
   Fq-products/s, its ns per product beside the rate kernel_cases.bound_ms
   assumes, the same from 10 calls enqueued behind a device sleep (the
   host's dispatch hidden), and the op's time as a kernel of its own.
   The chains run each op on the engine the main path runs it on (fq_mul
   one thread a lane; fq2_mul, fq2_sqr the three-thread Fq2 step;
   fq6_mul, the Fq12 ops the six-thread team).  Then row 15
   (fq2_mul_fused) on its own at 16384 and 262144 lanes: the event time
   between 10 back-to-back calls, the time of 10 calls enqueued behind a
   device sleep, the kernel's device time from torch.profiler where the
   trace holds its kernels (a session after phase 4's in one process
   traced none on the card), and the bound; and the wrapper's host
   microseconds a call split into its check, its output's allocation and
   its launch (the stream read among it), beside the stream object and
   entry lookup the launch path no longer pays.
10. Point decompression, with the counters reset first:
   ``g1_from_compressed_batch`` on 16384 G1 and ``g2_from_compressed_batch``
   (subgroup check on) on 16384 G2 compressed points built on the card as
   the MSM's are and compressed on the host by the port's spec codec, with
   planted invalid lanes (bad prefix, x = 0, x >= q, wrong lengths, an Fq2
   quotient >= q, twist points outside the subgroup) and the golden hex
   vectors.  Every valid lane round-trips to its point's affine limbs with
   z = 1, every planted invalid lane is masked off, and 16 sampled lanes
   of each group and the planted ones equal the host codec's result or
   exception; the G2 square root is one fq2_sqrt launch (no per-bit
   loop of one-op Fq2 squares and products: g2_rhs's x^2 and x^2 x are
   their only launches), the G2 subgroup check one point_mul launch, and
   no one-op add or double runs.  Then decompressions/s, split into host
   parse, square root, y selection and (G2) subgroup check; the fq2_sqrt
   kernel is held to its plain version on the path's own x^3 + b2 at
   16384 lanes (tolerance 0) and timed there beside its bound.
11. Inversions: the reference's sweeps (tests/test_reference_scale.py)
   on the port's own inversions on the card, tolerance 0, one batched
   call each with the counters reset around it: ``fields.FQ.inv`` and
   ``FR.inv`` on a = 1..10,000 and -1..-10,000 (a a^-1 = 1), on zeros (0
   maps to 0) and on 10,000 random a (a^-1 a = 1 and (a b) a^-1 = b);
   ``tower.fq2_inv`` on a + i, a - i and a + (3k + 1) i for a = 1..2,000
   and -1..-2,000, and on zeros.  Each check prints its lanes and the
   kernels it launched, which must be exactly its list (Fq: fq_pow, and
   mont_mul for the products; Fr: mont_sqr and mont_mul; Fq2 also
   fq2_mul) with no plain version.
12. The batched API over the scalar API's objects, with the counters
   reset first: 16384 pairs (a_i P, b_i Q), the G1 points made by
   ``batch.scalar_mul_g1`` and the G2 points by ``glv.scalar_mul_glv``,
   infinity planted in one slot or both on a few lanes (the first and
   the last among them).  ``batch.pairing_batch`` must equal the host
   spec's e(P, Q)^(sum a_i b_i) over the finite lanes, and its 3-chunk
   split the same Gt; ``batch.pairing_each`` on 64 sampled lanes (the
   planted ones among them) must equal ``api.pairing``, and the product
   of all its results ``pairing_batch``; the pairing path's kernels, five
   Miller launches (one a chunk) and no plain version.  Then
   ``pairing_batch``'s ms (CUDA events, mean of 3 after a warm-up), its
   device part on tensors and the host conversion (objects -> tensors,
   16384 Fq12 -> Gt).
13. The native host engine (bn254_tpu_torch.native), with the counters
   reset around its card part: its gcc build's seconds (phase 1 builds
   it, since phases 12-15 make the API's objects on it), then hold it
   against the spec: the golden pair (reduced pairing and Miller
   value, tests/golden.py), 8 G1 and 8 G2 scalar muls with the scalars 0,
   1 and r - 1 on random bases, pairing_batch with an infinity pair, and
   the API's miller_loop_batch raising ToAffineConversion on infinity.
   Its pairing_batch on 256 of the main path's pairs must equal
   pairing_torch.pairing_batch on the card on the same pairs (the
   pairing path's kernels, no plain version).  Prints the host ms of one
   api.pairing on the engine and with BN254_NO_NATIVE (the spec), and of
   the 256-pair batch; then runs examples.dh and examples.joux.
14. Sharded, with the counters reset around the in-process part: a world
   of 1 on NCCL in this process (a FileStore in a temporary directory):
   parallel.pairing_batch_sharded on the main path's 16384 pairs must
   equal pairing_torch.pairing_batch on them, value for value after
   canonical decode, and parallel.msm_sharded on phase 5's G1 2^20 inputs
   must equal msm.msm projectively (the pairing and MSM paths' kernels,
   no plain version); both timed beside the unsharded call, and the
   gather alone (CUDA events).  Then entry.dryrun_multichip(2): two
   spawned ranks on the one card (gloo, host copies of the partials), 2
   pairs and 4 points a rank against the spec; and the 16384 pairs as 2 x
   8192 on two ranks, which must give the world-of-1 value on both, with
   each rank's ms and its gather's ms.
15. Shootout, with the counters reset around device mode:
   shootout.device at N = 10000 (the reference's 20,000 pairings: GLV
   ladders for a_i = s1^i G1 and b_i = s2^i G2 in chunks of 4096, the
   last padded with scalar 0, a Miller product a chunk, one final
   exponentiation an accumulator on the host), acc1 == acc2 and equal to
   e(G1, G2)^(sum (s1 s2)^i) by the scalar API, its pairings/s beside
   the card's name and power limit (CUDA events after a warm-up at the
   same shapes; the GLV and Miller kernels, the product tree's fq12_mul,
   no plain version); then host mode (the scalar API on the engine) at
   N = 200 against the same oracle.

Each main path must launch every kernel it uses and no plain version.
The "all phases" line gives the run's seconds and each phase's.
The line before the last is the kernels' JSON record (launches summed
over the eleven paths); the last line is {"ok": true, "device": {...}}.
Needs one CUDA card; fails without one.
"""

import ctypes
import json
import os
import random
import re
import subprocess
import sys
import time

import torch

N_MAIN = 16384
N_RAGGED = 1000
SEED = 7
ROW_12 = "fq12_cyc_pow[binary]"     # TPU row 12: row 11's kernel on binary digits
# timed beside each kernel's first variant
TIMED = (ROW_12, "msm_accumulate[g1,skew]", "fq12_frob[conj]", "point_add[g2]",
         "point_double[g2]", "msm_combine[g2]", "point_mul[g2]", "glv_ladder[g2]",
         "to_affine[g2]") + tuple(f"chain_tower[{op}]" for op in (
             "fq2_mul", "fq2_sqr", "fq6_mul", "fq12_sqr", "fq12_mul", "cyclo_sqr"))
PTXAS = ("k_msm_bucket_sort", "k_msm_accumulate", "k_msm_bucket_reduce", "k_fq12_cyc_pow",
         "k_fq12_cyc_sqr",
         "k_miller_precompute", "k_fq12_mul", "k_fq_pow", "k_fq12_inv", "k_fq12_frob",
         "k_point_add", "k_point_double", "k_msm_combine", "k_point_mul", "k_glv_ladder",
         "k_fq2_sqrt", "k_miller_loop", "k_g2_precompute", "k_to_affine",
         "k_fq2_mul_fused", "k_fq2_sqr_fused", "k_chain_fq2", "k_chain_team")
SPREAD = ("miller_precompute",)     # also the min and max of the timed reps (row 6)
# timed once more at WIDE_B, where a one-op body shows past its wrapper's
# host time and one thread a lane fills the card: rows 15 and 16 and the
# Fq2 chains
WIDE = ("fq2_mul_fused", "fq2_sqr_fused", "chain_tower[fq2_mul]", "chain_tower[fq2_sqr]")
WIDE_B = 262144
WIDE_SLICE = 4096                   # lanes at each end held against the plain version


def require(ok, what: str):
    """Fail the run (a raise, so the exit code is not 0) unless ok."""
    if not ok:
        raise RuntimeError(f"chip_smoke.py: {what}")


def card_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]


def ptxas_lines(log: str, kernels):
    """ptxas's registers, stack and shared memory of each entry whose name
    holds one of `kernels`, from nvcc's -Xptxas -v log (G1/G2 by the
    template's Fq/Fq2, a probe team by its op, a chain by mul/sqr)."""
    out, entry, stack = [], None, {}
    for line in log.splitlines():
        if "Compiling entry function" in line:
            entry = line.split("'")[1]
        elif "Function properties for" in line:
            entry = line.split("for ")[-1].strip()
        elif "bytes stack frame" in line and entry:
            stack[entry] = line.split()[0]
        elif "Used" in line and "registers" in line and entry:
            name = next((k for k in kernels if k in entry), None)
            if name:
                op = re.search(r"(\d+)(Op\w+)", entry)
                field = (f"[{op.group(2)[:int(op.group(1))]}]" if op
                         else "[sqr]" if "ILb1E" in entry else "[mul]" if "ILb0E" in entry
                         else "[Fq2]" if "Fq2" in entry else "[Fq]" if "Fq" in entry else "")
                regs = line.split("Used")[1].split("registers")[0].strip()
                smem = line.split("bytes smem")[0].split(",")[-1].strip() \
                    if "bytes smem" in line else "0"
                out.append(f"ptxas {name}{field}: {regs} registers, "
                           f"{stack.get(entry, '?')} bytes stack, {smem} bytes shared")
    return out


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


def cuda_reps(fn, reps: int):
    """ms of each of `reps` calls after one warm-up (CUDA events around each)."""
    fn()
    torch.cuda.synchronize()
    events = [torch.cuda.Event(enable_timing=True) for _ in range(reps + 1)]
    events[0].record()
    for e in events[1:]:
        fn()
        e.record()
    torch.cuda.synchronize()
    return [a.elapsed_time(b) for a, b in zip(events, events[1:])]


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
        # time the first variant (Fq, NAF, G1, signed) and the TIMED ones
        if rec is None or case.label in TIMED:
            args = case.make_args(np.random.default_rng(SEED), main_b, dev)
            if case.label in SPREAD:
                reps = cuda_reps(lambda: case.kernel(*args), 10)
                ms = sum(reps) / len(reps)
            else:
                ms = cuda_ms(lambda: case.kernel(*args), 10)
            _, plain_ms = cuda_once(lambda: case.plain(*args))
            bound_ms, bound_by = KC.bound_ms(*case.work(*args))
            line += (f"; kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, "
                     f"bound {bound_ms:.4f} ms ({bound_by}) at B={main_b}")
            if case.depth is not None:
                line += f"; serial depth {case.depth(*args):.0f} products"
            if case.label in SPREAD:
                line += f"; reps min {min(reps):.4f} ms, max {max(reps):.4f} ms"
        if rec is None:
            records[case.name] = rec = {
                "name": case.name, "route": "cuda", "source": case.source,
                "replaces": case.replaces, "launches": 0, "max_abs_err": err,
                "ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
                "bound_by": bound_by, "library_ms": None}
        rec["max_abs_err"] = max(rec["max_abs_err"], err)
        print(line, flush=True)
        if case.label in WIDE:
            print(wide_line(case, dev), flush=True)
    return records


def _slice_lanes(args, lo: int, hi: int):
    """The args with every tensor cut to lanes lo:hi (its last axis)."""
    return tuple(x[..., lo:hi].contiguous() if isinstance(x, torch.Tensor) else x for x in args)


def wide_line(case, dev) -> str:
    """The case at WIDE_B lanes: one call held against the plain version on
    the first and last WIDE_SLICE lanes (tolerance 0), then timed beside
    its bound."""
    import numpy as np
    from bn254_tpu_torch import kernel_cases as KC

    args = case.make_args(np.random.default_rng(SEED), WIDE_B, dev)
    got = case.kernel(*args)
    for lo in (0, WIDE_B - WIDE_SLICE):
        err = KC.max_abs_err(got[..., lo:lo + WIDE_SLICE],
                             case.plain(*_slice_lanes(args, lo, lo + WIDE_SLICE)))
        require(err == 0, f"{case.label} at B={WIDE_B}: lanes {lo}+ differ from the plain "
                          f"version by {err}")
    ms, queued = cuda_ms(lambda: case.kernel(*args), 10), queued_ms(lambda: case.kernel(*args))
    bound_ms, bound_by = KC.bound_ms(*case.work(*args))
    return (f"kernel {case.label:22s} B={WIDE_B}: max_abs_err 0 on lanes 0-{WIDE_SLICE - 1} "
            f"and the last {WIDE_SLICE}; kernel {ms:.4f} ms ({queued:.4f} ms enqueued behind "
            f"a device sleep), bound {bound_ms:.4f} ms ({bound_by})")


def check_launches(path: str, kernels, launches, plain, absent=()):
    """Fail unless every kernel of the path launched, none of `absent` did
    and no plain version ran; return the path's launch counts."""
    missing = [k for k in kernels if launches[k] < 1]
    require(not missing, f"kernels not launched on the {path} path: {missing}")
    extra = {k: launches[k] for k in absent if launches[k]}
    require(not extra, f"kernels launched on the {path} path that it no longer uses: {extra}")
    ran_plain = {k: v for k, v in plain.items() if v}
    require(not ran_plain, f"plain versions ran on the {path} path: {ran_plain}")
    print(f"launches on the {path} path:", json.dumps(launches), flush=True)
    return launches


def phase_main_path(dev, ps, qs):
    """The main path once, with the counters reset around it."""
    import golden
    from bn254_tpu_torch import convert, counts
    from bn254_tpu_torch import groups as G
    from bn254_tpu_torch import pairing_torch as P
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

    require(launches["to_affine"] == 2 * 4, f"{launches['to_affine']} to_affine launches for "
                                            f"4 pairing calls (one a group a call)")
    require(launches["miller_precompute"] == 4, f"{launches['miller_precompute']} Miller launches "
                                                f"for 4 pairing calls (one a call)")
    return check_launches("pairing", counts.PAIRING_PATH, launches, plain,
                          absent=counts.TO_AFFINE_ONE_OPS + counts.FROBENIUS_TAIL_ONE_OPS)


def device_busy(fn):
    """One call of fn under torch.profiler -> (CUDA kernels, copies and
    sets, device-busy share: the union of their device intervals over the
    span of every event).  Fails where the trace holds no device event: on
    the card that means the profiler did not trace it."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    events = list(prof.events())
    device = sorted((e.time_range.start, e.time_range.end) for e in events
                    if e.device_type == torch.autograd.DeviceType.CUDA)
    require(device, "torch.profiler traced no device event in a call on the card")
    copies = sum(1 for e in events if e.device_type == torch.autograd.DeviceType.CUDA
                 and ("Memcpy" in e.name or "Memset" in e.name))
    busy, (cur_s, cur_e) = 0.0, device[0]
    for s, e in device[1:]:
        if s > cur_e:
            busy += cur_e - cur_s
            cur_s = s
        cur_e = max(cur_e, e)
    busy += cur_e - cur_s
    span = (max(e.time_range.end for e in events) - min(e.time_range.start for e in events))
    return len(device) - copies, copies, busy / span


def frobenius_tail_route(qa, pa, checks=None):
    """The Miller layer as it ran before the Frobenius tail moved into the
    Miller kernel: the kernel over the 85 scheduled kinds, the bases Q1 =
    pi(Q), Q2 = -pi^2(Q) by tower ops (pairing_torch._frobenius_points), then a
    one-step g2_add_step and fq12_fold_line launch for each.  With
    `checks`, each addition and fold is appended there as (name, kernel's
    result, plain version's result on the same inputs).  Returns f
    [12, 16, B]."""
    from bn254_tpu_torch import fused as FU
    from bn254_tpu_torch import pairing_torch as P
    from bn254_tpu_torch.convert import pack

    px, py = pa
    f, r = FU.miller_precompute(pack(qa), pack(pa), P._PRE_KINDS)
    for base in map(pack, P._frobenius_points(qa)):
        step = FU.g2_add_step(r, base)
        if checks is not None:
            checks.append(("g2_add_step", step, FU.g2_add_step_plain(r, base)))
        r, line = step
        got = FU.fq12_fold_line(f, line, px, py)
        if checks is not None:
            checks.append(("fq12_fold_line", got, FU.fq12_fold_line_plain(f, line, px, py)))
        f = got
    return f


def phase_timing(dev, ps, qs, card, records):
    """pairings/s at N_MAIN, the split into the path's three layers and of
    the final exponentiation into its easy and hard parts, the one-launch
    Miller layer against the route it replaced (equal on every lane, and
    timed), and one call's device-busy share."""
    from bn254_tpu_torch import fused as FU
    from bn254_tpu_torch import groups as G
    from bn254_tpu_torch import kernel_cases as KC
    from bn254_tpu_torch import pairing_torch as P
    from bn254_tpu_torch import tower as T
    from bn254_tpu_torch.convert import pack

    g1 = G.encode_points(G.G1, ps, dev)
    g2 = G.encode_points(G.G2, qs, dev)
    total_ms = cuda_ms(lambda: P.pairing(g1, g2), 3)
    (pa, _), (qa, _) = G.to_affine(G.G1, g1), G.to_affine(G.G2, g2)
    f = P._miller_f_fused(qa, pa)
    x = pack(f)
    easy = T.final_exp_easy(x)
    split = (cuda_ms(lambda: (G.to_affine(G.G1, g1), G.to_affine(G.G2, g2)), 3),
             cuda_ms(lambda: P._miller_f_fused(qa, pa), 3),
             cuda_ms(lambda: T.fq12_final_exponentiation(f), 3),
             cuda_ms(lambda: T.final_exp_easy(x), 3),
             cuda_ms(lambda: T.final_exp_hard(easy), 3))
    print(f"pairing B={N_MAIN}: {total_ms:.2f} ms = {N_MAIN / total_ms * 1e3:.0f} pairings/s; "
          f"to_affine {split[0]:.2f} ms, Miller {split[1]:.2f} ms, final exp {split[2]:.2f} ms "
          f"(easy part {split[3]:.2f} ms, hard part {split[4]:.2f} ms) [{card}]", flush=True)

    checks = []
    require(torch.equal(x, frobenius_tail_route(qa, pa, checks)),
            "the one-launch Miller layer differs from the 85-kind kernel + Frobenius tail route")
    for name, got, want in checks:
        err = KC.max_abs_err(got, want)
        require(err == 0, f"{name} on the Frobenius tail route differs from its plain version "
                          f"by {err}")
        records[name]["max_abs_err"] = max(records[name]["max_abs_err"], err)
    old_ms = cuda_ms(lambda: frobenius_tail_route(qa, pa), 3)
    sched_ms = cuda_ms(lambda: FU.miller_precompute(pack(qa), pack(pa), P._PRE_KINDS), 3)
    print(f"Miller B={N_MAIN}: one launch over 87 kinds = the 85-kind kernel + Frobenius bases "
          f"+ 2 one-step additions and folds on all lanes (those steps = their plain versions, "
          f"max_abs_err 0); one launch {split[1]:.2f} ms, old route {old_ms:.2f} ms (its "
          f"85-kind launch {sched_ms:.2f} ms) [{card}]", flush=True)
    busy = device_busy(lambda: P.pairing(g1, g2))
    print(f"pairing B={N_MAIN} under torch.profiler: {busy[0]} CUDA kernels and {busy[1]} "
          f"copies or sets a call, device busy {100 * busy[2]:.1f} % of the call's span "
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
    from bn254_tpu_torch import api as A
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
    for K, (ops, gen), cls in ((G.G1, SG.G1_PARAMS[:2], A.G1), (G.G2, SG.G2_PARAMS[:2], A.G2)):
        g = (gen[0], gen[1], ops.one)
        pts = [SG.scalar_mul(g, rnd.randrange(1, R), ops) for _ in range(64)]
        pts[3] = None
        ks = [rnd.randrange(R) for _ in range(64)]
        ks[4], ks[5] = 0, R - 1
        pts[6] = pts[10]
        small[K] = (pts, ks, [cls.zero() if p is None else cls._wrap(p) for p in pts],
                    [A.Fr(k) for k in ks])

    counts.reset()
    torch.cuda.synchronize()
    out = {K: M.msm(K, pts, k) for K, (pts, k, _, _) in inputs.items()}
    small_out = {K: (BA.msm_g1 if K is G.G1 else BA.msm_g2)(objs, frs)
                 for K, (_, _, objs, frs) in small.items()}
    torch.cuda.synchronize()
    launches, plain = dict(counts.launches), dict(counts.plain_calls)

    for K, (_, _, mult, ks) in inputs.items():
        ops, gen = (SG.G1_PARAMS if K is G.G1 else SG.G2_PARAMS)[:2]
        total = sum(k * a for k, a in zip(ks, mult)) % R
        want = SG.scalar_mul((gen[0], gen[1], ops.one), total, ops)
        got = G.decode_points(K, out[K])[0]
        require(SG.eq(got, want, ops),
                f"msm G{K.COORDS} n={len(mult)} differs from (sum k_i a_i) G")
        pts, ks, _, _ = small[K]
        want = SG.zero(ops)
        for p, k in zip(pts, ks):
            if p is not None:
                want = SG.add(want, SG.scalar_mul(p, k, ops), ops)
        require(SG.eq(small_out[K].p, want, ops),
                f"64-point msm G{K.COORDS} over the API's objects differs from the spec")
    print(f"MSM path: G1 n={MSM_SIZES[1]} and G2 n={MSM_SIZES[2]} = (sum k_i a_i) G; "
          f"64-point G1 and G2 MSMs over the API's objects = spec sums", flush=True)
    require(launches["msm_combine"] == len(out) + len(small_out),
            f"{launches['msm_combine']} Horner + lane fold calls for "
            f"{len(out) + len(small_out)} MSMs")
    require(launches["to_affine"] == len(out) + len(small_out),
            f"{launches['to_affine']} to_affine launches for {len(out) + len(small_out)} MSMs")
    return check_launches("MSM", counts.MSM_PATH, launches, plain,
                          absent=("point_add", "point_double", "fq2_mul")
                          + counts.TO_AFFINE_ONE_OPS), inputs


def prepare_split(K, pts, ks, c):
    """ms of ``msm.prepare`` on these inputs, then of its three parts on
    their own: the pad to whole lanes, the signed digits and ``to_affine``
    (CUDA events, mean of 3 after a warm-up); the rest is the pack of the
    padded points and the digits' infinity select."""
    from bn254_tpu_torch import fused as FU
    from bn254_tpu_torch import msm as M
    from bn254_tpu_torch.convert import pack

    padded, scalars = M._pad(K, pts, ks, M.LANES)
    xyz = pack(padded)
    nwindows = (254 + 1 + c - 1) // c
    return (cuda_ms(lambda: M.prepare(K, pts, ks, c), 3),
            cuda_ms(lambda: M._pad(K, pts, ks, M.LANES), 3),
            cuda_ms(lambda: M._signed_digits(M._digits_any_c(scalars, c, nwindows), c), 3),
            cuda_ms(lambda: FU.to_affine(K.COORDS, xyz), 3))


def phase_msm_timing(inputs, card):
    """ms per MSM, points/s, the split into its three steps and of the
    accumulate into its four; the accumulate, the bucket sort and the
    bucket reduce on the path's own inputs against their plain versions
    (tolerance 0), timed beside their bounds.  Returns {ncoords: {kernel
    name: record}}."""
    from bn254_tpu_torch import fused as FU
    from bn254_tpu_torch import kernel_cases as KC
    from bn254_tpu_torch import msm as M
    from bn254_tpu_torch.convert import pack

    records = {}
    for K, (pts, ks, _, _) in inputs.items():
        n, c, nc, lanes = ks.shape[-1], M.MSM_FUSED_WINDOW[K.COORDS], K.COORDS, M.LANES
        nb = (1 << (c - 1)) + 1
        total = cuda_ms(lambda: M.msm(K, pts, ks), 3)
        packed, dgs = M.prepare(K, pts, ks, c)
        acc = lambda: FU.msm_accumulate(nc, packed, dgs, nb, lanes=lanes)
        totals = acc()
        prep = prepare_split(K, pts, ks, c)
        split = (prep[0], cuda_ms(acc, 3), cuda_ms(lambda: FU.msm_combine(nc, totals, c), 3))
        offsets, order = FU.msm_bucket_sort(dgs, nb, True, lanes)
        words = FU.msm_point_words(packed)
        buckets = FU._msm_buckets(nc, words, dgs, offsets, order, nb, True, lanes)
        steps = (cuda_ms(lambda: FU.msm_bucket_sort(dgs, nb, True, lanes), 3),
                 cuda_ms(lambda: FU.msm_point_words(packed), 3),
                 cuda_ms(lambda: FU._msm_buckets(nc, words, dgs, offsets, order, nb, True,
                                                 lanes), 3),
                 cuda_ms(lambda: FU.msm_bucket_reduce(nc, buckets), 3))
        bound, by = KC.bound_ms(*KC.msm_work(nc, packed, dgs, nb, True, lanes))
        print(f"msm G{nc} n={n} c={c} lanes={lanes}: {total:.2f} ms = "
              f"{n / total * 1e3:.0f} points/s; prepare {split[0]:.2f} ms (pad {prep[1]:.4f} + "
              f"digits {prep[2]:.4f} + to_affine {prep[3]:.4f} ms on their own), accumulate "
              f"{split[1]:.2f} ms (bound {bound:.2f} ms, {by}), Horner + fold "
              f"{split[2]:.2f} ms; accumulate = sort {steps[0]:.4f} + point words "
              f"{steps[1]:.4f} + buckets {steps[2]:.4f} + reduce {steps[3]:.4f} ms [{card}]",
              flush=True)
        want, plain_ms = cuda_once(lambda: FU.msm_accumulate_plain(nc, packed, dgs, nb,
                                                                    lanes=lanes))
        checks = [("msm_accumulate", totals, want, plain_ms, split[1], (bound, by))]
        xyz = pack(M._pad(K, pts, ks, lanes)[0])
        want, plain_ms = cuda_once(lambda: FU.to_affine_plain(nc, xyz))
        checks.append(("to_affine", FU.to_affine(nc, xyz), want, plain_ms,
                       cuda_ms(lambda: FU.to_affine(nc, xyz), 3),
                       KC.bound_ms(*KC.to_affine_work(nc, xyz))))
        want, plain_ms = cuda_once(lambda: FU.msm_bucket_sort_plain(dgs, nb, True, lanes))
        checks.append(("msm_bucket_sort", (offsets, order), want, plain_ms, steps[0],
                       KC.bound_ms(*KC.sort_work(dgs, nb, True, lanes))))
        want, plain_ms = cuda_once(lambda: FU.msm_bucket_reduce_plain(nc, buckets))
        checks.append(("msm_bucket_reduce", FU.msm_bucket_reduce(nc, buckets), want, plain_ms,
                       steps[3], KC.bound_ms(*KC.reduce_work(nc, buckets))))
        want, plain_ms = cuda_once(lambda: FU.msm_combine_plain(nc, totals, c))
        checks.append(("msm_combine", FU.msm_combine(nc, totals, c), want, plain_ms, split[2],
                       KC.bound_ms(*KC.combine_work(nc, totals, c))))
        records[nc] = {}
        for name, got, want, plain_ms, ms, (b_ms, b_by) in checks:
            err = KC.max_abs_err(got, want)
            require(err == 0, f"{name}[g{nc}] on the MSM path's inputs (n={n}) "
                              f"differs from its plain version by {err}")
            depth = (f", serial depth {KC.combine_depth(nc, totals, c):.0f} products"
                     if name == "msm_combine" else
                     f", serial depth {KC.to_affine_depth(nc, xyz):.0f} products"
                     if name == "to_affine" else "")
            print(f"kernel {name}[g{nc}] on the path's inputs n={n}: max_abs_err 0; "
                  f"kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, bound {b_ms:.4f} ms "
                  f"({b_by}){depth} [{card}]", flush=True)
            if name != "to_affine":     # its record keeps the pairing's 16384 lanes (phase 2)
                records[nc][name] = {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
                                     "bound_ms": b_ms, "bound_by": b_by}
        if nc == 1:     # the worst case at the path's size (held at n = 16384 in phase 2)
            one = torch.where(dgs[:, :1] == 0, nb - 1, dgs[:, :1])
            skew = torch.where(dgs == 0, 0, one)        # infinity points keep digit 0
            s_off, s_ord = FU.msm_bucket_sort(skew, nb, True, lanes)
            s_ms = (cuda_ms(lambda: FU.msm_accumulate(nc, packed, skew, nb, lanes=lanes), 3),
                    cuda_ms(lambda: FU._msm_buckets(nc, words, skew, s_off, s_ord, nb, True,
                                                    lanes), 3))
            print(f"msm_accumulate[g1,skew] on the path's points n={n}, every nonzero digit of "
                  f"a window in one bucket: {s_ms[0]:.4f} ms, buckets {s_ms[1]:.4f} ms "
                  f"(random digits: {split[1]:.4f}, {steps[2]:.4f}) [{card}]", flush=True)
    return records


GLV_N = 32768          # benches/api.py:51's default batch for g1_mul_glv / g2_mul_glv


def phase_glv(dev):
    """The GLV path once per group, with the counters reset around it:
    ``glv.scalar_mul_glv`` on GLV_N points (msm_inputs' points and edges,
    plus k = 1, lambda, r - lambda) and ``batch.scalar_mul_g1`` on 64
    points.  Returns (launches, inputs)."""
    import numpy as np
    from bn254_tpu_torch import api as A
    from bn254_tpu_torch import batch as BA
    from bn254_tpu_torch import convert, counts
    from bn254_tpu_torch import glv as GLV
    from bn254_tpu_torch import groups as G
    from bn254_tpu_torch import msm as M
    from bn254_tpu_torch.spec import group as SG
    from bn254_tpu_torch.spec.constants import R

    rng = np.random.default_rng(SEED + 4)
    inputs = {}
    for K in (G.G1, G.G2):
        pts, _, mult, ks = msm_inputs(K, dev, GLV_N, rng)
        for j, k in zip((10, 11, 12), (1, GLV.LAMBDA, R - GLV.LAMBDA)):
            ks[j] = k
        inputs[K] = (pts, M.encode_scalars(ks, dev), mult, ks)
    rnd = random.Random(SEED + 5)
    ops1, gen1 = SG.G1_PARAMS[:2]
    g1 = (gen1[0], gen1[1], ops1.one)
    small_p = [SG.scalar_mul(g1, rnd.randrange(1, R), ops1) for _ in range(64)]
    small_k = [rnd.randrange(R) for _ in range(64)]
    small_p[3], small_k[4], small_k[5], small_k[6] = None, 0, R - 1, GLV.LAMBDA

    counts.reset()
    torch.cuda.synchronize()
    out = {K: GLV.scalar_mul_glv(K, pts, k) for K, (pts, k, _, _) in inputs.items()}
    small_out = BA.scalar_mul_g1([A.G1.zero() if p is None else A.G1._wrap(p) for p in small_p],
                                 [A.Fr(k) for k in small_k])
    torch.cuda.synchronize()
    launches, plain = dict(counts.launches), dict(counts.plain_calls)

    for K, (pts, k, mult, ks) in inputs.items():
        nc = K.COORDS
        ops, gen = (SG.G1_PARAMS if nc == 1 else SG.G2_PARAMS)[:2]
        same = G.eq_points(K, out[K], G.scalar_mul(K, pts, k))
        require(bool(same.all()), f"GLV G{nc}: {int((~same).sum())} of {GLV_N} lanes differ "
                                  f"from the double-and-add")
        lanes = [0, 1, 2, GLV_N // 2, GLV_N - 3, GLV_N // 3 + 1, GLV_N // 7, GLV_N - 5] + \
            [7, 8, 9, 10, 11, 12, GLV_N // 3, GLV_N // 2, GLV_N // 5, GLV_N - 2, GLV_N - 1]
        got = G.decode_points(K, convert.tree_map(lambda c: c[:, lanes], out[K]))
        for g, lane in zip(got, lanes):
            want = SG.scalar_mul((gen[0], gen[1], ops.one), ks[lane] * mult[lane] % R, ops)
            require(SG.eq(g, want, ops), f"GLV G{nc} lane {lane} differs from the spec")
    for p, k, g in zip(small_p, small_k, small_out):
        want = SG.zero(ops1) if p is None else SG.scalar_mul(p, k, ops1)
        require(SG.eq(g.p, want, ops1), "batch.scalar_mul_g1 differs from the spec")
    print(f"GLV path: G1 and G2 at B={GLV_N}, every lane = double-and-add, "
          f"{len(lanes)} lanes (edges: infinity, k = 0, 1, r - 1, lambda, r - lambda) = spec; "
          f"batch.scalar_mul_g1 on 64 API objects = spec", flush=True)
    return check_launches("GLV", counts.GLV_PATH, launches, plain), inputs


def phase_glv_timing(inputs, card, records):
    """Each kernel of the GLV path on the path's own inputs against its
    plain version (tolerance 0): beta x on mont_mul, p1 + p2 on point_add,
    the ladder; ms per call and scalar-muls/s, split into decompose +
    table and the ladder beside its bound.  The kernels line takes row
    20's times from the G1 inputs."""
    from bn254_tpu_torch import fused as FU
    from bn254_tpu_torch import glv as GLV
    from bn254_tpu_torch import kernel_cases as KC
    from bn254_tpu_torch import limbs as L
    from bn254_tpu_torch import mont_kernels as MK
    from bn254_tpu_torch.convert import pack
    from bn254_tpu_torch.fields import FQ

    for K, (pts, k, _, _) in inputs.items():
        nc = K.COORDS
        beta = FQ.const(GLV.BETA_G1 if nc == 1 else GLV.BETA_G2, GLV_N, pts[0][0].device)
        p1, p2, _ = GLV.signed_points(K, pts, k)
        a, b = pack(p1), pack(p2)
        table, digits = GLV.prepare(K, pts, k)
        checks = [("mont_mul", MK.mont_mul(x, beta, MK.FQ_MOD), L.mont_mul(x, beta, MK.FQ_MOD))
                  for x in ((pts[0],) if nc == 1 else pts[0])]
        checks.append(("point_add", FU.point_add(nc, a, b), FU.point_add_plain(nc, a, b)))
        got = FU.glv_ladder(nc, table, digits)
        want, plain_ms = cuda_once(lambda: FU.glv_ladder_plain(nc, table, digits))
        checks.append(("glv_ladder", got, want))
        for name, got, want in checks:
            err = KC.max_abs_err(got, want)
            require(err == 0, f"{name}[g{nc}] on the GLV path's inputs differs from its "
                              f"plain version by {err}")
            records[name]["max_abs_err"] = max(records[name]["max_abs_err"], err)
        total = cuda_ms(lambda: GLV.scalar_mul_glv(K, pts, k), 3)
        split = (cuda_ms(lambda: GLV.prepare(K, pts, k), 3),
                 cuda_ms(lambda: FU.glv_ladder(nc, table, digits), 3))
        bound, by = KC.bound_ms(*KC.glv_work(nc, table, digits))
        print(f"glv G{nc} B={GLV_N}: {total:.3f} ms = {GLV_N / total * 1e3:.0f} scalar-muls/s; "
              f"decompose + table {split[0]:.3f} ms, ladder {split[1]:.4f} ms (bound "
              f"{bound:.4f} ms, {by}; serial depth {KC.LADDER_DEPTH} rounds a step, "
              f"{digits.shape[0]} steps); beta x ({len(checks) - 2} mont_mul), p1 + p2 "
              f"(point_add) and the ladder = plain versions bit for bit (ladder plain "
              f"{plain_ms:.1f} ms) [{card}]", flush=True)
        if nc == 1:
            records["glv_ladder"].update({"ms": split[1], "plain_ms": plain_ms,
                                          "bound_ms": bound, "bound_by": by})


def one_step_lines(qa, dev):
    """precompute's 87 lines by the one-op route: rows 14 and 7 chained as
    one-step launches, the Frobenius bases on row 3 (pairing's
    _frobenius_points) -> [87, 6, 16, B]."""
    from bn254_tpu_torch import fused as FU
    from bn254_tpu_torch import pairing_torch as P
    from bn254_tpu_torch import tower as T
    from bn254_tpu_torch.convert import pack

    bases = {1: pack(qa), 2: pack((qa[0], T.fq2_neg(qa[1])))}
    bases.update(zip((3, 4), map(pack, P._frobenius_points(qa))))
    r = pack((qa[0], qa[1], T.fq2_ones(qa[0][0].shape[-1], dev)))
    lines = []
    for kind in P._LINE_KINDS:
        r, line = FU.g2_dbl_step(r) if kind == 0 else FU.g2_add_step(r, bases[int(kind)])
        lines.append(line)
    return torch.stack(lines)


def phase_prepared_miller(dev, ps, qs, card, records):
    """precompute + miller_loop (the prepared-G2 entry) on the pairing's
    pairs, with the counters reset around it: one g2_precompute launch and
    one miller_loop launch; all 87 lines of every lane equal to the one-op
    route's (rows 14 and 7 chained) and 4 lanes' to the spec's, and the
    loop's result to the fused Miller loop's, limb for limb.  Then the
    line and loop kernels against their plain versions on the path's own
    inputs, at tolerance 0, and both kernels timed beside their bounds.
    Returns its launches."""
    from bn254_tpu_torch import convert, counts
    from bn254_tpu_torch import fused as FU
    from bn254_tpu_torch import groups as G
    from bn254_tpu_torch import kernel_cases as KC
    from bn254_tpu_torch import pairing_torch as P
    from bn254_tpu_torch import tower as T
    from bn254_tpu_torch.convert import pack
    from bn254_tpu_torch.spec import group as SG

    (pa, _), (qa, _) = (G.to_affine(G.G1, G.encode_points(G.G1, ps, dev)),
                        G.to_affine(G.G2, G.encode_points(G.G2, qs, dev)))
    fused = P._miller_f_fused(qa, pa)
    counts.reset()
    torch.cuda.synchronize()
    coeffs = P.precompute(qa)
    f = P.miller_loop(coeffs, pa)
    torch.cuda.synchronize()
    launches, plain = dict(counts.launches), dict(counts.plain_calls)

    require(all(torch.equal(a, b) for a, b in zip(convert.tree_leaves(f),
                                                  convert.tree_leaves(fused))),
            "precompute + miller_loop differs from the fused Miller loop")
    c = torch.stack(convert.tree_leaves(coeffs), 1)          # [87, 6, 16, B]
    require(torch.equal(c, one_step_lines(qa, dev)),
            "precompute's lines differ from the one-op route's (rows 14 and 7 chained)")
    ops2 = SG.G2_PARAMS[0]
    lanes = [0, 1, N_MAIN // 2, N_MAIN - 1]
    sub = convert.tree_map(lambda c: c[:, :, lanes], coeffs)
    for j, lane in enumerate(lanes):
        got = [tuple(T.fq2_decode(tuple(c[i] for c in ell))[j] for ell in sub)
               for i in range(87)]
        require(got == SG.precompute(SG.to_affine(qs[lane], ops2)),
                f"prepared G2 lane {lane}: coefficients differ from the spec")
    times = (cuda_ms(lambda: P.precompute(qa), 3), cuda_ms(lambda: P.miller_loop(coeffs, pa), 3),
             cuda_ms(lambda: P._miller_f_fused(qa, pa), 3),
             cuda_ms(lambda: one_step_lines(qa, dev), 3))
    print(f"prepared Miller B={N_MAIN}: miller_loop(precompute) = fused Miller loop limb for "
          f"limb; 87 lines of every lane = one-op route, of 4 lanes = spec; precompute "
          f"{times[0]:.2f} ms (one-op route {times[3]:.2f} ms), miller_loop {times[1]:.2f} ms "
          f"(fused Miller loop {times[2]:.2f} ms) [{card}]", flush=True)

    # the kernels on the path's own inputs: the lines on the pairs' Q, the
    # loop on precompute's lines
    (px, py), line_args = pa, (pack(qa), P._LINE_KINDS)
    args = (c, px, py, P._SQR_FLAGS)
    checks = [("g2_precompute", c, FU.g2_precompute_plain(*line_args)),
              ("miller_loop", FU.miller_loop(*args), FU.miller_loop_plain(*args))]
    for name, got, want in checks:
        err = KC.max_abs_err(got, want)
        require(err == 0, f"{name} on the prepared-Miller path differs from its plain "
                          f"version by {err}")
        records[name]["max_abs_err"] = max(records[name]["max_abs_err"], err)
    timed = []
    for name, fn, work in (("g2_precompute", lambda: FU.g2_precompute(*line_args),
                            KC.lines_work(*line_args)),
                           ("miller_loop", lambda: FU.miller_loop(*args), KC.loop_work(*args))):
        bound, by = KC.bound_ms(*work)
        timed.append(f"{name} kernel {cuda_ms(fn, 10):.4f} ms (bound {bound:.4f} ms, {by})")
    print(f"prepared Miller B={N_MAIN}: g2_precompute kernel = plain version on the pairs' Q, "
          f"miller_loop kernel = plain version on precompute's lines (max_abs_err 0); "
          f"{'; '.join(timed)} [{card}]", flush=True)
    return check_launches("prepared-Miller", counts.PREPARED_MILLER_PATH, launches, plain,
                          absent=("g2_dbl_step", "g2_add_step", "fq2_mul", "fq12_sqr",
                                  "fq12_fold_line"))


def queued_ms(fn, reps: int = 10) -> float:
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


def kernel_device_ms(fn, name: str, reps: int = 10):
    """(mean device ms, count) of the CUDA kernels whose name holds
    `name`, over `reps` calls of fn under torch.profiler after a warm-up
    (one kernel a call); (None, count) where the trace holds fewer."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    us = [e.time_range.end - e.time_range.start for e in prof.events()
          if e.device_type == torch.autograd.DeviceType.CUDA and name in e.name]
    return (sum(us) / reps / 1e3 if len(us) == reps else None), len(us)


def host_us(fn, n: int = 2000) -> float:
    """Host microseconds a call of fn over n calls after a warm-up (the
    enqueue, no synchronize inside)."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(n):
        fn()
    us = (time.perf_counter() - t0) * 1e6 / n
    torch.cuda.synchronize()
    return us


def row15_lines(dev, card):
    """Row 15 (fused.fq2_mul) on the lazy product's column extremes, at
    the one-op batch and at WIDE_B: the event time between back-to-back
    calls, the kernel's device time (torch.profiler) and the bound; then
    the wrapper's host microseconds a call at the one-op batch, split into
    its check, its output's allocation and its launch (the stream read
    among it), beside the two costs the launch path no longer pays."""
    import numpy as np
    from bn254_tpu_torch import _build
    from bn254_tpu_torch import fused as FU
    from bn254_tpu_torch import kernel_cases as KC

    case = next(c for c in KC.CASES if c.label == "fq2_mul_fused")
    for batch in (N_MAIN, WIDE_B):
        a, b = KC.fq2_extremes(np.random.default_rng(SEED), batch, dev)
        event = cuda_ms(lambda: FU.fq2_mul(a, b), 10)
        queued = queued_ms(lambda: FU.fq2_mul(a, b))
        device, traced = kernel_device_ms(lambda: FU.fq2_mul(a, b), "k_fq2_mul_fused")
        prof = (f"{device:.4f} ms" if device is not None
                else f"not measured ({traced} of 10 kernels traced)")
        bound, by = KC.bound_ms(*case.work(a, b))
        print(f"row 15 fq2_mul_fused B={batch}: event {event:.4f} ms a call over 10 "
              f"back-to-back calls, {queued:.4f} ms enqueued behind a device sleep, "
              f"device {prof} (torch.profiler), bound {bound:.4f} ms ({by}) [{card}]",
              flush=True)
    a, b = KC.fq2_extremes(np.random.default_rng(SEED), N_MAIN, dev)
    out = torch.empty_like(a)
    ptrs = (a.data_ptr(), b.data_ptr(), out.data_ptr())
    lib = _build.library()
    split = (("wrapper", lambda: FU.fq2_mul(a, b)),
             ("check", lambda: _build.check("fq2_mul_fused", N_MAIN, a.device, (a, (2,)),
                                            (b, (2,)))),
             ("empty_like", lambda: torch.empty_like(a)),
             ("launch", lambda: _build.launch("fq2_mul_fused", N_MAIN, *ptrs)),
             ("its stream read",
              lambda: torch._C._cuda_getCurrentRawStream(torch._C._cuda_getDevice())),
             ("no longer paid: current_stream().cuda_stream",
              lambda: torch.cuda.current_stream().cuda_stream),
             ("no longer paid: getattr of the entry", lambda: getattr(lib, "bn254_fq2_mul_fused")))
    print(f"row 15 host us a call at B={N_MAIN}: "
          + ", ".join(f"{name} {host_us(fn):.2f}" for name, fn in split) + f" [{card}]",
          flush=True)


def phase_probes(dev, card, records):
    """The probe path once (probe_mont and probe_tower at their defaults),
    with the counters reset around it; every chain and every one-op kernel
    call against its plain version and the Fq chains against spec ints.
    Then row 15's times (row15_lines).  Returns its launches."""
    from bn254_tpu_torch import counts
    from bn254_tpu_torch import kernel_cases as KC
    from bn254_tpu_torch import mont_kernels as MK
    from bn254_tpu_torch import probes as PB
    from bn254_tpu_torch.spec.constants import Q

    counts.reset()
    torch.cuda.synchronize()
    mont, tower = PB.probe_mont(), PB.probe_tower()
    torch.cuda.synchronize()
    launches, plain = dict(counts.launches), dict(counts.plain_calls)

    fq = MK.FQ_MOD
    a, b, chain = mont["a"], mont["b"], mont["chain"]
    av, bv = fq.decode_batch(a[0]), fq.decode_batch(b[0])
    spec = {"mul": [x * pow(y, chain, Q) % Q for x, y in zip(av, bv)],
            "sqr": [pow(x, 1 << chain, Q) for x in av]}
    checks = [(f"chain_mont[{impl}]", rec["out"], PB.chain_mont_plain(impl, a, b, chain))
              for impl, rec in mont["ops"].items()]
    checks += [(f"chain_tower[{op}]", rec["out"],
                PB.chain_tower_plain(op, rec["a"], rec["b"], tower["chain"]))
               for op, rec in tower["ops"].items()]
    # each op's one call as a kernel of its own, on the probe's operands
    checks += [(f"{PB.MONT_ONE_OP[impl].kernel}[{impl}]", rec["one_op_out"],
                PB.MONT_ONE_OP[impl].plain(a, b)) for impl, rec in mont["ops"].items()]
    checks += [(f"{PB.TOWER_ONE_OP[op].kernel}[{op}]", rec["one_op_out"],
                PB.TOWER_ONE_OP[op].plain(rec["a"], rec["b"]))
               for op, rec in tower["ops"].items() if op in PB.TOWER_ONE_OP]
    for label, got, want in checks:
        err = KC.max_abs_err(got, want)
        require(err == 0, f"{label} on the probe path differs from its plain version by {err}")
        name = label.split("[")[0]
        records[name]["max_abs_err"] = max(records[name]["max_abs_err"], err)
    for impl, rec in mont["ops"].items():
        require(fq.decode_batch(rec["out"][0]) == spec[impl],
                f"chain_mont[{impl}] differs from the spec's ints")
    assumed_ns = KC.INSTR_PER_PRODUCT / KC.INT_OPS_PER_S * 1e9
    print(f"probe path: {len(checks)} chains and one-op kernel calls = plain versions bit "
          f"for bit; chain_mont = "
          f"a * b^{chain} and a^(2^{chain}) on all {mont['batch']} lanes [{card}]", flush=True)
    run = {"chain_mont": PB.chain_mont, "chain_tower": PB.chain_tower}
    for name, res in (("chain_mont", mont), ("chain_tower", tower)):
        for op, rec in res["ops"].items():
            a_op, b_op = (rec["a"], rec["b"]) if name == "chain_tower" else (mont["a"], mont["b"])
            queued = queued_ms(lambda: run[name](op, a_op, b_op, res["chain"]))
            one = "none" if rec["one_op_ms"] is None else f"{rec['one_op_ms']:.4f} ms"
            # per product of the work the bound counts (2.5 for the lazy fq2_mul)
            work = res["batch"] * res["chain"] * KC.body_products(op)
            ns, ns_queued = rec["ms"] * 1e6 / work, queued * 1e6 / work
            print(f"probe {name}[{op}] B={res['batch']} chain={res['chain']}: "
                  f"{rec['ms']:.4f} ms = {rec['g_products_per_s']:.2f} G Fq-products/s, "
                  f"{ns:.5f} ns per product of the bound's work (the bound assumes "
                  f"{assumed_ns:.5f}: {KC.INSTR_PER_PRODUCT} instr / INT_OPS_PER_S; measured = "
                  f"{ns / assumed_ns * KC.INSTR_PER_PRODUCT:.0f} instr-equivalents); enqueued "
                  f"behind a device sleep {queued:.4f} ms = {ns_queued:.5f} ns = "
                  f"{ns_queued / assumed_ns * KC.INSTR_PER_PRODUCT:.0f} instr-equivalents; one "
                  f"op as its own kernel {one} [{card}]", flush=True)
    path = check_launches("probe", counts.PROBE_PATH, launches, plain)
    row15_lines(dev, card)
    return path


CODEC_N = 16384        # one pairing batch's worth of each side


def _codec_batch(K, dev, rng):
    """16384 compressed points of msm_inputs' construction (the infinity
    lanes 7, n/3, n - 1 get planted blobs), compressed on the host by the
    port's spec codec, with planted invalid lanes and the golden vectors.
    Returns (blobs, affine limbs (x, y), {lane: the host codec's result or
    None} for the planted and 16 sampled lanes, the planted lanes, the
    planted invalid lanes)."""
    import golden
    from bn254_tpu_torch import groups as G
    from bn254_tpu_torch.errors import BNError
    from bn254_tpu_torch.spec import codec as SC
    from bn254_tpu_torch.spec import field as SF
    from bn254_tpu_torch.spec import group as SG
    from bn254_tpu_torch.spec.constants import B2, Q

    nc = K.COORDS
    pts, _, _, _ = msm_inputs(K, dev, CODEC_N, rng)
    (x, y), inf = G.to_affine(K, pts)
    xs, ys, inf = K.decode(x), K.decode(y), inf.tolist()
    compress = SC.g1_to_compressed if nc == 1 else SC.g2_to_compressed
    blobs = [None if i else compress((a, b)) for a, b, i in zip(xs, ys, inf)]
    valid = blobs[20]
    if nc == 1:
        invalid = [bytes([0x05]) + valid[1:],                 # bad prefix, valid x
                   bytes([0x02]) + b"\x00" * 32,              # x = 0: 3 is a non-residue
                   bytes([0x03]) + Q.to_bytes(32, "big"),     # x = q
                   bytes([0x02]) + b"\xff" * 32,              # x = 2^256 - 1
                   valid[:32], valid + b"\x00"]               # wrong lengths
        goldens = [bytes.fromhex(golden.G1_COMPRESSED_HEX)]
    else:
        off = []                                              # on the twist, off the subgroup
        rnd = random.Random(SEED + 7)
        while len(off) < 2:
            tx = (rnd.randrange(Q), rnd.randrange(Q))
            ty = SF.fq2_sqrt(SF.fq2_add(SF.fq2_mul(SF.fq2_sqr(tx), tx), B2))
            if ty is not None:
                off.append(SC.g2_to_compressed((tx, ty)))
        invalid = [bytes([0x0C]) + valid[1:],                 # bad prefix, valid x
                   bytes([0x0A]) + b"\x00" * 64,              # x = 0
                   bytes([0x0B]) + (Q * Q).to_bytes(64, "big"),   # quotient = q
                   bytes([0x0A]) + b"\xff" * 64,              # quotient > q
                   valid[:64], valid + b"\x00", *off]
        goldens = [bytes.fromhex(h) for h in (golden.G2_COMPRESSED_HEX,
                                              golden.G2_COMPRESSED_HEX_REFLECT,
                                              golden.G2_COMPRESSED_HEX_BADPREFIX)]
    host = SC.g1_from_compressed if nc == 1 else SC.g2_from_compressed

    def expect(blob):
        try:
            return host(blob)
        except BNError:
            return None

    planted = [i for i, p in enumerate(inf) if p]
    planted += [100 + 7 * j for j in range(len(invalid) + len(goldens) - len(planted))]
    expected = {}
    for lane, blob in zip(planted, invalid + goldens):
        blobs[lane] = blob
        expected[lane] = expect(blob)
    require(None not in blobs, f"G{nc}: a lane at infinity has no planted blob")
    bad = planted[:len(invalid)]
    require(all(expected[lane] is None for lane in bad),
            f"G{nc}: a planted invalid blob decodes on the host")
    for lane in random.Random(SEED + 8).sample(range(CODEC_N), 16):
        expected.setdefault(lane, expect(blobs[lane]))
    return blobs, (x, y), expected, planted, bad


def phase_codec(dev, card, records):
    """The decompression path once per group, with the counters reset
    around it, checked lane by lane; then decompressions/s and its split,
    and the fq2_sqrt kernel held to its plain version on the path's own
    x^3 + b2.  Returns its launches."""
    import numpy as np
    from bn254_tpu_torch import codec_device as CD
    from bn254_tpu_torch import convert, counts
    from bn254_tpu_torch import fused as FU
    from bn254_tpu_torch import groups as G
    from bn254_tpu_torch import kernel_cases as KC
    from bn254_tpu_torch import tower as T
    from bn254_tpu_torch.fields import FQ

    rng = np.random.default_rng(SEED + 6)
    t0 = time.perf_counter()
    batches = {K: _codec_batch(K, dev, rng) for K in (G.G1, G.G2)}
    print(f"codec inputs: {CODEC_N} G1 and {CODEC_N} G2 points built, made affine and "
          f"compressed in {time.perf_counter() - t0:.1f} s", flush=True)
    entry = {G.G1: CD.g1_from_compressed_batch, G.G2: CD.g2_from_compressed_batch}

    counts.reset()
    torch.cuda.synchronize()
    out = {K: entry[K](blobs) for K, (blobs, *_) in batches.items()}
    torch.cuda.synchronize()
    launches, plain = dict(counts.launches), dict(counts.plain_calls)

    for K, (blobs, (x, y), expected, planted, bad) in batches.items():
        nc = K.COORDS
        (px, py, pz), ok = out[K]
        one = convert.pack(K.ones(CODEC_N, dev))
        valid = torch.ones(CODEC_N, dtype=torch.bool, device=dev)
        valid[planted] = False
        same = lambda a, b: (convert.pack(a) == convert.pack(b)).flatten(0, -2).all(0)
        rt = same(px, x) & same(py, y) & (convert.pack(pz) == one).flatten(0, -2).all(0)
        require(bool((ok | ~valid).all()) and bool((rt | ~valid).all()),
                f"G{nc}: {int((valid & ~(ok & rt)).sum())} valid lanes do not round-trip")
        require(not bool(ok[bad].any()), f"G{nc}: a planted invalid lane is not masked off")
        lanes = sorted(expected)
        got = G.decode_points(K, convert.tree_map(lambda c: c[:, lanes], (px, py, pz)))
        oks = ok[lanes].tolist()
        z1 = 1 if nc == 1 else (1, 0)
        for lane, g, o in zip(lanes, got, oks):
            want = expected[lane]
            require(o == (want is not None) and (want is None or g == (*want, z1)),
                    f"G{nc} lane {lane} differs from the host codec")
        print(f"codec G{nc}: {CODEC_N} lanes, {int(ok.sum())} valid, every valid lane "
              f"round-trips to its affine limbs (z = 1); {len(bad)} planted invalid lanes masked off; "
              f"{len(lanes)} sampled and planted lanes = host codec", flush=True)
    require(launches["point_mul"] == 1,
            f"{launches['point_mul']} point_mul launches for one G2 decompression call")
    require(launches["fq2_sqrt"] == 1 and launches["fq2_sqr"] == launches["fq2_mul"] == 1,
            f"the G2 square root: {launches['fq2_sqrt']} fq2_sqrt, {launches['fq2_sqr']} "
            f"fq2_sqr and {launches['fq2_mul']} fq2_mul launches for one G2 call (want 1 each: "
            f"the kernel, and g2_rhs's x^2 and x^2 x)")
    launches = check_launches("codec", counts.CODEC_PATH, launches, plain,
                              absent=("point_add", "point_double"))

    for K, (blobs, *_) in batches.items():
        nc = K.COORDS
        entry[K](blobs)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(3):
            entry[K](blobs)
        torch.cuda.synchronize()
        total = (time.perf_counter() - t0) / 3 * 1e3
        parse = CD.parse_g1_compressed if nc == 1 else CD.parse_g2_compressed
        t0 = time.perf_counter()
        for _ in range(3):
            pre, xs, _ = parse(blobs, dev)
        torch.cuda.synchronize()
        parse_ms = (time.perf_counter() - t0) / 3 * 1e3
        if nc == 1:
            y, _ = FQ.sqrt(CD.g1_rhs(xs))
            split = (cuda_ms(lambda: FQ.sqrt(CD.g1_rhs(xs)), 3),
                     cuda_ms(lambda: CD.g1_select_y(pre, y), 3), None)
        else:
            y, _ = T.fq2_sqrt(CD.g2_rhs(xs))
            pt = G.to_jacobian(G.G2, (xs, CD.g2_select_y(pre, y)))
            split = (cuda_ms(lambda: T.fq2_sqrt(CD.g2_rhs(xs)), 3),
                     cuda_ms(lambda: CD.g2_select_y(pre, y), 3),
                     cuda_ms(lambda: CD.g2_in_subgroup(pt), 3))
        sub = "" if split[2] is None else f", subgroup check {split[2]:.2f} ms"
        if nc == 2:
            rhs = convert.pack(CD.g2_rhs(xs))
            err = KC.max_abs_err(FU.fq2_sqrt(rhs), FU.fq2_sqrt_plain(rhs))
            require(err == 0, f"fq2_sqrt on the codec's inputs differs from its plain "
                              f"version by {err}")
            records["fq2_sqrt"]["max_abs_err"] = max(records["fq2_sqrt"]["max_abs_err"], err)
            print(f"kernel fq2_sqrt on the codec's inputs n={CODEC_N}: max_abs_err 0", flush=True)
            bound, by = KC.bound_ms(*KC.fq2_sqrt_work(rhs))
            sub += (f"; the fq2_sqrt kernel alone {cuda_ms(lambda: FU.fq2_sqrt(rhs), 3):.4f} ms "
                    f"(bound {bound:.4f} ms, {by})")
        print(f"codec G{nc} B={CODEC_N}: {total:.2f} ms = {CODEC_N / total * 1e3:.0f} "
              f"decompressions/s; host parse {parse_ms:.2f} ms, sqrt {split[0]:.2f} ms, "
              f"y selection {split[1]:.2f} ms{sub} [{card}]", flush=True)
    return launches


INV_N = 10000          # tests/test_reference_scale.py's sweeps (fields/tests.rs:4-21, :88-95)
INV_FQ2_N = 2000


def inversion_checks(dev, n: int = INV_N, n_fq2: int = INV_FQ2_N):
    """The reference-scale inversion sweeps on the port's own inversions
    (fields.FQ.inv, FR.inv, tower.fq2_inv), each one batched call:
    [(label, inputs, the kernels it launches, check)], check(*inputs) a
    bool mask over the lanes.  Fq's inverse is one fq_pow launch, Fr's a
    loop of mont_sqr and mont_mul launches; the checks' products are
    mont_mul (Fq2: fq2_mul)."""
    from bn254_tpu_torch import tower as T
    from bn254_tpu_torch.fields import FQ, FR
    from bn254_tpu_torch.spec.constants import Q

    checks = []
    rng = random.Random(0x1234)
    for name, F in (("fq", FQ), ("fr", FR)):
        p, inv = F.p, (("fq_pow",) if F is FQ else ("mont_sqr", "mont_mul"))
        prod = ("fq_pow", "mont_mul") if F is FQ else inv     # the inverse and the products
        up_down = F.encode(list(range(1, n + 1)) + [p - k for k in range(1, n + 1)], dev)
        checks.append((f"{name}: a = 1..{n}, -1..-{n}: a a^-1 = 1", (up_down,),
                       prod,
                       lambda a, F=F: F.eq(F.mul(a, F.inv(a)), F.ones(a.shape[-1], a.device))))
        checks.append((f"{name}: 0^-1 = 0", (F.zeros(4, dev),), inv,
                       lambda z, F=F: F.is_zero(F.inv(z))))
        a = F.encode([rng.randrange(1, p) for _ in range(n)], dev)
        b = F.encode([rng.randrange(p) for _ in range(n)], dev)

        def law(a, b, F=F):
            inv_a = F.inv(a)
            return (F.eq(F.mul(inv_a, a), F.ones(a.shape[-1], a.device))
                    & F.eq(F.mul(F.mul(a, b), inv_a), b))

        checks.append((f"{name}: {n} random a: a^-1 a = 1, (a b) a^-1 = b", (a, b),
                       prod, law))
    # a + i, a - i and a + (3k + 1) i for a = 1..n_fq2, -1..-n_fq2
    c0 = list(range(1, n_fq2 + 1)) + [Q - k for k in range(1, n_fq2 + 1)]
    c1 = [1] * len(c0) + [Q - 1] * len(c0) + [3 * k + 1 for k in range(len(c0))]
    x = T.fq2_encode(zip(c0 * 3, c1), dev)
    checks.append((f"fq2: a + i, a - i, a + (3k + 1) i for a = 1..{n_fq2}, -1..-{n_fq2}: "
                   f"a a^-1 = 1", x, ("mont_sqr", "fq_pow", "mont_mul", "fq2_mul"),
                   lambda x0, x1: T.fq2_eq(T.fq2_mul((x0, x1), T.fq2_inv((x0, x1))),
                                           T.fq2_ones(x0.shape[-1], x0.device))))
    checks.append(("fq2: 0^-1 = 0", T.fq2_zeros(4, dev), ("mont_sqr", "fq_pow", "mont_mul"),
                   lambda x0, x1: T.fq2_is_zero(T.fq2_inv((x0, x1)))))
    return checks


def phase_inversions(dev, card):
    """The inversion sweeps on the card (inversion_checks), each with the
    counters reset around it: every lane must hold, the check must launch
    exactly its kernels and no plain version.  Returns the launches of
    all the checks."""
    from bn254_tpu_torch import counts

    total = dict.fromkeys(counts.KERNELS, 0)
    for label, inputs, kernels, check in inversion_checks(dev):
        counts.reset()
        ok, ms = cuda_once(lambda: check(*inputs))
        launches, plain = dict(counts.launches), dict(counts.plain_calls)
        lanes = inputs[0].shape[-1]
        require(ok.shape == (lanes,) and bool(ok.all()),
                f"inversion {label}: {int((~ok).sum())} of {lanes} lanes fail")
        ran = {k: v for k, v in launches.items() if v}
        require(sorted(ran) == sorted(kernels) and not any(plain.values()),
                f"inversion {label}: launched {ran} and plain versions "
                f"{ {k: v for k, v in plain.items() if v} }, want {kernels} and none")
        print(f"inversion {label}: all {lanes} lanes hold, {ms:.2f} ms; launched "
              f"{json.dumps(ran)} [{card}]", flush=True)
        for k, v in ran.items():
            total[k] += v
    return total


API_N = N_MAIN         # pairs of the api phase: one Miller launch's worth


def api_pairs(dev, n: int = API_N):
    """n pairs (a_i P, b_i Q) as the API's objects: the G1 points by
    batch.scalar_mul_g1, the G2 points by glv.scalar_mul_glv, P and Q
    multiples of the generators; infinity planted in the G1 slot, the G2
    slot or both on a few lanes, the first and the last among them.
    Returns (pairs, P, Q, a, b, the planted lanes)."""
    from bn254_tpu_torch import api as A
    from bn254_tpu_torch import batch as BA
    from bn254_tpu_torch import glv as GLV
    from bn254_tpu_torch import groups as G
    from bn254_tpu_torch import msm as M
    from bn254_tpu_torch.spec.constants import R

    rng = random.Random(SEED + 9)
    p, q = A.G1.one() * A.Fr(rng.randrange(1, R)), A.G2.one() * A.Fr(rng.randrange(1, R))
    a = [rng.randrange(1, R) for _ in range(n)]
    b = [rng.randrange(1, R) for _ in range(n)]
    g1 = BA.scalar_mul_g1([p] * n, [A.Fr(k) for k in a], device=dev)
    g2 = GLV.scalar_mul_glv(G.G2, G.encode_points(G.G2, [q.p] * n, dev),
                            M.encode_scalars(b, dev))
    g2 = [A.G2._wrap(x) for x in G.decode_points(G.G2, g2)]
    g1_inf, g2_inf = {0, 1, n // 2, n - 2}, {n - 1, 2, n // 2}
    for i in g1_inf:
        g1[i] = A.G1.zero()
    for i in g2_inf:
        g2[i] = A.G2.zero()
    return list(zip(g1, g2)), p, q, a, b, sorted(g1_inf | g2_inf)


def phase_api(dev, card, n: int = API_N):
    """The batched API over the scalar API's objects, with the counters
    reset around it: batch.pairing_batch on n pairs with planted infinity
    against e(P, Q)^(sum a_i b_i) over the finite lanes (the host spec
    API), once more cut into 3 chunks (the same Gt); batch.pairing_each
    on 64 sampled lanes (the planted ones among them) against
    api.pairing, and the product of all its results against
    pairing_batch.  Then pairing_batch's ms (CUDA events), its device part
    on tensors and the host conversion (objects -> tensors, tensors ->
    Gt).  Returns its launches."""
    from bn254_tpu_torch import api as A
    from bn254_tpu_torch import batch as BA
    from bn254_tpu_torch import counts
    from bn254_tpu_torch import pairing_torch as P
    from bn254_tpu_torch import tower as T
    from bn254_tpu_torch.spec.constants import R

    pairs, p, q, a, b, planted = api_pairs(dev, n)
    finite = [i for i in range(n) if i not in planted]
    want = A.pairing(p, q).pow(A.Fr(sum(a[i] * b[i] for i in finite) % R))
    sample = sorted(set(planted)
                    | set(random.Random(SEED + 10).sample(finite, 64 - len(planted))))
    chunk = BA.PAIRING_CHUNK

    counts.reset()
    torch.cuda.synchronize()
    got = BA.pairing_batch(pairs, device=dev)
    BA.PAIRING_CHUNK = -(-n // 3)
    try:
        got3 = BA.pairing_batch(pairs, device=dev)
    finally:
        BA.PAIRING_CHUNK = chunk
    each = BA.pairing_each(pairs, device=dev)
    torch.cuda.synchronize()
    launches, plain = dict(counts.launches), dict(counts.plain_calls)

    require(got == want, f"batch.pairing_batch on {n} pairs differs from e(P, Q)^(sum a_i b_i)")
    require(got3 == got, "batch.pairing_batch in 3 chunks differs from one chunk")
    require(len(each) == n, f"batch.pairing_each returned {len(each)} of {n}")
    for i in sample:
        require(each[i] == A.pairing(*pairs[i]), f"batch.pairing_each lane {i} differs from "
                                                 f"api.pairing")
    prod = A.Gt.one()
    for g in each:
        prod = prod * g
    require(prod == got, "the product of batch.pairing_each differs from batch.pairing_batch")
    print(f"api: batch.pairing_batch on {n} pairs ({len(planted)} with infinity planted) = "
          f"e(P, Q)^(sum a_i b_i) over the finite lanes (host spec), = its 3-chunk split; "
          f"batch.pairing_each on {len(sample)} sampled lanes = api.pairing, its product = "
          f"pairing_batch", flush=True)
    require(launches["miller_precompute"] == 1 + 3 + 1,
            f"{launches['miller_precompute']} Miller launches for 5 chunks of pairs")
    launches = check_launches("api", counts.PAIRING_PATH, launches, plain,
                              absent=counts.TO_AFFINE_ONE_OPS + counts.FROBENIUS_TAIL_ONE_OPS)

    g1, g2 = BA.pairs_in(pairs, dev)
    total = cuda_ms(lambda: BA.pairing_batch(pairs, device=dev), 3)
    device = cuda_ms(lambda: T.fq12_final_exponentiation(P.miller_loop_batch(g2, g1)), 3)
    f, host = P.pairing(g1, g2), []
    for fn in (lambda: BA.pairs_in(pairs, dev), lambda: BA.gt_out(f)):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(3):
            fn()
        torch.cuda.synchronize()
        host.append((time.perf_counter() - t0) / 3 * 1e3)
    print(f"api B={n}: batch.pairing_batch {total:.2f} ms = {n / total * 1e3:.0f} pairings/s "
          f"(CUDA events, host conversion included); its device part on tensors {device:.2f} "
          f"ms; host conversion: objects -> tensors {host[0]:.2f} ms, {n} Fq12 -> Gt "
          f"(pairing_each's) {host[1]:.2f} ms [{card}]", flush=True)
    return launches


NATIVE_PAIRS = 256     # pairs of the native engine's batch against the card's


def host_ms(fn, reps: int) -> float:
    """Mean host ms of fn over reps calls (perf_counter)."""
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    return (time.perf_counter() - t0) / reps * 1e3


def phase_native(dev, ps, qs, card):
    """The native host engine: built, held against the spec and the
    goldens, its 256-pair batch against the card's pairing_batch (the
    counters reset around that call), timed against the spec, and the
    examples run on it.  Returns the card call's launches."""
    import golden
    from bn254_tpu_torch import api as A
    from bn254_tpu_torch import counts
    from bn254_tpu_torch import groups as G
    from bn254_tpu_torch import native as NV
    from bn254_tpu_torch import pairing_torch as P
    from bn254_tpu_torch import tower as T
    from bn254_tpu_torch.errors import ToAffineConversion
    from bn254_tpu_torch.examples import dh, joux
    from bn254_tpu_torch.spec import group as SG
    from bn254_tpu_torch.spec.constants import R

    require(NV.enabled(), "BN254_NO_NATIVE is set: the native phase needs the engine")
    print(f"native host engine: {NV.library_path().name}, "
          + (f"built in {NV.build_seconds:.1f} s by this run" if NV.build_seconds
             else "found built"), flush=True)
    ops1, ops2 = SG.G1_PARAMS[0], SG.G2_PARAMS[0]
    gen1 = (SG.G1_PARAMS[1][0], SG.G1_PARAMS[1][1], ops1.one)
    gen2 = (SG.G2_PARAMS[1][0], SG.G2_PARAMS[1][1], ops2.one)
    gp = SG.scalar_mul(gen1, golden.MILLER_G1_SCALAR, ops1)
    gq = SG.scalar_mul(gen2, golden.MILLER_G2_SCALAR, ops2)
    require(NV.pairing(gp, gq) == golden.REDUCED_PAIRING_EXPECTED,
            "native golden reduced pairing differs")
    require(NV.miller_loop_batch([gq], [gp]) == golden.MILLER_EXPECTED,
            "native golden Miller value differs")
    rng = random.Random(SEED + 11)
    ks = [0, 1, R - 1] + [rng.randrange(R) for _ in range(5)]
    for k in ks:
        p = SG.scalar_mul(gen1, rng.randrange(1, R), ops1)
        q = SG.scalar_mul(gen2, rng.randrange(1, R), ops2)
        require(SG.eq(NV.g1_scalar_mul(p, k), SG.scalar_mul(p, k, ops1), ops1),
                f"native G1 scalar mul by {k} differs from the spec")
        require(SG.eq(NV.g2_scalar_mul(q, k), SG.scalar_mul(q, k, ops2), ops2),
                f"native G2 scalar mul by {k} differs from the spec")
    bp, bq = list(ps[:3]), list(qs[:3])
    bp[1] = SG.zero(ops1)
    require(NV.pairing_batch(bp, bq) == SG.pairing_batch(bp, bq),
            "native pairing_batch with an infinity pair differs from the spec")
    try:
        A.miller_loop_batch([(A.G2.zero(), A.G1.one())])
        raised = False
    except ToAffineConversion:
        raised = True
    require(raised, "api.miller_loop_batch on infinity did not raise ToAffineConversion")
    print(f"native vs spec: golden pair, {len(ks)} G1 and {len(ks)} G2 scalar muls (0, 1, "
          f"r - 1 among them), pairing_batch with an infinity pair, miller_loop_batch "
          f"raising ToAffineConversion: all agree", flush=True)

    n = NATIVE_PAIRS
    sp, sq = ps[:n], qs[:n]
    g1, g2 = G.encode_points(G.G1, sp, dev), G.encode_points(G.G2, sq, dev)
    want = NV.pairing_batch(sp, sq)
    counts.reset()
    torch.cuda.synchronize()
    got = P.pairing_batch(g1, g2)
    torch.cuda.synchronize()
    launches, plain = dict(counts.launches), dict(counts.plain_calls)
    require(T.fq12_decode(got)[0] == want,
            f"native pairing_batch on {n} pairs differs from the card's")
    print(f"native pairing_batch on {n} pairs = pairing_torch.pairing_batch on the card",
          flush=True)
    launches = check_launches("native", counts.PAIRING_PATH, launches, plain,
                              absent=counts.TO_AFFINE_ONE_OPS + counts.FROBENIUS_TAIL_ONE_OPS)

    a, b = A.G1.one() * A.Fr(rng.randrange(1, R)), A.G2.one() * A.Fr(rng.randrange(1, R))
    native_ms = host_ms(lambda: A.pairing(a, b), 20)
    batch_ms = host_ms(lambda: NV.pairing_batch(sp, sq), 3)
    card_ms = cuda_ms(lambda: P.pairing_batch(g1, g2), 3)
    os.environ["BN254_NO_NATIVE"] = "1"
    try:
        spec_ms = host_ms(lambda: A.pairing(a, b), 3)
        spec_e = A.pairing(a, b)
    finally:
        del os.environ["BN254_NO_NATIVE"]
    require(spec_e == A.pairing(a, b), "api.pairing on the spec differs from the engine")
    print(f"native: api.pairing {native_ms:.3f} ms on the engine, {spec_ms:.2f} ms on the spec "
          f"(BN254_NO_NATIVE), host clock; pairing_batch on {n} pairs {batch_ms:.2f} ms on the "
          f"engine, {card_ms:.3f} ms on the card (CUDA events) [{card}]", flush=True)
    dh.main(random.Random(SEED + 12))
    joux.main(random.Random(SEED + 13))
    return launches


def _world_of_one(dev):
    """A one-rank NCCL process group in this process, on a FileStore in a
    temporary directory; returns the directory (remove it after
    destroy_process_group)."""
    import datetime
    import tempfile

    import torch.distributed as dist

    tmp = tempfile.mkdtemp(prefix="bn254_world1_")
    store = dist.FileStore(os.path.join(tmp, "store"), 1)
    dist.init_process_group("nccl", store=store, rank=0, world_size=1,
                            timeout=datetime.timedelta(seconds=60))
    return tmp


def phase_sharded(dev, ps, qs, msm_g1, card):
    """The sharded pairing and MSM: a world of 1 on NCCL in this process
    against the unsharded calls (the counters reset around the sharded
    ones), then dryrun_multichip(2) and 2 x 8192 pairs on two spawned
    ranks sharing the card.  Returns the in-process launches."""
    import shutil

    import torch.distributed as dist
    from bn254_tpu_torch import counts
    from bn254_tpu_torch import entry as E
    from bn254_tpu_torch import groups as G
    from bn254_tpu_torch import msm as M
    from bn254_tpu_torch import pairing_torch as P
    from bn254_tpu_torch import parallel as PAR
    from bn254_tpu_torch import tower as T
    from bn254_tpu_torch.convert import pack, tree_map
    from bn254_tpu_torch.spec import group as SG

    g1, g2 = G.encode_points(G.G1, ps, dev), G.encode_points(G.G2, qs, dev)
    pts, ks = msm_g1
    want_e = T.fq12_decode(P.pairing_batch(g1, g2))[0]
    want_m = G.decode_points(G.G1, M.msm(G.G1, pts, ks))[0]
    ops1 = SG.G1_PARAMS[0]
    tmp = _world_of_one(dev)
    try:
        counts.reset()
        torch.cuda.synchronize()
        got_e = PAR.pairing_batch_sharded(g1, g2)
        got_m = PAR.msm_sharded(G.G1, pts, ks)
        torch.cuda.synchronize()
        launches, plain = dict(counts.launches), dict(counts.plain_calls)
        require(T.fq12_decode(got_e)[0] == want_e,
                f"pairing_batch_sharded (world 1) on {len(ps)} pairs differs from pairing_batch")
        require(SG.eq(G.decode_points(G.G1, got_m)[0], want_m, ops1),
                f"msm_sharded (world 1) on G1 {ks.shape[-1]} differs from msm.msm")
        print(f"sharded, world of 1 (NCCL): pairing_batch_sharded on {len(ps)} pairs = "
              f"pairing_batch; msm_sharded on G1 {ks.shape[-1]} = msm.msm (projectively)",
              flush=True)
        launches = check_launches("sharded", counts.PAIRING_PATH + counts.MSM_PATH, launches,
                                  plain, absent=counts.TO_AFFINE_ONE_OPS)
        sharded = (cuda_ms(lambda: PAR.pairing_batch_sharded(g1, g2), 3),
                   cuda_ms(lambda: P.pairing_batch(g1, g2), 3),
                   cuda_ms(lambda: PAR.all_gather_partials(pack(got_e)), 10),
                   cuda_ms(lambda: PAR.msm_sharded(G.G1, pts, ks), 3),
                   cuda_ms(lambda: M.msm(G.G1, pts, ks), 3),
                   cuda_ms(lambda: PAR.all_gather_partials(pack(got_m)), 10))
    finally:
        dist.destroy_process_group()
        shutil.rmtree(tmp, ignore_errors=True)
    print(f"sharded, world of 1 (NCCL): pairing_batch_sharded {sharded[0]:.2f} ms "
          f"(pairing_batch {sharded[1]:.2f} ms; the gather alone {sharded[2]:.4f} ms); "
          f"msm_sharded G1 {ks.shape[-1]} {sharded[3]:.2f} ms (msm.msm {sharded[4]:.2f} ms; "
          f"the gather alone {sharded[5]:.4f} ms) [{card}]", flush=True)

    t0 = time.perf_counter()
    E.dryrun_multichip(2)
    print(f"dryrun_multichip(2): {time.perf_counter() - t0:.1f} s with the spawn", flush=True)
    half = len(ps) // 2
    shard = lambda t, lo, hi: tree_map(lambda a: a[..., lo:hi].contiguous(), t)
    jobs = [[E.pairing_job(shard(g1, 0, half), shard(g2, 0, half), reps=3)],
            [E.pairing_job(shard(g1, half, len(ps)), shard(g2, half, len(ps)), reps=3)]]
    t0 = time.perf_counter()
    results = E.run_ranks(2, jobs)
    for r, (res,) in enumerate(results):
        require(res["value"] == want_e, f"rank {r} of 2 x {half} pairs differs from the "
                                        f"world-of-1 value")
    print(f"sharded, 2 ranks on one card ({E.backend_for(2)}, host copies): 2 x {half} pairs = "
          f"the world-of-1 value on both ranks; "
          + "; ".join(f"rank {r} {res['ms']:.2f} ms, its gather {res['gather_ms']:.4f} ms"
                      for r, (res,) in enumerate(results))
          + f" ({time.perf_counter() - t0:.1f} s with the spawn) [{card}]", flush=True)
    return launches


SHOOTOUT_N = 10000     # the reference's full workload: 2 x 10000 pairings (shootout/run.py:3-4)
SHOOTOUT_HOST_N = 200  # shootout/run.py's default


def phase_shootout(dev, card):
    """The shootout: device mode at N = 10000 with the counters reset
    around it (both checks), then host mode at N = 200.  Returns device
    mode's launches."""
    from bn254_tpu_torch import counts
    from bn254_tpu_torch import shootout as S

    counts.reset()
    torch.cuda.synchronize()
    dt, acc = S.device(SHOOTOUT_N, device=dev)
    torch.cuda.synchronize()
    launches, plain = dict(counts.launches), dict(counts.plain_calls)
    require(acc == S.oracle(SHOOTOUT_N), f"shootout N={SHOOTOUT_N}: the accumulator differs "
                                         f"from e(G1, G2)^(sum (s1 s2)^i)")
    print(card, flush=True)
    print(f"shootout[device]: {2 * SHOOTOUT_N} pairings in {dt:.3f}s = "
          f"{2 * SHOOTOUT_N / dt:.1f} pairings/s (reference crate: {S.REFERENCE_PER_S}/s); "
          f"acc1 == acc2 = e(G1, G2)^(sum (s1 s2)^i); chunks of {S.chunk_size()}", flush=True)
    launches = check_launches("shootout", counts.GLV_PATH + ("to_affine", "miller_precompute",
                                                             "fq12_mul"),
                              launches, plain, absent=counts.FROBENIUS_TAIL_ONE_OPS)
    dt, acc = S.host(SHOOTOUT_HOST_N)
    require(acc == S.oracle(SHOOTOUT_HOST_N), f"shootout host N={SHOOTOUT_HOST_N}: the "
                                              f"accumulator differs from the oracle")
    print(f"shootout[host]: {2 * SHOOTOUT_HOST_N} pairings in {dt:.2f}s = "
          f"{2 * SHOOTOUT_HOST_N / dt:.1f} pairings/s on the native host engine (reference "
          f"crate: {S.REFERENCE_PER_S}/s)", flush=True)
    return launches


def main():
    if not torch.cuda.is_available():
        sys.exit("chip_smoke.py: no CUDA device; this script runs the port on the card only")
    root = os.path.dirname(os.path.abspath(__file__))
    sys.path[:0] = [root, os.path.join(root, "tests")]
    from bn254_tpu_torch import _build, counts, native

    dev = torch.device("cuda", 0)
    card = card_line()
    print(card, flush=True)
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"device {torch.cuda.get_device_name(0)}", flush=True)
    t0 = time.perf_counter()
    _build.library()
    print(f"kernel build ({len(counts.KERNELS)} kernels): {time.perf_counter() - t0:.1f} s",
          flush=True)
    t1 = time.perf_counter()
    native.load()       # phase 13's engine; the api objects of phases 12-15 run on it
    print(f"native host engine ({native.CC} {' '.join(native.FLAGS)}): "
          + (f"built in {native.build_seconds:.1f} s" if native.build_seconds
             else f"found built, loaded in {time.perf_counter() - t1:.1f} s"), flush=True)
    for line in ptxas_lines((_build.BUILD_DIR / "build.log").read_text(), PTXAS):
        print(line, flush=True)
    blocks = ctypes.c_int(0)
    require(_build.library().bn254_miller_blocks_per_sm(ctypes.byref(blocks)) == 0,
            "the occupancy query of k_miller_precompute failed")
    print(f"k_miller_precompute: {blocks.value} blocks of 2 warps an SM (occupancy query)",
          flush=True)

    laps = [("build", time.perf_counter())]      # each phase's end, for the seconds line
    lap = lambda name: laps.append((name, time.perf_counter()))
    records = phase_kernels(dev)
    lap("kernels")
    ps, qs = spec_pairs(N_MAIN)
    launches = phase_main_path(dev, ps, qs)
    lap("pairing")
    phase_timing(dev, ps, qs, card, records)
    lap("pairing timing")
    msm_launches, inputs = phase_msm(dev)
    lap("MSM")
    for name, rec in phase_msm_timing(inputs, card)[1].items():          # G1 2^20
        records[name].update(rec)
    msm_g1 = next(v[:2] for K, v in inputs.items() if K.COORDS == 1)     # for phase 14
    del inputs
    lap("MSM timing")
    glv_launches, inputs = phase_glv(dev)
    phase_glv_timing(inputs, card, records)
    del inputs
    lap("GLV")
    miller_launches = phase_prepared_miller(dev, ps, qs, card, records)
    lap("prepared Miller")
    probe_launches = phase_probes(dev, card, records)
    lap("probes")
    codec_launches = phase_codec(dev, card, records)
    lap("codec")
    inversion_launches = phase_inversions(dev, card)
    lap("inversions")
    api_launches = phase_api(dev, card)
    lap("api")
    native_launches = phase_native(dev, ps, qs, card)
    lap("native")
    sharded_launches = phase_sharded(dev, ps, qs, msm_g1, card)
    del msm_g1
    lap("sharded")
    shootout_launches = phase_shootout(dev, card)
    lap("shootout")
    print(f"all phases: {time.perf_counter() - t0:.0f} s from the build's start ("
          + ", ".join(f"{name} {t - laps[i][1]:.0f} s" for i, (name, t) in enumerate(laps[1:]))
          + ")", flush=True)

    paths = (launches, msm_launches, glv_launches, miller_launches, probe_launches,
             codec_launches, inversion_launches, api_launches, native_launches,
             sharded_launches, shootout_launches)
    for name, rec in records.items():      # launches over the eleven main-path runs
        rec["launches"] = sum(p[name] for p in paths)
    require(sorted(records) == sorted(counts.KERNELS), "a kernel has no comparison record")
    print(card)
    print(json.dumps({"kernels": [records[k] for k in counts.KERNELS]}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
