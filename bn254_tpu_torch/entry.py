"""Entry points of the port — counterpart of __graft_entry__.py.

* ``entry(device=None)`` -> ``(fn, example_args)``: the flagship step,
  ``pairing_torch.pairing_batch`` (to_affine, the Miller kernel, the Fq12
  product, the final exponentiation), and 128 example pairs made as
  __graft_entry__.py's ``_example_pairs`` makes them, on the card unless
  ``device="cpu"``.
* ``dryrun_multichip(n, device=None)``: starts n processes joined by
  torch.distributed, runs the sharded pairing on 2 pairs a rank and the
  sharded G1 MSM on 4 points a rank (scalars 7i + 1), and checks both on
  every rank against the port's spec.
* ``run_ranks(world, jobs, device=None)``: the process launcher under
  ``dryrun_multichip``: rank r runs ``jobs[r]`` (``pairing_job`` /
  ``msm_job``) and returns their decoded results and times.

The ranks are spawned (``torch.multiprocessing``, start method spawn):
each child imports this module and the port, and neither jax nor the
tests (``_rank_main`` checks).  Backends: NCCL where every rank has a
card of its own, gloo otherwise, on the CPU or with every rank on the one
card (then ``parallel`` gathers host copies).  The rendezvous is a file in
a temporary directory, and a timeout of TIMEOUT_S makes a rank that dies
fail the run instead of hanging it.

    python -m bn254_tpu_torch.entry [n] [--cpu]
"""

from __future__ import annotations

import datetime
import os
import pickle
import shutil
import sys
import tempfile
import time

import torch

from . import groups as G
from . import msm as M
from . import pairing_torch as P
from . import parallel as PAR
from . import tower as T
from ._build import resolve_device
from .convert import pack, unpack_point
from .spec import group as SG

__all__ = ["entry", "dryrun_multichip", "run_ranks", "pairing_job", "msm_job",
           "example_points"]

EXAMPLE_PAIRS = 128
TIMEOUT_S = 60


def example_points(n: int):
    """n deterministic spec pairs: P_i = (2i + 3) G1, Q_i = (3i + 5) G2
    (__graft_entry__.py:32-43)."""
    ops1, gen1 = SG.G1_PARAMS[0], SG.G1_PARAMS[1]
    ops2, gen2 = SG.G2_PARAMS[0], SG.G2_PARAMS[1]
    ps = [SG.scalar_mul((gen1[0], gen1[1], ops1.one), 2 * i + 3, ops1) for i in range(n)]
    qs = [SG.scalar_mul((gen2[0], gen2[1], ops2.one), 3 * i + 5, ops2) for i in range(n)]
    return ps, qs


def entry(device=None):
    """(fn, example_args): fn(*example_args) is the batched reduced
    pairing of 128 example pairs, a batch-1 Fq12."""
    dev = resolve_device(device)
    ps, qs = example_points(EXAMPLE_PAIRS)
    return P.pairing_batch, (G.encode_points(G.G1, ps, dev), G.encode_points(G.G2, qs, dev))


# ---- jobs a rank runs ----

def pairing_job(g1, g2, reps: int = 0) -> dict:
    """A sharded pairing over this rank's pairs: Jacobian point batches
    (tensors, any device) or lists of spec points.  reps > 0 also times
    reps calls after a warm-up, and the gather alone."""
    if isinstance(g1, list):
        g1, g2 = G.encode_points(G.G1, g1, "cpu"), G.encode_points(G.G2, g2, "cpu")
    return {"kind": "pairing", "g1": pack(g1).cpu(), "g2": pack(g2).cpu(), "reps": reps}


def msm_job(K, points, scalars, lanes=None, reps: int = 0) -> dict:
    """A sharded MSM over group K on this rank's points (a Jacobian batch
    or a list of spec points) and scalars (limbs [16, n] or ints)."""
    if isinstance(points, list):
        points = G.encode_points(K, points, "cpu")
    if isinstance(scalars, list):
        scalars = M.encode_scalars(scalars, "cpu")
    return {"kind": "msm", "ncoords": K.COORDS, "points": pack(points).cpu(),
            "scalars": scalars.cpu(), "lanes": lanes, "reps": reps}


def _run_job(job, dev) -> dict:
    """Run one job on this rank; its value decoded on the host (a spec
    Fq12 or Jacobian point), and where reps > 0 the ms of a call and of
    the gather alone (CUDA events on the card, the host clock on the CPU)."""
    if job["kind"] == "pairing":
        nc = 1
        g1 = unpack_point(1, job["g1"].to(dev))
        g2 = unpack_point(2, job["g2"].to(dev))
        call = lambda: PAR.pairing_batch_sharded(g1, g2)
    else:
        nc = job["ncoords"]
        K = G.G1 if nc == 1 else G.G2
        pts = unpack_point(nc, job["points"].to(dev))
        ks = job["scalars"].to(dev)
        call = lambda: PAR.msm_sharded(K, pts, ks, lanes=job["lanes"])
    out = call()
    value = (T.fq12_decode(out)[0] if job["kind"] == "pairing"
             else G.decode_points(G.G1 if nc == 1 else G.G2, out)[0])
    res = {"value": value, "ms": None, "gather_ms": None}
    if job["reps"]:
        partial = pack(out)
        res["ms"] = _mean_ms(call, job["reps"], dev)
        res["gather_ms"] = _mean_ms(lambda: PAR.all_gather_partials(partial), job["reps"], dev)
    return res


def _mean_ms(fn, reps: int, dev) -> float:
    """Mean ms of a call over reps calls after one warm-up."""
    fn()
    if dev.type != "cuda":
        t0 = time.perf_counter()
        for _ in range(reps):
            fn()
        return (time.perf_counter() - t0) / reps * 1e3
    torch.cuda.synchronize(dev)
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize(dev)
    return start.elapsed_time(end) / reps


def _foreign_modules() -> list:
    """Modules a rank must not load: jax, the JAX package, the tests."""
    tests = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "tests")
    bad = []
    for name, mod in list(sys.modules.items()):
        path = getattr(mod, "__file__", None) or ""
        if (name.split(".")[0] in ("jax", "jaxlib", "bn254_tpu")
                or os.path.abspath(path).startswith(tests + os.sep)):
            bad.append(name)
    return sorted(bad)


def _rank_main(rank, world, backend, device, jobs, rendezvous, out_dir):
    """One spawned rank: join the group, run this rank's jobs, save the
    results to out_dir/rank<r>.pkl."""
    import torch.distributed as dist

    dev = torch.device(device)
    if dev.type == "cuda":        # NCCL: a card a rank; gloo: every rank on the given card
        dev = torch.device("cuda", rank if backend == "nccl" else dev.index or 0)
        torch.cuda.set_device(dev)
    else:
        torch.set_num_threads(1)
    dist.init_process_group(backend, init_method=f"file://{rendezvous}", rank=rank,
                            world_size=world, timeout=datetime.timedelta(seconds=TIMEOUT_S))
    try:
        results = [_run_job(job, dev) for job in jobs[rank]]
        dist.barrier()
    finally:
        dist.destroy_process_group()
    bad = _foreign_modules()
    if bad:
        raise RuntimeError(f"rank {rank} loaded modules the port must not: {bad}")
    with open(os.path.join(out_dir, f"rank{rank}.pkl"), "wb") as f:
        pickle.dump(results, f)


def backend_for(world: int, device=None) -> str:
    """NCCL where every rank can have a card of its own, gloo otherwise."""
    import torch.distributed as dist

    dev = resolve_device(device)
    if (dev.type == "cuda" and torch.cuda.device_count() >= world
            and dist.is_nccl_available()):
        return "nccl"
    return "gloo"


def run_ranks(world: int, jobs, device=None) -> list:
    """Spawn `world` ranks; rank r runs jobs[r] (the same kinds in the same
    order on every rank).  Returns [[result of each job] for each rank],
    each result {"value", "ms", "gather_ms"}.  A rank's failure raises
    here, after every rank has stopped."""
    import torch.multiprocessing as mp

    if len(jobs) != world:
        raise ValueError(f"{len(jobs)} job lists for {world} ranks")
    dev = resolve_device(device)
    backend = backend_for(world, dev)
    tmp = tempfile.mkdtemp(prefix="bn254_ranks_")
    try:
        mp.spawn(_rank_main, args=(world, backend, str(dev), jobs,
                                   os.path.join(tmp, "rendezvous"), tmp),
                 nprocs=world, join=True)
        out = []
        for r in range(world):
            with open(os.path.join(tmp, f"rank{r}.pkl"), "rb") as f:
                out.append(pickle.load(f))
        return out
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


def dryrun_multichip(n_devices: int, device=None) -> list:
    """The sharded pairing (2 pairs a rank) and the sharded G1 MSM (4
    points a rank, scalars 7i + 1, lanes 4) on n_devices spawned ranks,
    each rank's results held against the spec (__graft_entry__.py:54-116).
    Returns run_ranks' results."""
    n = n_devices
    ps, qs = example_points(4 * n)
    ks = [7 * i + 1 for i in range(4 * n)]
    jobs = [[pairing_job(ps[2 * r:2 * r + 2], qs[2 * r:2 * r + 2]),
             msm_job(G.G1, ps[4 * r:4 * r + 4], ks[4 * r:4 * r + 4], lanes=4)]
            for r in range(n)]
    results = run_ranks(n, jobs, device)
    want_e = SG.pairing_batch(ps[:2 * n], qs[:2 * n])
    ops1 = SG.G1_PARAMS[0]
    want_p = SG.zero(ops1)
    for p, k in zip(ps, ks):
        want_p = SG.add(want_p, SG.scalar_mul(p, k, ops1), ops1)
    for r, (e, m) in enumerate(results):
        assert e["value"] == want_e, f"rank {r}: sharded pairing differs from the spec"
        assert SG.eq(m["value"], want_p, ops1), f"rank {r}: sharded MSM differs from the spec"
    print(f"dryrun_multichip({n}): sharded pairing + MSM OK on {n} ranks "
          f"({backend_for(n, device)}, {resolve_device(device)})", flush=True)
    return results


def main(argv):
    device = "cpu" if "--cpu" in argv else None
    nums = [int(a) for a in argv if a.isdigit()]
    fn, args = entry(device)
    out = fn(*args)
    ps, qs = example_points(EXAMPLE_PAIRS)
    assert T.fq12_decode(out)[0] == SG.pairing_batch(ps, qs), "entry() differs from the spec"
    print(f"entry OK: pairing_batch on {EXAMPLE_PAIRS} pairs = spec", flush=True)
    n = nums[0] if nums else max(2, torch.cuda.device_count() if device is None else 0)
    dryrun_multichip(n, device)


if __name__ == "__main__":
    main(sys.argv[1:])
