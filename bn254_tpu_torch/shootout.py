"""Shootout workload on the port — port form of shootout/run.py: 2 x N
pairing accumulation with a commuting cross-check (acc1 == acc2), the
reference's end-to-end performance and correctness harness
(shootout/main.rs:5-29; shootout/README.md records 20,000 pairings in
208.8 s for the Rust crate, 95.8 pairings/s, and 123.7 s for libsnark).

    python -m bn254_tpu_torch.shootout [N]       # host mode, N = 200
    BN254_SHOOTOUT_DEVICE=1 python -m bn254_tpu_torch.shootout 10000
                                                  # device mode, on the card

Host mode runs the scalar API (``api``: ``G1/G2 * Fr`` and ``pairing`` on
the native host engine unless BN254_NO_NATIVE is set).  Device mode runs
the whole workload batched: a_i = s1^i G1 and b_i = s2^i G2 by the GLV
ladders (``glv.scalar_mul_glv``) from host scalar powers, one Miller
product a chunk (``pairing_torch.miller_loop_batch``), the chunks'
partials folded on the host and one final exponentiation an accumulator
(mod.rs:925).  Both modes also check the accumulator against an oracle
off the device path: acc = e(G1, G2)^(sum_i (s1 s2)^i mod r), by the
scalar API's ``pairing`` and ``Gt.pow``.
"""

from __future__ import annotations

import os
import subprocess
import sys
import time

from . import api as A
from .spec import field as SF
from .spec.constants import R

REFERENCE_PER_S = 95.8      # the crate: 20,000 pairings in 208.8 s
CHUNK = 4096                # pairs a device chunk (BN254_SHOOTOUT_CHUNK)


def chunk_size() -> int:
    """Pairs a device chunk: BN254_SHOOTOUT_CHUNK, else CHUNK."""
    return int(os.environ.get("BN254_SHOOTOUT_CHUNK", CHUNK))


def _scalars():
    """The reference's s1, s2: 1901^-1 and 2344^-1 in Fr (main.rs:9-10)."""
    return A.Fr.from_str("1901").inverse(), A.Fr.from_str("2344").inverse()


def oracle(n: int) -> "A.Gt":
    """e(G1, G2)^(sum_{i<n} (s1 s2)^i mod r): both accumulators' value."""
    c, d = _scalars()
    cd, x, e = c.v * d.v % R, 1, 0
    for _ in range(n):
        e = (e + x) % R
        x = x * cd % R
    return A.pairing(A.G1.one(), A.G2.one()).pow(A.Fr(e))


def host(n: int):
    """The workload on the scalar API, as shootout/run.py's host mode:
    (seconds, acc1)."""
    c, d = _scalars()

    def accumulate(s1, s2):
        a, b = A.G1.one(), A.G2.one()
        acc = A.Gt.one()
        for _ in range(n):
            acc = acc * A.pairing(a, b)
            a = a * s1
            b = b * s2
        return acc

    t0 = time.perf_counter()
    acc1 = accumulate(c, d)
    acc2 = accumulate(d, c)
    dt = time.perf_counter() - t0
    assert acc1 == acc2, "commuting accumulators disagree"
    return dt, acc1


def device(n: int, device=None):
    """The workload batched on the device: (seconds, acc1).

    The reference's ladder is the recurrence a = a s1 (main.rs:16-24), so
    a_i = s1^i G1: a chunk's GLV ladders build those points directly from
    the scalar powers (host big-int powers, n modular products), the
    Miller kernel and the Fq12 product tree fold the chunk's pairs into
    one partial, exact in any split, and ONE final exponentiation an
    accumulator finishes on the host's spec (mod.rs:925).  A short chunk
    is padded with scalar 0, whose point is at infinity, so its pair folds
    to 1 (the silent skip, mod.rs:911-920).  Chunks hold chunk_size()
    pairs.  On the card the clock (CUDA events, then a synchronize)
    starts after an untimed warm-up at the same shapes; the CPU, where
    nothing is compiled or cached, has none."""
    import torch

    from . import glv as GLV
    from . import groups as G
    from . import msm as M
    from . import pairing_torch as P
    from . import tower as T
    from ._build import resolve_device

    dev = resolve_device(device)
    ch = chunk_size()
    c, d = (s.v for s in _scalars())
    gen1, gen2 = G.generator(G.G1, ch, dev), G.generator(G.G2, ch, dev)

    def chunk_f(k1, k2):
        p = GLV.scalar_mul_glv(G.G1, gen1, M.encode_scalars(k1, dev))
        q = GLV.scalar_mul_glv(G.G2, gen2, M.encode_scalars(k2, dev))
        return T.fq12_decode(P.miller_loop_batch(q, p))[0]

    def accumulate(s1, s2):
        ks1, ks2 = [], []
        x = y = 1
        for _ in range(n):
            ks1.append(x)
            ks2.append(y)
            x = (x * s1) % R
            y = (y * s2) % R
        acc = None
        for i in range(0, n, ch):
            k1, k2 = ks1[i:i + ch], ks2[i:i + ch]
            pad = ch - len(k1)
            k1 += [0] * pad
            k2 += [0] * pad
            f = chunk_f(k1, k2)
            acc = f if acc is None else SF.fq12_mul(acc, f)
        return SF.fq12_final_exponentiation(acc)

    cuda = dev.type == "cuda"
    if cuda:
        chunk_f([1] * ch, [1] * ch)
        torch.cuda.synchronize(dev)
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
    t0 = time.perf_counter()
    acc1 = accumulate(c, d)
    acc2 = accumulate(d, c)
    if cuda:
        end.record()
        torch.cuda.synchronize(dev)
        dt = start.elapsed_time(end) / 1e3
    else:
        dt = time.perf_counter() - t0
    assert acc1 == acc2, "commuting accumulators disagree"
    return dt, A.Gt(acc1)


def card_line() -> str:
    """The card's name and power limit, as nvidia-smi prints them."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]


def main(argv=None):
    argv = sys.argv[1:] if argv is None else argv
    n = int(argv[0]) if argv else 200
    mode = "device" if os.environ.get("BN254_SHOOTOUT_DEVICE") else "host"
    dt, acc = device(n) if mode == "device" else host(n)
    assert acc == oracle(n), "the accumulator differs from e(G1, G2)^(sum (s1 s2)^i)"
    total = 2 * n
    if mode == "device":
        print(card_line(), flush=True)
    print(f"shootout[{mode}]: {total} pairings in {dt:.2f}s "
          f"= {total / dt:.1f} pairings/s (reference crate: {REFERENCE_PER_S}/s)", flush=True)
    return total / dt


if __name__ == "__main__":
    main()
