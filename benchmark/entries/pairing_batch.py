"""Driver: ``bn254_tpu_torch.pairing_torch.pairing_batch``, one reduced
product of pairings a call (the crate's pairing_batch, EIP-197's check).

Every call's output is kept (one Fq12) and compared, fully reduced and
bit for bit, with g^(sum of a_i c_i) over its batch's finite pairs."""

import numpy as np
import torch

from benchlib import pairs as PS
from bnref import check as C

ENTRY = "pairing_batch"


def setup(ctx):
    from bn254_tpu_torch import pairing_torch as P
    st = PS.setup(ctx)
    st.extra["seed"] = ctx.seed
    st.extra["entry"] = P.pairing_batch
    return st


def call(st, k):
    g1, g2 = st.batches[k]
    return st.extra["entry"](g1, g2)


def keep(st, i, k, out):
    st.kept.append((k, out))


def work(st, k):
    return st.n


def facts(st, k):
    return PS.facts(st, k, ENTRY)


def _expected(st, fb):
    return [fb.pow(sum(logs) % C.R) for logs in st.logs]


def check(st, control=False):
    """{number: (value, limit)}, calls that failed.  control: the
    reference's answers in the lazy arithmetic take the program's place."""
    rng = np.random.default_rng(st.extra["seed"] + 1)
    g = C.gt_generator()
    fb = C.FixedBase(C.Tower(C.CANON), g)
    want = [C.B.fq12_flat(e) for e in _expected(st, fb)]
    if control:
        lazy = C.FixedBase(C.Tower(C.LAZY), g)
        got_k = [[C.decode(m) for m in C.B.fq12_flat(e)] for e in _expected(st, lazy)]
        got = [got_k[k] for k, _ in st.kept]
    else:
        arr = torch.cat([PS.fq12_lanes(out) for _, out in st.kept], -1)     # [12, 16, calls]
        got = PS.decode_fq12(arr)
    wrong = sum(1 for (k, _), g_ in zip(st.kept, got) if g_ != want[k])
    off = PS.inputs_off(st, fb, rng)
    return {"wrong_answers": (wrong, 0), "inputs_off": (off, 0)}, wrong
