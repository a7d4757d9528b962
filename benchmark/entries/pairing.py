"""Driver: ``bn254_tpu_torch.pairing_torch.pairing``, one reduced pairing a
lane (the crate's pairing(), a verdict a pair).

Kept: the whole output of the first call on each batch and of a sample of
later calls drawn from the seed.  Compared with the reference:

* wrong_lanes: a sample of lanes of every kept call (drawn from the seed,
  with the first and last lane and the infinity lanes) against g^(a_i c_i),
  fully reduced and bit for bit;
* wrong_products: for the first call on each batch, the product of all its
  lanes' outputs against g^(sum of a_i c_i), so every lane is covered;
* unequal_calls: every later kept call bit-equal to the first on its batch.
"""

import numpy as np
import torch

from benchlib import pairs as PS
from bnref import bn254 as B
from bnref import check as C

ENTRY = "pairing"


def setup(ctx):
    from bn254_tpu_torch import pairing_torch as P
    st = PS.setup(ctx)
    st.extra["entry"] = P.pairing
    rng = np.random.default_rng([ctx.seed, 1])
    every = int(ctx.traffic["keep_every"])
    st.extra["keep"] = rng.random(1 << 20) < 1.0 / every
    st.extra["seed"] = ctx.seed
    nlanes = int(ctx.traffic["sample_lanes"])
    st.extra["lanes"] = [
        sorted({0, st.n - 1} | {int(x) for x in rng.choice(st.n, size=min(nlanes, st.n), replace=False)}
               | {i for i, e in enumerate(st.logs[k]) if not e})
        for k in range(st.n_batches)]
    return st


def call(st, k):
    g1, g2 = st.batches[k]
    return st.extra["entry"](g1, g2)


def keep(st, i, k, out):
    if i < st.n_batches or st.extra["keep"][i % len(st.extra["keep"])]:
        st.kept.append((i, k, out))


def work(st, k):
    return st.n


def facts(st, k):
    return PS.facts(st, k, ENTRY)


def check(st, control=False):
    rng = np.random.default_rng(st.extra["seed"] + 1)
    g = C.gt_generator()
    fb = C.FixedBase(C.Tower(C.CANON), g)
    lazy = C.FixedBase(C.Tower(C.LAZY), g) if control else None
    memo = {}

    def want(k, lane):
        if (k, lane) not in memo:
            memo[k, lane] = B.fq12_flat(fb.pow(st.logs[k][lane]))
        return memo[k, lane]

    wrong_lanes, failed = 0, set()
    for i, k, out in st.kept:
        lanes = st.extra["lanes"][k]
        if control:
            got = [[C.decode(m) for m in B.fq12_flat(lazy.pow(st.logs[k][lane]))] for lane in lanes]
        else:
            got = PS.decode_fq12(PS.fq12_lanes(out, lanes))
        bad = sum(1 for lane, g_ in zip(lanes, got) if g_ != want(k, lane))
        wrong_lanes += bad
        if bad:
            failed.add(i)
    numbers = {"wrong_lanes": (wrong_lanes, 0)}
    if not control:
        first = {}
        for i, k, out in st.kept:
            first.setdefault(k, (i, out))
        wrong_products = 0
        for k, (i, out) in first.items():
            prod, ok = B.FQ12_ONE, True
            for c in PS.decode_fq12(PS.fq12_lanes(out)):
                if None in c:
                    ok = False
                    break
                prod = B.fq12_mul(prod, C.fq12_from_flat(c))
            if not ok or B.fq12_flat(prod) != B.fq12_flat(fb.pow(sum(st.logs[k]) % C.R)):
                wrong_products += 1
                failed.add(i)
        unequal = 0
        for i, k, out in st.kept:
            if not torch.equal(PS.fq12_lanes(out), PS.fq12_lanes(first[k][1])):
                unequal += 1
                failed.add(i)
        numbers["wrong_products"] = (wrong_products, 0)
        numbers["unequal_calls"] = (unequal, 0)
    numbers["inputs_off"] = (PS.inputs_off(st, fb, rng), 0)
    return numbers, len(failed)
