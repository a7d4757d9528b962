"""Driver: ``bn254_tpu_torch.msm.msm``, one multi-scalar multiplication a
call over fixed points (a prover's query: P_i = a_i G, a_i known) with the
scalars of one of the cell's batches (one proof's witness each).

Every call's output point is kept and compared with (sum_i k_i a_i) G:
each coordinate fully reduced, the point equal in affine form."""

from dataclasses import dataclass, field

import numpy as np
import torch

from benchlib import inputs as I
from benchlib import roofline as RF
from bnref import bn254 as B
from bnref import check as C


@dataclass
class MsmState:
    ncoords: int
    n: int
    n_batches: int
    table: object
    points: tuple
    scalars: list                 # int32 [16, n] per batch, as the program takes them
    limbs: list                   # the same as numpy int64
    seed: int
    config: dict
    entry: object                 # msm.msm bound to the group
    kept: list = field(default_factory=list)
    _work: dict = field(default_factory=dict)


def setup(ctx):
    from functools import partial

    from bn254_tpu_torch import groups as G
    from bn254_tpu_torch import msm as M
    tr, cfg = ctx.traffic, ctx.config
    nc = {"G1": 1, "G2": 2}[tr["group"]]
    n, nb = int(tr["points"]), int(tr["batches"])
    table = I.point_table(nc, n, ctx.rng, ctx.device, n_infinity=int(tr["infinity_points"]))
    points = I.batch_points(table, 0, n)
    limbs = [I.scalars(n, ctx.rng, int(tr["zero_scalars"]), int(tr["top_scalars"]))
             for _ in range(nb)]
    scalars = [torch.from_numpy(k.astype(np.int32)).to(ctx.device).contiguous() for k in limbs]
    table.coords = None                                    # the int64 table is no longer needed
    return MsmState(nc, n, nb, table, points, scalars, limbs, ctx.seed, cfg,
                    partial(M.msm, G.G1 if nc == 1 else G.G2))


def call(st, k):
    return st.entry(st.points, st.scalars[k])


def keep(st, i, k, out):
    st.kept.append((k, out))


def work(st, k):
    return st.n


def facts(st, k):
    if k not in st._work:
        c = int(st.config["window_bits"][str(st.ncoords)])
        lanes = int(st.config["lanes"])
        nbits = int(st.config["scalar_bits"])
        mixed, general = RF.bucket_work(st.limbs[k], c, lanes, nbits)
        st._work[k] = {"ncoords": st.ncoords, "points": st.n, "c": c, "lanes": lanes,
                       "windows": (nbits + c) // c, "mixed": mixed, "general": general}
    return st._work[k]


def _flat_point(st, out):
    if st.ncoords == 1:
        return list(out)
    return [x for c in out for x in c]


def _spot_points(st, rng) -> int:
    """Input points, read back from the program's input tensors, that are
    not a_i G."""
    K, g = (B.FqOps, B.G1_ONE) if st.ncoords == 1 else (B.Fq2Ops, B.G2_ONE)
    flat = _flat_point(st, st.points)
    bad = 0
    for lane in list(rng.choice(st.n, size=2, replace=False)) + list(st.table.infinity[:1]):
        vals = [C.decode(C.limbs_to_ints(t[:, lane:lane + 1].cpu().numpy())[0]) for t in flat]
        got = C.jacobian_to_affine(st.ncoords, vals)
        a = st.table.log(int(lane))
        want = B.to_affine(B.scalar_mul((g[0], g[1], K.one), a, K), K) if a else None
        bad += got != want
    return bad


def check(st, control=False):
    rng = np.random.default_rng(st.seed + 1)
    K = B.FqOps if st.ncoords == 1 else B.Fq2Ops
    g = C.group_generator(st.ncoords)
    logs = [I.weighted_log_sum(k, st.table) for k in st.limbs]
    want = [B.to_affine(B.scalar_mul((g[0], g[1], K.one), s, K), K) if s else None for s in logs]
    if control:
        per_batch = []
        for s in logs:
            j = C.scalar_mul(C.Tower(C.LAZY), st.ncoords, g, s)
            per_batch.append([C.decode(m) for m in (list(j) if st.ncoords == 1 else
                                                    [x for c in j for x in c])])
        coords = [per_batch[k] for k, _ in st.kept]
    else:
        arr = torch.stack([torch.stack(_flat_point(st, out))[:, :, 0] for _, out in st.kept])
        a = arr.cpu().numpy()                              # [calls, 3c, 16]
        ints = C.limbs_to_ints(a.reshape(-1, 16).T)
        m = 3 * st.ncoords
        coords = [[C.decode(x) for x in ints[m * j:m * j + m]] for j in range(len(st.kept))]
    wrong = 0
    for (k, _), cs in zip(st.kept, coords):
        if None in cs or C.jacobian_to_affine(st.ncoords, cs) != want[k]:
            wrong += 1
    return {"wrong_answers": (wrong, 0), "inputs_off": (_spot_points(st, rng), 0)}, wrong
