"""Input pairs for the pairing entries, and what the reference expects of them.

A cell's K batches are lanes [k n, (k + 1) n) of one G1 table and one G2
table (``inputs.point_table``): pair i is (a_i G1, c_i G2) with known a_i,
c_i, so its reduced pairing is g^(a_i c_i), g = e(G1, G2).  A few lanes of
each table hold the point at infinity, which the reference skips (mod.rs:
911-920): their exponent is 0.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import torch

from bnref import bn254 as B
from bnref import check as C

from . import inputs as I


@dataclass
class PairState:
    n: int
    n_batches: int
    batches: list                  # (g1 points, g2 points) per batch, as the program takes them
    logs: list                     # per batch: a_i c_i mod r of each lane
    kept: list = field(default_factory=list)
    extra: dict = field(default_factory=dict)

    def finite(self, k: int) -> int:
        return sum(1 for e in self.logs[k] if e)


def setup(ctx) -> PairState:
    tr = ctx.traffic
    n, nb = int(tr["pairs"]), int(tr["batches"])
    t1 = I.point_table(1, n * nb, ctx.rng, ctx.device, n_infinity=int(tr["infinity_g1"]) * nb)
    t2 = I.point_table(2, n * nb, ctx.rng, ctx.device, n_infinity=int(tr["infinity_g2"]) * nb)
    batches, logs = [], []
    for k in range(nb):
        lo, hi = k * n, (k + 1) * n
        batches.append((I.batch_points(t1, lo, hi), I.batch_points(t2, lo, hi)))
        logs.append([t1.log(i) * t2.log(i) % B.R for i in range(lo, hi)])
    del t1, t2
    return PairState(n, nb, batches, logs)


def leaves(tree) -> list:
    if isinstance(tree, tuple):
        return [x for t in tree for x in leaves(t)]
    return [tree]


def fq12_lanes(out, lanes=None):
    """An Fq12 output tree -> int32 [12, 16, len(lanes)] (all lanes when
    None), on the output's device."""
    ls = leaves(out)
    if lanes is None:
        return torch.stack(ls)
    idx = torch.as_tensor(lanes, device=ls[0].device)
    return torch.stack([x.index_select(-1, idx) for x in ls])


def decode_fq12(arr) -> list:
    """int32 [12, 16, m] limbs -> m lists of 12 decoded coefficients (None
    where a residue is not fully reduced)."""
    a = arr.cpu().numpy()
    ints = C.limbs_to_ints(a.transpose(1, 2, 0).reshape(16, -1))     # lane-major, 12 a lane
    return [[C.decode(x) for x in ints[12 * j:12 * j + 12]] for j in range(a.shape[2])]


def point_at(st: PairState, k: int, lane: int):
    """Input pair `lane` of batch k, read back as reference points."""
    g1, g2 = st.batches[k]
    vals = [C.decode(C.limbs_to_ints(t[:, lane:lane + 1].cpu().numpy())[0]) for t in leaves(g1)]
    p = tuple(vals)
    v2 = [C.decode(C.limbs_to_ints(t[:, lane:lane + 1].cpu().numpy())[0]) for t in leaves(g2)]
    q = ((v2[0], v2[1]), (v2[2], v2[3]), (v2[4], v2[5]))
    return p, q


def inputs_off(st: PairState, fb, rng) -> int:
    """Pairs whose reference pairing, computed directly on the input points,
    differs from g^(a c): a check of the inputs and of the route through g.
    Two finite lanes and one infinity lane where a batch has one."""
    bad = 0
    lanes = [int(x) for x in rng.choice(st.n, size=2, replace=False)]
    inf = [i for i, e in enumerate(st.logs[0]) if not e][:1]
    for lane in lanes + inf:
        p, q = point_at(st, 0, lane)
        if B.fq12_flat(B.pairing(p, q)) != B.fq12_flat(fb.pow(st.logs[0][lane])):
            bad += 1
    return bad


def facts(st: PairState, k: int, entry: str) -> dict:
    return {"entry": entry, "pairs": st.n, "finite_pairs": st.finite(k)}
