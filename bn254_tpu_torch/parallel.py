"""Sharded batched pairing and MSM over torch.distributed — counterpart of
bn254_tpu/parallel.py.

The design is the JAX package's: the only data that crosses processes is
constant-size group and field elements.

* ``pairing_batch_sharded`` — each rank passes its own shard of the
  pairs, runs the Miller loops of its shard and reduces them to one
  batch-1 Fq12 (``pairing_torch.miller_loop_batch``); one ``all_gather``
  brings every rank's partial to every rank, each folds them in rank
  order with ``tower.fq12_mul``, and ONE final exponentiation runs,
  replicated.  This is the reference's shared-final-exponentiation
  semantics (groups/mod.rs:904-926): a rank whose pairs are all at
  infinity, or which has none, contributes Fq12 one (mod.rs:911-920).
* ``msm_sharded`` — each rank runs the whole Pippenger MSM (``msm.msm``)
  on its shard of points and scalars; the batch-1 Jacobian partials are
  gathered and folded in rank order with the group add, so every rank
  holds the same limbs.  A rank with no points contributes infinity.

Where the JAX package maps a function over a mesh (``shard_map`` with
in_specs), each rank here passes its own shard; shards may be ragged.
The collective is NCCL's where the group's backend is NCCL (one card a
rank: the device tensors are gathered); any other backend (gloo on the
CPU, or ranks that share one card) gathers host copies, a few hundred
bytes a rank.  A process group must exist: without one, and with no
``group`` passed, these functions raise rather than run a quiet
single-process path.
"""

from __future__ import annotations

import torch
import torch.distributed as dist

from . import groups as G
from . import msm as M
from . import pairing_torch as P
from . import tower as T
from .convert import pack, tree_leaves, unpack_fq12, unpack_point

__all__ = ["pairing_batch_sharded", "msm_sharded", "all_gather_partials"]


def _require_group(group):
    if group is None and not dist.is_initialized():
        raise RuntimeError("no process group: call torch.distributed.init_process_group "
                           "(or pass group=) before a sharded call")


def all_gather_partials(t: torch.Tensor, group=None) -> list:
    """Every rank's packed partial ``[c, 16, 1]`` in rank order, on t's
    device: NCCL gathers the device tensors, another backend host copies."""
    _require_group(group)
    world = dist.get_world_size(group)
    src = t.contiguous() if dist.get_backend(group) == "nccl" else t.cpu()
    out = [torch.empty_like(src) for _ in range(world)]
    dist.all_gather(out, src, group=group)
    return [o.to(t.device) for o in out]


def pairing_batch_sharded(g1_local, g2_local, group=None):
    """Reduced product of pairings over every rank's pairs.

    g1_local / g2_local: this rank's Jacobian G1 and G2 batches (aligned,
    any length, 0 included).  Returns a batch-1 Fq12, the same on every
    rank."""
    _require_group(group)
    leaf = tree_leaves(g1_local)[0]
    n = leaf.shape[-1]
    if n != tree_leaves(g2_local)[0].shape[-1]:
        raise ValueError(f"{n} G1 points and {tree_leaves(g2_local)[0].shape[-1]} G2 points")
    f = P.miller_loop_batch(g2_local, g1_local) if n else T.fq12_ones(1, leaf.device)
    parts = all_gather_partials(pack(f), group)
    acc = unpack_fq12(parts[0])
    for part in parts[1:]:
        acc = T.fq12_mul(acc, unpack_fq12(part))
    return T.fq12_final_exponentiation(acc)


def msm_sharded(K, points_local, scalars_local, group=None, c: int | None = None,
                lanes: int | None = None):
    """sum_i k_i P_i over every rank's points (group K): this rank's
    Jacobian batch and canonical scalar limbs ``[16, n]`` (``msm.msm``'s
    arguments; n may be 0).  Returns a batch-1 Jacobian point, the same
    limbs on every rank."""
    _require_group(group)
    n = scalars_local.shape[-1]
    if n:
        part = M.msm(K, points_local, scalars_local, c=c, lanes=lanes)
    else:
        part = G.zero_point(K, 1, scalars_local.device)
    parts = all_gather_partials(pack(part), group)
    acc = unpack_point(K.COORDS, parts[0])
    for other in parts[1:]:
        acc = G.add(K, acc, unpack_point(K.COORDS, other))
    return acc
