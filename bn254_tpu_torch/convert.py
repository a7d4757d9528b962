"""Converters between the JAX package's arrays and the port's tensors.

Both packages hold an Fq value as 16 little-endian 16-bit limbs of its
Montgomery residue (R = 2^256), batch last: the JAX package as uint32
``[16, B]`` arrays, the port as int32 ``[16, B]`` tensors.  Towers and
points are the same nested tuples on both sides (Fq2 = (c0, c1), Fq6 =
three Fq2, Fq12 = two Fq6, a Jacobian point = (x, y, z)), so converting is
a numpy cast per leaf and the same inputs go through both packages.

Kernels take a tuple tree packed into one contiguous ``[c, 16, B]``
tensor, leaves in order (as ``pallas_fused.pack``).
"""

from __future__ import annotations

import numpy as np
import torch


def tree_leaves(tree) -> list:
    """Leaves of a nested tuple, depth first."""
    if isinstance(tree, tuple):
        return [leaf for sub in tree for leaf in tree_leaves(sub)]
    return [tree]


def tree_map(fn, *trees):
    """Apply fn leafwise over nested tuples of one structure."""
    if isinstance(trees[0], tuple):
        return tuple(tree_map(fn, *subs) for subs in zip(*trees))
    return fn(*trees)


def from_numpy(tree, device):
    """JAX-format uint32 arrays (numpy or jax) -> contiguous int32 tensors on
    device (the kernels take contiguous tensors only)."""
    return tree_map(
        lambda a: torch.from_numpy(np.ascontiguousarray(a, dtype=np.int32)).to(device), tree)


def to_numpy(tree):
    """Port tensors -> JAX-format uint32 numpy arrays."""
    return tree_map(lambda t: t.cpu().numpy().astype(np.uint32), tree)


def decode(tree, mod):
    """Leafwise canonical ints (list of B per leaf) through the port's Mod."""
    return tree_map(mod.decode_batch, tree)


def pack(tree):
    """Nested tuple of [16, B] leaves -> contiguous [c, 16, B]."""
    return torch.stack(tree_leaves(tree))


def unpack_fq12(arr):
    return (((arr[0], arr[1]), (arr[2], arr[3]), (arr[4], arr[5])),
            ((arr[6], arr[7]), (arr[8], arr[9]), (arr[10], arr[11])))


def unpack_point(ncoords: int, arr):
    """Packed [3c, 16, B] -> Jacobian triple: Fq leaves for G1 (c = 1),
    Fq2 pairs for G2 (c = 2)."""
    if ncoords == 1:
        return (arr[0], arr[1], arr[2])
    return ((arr[0], arr[1]), (arr[2], arr[3]), (arr[4], arr[5]))
