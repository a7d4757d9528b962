"""Batched optimal-ate pairing on tensors — counterpart of
bn254_tpu/pairing_jax.py.

The main path (``pairing``, ``pairing_batch``) is the JAX package's fused
TPU path: to_affine (one to_affine kernel a group: a Fermat inversion a
block of lanes, shared by prefix and suffix products), one whole-Miller
kernel for the 85 scheduled steps and the 2 Frobenius addition steps
with their line folds (the bases made in the kernel), the infinity
select, the batch-wide Fq12 product (pairing_batch only) and the final
exponentiation.

``precompute`` + ``miller_loop`` are the prepared-G2 entry (87 line
coefficients computed once per G2 point, then 87 folds), the JAX
package's unfused device route: the 87 G2 steps (rows 14 and 7) in one
g2_precompute kernel, then the 64 squares and 87 folds (rows 13 and 8) in
one miller_loop kernel, as the JAX package's scans run them.  They run no
Miller kernel (row 6), so they check it independently.  The tower-op
steps ``_doubling_step`` / ``_addition_step`` are a third spelling, held
against both in the tests.
"""

from __future__ import annotations

import numpy as np
import torch

from . import fused as FU
from . import groups as G
from . import tower as T
from .convert import pack, tree_leaves, tree_map, unpack_fq12
from .spec import constants as C

# ---------------------------------------------------------------------------
# Static schedules derived from ATE_NAF (groups/mod.rs:14)
# ---------------------------------------------------------------------------

# 85 scheduled steps (dbl always; add on nonzero digits), then the 2
# Frobenius additions.  Step kinds: 0 = doubling, 1 = add Q, 2 = add -Q.
_PRE_KINDS = []
for _d in C.ATE_NAF:
    _PRE_KINDS.append(0)
    if _d == 1:
        _PRE_KINDS.append(1)
    elif _d == -1:
        _PRE_KINDS.append(2)
_PRE_KINDS = np.array(_PRE_KINDS, dtype=np.int32)
assert len(_PRE_KINDS) + 2 == C.N_COEFFS == 87

# Miller loop: square-before-fold flag per coeff (1 on doubling coeffs).
_SQR_FLAGS = np.array(
    [k == 0 for k in _PRE_KINDS] + [False, False], dtype=np.bool_)
assert _SQR_FLAGS.sum() == 64 and len(_SQR_FLAGS) == 87

# The 87 steps of precompute and of the Miller kernel: the 85 scheduled,
# then the additions of the 2 Frobenius bases (kinds 3 = pi(Q), 4 =
# -pi^2(Q): fused.STEP_KINDS).
_LINE_KINDS = np.concatenate([_PRE_KINDS, [3, 4]]).astype(np.int32)


# ---------------------------------------------------------------------------
# Precompute steps (mod.rs:731-776) — Fq2 batches
# ---------------------------------------------------------------------------

def _doubling_step(r, two_inv):
    """(mod.rs:754-776): returns (new_r, (ell_0, ell_vw, ell_vv))."""
    x, y, z = r
    batch, device = x[0].shape[-1], x[0].device
    a = T.fq2_scale(T.fq2_mul(x, y), two_inv)
    b = T.fq2_sqr(y)
    c = T.fq2_sqr(z)
    d = T.fq2_add(T.fq2_add(c, c), c)
    e = T.fq2_mul(T.fq2_const(C.B2, batch, device), d)
    f = T.fq2_add(T.fq2_add(e, e), e)
    g = T.fq2_scale(T.fq2_add(b, f), two_inv)
    h = T.fq2_sub(T.fq2_sqr(T.fq2_add(y, z)), T.fq2_add(b, c))
    i = T.fq2_sub(e, b)
    j = T.fq2_sqr(x)
    e_sq = T.fq2_sqr(e)

    nx = T.fq2_mul(a, T.fq2_sub(b, f))
    ny = T.fq2_sub(T.fq2_sqr(g), T.fq2_add(T.fq2_add(e_sq, e_sq), e_sq))
    nz = T.fq2_mul(b, h)

    ell_0 = T.fq2_mul_by_xi(i)
    ell_vw = T.fq2_neg(h)
    ell_vv = T.fq2_add(T.fq2_add(j, j), j)
    return (nx, ny, nz), (ell_0, ell_vw, ell_vv)


def _addition_step(r, base):
    """Mixed addition vs an affine base (mod.rs:731-752)."""
    x, y, z = r
    bx, by = base
    d = T.fq2_sub(x, T.fq2_mul(z, bx))
    e = T.fq2_sub(y, T.fq2_mul(z, by))
    f = T.fq2_sqr(d)
    g = T.fq2_sqr(e)
    h = T.fq2_mul(d, f)
    i = T.fq2_mul(x, f)
    j = T.fq2_sub(T.fq2_add(T.fq2_mul(z, g), h), T.fq2_add(i, i))

    nx = T.fq2_mul(d, j)
    ny = T.fq2_sub(T.fq2_mul(e, T.fq2_sub(i, j)), T.fq2_mul(h, y))
    nz = T.fq2_mul(z, h)

    ell_0 = T.fq2_mul_by_xi(T.fq2_sub(T.fq2_mul(e, bx), T.fq2_mul(d, by)))
    ell_vw = d
    ell_vv = T.fq2_neg(e)
    return (nx, ny, nz), (ell_0, ell_vw, ell_vv)


def _mul_by_q(pt):
    """Frobenius endomorphism on affine G2 via twist factors
    (mod.rs:693-699)."""
    x, y = pt
    batch, device = x[0].shape[-1], x[0].device
    return (T.fq2_mul(T.fq2_const(C.TWIST_MUL_BY_Q_X, batch, device), T.fq2_conj(x)),
            T.fq2_mul(T.fq2_const(C.TWIST_MUL_BY_Q_Y, batch, device), T.fq2_conj(y)))


def _frobenius_points(qa):
    """The 2 Frobenius addition bases: Q1 = pi(Q), Q2 = -pi^2(Q), by the
    tower ops (the Miller kernel makes its own)."""
    q1 = _mul_by_q(qa)
    q2 = _mul_by_q(q1)
    return q1, (q2[0], T.fq2_neg(q2[1]))


def precompute(q_affine):
    """87 line-coefficient triples per batch element (mod.rs:701-728), the
    prepared-G2 entry: q_affine is an affine G2 batch ((x, y) of Fq2).
    One g2_precompute kernel runs the 85 scheduled steps and the 2
    Frobenius additions (rows 14 and 7, which the JAX package's device
    route, pairing_jax.py:130-177, runs as a scan that computes both steps
    and selects; the kinds are static here, so only the step taken runs).
    Returns the (ell_0, ell_vw, ell_vv) tree with a leading 87 axis on
    every leaf: views of the one [87, 6, 16, B] tensor."""
    c = FU.g2_precompute(pack(q_affine), _LINE_KINDS)
    return ((c[:, 0], c[:, 1]), (c[:, 2], c[:, 3]), (c[:, 4], c[:, 5]))


# ---------------------------------------------------------------------------
# Miller loop + pairing
# ---------------------------------------------------------------------------

def miller_loop(coeffs, p_affine):
    """87 folds (mod.rs:580-606): f = [sqr] then fold line, the scan of
    pairing_jax.py:203-214 over rows 13 and 8, in one miller_loop kernel.

    coeffs: tree with leading 87 axis; p_affine: affine G1 batch (x, y).
    Returns the un-exponentiated Fq12 batch."""
    px, py = p_affine
    c = torch.stack(tree_leaves(coeffs), 1)                 # [87, 6, 16, B]
    return unpack_fq12(FU.miller_loop(c, px, py, _SQR_FLAGS))


def _miller_f_fused(qa, pa):
    """One Miller kernel launch for the 85 scheduled steps, then the 2
    Frobenius addition steps (mod.rs:717-721, :630-638), each line folded
    into f, the Frobenius bases made in the kernel.  Equal to precompute()
    + miller_loop()."""
    f, _ = FU.miller_precompute(pack(qa), pack(pa), _LINE_KINDS)
    return unpack_fq12(f)


def _miller_f(g2_points, g1_points):
    """Per-lane Miller value; lanes with either point at infinity give
    f = 1 (the reference's silent skip, mod.rs:911-920)."""
    pa, p_inf = G.to_affine(G.G1, g1_points)
    qa, q_inf = G.to_affine(G.G2, g2_points)
    f = _miller_f_fused(qa, pa)
    skip = p_inf | q_inf
    return T.fq12_select(skip, T.fq12_ones(pa[0].shape[-1], pa[0].device), f)


def fq12_product_reduce(f):
    """Product over the batch axis by halving (log depth): the replacement
    for the reference's serial per-pair folds (mod.rs:614-628).  Returns a
    batch-1 Fq12.  (The JAX package keeps the batch constant on the TPU by
    rolling; the card has no 128-lane rule, and the product is the same in
    any order.)"""
    n = f[0][0][0].shape[-1]
    while n > 1:
        half = n // 2
        prod = T.fq12_mul(tree_map(lambda a: a[..., :half], f),
                          tree_map(lambda a: a[..., half:2 * half], f))
        if n % 2:
            prod = tree_map(lambda p, a: torch.cat([p, a[..., 2 * half:]], -1),
                            prod, f)
            n = half + 1
        else:
            n = half
        f = prod
    return f


def miller_loop_batch(g2_points, g1_points):
    """Un-exponentiated product of pairings over the batch axis (Jacobian
    point batches in); a batch-1 Fq12."""
    return fq12_product_reduce(_miller_f(g2_points, g1_points))


def pairing_batch(g1_points, g2_points):
    """Reduced product of pairings (mod.rs:904-926): one shared final
    exponentiation, on the batch-1 product.  Returns a batch-1 Fq12."""
    return T.fq12_final_exponentiation(miller_loop_batch(g2_points, g1_points))


def pairing(g1_point, g2_point):
    """Reduced pairing of batch-aligned points (mod.rs:894-902), per lane;
    infinity in either slot gives the GT identity."""
    return T.fq12_final_exponentiation(_miller_f(g2_point, g1_point))

