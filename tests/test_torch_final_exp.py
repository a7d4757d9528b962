"""The final exponentiation's kernels in the port (bn254_tpu_torch on the
CPU): the plain versions of the Fq12 inverse, the Frobenius maps and the
conjugation against the JAX tower run as a tape, the windowed Fermat
chain against Python's pow, the Frobenius factors the kernel multiplies
by against the spec's maps, and the final exponentiation's dispatch on
packed tensors.  Comparisons are exact."""

import random

import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from bn254_tpu import tower as JT
from bn254_tpu_torch import _build, convert, counts
from bn254_tpu_torch import fused as FU
from bn254_tpu_torch import kernel_cases as KC
from bn254_tpu_torch import tower as T
from bn254_tpu_torch.fields import FQ
from bn254_tpu_torch.spec import field as SF
from bn254_tpu_torch.spec.constants import Q
from test_torch_tower import _cyclotomic, _fq12, assert_same, on_tape

# The plain versions run many small tensor ops: intra-op threads only add
# overhead at these batch sizes, and the test workers already run in parallel.
torch.set_num_threads(1)

SEED = 0xF1E7


def _edge_fq12(rng, n):
    """An all-zero Fq12, one of 1s and q - 1s in alternate coefficients,
    then n random ones."""
    mixed = tuple(tuple((1, Q - 1) if (i + j) % 2 else (Q - 1, 1) for j in range(3))
                  for i in range(2))
    zero = tuple(tuple((0, 0) for _ in range(3)) for _ in range(2))
    return [zero, mixed] + [_fq12(rng) for _ in range(n)]


def _packed(a_np):
    return convert.pack(convert.from_numpy(a_np, "cpu"))


def test_fq12_inv_plain_vs_jax_and_zero_maps_to_zero():
    """k_fq12_inv's plain version against JAX fq12_inv (a tape), limb for
    limb; the all-zero lane gives 0."""
    av = _edge_fq12(random.Random(SEED), 3)
    a_np = JT.fq12_encode(av)
    got = FU.fq12_inv_plain(_packed(a_np))
    assert_same(convert.unpack_fq12(got), on_tape(JT.fq12_inv, a_np))
    assert not bool(got[..., 0].any())
    assert T.fq12_decode(convert.unpack_fq12(got))[1:] == [SF.fq12_inv(x) for x in av[1:]]


@pytest.mark.parametrize("power", FU.FROB_POWERS)
def test_fq12_frob_plain_vs_jax(power):
    """k_fq12_frob's plain version for powers 1-3 against JAX fq12_frob and
    for the conjugation (power 6) against JAX fq12_conj."""
    av = _edge_fq12(random.Random(SEED + power), 2)
    a_np = JT.fq12_encode(av)
    got = FU.fq12_frob_plain(_packed(a_np), power)
    want = on_tape((lambda x: JT.fq12_conj(x)) if power == FU.CONJ
                   else (lambda x: JT.fq12_frob(x, power)), a_np)
    assert_same(convert.unpack_fq12(got), want)
    assert not bool(got[..., 0].any())


@pytest.mark.parametrize("power", (1, 2, 3))
def test_frob12_consts_are_the_tuple_code_factors(power):
    """The kernel's one factor a coefficient (_build.frob12_consts, in the
    generated header) gives the spec's Frobenius map: conj^p(a_k) times
    factor k equals coefficient k of spec fq12_frob."""
    rng = random.Random(SEED + 10 + power)
    factors = _build.frob12_consts(power)
    for a in [_fq12(rng) for _ in range(3)]:
        coeffs = [c for half in a for c in half]
        got = [SF.fq2_mul(SF.fq2_frob(c, power), f) for c, f in zip(coeffs, factors)]
        want = [c for half in SF.fq12_frob(a, power) for c in half]
        assert got == want


_EXPONENTS = {"1": 1, "2": 2, "3": 3, "q-2": Q - 2, "(q-3)/4": (Q - 3) // 4,
              "(q-1)/2": (Q - 1) // 2}


@pytest.mark.parametrize("name", sorted(_EXPONENTS))
def test_fq_pow_plain_window_chain_vs_pow(name):
    """Row 5's plain version runs the kernel's sliding-window chain: a^e on
    0, 1, q - 1 and random residues equals Python's pow."""
    e = _EXPONENTS[name]
    rng = random.Random(SEED + 20)
    vals = [0, 1, Q - 1] + [rng.randrange(Q) for _ in range(3)]
    got = FU.fq_pow_plain(FQ.encode(vals, "cpu"), e)
    assert FQ.decode(got) == [pow(v, e, Q) for v in vals]


def test_fq_pow_bound_counts_the_window_chain():
    """pow_digits(q - 2) spells q - 2 with odd digits below 16, at least 4
    bits apart, and the kernel case's work counts the chain the kernel
    runs: the table's square and 7 products, a square a digit after the
    first and a product a nonzero digit, each square at FQ_SQR_PRODUCTS
    (108 word products against a product's 136): less than the binary
    ladder's 253 squares and 109 products."""
    d = FU.pow_digits(Q - 2).ravel()
    value = 0
    for x in d:
        value = 2 * value + int(x)
    assert value == Q - 2
    nz = np.flatnonzero(d)
    assert d[0] != 0 and all(d[nz] % 2 == 1) and d.max() < 16
    assert np.diff(nz).min() >= FU.POW_WINDOW
    squares, products = 1 + len(d) - 1, FU.POW_TABLE - 1 + int((d[1:] != 0).sum())
    assert FU.pow_chain_counts(Q - 2) == (squares, products) == (253, 55)
    assert KC.FQ_SQR_PRODUCTS == 108 / 136
    work = squares * KC.FQ_SQR_PRODUCTS + products
    case = next(c for c in KC.CASES if c.name == "fq_pow")
    a, e = case.make_args(np.random.default_rng(SEED), 10, "cpu")
    assert case.work(a, e) == (int(10 * work), 10 * 2 * 64)
    assert KC.pow_chain_work(Q - 2) == work < 253 * KC.FQ_SQR_PRODUCTS + 109


def test_fq12_inv_bound_counts_the_inverse_and_its_chain():
    """Row 3i's bound: the Fq12 inverse's tower work (2 Fq6 squares at 11,
    the Fq6 inverse's 28.5, the norm's 2 Fq squares and 2 scalings, 2 Fq6
    products at 15) plus the norm's Fermat chain, 24 Fq of bytes a lane."""
    case = next(c for c in KC.CASES if c.name == "fq12_inv")
    (a,) = case.make_args(np.random.default_rng(SEED), 10, "cpu")
    tower = 2 * 11 + 28.5 + 2 * KC.FQ_SQR_PRODUCTS + 2 + 2 * 15
    assert KC.FQ12_INV_PRODUCTS == tower
    assert case.work(a) == (int(10 * (tower + KC.pow_chain_work(Q - 2))), 10 * 24 * 64)


class _CountOutside(TorchDispatchMode):
    """Counts aten ops dispatched while no kernel wrapper is running."""

    def __init__(self):
        super().__init__()
        self.ops, self.depth = 0, 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if self.depth == 0:
            self.ops += 1
        return func(*args, **(kwargs or {}))


def test_final_exponentiation_dispatches_few_ops_outside_the_kernels(monkeypatch):
    """At B = 4 the final exponentiation runs on one packed tensor from
    kernel wrapper to kernel wrapper: fewer than 100 aten ops outside the
    wrappers (the tuple code dispatched thousands), one Fq12 inverse and 11
    Frobenius maps or conjugations, and its result equals the spec's on
    cyclotomic and random inputs."""
    mode = _CountOutside()
    calls = {}

    def counted(name, fn):
        def wrapper(*args):
            calls[name] = calls.get(name, 0) + 1
            mode.depth += 1
            try:
                return fn(*args)
            finally:
                mode.depth -= 1
        return wrapper

    for name in ("fq12_inv", "fq12_frob", "fq12_mul", "fq12_cyc_sqr", "fq12_cyc_pow"):
        monkeypatch.setattr(FU, name, counted(name, getattr(FU, name)))
    rng = random.Random(SEED + 30)
    av = _cyclotomic([_fq12(rng) for _ in range(2)]) + [_fq12(rng) for _ in range(2)]
    a = T.fq12_encode(av, "cpu")
    counts.reset()
    with mode:
        out = T.fq12_final_exponentiation(a)
    assert mode.ops < 100
    assert calls == {"fq12_inv": 1, "fq12_frob": 11, "fq12_mul": 12, "fq12_cyc_sqr": 3,
                     "fq12_cyc_pow": 3}
    assert counts.plain_calls["fq12_inv"] == 1 and counts.plain_calls["fq12_frob"] == 11
    assert T.fq12_decode(out) == [SF.fq12_final_exponentiation(x) for x in av]
