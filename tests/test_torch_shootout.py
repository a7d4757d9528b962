"""The port's shootout (bn254_tpu_torch.shootout) and examples
(bn254_tpu_torch.examples.dh, joux) on the CPU: device mode at N = 3 with
chunks of 4 (each accumulator one chunk, its last lane padded with scalar
0) against the Gt.pow oracle and against the same accumulator built with
the JAX package's scalar API (bn254_tpu.api); host mode at N = 3; and
the two examples with seeded keys."""

import random

import torch

import bn254_tpu.api as JA
from bn254_tpu_torch import api as A
from bn254_tpu_torch import counts
from bn254_tpu_torch import shootout as S
from bn254_tpu_torch.examples import dh, joux

torch.set_num_threads(1)

N = 3


def _jax_accumulator(n):
    """shootout/run.py's host accumulate(c, d) on bn254_tpu.api's objects."""
    c, d = JA.Fr.from_str("1901").inverse(), JA.Fr.from_str("2344").inverse()
    a, b, acc = JA.G1.one(), JA.G2.one(), JA.Gt.one()
    for _ in range(n):
        acc = acc * JA.pairing(a, b)
        a, b = a * c, b * d
    return acc


def test_device_mode_equals_the_oracle_and_the_jax_api(monkeypatch):
    """Both accumulators through the GLV ladders, the Miller kernel's plain
    version and the product tree (acc1 == acc2 is asserted inside), equal
    e(G1, G2)^(sum (cd)^i) and the JAX API's accumulator; no kernel
    launched, the plain versions ran."""
    monkeypatch.setenv("BN254_SHOOTOUT_CHUNK", "4")
    counts.reset()
    dt, acc = S.device(N, device="cpu")
    assert dt > 0 and isinstance(acc, A.Gt)
    assert acc == S.oracle(N)
    assert acc.f == _jax_accumulator(N).f
    assert not any(counts.launches.values())
    assert counts.plain_calls["glv_ladder"] == 4 and counts.plain_calls["miller_precompute"] == 2


def test_host_mode_equals_the_oracle():
    dt, acc = S.host(N)
    assert dt > 0 and acc == S.oracle(N) != A.Gt.one()
    assert acc.f == _jax_accumulator(N).f


def test_examples_agree_with_seeded_keys():
    """dh and joux with an explicit random.Random: the same seed gives the
    same secret, and the secrets are what the keys make."""
    s = dh.main(random.Random(11))
    assert s == dh.main(random.Random(11))
    rng = random.Random(11)
    a, b, c = (A.Fr.random(rng) for _ in range(3))
    assert s == A.G1.one() * (a * b * c)
    ss = joux.main(random.Random(12))
    rng = random.Random(12)
    a, b, c = (A.Fr.random(rng) for _ in range(3))
    assert ss == A.pairing(A.G1.one(), A.G2.one()).pow(a * b * c) != A.Gt.one()
