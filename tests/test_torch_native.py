"""The port's native host engine (bn254_tpu_torch.native: its own build of
csrc/host/bn254_host.c) against the JAX package's spec oracle and the
reference golden vectors: the cases of tests/test_native.py, held on the
port's bridge.  Also: the copied C source equals native/bn254_host.c byte
for byte, every constant of the port's generated header equals
native/bn254_consts.h's, the OpenMP batch runs in a process that has
loaded torch, BN254_NO_NATIVE is the only route to the spec, and a failed
build raises."""

import os
import random
import re

import pytest
import torch

import bn254_tpu_torch.api as TA
import bn254_tpu_torch.native as N
from bn254_tpu.spec import field as SF
from bn254_tpu.spec import group as SG
from bn254_tpu.spec.constants import R
import golden

SEED = 0xC0DE
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _g1(k):
    return SG.scalar_mul((SG.G1_PARAMS[1][0], SG.G1_PARAMS[1][1],
                          SG.G1_PARAMS[0].one), k, SG.G1_PARAMS[0])


def _g2(k):
    return SG.scalar_mul((SG.G2_PARAMS[1][0], SG.G2_PARAMS[1][1],
                          SG.G2_PARAMS[0].one), k, SG.G2_PARAMS[0])


def _decls(text):
    """{name: value} of every `static const ... NAME[..] = value;` of a
    header, whitespace folded."""
    return {m.group(1): re.sub(r"\s+", " ", m.group(2))
            for m in re.finditer(r"static const [\w ]+? (\w+)(?:\[\d+\])?\s*=\s*(.*?);",
                                 text, re.S)}


def test_source_is_a_byte_copy_of_the_jax_packages():
    with open(os.path.join(REPO, "native", "bn254_host.c"), "rb") as f:
        assert N.SOURCE.read_bytes() == f.read()


def test_generated_header_equals_the_jax_packages():
    """Every declaration of native/bn254_consts.h, with its value, and no
    other, in the header the port generates from its own spec and GLV
    constants."""
    with open(os.path.join(REPO, "native", "bn254_consts.h")) as f:
        want = _decls(f.read())
    got = _decls(N.consts_header())
    assert len(want) == 28
    assert got == want


def test_scalar_mul_parity():
    """bn254_g1_mul / bn254_g2_mul (GLV + width-4 wNAF) against the
    mod.rs:272-292 double-and-add oracle, projectively; the edge scalars
    0, 1, r - 1, (r - 1) / 2 and random bases."""
    rng = random.Random(SEED)
    g1 = (SG.G1_PARAMS[1][0], SG.G1_PARAMS[1][1], SG.G1_PARAMS[0].one)
    g2 = (SG.G2_PARAMS[1][0], SG.G2_PARAMS[1][1], SG.G2_PARAMS[0].one)
    ks = ([0, 1, 2, 3, R - 1, R - 2, (R - 1) // 2]
          + [rng.randrange(R) for _ in range(24)])
    for k in ks:
        assert SG.eq(N.g1_scalar_mul(g1, k),
                     SG.scalar_mul(g1, k, SG.G1_PARAMS[0]), SG.G1_PARAMS[0])
        assert SG.eq(N.g2_scalar_mul(g2, k),
                     SG.scalar_mul(g2, k, SG.G2_PARAMS[0]), SG.G2_PARAMS[0])
    for _ in range(6):
        p = _g1(rng.randrange(1, R))
        q = _g2(rng.randrange(1, R))
        k = rng.randrange(R)
        assert SG.eq(N.g1_scalar_mul(p, k),
                     SG.scalar_mul(p, k, SG.G1_PARAMS[0]), SG.G1_PARAMS[0])
        assert SG.eq(N.g2_scalar_mul(q, k),
                     SG.scalar_mul(q, k, SG.G2_PARAMS[0]), SG.G2_PARAMS[0])


@pytest.mark.parametrize("group", ["g1", "g2"])
def test_add_parity_incl_branches(group):
    """The add's branches: generic, P + P, P + (-P), P + inf, inf + Q,
    inf + inf."""
    rng = random.Random(SEED + 1)
    make, add, ops = ((_g1, N.g1_add, SG.G1_PARAMS[0]) if group == "g1"
                      else (_g2, N.g2_add, SG.G2_PARAMS[0]))
    p = make(rng.randrange(1, R))
    q = make(rng.randrange(1, R))
    cases = [(p, q), (p, p), (p, SG.neg(p, ops)), (p, SG.zero(ops)),
             (SG.zero(ops), q), (SG.zero(ops), SG.zero(ops))]
    for a, b in cases:
        assert SG.eq(add(a, b), SG.add(a, b, ops), ops)


def test_reduced_pairing_golden():
    p = _g1(golden.MILLER_G1_SCALAR)
    q = _g2(golden.MILLER_G2_SCALAR)
    assert N.pairing(p, q) == golden.REDUCED_PAIRING_EXPECTED


def test_miller_loop_golden():
    p = _g1(golden.MILLER_G1_SCALAR)
    q = _g2(golden.MILLER_G2_SCALAR)
    assert N.miller_loop_batch([q], [p]) == golden.MILLER_EXPECTED


def test_pairing_batch_parity():
    rng = random.Random(SEED + 2)
    ps = [_g1(rng.randrange(1, R)) for _ in range(4)]
    qs = [_g2(rng.randrange(1, R)) for _ in range(4)]
    ps[1] = SG.zero(SG.G1_PARAMS[0])      # silent skip
    qs[2] = SG.zero(SG.G2_PARAMS[0])
    assert N.pairing_batch(ps, qs) == SG.pairing_batch(ps, qs)
    assert N.pairing_batch([], []) == SF.FQ12_ONE
    assert N.pairing_batch([SG.zero(SG.G1_PARAMS[0])], [qs[0]]) == SF.FQ12_ONE


def test_openmp_pairing_batch_in_a_process_that_loaded_torch():
    """48 pairs run on 3 OpenMP threads (16 pairs a thread at least) in
    this process, where torch has loaded its own OpenMP runtime and run
    a threaded op first; the result equals the spec's, and so does the
    Pippenger MSM's OpenMP loop."""
    torch.set_num_threads(2)
    try:
        x = torch.randn(256, 256)
        assert torch.isfinite(x @ x).all()
    finally:
        torch.set_num_threads(1)
    rng = random.Random(SEED + 5)
    ks1 = [rng.randrange(1, 1 << 64) for _ in range(48)]
    ks2 = [rng.randrange(1, 1 << 64) for _ in range(48)]
    ps, qs = [_g1(k) for k in ks1], [_g2(k) for k in ks2]
    ps[7] = SG.zero(SG.G1_PARAMS[0])
    want = SG.pairing(_g1(1), _g2(1))
    e = sum(a * b for i, (a, b) in enumerate(zip(ks1, ks2)) if i != 7) % R
    assert N.pairing_batch(ps, qs) == SF.fq12_pow(want, e)


def test_miller_infinity_raises():
    with pytest.raises(ValueError):
        N.miller_loop_batch([SG.zero(SG.G2_PARAMS[0])], [_g1(3)])


def test_fq12_pow_and_final_exp_parity():
    rng = random.Random(SEED + 3)
    f = SG.pairing(_g1(5), _g2(7))
    e = rng.randrange(R)
    assert N.fq12_pow(f, e) == SF.fq12_pow(f, e)
    m = SG.miller_loop(SG.precompute(SG.to_affine(_g2(9), SG.Fq2Ops)),
                       SG.to_affine(_g1(11), SG.FqOps))
    assert N.final_exp(m) == SF.fq12_final_exponentiation(m)


def test_bilinearity_native():
    rng = random.Random(SEED + 4)
    a, b, s = (rng.randrange(1, R) for _ in range(3))
    e1 = N.pairing(_g1(a * s % R), _g2(b))
    e2 = N.pairing(_g1(a), _g2(b * s % R))
    assert e1 == e2 != SF.FQ12_ONE


@pytest.mark.parametrize("group,n", [("g1", 200), ("g2", 48)])
def test_native_msm_vs_spec(group, n):
    """The C Pippenger MSM against the spec's sum, with a zero scalar, an
    infinity point and the scalars 0, 1, r - 1 mixed in."""
    rng = random.Random(0x517 if group == "g1" else 0x527)
    ops, gen = (SG.G1_PARAMS if group == "g1" else SG.G2_PARAMS)[:2]
    ks = [rng.randrange(R) for _ in range(n - 3)] + [0, 1, R - 1]
    pts = [SG.scalar_mul((gen[0], gen[1], ops.one), rng.randrange(1, 1 << 50), ops)
           for _ in range(n)]
    pts[5] = SG.zero(ops)
    want = SG.zero(ops)
    for p, k in zip(pts, ks):
        want = SG.add(want, SG.scalar_mul(p, k, ops), ops)
    got = (N.msm_g1 if group == "g1" else N.msm_g2)(pts, ks)
    assert SG.eq(got, want, ops)


def test_opt_out_runs_the_spec_without_building(monkeypatch, tmp_path):
    """With BN254_NO_NATIVE set, enabled() is False and the API computes
    on the spec, even where no compiler could build the engine."""
    monkeypatch.setenv("BN254_NO_NATIVE", "1")
    monkeypatch.setattr(N, "_LIB", None)
    monkeypatch.setattr(N, "CC", str(tmp_path / "no-such-compiler"))
    monkeypatch.setattr(N, "BUILD_DIR", tmp_path / "host")
    assert not N.enabled()
    e = TA.pairing(TA.G1.one() * TA.Fr(5), TA.G2.one())
    assert e.f == SG.pairing(_g1(5), _g2(1))
    assert N._LIB is None and not (tmp_path / "host").exists()


def test_failed_build_raises_with_the_compilers_output(monkeypatch, tmp_path):
    """No hidden fallback: a build that fails raises from the API's first
    call, with the compiler's output; a compiler that cannot run raises
    too."""
    monkeypatch.delenv("BN254_NO_NATIVE", raising=False)
    monkeypatch.setattr(N, "_LIB", None)
    monkeypatch.setattr(N, "BUILD_DIR", tmp_path / "host")
    broken = tmp_path / "bn254_host.c"
    broken.write_text("#include \"bn254_consts.h\"\nint broken(void) { return }\n")
    monkeypatch.setattr(N, "SOURCE", broken)
    with pytest.raises(RuntimeError, match="build failed") as err:
        TA.pairing(TA.G1.one(), TA.G2.one())
    assert "error" in str(err.value)
    assert not list((tmp_path / "host").glob("*.so"))
    monkeypatch.setattr(N, "CC", str(tmp_path / "no-such-compiler"))
    with pytest.raises(RuntimeError, match="cannot run"):
        N.load()
