"""The port's scalar API (bn254_tpu_torch.api, re-exported by the package)
against the JAX package's (bn254_tpu.api) on the same seeded inputs, on
the native host engine and on the spec, the
batched API over its objects (batch.pairing_batch / pairing_each on the
CPU) against the JAX package's host pairing, and chip_smoke.py's
inversion phase (its inputs and the kernels each check launches, the
launch stubbed).  Results are compared as canonical values: ints, Fq2
pairs, Jacobian triples, Fq12 tuples, and the names of raised errors."""

import importlib.util
import os
import random

import numpy as np
import pytest
import torch

import bn254_tpu
import bn254_tpu.api as JA
import bn254_tpu.errors as JE
import bn254_tpu.native as JN
import bn254_tpu_torch
import bn254_tpu_torch.api as TA
import bn254_tpu_torch.errors as TE
import bn254_tpu_torch.native as TN
from bn254_tpu.spec.constants import Q, R
from bn254_tpu_torch import batch as BA
from bn254_tpu_torch import counts
from bn254_tpu_torch import fused as FU
from bn254_tpu_torch import mont_kernels as MK
from bn254_tpu_torch import tower as T
from bn254_tpu_torch.fields import FQ, FR
from test_torch_pairing import _stub_launch
import golden

torch.set_num_threads(1)

SEED = 0xA91
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _ints(rng, n, mod):
    """n ints below mod from a numpy generator (512 random bits each)."""
    return [int.from_bytes(rng.bytes(64), "big") % mod for _ in range(n)]


def canon(x):
    """An API object (or a nest of them) as plain values."""
    if isinstance(x, (list, tuple)):
        return [canon(v) for v in x]
    if isinstance(x, (JA._Fp, TA._Fp)):
        return (type(x).__name__, x.v)
    if isinstance(x, (JA.Fq2, TA.Fq2)):
        return ("Fq2", x.c)
    if isinstance(x, (JA._Point, TA._Point)):
        return (type(x).__name__, x.p)
    if isinstance(x, (JA.AffineG1, JA.AffineG2, TA.AffineG1, TA.AffineG2)):
        return (type(x).__name__, x.a)
    if isinstance(x, (JA.Gt, TA.Gt)):
        return ("Gt", x.f)
    return x


def outcome(api, fn):
    """fn()'s canonical value, or ("raise", the error's class and its
    bases) where it raises one of api's own errors."""
    errors = JE if api is JA else TE
    try:
        return canon(fn())
    except errors.BNError as e:
        return ("raise", [c.__name__ for c in type(e).__mro__[:-2]])


def case_fields(api, rng):
    out = []
    for cls, mod in ((api.Fr, R), (api.Fq, Q)):
        a, b, e = (cls(v) for v in _ints(rng, 3, mod))
        zero = cls.zero()
        out += [a + b, a - b, a * b, -a, a.pow(api.Fr(e.v)), a.inverse(), zero.inverse(),
                zero.is_zero(), a.is_zero(), a == b, a == cls(a.v), hash(a) == hash(cls(a.v)),
                a.to_big_endian(), a.into_int(), cls.one(), repr(a),
                cls.from_str("1234567"), cls.from_str("12a"), cls.from_str(""),
                cls.random(random.Random(int(rng.integers(1 << 30))))]
        out.append(outcome(api, lambda: cls.interpret(rng.bytes(64))))
        out.append(outcome(api, lambda: cls.interpret(b"\x01" * 63)))
        out.append(outcome(api, lambda: cls.from_slice((mod + 7).to_bytes(32, "big"))))
        out.append(outcome(api, lambda: cls.from_slice(a.to_big_endian())))
        out.append(outcome(api, lambda: cls.from_slice(b"\x00" * 31)))
    out += [api.Fr.new(R), api.Fr.new(R - 1), api.Fr.new_mul_factor(R + 3), api.Fq.modulus()]
    out.append(outcome(api, lambda: api.Fq.from_u256(Q)))
    out.append(outcome(api, lambda: api.Fq.from_u256(Q - 1)))
    return out


def case_sqrt(api, rng):
    xs = [api.Fq(v) for v in _ints(rng, 6, Q)]
    args = [x * x for x in xs] + [api.Fq(Q - 1), api.Fq(0), api.Fq(golden.SQRT_FQ_ARG)] + xs
    root = api.Fq(golden.SQRT_FQ_ARG).sqrt()
    return [x.sqrt() for x in args] + [root == api.Fq(golden.SQRT_FQ_ROOT)]


def case_set_bit(api, rng):
    """Fr.set_bit on the Montgomery repr (lib.rs:65-67), out-of-range bits
    ignored; its documented divergence for reprs pushed past r."""
    out = []
    for v, bit in zip(_ints(rng, 12, R), [0, 1, 7, 64, 128, 200, 253, 254, 255, 256, 300, -1]):
        for to in (True, False):
            a = api.Fr(v)
            out.append((a.set_bit(bit, to), a))
    return out


def case_fq2(api, rng):
    a, b = (api.Fq2(*_ints(rng, 2, Q)) for _ in range(2))
    zero = api.Fq2.zero()
    out = [a + b, a - b, a * b, -a, a.pow(int(rng.integers(1 << 40))), (a * a).sqrt(),
           api.Fq2(api.Fq(Q - 1), api.Fq(0)).sqrt(), api.Fq2(3, 0).sqrt(), a.inverse(),
           zero.inverse(), a.to_u512(), a.real(), a.imaginary(), api.Fq2.one(), api.Fq2.i(),
           zero.is_zero(), a == b, hash(a) == hash(api.Fq2(*a.c)), repr(a)]
    for v in (Q, Q * Q - 1, Q * Q, a.to_u512()):
        out.append(outcome(api, lambda: api.Fq2.from_slice(v.to_bytes(64, "big"))))
    out.append(outcome(api, lambda: api.Fq2.from_slice(b"\xff" * 64)))
    out.append(outcome(api, lambda: api.Fq2.from_slice(b"\x00" * 63)))
    return out


def case_group(api, rng):
    out = []
    for G, A in ((api.G1, api.AffineG1), (api.G2, api.AffineG2)):
        k, m = (api.Fr(v) for v in _ints(rng, 2, R))
        p, q = G.one() * k, G.one() * m
        r = p + q
        n = G.one() * k
        n.normalize()
        z = G.zero()
        z.normalize()
        out += [p, q, r, p - q, -p, p.double(), p + p == p.double(), p * api.Fr(0), G.zero(),
                G.zero() + p, p - p, n, n == p, hash(n) == hash(p), z, p.x(), p.y(), p.z(),
                p.is_zero(), G.zero().is_zero(), G.b(), repr(p),
                G.random(random.Random(int(rng.integers(1 << 30)))),
                A.from_jacobian(G.zero()), A.from_jacobian(p), -A.from_jacobian(p),
                A.from_jacobian(p).to_jacobian() == p, A.from_jacobian(p).x(),
                A.from_jacobian(p).y()]
    out.append(outcome(api, lambda: api.AffineG1(api.Fq(1), api.Fq(2))))
    out.append(outcome(api, lambda: api.AffineG1(api.Fq(1), api.Fq(1))))
    g2 = api.AffineG2.from_jacobian(api.G2.one())
    out.append(outcome(api, lambda: api.AffineG2(g2.x(), g2.y())))
    out.append(outcome(api, lambda: api.AffineG2(g2.x(), g2.x())))
    return out


def case_compressed(api, rng):
    """from_compressed on tests/golden.py's vectors and the error taxonomy
    of bad encodings: a bad prefix on a valid x is InvalidEncoding, x = 0
    NotMemberCurveError (the square root before the prefix), a wrong
    length InvalidEncoding, x >= q NotMemberFieldError."""
    g1 = bytes.fromhex(golden.G1_COMPRESSED_HEX)
    blobs1 = [g1, bytes([9]) + g1[1:], b"\x02\x00", bytes([2]) + b"\x00" * 32,
              bytes([3]) + Q.to_bytes(32, "big"), g1 + b"\x00"]
    blobs2 = [bytes.fromhex(h) for h in (golden.G2_COMPRESSED_HEX,
                                         golden.G2_COMPRESSED_HEX_REFLECT,
                                         golden.G2_COMPRESSED_HEX_BADPREFIX)]
    blobs2 += [bytes([0x0A]) + b"\x00" * 64, bytes([0x0A]) + b"\xff" * 64, blobs2[0][:64]]
    return ([outcome(api, lambda: api.G1.from_compressed(b)) for b in blobs1]
            + [outcome(api, lambda: api.G2.from_compressed(b)) for b in blobs2])


def case_gt(api, rng):
    k = api.Fr(_ints(rng, 1, R)[0])
    e = api.pairing(api.G1.one(), api.G2.one())
    m = api.miller_loop_batch([(api.G2.one(), api.G1.one() * k)])
    return [e, e.pow(k), e.pow(api.Fr(0)), e.inverse(), e.inverse() * e, e * e, api.Gt.one(),
            api.Gt.one().inverse(), e.is_zero(), m, m.final_exponentiation(),
            m.final_exponentiation() == e.pow(k), e == api.Gt(e.f), hash(e) == hash(api.Gt(e.f))]


def case_pairing(api, rng):
    k, m, s = (api.Fr(v) for v in _ints(rng, 3, R))
    p, q = api.G1.one() * k, api.G2.one() * m
    gold = api.pairing(api.G1.one() * api.Fr(golden.MILLER_G1_SCALAR),
                       api.G2.one() * api.Fr(golden.MILLER_G2_SCALAR))
    return [api.pairing(p, q), api.pairing(p * s, q) == api.pairing(p, q).pow(s),
            api.pairing(api.G1.zero(), q), api.pairing(p, api.G2.zero()),
            api.pairing_batch([(p, q), (api.G1.zero(), q), (p * s, q), (p, api.G2.zero())]),
            api.pairing_batch([]), gold.f == golden.REDUCED_PAIRING_EXPECTED,
            api.miller_loop_batch([(q, p), (q, p * s)]),
            outcome(api, lambda: api.miller_loop_batch([(api.G2.zero(), p)])),
            outcome(api, lambda: api.miller_loop_batch([(q, p), (q, api.G1.zero())]))]


CASES = {f.__name__[5:]: f for f in (case_fields, case_sqrt, case_set_bit, case_fq2, case_group,
                                     case_compressed, case_gt, case_pairing)}


@pytest.mark.parametrize("engine", ["native", "spec"])
@pytest.mark.parametrize("case", sorted(CASES))
def test_scalar_api_equals_the_jax_api(case, engine, monkeypatch):
    """The same seeded inputs through bn254_tpu.api and bn254_tpu_torch.api
    give the same canonical values and the same errors, with each API on
    its native host engine and with both on the spec (BN254_NO_NATIVE=1).
    The JAX API's bridge (bn254_tpu/native.py) loads native/'s library,
    which the tree does not build; it is handed the port's build of the
    same C source and constants (tests/test_torch_native.py holds both
    equal), so both sides run the engine's own Jacobian representatives."""
    if engine == "native":
        monkeypatch.delenv("BN254_NO_NATIVE", raising=False)
        monkeypatch.setattr(JN, "_LIB", TN.load())
        monkeypatch.setattr(JA, "_NATIVE", True)
    else:
        monkeypatch.setenv("BN254_NO_NATIVE", "1")
        monkeypatch.setattr(JA, "_NATIVE", False)
    assert TN.enabled() == (engine == "native")
    fn = CASES[case]
    got = canon(fn(TA, np.random.default_rng(SEED)))
    want = canon(fn(JA, np.random.default_rng(SEED)))
    assert got == want
    assert any(isinstance(v, list) and v and v[0] == "raise" for v in got) == (
        case in ("fields", "fq2", "group", "compressed", "pairing"))


def test_package_reexports_the_api_and_the_errors():
    """Every name of bn254_tpu.api.__all__ is in bn254_tpu_torch.api and
    re-exported by the package, as bn254_tpu/__init__.py does, with the
    errors module and its four base classes."""
    assert TA.__all__ == JA.__all__
    for name in JA.__all__:
        assert getattr(bn254_tpu_torch, name) is getattr(TA, name), name
        assert hasattr(bn254_tpu, name)
    assert bn254_tpu_torch.errors is TE
    for name in ("BNError", "FieldError", "CurveError", "GroupError"):
        assert getattr(bn254_tpu_torch, name) is getattr(TE, name)
    assert bn254_tpu_torch.pairing is TA.pairing      # not the pairing_torch module


def test_package_version_equals_the_jax_packages():
    assert bn254_tpu_torch.__version__ == bn254_tpu.__version__ == "0.1.0"


def test_batch_pairing_on_cpu_equals_the_jax_host_api(monkeypatch):
    """batch.pairing_batch (two chunks: PAIRING_CHUNK set to 2) and
    pairing_each on 3 pairs with an infinity pair, on the CPU, against
    bn254_tpu.api.pairing_batch and pairing on the same points; an empty
    input gives Gt.one() and []."""
    monkeypatch.setattr(BA, "PAIRING_CHUNK", 2)
    rng = np.random.default_rng(SEED + 1)
    ks = _ints(rng, 6, R)
    pairs = {api: [(api.G1.one() * api.Fr(a), api.G2.one() * api.Fr(b))
                   for a, b in zip(ks[:3], ks[3:])] for api in (TA, JA)}
    for api in (TA, JA):
        pairs[api][1] = (api.G1.zero(), pairs[api][1][1])
    got = BA.pairing_batch(pairs[TA], device="cpu")
    assert isinstance(got, TA.Gt)
    assert canon(got) == canon(JA.pairing_batch(pairs[JA]))
    each = BA.pairing_each(pairs[TA], device="cpu")
    assert all(isinstance(g, TA.Gt) for g in each)
    assert canon(each) == canon([JA.pairing(p, q) for p, q in pairs[JA]])
    assert each[1] == TA.Gt.one() and each[0] * each[2] == got
    assert BA.pairing_batch([], device="cpu") == TA.Gt.one()
    assert BA.pairing_each([], device="cpu") == []


def _chip_smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke", os.path.join(REPO, "chip_smoke.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_inversion_phase_inputs_and_launches(monkeypatch):
    """chip_smoke.py's inversion phase at a small size: its inputs are the
    reference sweeps' (a = 1..n and -1..-n, zeros, random a != 0 and b,
    the Fq2 a + i, a - i, a + (3k + 1) i), every check holds on the CPU's
    plain versions, and with the wrappers taking their kernel branch and
    the launch stubbed each check launches exactly the kernels it lists
    (with its entry's arguments) and no plain version."""
    CS = _chip_smoke()
    assert (CS.INV_N, CS.INV_FQ2_N) == (10000, 2000)   # tests/test_reference_scale.py's
    n, n2 = 6, 3
    checks = CS.inversion_checks("cpu", n=n, n_fq2=n2)
    assert len(checks) == 8
    by_field = {"fq": (FQ, Q), "fr": (FR, R)}
    for label, inputs, kernels, check in checks:
        name = label.split(":")[0]
        if name in by_field:
            F, p = by_field[name]
            vals = [F.decode(x) for x in inputs]
            if "0^-1" in label:
                assert vals == [[0] * 4]
            elif "random" in label:
                assert len(vals[0]) == len(vals[1]) == n and 0 not in vals[0]
                assert all(0 <= v < p for v in vals[0] + vals[1])
            else:
                assert vals == [list(range(1, n + 1)) + [p - k for k in range(1, n + 1)]]
            assert kernels[0] == ("fq_pow" if F is FQ else "mont_sqr")
        else:
            vals = T.fq2_decode(inputs)
            if "0^-1" in label:
                assert vals == [(0, 0)] * 4
            else:
                c0 = list(range(1, n2 + 1)) + [Q - k for k in range(1, n2 + 1)]
                assert vals == list(zip(c0 * 3, [1] * 2 * n2 + [Q - 1] * 2 * n2
                                        + [3 * k + 1 for k in range(2 * n2)]))
        assert bool(check(*inputs).all()), label

    for mod in (MK, FU):
        monkeypatch.setattr(mod, "on_cuda", lambda t: True)
        monkeypatch.setattr(mod, "launch", _stub_launch)
    for label, inputs, kernels, check in checks:
        counts.reset()
        check(*inputs)
        assert sorted(k for k, v in counts.launches.items() if v) == sorted(kernels), label
        assert not any(counts.plain_calls.values()), label
