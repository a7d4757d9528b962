"""The port's G1/G2 codecs, Miller loop and reduced pairing (bn254_tpu_torch
on the CPU, plain versions of every kernel) against the JAX package's
pairing, the spec oracle and the reference's golden vectors, on the same
inputs.  Comparisons are exact."""

import ast
import functools
import os
import random
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch

from bn254_tpu import groups as JG
from bn254_tpu import pairing_jax as JP
from bn254_tpu import tape
from bn254_tpu import tower as JT
from bn254_tpu.spec import field as SF
from bn254_tpu.spec import group as SG
from bn254_tpu.spec.constants import Q, R
from bn254_tpu_torch import convert, counts
from bn254_tpu_torch import fused as FU
from bn254_tpu_torch import groups as G
from bn254_tpu_torch import mont_kernels as MK
from bn254_tpu_torch import pairing_torch as P
from bn254_tpu_torch import tower as T
import test_torch_tower as TT
from test_torch_tower import assert_same, on_tape
import golden

# The plain versions run many small tensor ops: intra-op threads only add
# overhead at these batch sizes, and the test workers already run in parallel.
torch.set_num_threads(1)

SEED = 0xB17E
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
OPS1, OPS2 = SG.G1_PARAMS[0], SG.G2_PARAMS[0]


def _g1(k):
    return SG.scalar_mul((SG.G1_PARAMS[1][0], SG.G1_PARAMS[1][1], OPS1.one), k, OPS1)


def _g2(k):
    return SG.scalar_mul((SG.G2_PARAMS[1][0], SG.G2_PARAMS[1][1], OPS2.one), k, OPS2)


def assert_packed(packed, jax_tree):
    """A packed [c, 16, B] port tensor holds the JAX tree's leaves in order."""
    want = np.stack([np.asarray(x) for x in jax.tree.leaves(jax_tree)])
    assert np.array_equal(packed.numpy().astype(np.uint32), want)


def _rand_fq2_np(rng, n):
    return JT.fq2_encode([(rng.randrange(Q), rng.randrange(Q)) for _ in range(n)])


def _affine_pairs(scalars):
    """Affine (G1, G2) batches of k*G for (a, b) in scalars, JAX format."""
    ps = [SG.to_affine(_g1(a), OPS1) for a, _ in scalars]
    qs = [SG.to_affine(_g2(b), OPS2) for _, b in scalars]
    pa = tuple(JG.G1.encode([p[k] for p in ps]) for k in range(2))
    qa = tuple(JT.fq2_encode([q[k] for q in qs]) for k in range(2))
    return pa, qa


def test_schedules_match_jax():
    assert np.array_equal(P._PRE_KINDS, JP._PRE_KINDS)
    assert np.array_equal(P._SQR_FLAGS, JP._SQR_FLAGS)


def test_to_affine_vs_jax():
    """G1 and G2 to_affine (the to_affine kernel's plain version on the
    CPU, which serves rows 1-5) on Jacobian points with z != 1 and an
    infinity lane, and its shared inversion at blocks of 1, 2 and 4 lanes
    against the same JAX outputs."""
    rng = random.Random(SEED)
    ps = [_g1(rng.randrange(1, R)) for _ in range(3)] + [SG.zero(OPS1)]
    qs = [SG.zero(OPS2)] + [_g2(rng.randrange(1, R)) for _ in range(3)]
    for jk, pk, ops, pts, zero in ((JG.G1, G.G1, OPS1, ps, 0),
                                   (JG.G2, G.G2, OPS2, qs, (0, 0))):
        j_np = jax.tree.map(np.asarray, JG.encode_points(jk, pts))
        port = G.encode_points(pk, pts, "cpu")
        assert_same(port, j_np)
        assert G.decode_points(pk, port) == pts
        (x, y), inf = G.to_affine(pk, port)
        (jx, jy), jinf = jax.jit(lambda p, jk=jk: JG.to_affine(jk, p))(j_np)
        assert_same((x, y), (jx, jy))
        assert inf.tolist() == np.asarray(jinf).tolist() == [SG.is_zero(p, ops) for p in pts]
        for block in (1, 2, 4):
            xy, binf = FU.to_affine_plain(pk.COORDS, convert.pack(port), block)
            assert_packed(xy, (jx, jy))
            assert torch.equal(binf, inf)
        for xv, yv, p in zip(pk.decode(x), pk.decode(y), pts):
            assert (xv, yv) == (SG.to_affine(p, ops) or (zero, zero))   # inv(0) = 0


def test_precompute_all_87_coefficients():
    """Every one of the 87 line-coefficient triples of precompute (on the
    g2_precompute wrapper's plain version) against the spec's and the JAX
    package's (whose tests check the count, the first and the last)."""
    qa_spec = [golden.PREPARED_G2_Q, SG.to_affine(_g2(0x5EED), OPS2)]
    qa_np = tuple(JT.fq2_encode([q[k] for q in qa_spec]) for k in range(2))
    coeffs = P.precompute(convert.from_numpy(qa_np, "cpu"))
    assert_same(coeffs, jax.jit(JP.precompute)(qa_np))
    for lane, q in enumerate(qa_spec):
        got = [tuple(T.fq2_decode(tuple(c[i] for c in ell))[lane] for ell in coeffs)
               for i in range(87)]
        assert got == SG.precompute(q)
    first = tuple(T.fq2_decode(tuple(c[0] for c in ell))[0] for ell in coeffs)
    assert first == golden.PREPARED_G2_COEFF_FIRST


def test_doubling_and_addition_steps_vs_jax():
    """The stacked G2 line steps inside the plain Miller (row 6) and the
    g2_add_step plain version (row 7) against pairing_jax's steps."""
    rng = random.Random(SEED + 1)
    r_np = tuple(_rand_fq2_np(rng, 4) for _ in range(3))
    base_np = tuple(_rand_fq2_np(rng, 4) for _ in range(2))
    r, base = (convert.pack(t) for t in convert.from_numpy((r_np, base_np), "cpu"))
    two_inv = JG.G1.encode([pow(2, Q - 2, Q)] * 4)
    nr, c = FU._dbl_step(r.view(3, 2, 16, 4))
    assert_packed(torch.cat([nr.reshape(6, 16, 4), c.reshape(6, 16, 4)]),
                  on_tape(JP._doubling_step, r_np, two_inv))
    assert_packed(torch.cat(FU.g2_add_step(r, base)), on_tape(JP._addition_step, r_np, base_np))


def test_fq12_sqr_plain_vs_jax():
    """Row 13's plain version (and tower.fq12_sqr, which routes to its
    wrapper) against the JAX package's tower.fq12_sqr."""
    rng = random.Random(SEED + 8)
    f_np = JT.fq12_encode([tuple(tuple((rng.randrange(Q), rng.randrange(Q))
                                       for _ in range(3)) for _ in range(2))
                           for _ in range(4)] + [SF.FQ12_ONE])
    want = on_tape(JT.fq12_sqr, f_np)
    f = convert.from_numpy(f_np, "cpu")
    assert_packed(FU.fq12_sqr_plain(convert.pack(f)), want)
    assert_same(T.fq12_sqr(f), want)


def test_g2_dbl_step_plain_and_tower_steps_vs_jax():
    """Row 14's plain version against pairing_jax._doubling_step at 8
    lanes, and the port's tower-op steps (pairing_torch._doubling_step /
    _addition_step, the third spelling) against pairing_jax's."""
    rng = random.Random(SEED + 9)
    r_np = tuple(_rand_fq2_np(rng, 8) for _ in range(3))
    base_np = tuple(_rand_fq2_np(rng, 8) for _ in range(2))
    two_inv_np = JG.G1.encode([pow(2, Q - 2, Q)] * 8)
    r, base, two_inv = convert.from_numpy((r_np, base_np, two_inv_np), "cpu")
    want_dbl = on_tape(JP._doubling_step, r_np, two_inv_np)
    assert_packed(torch.cat(FU.g2_dbl_step_plain(convert.pack(r))), want_dbl)
    assert_same(P._doubling_step(r, two_inv), want_dbl)
    assert_same(P._addition_step(r, base), on_tape(JP._addition_step, r_np, base_np))


def _stub_launch(name, batch, *args):
    """fused.launch without the card: the arguments must match the C
    entry's signature (_build._SIGS); count the launch."""
    from bn254_tpu_torch import _build
    assert len(args) == len(_build._SIGS[name]), (name, len(args))
    counts.launches[name] += 1


def test_prepared_miller_reaches_its_kernels_with_valid_arguments(monkeypatch):
    """precompute + miller_loop with the wrappers taking their kernel
    branch on CPU tensors and the launch stubbed out: every check passes,
    one g2_precompute launch (the 87 G2 steps, the Frobenius bases among
    them) with its entry's arguments and one miller_loop launch (its 64
    squares and 87 folds), no one-op g2_dbl_step, g2_add_step, fq2_mul,
    fq12_sqr or fq12_fold_line launch, and no plain version runs."""
    _stub_kernels(monkeypatch)
    rng = random.Random(SEED + 10)
    pa_np, qa_np = _affine_pairs([(rng.randrange(1, R), rng.randrange(1, R)) for _ in range(3)])
    pa, qa = convert.from_numpy((pa_np, qa_np), "cpu")
    counts.reset()
    P.miller_loop(P.precompute(qa), pa)
    assert sorted(k for k, v in counts.launches.items() if v) == sorted(counts.PREPARED_MILLER_PATH)
    assert [counts.launches[k] for k in ("g2_precompute", "miller_loop", "g2_dbl_step",
                                         "g2_add_step", "fq2_mul", "fq12_sqr",
                                         "fq12_fold_line")] == [1, 1, 0, 0, 0, 0, 0]
    assert not any(counts.plain_calls.values())


def test_fold_line_vs_jax():
    """Row 8's plain version: f * line with ell_vv*px and ell_vw*py."""
    rng = random.Random(SEED + 2)
    f_np = JT.fq12_encode([tuple(tuple((rng.randrange(Q), rng.randrange(Q))
                                       for _ in range(3)) for _ in range(2))
                           for _ in range(4)])
    c_np = tuple(_rand_fq2_np(rng, 4) for _ in range(3))
    px_np, py_np = (JG.G1.encode([rng.randrange(Q) for _ in range(4)]) for _ in range(2))
    want = on_tape(lambda f, c, px, py: JT.fq12_mul_by_024(
        f, c[0], JT.fq2_scale(c[2], px), JT.fq2_scale(c[1], py)), f_np, c_np, px_np, py_np)
    f, c, px, py = convert.from_numpy((f_np, c_np, px_np, py_np), "cpu")
    assert_packed(FU.fq12_fold_line(convert.pack(f), convert.pack(c), px, py), want)


@functools.lru_cache(maxsize=1)
def _jax_miller_case():
    """Two random affine pairs and the JAX package's CPU Miller loop of
    them (precompute interleaved with the fold, tape.py), made once for
    the tests that compare with it."""
    rng = random.Random(SEED + 3)
    pa_np, qa_np = _affine_pairs([(rng.randrange(1, R), rng.randrange(1, R))
                                  for _ in range(2)])
    return pa_np, qa_np, on_tape(lambda q, p: tape._tape_miller_fused(p, q), qa_np, pa_np)


def test_miller_f_fused_vs_jax_miller_loop():
    """The one-launch Miller layer (row 6's plain version, one call over
    the 87 kinds: the 85 scheduled steps, then the 2 Frobenius additions
    and folds, the bases made by fused._step_bases) against the JAX
    package's _miller_f_fused (pairing_jax.py:221-237) as its CPU tape
    spells it (tape._tape_miller_fused: the 85 steps interleaved with the
    fold, then _mul_by_q twice and the 2 Frobenius additions and folds),
    and against the port's prepared-G2 entry, precompute + miller_loop
    (rows 7, 8, 13, 14)."""
    pa_np, qa_np, want = _jax_miller_case()
    pa, qa = convert.from_numpy((pa_np, qa_np), "cpu")
    counts.reset()
    got = P._miller_f_fused(qa, pa)
    assert [counts.plain_calls[k] for k in ("miller_precompute", *counts.FROBENIUS_TAIL_ONE_OPS)] \
        == [1, 0, 0, 0]
    assert_same(got, want)
    assert_same(got, convert.to_numpy(P.miller_loop(P.precompute(qa), pa)))


def test_team_miller_loop_vs_jax_miller_loop(monkeypatch):
    """The fused Miller loop with the team Miller kernel's CPU model in
    place of row 6 equals the JAX package's CPU Miller loop on the same
    pairs (the tape of test_miller_f_fused_vs_jax_miller_loop)."""
    pa_np, qa_np, want = _jax_miller_case()
    monkeypatch.setattr(FU, "miller_precompute", TT.team_miller_precompute)
    assert_same(P._miller_f_fused(*convert.from_numpy((qa_np, pa_np), "cpu")), want)


def _team_loop(c, px, py, flags):
    """fused.miller_loop with k_miller_loop's CPU model in place of the kernel."""
    return TT.team_miller_loop(len(flags), flags, None, c, px, py)


def test_team_miller_loop_route_vs_jax_miller_loop(monkeypatch):
    """The prepared-G2 entry, precompute + miller_loop, with the team loop
    kernel's CPU model in place of k_miller_loop equals the JAX package's
    CPU Miller loop on the same pairs (the tape of
    test_miller_f_fused_vs_jax_miller_loop)."""
    pa_np, qa_np, want = _jax_miller_case()
    pa, qa = convert.from_numpy((pa_np, qa_np), "cpu")
    monkeypatch.setattr(FU, "miller_loop", _team_loop)
    assert_same(P.miller_loop(P.precompute(qa), pa), want)


def test_team_loop_model_on_precomputed_lines():
    """The team loop's CPU model equals miller_loop_plain limb for limb on
    the 87 lines precompute makes for 3 real affine pairs."""
    rng = random.Random(SEED + 28)
    pa_np, qa_np = _affine_pairs([(rng.randrange(1, R), rng.randrange(1, R)) for _ in range(3)])
    pa, qa = convert.from_numpy((pa_np, qa_np), "cpu")
    c = torch.stack(convert.tree_leaves(P.precompute(qa)), 1)
    assert torch.equal(_team_loop(c, *pa, P._SQR_FLAGS),
                       FU.miller_loop_plain(c, *pa, P._SQR_FLAGS))


def test_miller_loop_batch_golden():
    """Un-exponentiated Miller value (mod.rs:642-691)."""
    pd = G.encode_points(G.G1, [_g1(golden.MILLER_G1_SCALAR)], "cpu")
    qd = G.encode_points(G.G2, [_g2(golden.MILLER_G2_SCALAR)], "cpu")
    assert T.fq12_decode(P.miller_loop_batch(qd, pd))[0] == golden.MILLER_EXPECTED


def test_pairing_vs_jax_and_golden():
    """Per-lane reduced pairing: the golden pair, a random pair, and
    infinity in either slot (the GT identity)."""
    rng = random.Random(SEED + 4)
    ps = [_g1(golden.MILLER_G1_SCALAR), _g1(rng.randrange(1, R)), SG.zero(OPS1),
          _g1(rng.randrange(1, R))]
    qs = [_g2(golden.MILLER_G2_SCALAR), _g2(rng.randrange(1, R)), _g2(rng.randrange(1, R)),
          SG.zero(OPS2)]
    pd_np, qd_np = JG.encode_points(JG.G1, ps), JG.encode_points(JG.G2, qs)
    got = P.pairing(*convert.from_numpy((pd_np, qd_np), "cpu"))
    assert_same(got, jax.jit(JP.pairing)(pd_np, qd_np))
    out = T.fq12_decode(got)
    assert out[0] == golden.REDUCED_PAIRING_EXPECTED
    assert out[1] == SG.pairing(ps[1], qs[1])
    assert out[2] == out[3] == SF.FQ12_ONE


def test_pairing_batch_with_infinity_vs_jax_and_spec():
    """Product of 5 pairings with two infinity pairs skipped, one shared
    final exponentiation (mod.rs:904-926); odd batch exercises the
    halving product's carried tail."""
    rng = random.Random(SEED + 5)
    ps = [_g1(rng.randrange(1, R)) for _ in range(5)]
    qs = [_g2(rng.randrange(1, R)) for _ in range(5)]
    ps[1] = SG.zero(OPS1)
    qs[3] = SG.zero(OPS2)
    pd_np, qd_np = JG.encode_points(JG.G1, ps), JG.encode_points(JG.G2, qs)
    got = P.pairing_batch(*convert.from_numpy((pd_np, qd_np), "cpu"))
    assert_same(got, jax.jit(JP.pairing_batch)(pd_np, qd_np))
    assert T.fq12_decode(got)[0] == SG.pairing_batch(ps, qs)


def test_all_infinity_batch_is_identity():
    ps = [SG.zero(OPS1), SG.zero(OPS1)]
    qs = [_g2(5), SG.zero(OPS2)]
    out = P.pairing_batch(G.encode_points(G.G1, ps, "cpu"), G.encode_points(G.G2, qs, "cpu"))
    assert T.fq12_decode(out)[0] == SF.FQ12_ONE


def _stub_kernels(monkeypatch):
    """Every wrapper takes its kernel branch on CPU tensors, with the launch
    stubbed out (_stub_launch)."""
    for mod in (MK, FU):
        monkeypatch.setattr(mod, "on_cuda", lambda t: True)
        monkeypatch.setattr(mod, "launch", _stub_launch)


def test_main_path_reaches_every_kernel_with_valid_arguments(monkeypatch):
    """The main path with the wrappers taking their kernel branch on CPU
    tensors and the launch stubbed out: every wrapper's device, dtype,
    shape and contiguity check passes, each of the path's seven kernels is
    reached with its entry's arguments, and no plain version runs (what
    chip_smoke.py asserts on the card): to_affine once a group a call, and
    none of the one-op field kernels it replaced; one Miller launch a call
    (the Frobenius tail in it), and none of the Fq2 products, addition
    steps and folds that tail replaced.  Batches 1 to 5 cover the product
    reduction's odd tails."""
    _stub_kernels(monkeypatch)
    rng = random.Random(SEED + 6)
    ps = [_g1(rng.randrange(1, R)) for _ in range(5)]
    qs = [_g2(rng.randrange(1, R)) for _ in range(5)]
    ps[1] = SG.zero(OPS1)
    counts.reset()
    P.pairing(G.encode_points(G.G1, ps, "cpu"), G.encode_points(G.G2, qs, "cpu"))
    for n in range(1, 6):
        P.pairing_batch(G.encode_points(G.G1, ps[:n], "cpu"),
                        G.encode_points(G.G2, qs[:n], "cpu"))
    assert sorted(k for k, v in counts.launches.items() if v) == sorted(counts.PAIRING_PATH)
    assert not any(counts.plain_calls.values())
    assert counts.launches["miller_precompute"] == 6  # the 87 steps, the Frobenius tail in them
    assert counts.launches["fq12_cyc_pow"] == 3 * 6
    assert counts.launches["fq12_inv"] == 6          # one final exponentiation a call
    assert counts.launches["fq12_frob"] == 11 * 6    # 4 Frobenius maps, 7 conjugations
    assert counts.launches["to_affine"] == 2 * 6
    assert [counts.launches[k] for k in counts.FROBENIUS_TAIL_ONE_OPS] == [0, 0, 0]
    assert not any(counts.launches[k] for k in counts.TO_AFFINE_ONE_OPS)


def test_pairing_call_dispatches_few_tensor_ops(monkeypatch):
    """One pairing call at B = 4, every wrapper taking its kernel branch
    with the launch stubbed out, dispatches fewer than 150 aten ops in all
    (the tensor glue of the Frobenius bases alone was 445 of 571 before
    the Miller kernel made them), with 2 to_affine launches, one Miller
    launch and no other Miller-layer launch."""
    from test_torch_final_exp import _CountOutside
    _stub_kernels(monkeypatch)
    rng = random.Random(SEED + 7)
    g1 = G.encode_points(G.G1, [_g1(rng.randrange(1, R)) for _ in range(4)], "cpu")
    g2 = G.encode_points(G.G2, [_g2(rng.randrange(1, R)) for _ in range(4)], "cpu")
    mode = _CountOutside()
    counts.reset()
    with mode:
        P.pairing(g1, g2)
    assert mode.ops < 150, mode.ops
    assert [counts.launches[k] for k in ("to_affine", "miller_precompute", *counts.FROBENIUS_TAIL_ONE_OPS)] \
        == [2, 1, 0, 0, 0]
    assert not any(counts.plain_calls.values())


def test_import_leaves_jax_unloaded():
    """The port and everything it imports run without jax and without the
    JAX package (the card's machine has no jax, and the port keeps its own
    copy of the spec): after importing every module of bn254_tpu_torch, no
    jax module and no bn254_tpu module is loaded."""
    code = ("import sys, pkgutil, importlib, bn254_tpu_torch as m\n"
            "for i in pkgutil.walk_packages(m.__path__, 'bn254_tpu_torch.'):\n"
            "    importlib.import_module(i.name)\n"
            "bad = sorted(k for k in sys.modules if k == 'jax' or k.startswith(('jax.', 'jaxlib'))\n"
            "             or k == 'bn254_tpu' or k.startswith('bn254_tpu.'))\n"
            "assert not bad, bad\n"
            "print('ok')\n")
    env = dict(os.environ, PYTHONPATH=REPO)
    out = subprocess.run([sys.executable, "-c", code], cwd="/", env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "ok"


def _imported_modules(path):
    """Every module an `import` or `from ... import` in the file names,
    wherever it stands (chip_smoke.py imports inside its functions);
    relative imports resolve to the port's package."""
    tree = ast.parse(open(path).read(), path)
    names = []
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names += [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom):
            names.append("bn254_tpu_torch" if node.level else node.module)
    return names


def test_port_sources_import_neither_jax_nor_the_jax_package():
    files = [os.path.join(REPO, "chip_smoke.py")]
    for root, _, fs in os.walk(os.path.join(REPO, "bn254_tpu_torch")):
        files += [os.path.join(root, f) for f in fs if f.endswith(".py")]
    assert len(files) > 15
    rel = {os.path.relpath(f, REPO) for f in files}
    assert {"bn254_tpu_torch/probes.py", "bn254_tpu_torch/codec_device.py",
            "bn254_tpu_torch/errors.py", "bn254_tpu_torch/spec/codec.py"} <= rel
    for path in files:
        for name in _imported_modules(path):
            top = name.split(".")[0]
            assert top not in ("jax", "jaxlib", "bn254_tpu"), (path, name)


def test_spec_copy_equals_the_jax_package_spec():
    """bn254_tpu_torch/spec is a copy of bn254_tpu/spec: every public
    constant is equal, and so are scalar_mul, pairing and the final
    exponentiation on a few inputs."""
    import bn254_tpu.spec.constants as JC
    import bn254_tpu.spec.field as JF
    import bn254_tpu.spec.group as JSG
    from bn254_tpu_torch.spec import constants as PC
    from bn254_tpu_torch.spec import field as PF
    from bn254_tpu_torch.spec import group as PSG

    public = lambda m: {k for k in vars(m) if not k.startswith("_")}
    for jm, pm in ((JC, PC), (JF, PF), (JSG, PSG)):
        assert public(jm) == public(pm)
    for k in public(JC):
        assert getattr(JC, k) == getattr(PC, k), k
    rng = random.Random(SEED + 7)
    for jp, pp in ((JSG.G1_PARAMS, PSG.G1_PARAMS), (JSG.G2_PARAMS, PSG.G2_PARAMS)):
        gen = (jp[1][0], jp[1][1], jp[0].one)
        for _ in range(2):
            k = rng.randrange(R)
            assert JSG.scalar_mul(gen, k, jp[0]) == PSG.scalar_mul(gen, k, pp[0])
    p, q = _g1(rng.randrange(1, R)), _g2(rng.randrange(1, R))
    assert JSG.pairing(p, q) == PSG.pairing(p, q)
    f = tuple(tuple((rng.randrange(Q), rng.randrange(Q)) for _ in range(3)) for _ in range(2))
    assert JF.fq12_final_exponentiation(f) == PF.fq12_final_exponentiation(f)


def test_codec_and_errors_copies_equal_the_jax_package():
    """bn254_tpu_torch/spec/codec.py and errors.py are copies of the JAX
    package's: the same public names, the same error classes and
    hierarchy, and the same results or exception classes on valid and
    invalid encodings."""
    import bn254_tpu.errors as JE
    import bn254_tpu.spec.codec as JSC
    from bn254_tpu_torch import errors as PE
    from bn254_tpu_torch.spec import codec as PSC

    public = lambda m: {k for k in vars(m) if not k.startswith("_")}
    assert public(JSC) == public(PSC)
    classes = lambda m: {k: [c.__name__ for c in v.__mro__]
                         for k, v in vars(m).items() if isinstance(v, type)}
    assert classes(JE) == classes(PE) and len(classes(PE)) == 12

    def run(codec, errors, fn, b):
        try:
            return getattr(codec, fn)(b)
        except errors.BNError as e:
            return type(e).__name__
    p, q = SG.to_affine(_g1(5), OPS1), SG.to_affine(_g2(7), OPS2)
    g1, g2 = JSC.g1_to_compressed(p), JSC.g2_to_compressed(q)
    assert g1 == PSC.g1_to_compressed(p) and g2 == PSC.g2_to_compressed(q)
    cases = [("g1_from_compressed", b) for b in
             (g1, bytes([5]) + g1[1:], bytes([2]) + bytes(32), bytes([2]) + Q.to_bytes(32, "big"),
              g1[:32], bytes.fromhex(golden.G1_COMPRESSED_HEX))]
    cases += [("g2_from_compressed", b) for b in
              (g2, bytes([12]) + g2[1:], bytes([10]) + (Q * Q).to_bytes(64, "big"), g2[:64],
               bytes.fromhex(golden.G2_COMPRESSED_HEX))]
    cases += [("fq_from_slice", Q.to_bytes(32, "big")), ("fr_from_slice", bytes(31)),
              ("fq2_from_slice", bytes(63)), ("fr_interpret", bytes(range(64)))]
    outs = [run(JSC, JE, fn, b) for fn, b in cases]
    assert outs == [run(PSC, PE, fn, b) for fn, b in cases]
    assert {"InvalidEncoding", "NotMemberCurveError", "NotMemberFieldError",
            "InvalidSliceLength", "InvalidU512Encoding"} <= set(o for o in outs if isinstance(o, str))


# The Miller kernel's team schedule (team_schedule.py), run by the CPU
# model of tests/test_torch_tower.py, against the plain versions.

def _team_g2_rounds(step):
    """The G2 part of a step's rounds: its products and combinations
    without the square's and the fold's."""
    from bn254_tpu_torch import team_schedule as TS
    if step == "dbl":
        parts = ((TS.DBL_R1_MULS, TS.DBL_R1_LINS), (TS.DBL_R2_MULS, TS.DBL_R2_LINS),
                 (TS.DBL_R3_MULS, TS.DBL_R3_LINS))
    else:
        parts = ((TS.ADD_A1_MULS, TS.ADD_A1_LINS), (TS.ADD_A2_MULS, TS.ADD_A2_LINS),
                 (TS.ADD_A3_MULS, TS.ADD_A3_LINS), (TS.ADD_A4_MULS, TS.ADD_A4_LINS))
    return [TS.Round(m, c) for m, c in parts]


@pytest.mark.parametrize("kind", [0, 1, 2, 3, 4])
def test_team_g2_step_rounds_equal_plain_steps(kind):
    """The team doubling step (kind 0) and mixed addition against Q (1),
    -Q (2), pi(Q) (3) and -pi^2(Q) (4), split into their rounds: R' and
    the line (ell_0, ell_vv px, ell_vw py) equal fused._dbl_step /
    _add_step's bit for bit (the bases by fused._step_bases; the team's
    Frobenius bases by their round, team_schedule.FROB), on
    kernel_cases.residues inputs (0, 1, q - 1 in the first lanes)."""
    from bn254_tpu_torch import team_schedule as TS
    d = TT._team_inputs(SEED + 20 + kind)
    st = TT.team_state(q=d["q"], p=d["p"], r=d["r"])
    if kind >= 3:
        TT.team_round(st, TS.ROUNDS[TS.FROB[0]], 0)
    for rnd in _team_g2_rounds("dbl" if kind == 0 else "add"):
        TT.team_round(st, rnd, TS.base_slot(kind) if kind else 0)
    r = d["r"].view(3, 2, 16, -1)
    nr, c = FU._dbl_step(r) if kind == 0 else FU._add_step(r, FU._step_bases(d["q"])[kind])
    ell_0, ell_vw, ell_vv = c.unbind(0)
    px, py = d["p"]
    assert torch.equal(TT.team_slots(st, "RX", "RY", "RZ"), nr.reshape(6, 16, -1))
    assert torch.equal(st[TS.SLOT["L0"]], ell_0)
    assert torch.equal(torch.stack([st[TS.SLOT["L2"]], st[TS.SLOT["L4"]]]),
                       MK._fq2_mul(torch.stack([ell_vv, ell_vw]),
                                   torch.stack([torch.stack([px, torch.zeros_like(px)]),
                                                torch.stack([py, torch.zeros_like(py)])])))


@pytest.mark.parametrize("kinds", [(0,), (1,), (2,), (0, 1), (0, 2), (0, 0),
                                   (0, 3), (3, 4), (0, 3, 4), (4, 0, 2)])
def test_team_miller_steps_equal_plain_steps(kinds):
    """Whole team Miller steps (square, G2 step and fold interleaved in
    their rounds, as step_rounds picks them: an addition after a doubling
    step starts in that step's last round) equal the plain steps of
    miller_precompute_plain; in the cases with the Frobenius additions
    (kinds 3, 4) the model runs the bases' round first, as the kernel does
    (team_schedule.device_kinds), the plain steps take fused._step_bases."""
    d = TT._team_inputs(SEED + 23 + len(kinds) * 3 + kinds[-1])
    st = TT.team_state(f=d["f"], q=d["q"], p=d["p"], r=d["r"])
    f, r = d["f"].view(2, 3, 2, 16, -1), d["r"].view(3, 2, 16, -1)
    bases = FU._step_bases(d["q"])
    TT.team_miller_steps(st, kinds)
    for kind in kinds:
        if kind == 0:
            f = FU._sqr12(f)
            r, c = FU._dbl_step(r)
        else:
            r, c = FU._add_step(r, bases[kind])
        f = FU._fold(f, c, *d["p"])
    assert torch.equal(TT.team_slots(st, "F0", "F1", "F2", "F3", "F4", "F5"), f.reshape(12, 16, -1))
    assert torch.equal(TT.team_slots(st, "RX", "RY", "RZ"), r.reshape(6, 16, -1))


def test_team_miller_loop_equals_plain_version():
    """The whole team Miller kernel, all 87 kinds of the pairing (the 85
    scheduled and the 2 Frobenius additions), equals
    miller_precompute_plain limb for limb on residue inputs with 0, 1 and
    q - 1 in the first lanes (lane 0 all zeros, as to_affine gives an
    infinity lane) and on real affine points."""
    d = TT._team_inputs(SEED + 26, batch=8)
    kinds = P._LINE_KINDS
    got, want = TT.team_miller_precompute(d["q"], d["p"], kinds), FU.miller_precompute_plain(
        d["q"], d["p"], kinds)
    assert all(torch.equal(g, w) for g, w in zip(got, want))
    rng = random.Random(SEED + 27)
    pa_np, qa_np = _affine_pairs([(rng.randrange(1, R), rng.randrange(1, R)) for _ in range(3)])
    pa, qa = (convert.pack(t) for t in convert.from_numpy((pa_np, qa_np), "cpu"))
    got, want = TT.team_miller_precompute(qa, pa, kinds), FU.miller_precompute_plain(qa, pa, kinds)
    assert all(torch.equal(g, w) for g, w in zip(got, want))


@pytest.mark.parametrize("kinds", [(0, 5), (-1,), (1, 7, 0)])
def test_miller_precompute_refuses_a_kind_outside_step_kinds(kinds):
    """miller_precompute refuses a kind outside STEP_KINDS before it
    reaches a kernel or a plain version."""
    d = TT._team_inputs(SEED + 29, batch=2)
    counts.reset()
    with pytest.raises(ValueError, match="miller_precompute"):
        FU.miller_precompute(d["q"], d["p"], kinds)
    assert not any(counts.plain_calls.values())
