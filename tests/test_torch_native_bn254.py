"""The native tier's BN254 and Groth16 hooks against the pure-Python goldens
and the JAX package's native tier.

* G1 and G2 ``msm`` (n = 1, 2, 7, 33, with a zero scalar and the point at
  infinity), ``scalar_mul`` and the fixed-basis MSM (one point, and a
  basis of 33) equal their ``*_py`` goldens and the JAX package's native
  results on the same numpy-seeded inputs.
* ``multi_pairing``, ``pairing`` and the premultiplied pairing equal the
  pure-Python pairing on a few pairs, with a pair at infinity.
* ``groth16_spmv``'s rows equal the pure-Python sparse products
  (``groth16._abc_from_csr``) and the JAX package's native ones, the packed
  rows the JAX package's; ``groth16_h`` equals the host NTTs' h;
  ``groth16_prove_msms`` equals the five query MSMs of ``_prove_accs`` and
  their goldens; at the equality and membership shapes. The device h from
  the sparse products' rows equals the host h.
* A full registry raises ``MemoryError``; one-point calls run serial and
  the query MSMs on the thread budget's team; importing the BN254 and
  Groth16 modules builds and loads nothing, and the BN254 wrappers refuse
  to run before ``bn254_init``.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from libzkp_tpu import native as jnative
from libzkp_tpu.models import groth16 as jg
from libzkp_tpu.models import snark_backend as jsb
from libzkp_tpu_torch import convert, native
from libzkp_tpu_torch.models import groth16 as tg
from libzkp_tpu_torch.models import snark_backend as tsb
from libzkp_tpu_torch.ops import bn254 as bn
from libzkp_tpu_torch.ops.groth16_device import h_batch_device
from libzkp_tpu_torch.ops.limb import bytes_to_limb_rows, get_context
from libzkp_tpu_torch.utils.commitment import commit_value_snark

REPO = Path(__file__).resolve().parent.parent
G1 = bn.g1_from_affine(bn.G1_GEN)
G2 = bn.g2_from_affine((bn.G2_GEN_X, bn.G2_GEN_Y))


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread, which is also the native tier's OpenMP team: the
    suite runs in several worker processes at once."""
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _scalars(rng: np.random.Generator, count: int) -> list:
    """Seeded scalars below R (four 64-bit words each, reduced)."""
    words = rng.integers(0, 1 << 63, size=(count, 4), dtype=np.int64)
    return [sum(int(w) << (64 * i) for i, w in enumerate(row)) % bn.R for row in words]


def _g1_same(a, b) -> bool:
    return bn.g1_to_affine(a) == bn.g1_to_affine(b)


def _g2_same(a, b) -> bool:
    return bn.g2_to_affine(a) == bn.g2_to_affine(b)


CURVES = {
    "g1": (G1, bn.g1_scalar_mul_py, bn.g1_msm, bn.g1_msm_py, bn.g1_msm_fixed, bn.g1_scalar_mul,
           bn.G1_INF, _g1_same, jnative.bn254_g1_msm, jnative.bn254_g1_scalar_mul),
    "g2": (G2, bn.g2_scalar_mul_py, bn.g2_msm, bn.g2_msm_py, bn.g2_msm_fixed, bn.g2_scalar_mul,
           bn.G2_INF, _g2_same, jnative.bn254_g2_msm, jnative.bn254_g2_scalar_mul),
}


def _points(curve: str, rng: np.random.Generator, count: int) -> list:
    gen, mul_py = CURVES[curve][:2]
    return [mul_py(k, gen) for k in _scalars(rng, count)]


@pytest.mark.parametrize("curve", ["g1", "g2"])
@pytest.mark.parametrize("n", [1, 2, 7, 33])
def test_msm_matches_golden_and_reference(curve, n):
    _, _, msm, msm_py, msm_fixed, _, inf, same, jmsm, _ = CURVES[curve]
    rng = np.random.default_rng(n)
    pts = _points(curve, rng, n)
    ks = _scalars(rng, n)
    if n > 1:
        ks[0] = 0          # a zero scalar is skipped
        pts[-1] = inf      # and so is the point at infinity
    want = msm_py(ks, pts)
    got = msm(ks, pts)
    assert same(got, want)
    assert got == jmsm(ks, pts)
    assert same(msm_fixed(ks, pts), want)
    # n = 1: the zero scalar and the point at infinity alone
    assert same(msm([0], pts[:1]), inf) and same(msm(ks[-1:], [inf]), inf)


@pytest.mark.parametrize("curve", ["g1", "g2"])
def test_scalar_mul_and_one_point_fixed_msm_match_golden(curve):
    gen, mul_py, _, _, msm_fixed, mul, inf, same, _, jmul = CURVES[curve]
    rng = np.random.default_rng(254)
    p = mul_py(_scalars(rng, 1)[0], gen)
    for k in [0, 1, bn.R - 1, bn.R, bn.R + 5] + _scalars(rng, 3):
        want = mul_py(k, p)
        got = mul(k, p)
        assert same(got, want)
        assert got == jmul(k, p)
        assert same(msm_fixed([k], [p]), want)
    assert same(mul(7, inf), inf)


def test_pairings_match_golden():
    """e(3 g1, g2) e(-g1, 3 g2) e(inf, g2) = 1; e(2 g1, g2) e(g1, 5 g2) as the
    pure-Python pairing gives it, also with its first pair's Miller value
    premultiplied."""
    three = (bn.g1_scalar_mul_py(3, G1), G2)
    cancel = [three, (bn.g1_neg(G1), bn.g2_scalar_mul_py(3, G2)), (bn.G1_INF, G2)]
    assert bn.multi_pairing(cancel) == bn.FQ12_ONE
    assert jnative.bn254_multi_pairing(cancel) == bn.FQ12_ONE
    pairs = [(bn.g1_scalar_mul_py(2, G1), G2), (G1, bn.g2_scalar_mul_py(5, G2))]
    want = bn.multi_pairing_py(pairs)
    assert want != bn.FQ12_ONE
    assert bn.multi_pairing(pairs) == want == jnative.bn254_multi_pairing(pairs)
    tier = bn.native_tier()
    f0 = tier.bn254_miller_bytes(*pairs[0])
    assert f0 == jnative.bn254_miller_bytes(*pairs[0])
    assert tier.bn254_multi_pairing_premul(f0, pairs[1:] + [(G1, bn.G2_INF)]) == want
    assert bn.pairing(G2, G1) == bn.pairing_py(G2, G1)


def _circuits():
    """(name, constraint system of one statement, the setup circuit's
    (num_instance, csr), domain size) of the equality and membership
    circuits."""
    v = 424242
    fr = int.from_bytes(commit_value_snark(v), "little")
    eq = tsb.build_equality_circuit(v, v, fr)
    the_set = [3, v, 9]
    sel = [False] * tsb.MAX_SET_SIZE
    sel[1] = True
    pad = tsb.MAX_SET_SIZE - len(the_set)
    mem = tsb.build_membership_circuit(v, sel, the_set + [0] * pad, [True] * 3 + [False] * pad, fr)
    return [("equality", eq, tsb._equality_shape(), 512),
            ("membership", mem, tsb._membership_shape(), 1024)]


@pytest.mark.parametrize("which", [0, 1])
def test_groth16_spmv_and_h_match_golden_and_reference(which):
    _, cs, (num_instance, csr), n = _circuits()[which]
    z = cs.full_assignment()
    packed = tg._packed_csr(csr)
    assert packed == tuple(jg._pack_csr(cs, w) for w in range(3))
    rows = native.groth16_spmv(n, len(cs.constraints), num_instance, tg.R, packed, z)
    got = [[int.from_bytes(b[i : i + 32], "little") for i in range(0, 32 * n, 32)] for b in rows]
    assert got == list(tg._abc_from_csr(n, num_instance, csr, z))
    assert got == list(jnative.groth16_spmv(n, len(cs.constraints), num_instance, tg.R, packed, z))
    h = tg._h_native(n, num_instance, csr, z)
    assert h == tg._h_from_csr(n, num_instance, csr, z) == tg._compute_h(cs, n)
    root = tg.BN254_FR.root_of_unity(n)
    assert h == jnative.groth16_h(n, len(cs.constraints), num_instance, tg.R, root, 5, packed, z)
    bad = list(z)
    bad[-1] = (bad[-1] + 1) % tg.R  # an unsatisfied system: h has degree n - 1
    with pytest.raises(AssertionError):
        tg._h_native(n, num_instance, csr, bad)


def test_device_h_from_spmv_rows_equals_host_h():
    """The card route's h takes the native sparse products' rows as bytes
    (``h_batch_device``): the limbs ``encode`` gives the ints, and the host
    h of the pure-Python sparse products."""
    _, cs, (num_instance, csr), n = _circuits()[0]
    other = tsb._equality_assignment(5, 5, int.from_bytes(commit_value_snark(5), "little"))
    zs = [cs.full_assignment(), other]
    rows = [native.groth16_spmv(n, len(cs.constraints), num_instance, tg.R,
                                tg._packed_csr(csr), z) for z in zs]
    abc = tg._abc_from_csr(n, num_instance, csr, zs[1])
    ctx = get_context(tg.R, "bn254_fr")
    assert torch.equal(ctx.encode_bytes(b"".join(rows[1])),
                       ctx.encode([v for vec in abc for v in vec]))
    want = [tg._h_from_csr(n, num_instance, csr, z) for z in zs]
    assert h_batch_device(n, rows, 5, device="cpu") == want
    with pytest.raises(ValueError):
        bytes_to_limb_rows(bytes(35), 35, ctx.n)  # 35 bytes do not fit 22 limbs' 34


def test_groth16_prove_msms_matches_prove_accs_and_goldens():
    """The five query MSMs of one equality proof in one native call equal
    ``_prove_accs`` (the fixed-basis hooks) and the pure-Python MSMs."""
    pk = convert.proving_key(jsb._get_equality_setup())
    _, cs, (num_instance, csr), n = _circuits()[0]
    z = cs.full_assignment()
    h = tg._h_native(n, num_instance, csr, z)
    tier = bn.native_tier()
    handles = [tier.g1_fixed_handle(tuple(q), q)
               for q in (pk.a_query, pk.b_g1_query, pk.h_query, pk.l_query)]
    handles.append(tier.g2_fixed_handle(tuple(pk.b_g2_query), pk.b_g2_query))
    a, b1, hh, l, b2 = tier.groth16_prove_msms(*handles, z, h, num_instance)
    wa, wb2, wb1, wh, wl = tg._prove_accs(pk, z, num_instance, h)
    assert all(_g1_same(x, y) for x, y in ((a, wa), (b1, wb1), (hh, wh), (l, wl)))
    assert _g2_same(b2, wb2)
    assert _g1_same(a, bn.g1_msm_py(z, pk.a_query))
    assert _g1_same(b1, bn.g1_msm_py(z, pk.b_g1_query))
    assert _g1_same(hh, bn.g1_msm_py(h, pk.h_query))
    assert _g1_same(l, bn.g1_msm_py(z[num_instance:], pk.l_query))
    assert _g2_same(b2, bn.g2_msm_py(z, pk.b_g2_query))


def test_full_registry_raises(monkeypatch):
    """Each registry refuses its MAX_FIXED_BASES + 1st entry with
    MemoryError (the C++ side never frees one); registered bases are still
    served."""
    rng = np.random.default_rng(64)
    p1, p2 = _points("g1", rng, 1), _points("g2", rng, 1)
    assert _g1_same(bn.g1_msm_fixed([5], p1), bn.g1_scalar_mul_py(5, p1[0]))
    bn.g2_msm_fixed([5], p2)
    _, cs, (num_instance, csr), n = _circuits()[0]
    tg._h_native(n, num_instance, csr, cs.full_assignment())
    fresh = [(native._g1_handles, lambda: bn.g1_msm_fixed([5], _points("g1", rng, 1))),
             (native._g2_handles, lambda: bn.g2_msm_fixed([5], _points("g2", rng, 1))),
             # the equality circuit on a domain of 2048: a circuit key of its own
             (native._g16h_handles, lambda: tg._h_native(2048, num_instance, csr,
                                                        cs.full_assignment()))]
    for registry, register in fresh:
        monkeypatch.setattr(native, "MAX_FIXED_BASES", len(registry))
        with pytest.raises(MemoryError):
            register()
    assert _g1_same(bn.g1_msm_fixed([5], p1), bn.g1_scalar_mul_py(5, p1[0]))


class _TeamSpy:
    """Stands in for the loaded library and records each team it is set to."""

    def __init__(self, lib):
        self.lib, self.teams = lib, []

    def omp_set_num_threads(self, k):
        self.teams.append(k)
        self.lib.omp_set_num_threads(k)

    def __getattr__(self, name):
        return getattr(self.lib, name)


def test_one_point_calls_run_serial(monkeypatch):
    """Under a budget of 3 threads: the one-point hooks and the finish's
    calls set a team of one; an MSM of TEAM_MIN_POINTS points and a
    multi-pairing of TEAM_MIN_PAIRS pairs take the budget; the budget is set
    back after each."""
    rng = np.random.default_rng(3)
    pts = _points("g1", rng, native.TEAM_MIN_POINTS)
    ks = _scalars(rng, len(pts))
    bn.g1_msm_fixed(ks, pts)  # registers the basis
    spy = _TeamSpy(native.load())
    monkeypatch.setattr(native, "_lib", spy)
    torch.set_num_threads(3)
    try:
        cases = [(lambda: bn.g1_scalar_mul(5, G1), 1), (lambda: bn.g2_scalar_mul(5, G2), 1),
                 (lambda: bn.g1_msm_fixed([5], [G1]), 1), (lambda: bn.g2_msm([5], [G2]), 1),
                 (lambda: bn.g1_msm(ks, pts), 3), (lambda: bn.g1_msm_fixed(ks, pts), 3),
                 (lambda: bn.multi_pairing([(G1, G2)] * native.TEAM_MIN_PAIRS), 3)]
        for call, team in cases:
            spy.teams.clear()
            call()
            assert spy.teams == [team, 3]
    finally:
        torch.set_num_threads(1)


def test_importing_bn254_builds_nothing():
    code = """
import json
from libzkp_tpu_torch import convert, native
from libzkp_tpu_torch.ops import bn254
from libzkp_tpu_torch.models import groth16, snark_backend
from libzkp_tpu_torch.models.schemes import set_membership
import libzkp_tpu_torch
before = (native._lib is None, native._bn254 is None, bn254._native_ready)
try:
    native.bn254_g1_scalar_mul(3, bn254.g1_from_affine(bn254.G1_GEN))
    refused = False
except RuntimeError:
    refused = True
bn254.g1_scalar_mul(3, bn254.g1_from_affine(bn254.G1_GEN))
print(json.dumps([before, refused, native._lib is not None, native._bn254 is not None,
                  bn254._native_ready]))
"""
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env.update(PYTHONPATH=str(REPO), OMP_NUM_THREADS="1")
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env, capture_output=True,
                          text=True, timeout=600)
    assert proc.returncode == 0, proc.stderr
    assert json.loads(proc.stdout.strip().splitlines()[-1]) == [[True, True, False], True, True,
                                                                True, True]


def test_bn254_init_takes_its_constants_from_the_caller():
    """The loader imports nothing of ``ops`` (the curve constants come in
    through ``bn254_init``); a second init with the same constants is a
    no-op, with other constants it raises."""
    import ast

    tree = ast.parse((REPO / "libzkp_tpu_torch" / "native" / "__init__.py").read_text())
    imported = [node.module or "" for node in ast.walk(tree) if isinstance(node, ast.ImportFrom)]
    assert not any("ops" in m.split(".") for m in imported), imported
    tier = bn.native_tier()
    hard = (bn.P**4 - bn.P**2 + 1) // bn.R
    tier.bn254_init(bn.P, bn.R, bn._FROB_GAMMA1, hard)
    with pytest.raises(ValueError):
        tier.bn254_init(bn.P, bn.R, bn._FROB_GAMMA1, hard + 1)
    assert _g1_same(bn.g1_scalar_mul(3, G1), bn.g1_scalar_mul_py(3, G1))
