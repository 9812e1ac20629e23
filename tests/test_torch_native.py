"""The port's native host tier (``libzkp_tpu_torch/native``) against the
pure-Python goldens and the JAX package's native tier.

* Keccak-f[1600], point add, scalar multiplication, the Pippenger and
  fixed-basis MSMs (n = 1, 2, 7, 33, 130) and Ristretto encode and decode
  (with invalid encodings) equal their ``*_py`` goldens and the JAX
  package's native results on the same seeded inputs.
* The hooks are wired: ``ed.compress``, ``ed.msm_fixed`` and the STROBE
  permutation reach the port's library, built under ``_build/``.
* The build: a broken source raises with the compiler's log; two processes
  on an empty build directory load one file, compiled once.
* Two copies of the library in one process keep their own registries.
* ``_prove_batch_native`` gives the bytes of the JAX package's native
  prover under the same draws and transcripts, n = 1 to 64, and leaves the
  transcripts as they were. (Against the lockstep host prover, n = 1 to 32:
  ``test_torch_bp_widths.py``; against the device prover's CPU path at 64
  bits: ``test_torch_bp_device.py``, each beside the run it reuses.)
* The native RLC verifier's verdicts equal the pure-Python verifier's on
  valid, tampered, structurally bad, mixed and empty groups.
"""

from __future__ import annotations

import ctypes
import hashlib
import json
import os
import random
import subprocess
import sys
from dataclasses import replace
from pathlib import Path

import pytest
import torch

from libzkp_tpu import native as jnative
from libzkp_tpu.models import bulletproofs as jbulp
from libzkp_tpu.models.strobe import Transcript as JTranscript
from libzkp_tpu_torch import native
from libzkp_tpu_torch.models import bulletproofs as bp
from libzkp_tpu_torch.models.strobe import Transcript
from libzkp_tpu_torch.ops import ed25519 as ed
from libzkp_tpu_torch.ops import keccak

REPO = Path(__file__).resolve().parent.parent
L = ed.L
LABELS = (b"libzkp_range_min", b"libzkp_threshold", b"libzkp_consistency")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread, which is also the native tier's OpenMP team: the
    suite runs in several worker processes at once."""
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _points(rng: random.Random, count: int) -> list:
    return [ed.scalar_mul_py(rng.randrange(1, L), ed.BASEPOINT) for _ in range(count)]


def test_keccak_matches_golden_and_reference():
    rng = random.Random(1600)
    for _ in range(16):
        state = bytearray(rng.randbytes(200))
        want = bytearray(state)
        keccak.keccak_f1600_bytes_py(want)
        ref = bytearray(state)
        jnative.keccak_f1600_bytes(ref)
        native.keccak_f1600_bytes(state)
        assert state == want == ref


def test_point_ops_match_golden_and_reference():
    rng = random.Random(25519)
    p, q = _points(rng, 2)
    got = native.ed_point_add(p, q)
    assert ed.point_equal(got, ed.point_add(p, q))
    assert got == jnative.ed_point_add(p, q)
    for k in [0, 1, L - 1, L, L + 5] + [rng.randrange(L) for _ in range(4)]:
        got = ed.scalar_mul(k, p)
        assert ed.point_equal(got, ed.scalar_mul_py(k, p))
        assert got == jnative.ed_scalar_mul(k, p, L)


@pytest.mark.parametrize("n", [1, 2, 7, 33, 130])
def test_msm_matches_golden_and_reference(n):
    rng = random.Random(n)
    pts = _points(rng, n)
    ks = [rng.randrange(L) for _ in range(n)]
    ks[0] = 0  # a zero scalar is skipped
    want = ed.msm_py(ks, pts)
    got = ed.msm(ks, pts)
    assert ed.point_equal(got, want)
    assert got == jnative.ed_msm(ks, pts, L)
    # the fixed-basis MSM: registered once, then per call; its golden is msm_py
    for _ in range(2):
        assert ed.point_equal(ed.msm_fixed(ks, pts), want)
        ks = [rng.randrange(L) for _ in range(n)]
        want = ed.msm_py(ks, pts)


def test_ristretto_roundtrip_matches_golden_and_reference():
    rng = random.Random(9496)
    for pt in _points(rng, 8) + [ed.IDENTITY]:
        enc = ed.compress(pt)
        assert enc == ed.compress_py(pt) == jnative.ristretto_compress(pt)
        dec = ed.decompress(enc)
        assert dec == jnative.ristretto_decompress(enc)
        assert ed.ristretto_eq(dec, ed.decompress_py(enc))
    # invalid encodings: negative s, s >= p, bad lengths, and non-squares
    # (random canonical non-negative s, most of which decode to nothing)
    bad = [b"\x01" + bytes(31), b"\xff" * 32, (ed.P + 2).to_bytes(32, "little"), bytes(16), b""]
    while len(bad) < 64:
        s = rng.randrange(ed.P) & ~1
        bad.append(s.to_bytes(32, "little"))
    rejected = 0
    for enc in bad:
        want = ed.decompress_py(enc)
        got = ed.decompress(enc)
        assert got == jnative.ristretto_decompress(enc)
        if want is None:
            rejected += 1
            assert got is None
        else:
            assert ed.ristretto_eq(got, want) and ed.compress(got) == enc
    assert rejected >= 32


class _Spy:
    """Stands in for the loaded library and records the symbols called."""

    def __init__(self, lib):
        self.lib, self.seen = lib, []

    def __getattr__(self, name):
        self.seen.append(name)
        return getattr(self.lib, name)


def test_hooks_reach_the_ports_library(monkeypatch):
    lib = native.load()
    assert Path(lib._name).parent == native.BUILD_DIR == REPO / "libzkp_tpu_torch" / "_build"
    spy = _Spy(lib)
    monkeypatch.setattr(native, "_lib", spy)
    pts = _points(random.Random(3), 3)
    ed.compress(pts[0])
    ed.msm_fixed([1, 2, 3], pts)
    Transcript(b"wired").challenge_bytes(b"c", 64)
    assert {"zkp_ristretto_compress", "zkp_ed_msm_fixed_mt", "zkp_keccak_f1600"} <= set(spy.seen)


def test_thread_budget_follows_torch():
    """The native team is torch's thread count: a fixed MSM of at least
    TEAM_MIN_POINTS points splits its windows into one chunk a thread, a
    smaller one runs serial, and either leaves the budget as it was."""
    rng = random.Random(33)
    pts = _points(rng, native.TEAM_MIN_POINTS + 1)
    ks = [rng.randrange(L) for _ in pts]
    assert native.max_threads() == 1
    torch.set_num_threads(3)
    try:
        assert native.max_threads() == 3
        for m in (len(pts), 5):
            assert ed.point_equal(ed.msm_fixed(ks[:m], pts[:m]), ed.msm_py(ks[:m], pts[:m]))
            assert ed.point_equal(ed.msm(ks[:m], pts[:m]), ed.msm_py(ks[:m], pts[:m]))
            assert native.max_threads() == torch.get_num_threads() == 3
    finally:
        torch.set_num_threads(1)
    assert native.max_threads() == 1


def test_failed_build_raises_with_the_compilers_log(tmp_path, monkeypatch):
    src = tmp_path / "zkpcore.cpp"
    src.write_text(native.SRC.read_text().replace(
        '\nextern "C" {', '\nextern "C" {\nint deliberately_broken = undeclared_name;', 1))
    monkeypatch.setattr(native, "SRC", src)
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path / "build")
    with pytest.raises(RuntimeError, match="undeclared_name") as err:
        native.build()
    assert "failed to build" in str(err.value)
    assert [p.name for p in (tmp_path / "build").iterdir()] == ["zkpcore.lock"]


_RACE = """
import ctypes, json, pathlib, sys, time
from libzkp_tpu_torch import native
tmp = pathlib.Path(sys.argv[1])
native.SRC, native.BUILD_DIR = tmp / "tiny.cpp", tmp / "build"
(tmp / f"ready-{sys.argv[2]}").touch()
while len(list(tmp.glob("ready-*"))) < 2:  # start both builds together
    time.sleep(0.001)
path, seconds = native.build()
print(json.dumps({"path": str(path), "seconds": seconds, "probe": ctypes.CDLL(str(path)).zkp_probe()}))
"""


def test_concurrent_first_use_compiles_once(tmp_path):
    (tmp_path / "tiny.cpp").write_text('extern "C" int zkp_probe() { return 7; }\n')
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"} | {
        "PYTHONPATH": str(REPO), "OMP_NUM_THREADS": "1"}
    procs = [subprocess.Popen([sys.executable, "-c", _RACE, str(tmp_path), str(i)], cwd=REPO,
                              env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
             for i in range(2)]
    outs = []
    for proc in procs:
        out, err = proc.communicate(timeout=300)
        assert proc.returncode == 0, err
        outs.append(json.loads(out.strip().splitlines()[-1]))
    assert outs[0]["path"] == outs[1]["path"]
    assert Path(outs[0]["path"]).parent == tmp_path / "build"
    assert sorted(o["seconds"] is None for o in outs) == [False, True]
    assert [o["probe"] for o in outs] == [7, 7]
    assert sorted(p.name for p in (tmp_path / "build").iterdir()) == sorted(
        [Path(outs[0]["path"]).name, "zkpcore.lock"])


def test_two_library_copies_keep_their_own_registries():
    port, ref = native.load(), jnative._lib
    assert port._name != ref._name
    rng = random.Random(2)
    basis = _points(rng, 9)
    wire = b"".join(native._to_wire(p) for p in basis)
    ks = [rng.randrange(L) for _ in basis]
    sc = b"".join(k.to_bytes(32, "little") for k in ks)
    hp = port.zkp_ed_msm_register(len(basis), wire)
    hr = ref.zkp_ed_msm_register(len(basis), wire)
    # a registration in the reference's library takes no slot in the port's
    assert port.zkp_ed_msm_register(len(basis), wire) == hp + 1
    assert ref.zkp_ed_msm_register(len(basis), wire) == hr + 1
    outs = []
    for lib, h in ((port, hp), (ref, hr)):
        out = ctypes.create_string_buffer(128)
        lib.zkp_ed_msm_fixed_mt(h, sc, out, 1)
        outs.append(native._from_wire(out.raw))
    assert outs[0] == outs[1]
    assert ed.point_equal(outs[0], ed.msm_py(ks, basis))


def _instances(n: int, T, count: int = 3):
    """The value's extremes and random ones, under the backend's labels."""
    rng = random.Random(n)
    values = [0, (1 << n) - 1] + [rng.randrange(1 << n) for _ in range(count - 2)]
    return [(T(LABELS[i % 3]), v, rng.randrange(L), n) for i, v in enumerate(values)]


def _rand(n: int, count: int) -> bytes:
    return hashlib.shake_256(b"native-%d" % n).digest((2 * n + 4) * 64 * count)


def _same(got, want) -> bool:
    return [(rp.to_bytes(), V) for rp, V in got] == [(rp.to_bytes(), V) for rp, V in want]


@pytest.mark.parametrize("n", [1, 2, 4, 8, 16, 32, 64])
def test_native_prover_matches_reference_native_prover(n):
    rand = _rand(n, 3)
    insts = _instances(n, Transcript)
    got = bp._prove_batch_native(insts, n, rand)
    assert _same(got, jbulp._prove_batch_native(_instances(n, JTranscript), n, rand))
    # it reads the transcripts and leaves them as they were
    assert [t.strobe.state_bytes() for t, *_ in insts] == [
        t.strobe.state_bytes() for t, *_ in _instances(n, Transcript)]


@pytest.fixture(scope="module")
def proofs():
    """Four valid proofs at 8 bits and two at 64: (proof, label, V, n)."""
    out = []
    for n, count in ((8, 4), (64, 2)):
        insts = _instances(n, Transcript, count)
        res = bp._prove_batch_native(insts, n, _rand(n, count))
        out += [(rp, LABELS[i % 3], V, n) for i, (rp, V) in enumerate(res)]
    return out


def _tampered(p):
    rp, label, V, n = p
    return replace(rp, t_x=(rp.t_x + 1) % L), label, V, n


def _structurally_bad(p):  # A is no canonical encoding
    rp, label, V, n = p
    return replace(rp, A=b"\xff" * 32), label, V, n


def _wrong_length(p):  # S is 31 bytes: malformed before the native call
    rp, label, V, n = p
    return replace(rp, S=rp.S[:31]), label, V, n


def _wrong_width(p):  # a width the proof was not made for
    rp, label, V, n = p
    return rp, label, V, 2 * n


# group layouts: indices into the fixture's proofs, or a (maker, index) pair
_CASES = {
    "valid": ([[0, 1], [2], [4, 5], [3]], [True] * 4),
    "tampered": ([[(_tampered, 0)]], [False]),
    "structural": ([[0], [(_structurally_bad, 1)], [2, 3]], [True, False, True]),
    "mixed": ([[0, 1], [(_tampered, 2)], [4], [3, (_structurally_bad, 5)], [],
               [(_wrong_length, 1)], [5, (_tampered, 3)], [(_wrong_width, 0)], [2]],
              [True, False, True, False, True, False, False, False, True]),
    "empty": ([[], []], [True, True]),
}


def _groups(proofs, layout):
    groups = []
    for g in layout:
        items = [proofs[i] if isinstance(i, int) else i[0](proofs[i[1]]) for i in g]
        groups.append([(rp, Transcript(label), V, n) for rp, label, V, n in items])
    return groups


@pytest.mark.parametrize("case", sorted(_CASES))
def test_native_verifier_matches_python_verifier(case, proofs, monkeypatch):
    layout, expect = _CASES[case]
    rcs = []
    verify_rlc = native.bp_verify_rlc

    def counting(*args):
        rc, bad = verify_rlc(*args)
        rcs.append(rc)
        return rc, bad

    monkeypatch.setattr(native, "bp_verify_rlc", counting)
    got = bp.batch_verify_groups(_groups(proofs, layout))
    assert got == bp.batch_verify_groups_py(_groups(proofs, layout)) == expect
    # the structural retry (rc 2) and the bisection (rc 0) ran where needed
    assert (rcs[:1] == [2]) == (case in ("structural", "mixed"))
    assert (0 in rcs) == (case in ("tampered", "mixed"))
    assert (rcs == []) == (case == "empty")


@pytest.mark.parametrize("make", [None, _tampered, _structurally_bad, _wrong_length, _wrong_width])
def test_verify_single_matches_python_verifier(make, proofs):
    for p in (proofs[1], proofs[5]):
        rp, label, V, n = p if make is None else make(p)
        got = bp.verify_single(rp, Transcript(label), V, n)
        assert got == bp.verify_single_py(rp, Transcript(label), V, n) == (make is None)
