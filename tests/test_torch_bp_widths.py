"""Bulletproofs widths other than 64 and the ed25519 MSM seam, against the
JAX package.

* ``ed.msm_fixed_many`` on the CPU (the seam's plain kernels: table build,
  v3 window walk) gives the same compressed points as the JAX package's
  per-vector host ``msm`` at K = 2, 17 and 65, the bases of V, A/S and the
  inner-product rounds at 8 and 32 bits; on a mesh, as the host ``msm``.
* The lockstep host prover ``_prove_batch_fixed_n`` at n = 1, 2, 4, 8, 16,
  32 (n = 1: no inner-product round, so no L||R MSM) gives
  byte-identical proofs and V commitments to the JAX package's under the
  same injected draws (its native and device prover routes off) and to the
  port's native whole-pipeline prover ``_prove_batch_native``, and both
  packages' verifiers accept them.
* ``prove_range_with_bits`` at 8 bits gives the JAX package's envelope under
  one seeded stand-in for ``os.urandom``.
* Widths the reference refuses raise its exception class in both packages.
"""

from __future__ import annotations

import hashlib
import os
import random

import pytest
import torch

from libzkp_tpu.models import bulletproofs as jbulp
from libzkp_tpu.models import bp_generators as jgens
from libzkp_tpu.models.schemes import range_proof as jrp
from libzkp_tpu.models.strobe import Transcript as JTranscript
from libzkp_tpu.ops import ed25519 as jed
from libzkp_tpu_torch.models import bp_generators as gens
from libzkp_tpu_torch.models import bulletproofs as bp
from libzkp_tpu_torch.models.schemes import range_proof as trp
from libzkp_tpu_torch.models.strobe import Transcript
from libzkp_tpu_torch.ops import ed25519 as ed

L = ed.L
CPU = "cpu"
LABELS = (b"libzkp_range_min", b"libzkp_threshold", b"libzkp_consistency")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the suite runs in several worker processes at
    once, and OpenMP pools oversubscribing the cores stall each other."""
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


@pytest.fixture
def jax_lockstep(monkeypatch):
    """The JAX package's ``_prove_batch_fixed_n`` on its lockstep host path."""
    monkeypatch.setattr(jbulp, "_use_device_prover", lambda batch, n: False)
    monkeypatch.setattr(jbulp, "_use_native_prover", lambda: False)


@pytest.mark.parametrize("K", [2, 17, 65])
def test_msm_fixed_many_matches_reference_msm(K):
    rng = random.Random(K)
    B, B_blinding = gens.pedersen_gens()
    G, H = gens.bp_gens(32)
    basis = ([B, B_blinding] + list(G) + list(H))[:K]
    vecs = [[0] * K, [L - 1] * K, [1] + [0] * (K - 1)] + [
        [rng.randrange(L) for _ in range(K)] for _ in range(4)]
    got = [ed.compress(p) for p in ed.msm_fixed_many(vecs, basis, device=CPU)]
    jB, jBb = jgens.pedersen_gens()
    jG, jH = jgens.bp_gens(32)
    jbasis = ([jB, jBb] + list(jG) + list(jH))[:K]
    assert jbasis == basis  # the same SHAKE chains in both packages
    assert got == [jed.compress(jed.msm(v, jbasis)) for v in vecs]


def test_msm_fixed_many_on_a_mesh():
    """Under ``set_mesh`` the ed25519 seam takes the mesh route
    (``msm_many_sharded``, four positions on the CPU): the same points."""
    from libzkp_tpu_torch.parallel import mesh as meshmod

    rng = random.Random(5)
    G, H = gens.bp_gens(8)
    basis = list(G) + list(H) + [gens.pedersen_gens()[0]]
    vecs = [[rng.randrange(L) for _ in basis] for _ in range(5)]
    want = [ed.compress(ed.msm(v, basis)) for v in vecs]
    meshmod.set_mesh(meshmod.get_mesh(dp=2, shard=2, devices=[CPU] * 4))
    try:
        got = [ed.compress(p) for p in ed.msm_fixed_many(vecs, basis, device=CPU)]
    finally:
        meshmod.set_mesh(None)
    assert got == want


def _instances(n: int, T):
    """Three lanes: the value's extremes and a random one, under the three
    backend transcript labels."""
    rng = random.Random(n)
    values = [0, (1 << n) - 1, rng.randrange(1 << n)]
    return [(T(label), v, rng.randrange(L), n) for label, v in zip(LABELS, values)]


@pytest.mark.parametrize("n", [1, 2, 4, 8, 16, 32])
def test_lockstep_prover_matches_reference(jax_lockstep, n):
    per = (2 * n + 4) * 64
    rand = hashlib.shake_256(b"widths-%d" % n).digest(per * len(LABELS))
    got = bp._prove_batch_fixed_n(_instances(n, Transcript), n, rand=rand, device=CPU)
    want = jbulp._prove_batch_fixed_n(_instances(n, JTranscript), n, rand)
    native = bp._prove_batch_native(_instances(n, Transcript), n, rand)
    assert [(rp.to_bytes(), V) for rp, V in native] == [(rp.to_bytes(), V) for rp, V in got]
    for (rp, V), (jrp_, jV), label in zip(got, want, LABELS):
        assert len(rp.to_bytes()) == 7 * 32 + 64 * (n.bit_length() - 1) + 64
        assert rp.to_bytes() == jrp_.to_bytes() and V == jV
        assert bp.verify_single(rp, Transcript(label), V, n)
        assert jbulp.verify_single(jrp_, JTranscript(label), V, n)
        assert not bp.verify_single(rp, Transcript(label), V, 2 * n)


def test_prove_range_with_bits_8_envelope_parity(monkeypatch):
    def seeded(fn, *args, **kw):
        buf = hashlib.shake_256(b"range-8").digest(1 << 16)
        pos = [0]

        def urandom(k):
            pos[0] += k
            return buf[pos[0] - k : pos[0]]

        with monkeypatch.context() as m:
            m.setattr(os, "urandom", urandom)
            return fn(*args, **kw)

    got = seeded(trp.prove_range_with_bits, 100, 0, 255, 8, device=CPU)
    want = seeded(jrp.prove_range_with_bits, 100, 0, 255, 8)
    assert got == want
    assert trp.verify_range(want, 0, 255) and jrp.verify_range(got, 0, 255)
    assert not trp.verify_range(got, 1, 255)


@pytest.mark.parametrize("n", [0, 3, 12, 128])
def test_refused_widths_raise_reference_class(n):
    with pytest.raises(Exception) as want:
        jbulp._prove_batch_fixed_n([(JTranscript(b"w"), 1, 1, n)], n, b"")
    with pytest.raises(Exception) as got:
        bp._prove_batch_fixed_n([(Transcript(b"w"), 1, 1, n)], n, b"", device=CPU)
    assert type(got.value) is type(want.value) is AssertionError


@pytest.mark.parametrize("n", [12, 128])
def test_refused_widths_through_the_entry_point(n):
    with pytest.raises(Exception) as want:
        jrp.prove_range_with_bits(5, 0, 200, n)
    with pytest.raises(Exception) as got:
        trp.prove_range_with_bits(5, 0, 200, n, device=CPU)
    assert type(got.value) is type(want.value) is AssertionError
