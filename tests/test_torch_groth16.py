"""The port's batched Groth16 equality prover against the JAX package.

Both packages prove with one key: the JAX package's equality key, carried
into the port by ``convert.proving_key``. With the same (r, s) draws fed to
both (numpy-seeded, injected as ``_rand_fr``), the port's
``prove_equality_batch(device="cpu")`` gives envelopes byte-identical to the
JAX package's ``prove_equality``; proofs verify across the packages; a
statement repeated 8 times takes the grouped finish, still verifies, and
gives the bytes of the per-proof finish under the same draws; the native
whole-pipeline baseline ``prove_assigned_native`` gives the card route's
bytes under the same draws; the native ``verify`` gives the verdicts of its
pure-Python golden ``verify_py``.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

import libzkp_tpu_torch as zkpt
from libzkp_tpu.models import groth16 as jg
from libzkp_tpu.models import snark_backend as jsb
from libzkp_tpu.models.schemes import equality_proof as jeq
from libzkp_tpu_torch import convert
from libzkp_tpu_torch.models import groth16 as tg
from libzkp_tpu_torch.models import snark_backend as tsb
from libzkp_tpu_torch.ops import kernels, msm_device
from libzkp_tpu_torch.utils.commitment import commit_value_snark
from libzkp_tpu_torch.utils.envelope import Proof as Envelope
from libzkp_tpu_torch.utils.errors import InvalidInput

DISTINCT = [3, 77, (1 << 64) - 1]
REPEATED = 12345
GROUP = 8


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the suite runs in several worker processes at
    once, and OpenMP pools oversubscribing the cores stall each other."""
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _feeder(seq):
    it = iter(seq)
    return lambda: next(it)


@pytest.fixture(scope="module")
def keys():
    """The JAX package's equality key, and the port's setup cache holding
    its conversion (restored to a fresh state afterwards)."""
    jpk = jsb._get_equality_setup()
    tsb._reset_for_tests()
    tsb._equality_setup = convert.proving_key(jpk)
    yield jpk, tsb._equality_setup
    tsb._reset_for_tests()


@pytest.fixture(scope="module")
def batch(keys):
    """One CPU batch: three distinct statements, then one statement 8 times,
    under seeded (r, s) draws; and the JAX proofs of the three distinct
    statements under the same draws."""
    draws = [int(x) for x in np.random.default_rng(2026).integers(1, 1 << 62, size=2 * 11)]
    pairs = [(v, v) for v in DISTINCT] + [(REPEATED, REPEATED)] * GROUP
    saved = tg._rand_fr
    tg._rand_fr = _feeder(draws)
    try:
        ours = zkpt.prove_equality_batch(pairs, device="cpu")
    finally:
        tg._rand_fr = saved
    saved = jg._rand_fr
    jg._rand_fr = _feeder(draws)
    try:
        theirs = [jeq.prove_equality(v, v) for v in DISTINCT]
    finally:
        jg._rand_fr = saved
    return draws, pairs, ours, theirs


def test_convert_proving_key_copies_every_field(keys):
    jpk, pk = keys
    assert tg.pk_to_bytes(pk) == jg.pk_to_bytes(jpk)
    assert tg.vk_to_bytes(pk.vk) == jg.vk_to_bytes(jpk.vk)
    assert (len(pk.a_query), len(pk.h_query), len(pk.l_query)) == (334, 511, 332)


def test_batch_bytes_identical_to_jax(batch):
    _, _, ours, theirs = batch
    assert len(ours) == len(DISTINCT) + GROUP
    for a, b in zip(ours[: len(DISTINCT)], theirs):
        assert a == b
    assert not any(kernels.launches().values())  # the CPU runs the plain versions


def test_batch_lane_equals_host_golden_prover(batch, keys):
    """A lane of the device batch equals the port's host golden prover (host
    h, host MSMs, host finish) under the same (r, s)."""
    draws, _, ours, _ = batch
    _, pk = keys
    v = DISTINCT[1]
    c = commit_value_snark(v)
    cs = tsb.build_equality_circuit(v, v, int.from_bytes(c, "little"))
    saved = tg._rand_fr
    tg._rand_fr = _feeder(draws[2:4])
    try:
        proof = tg.proof_to_bytes(tg.prove(pk, cs))
    finally:
        tg._rand_fr = saved
    assert Envelope.from_bytes(ours[1]).proof == proof


def test_proofs_verify_across_packages(batch, keys):
    _, pairs, ours, theirs = batch
    for env, (v, _) in zip(theirs, pairs):
        assert zkpt.verify_equality(env, v, v)
    for env, (v, _) in zip(ours[: len(DISTINCT)], pairs):
        assert jeq.verify_equality(env, v, v)
    c = commit_value_snark(DISTINCT[0])
    assert zkpt.verify_equality_with_commitment(ours[0], c)
    assert not zkpt.verify_equality_with_commitment(ours[0], commit_value_snark(DISTINCT[1]))
    assert not zkpt.verify_equality(ours[0], DISTINCT[1], DISTINCT[1])
    bad = bytearray(ours[0])
    bad[len(bad) // 2] ^= 1
    assert not zkpt.verify_equality(bytes(bad), DISTINCT[0], DISTINCT[0])
    assert not jeq.verify_equality(bytes(bad), DISTINCT[0], DISTINCT[0])


def test_grouped_finish_verifies(batch):
    """The 8 proofs of one statement take _finish_proof_group (fixed-basis
    MSMs over bases of 1 and 3 points) and each verifies, in both packages;
    their fresh blinding makes them all distinct."""
    _, _, ours, _ = batch
    group = ours[len(DISTINCT):]
    assert len(set(group)) == GROUP
    for env in group[:3]:
        assert zkpt.verify_equality(env, REPEATED, REPEATED)
    for env in group:
        assert jeq.verify_equality(env, REPEATED, REPEATED)


def test_grouped_finish_equals_per_proof_route(batch, keys, monkeypatch):
    """Under the same (r, s) draws the grouped finish gives the bytes of the
    per-proof finish (forced by raising GROUP_MIN above the group). The
    group's MSMs went through the seam: the key's [delta_g1] and [delta_g2]
    tables entered its LRU, the statement's own [P1, P2, delta_g1] did not."""
    draws, _, ours, _ = batch
    _, pk = keys
    cached = [key[2] for key in msm_device._TABLES if key[1] == "cpu"]
    assert (pk.delta_g1,) in cached and (pk.vk.delta_g2,) in cached
    assert not any(len(basis) == 3 and basis[2] == pk.delta_g1 for basis in cached)
    monkeypatch.setattr(tg, "GROUP_MIN", GROUP + 1)
    monkeypatch.setattr(tg, "_rand_fr", _feeder(draws[2 * len(DISTINCT):]))
    per_proof = zkpt.prove_equality_batch([(REPEATED, REPEATED)] * GROUP, device="cpu")
    assert per_proof == ours[len(DISTINCT):]


def test_h_from_csr_matches_constraint_system():
    """h of the batch path (CSR rows of the setup circuit, pure-Python
    sparse products) equals h of the full constraint system."""
    v = 987654321
    fr = int.from_bytes(commit_value_snark(v), "little")
    cs = tsb.build_equality_circuit(v, v, fr)
    num_instance, csr = tsb._equality_shape()
    z = tsb._equality_assignment(v, v, fr)
    assert z == cs.full_assignment()
    n = 512
    assert tg._h_from_csr(n, num_instance, csr, z) == tg._compute_h(cs, n)


def test_keys_load_from_a_jax_key_directory(keys, tmp_path):
    """Key files the JAX package wrote load into the port's setup."""
    jpk, pk = keys
    (tmp_path / "equality_mimc_pk.bin").write_bytes(jg.pk_to_bytes(jpk))
    (tmp_path / "equality_mimc_vk.bin").write_bytes(jg.vk_to_bytes(jpk.vk))
    saved = tsb._equality_setup
    tsb._reset_for_tests()
    try:
        tsb.set_snark_key_dir(str(tmp_path))
        loaded = tsb._get_equality_setup()
        assert tg.pk_to_bytes(loaded) == tg.pk_to_bytes(pk)
    finally:
        tsb._reset_for_tests()
        tsb._equality_setup = saved


def test_equality_rejects_bad_statements(keys):
    with pytest.raises(InvalidInput):
        zkpt.prove_equality(1, 2, device="cpu")
    assert tsb.SnarkBackend.prove_equality_zk_many(
        [(5, 5, commit_value_snark(6)), (5, 5, b"\xff" * 32)], device="cpu"
    ) == [b"", b""]
    assert tsb.SnarkBackend.prove_equality_zk(5, 6, commit_value_snark(5), device="cpu") == b""
    assert not zkpt.verify_equality(b"\x00" * 10, 5, 5)
    assert not zkpt.verify_equality(b"", 5, 6)


def test_card_route_equals_native_baseline(batch, keys):
    """``prove_assigned_native`` (native h, the five query MSMs in one native
    call, the host finish) on the batch's statements, three distinct and one
    8 times, under the same draws: the bytes of the card route's CPU batch,
    the grouped finish's included."""
    draws, pairs, ours, _ = batch
    _, pk = keys
    num_instance, csr = tsb._equality_shape()
    z_list = [tsb._equality_assignment(v, v, int.from_bytes(commit_value_snark(v), "little"))
              for v, _ in pairs]
    saved = tg._rand_fr
    tg._rand_fr = _feeder(draws)
    try:
        native = tg.prove_assigned_native(pk, z_list, num_instance, csr)
    finally:
        tg._rand_fr = saved
    assert [tg.proof_to_bytes(p) for p in native] == [Envelope.from_bytes(e).proof for e in ours]


def test_verify_equals_verify_py(batch, keys):
    _, pairs, ours, _ = batch
    _, pk = keys
    proof = tg.proof_from_bytes(Envelope.from_bytes(ours[0]).proof)
    fr = int.from_bytes(commit_value_snark(pairs[0][0]), "little")
    other = int.from_bytes(commit_value_snark(pairs[1][0]), "little")
    for public in ([fr], [other], [fr, fr], []):
        assert tg.verify(pk.vk, public, proof) == tg.verify_py(pk.vk, public, proof) == (public == [fr])
    swapped = tg.Proof(a=proof.c, b=proof.b, c=proof.a)
    assert not tg.verify(pk.vk, [fr], swapped) and not tg.verify_py(pk.vk, [fr], swapped)
