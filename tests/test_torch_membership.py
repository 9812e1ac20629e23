"""The port's set-membership proofs (scheme 4) and Groth16 batch
verification against the JAX package.

Both packages prove with one key: the JAX package's membership key, carried
into the port by ``convert.proving_key``. With the same (r, s) draws fed to
both (numpy-seeded, injected as ``_rand_fr``), the port's
``prove_membership_batch(device="cpu")`` gives envelopes byte-identical to
the JAX package's ``prove_membership`` and to the port's native baseline
``prove_assigned_native``; proofs verify across the packages, singly and in
batch; a reordered set is accepted, a changed set and a tampered proof are
rejected; errors have the JAX package's types; the batch verifiers give
per-proof verdicts with bad proofs among good ones, under injected
weights and with every fixed-basis registry full; keys load from a JAX
key directory.
"""

from __future__ import annotations

import contextlib

import numpy as np
import pytest
import torch

import libzkp_tpu_torch as zkpt
from libzkp_tpu.models import groth16 as jg
from libzkp_tpu.models import snark_backend as jsb
from libzkp_tpu.models.schemes import equality_proof as jeq
from libzkp_tpu.models.schemes import set_membership as jsm
from libzkp_tpu_torch import convert, native
from libzkp_tpu_torch.models import groth16 as tg
from libzkp_tpu_torch.models import snark_backend as tsb
from libzkp_tpu_torch.ops import bn254 as bn
from libzkp_tpu_torch.ops import kernels
from libzkp_tpu_torch.utils.commitment import commit_value_snark
from libzkp_tpu_torch.utils.envelope import Proof as Envelope

SETS = [[11], [5, 70, 3, 9, 1 << 40], list(range(100, 164))]  # sizes 1, 5, 64


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


@contextlib.contextmanager
def _jax_keys(jpk=None, jeq_pk=None):
    """The JAX package's setups pinned to these keys for the body (another
    test in this worker may have reset them)."""
    saved = jsb._membership_setup, jsb._equality_setup
    jsb._membership_setup = jpk if jpk is not None else saved[0]
    jsb._equality_setup = jeq_pk if jeq_pk is not None else saved[1]
    try:
        yield
    finally:
        jsb._membership_setup, jsb._equality_setup = saved


@pytest.fixture(scope="module")
def keys():
    """The JAX package's membership and equality keys, and the port's setup
    caches holding their conversions (a fresh state afterwards)."""
    jpk, jeq_pk = jsb._get_membership_setup(), jsb._get_equality_setup()
    tsb._reset_for_tests()
    tsb._membership_setup = convert.proving_key(jpk)
    tsb._equality_setup = convert.proving_key(jeq_pk)
    yield jpk, jeq_pk
    tsb._reset_for_tests()


@pytest.fixture(scope="module")
def jax_envelopes(keys):
    """JAX membership envelopes: the value of each of SETS (a set of 1, of 5
    and of 64), and a second value of the set of 5."""
    jpk, _ = keys
    items = [(s[len(s) // 2], s) for s in SETS] + [(SETS[1][0], SETS[1])]
    with _jax_keys(jpk):
        return [(v, s, jsm.prove_membership(v, s)) for v, s in items]


@pytest.mark.parametrize("the_set", SETS, ids=["1", "5", "64"])
def test_assignment_equals_the_circuits(the_set):
    v = the_set[-1]
    c = commit_value_snark(v)
    fr = int.from_bytes(c, "little")
    pad = tsb.MAX_SET_SIZE - len(the_set)
    sel = [x == len(the_set) - 1 for x in range(tsb.MAX_SET_SIZE)]
    args = (v, sel, the_set + [0] * pad, [True] * len(the_set) + [False] * pad, fr)
    cs = tsb.build_membership_circuit(*args)
    assert tsb._membership_assignment(*args) == cs.full_assignment()
    assert jsb._membership_assignment(*args) == cs.full_assignment()
    assert tsb._membership_statement(v, the_set, c) == cs.full_assignment()
    assert cs.is_satisfied()
    assert (cs.num_instance, len(cs.constraints), cs.num_variables) == (130, 589, 589)


def test_card_route_batch_bytes_identical_to_jax_and_native(keys):
    """One CPU batch of the card route, two statements (a set of 1 and a set
    of 64), under seeded (r, s): the envelopes equal the JAX package's
    ``prove_membership`` and the native baseline under the same draws, and
    verify in both packages, singly and in batch."""
    jpk, _ = keys
    pk = tsb._get_membership_setup()
    items = [(SETS[0][0], SETS[0]), (SETS[2][7], SETS[2])]
    draws = [int(x) for x in np.random.default_rng(4444).integers(1, 1 << 62, size=4)]
    saved = tg._rand_fr
    tg._rand_fr = _feeder(draws)
    try:
        ours = zkpt.prove_membership_batch(items, device="cpu")
    finally:
        tg._rand_fr = saved
    assert not any(kernels.launches().values())  # the CPU runs the plain versions
    saved = jg._rand_fr
    try:
        with _jax_keys(jpk):
            for i, (v, s) in enumerate(items):
                jg._rand_fr = _feeder(draws[2 * i : 2 * i + 2])
                assert ours[i] == jsm.prove_membership(v, s)
    finally:
        jg._rand_fr = saved
    num_instance, csr = tsb._membership_shape()
    z_list = [tsb._membership_statement(v, s, commit_value_snark(v)) for v, s in items]
    tg._rand_fr = _feeder(draws)
    try:
        native = tg.prove_assigned_native(pk, z_list, num_instance, csr)
    finally:
        tg._rand_fr = saved
    for env, (_, s), proof in zip(ours, items, native):
        assert Envelope.from_bytes(env).proof[4 + 8 * len(s):] == tg.proof_to_bytes(proof)
    with _jax_keys(jpk):
        for env, (_, s) in zip(ours, items):
            assert zkpt.verify_membership(env, s)
            assert jsm.verify_membership(env, s)
    entries = [(Envelope.from_bytes(e).proof[4 + 8 * len(s):], s, Envelope.from_bytes(e).commitment)
               for e, (_, s) in zip(ours, items)]
    assert tsb.SnarkBackend.verify_membership_batch(entries) == [True, True]


def test_jax_envelopes_verify_in_the_port(keys, jax_envelopes):
    for v, s, env in jax_envelopes:
        assert zkpt.verify_membership(env, s)
        assert zkpt.verify_membership(env, list(reversed(s)))  # order is ignored
        assert not zkpt.verify_membership(env, s[:-1] + [s[-1] + 1])
        e = Envelope.from_bytes(env)
        bad = bytearray(e.proof)
        bad[-100] ^= 1  # inside the Groth16 proof's B
        assert not zkpt.verify_membership(Envelope.new(e.scheme, bytes(bad), e.commitment).to_bytes(), s)
    assert not zkpt.verify_membership(b"\x00" * 10, SETS[0])
    assert not zkpt.verify_membership(jax_envelopes[1][2], SETS[0])
    entries = []
    for _, s, env in jax_envelopes:
        e = Envelope.from_bytes(env)
        entries.append((e.proof[4 + 8 * len(s):], s, e.commitment))
    assert tsb.SnarkBackend.verify_membership_batch(entries) == [True] * len(entries)


@pytest.mark.parametrize("call", [
    lambda m: m.prove_membership(4, [1, 2, 3], **m.kw),
    lambda m: m.prove_membership(4, list(range(65)), **m.kw),
    lambda m: m.prove_membership(4, [], **m.kw),
    lambda m: m.prove_membership(-1, [1, 2], **m.kw),
    lambda m: m.prove_membership_batch([(1, [1]), (4, [1, 2, 3])], **m.kw),
], ids=["not-in-set", "over-64", "empty", "negative", "batch"])
def test_errors_match_jax(call):
    class Port:
        prove_membership = staticmethod(zkpt.prove_membership)
        prove_membership_batch = staticmethod(zkpt.prove_membership_batch)
        kw = {"device": "cpu"}

    class Jax:
        prove_membership = staticmethod(jsm.prove_membership)
        prove_membership_batch = staticmethod(jsm.prove_membership_batch)
        kw = {}

    errors = []
    for m in (Port, Jax):
        with pytest.raises(Exception) as info:
            call(m)
        errors.append((type(info.value).__name__, str(info.value)))
    assert errors[0] == errors[1]


def test_backend_gives_empty_bytes_for_unprovable_entries(keys):
    c = commit_value_snark(7)
    assert tsb.SnarkBackend.prove_membership_zk_many(
        [(7, [1, 2], c), (7, [], c), (7, list(range(65)) + [7], c), (7, [7], commit_value_snark(8)),
         (7, [7], b"\xff" * 32)], device="cpu") == [b""] * 5
    assert tsb.SnarkBackend.prove(b"\x00" * 47, device="cpu") == b""


def _batch_case(keys, jax_envelopes, scheme: str):
    """(batch verifier, entries, per-proof verdicts): the JAX proofs with a
    bad one among them (another statement's proof)."""
    if scheme == "membership":
        entries = []
        for _, s, env in jax_envelopes:
            e = Envelope.from_bytes(env)
            entries.append((e.proof[4 + 8 * len(s):], s, e.commitment))
        entries.insert(2, (entries[0][0], entries[1][1], entries[1][2]))
        single = [tsb.SnarkBackend.verify_membership_zk(*e) for e in entries]
        return tsb.SnarkBackend.verify_membership_batch, entries, single
    _, jeq_pk = keys
    with _jax_keys(jeq_pk=jeq_pk):
        envs = [Envelope.from_bytes(jeq.prove_equality(v, v)) for v in (3, 77, 1 << 63, 5)]
    entries = [(e.proof, e.commitment) for e in envs]
    entries.insert(1, (entries[0][0], entries[2][1]))
    single = [tsb.SnarkBackend.verify_equality_zk(*e) for e in entries]
    return tsb.SnarkBackend.verify_equality_batch, entries, single


@pytest.mark.parametrize("scheme", ["membership", "equality"])
def test_batch_verify_gives_per_proof_verdicts(keys, jax_envelopes, scheme, monkeypatch):
    """One bad proof among good ones: bisection finds it, with random and
    with injected (seeded) weights; all good ones pass in one combination,
    one weight a proof; the port's verify equals its pure-Python golden."""
    verify_batch, entries, single = _batch_case(keys, jax_envelopes, scheme)
    assert single.count(False) == 1
    assert verify_batch(entries) == single
    weights = [int(w) for w in np.random.default_rng(128).integers(1, 1 << 62, size=64)]
    used = []
    feed = _feeder(weights)
    monkeypatch.setattr(tg, "_rlc_weight", lambda: used.append(1) or feed())
    assert verify_batch(entries) == single
    used.clear()
    good = [e for e, ok in zip(entries, single) if ok]
    assert verify_batch(good) == [True] * len(good)
    assert len(used) == len(good)
    assert verify_batch([]) == []


@pytest.mark.parametrize("scheme", ["membership", "equality"])
def test_batch_verify_with_a_full_registry(keys, jax_envelopes, scheme, monkeypatch):
    """Batch verification registers no fixed-basis table: with every native
    registry full (a new basis raises MemoryError) it still gives the
    per-proof verdicts."""
    verify_batch, entries, single = _batch_case(keys, jax_envelopes, scheme)
    monkeypatch.setattr(native, "MAX_FIXED_BASES", 0)
    fresh = bn.g1_scalar_mul_py(987654321987654321, bn.g1_from_affine(bn.G1_GEN))
    with pytest.raises(MemoryError):
        bn.g1_msm_fixed([5], [fresh])
    assert verify_batch(entries) == single


def test_verify_equals_verify_py(keys, jax_envelopes):
    pk = tsb._get_membership_setup()
    v, s, env = jax_envelopes[1]
    e = Envelope.from_bytes(env)
    proof = tg.proof_from_bytes(e.proof[4 + 8 * len(s):])
    fr = int.from_bytes(e.commitment, "little")
    public = tsb._membership_public(s, fr)
    assert tg.verify(pk.vk, public, proof) and tg.verify_py(pk.vk, public, proof)
    other = tsb._membership_public(SETS[0], fr)
    assert not tg.verify(pk.vk, other, proof) and not tg.verify_py(pk.vk, other, proof)
    assert not tg.verify(pk.vk, public[:-1], proof) and not tg.verify_py(pk.vk, public[:-1], proof)


def test_keys_load_from_a_jax_key_directory(keys, tmp_path):
    jpk, _ = keys
    (tmp_path / "membership_mimc_pk.bin").write_bytes(jg.pk_to_bytes(jpk))
    (tmp_path / "membership_mimc_vk.bin").write_bytes(jg.vk_to_bytes(jpk.vk))
    saved = tsb._membership_setup, tsb._equality_setup
    tsb._reset_for_tests()
    try:
        tsb.set_snark_key_dir(str(tmp_path))
        assert not tsb.is_snark_initialized()
        loaded = tsb._get_membership_setup()
        assert tsb.is_snark_initialized()
        assert tg.pk_to_bytes(loaded) == jg.pk_to_bytes(jpk)
    finally:
        tsb._reset_for_tests()
        tsb._membership_setup, tsb._equality_setup = saved


def test_trait_pair_verifies_a_jax_equality_proof(keys):
    _, jeq_pk = keys
    with _jax_keys(jeq_pk=jeq_pk):
        e = Envelope.from_bytes(jeq.prove_equality(99, 99))
    assert tsb.SnarkBackend.verify(e.proof, e.commitment)
    assert not tsb.SnarkBackend.verify(e.proof, commit_value_snark(98))
