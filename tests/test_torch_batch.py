"""The port's batch API (registry, store, ``process_batch``) against the JAX
package's.

* The registry: its lifecycle, status and errors, equal to the JAX
  package's (the reference's ``tests/integration.rs`` batch cases).
* The store: both packages write byte-identical ``LZB1`` files for the same
  operations and read each other's; export, import, refresh, clear and
  ``process_batch`` (which deletes the file) as in the reference.
* The bucketing of ``process_batch``, with recording stand-ins for the five
  batch provers: the buckets' order, the results in op order, one
  ``prove_single_batch`` for the whole Bulletproofs pool with each op's
  tail, the MiMC pre-hash passed by ``commitments=`` at 64 distinct values
  and not at 63, one failure failing the batch.
* One real mixed batch: two ops of each kind under one seeded stand-in for
  ``os.urandom``, on ``device="cpu"``, byte-identical to the JAX package's
  ``process_batch`` on the same stream, under a time limit of its own.

Every comparison is exact (bytes, verdicts, dicts).
"""

from __future__ import annotations

import contextlib
import hashlib
import os
import signal

import pytest
import torch

import libzkp_tpu.api as japi
from libzkp_tpu.advanced import batch as jbatch
from libzkp_tpu.advanced import batch_store as jstore
from libzkp_tpu.models import bulletproofs as jbulp
from libzkp_tpu.models import snark_backend as jsb

import libzkp_tpu_torch as zkp
from libzkp_tpu_torch import convert
from libzkp_tpu_torch.advanced import batch as tbatch
from libzkp_tpu_torch.advanced import batch_store as tstore
from libzkp_tpu_torch.models import snark_backend as tsb
from libzkp_tpu_torch.models.schemes import common
from libzkp_tpu_torch.ops import kernels
from libzkp_tpu_torch.ops.mimc import fr_to_commitment
from libzkp_tpu_torch.parallel import batch_prover
from libzkp_tpu_torch.utils.envelope import Proof
from libzkp_tpu_torch.utils.errors import ProofGenerationFailed

MIXED_BATCH_LIMIT_S = 900  # the real mixed batch on the CPU takes a few minutes

# one op of each kind, the API's batch_add_* name and arguments
OPS = [
    ("range", (5, 0, 10)),
    ("equality", (7, 7)),
    ("threshold", ([10, 20, 30], 50)),
    ("membership", (3, [1, 2, 3, 5])),
    ("improvement", (1, 8)),
    ("consistency", ([1, 2, 2, 9],)),
]


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the suite runs in several worker processes at
    once, and OpenMP pools oversubscribing the cores stall each other."""
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


@pytest.fixture(autouse=True)
def _fresh_registries():
    """Each test starts with empty registries and no store in either
    package, and leaves them so."""
    for mod in (tbatch, jbatch, tstore, jstore):
        mod._reset_for_tests()
    yield
    for mod in (tbatch, jbatch, tstore, jstore):
        mod._reset_for_tests()


def _add(pkg, bid: int, kind: str, args) -> None:
    getattr(pkg, f"batch_add_{kind}_proof")(bid, *args)


def _batch(pkg, ops) -> int:
    bid = pkg.create_proof_batch()
    for kind, args in ops:
        _add(pkg, bid, kind, args)
    return bid


# -- the registry ---------------------------------------------------------------


def test_registry_lifecycle_and_status():
    bid, jbid = _batch(zkp, OPS), _batch(japi, OPS)
    assert bid != 0 and bid < 1 << 64
    status = zkp.get_batch_status(bid)
    assert status == japi.get_batch_status(jbid)
    assert status["total_operations"] == 6
    assert all(status[f"{kind}_proofs"] == 1 for kind, _ in OPS)
    other = zkp.create_proof_batch()
    assert other != bid and zkp.get_batch_status(other)["total_operations"] == 0
    zkp.clear_batch(bid)
    zkp.clear_batch(bid)  # clearing twice is no error
    for call in (lambda: zkp.get_batch_status(bid), lambda: zkp.process_batch(bid, device="cpu"),
                 lambda: zkp.export_batch_to_file(bid, "unused.bin")):
        with pytest.raises(ValueError, match=f"Invalid batch ID: {bid}"):
            call()
    with pytest.raises(ValueError, match="Invalid batch ID"):
        zkp.batch_add_range_proof(bid, 1, 0, 2)
    assert zkp.process_batch(other, device="cpu") == []  # an empty batch proves nothing
    with pytest.raises(ValueError):
        zkp.get_batch_status(other)  # process_batch consumed it


@pytest.mark.parametrize("kind, args", [
    ("range", (11, 0, 10)), ("range", (5, 10, 0)), ("range", (-1, 0, 10)),
    ("equality", (7, 8)), ("threshold", ([], 1)), ("threshold", ([1, 2], 4)),
    ("threshold", ([(1 << 64) - 1, 1], 0)), ("membership", (4, [1, 2, 3])),
    ("membership", (1, [])), ("improvement", (8, 8)), ("improvement", (9, 8)),
    ("consistency", ([3, 2],)), ("consistency", ([],)),
])
def test_batch_add_validation_equals_the_jax_packages(kind, args):
    bid, jbid = zkp.create_proof_batch(), japi.create_proof_batch()
    with pytest.raises(Exception) as ours:
        _add(zkp, bid, kind, args)
    with pytest.raises(Exception) as theirs:
        _add(japi, jbid, kind, args)
    assert type(ours.value).__name__ == type(theirs.value).__name__
    assert isinstance(ours.value, (ValueError, OverflowError))
    assert str(ours.value) == str(theirs.value)
    assert zkp.get_batch_status(bid)["total_operations"] == 0


# -- the store --------------------------------------------------------------------


@pytest.fixture
def store(tmp_path):
    """Both packages' stores in one directory."""
    zkp.set_batch_store_dir(str(tmp_path))
    japi.set_batch_store_dir(str(tmp_path))
    return tmp_path


def test_store_files_are_byte_identical_and_read_across(store):
    bid, jbid = _batch(zkp, OPS), _batch(japi, OPS)
    ours = tstore.batch_file_path(store, bid).read_bytes()
    assert ours[:4] == b"LZB1"
    assert ours == jstore.batch_file_path(store, jbid).read_bytes()
    assert zkp.get_batch_store_dir() == japi.get_batch_store_dir() == str(store)
    assert zkp.list_batch_ids_in_store() == sorted([bid, jbid]) == japi.list_batch_ids_in_store()
    # each package opens the other's file
    tbatch._reset_for_tests()
    jbatch._reset_for_tests()
    zkp.open_batch_from_store(jbid)
    japi.open_batch_from_store(bid)
    assert zkp.get_batch_status(jbid) == japi.get_batch_status(bid)
    assert tbatch._registry[jbid] == tstore.decode_batch_bytes(ours)
    with pytest.raises(ValueError, match="already open"):
        zkp.open_batch_from_store(jbid)


def test_store_export_import_refresh_and_clear(store, tmp_path):
    bid = _batch(zkp, OPS[:3])
    dest = tmp_path / "out" / "exported.bin"
    zkp.export_batch_to_file(bid, str(dest))
    jdest = tmp_path / "jax_exported.bin"
    jbid = _batch(japi, OPS[:3])
    japi.export_batch_to_file(jbid, str(jdest))
    assert dest.read_bytes() == jdest.read_bytes()
    new_id = zkp.import_batch_from_file(str(jdest))
    assert new_id not in (bid, jbid)
    assert zkp.get_batch_status(new_id) == japi.get_batch_status(japi.import_batch_from_file(str(dest)))
    assert new_id in zkp.list_batch_ids_in_store()  # the import persists
    # another process adds an op to the file; refresh reads it
    japi_side = jstore.read_batch_file(store, bid)
    japi_side.add_improvement_proof(2, 3)
    jstore.write_batch_file(store, bid, japi_side)
    zkp.refresh_batch_from_store(bid)
    assert zkp.get_batch_status(bid)["improvement_proofs"] == 1
    with pytest.raises(ValueError, match="not loaded"):
        zkp.refresh_batch_from_store(12345)
    zkp.clear_batch(bid)
    assert bid not in zkp.list_batch_ids_in_store()
    with pytest.raises(RuntimeError):  # StorageError: no such file
        zkp.import_batch_from_file(str(tmp_path / "missing.bin"))
    (tmp_path / "bad.bin").write_bytes(dest.read_bytes() + b"\0")
    with pytest.raises(RuntimeError, match="trailing bytes"):
        zkp.import_batch_from_file(str(tmp_path / "bad.bin"))


def test_process_batch_deletes_the_file_and_proves(store):
    bid = _batch(zkp, [("improvement", (1, 8)), ("improvement", (30, 50))])
    assert bid in zkp.list_batch_ids_in_store()
    proofs = zkp.process_batch(bid, device="cpu")
    assert bid not in zkp.list_batch_ids_in_store()
    assert zkp.verify_improvement(proofs[0], 1) and zkp.verify_improvement(proofs[1], 30)
    assert japi.verify_improvement(proofs[1], 30)


def test_store_directory_from_the_environment(monkeypatch, tmp_path):
    assert zkp.get_batch_store_dir() is None
    with pytest.raises(TypeError, match="batch store not configured"):
        zkp.list_batch_ids_in_store()
    monkeypatch.setenv("LIBZKP_BATCH_DIR", str(tmp_path))
    assert zkp.get_batch_store_dir() == str(tmp_path)
    bid = zkp.create_proof_batch()
    assert zkp.list_batch_ids_in_store() == [bid]


# -- the bucketing, with recording stand-ins ---------------------------------------------


class _FakeRangeProof:
    def __init__(self, j: int):
        self.j = j

    def to_bytes(self) -> bytes:
        return b"rp%02d" % self.j


@pytest.fixture
def stand_ins(monkeypatch):
    """Recording stand-ins for the five batch provers behind
    ``process_operations``; each call's name and arguments land in
    ``calls``."""
    calls = []

    def groth16(name):
        def prove(items, *, device, commitments):
            calls.append((name, [tuple(x) for x in items], str(device), commitments))
            return [b"%s:%d" % (name.encode(), i) for i in range(len(items))]
        return prove

    def mimc(values, *, device):
        calls.append(("mimc", list(values), str(device)))
        return [v + 1 for v in values]

    def single_batch(instances, *, device):
        calls.append(("pool", [(t.strobe.state_bytes(), v, n) for t, v, _, n in instances], str(device)))
        return [(_FakeRangeProof(j), bytes([j]) * 32) for j in range(len(instances))]

    def improvement(pairs, *, device):
        calls.append(("improvement", [tuple(p) for p in pairs], str(device)))
        return [b"improvement:%d" % i for i in range(len(pairs))]

    monkeypatch.setattr(batch_prover, "prove_equality_batch", groth16("equality"))
    monkeypatch.setattr(batch_prover, "prove_membership_batch", groth16("membership"))
    monkeypatch.setattr(batch_prover, "mimc_hash_batch", mimc)
    monkeypatch.setattr(common, "prove_single_batch", single_batch)
    monkeypatch.setattr(batch_prover, "prove_improvement_batch", improvement)
    return calls


def test_buckets_in_order_one_pool_and_tails(stand_ins):
    """OPS twice, interleaved: five calls in the reference's order, each on
    the entry device; the Bulletproofs pool is one call over every op's
    instances in op order, and each op's envelope carries its own slice."""
    ops = OPS + [(k, a) for k, a in OPS]
    out = zkp.process_batch(_batch(zkp, ops), device="cpu")
    assert [c[0] for c in stand_ins] == ["equality", "membership", "pool", "improvement"]
    assert all(c[-2 if c[0] in ("equality", "membership") else -1] == "cpu" for c in stand_ins)
    assert stand_ins[0][1] == [(7, 7)] * 2 and stand_ins[0][3] is None
    assert stand_ins[1][1] == [(3, [1, 2, 3, 5])] * 2
    assert stand_ins[3][1] == [(1, 8)] * 2
    # the pool: range (min, max), threshold, consistency (3 steps), twice
    pool = stand_ins[2][1]
    assert [v for _, v, _ in pool] == [5, 5, 10, 1, 0, 7] * 2
    assert all(n == 64 for _, _, n in pool)
    assert out[1] == b"equality:0" and out[7] == b"equality:1"
    assert out[3] == b"membership:0" and out[9] == b"membership:1"
    assert out[4] == b"improvement:0" and out[10] == b"improvement:1"
    slices = {0: [0, 1], 2: [2], 5: [3, 4, 5], 6: [6, 7], 8: [8], 11: [9, 10, 11]}
    schemes = {0: 1, 2: 3, 5: 6, 6: 1, 8: 3, 11: 6}
    for i, js in slices.items():
        env = Proof.from_bytes(out[i])
        assert env.scheme == schemes[i]
        assert [j for j in range(12) if b"rp%02d" % j in env.proof] == js


@pytest.mark.parametrize("distinct", [63, 64])
def test_mimc_prehash_from_64_distinct_values(stand_ins, distinct):
    """The equality and membership values, 64 distinct or more (one value
    shared by both buckets counts once), are hashed in one device batch and
    reach both provers as ``commitments=``; at 63 the provers commit
    themselves."""
    eq_values = list(range(100, 100 + 40))
    mem_values = list(range(139, 139 + distinct - 39))  # 139 is shared
    ops = [("equality", (v, v)) for v in eq_values] + [("membership", (v, [v, 1])) for v in mem_values]
    out = zkp.process_batch(_batch(zkp, ops), device="cpu")
    assert len(out) == len(ops)
    values = sorted(set(eq_values) | set(mem_values))
    assert len(values) == distinct
    if distinct < batch_prover.MIN_PREHASH_VALUES:
        assert [c[0] for c in stand_ins] == ["equality", "membership"]
        assert stand_ins[0][3] is None and stand_ins[1][3] is None
    else:
        assert [c[0] for c in stand_ins] == ["mimc", "equality", "membership"]
        assert stand_ins[0][1:] == (values, "cpu")
        assert stand_ins[1][3] == [fr_to_commitment(v + 1) for v in eq_values]
        assert stand_ins[2][3] == [fr_to_commitment(v + 1) for v in mem_values]


def test_one_failure_fails_the_batch(stand_ins, monkeypatch):
    def failing(items, *, device, commitments):
        raise ProofGenerationFailed("SNARK membership proof generation failed")

    monkeypatch.setattr(batch_prover, "prove_membership_batch", failing)
    bid = _batch(zkp, OPS)
    with pytest.raises(RuntimeError, match="membership proof generation failed"):
        zkp.process_batch(bid, device="cpu")
    with pytest.raises(ValueError, match="Invalid batch ID"):
        zkp.get_batch_status(bid)  # consumed before the proving
    assert [c[0] for c in stand_ins] == ["equality"]


def test_given_commitments_are_checked(shared_keys):
    """A given commitment that is not MiMC5 of the value gets no proof, and
    the batch raises before any MSM; a count that does not match is
    refused."""
    wrong = [zkp.snark_commit_value(2)]
    with pytest.raises(ProofGenerationFailed):
        zkp.prove_equality_batch([(1, 1)], device="cpu", commitments=wrong)
    with pytest.raises(ProofGenerationFailed):
        zkp.prove_membership_batch([(1, [1, 2])], device="cpu", commitments=wrong)
    with pytest.raises(ValueError, match="1 commitments for 2 pairs"):
        zkp.prove_equality_batch([(1, 1), (2, 2)], device="cpu", commitments=wrong)
    with pytest.raises(ValueError, match="0 commitments for 1 items"):
        zkp.prove_membership_batch([(1, [1])], device="cpu", commitments=[])
    assert not any(kernels.launches().values())


# -- one real mixed batch ---------------------------------------------------------


class _Stream:
    """A stand-in for ``os.urandom``: consecutive slices of one SHAKE stream
    of ``seed``, so the bytes a caller gets do not depend on how it splits
    its draws."""

    def __init__(self, seed: bytes):
        self.buf = hashlib.shake_256(seed).digest(1 << 20)
        self.pos = 0

    def __call__(self, n: int) -> bytes:
        out = self.buf[self.pos : self.pos + n]
        self.pos += n
        assert len(out) == n, "stream exhausted"
        return out


@contextlib.contextmanager
def _time_limit(seconds: int):
    """Raise ``TimeoutError`` in the body after ``seconds`` (SIGALRM; the
    test runs on its process's main thread)."""
    def expired(signum, frame):
        raise TimeoutError(f"the mixed batch took more than {seconds} s")

    old = signal.signal(signal.SIGALRM, expired)
    signal.alarm(seconds)
    try:
        yield
    finally:
        signal.alarm(0)
        signal.signal(signal.SIGALRM, old)


@pytest.fixture
def shared_keys():
    """The JAX package's keys in both packages' setups (fresh states
    afterwards)."""
    jeq, jmem = jsb._get_equality_setup(), jsb._get_membership_setup()
    saved = jsb._equality_setup, jsb._membership_setup
    tsb._reset_for_tests()
    tsb._equality_setup, tsb._membership_setup = convert.proving_key(jeq), convert.proving_key(jmem)
    jsb._equality_setup, jsb._membership_setup = jeq, jmem
    yield
    tsb._reset_for_tests()
    jsb._equality_setup, jsb._membership_setup = saved


def test_mixed_batch_bytes_identical_to_the_jax_packages(monkeypatch, shared_keys):
    """Two ops of each kind, interleaved, proved by the port on the CPU and
    by the JAX package (its Bulletproofs on its native tier), each under the
    same seeded ``os.urandom``: the same envelopes, which verify in both
    packages, singly and in ``verify_proofs_parallel``."""
    monkeypatch.setattr(jbulp, "_use_device_prover", lambda batch, n: False)
    ops = OPS + [("range", (0, 0, 0)), ("equality", ((1 << 64) - 1,) * 2),
                 ("threshold", ([4], 4)), ("membership", (9, [9])), ("improvement", (0, (1 << 64) - 1)),
                 ("consistency", ([5, 5],))]
    bid, jbid = _batch(zkp, ops), _batch(japi, ops)
    kernels.reset_launches()
    with _time_limit(MIXED_BATCH_LIMIT_S):
        with monkeypatch.context() as m:
            m.setattr(os, "urandom", _Stream(b"mixed batch"))
            ours = zkp.process_batch(bid, device="cpu")
        with monkeypatch.context() as m:
            m.setattr(os, "urandom", _Stream(b"mixed batch"))
            theirs = japi.process_batch(jbid)
    assert not any(kernels.launches().values())  # the CPU runs the plain versions
    assert [e[:2] for e in ours] == [bytes([2, s]) for s in (1, 2, 3, 4, 5, 6)] * 2
    assert ours == theirs
    labels = [kind for kind, _ in ops]
    assert zkp.verify_proofs_parallel(list(zip(ours, labels))) == [True] * 12
    assert japi.verify_proofs_parallel(list(zip(ours, labels))) == [True] * 12
    verify = {"range": lambda e, a: zkp.verify_range(e, *a[1:]),
              "equality": lambda e, a: zkp.verify_equality(e, *a),
              "threshold": lambda e, a: zkp.verify_threshold(e, a[1]),
              "membership": lambda e, a: zkp.verify_membership(e, a[1]),
              "improvement": lambda e, a: zkp.verify_improvement(e, a[0]),
              "consistency": lambda e, a: zkp.verify_consistency(e)}
    for env, (kind, args) in zip(ours, ops):
        assert verify[kind](env, args), kind
