"""The port's reference API (``libzkp_tpu_torch.api``, 49 names) against the
JAX package's ``libzkp_tpu.api``.

Envelopes of all six proof types come from the JAX package (its native tier
is fast on the CPU); the port's Groth16 setups hold the JAX package's keys,
carried over by ``convert.proving_key``. On them:

* the surface: the 49 names, their positional signatures, ``device=`` on
  every name that proves;
* composite proofs byte-identical to the JAX package's, read by both, a
  trailing byte or a changed digest raising the same class;
* ``get_proof_info``, ``validate_proof_chain``, the serialization codecs,
  ``snark_commit_value``: equal to the JAX package's;
* ``verify_proofs_parallel`` and ``dispatch.verify_proof_cryptographic`` on
  a mix of all six kinds with tampered copies, wrong type labels and
  garbage: the JAX package's flags;
* the proof cache, the metrics and ``prove_range_cached``'s hit path; the
  benchmarks on ``"improvement"`` (cheap on the CPU), an unknown type, a
  library error counted as a failed iteration and any other error
  propagating;
* the Bulletproofs backend's raw trait: ``prove`` on bad lengths, ``verify``
  on a JAX-made trait proof.

Every comparison is exact (bytes, verdicts, dicts).
"""

from __future__ import annotations

import inspect

import pytest
import torch

import libzkp_tpu.api as japi
from libzkp_tpu.models import bulletproofs as jbulp
from libzkp_tpu.models import snark_backend as jsb
from libzkp_tpu.models.bulletproofs_backend import BulletproofsBackend as JBackend
from libzkp_tpu.models.schemes import dispatch as jdispatch
from libzkp_tpu.utils import performance as jperf
from libzkp_tpu.utils import serialization as jser
from libzkp_tpu.utils.envelope import Proof as JProof

import libzkp_tpu_torch as zkp
from libzkp_tpu_torch import api, convert
from libzkp_tpu_torch.models import snark_backend as tsb
from libzkp_tpu_torch.models.bulletproofs_backend import BulletproofsBackend as TBackend
from libzkp_tpu_torch.models.schemes import dispatch, improvement_proof, range_proof
from libzkp_tpu_torch.utils import performance, serialization
from libzkp_tpu_torch.utils.encoding import u64_le
from libzkp_tpu_torch.utils.envelope import Proof
from libzkp_tpu_torch.utils.errors import ProofGenerationFailed

PROVERS = {
    "prove_range", "prove_equality", "prove_threshold", "prove_membership", "prove_improvement",
    "prove_consistency", "benchmark_proof_generation_numeric", "benchmark_proof_generation",
    "prove_range_cached", "prove_equality_advanced", "prove_threshold_optimized", "process_batch",
}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the suite runs in several worker processes at
    once, and OpenMP pools oversubscribing the cores stall each other."""
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


@pytest.fixture(scope="module")
def keys():
    """The JAX package's equality and membership keys, and the port's setups
    holding their conversions (a fresh state afterwards)."""
    jeq, jmem = jsb._get_equality_setup(), jsb._get_membership_setup()
    tsb._reset_for_tests()
    tsb._equality_setup = convert.proving_key(jeq)
    tsb._membership_setup = convert.proving_key(jmem)
    yield jeq, jmem
    tsb._reset_for_tests()


@pytest.fixture
def jax_keys(keys):
    """The JAX package's setups pinned to ``keys`` for the test (another
    test in this worker may have reset them)."""
    saved = jsb._equality_setup, jsb._membership_setup
    jsb._equality_setup, jsb._membership_setup = keys
    try:
        yield
    finally:
        jsb._equality_setup, jsb._membership_setup = saved


@pytest.fixture(scope="module")
def envelopes(keys):
    """JAX envelopes, one of each kind with its public inputs, made under
    ``keys``."""
    saved = jsb._equality_setup, jsb._membership_setup
    jsb._equality_setup, jsb._membership_setup = keys
    try:
        with pytest.MonkeyPatch.context() as m:
            # the JAX batch prover on its native tier (its device route is slow on the CPU)
            m.setattr(jbulp, "_use_device_prover", lambda batch, n: False)
            return {
                "range": (japi.prove_range(10, 0, 20), (0, 20)),
                "equality": (japi.prove_equality(5, 5), (5, 5)),
                "threshold": (japi.prove_threshold([10, 20, 30], 50), (50,)),
                "membership": (japi.prove_membership(3, [1, 2, 3, 5]), ([1, 2, 3, 5],)),
                "improvement": (japi.prove_improvement(10, 20), (10,)),
                "consistency": (japi.prove_consistency([1, 2, 3]), ()),
            }
    finally:
        jsb._equality_setup, jsb._membership_setup = saved


def _tampered(env: bytes, where: int) -> bytes:
    bad = bytearray(env)
    bad[where] ^= 0x01
    return bytes(bad)


def _param_names(fn, kinds) -> list:
    return [p.name for p in inspect.signature(fn).parameters.values() if p.kind in kinds]


# -- the surface ---------------------------------------------------------------


def test_surface_has_the_reference_names_and_signatures():
    """The 49 names of the JAX package's ``api.__all__``, each exported by
    the package, callable, with the JAX function's positional parameters;
    every name that proves also takes a keyword-only ``device``."""
    assert len(api.__all__) == 49
    assert sorted(api.__all__) == sorted(japi.__all__)
    positional = (inspect.Parameter.POSITIONAL_ONLY, inspect.Parameter.POSITIONAL_OR_KEYWORD)
    for name in api.__all__:
        ours = getattr(zkp, name)
        assert callable(ours) and ours is getattr(api, name), name
        assert _param_names(ours, positional) == _param_names(getattr(japi, name), positional), name
        kw_only = _param_names(ours, (inspect.Parameter.KEYWORD_ONLY,))
        assert kw_only == (["device"] if name in PROVERS else []), name
    # the port's batch entry points stay beside them
    for name in ("prove_range_batch", "prove_equality_batch", "prove_membership_batch",
                 "prove_threshold_batch", "prove_consistency_batch", "prove_improvement_batch",
                 "mimc_hash_batch"):
        assert callable(getattr(zkp, name))


# -- composite proofs ------------------------------------------------------------


def test_composite_bytes_equal_the_jax_packages(envelopes):
    envs = [e for e, _ in envelopes.values()]
    metadata = {"issuer": b"acme", "v": b"\x01", "": b""}
    cases = [
        (zkp.create_composite_proof(envs), japi.create_composite_proof(envs)),
        (zkp.create_composite_proof([bytearray(envs[0])]), japi.create_composite_proof([envs[0]])),
        (zkp.create_proof_with_metadata(envs[2], metadata),
         japi.create_proof_with_metadata(envs[2], metadata)),
    ]
    for ours, theirs in cases:
        assert ours == theirs and ours[:4] == b"COMP"
        assert zkp.verify_composite_proof_integrity_only(theirs)
        assert japi.verify_composite_proof_integrity_only(ours)
    assert zkp.extract_proof_metadata(cases[2][1]) == japi.extract_proof_metadata(cases[2][0]) == metadata
    with pytest.raises(ValueError) as ours:
        zkp.create_composite_proof([])
    with pytest.raises(ValueError) as theirs:
        japi.create_composite_proof([])
    assert str(ours.value) == str(theirs.value)


def test_composite_of_six_kinds_verifies(envelopes):
    """The full check verifies every inner proof by its scheme; one
    tampered inner proof (its digest recomputed) fails it."""
    envs = [e for e, _ in envelopes.values()]
    comp = zkp.create_composite_proof(envs)
    assert zkp.verify_composite_proof(comp)
    bad = zkp.create_composite_proof(envs[:5] + [_tampered(envs[5], 60)])
    assert zkp.verify_composite_proof_integrity_only(bad)
    assert zkp.verify_composite_proof(bad) is False


@pytest.mark.parametrize("damage", ["trailing byte", "digest", "header", "truncated"])
def test_damaged_composite_raises_the_jax_class(envelopes, damage):
    comp = zkp.create_proof_with_metadata(envelopes["range"][0], {"k": b"v"})
    bad = {"trailing byte": comp + b"\x00", "digest": _tampered(comp, len(comp) - 1),
           "header": b"COMX" + comp[4:], "truncated": comp[:-40]}[damage]
    with pytest.raises(TypeError) as ours:
        zkp.verify_composite_proof(bad)
    with pytest.raises(TypeError) as theirs:
        japi.verify_composite_proof(bad)
    assert type(ours.value).__name__ == type(theirs.value).__name__ == "InvalidProofFormat"
    assert str(ours.value) == str(theirs.value)
    for fn in (zkp.verify_composite_proof_integrity_only, zkp.extract_proof_metadata):
        with pytest.raises(TypeError):
            fn(bad)


# -- proof info, chains, codecs, commitments --------------------------------------


def test_proof_info_and_chain_equal_the_jax_packages(envelopes):
    envs = [e for e, _ in envelopes.values()]
    for env in envs:
        assert zkp.get_proof_info(env) == japi.get_proof_info(env)
    chains = [[], envs, envs + [b"garbage"], [envs[0][:-1]], [bytearray(envs[1])]]
    for chain in chains:
        assert zkp.validate_proof_chain(chain) == japi.validate_proof_chain(chain)
    with pytest.raises(TypeError):
        zkp.get_proof_info(b"\x02\x01")


@pytest.mark.parametrize("values", [[], [0], [1, (1 << 64) - 1, 7], list(range(4096))])
def test_u64_vec_codec_equals_the_jax_packages(values):
    data = serialization.serialize_u64_vec(values)
    assert data == jser.serialize_u64_vec(values)
    assert serialization.deserialize_u64_vec(data) == values
    for bad in (data[:-1], data + b"\0", data[:3], (4097).to_bytes(4, "little")):
        with pytest.raises(RuntimeError) as ours:
            serialization.deserialize_u64_vec(bad)
        with pytest.raises(RuntimeError) as theirs:
            jser.deserialize_u64_vec(bad)
        assert str(ours.value) == str(theirs.value)


@pytest.mark.parametrize("op, params", [("prove", b"\x01\x02"), ("", b""), ("x" * 64, b"p"),
                                        ("x" * 65, b""), ("big", b"\0" * (256 * 1024 - 11))])
def test_backend_payload_codec_equals_the_jax_packages(op, params):
    data = serialization.create_backend_payload(op, params)
    assert data == jser.create_backend_payload(op, params)
    if data:
        assert serialization.parse_backend_payload(data) == jser.parse_backend_payload(data) == (op, params)
    for bad in (data + b"\0", data[:-1], b"\xff\xff\xff\xff"):
        with pytest.raises(RuntimeError) as ours:
            serialization.parse_backend_payload(bad)
        with pytest.raises(RuntimeError) as theirs:
            jser.parse_backend_payload(bad)
        assert str(ours.value) == str(theirs.value)


def test_snark_commit_value_equals_the_jax_packages(envelopes):
    for v in (0, 5, (1 << 64) - 1):
        assert zkp.snark_commit_value(v) == japi.snark_commit_value(v)
    env = envelopes["equality"][0]
    assert zkp.verify_equality_with_commitment(env, zkp.snark_commit_value(5))
    assert not zkp.verify_equality_with_commitment(env, zkp.snark_commit_value(6))


# -- verification of many proofs ----------------------------------------------------


def _mix(envelopes) -> list:
    """Every kind's envelope under its own label, tampered copies (payload,
    commitment and header bytes), each envelope under a wrong label, an
    unknown label, garbage and an empty proof."""
    kinds = list(envelopes)
    out = [(envelopes[k][0], k) for k in kinds]
    for k in kinds:
        env = envelopes[k][0]
        out += [(_tampered(env, len(env) // 2), k), (_tampered(env, len(env) - 3), k),
                (_tampered(env, 0), k)]
    out += [(envelopes[k][0], kinds[(i + 1) % 6]) for i, k in enumerate(kinds)]
    out += [(envelopes["range"][0], "nope"), (b"garbage", "range"), (b"", "equality")]
    return out


def test_verify_proofs_parallel_gives_the_jax_packages_flags(envelopes, jax_keys):
    mix = _mix(envelopes)
    flags = zkp.verify_proofs_parallel(mix)
    assert flags == japi.verify_proofs_parallel(mix)
    assert flags[:6] == [True] * 6 and sum(flags) == 6
    # one proof, and one proof of each kind alone, take the single path
    for pair in mix[:6] + mix[-3:]:
        assert zkp.verify_proofs_parallel([pair]) == jperf.verify_proofs_parallel([pair])
    assert zkp.verify_proofs_parallel([]) == []
    # a list of int bytes and bytearrays coerce as the reference's Vec<u8>
    assert zkp.verify_proofs_parallel([(list(mix[0][0]), "range"), (bytearray(mix[1][0]), "equality")]) == [
        True, True]


def test_dispatch_gives_the_jax_packages_verdicts(envelopes, jax_keys):
    for env, _ in _mix(envelopes):
        try:
            proof, jproof = Proof.from_bytes(env), JProof.from_bytes(env)
        except TypeError:
            continue
        assert dispatch.verify_proof_cryptographic(proof) == jdispatch.verify_proof_cryptographic(jproof)
    ok = [dispatch.verify_proof_cryptographic(Proof.from_bytes(e)) for e, _ in envelopes.values()]
    assert ok == [True] * 6
    v1 = Proof.from_bytes(envelopes["range"][0])
    assert dispatch.verify_proof_cryptographic(Proof(1, v1.scheme, v1.proof, v1.commitment)) is False
    assert dispatch.verify_proof_cryptographic(Proof.new(9, v1.proof, v1.commitment)) is False


# -- cache, metrics, benchmarks -------------------------------------------------------


def test_cache_metrics_and_cached_range_hit_path(monkeypatch, envelopes):
    """A miss proves (a recording stand-in for the scheme's prover, on the
    device asked for) and fills the cache; the hit returns the same bytes
    without proving; the metrics count both."""
    calls = []
    env = envelopes["range"][0]
    monkeypatch.setattr(range_proof, "prove_range",
                        lambda v, lo, hi, *, device=None: calls.append((v, lo, hi, device)) or env)
    zkp.clear_cache()
    assert zkp.get_cache_stats() == {"size": 0}
    before = zkp.get_performance_metrics()
    assert zkp.prove_range_cached(7, 0, 100, device="cpu") == env
    assert zkp.prove_range_cached(7, 0, 100, device="cpu") == env
    assert calls == [(7, 0, 100, "cpu")]
    assert zkp.get_cache_stats() == {"size": 1}
    m = zkp.get_performance_metrics()
    assert m["cache_hits"] == before["cache_hits"] + 1
    assert m["cache_misses"] == before["cache_misses"] + 1
    assert m["range_proof_count"] == before.get("range_proof_count", 0) + 1
    assert m["total_operations"] == before["total_operations"] + 1
    assert "avg_range_proof_time_ms" in m and 0 <= m["cache_hit_rate"] <= 1
    zkp.clear_cache()
    assert zkp.get_cache_stats() == {"size": 0}


def test_proof_cache_ttl_and_lfu_eviction(monkeypatch):
    cache = performance.ProofCache(max_size=2, ttl_seconds=10)
    clock = [0.0]
    monkeypatch.setattr(performance, "_now_ms", lambda: clock[0])
    cache.put("a", b"A")
    cache.put("b", b"B")
    assert cache.get("a") == b"A"  # a: 2 accesses, b: 1
    cache.put("c", b"C")           # evicts the least used, b
    assert (cache.get("b"), cache.get("a"), cache.size()) == (None, b"A", 2)
    clock[0] = 10_000.0
    assert cache.get("a") is None and cache.size() == 1
    key = performance.generate_cache_key("range_proof", b"1:0:2")
    assert key.startswith("range_proof:") and len(key) == len("range_proof:") + 64
    assert key != jperf.generate_cache_key("range_proof", b"1:0:2")  # per-process salt


def test_benchmark_on_improvement():
    out = zkp.benchmark_proof_generation_numeric("improvement", 2, device="cpu")
    assert out["iterations"] == out["successful_iterations"] == 2.0
    assert out["success_rate"] == 100.0 and out["proofs_per_second"] > 0
    assert set(out) == set(japi.benchmark_proof_generation_numeric("improvement", 1))
    text = zkp.benchmark_proof_generation("improvement", 1, device="cpu")
    assert text["proof_type"] == "improvement" and float(text["successful_iterations"]) == 1.0
    assert zkp.get_performance_metrics()["improvement_proof_count"] >= 3
    for fn in (zkp.benchmark_proof_generation_numeric, japi.benchmark_proof_generation_numeric):
        with pytest.raises(ValueError, match="unsupported proof type: nope"):
            fn("nope", 1)


def test_benchmark_counts_library_errors_and_propagates_the_rest(monkeypatch):
    """A ``ZkpError`` of the library is a failed iteration; a
    ``RuntimeError`` (a CUDA error, a failed kernel build or launch)
    propagates."""
    real = improvement_proof.prove_improvement
    outcomes = iter([ProofGenerationFailed("no proof"), None])

    def flaky(old, new, *, device=None):
        err = next(outcomes)
        if err is not None:
            raise err
        return real(old, new, device=device)

    monkeypatch.setattr(improvement_proof, "prove_improvement", flaky)
    out = zkp.benchmark_proof_generation_numeric("improvement", 2, device="cpu")
    assert (out["successful_iterations"], out["success_rate"]) == (1.0, 50.0)

    def broken(old, new, *, device=None):
        raise RuntimeError("CUDA error: an illegal memory access was encountered")

    monkeypatch.setattr(improvement_proof, "prove_improvement", broken)
    with pytest.raises(RuntimeError, match="illegal memory access"):
        zkp.benchmark_proof_generation_numeric("improvement", 3, device="cpu")
    monkeypatch.setattr(improvement_proof, "prove_improvement",
                        lambda o, n, *, device=None: (_ for _ in ()).throw(ProofGenerationFailed("x")))
    with pytest.raises(ValueError, match="no successful proof generations"):
        zkp.benchmark_proof_generation_numeric("improvement", 2, device="cpu")


def test_snark_setup_state(envelopes):
    assert zkp.is_snark_setup_initialized()
    with pytest.raises(TypeError):  # a setup exists: the key directory is fixed
        zkp.set_snark_key_dir("/nonexistent-key-dir")


# -- the Bulletproofs backend's raw trait ------------------------------------------------


@pytest.mark.parametrize("data", [b"", b"\x01" * 7, b"\x01" * 9, b"\x00" * 16])
def test_trait_prove_refuses_bad_lengths(data):
    assert TBackend.prove(data, device="cpu") == b""
    assert JBackend.prove(data) == b""


def test_trait_verify_on_a_jax_trait_proof():
    proof = JBackend.prove(u64_le(123456789))
    assert len(proof) > 32
    assert TBackend.verify(proof) and TBackend.verify(proof, b"ignored")
    for bad in (_tampered(proof, 40), _tampered(proof, len(proof) - 1), proof[:-1], proof[:31], b""):
        assert TBackend.verify(bad) is False
        assert JBackend.verify(bad) is False
