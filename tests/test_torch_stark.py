"""The port's STARK backend and improvement proofs (scheme 5) against the JAX
package, on the CPU.

* f128: the field, its roots of unity; ``mont_mul_plain`` at 11 limbs equal
  to the JAX ``get_context(F128).mont_mul``, limb for limb.
* The card route's device program (``ops/stark_device.py``) on its plain
  versions: ``canon_f128_device`` on the hazard values, ``limbs_to_u32_words``
  and the torch BLAKE3 compress equal to the JAX functions exactly;
  ``coset_lde_commit_batch`` equal to the JAX one's polys, LDEs, leaf digests
  and every intermediate limb at B = 3, and to the host ``interpolate``,
  ``evaluate_coset`` and ``hash_element_rows``.
* The native hooks (BLAKE3, its batch and Merkle levels, the NTT) equal to
  their goldens and to the JAX package's native tier.
* ``prove_improvement_batch(device="cpu")``: envelopes byte-identical to the
  JAX ``prove_improvement``, to the native baseline, and verified by both
  packages both ways; the container read by ``tests/wf_parser2.py``; a trace
  long enough to commit a FRI layer proved byte for byte like the JAX
  package's.
* The cases of ``tests/test_stark.py``, ported: tamper, wrong options,
  equal and decreasing values, the raw trait's bad lengths; the native
  verifier's verdicts equal the Python verifier's on every tampered and
  truncated proof.

Tolerance: every comparison is exact (limbs, ints, bytes, verdicts).
"""

from __future__ import annotations

import os
import random
import sys

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from libzkp_tpu import native as jnative
from libzkp_tpu.models import stark as jstark
from libzkp_tpu.models import stark_backend as jsb
from libzkp_tpu.models.schemes import improvement_proof as jip
from libzkp_tpu.ops import blake3_device as jb3d
from libzkp_tpu.ops import stark_device as jsd
from libzkp_tpu.ops.field import F128 as JF128
from libzkp_tpu.ops.limb import get_context as jget_context

import libzkp_tpu_torch as zkp
from libzkp_tpu_torch import native
from libzkp_tpu_torch.models import merkle, stark, stark_backend as sb
from libzkp_tpu_torch.models import winterfell_wire as ww
from libzkp_tpu_torch.ops import blake3, blake3_device, kernels, ntt, stark_device as sd
from libzkp_tpu_torch.ops.field import BN254_FR, F128, F128_TWO_ADIC_ROOT
from libzkp_tpu_torch.ops.limb import get_context
from libzkp_tpu_torch.utils.envelope import Proof
from libzkp_tpu_torch.utils.errors import InvalidInput

sys.path.insert(0, os.path.dirname(__file__))
import wf_parser2  # noqa: E402

P = F128.p
PAIRS = [(30, 50), (1, 8), (0, 1), (2**32, 2**40), (0, 2**64 - 1)]


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


@pytest.fixture(scope="module")
def envelopes():
    """The port's CPU route over PAIRS, and the JAX package's proofs."""
    return (zkp.prove_improvement_batch(PAIRS, device="cpu"),
            [jip.prove_improvement(o, n) for o, n in PAIRS])


def _stark_bytes(env: bytes) -> bytes:
    return bytes(Proof.from_bytes(env).proof[16:])


def _row_value(row) -> int:
    return sum(int(v) << (12 * i) for i, v in enumerate(row))


# ---------------------------------------------------------------------------
# the field and the product at 11 limbs
# ---------------------------------------------------------------------------


def test_f128_field_matches_reference():
    assert F128.p == JF128.p and F128.nbytes == 16 and F128.two_adicity == 40
    assert F128.root_of_unity(1 << 40) == F128_TWO_ADIC_ROOT
    for order in (2, 8, 64, 1 << 20):
        assert F128.root_of_unity(order) == JF128.root_of_unity(order)
    rng = random.Random(128)
    for _ in range(8):
        a, b = rng.randrange(P), rng.randrange(1, P)
        assert F128.div(a, b) == JF128.div(a, b) and F128.mul(F128.div(a, b), b) == a
        assert F128.pow(a, 77) == JF128.pow(a, 77)
        assert F128.to_le_bytes(a) == JF128.to_le_bytes(a)
    assert get_context(P).n == jget_context(P).n == 11


def test_mont_mul_plain_n11_matches_reference():
    """Relaxed limbs in [-4096, 4096) against the JAX product, b as full
    rows, broadcast twiddle rows and one row; the wrapper on CPU tensors
    takes the plain version."""
    ctx, jctx = get_context(P), jget_context(P)
    consts = ctx.tensor("consts", "cpu")
    assert tuple(consts.shape) == (3, 11)
    rng = np.random.default_rng(11)
    a = rng.integers(-4096, 4096, (4, 32, 11), dtype=np.int32)
    for b in (rng.integers(-4096, 4096, (4, 32, 11), dtype=np.int32),
              rng.integers(0, 4096, (32, 11), dtype=np.int32),
              rng.integers(0, 4096, (11,), dtype=np.int32)):
        want = np.asarray(jctx.mont_mul(jnp.asarray(a), jnp.asarray(b)))
        got = kernels.mont_mul_plain(consts, torch.from_numpy(a), torch.from_numpy(b))
        assert np.array_equal(got.numpy(), want)
        assert torch.equal(kernels.mont_mul(consts, torch.from_numpy(a), torch.from_numpy(b)), got)


def test_mont_mul_instances_by_limb_count():
    """One instance per limb count, and the rows a stage of a 256-proof
    batch at N = 64 gives the n = 11 instance."""
    assert kernels.MONT_NS == {22: None, 11: "n11"}
    assert "mont_mul_n11" in kernels.INSTANCES and "mont_mul" in kernels.INSTANCES
    rows = torch.empty((8, 11), dtype=torch.int32, device="meta")
    with pytest.raises(ValueError, match="CUDA or CPU"):
        kernels.mont_mul(torch.empty((3, 11), dtype=torch.int32, device="meta"), rows, rows)
    M, Mb = kernels.mont_rows(torch.zeros(256, 32, 11, dtype=torch.int32),
                              torch.zeros(32, 11, dtype=torch.int32), 11)
    assert (M, Mb) == (8192, 32)


# ---------------------------------------------------------------------------
# the device program's parts
# ---------------------------------------------------------------------------


def _hazard_rows() -> np.ndarray:
    """Relaxed f128 limb rows at the canonicalisation's hazards: p - 1, p,
    2p - 1, -p + 1 (negated limbs), 2^128 - 1 and other runs of 0xFFF limbs,
    0, 1, and random values in (-p, 2p) with unreduced limbs."""
    def limbs(v):
        return [(v >> (12 * i)) & 0xFFF for i in range(11)]

    rows = [limbs(v) for v in (P - 1, P, 2 * P - 1, (1 << 128) - 1, (1 << 120) - 1,
                               P + (1 << 40) - 1, 2 * P - 2, 0, 1)]
    rows.append([-x for x in limbs(P - 1)])           # -p + 1
    rows.append([-x for x in limbs((1 << 120) - 1)])  # a run of -0xFFF limbs
    rows.append([4095] * 10 + [255])                  # 2^128 - 1 again, as its limbs
    rows.append([8191] * 10 + [0])                    # unreduced limbs below bit 120
    rng = np.random.default_rng(128)
    for _ in range(20):  # a value in (-p, 2p) spread over limbs in (-2^13, 2^13)
        v = int.from_bytes(rng.bytes(17), "little") % (3 * P) - P
        r = limbs(v % (1 << 132)) if v >= 0 else [-x for x in limbs(-v)]
        k = int(rng.integers(0, 10))
        r[k] += 4096
        r[k + 1] -= 1
        rows.append(r)
    return np.asarray(rows, dtype=np.int32)


def test_canon_f128_device_matches_reference_on_hazards():
    ctx, jctx = get_context(P), jget_context(P)
    x = _hazard_rows()
    # also their round trip through the Montgomery domain (relaxed outputs)
    x_rel = ctx.from_mont(ctx.to_mont(torch.from_numpy(x))).numpy()
    for rows in (x, x_rel):
        want = np.asarray(jsd.canon_f128_device(jctx, jnp.asarray(rows)))
        got = sd.canon_f128_device(ctx, torch.from_numpy(rows)).numpy()
        assert np.array_equal(got, want)
        assert got.min() >= 0 and got.max() < 4096
        for row, g in zip(rows, got):
            assert _row_value(g) == _row_value(row) % P


def test_limbs_to_u32_words_matches_reference():
    ctx, jctx = get_context(P), jget_context(P)
    rng = np.random.default_rng(32)
    vals = [int.from_bytes(rng.bytes(16), "little") % P for _ in range(30)] + [0, P - 1]
    x = ctx.encode(vals)
    got = sd.limbs_to_u32_words(x, 16).numpy()
    want = np.asarray(jsd.limbs_to_u32_words(jnp.asarray(x.numpy()), 16))
    assert got.dtype == np.int64 and np.array_equal(got, want.astype(np.int64))
    for v, w in zip(vals, got):
        assert w.astype("<u4").tobytes() == v.to_bytes(16, "little")


def test_blake3_compress_matches_golden_and_reference():
    """hash_blocks of 16-byte leaves (and other one-block lengths) against
    blake3_256_py; compress_vec against the JAX _compress_vec on random
    chaining values, words, counter and flags."""
    rng = np.random.default_rng(3)
    for length in (16, 0, 1, 33, 64):
        msgs = [rng.bytes(length) for _ in range(9)]
        buf = np.zeros((9, 64), dtype=np.uint8)
        for i, msg in enumerate(msgs):
            buf[i, :length] = np.frombuffer(msg, dtype=np.uint8)
        m = torch.from_numpy(buf.view("<u4").astype(np.int64))
        got = blake3_device.hash_blocks(m, length).numpy().astype("<u4")
        assert [row.tobytes() for row in got] == [blake3.blake3_256_py(msg) for msg in msgs]
    cv = rng.integers(0, 1 << 32, (16, 8), dtype=np.uint64).astype(np.uint32)
    m = rng.integers(0, 1 << 32, (16, 16), dtype=np.uint64).astype(np.uint32)
    for counter, block_len, flags in ((0, 16, 11), ((1 << 40) + 7, 64, 4)):
        want = np.asarray(jb3d._compress_vec(jnp.asarray(cv), jnp.asarray(m), counter, block_len, flags))
        got = blake3_device.compress_vec(torch.from_numpy(cv.astype(np.int64)),
                                         torch.from_numpy(m.astype(np.int64)), counter, block_len, flags)
        assert np.array_equal(got.numpy(), want.astype(np.int64))


def test_coset_lde_commit_batch_matches_reference(monkeypatch):
    """B = 3 traces: the port's batch against the JAX one's polys, LDEs and
    leaf digests, the JAX program's limbs (its first 3 of 16 padded rows)
    against the port's, and both against the host tier."""
    rng = np.random.default_rng(9)
    traces = [[int.from_bytes(rng.bytes(16), "little") % P for _ in range(8)] for _ in range(3)]
    captured = []
    program = jsd._lde_commit_jitted

    def capture(*args):
        run = program(*args)
        return lambda x: captured.append((x, run(x))) or captured[-1][1]

    monkeypatch.setattr(jsd, "_lde_commit_jitted", capture)
    want = jsd.coset_lde_commit_batch(P, traces, 8, stark.DOMAIN_OFFSET)
    got = sd.coset_lde_commit_batch(P, traces, 8, stark.DOMAIN_OFFSET, device="cpu")
    assert got == want
    (x_in, outs), = captured
    mine = sd.lde_commit_device(get_context(P), torch.from_numpy(np.asarray(x_in)[:3].copy()), 8,
                                stark.DOMAIN_OFFSET)
    for j, m in zip(outs, mine):
        j = np.asarray(j).astype(np.int64)
        assert np.array_equal(m.numpy().astype(np.int64).reshape(3, -1), j.reshape(16, -1)[:3])
    polys, ldes, leaves = got
    for t, c, lde, lv in zip(traces, polys, ldes, leaves):
        assert c == ntt.interpolate(F128, t) == ntt.ntt_py(F128, t, invert=True)
        assert lde == ntt.evaluate_coset(F128, c, 64, stark.DOMAIN_OFFSET)
        assert lv == merkle.hash_element_rows(F128, [[v] for v in lde])


def test_coset_lde_batch_matches_host():
    rng = random.Random(5)
    traces = [[rng.randrange(P) for _ in range(8)] for _ in range(4)]
    polys, ldes = ntt.coset_lde_batch(P, traces, 8, 3, device="cpu")
    for t, c, lde in zip(traces, polys, ldes):
        assert c == ntt.interpolate(F128, t)
        assert lde == ntt.evaluate_coset(F128, c, 64, 3)


# ---------------------------------------------------------------------------
# the native hooks
# ---------------------------------------------------------------------------


def test_native_blake3_matches_golden_and_reference():
    rng = random.Random(33)
    for length in (0, 1, 16, 63, 64, 65, 1023, 1024, 1025, 4097):
        data = rng.randbytes(length)
        assert native.blake3_256(data) == blake3.blake3_256_py(data) == jnative.blake3_256(data)
        assert blake3.blake3_256(data) == blake3.blake3_256_py(data)
    left, right = rng.randbytes(32), rng.randbytes(32)
    assert blake3.merge_digests(left, right) == blake3.merge_digests_py(left, right)
    leaves = [rng.randbytes(32) for _ in range(64)]
    assert native.blake3_batch(leaves, 32) == [blake3.blake3_256_py(x) for x in leaves]
    assert native.blake3_batch(leaves, 32) == jnative.blake3_batch(leaves, 32)
    levels = native.blake3_merkle_levels(leaves)
    assert levels == jnative.blake3_merkle_levels(leaves)
    cur = leaves
    for level in levels:
        cur = [blake3.merge_digests_py(cur[i], cur[i + 1]) for i in range(0, len(cur), 2)]
        assert level == cur
    assert len(levels) == 6 and native.blake3_merkle_levels(leaves[:1]) == []
    with pytest.raises(ValueError):
        native.blake3_merkle_levels(leaves[:3])
    with pytest.raises(ValueError):
        native.blake3_batch([b"ab", b"c"], 2)


def test_native_ntt_matches_golden_and_reference():
    rng = random.Random(64)
    for F in (F128, BN254_FR):
        for n in (1, 2, 8, 64, 512):
            vals = [rng.randrange(F.p) for _ in range(n)]
            assert ntt.ntt(F, vals) == ntt.ntt_py(F, vals)
            assert ntt.ntt(F, vals, invert=True) == ntt.ntt_py(F, vals, invert=True)
            assert ntt.ntt(F, ntt.ntt(F, vals), invert=True) == vals
            root = F.root_of_unity(n)
            assert native.ntt(F.p, vals, root, None) == jnative.ntt(F.p, vals, root, None)


# ---------------------------------------------------------------------------
# proofs: parity, the baseline, cross-package verification
# ---------------------------------------------------------------------------


def test_prove_improvement_batch_matches_reference(envelopes):
    ours, theirs = envelopes
    assert ours == theirs
    assert [_stark_bytes(e) for e in ours] == sb._prove_native(PAIRS)
    assert [_stark_bytes(zkp.prove_improvement(o, n, device="cpu")) for o, n in PAIRS[:2]] == \
        [_stark_bytes(e) for e in ours[:2]]
    assert zkp.prove_improvement_batch([], device="cpu") == []


def test_both_packages_verify_each_others_proofs(envelopes):
    ours, theirs = envelopes
    for env_o, env_t, (old, new) in zip(ours, theirs, PAIRS):
        assert zkp.verify_improvement(env_t, old) and jip.verify_improvement(env_o, old)
        assert not zkp.verify_improvement(env_t, old + 1)
        sp = _stark_bytes(env_o)
        assert sb.verify_improvement(sp, old, new) and sb.verify_improvement_py(sp, old, new)
        assert jsb.verify_improvement(sp, old, new)
        assert not sb.verify_improvement(sp, old, new + 1)
        assert not sb.verify_improvement_py(sp, old, new + 1)


def test_container_reads_with_the_second_parser(envelopes):
    for env in envelopes[0]:
        data = _stark_bytes(env)
        p2 = wf_parser2.parse(data)
        assert wf_parser2.serialize(p2) == data
        assert (p2.main_width, p2.trace_length, p2.num_queries, p2.blowup, p2.grinding) == (1, 8, 32, 8, 0)
        assert int.from_bytes(p2.modulus, "little") == P
        assert (p2.fri_folding, p2.fri_max_remainder, p2.fri_layers) == (8, 31, [])
        w, n, modulus, opts, pos = ww.read_context(data, 0)
        assert (w, n, modulus, opts) == (1, 8, P, (32, 8, 0, 8, 31))
        assert data[pos] == p2.num_unique_queries


class _CounterAir(stark.Air):
    """next = cur + 1 over one column (the JAX package's FRI test AIR)."""

    def __init__(self, trace_length: int, start: int):
        super().__init__(trace_length, 1, [start], stark.ProofOptions())
        self.start = start

    def transition_degrees(self):
        return [1]

    def evaluate_transition(self, current, nxt):
        return [(nxt[0] - current[0] - 1) % self.field.p]

    def get_assertions(self):
        return [(0, 0, self.start), (0, self.trace_length - 1, self.start + self.trace_length - 1)]


class _JCounterAir(jstark.Air):
    def __init__(self, trace_length: int, start: int):
        super().__init__(trace_length, 1, [start], jstark.ProofOptions())
        self.start = start

    transition_degrees = _CounterAir.transition_degrees
    evaluate_transition = _CounterAir.evaluate_transition
    get_assertions = _CounterAir.get_assertions


def test_fri_layer_proof_matches_reference():
    """A trace of 256 (LDE 2048): one committed FRI layer, which the
    improvement AIR never reaches; the same bytes as the JAX prover's, each
    package's verifier accepts them and rejects a tampered layer opening."""
    assert stark._fri_layer_plan(stark.ProofOptions(), 2048) == [2048]
    trace = [[(3 + i) % P for i in range(256)]]
    proof = stark.prove(_CounterAir(256, 3), trace)
    assert proof == jstark.prove(_JCounterAir(256, 3), trace)
    assert stark.verify(_CounterAir(256, 3), proof) and jstark.verify(_JCounterAir(256, 3), proof)
    assert not stark.verify(_CounterAir(256, 4), proof)
    bad = bytearray(proof)
    bad[len(proof) - 9] ^= 0xFF
    assert not stark.verify(_CounterAir(256, 3), bytes(bad))


# ---------------------------------------------------------------------------
# tests/test_stark.py, ported
# ---------------------------------------------------------------------------


def test_stark_backend_roundtrip_and_bad_lengths():
    data = (1).to_bytes(8, "little") + (8).to_bytes(8, "little")
    proof = sb.StarkBackend.prove(data, device="cpu")
    assert proof and sb.StarkBackend.verify(proof, data)
    assert proof == jsb.StarkBackend.prove(data)
    assert sb.StarkBackend.prove(b"short", device="cpu") == b""
    assert not sb.StarkBackend.verify(b"x", b"short")
    assert not sb.StarkBackend.verify(proof, data + b"\x00")
    backwards = (8).to_bytes(8, "little") + (1).to_bytes(8, "little")
    assert sb.StarkBackend.prove(backwards, device="cpu") == b""
    assert sb.StarkBackend.prove(data[:8] * 2, device="cpu") == b""


def test_improvement_envelope_fields(envelopes):
    env = Proof.from_bytes(envelopes[0][1])  # (1, 8)
    assert env.scheme == 5 and env.version == 2
    assert int.from_bytes(env.proof[0:8], "little") == 1
    assert int.from_bytes(env.proof[8:16], "little") == 8
    assert len(env.commitment) == 32


def test_improvement_rejects_equal_and_decreasing():
    for old, new in ((8, 8), (9, 8)):
        with pytest.raises(InvalidInput, match="new value must be greater than old value"):
            zkp.prove_improvement(old, new, device="cpu")
        with pytest.raises(InvalidInput, match="new value must be greater than old value"):
            zkp.prove_improvement_batch([(1, 8), (old, new)], device="cpu")
        with pytest.raises(ValueError, match="new value must be greater than old value"):
            sb.prove_improvement_batch([(old, new)], device="cpu")
        with pytest.raises(ValueError, match="new value must be greater than old value"):
            sb._prove_native([(old, new)])
    for old in (-1, 2**64):  # the reference's u64 conversion error
        with pytest.raises(OverflowError):
            zkp.prove_improvement(old, 2**64 + 1, device="cpu")
        with pytest.raises(OverflowError):
            jip.prove_improvement(old, 2**64 + 1)


def test_improvement_tamper_rejection(envelopes):
    env = envelopes[0][1]
    rng = random.Random(42)
    for _ in range(10):
        b = bytearray(env)
        b[rng.randrange(len(b))] ^= rng.randrange(1, 256)
        assert not zkp.verify_improvement(bytes(b), 1)
    assert not zkp.verify_improvement(env[:-1], 1)
    assert not zkp.verify_improvement(env + b"\x00", 1)
    assert not zkp.verify_improvement(b"", 1)


def test_improvement_wrong_options_rejected(monkeypatch):
    """A proof made under other options (AcceptableOptions) is rejected by
    both verifiers."""
    alt = stark.ProofOptions(num_queries=16, blowup=8, grinding=0, folding=8, max_remainder_degree=31)
    monkeypatch.setattr(sb, "DEFAULT_OPTIONS", alt)
    p_alt = zkp.prove_improvement(1, 8, device="cpu")
    sp = _stark_bytes(p_alt)
    monkeypatch.undo()
    assert sb.verify_improvement_py(sp, 1, 8) is False
    assert not zkp.verify_improvement(p_alt, 1)


def test_native_verifier_agrees_with_python_on_every_tamper(envelopes):
    """Every 7th byte flipped and every 97th prefix: the native verifier and
    the Python golden give the same verdict (False), and neither raises."""
    sp = _stark_bytes(envelopes[0][0])  # (30, 50)
    assert sb.verify_improvement(sp, 30, 50) and sb.verify_improvement_py(sp, 30, 50)
    for pos in range(0, len(sp), 7):
        b = bytearray(sp)
        b[pos] ^= 0xFF
        assert sb.verify_improvement(bytes(b), 30, 50) is False
        assert sb.verify_improvement_py(bytes(b), 30, 50) is False, f"byte {pos}"
    for cut in range(0, len(sp), 97):
        assert not sb.verify_improvement(sp[:cut], 30, 50)
        assert not sb.verify_improvement_py(sp[:cut], 30, 50)
    assert not sb.verify_improvement(sp, -1, 50) and not sb.verify_improvement(sp, 30, 2**64)


def test_vint64_and_batch_merkle_proof():
    for v in [0, 1, 127, 128, 16383, 16384, 2**21 - 1, 2**21, 2**55, 2**56, 2**63, 2**64 - 1]:
        buf = bytearray()
        ww.write_usize(buf, v)
        assert ww.read_usize(bytes(buf), 0) == (v, len(buf))
    rng = random.Random(3)
    leaves = [rng.randbytes(32) for _ in range(64)]
    tree = merkle.MerkleTree(leaves)
    positions = sorted(rng.sample(range(64), 9))
    blob = ww.batch_proof_nodes(tree, positions)
    lv = [leaves[q] for q in positions]
    assert ww.batch_proof_verify(tree.root, tree.depth, positions, lv, blob)
    for pos in range(len(blob)):
        b = bytearray(blob)
        b[pos] ^= 0xFF
        assert not ww.batch_proof_verify(tree.root, tree.depth, positions, lv, bytes(b))
    assert merkle.MerkleTree([leaves[0]]).root == leaves[0]
