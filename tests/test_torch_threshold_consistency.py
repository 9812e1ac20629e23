"""The port's threshold (scheme 3) and consistency (scheme 6) proofs against
the JAX package's.

Under one seeded stand-in for ``os.urandom`` (it feeds the blindings and the
prover draws of both packages alike) the port proves byte-identical
envelopes: threshold proofs at 64 bits (a batch of one on the device prover,
padded to 8 lanes) and at 8 bits (the lockstep host prover), consistency of
3 values reaching 2^64 - 1, the batch variants, and a ``prove_single_batch``
mixing transcript labels and widths. Each package's verifier accepts the
other's proofs; a flipped byte gives ``False`` without raising; bad inputs
raise the reference's classes and messages.
"""

from __future__ import annotations

import hashlib
import os

import pytest
import torch

from libzkp_tpu.models import bulletproofs as jbulp
from libzkp_tpu.models.bulletproofs_backend import BulletproofsBackend as JBackend
from libzkp_tpu.models.schemes import consistency_proof as jcp
from libzkp_tpu.models.schemes import threshold_proof as jtp
from libzkp_tpu.models.strobe import Transcript as JTranscript
from libzkp_tpu_torch import prove_threshold_optimized
from libzkp_tpu_torch.models import bulletproofs as bp
from libzkp_tpu_torch.models.bulletproofs_backend import BulletproofsBackend as TBackend
from libzkp_tpu_torch.models.schemes import consistency_proof as tcp
from libzkp_tpu_torch.models.schemes import threshold_proof as ttp
from libzkp_tpu_torch.models.strobe import Transcript
from libzkp_tpu_torch.utils.errors import InvalidInput

U64_MAX = (1 << 64) - 1
CPU = "cpu"


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the suite runs in several worker processes at
    once, and OpenMP pools oversubscribing the cores stall each other."""
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


@pytest.fixture(autouse=True)
def _jax_host_prover(monkeypatch):
    """The JAX package's batch prover on its native tier (the same bytes as
    its device route, which is slow under the CPU backend)."""
    monkeypatch.setattr(jbulp, "_use_device_prover", lambda batch, n: False)


class _Stream:
    """A stand-in for ``os.urandom``: consecutive slices of ``data``, or of
    one SHAKE stream of ``seed``, so the bytes a caller gets do not depend
    on how it splits its draws."""

    def __init__(self, seed: bytes = b"", data: bytes = None):
        self.buf = hashlib.shake_256(seed).digest(1 << 20) if data is None else data
        self.pos = 0

    def __call__(self, n: int) -> bytes:
        out = self.buf[self.pos : self.pos + n]
        self.pos += n
        assert len(out) == n, "stream exhausted"
        return out


def _seeded(monkeypatch, seed: bytes, fn, *args, **kw):
    with monkeypatch.context() as m:
        m.setattr(os, "urandom", _Stream(seed))
        return fn(*args, **kw)


@pytest.mark.parametrize("n_bits", [64, 8])
def test_threshold_envelope_parity(monkeypatch, n_bits):
    """At 64 bits a batch of one (device prover, lane 0 cloned to 8 lanes);
    at 8 bits the lockstep host prover."""
    values, threshold = [10, 20, 30, 40], 50 if n_bits == 64 else 90
    seed = b"threshold-%d" % n_bits
    if n_bits == 64:
        got = _seeded(monkeypatch, seed, prove_threshold_optimized, values, threshold, device=CPU)
        want = _seeded(monkeypatch, seed, jtp.prove_threshold, values, threshold)
    else:
        got = _seeded(monkeypatch, seed, ttp.prove_threshold_with_bits, values, threshold, 8, device=CPU)
        want = _seeded(monkeypatch, seed, jtp.prove_threshold_with_bits, values, threshold, 8)
    assert got[:2] == bytes([2, 3])  # envelope v2, scheme 3
    assert got == want
    assert ttp.verify_threshold(want, threshold) and jtp.verify_threshold(got, threshold)
    assert not ttp.verify_threshold(got, threshold + 1)
    for where in (12, len(got) // 2, -40, -5):
        bad = bytearray(got)
        bad[where] ^= 0x01
        assert ttp.verify_threshold(bytes(bad), threshold) is False
        assert jtp.verify_threshold(bytes(bad), threshold) is False


def test_consistency_envelope_parity_to_u64_max(monkeypatch):
    data = [5, 1000, U64_MAX]  # steps 995 and 2^64 - 1001
    got = _seeded(monkeypatch, b"consistency", tcp.prove_consistency, data, device=CPU)
    want = _seeded(monkeypatch, b"consistency", jcp.prove_consistency, data)
    assert got[:2] == bytes([2, 6])
    assert got == want
    assert tcp.verify_consistency(want) and jcp.verify_consistency(got)
    for where in (12, 100, len(got) // 2, -40, -5):
        bad = bytearray(got)
        bad[where] ^= 0x01
        assert tcp.verify_consistency(bytes(bad)) is False
        assert jcp.verify_consistency(bytes(bad)) is False


PER64 = (2 * 64 + 4) * 64  # prover draw bytes of one 64-bit instance


def _batch_and_singles(monkeypatch, seed, batch_fn, items, single_fn, n_values):
    """The port's batch of ``items`` under ``seed``, and the JAX package's
    single proofs of them fed the draws the batch took. The batch drew every
    proof's 32-byte blindings (``n_values(item)`` of them), then one prover
    block per instance (one fewer than the blindings for consistency, one
    for threshold); a single proof draws its blindings, then its blocks."""
    stream = _Stream(seed)
    with monkeypatch.context() as m:
        m.setattr(os, "urandom", stream)
        got = batch_fn(items, device=CPU)
    blinds = [32 * n_values(item) for item in items]
    blocks = [max(1, n_values(item) - 1) * PER64 for item in items]
    used = stream.buf[: stream.pos]
    assert len(used) == sum(blinds) + sum(blocks)
    b_pos, d_pos, want = 0, sum(blinds), []
    for item, nb, nd in zip(items, blinds, blocks):
        feed = _Stream(data=used[b_pos : b_pos + nb] + used[d_pos : d_pos + nd])
        b_pos, d_pos = b_pos + nb, d_pos + nd
        with monkeypatch.context() as m:
            m.setattr(os, "urandom", feed)
            want.append(single_fn(item))
        assert feed.pos == len(feed.buf)
    return got, want


def test_threshold_batch_equals_singles(monkeypatch):
    pairs = [([7, 8, 9], 20), ([U64_MAX - 3, 3], 1)]
    got, want = _batch_and_singles(monkeypatch, b"threshold-batch", ttp.prove_threshold_batch, pairs,
                                   lambda p: jtp.prove_threshold(*p), lambda p: 1)
    assert got == want
    assert got == _seeded(monkeypatch, b"threshold-batch", jtp.prove_threshold_batch, pairs)
    for env, (_, threshold) in zip(got, pairs):
        assert ttp.verify_threshold(env, threshold)


def test_consistency_batch_equals_singles(monkeypatch):
    datas = [[1, 2, 3], [4, 4]]
    got, want = _batch_and_singles(monkeypatch, b"consistency-batch", tcp.prove_consistency_batch, datas,
                                   jcp.prove_consistency, len)
    assert got == want
    assert got == _seeded(monkeypatch, b"consistency-batch", jcp.prove_consistency_batch, datas)
    assert all(tcp.verify_consistency(e) for e in got)


def test_mixed_labels_and_widths_in_one_batch(monkeypatch):
    """Threshold and range_min labels (16 bytes) share a STROBE position,
    consistency's (18 bytes) does not: two device groups, and one 8-bit
    lane on the lockstep host prover."""
    spec = [(b"libzkp_threshold", 77, 64), (b"libzkp_consistency", 5, 64),
            (b"libzkp_range_min", U64_MAX, 64), (b"libzkp_threshold", 200, 8)]

    def insts(T):
        return [(T(label), value, 1000 + i, n) for i, (label, value, n) in enumerate(spec)]

    got = _seeded(monkeypatch, b"mixed", bp.prove_single_batch, insts(Transcript), device=CPU)
    want = _seeded(monkeypatch, b"mixed", jbulp.prove_single_batch, insts(JTranscript))
    for (rp, V), (jrp, jV), (label, _, n) in zip(got, want, spec):
        assert rp.to_bytes() == jrp.to_bytes() and V == jV
        assert bp.verify_single(rp, Transcript(label), V, n)
        assert jbulp.verify_single(jbulp.RangeProof.from_bytes(rp.to_bytes()), JTranscript(label), V, n)


def _same_error(port_call, jax_call):
    """Both calls raise: the same class name (each package's own class) and
    the same message."""
    with pytest.raises(Exception) as got:
        port_call()
    with pytest.raises(Exception) as want:
        jax_call()
    assert type(got.value).__name__ == type(want.value).__name__
    assert str(got.value) == str(want.value)
    return got.value


@pytest.mark.parametrize("values, threshold", [([], 5), ([1, 2], 10), ([U64_MAX, 1], 1)])
def test_threshold_errors_match_reference(values, threshold):
    err = _same_error(lambda: ttp.prove_threshold(values, threshold, device=CPU),
                      lambda: jtp.prove_threshold(values, threshold))
    assert isinstance(err, InvalidInput)


@pytest.mark.parametrize("values, threshold, n_bits", [
    ([], 5, 64), ([1, 2], 10, 64), ([U64_MAX, 1], 1, 64), ([300], 1, 8)])
def test_threshold_backend_errors_match_reference(values, threshold, n_bits):
    with pytest.raises(ValueError) as want:
        JBackend.prepare_threshold_bits(values, threshold, n_bits)
    with pytest.raises(ValueError) as got:
        TBackend.prepare_threshold_bits(values, threshold, n_bits)
    assert str(got.value) == str(want.value)


@pytest.mark.parametrize("data, cls", [([], InvalidInput), ([3, 2], InvalidInput),
                                       ([1, U64_MAX + 1], OverflowError)])
def test_consistency_errors_match_reference(data, cls):
    err = _same_error(lambda: tcp.prove_consistency(data, device=CPU), lambda: jcp.prove_consistency(data))
    assert isinstance(err, cls)


@pytest.mark.parametrize("data", [[], [3, 2]])
def test_consistency_backend_errors_match_reference(data):
    with pytest.raises(ValueError) as want:
        JBackend.prepare_consistency(data)
    with pytest.raises(ValueError) as got:
        TBackend.prepare_consistency(data, device=CPU)
    assert str(got.value) == str(want.value)  # "data cannot be empty", "data inconsistent"


@pytest.mark.parametrize("blob", [b"", b"\x00", b"\x02\x03" + b"\x00" * 60, b"\x02\x06" + b"\xff" * 80])
def test_malformed_inputs_to_verify(blob):
    assert ttp.verify_threshold(blob, 5) is False
    assert tcp.verify_consistency(blob) is False
