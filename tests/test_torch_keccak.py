"""The port's batched Keccak/STROBE/Merlin transcript against the JAX
package's device transcript and the host wire model, byte for byte, on the
four cases of ``tests/test_keccak_device.py``."""

from __future__ import annotations

import random

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from libzkp_tpu.models.strobe import Transcript
from libzkp_tpu.ops import keccak_device as jkd
from libzkp_tpu.ops.keccak import keccak_f1600_bytes_py
from libzkp_tpu_torch import convert
from libzkp_tpu_torch.models import strobe as tstrobe
from libzkp_tpu_torch.ops import keccak_device as kd

B = 16
DEV = "cpu"


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the suite runs in several worker processes at
    once, and OpenMP pools oversubscribing the cores stall each other."""
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _to_dev(data: bytes):
    """Per-lane distinct data: lane b gets data rotated by b. -> (L, B)."""
    arr = np.zeros((len(data), B), dtype=np.int32)
    for b in range(B):
        arr[:, b] = np.frombuffer(bytes((x + b) & 0xFF for x in data), dtype=np.uint8)
    return arr


def _chal_bytes(t: torch.Tensor, lane: int) -> bytes:
    return bytes(t[:, lane].numpy().astype(np.uint8).tolist())


def test_keccak_permutation_matches_host_and_jax():
    rng = np.random.default_rng(3)
    raws = [rng.integers(0, 256, 200, dtype=np.uint8).tobytes() for _ in range(B)]
    state = torch.from_numpy(np.stack([np.frombuffer(r, dtype="<i8") for r in raws], axis=1).copy())
    out = kd.keccak_f1600_device(state)
    for lane in (0, 5, 15):
        want = bytearray(raws[lane])
        keccak_f1600_bytes_py(want)
        assert out[:, lane].numpy().astype("<i8").tobytes() == bytes(want)
    # the JAX permutation on its (hi, lo) uint32 words, carried across
    words = np.stack([np.frombuffer(r, dtype="<u4") for r in raws], axis=1)  # (50, B)
    jout = jkd.keccak_f1600_device([jnp.asarray(w) for w in words])
    np.testing.assert_array_equal(convert.strobe_words(jout, device=DEV).numpy(), out.numpy())


def test_strobe_lane_constant_ops_match_host():
    hd = kd.StrobeDevice(b"test proto", B, device=DEV)
    hh = tstrobe.Strobe128(b"test proto")
    jd = jkd.StrobeDevice(b"test proto", B)
    for s in (hd, hh, jd):
        s.meta_ad(b"hello", False)
        s.ad(b"world" * 40, False)  # crosses the rate boundary
    assert hd.state_bytes(0) == bytes(hh.state)
    np.testing.assert_array_equal(convert.strobe_words(jd.state, device=DEV).numpy(), hd.state.numpy())
    dev = hd.prf(32)
    assert _chal_bytes(dev, 0) == hh.prf(32, False)
    np.testing.assert_array_equal(dev.numpy(), np.asarray(jd.prf(32)).astype(np.int32))
    assert hd.state_bytes(3) == bytes(hh.state)


def test_strobe_per_lane_data_diverges_and_matches():
    data = bytes(range(48))
    hd = kd.TranscriptDevice(b"proto", B, device=DEV)
    hd.append_message(b"m", torch.from_numpy(_to_dev(data)))
    ch_dev = hd.challenge_bytes(b"c", 64)
    jd = jkd.TranscriptDevice(b"proto", B)
    jd.append_message(b"m", jnp.asarray(_to_dev(data).astype(np.uint32)))
    np.testing.assert_array_equal(ch_dev.numpy(), np.asarray(jd.challenge_bytes(b"c", 64)).astype(np.int32))
    for lane in (0, 1, 7, 15):
        hh = Transcript(b"proto")
        hh.append_message(b"m", bytes((x + lane) & 0xFF for x in data))
        assert _chal_bytes(ch_dev, lane) == hh.challenge_bytes(b"c", 64), f"lane {lane}"


def test_transcript_schedule_rangeproof_prefix_resumed_from_snapshots():
    """The first bulletproofs transcript ops, resumed on the device from host
    snapshots (as the prover resumes them), match the host Transcript."""
    label = b"libzkp_range_min"
    hosts = [tstrobe.Transcript(label) for _ in range(B)]
    hd = convert.transcript_state([t.strobe.state_bytes() for t in hosts], device=DEV)
    V = random.Random(8).randbytes(32)
    (c_dev,) = hd.run_phase([
        ("msg", b"dom-sep", b"rangeproof v1"),
        ("msg", b"n", (64).to_bytes(8, "little")),
        ("msg", b"m", (1).to_bytes(8, "little")),
        ("msg", b"V", torch.from_numpy(_to_dev(V))),
        ("chal", b"y", 64),
    ])
    for lane in (0, 5):
        t2 = Transcript(label)
        t2.append_message(b"dom-sep", b"rangeproof v1")
        t2.append_u64(b"n", 64)
        t2.append_u64(b"m", 1)
        t2.append_message(b"V", bytes((x + lane) & 0xFF for x in V))
        assert _chal_bytes(c_dev, lane) == t2.challenge_bytes(b"y", 64)
        assert hd.strobe.state_bytes(lane) == bytes(t2.strobe.state)
