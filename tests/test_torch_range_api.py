"""The port's range-proof scheme against the JAX package's: envelopes made by
one package verify in the other, tampering gives ``False`` without raising,
and bad inputs raise as in the reference."""

from __future__ import annotations

import pytest
import torch

from libzkp_tpu.models.schemes import range_proof as jrp
from libzkp_tpu_torch.models.schemes import range_proof as trp
from libzkp_tpu_torch.utils.errors import InvalidInput

TRIPLES = [(50, 0, 100), ((1 << 63) + 12345, 0, (1 << 64) - 1)]


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the suite runs in several worker processes at
    once, and OpenMP pools oversubscribing the cores stall each other."""
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


@pytest.fixture(scope="module")
def port_envelopes():
    """One single and one batched prove on the port's CPU path."""
    single = trp.prove_range(*TRIPLES[0], device="cpu")
    batch = trp.prove_range_batch(TRIPLES, device="cpu")
    return [single] + batch


def test_port_envelopes_verify_in_both_packages(port_envelopes):
    triples = [TRIPLES[0]] + TRIPLES
    assert len(port_envelopes) == 3
    for env, (_, lo, hi) in zip(port_envelopes, triples):
        assert env[:2] == bytes([2, 1])  # envelope v2, scheme 1
        assert jrp.verify_range(env, lo, hi)
        assert trp.verify_range(env, lo, hi)
        assert not trp.verify_range(env, lo + 1, hi)


def test_jax_envelope_verifies_in_port():
    env = jrp.prove_range(*TRIPLES[0])
    assert trp.verify_range(env, *TRIPLES[0][1:])


@pytest.mark.parametrize("where", [12, 300, 900, -40, -5])
def test_tampered_envelope_is_false_not_raised(port_envelopes, where):
    bad = bytearray(port_envelopes[0])
    bad[where] ^= 0x01
    assert trp.verify_range(bytes(bad), *TRIPLES[0][1:]) is False
    assert jrp.verify_range(bytes(bad), *TRIPLES[0][1:]) is False


def test_malformed_inputs_to_verify():
    assert trp.verify_range(b"\x00", 0, 100) is False
    assert trp.verify_range(b"", 0, 100) is False
    assert trp.verify_range(b"\x02\x01" + b"\x00" * 60, 0, 100) is False
    assert trp.verify_range(b"\x02\x01", 10, 5) is False


@pytest.mark.parametrize("args", [(150, 0, 100), (5, 10, 20), (5, 20, 10)])
def test_out_of_range_raises_as_reference(args):
    with pytest.raises(ValueError) as want:
        jrp.prove_range(*args)
    with pytest.raises(InvalidInput) as got:
        trp.prove_range(*args, device="cpu")
    assert str(got.value) == str(want.value)


def test_non_u64_and_other_widths():
    with pytest.raises(OverflowError):
        trp.prove_range(-1, 0, 10, device="cpu")
    with pytest.raises(TypeError):
        trp.prove_range(1.5, 0, 10, device="cpu")
    env = trp.prove_range_with_bits(5, 0, 200, 8, device="cpu")
    assert trp.verify_range(env, 0, 200) and jrp.verify_range(env, 0, 200)


def test_sha256_commitments_match_reference():
    from libzkp_tpu.utils import commitment as jc
    from libzkp_tpu_torch.utils import commitment as tcm

    assert tcm.commit_value(42) == jc.commit_value(42)
    assert tcm.commit_values([1, 2, 3]) == jc.commit_values([1, 2, 3])
    assert tcm.commit_with_context([7, 8], b"ctx") == jc.commit_with_context([7, 8], b"ctx")
    assert tcm.commit_improvement(3, 9) == jc.commit_improvement(3, 9)
    tcm.validate_improvement_commitment(jc.commit_improvement(3, 9), 3, 9)
    with pytest.raises(InvalidInput):
        tcm.commit_improvement(9, 3)
