"""Set-membership proof (scheme 4): value in set, the value and its index
hidden.

Port of the JAX package's ``libzkp_tpu/models/schemes/set_membership.py``:
the set is embedded in the payload as ``[u32 len][u64 x len]`` and compared
order-insensitively at verification. The provers take a keyword-only
``device=`` (default: the CUDA card; ``"cpu"`` runs the plain PyTorch path)
and run the batched Groth16 prover, whose query MSMs and h NTTs run on that
device; the verifier runs on the host's native tier.
"""

from __future__ import annotations

from typing import List

from ...device import resolve
from ...utils.commitment import commit_value_snark
from ...utils.encoding import u32_le, u64_le
from ...utils.envelope import SCHEME_MEMBERSHIP, Proof
from ...utils.errors import ProofGenerationFailed
from ...utils.validation import validate_membership_params, validate_set_size
from ..snark_backend import MAX_SET_SIZE, SnarkBackend
from .common import (
    deserialize_embedded_set_prefix,
    parse_and_validate_proof,
    validate_standard_commitment,
)

SCHEME_ID = SCHEME_MEMBERSHIP


def prove_membership(value: int, the_set: List[int], *, device=None) -> bytes:
    return prove_membership_batch([(value, the_set)], device=device)[0]


def prove_membership_batch(items, *, device=None, commitments=None) -> list:
    """Batched variant over ``(value, set)`` items: all proofs of the fixed
    membership circuit share each proving-key table walk on the device.

    ``commitments`` (one 32-byte MiMC commitment of ``value`` an item, from
    a caller that hashed them in one device batch) replaces the per-item
    :func:`commit_value_snark`; a commitment that is not MiMC5(value) gets
    no proof, and the batch raises."""
    device = resolve(device)
    items = [(value, list(the_set)) for value, the_set in items]
    for value, the_set in items:
        validate_membership_params(value, the_set)
        validate_set_size(the_set, MAX_SET_SIZE)
    if commitments is None:
        commitments = [commit_value_snark(v) for v, _ in items]
    elif len(commitments) != len(items):
        raise ValueError(f"{len(commitments)} commitments for {len(items)} items")
    snarks = SnarkBackend.prove_membership_zk_many(
        [(v, s, c) for (v, s), c in zip(items, commitments)], device=device)
    out = []
    for (_, the_set), sp, c in zip(items, snarks, commitments):
        if not sp:
            raise ProofGenerationFailed("SNARK membership proof generation failed")
        payload = bytearray(u32_le(len(the_set)))
        for v in the_set:
            payload += u64_le(v)
        out.append(Proof.new(SCHEME_ID, bytes(payload) + sp, c).to_bytes())
    return out


def verify_membership(proof: bytes, the_set: List[int]) -> bool:
    try:
        p = parse_and_validate_proof(proof, SCHEME_ID)
        validate_standard_commitment(p.commitment)
    except Exception:
        return False
    parsed = deserialize_embedded_set_prefix(p.proof, MAX_SET_SIZE)
    if parsed is None:
        return False
    embedded_set, snark_bytes = parsed
    if len(the_set) != len(embedded_set) or sorted(the_set) != sorted(embedded_set):
        return False
    return SnarkBackend.verify_membership_zk(snark_bytes, embedded_set, p.commitment)
