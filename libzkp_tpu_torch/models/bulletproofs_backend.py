"""Bulletproofs backend: range, threshold and consistency proofs.

Port of the JAX package's ``libzkp_tpu/models/bulletproofs_backend.py``,
wire-identical to it:

* backend envelope ``[u32 body_len][body][u32=32][32B commitment]``;
* two-sided range body ``[min:8][max:8][n_bits:4][len|rp_min][len|rp_max]
  [Cmin:32][Cmax:32]`` with transcripts ``b"libzkp_range_min"`` /
  ``b"libzkp_range_max"`` and blindings ``b`` / ``-b``;
* threshold body ``[threshold:8][n_bits:4][len|rp][Cdiff:32]``, transcript
  ``b"libzkp_threshold"``, diff blinding = sum blinding;
* consistency body ``[count:4][C_i x32 ...][len|rp ...][Cdiff x32 ...]``,
  transcript ``b"libzkp_consistency"``, the SHA-256 digest of the
  commitment list as envelope commitment;
* homomorphic verification: ``C_min = C - min*B``, ``C_max = max*B - C``,
  ``C_diff = C_sum - threshold*B``, ``C_diff_i = C_i - C_{i-1}``.

Every prover is a ``prepare_*`` (the single-proof instances and a
``finish`` that assembles the wire bytes from their results) and one
:func:`.bulletproofs.prove_single_batch` on the caller's device;
verification is the pure-Python host verifier and never raises.
"""

from __future__ import annotations

import hashlib
import os
from typing import List, Optional, Tuple

from ..device import resolve
from ..ops import ed25519 as ed
from ..utils.encoding import read_u64_le, u32_le, u64_le
from .bp_generators import pedersen_commit, pedersen_commit_compressed_many, pedersen_gens
from .bulletproofs import RangeProof, batch_verify_groups, prove_single_batch, verify_single
from .strobe import Transcript

L = ed.L


def encode_proof_body_with_commit(body: bytes, commit: bytes) -> bytes:
    if len(commit) != 32:
        raise ValueError("commitment must be 32 bytes")
    return u32_le(len(body)) + body + u32_le(32) + commit


def decode_proof_body_and_commit(data: bytes) -> Optional[Tuple[bytes, bytes]]:
    if len(data) < 4 + 4 + 32:
        return None
    plen = int.from_bytes(data[0:4], "little")
    proof_end = 4 + plen
    if len(data) < proof_end + 4 + 32:
        return None
    clen = int.from_bytes(data[proof_end : proof_end + 4], "little")
    if clen != 32 or len(data) != proof_end + 4 + 32:
        return None
    return data[4:proof_end], data[proof_end + 4 :]


def _random_blinding() -> int:
    # reference: Scalar::from_bytes_mod_order(OsRng 32 bytes)
    return ed.scalar_from_bytes_mod_order(os.urandom(32))


def max_u64_for_bit_width(n_bits: int) -> int:
    return (1 << 64) - 1 if n_bits >= 64 else (1 << n_bits) - 1


class BulletproofsBackend:
    @staticmethod
    def prove_range_with_bounds_bits(
        value: int, min_v: int, max_v: int, n_bits: int, *, device=None
    ) -> bytes:
        instances, finish = BulletproofsBackend.prepare_range_bits(value, min_v, max_v, n_bits)
        return finish(prove_single_batch(instances, device=device))

    @staticmethod
    def prepare_range_bits(value: int, min_v: int, max_v: int, n_bits: int):
        """Returns ``(instances, finish)``: the two ``(Transcript, value,
        blinding, n)`` single-proof instances of one range proof, and
        ``finish(results)`` that assembles the backend wire bytes from their
        ``(RangeProof, V)`` results. Lets many range proofs share one batch."""
        if value < min_v or value > max_v:
            raise ValueError("value out of range")
        max_diff = max_u64_for_bit_width(n_bits)
        diff_min = value - min_v
        diff_max = max_v - value
        if diff_min > max_diff or diff_max > max_diff:
            raise ValueError(
                f"range width exceeds {n_bits}-bit capacity; use n_bits=64"
            )
        blinding = _random_blinding()
        value_commit = ed.compress(pedersen_commit(value % L, blinding))
        instances = [
            (Transcript(b"libzkp_range_min"), diff_min, blinding, n_bits),
            (Transcript(b"libzkp_range_max"), diff_max, (L - blinding) % L, n_bits),
        ]

        def finish(results):
            (rp_min, c_min), (rp_max, c_max) = results
            body = bytearray()
            body += u64_le(min_v)
            body += u64_le(max_v)
            body += u32_le(n_bits)
            rp_min_b = rp_min.to_bytes()
            body += u32_le(len(rp_min_b)) + rp_min_b
            rp_max_b = rp_max.to_bytes()
            body += u32_le(len(rp_max_b)) + rp_max_b
            body += c_min
            body += c_max
            return encode_proof_body_with_commit(bytes(body), value_commit)

        return instances, finish

    @staticmethod
    def verify_range_with_bounds(proof_data: bytes, min_v: int, max_v: int) -> bool:
        return BulletproofsBackend.verify_range_with_bounds_bits(proof_data, min_v, max_v)

    @staticmethod
    def verify_range_with_bounds_bits(proof_data: bytes, min_v: int, max_v: int) -> bool:
        """Never raises: anything malformed is ``False``."""
        try:
            insts = BulletproofsBackend.range_instances(proof_data, min_v, max_v)
            if insts is None:
                return False
            return batch_verify_groups([insts])[0]
        except Exception:
            return False

    @staticmethod
    def range_instances(proof_data: bytes, min_v: int, max_v: int):
        """Structural + homomorphic checks; returns the two single-proof
        verification instances ``(RangeProof, Transcript, V, n_bits)`` or
        None."""
        decoded = decode_proof_body_and_commit(proof_data)
        if decoded is None:
            return None
        body, commit_bytes = decoded
        value_commit = ed.decompress(commit_bytes)
        if value_commit is None:
            return None
        if len(body) < 20:
            return None
        proof_min = read_u64_le(body, 0)
        proof_max = read_u64_le(body, 8)
        if proof_min != min_v or proof_max != max_v:
            return None
        n_bits = int.from_bytes(body[16:20], "little")
        pos = 20
        if len(body) < pos + 4:
            return None
        l1 = int.from_bytes(body[pos : pos + 4], "little")
        pos += 4
        if len(body) < pos + l1:
            return None
        rp_min = RangeProof.from_bytes(body[pos : pos + l1])
        pos += l1
        if rp_min is None or len(body) < pos + 4:
            return None
        l2 = int.from_bytes(body[pos : pos + 4], "little")
        pos += 4
        if len(body) < pos + l2:
            return None
        rp_max = RangeProof.from_bytes(body[pos : pos + l2])
        pos += l2
        if rp_max is None or len(body) != pos + 64:
            return None
        c_min_bytes = body[pos : pos + 32]
        c_max_bytes = body[pos + 32 : pos + 64]

        B, _ = pedersen_gens()
        expected_min = ed.compress(
            ed.point_add(value_commit, ed.point_neg(ed.scalar_mul(min_v % L, B)))
        )
        expected_max = ed.compress(
            ed.point_add(ed.scalar_mul(max_v % L, B), ed.point_neg(value_commit))
        )
        if expected_min != c_min_bytes or expected_max != c_max_bytes:
            return None

        return [
            (rp_min, Transcript(b"libzkp_range_min"), expected_min, n_bits),
            (rp_max, Transcript(b"libzkp_range_max"), expected_max, n_bits),
        ]

    # -- threshold ---------------------------------------------------------
    @staticmethod
    def prove_threshold(values: List[int], threshold: int, *, device=None) -> bytes:
        return BulletproofsBackend.prove_threshold_bits(values, threshold, 64, device=device)

    @staticmethod
    def prove_threshold_bits(
        values: List[int], threshold: int, n_bits: int, *, device=None
    ) -> bytes:
        instances, finish = BulletproofsBackend.prepare_threshold_bits(values, threshold, n_bits)
        return finish(prove_single_batch(instances, device=device))

    @staticmethod
    def prepare_threshold_bits(values: List[int], threshold: int, n_bits: int):
        """``(instances, finish)`` of one threshold proof (see
        :meth:`prepare_range_bits`): one instance, sum - threshold under the
        sum's blinding."""
        if not values:
            raise ValueError("values cannot be empty")
        total = 0
        for v in values:
            total += v
            if total > (1 << 64) - 1:
                raise ValueError("integer overflow in sum calculation")
        if total < threshold:
            raise ValueError("threshold not met")
        diff = total - threshold
        if diff > max_u64_for_bit_width(n_bits):
            raise ValueError(
                f"sum - threshold exceeds {n_bits}-bit capacity; use n_bits=64"
            )
        sum_blinding = _random_blinding()
        sum_commit = ed.compress(pedersen_commit(total % L, sum_blinding))
        instances = [(Transcript(b"libzkp_threshold"), diff, sum_blinding, n_bits)]

        def finish(results):
            ((rp, diff_commit),) = results
            body = bytearray()
            body += u64_le(threshold)
            body += u32_le(n_bits)
            rp_b = rp.to_bytes()
            body += u32_le(len(rp_b)) + rp_b
            body += diff_commit
            return encode_proof_body_with_commit(bytes(body), sum_commit)

        return instances, finish

    @staticmethod
    def verify_threshold(proof_data: bytes, threshold: int) -> bool:
        """Never raises: anything malformed is ``False``."""
        try:
            insts = BulletproofsBackend.threshold_instances(proof_data, threshold)
            if insts is None:
                return False
            return batch_verify_groups([insts])[0]
        except Exception:
            return False

    @staticmethod
    def threshold_instances(proof_data: bytes, threshold: int):
        """Structural checks; returns the single verification instance or
        None (see :meth:`range_instances`)."""
        decoded = decode_proof_body_and_commit(proof_data)
        if decoded is None:
            return None
        body, sum_commit_bytes = decoded
        if len(body) < 12:
            return None
        if read_u64_le(body, 0) != threshold:
            return None
        n_bits = int.from_bytes(body[8:12], "little")
        pos = 12
        if len(body) < pos + 4:
            return None
        rp_len = int.from_bytes(body[pos : pos + 4], "little")
        pos += 4
        if len(body) < pos + rp_len:
            return None
        rp = RangeProof.from_bytes(body[pos : pos + rp_len])
        pos += rp_len
        if rp is None or len(body) != pos + 32:
            return None
        diff_commit = body[pos : pos + 32]
        sum_commit = ed.decompress(sum_commit_bytes)
        if sum_commit is None:
            return None
        B, _ = pedersen_gens()
        expected_diff = ed.compress(
            ed.point_add(sum_commit, ed.point_neg(ed.scalar_mul(threshold % L, B)))
        )
        if expected_diff != diff_commit:
            return None
        return [(rp, Transcript(b"libzkp_threshold"), expected_diff, n_bits)]

    # -- consistency (monotonic non-decreasing) ----------------------------
    @staticmethod
    def prove_consistency(data: List[int], *, device=None) -> bytes:
        instances, finish = BulletproofsBackend.prepare_consistency(data, device=device)
        return finish(prove_single_batch(instances, device=device))

    @staticmethod
    def prepare_consistency(data: List[int], *, device=None):
        """``(instances, finish)`` of one consistency proof (see
        :meth:`prepare_range_bits`): the len(data) commitments as one MSM
        batch on ``device`` (default: the CUDA card), and one 64-bit
        instance per step, ``data[i] - data[i-1]`` under ``b_i - b_{i-1}``."""
        device = resolve(device)
        if not data:
            raise ValueError("data cannot be empty")
        if any(data[i] > data[i + 1] for i in range(len(data) - 1)):
            raise ValueError("data inconsistent")
        blindings = [_random_blinding() for _ in data]
        commitments = pedersen_commit_compressed_many(
            [(v % L, b) for v, b in zip(data, blindings)], device=device
        )
        instances = [
            (
                Transcript(b"libzkp_consistency"),
                data[i] - data[i - 1],
                (blindings[i] - blindings[i - 1]) % L,
                64,
            )
            for i in range(1, len(data))
        ]

        def finish(results):
            body = bytearray()
            body += u32_le(len(data))
            for c in commitments:
                body += c
            for rp, _ in results:
                rp_b = rp.to_bytes()
                body += u32_le(len(rp_b)) + rp_b
            for _, dc in results:
                body += dc
            digest = hashlib.sha256(b"".join(commitments)).digest()
            return encode_proof_body_with_commit(bytes(body), digest)

        return instances, finish

    @staticmethod
    def verify_consistency(proof_data: bytes) -> bool:
        """Never raises: anything malformed is ``False``."""
        try:
            insts = BulletproofsBackend.consistency_instances(proof_data)
            if insts is None:
                return False
            return batch_verify_groups([insts])[0]
        except Exception:
            return False

    @staticmethod
    def consistency_instances(proof_data: bytes):
        """Structural and commitment-chain checks; returns the num - 1 step
        verification instances or None (see :meth:`range_instances`)."""
        decoded = decode_proof_body_and_commit(proof_data)
        if decoded is None:
            return None
        body, commitment_hash = decoded
        if len(commitment_hash) != 32 or len(body) < 4:
            return None
        num = int.from_bytes(body[0:4], "little")
        if num == 0:
            return None
        pos = 4
        if len(body) < pos + num * 32:
            return None
        commit_bytes = [body[pos + i * 32 : pos + (i + 1) * 32] for i in range(num)]
        pos += num * 32
        if hashlib.sha256(b"".join(commit_bytes)).digest() != commitment_hash:
            return None
        commitments = [ed.decompress(c) for c in commit_bytes]
        if any(c is None for c in commitments):
            return None
        range_proofs = []
        for _ in range(1, num):
            if len(body) < pos + 4:
                return None
            rp_len = int.from_bytes(body[pos : pos + 4], "little")
            pos += 4
            if len(body) < pos + rp_len:
                return None
            rp = RangeProof.from_bytes(body[pos : pos + rp_len])
            if rp is None:
                return None
            range_proofs.append(rp)
            pos += rp_len
        diff_commits = []
        for i in range(1, num):
            if len(body) < pos + 32:
                return None
            diff_commit = body[pos : pos + 32]
            pos += 32
            expected = ed.compress(
                ed.point_add(commitments[i], ed.point_neg(commitments[i - 1]))
            )
            if expected != diff_commit:
                return None
            diff_commits.append(diff_commit)
        if pos != len(body):
            return None
        return [
            (range_proofs[i], Transcript(b"libzkp_consistency"), diff_commits[i], 64)
            for i in range(num - 1)
        ]

    # -- raw ZkpBackend trait interface (bulletproofs.rs:629-684) ----------
    @staticmethod
    def prove(data: bytes, *, device=None) -> bytes:
        """``[u64 LE value]`` -> ``[RangeProof][V:32]``, a 64-bit proof under
        the transcript ``b"libzkp_bulletproof"`` on ``device`` (default: the
        CUDA card); ``b""`` for input that is not 8 bytes, the trait's one
        defined failure. Any other failure raises."""
        if len(data) != 8:
            return b""
        value = read_u64_le(data, 0)
        blinding = _random_blinding()
        ((rp, commit),) = prove_single_batch(
            [(Transcript(b"libzkp_bulletproof"), value, blinding, 64)], device=device)
        return rp.to_bytes() + commit

    @staticmethod
    def verify(proof: bytes, _data: bytes = b"") -> bool:
        """Never raises: anything malformed is ``False``."""
        if len(proof) < 32:
            return False
        rp = RangeProof.from_bytes(proof[:-32])
        if rp is None:
            return False
        return verify_single(rp, Transcript(b"libzkp_bulletproof"), proof[-32:], 64)
