"""The Bulletproofs backend's wire bodies, checked against their public
statements, down to single range-proof instances.

Frozen copy of the port's ``range_instances``, ``threshold_instances`` and
``consistency_instances``, with the proof width the deployment states
required of every instance:

* backend envelope ``[u32 body_len][body][u32=32][32B commitment]``;
* two-sided range body ``[min:8][max:8][n_bits:4][len|rp_min][len|rp_max]
  [Cmin:32][Cmax:32]``, transcripts ``b"libzkp_range_min"`` /
  ``b"libzkp_range_max"``, ``C_min = C - min*B``, ``C_max = max*B - C``;
* threshold body ``[threshold:8][n_bits:4][len|rp][Cdiff:32]``, transcript
  ``b"libzkp_threshold"``, ``C_diff = C_sum - threshold*B``;
* consistency body ``[count:4][C_i x32 ...][len|rp ...][Cdiff x32 ...]``,
  transcript ``b"libzkp_consistency"``, the SHA-256 of the commitment list
  as the envelope's commitment, ``C_diff_i = C_i - C_{i-1}``, 64 bits.
"""

from __future__ import annotations

import hashlib
from typing import List, Optional, Tuple

from . import ed25519 as ed
from .bp_generators import pedersen_gens
from .bulletproofs import RangeProof
from .strobe import Transcript

L = ed.L
Instance = Tuple[RangeProof, Transcript, bytes, int]


def _u64(data: bytes, at: int) -> int:
    return int.from_bytes(data[at : at + 8], "little")


def _u32(data: bytes, at: int) -> int:
    return int.from_bytes(data[at : at + 4], "little")


def _read_rp(body: bytes, pos: int) -> Tuple[Optional[RangeProof], int]:
    if len(body) < pos + 4:
        return None, pos
    n = _u32(body, pos)
    pos += 4
    if len(body) < pos + n:
        return None, pos
    return RangeProof.from_bytes(body[pos : pos + n]), pos + n


def range_instances(body: bytes, commit_bytes: bytes, min_v: int, max_v: int,
                    bits: int) -> Optional[List[Instance]]:
    value_commit = ed.decompress(commit_bytes)
    if value_commit is None or len(body) < 20:
        return None
    if _u64(body, 0) != min_v or _u64(body, 8) != max_v or _u32(body, 16) != bits:
        return None
    rp_min, pos = _read_rp(body, 20)
    if rp_min is None:
        return None
    rp_max, pos = _read_rp(body, pos)
    if rp_max is None or len(body) != pos + 64:
        return None
    c_min_bytes, c_max_bytes = body[pos : pos + 32], body[pos + 32 : pos + 64]
    B, _ = pedersen_gens()
    expected_min = ed.compress(ed.point_add(value_commit, ed.point_neg(ed.scalar_mul(min_v % L, B))))
    expected_max = ed.compress(ed.point_add(ed.scalar_mul(max_v % L, B), ed.point_neg(value_commit)))
    if expected_min != c_min_bytes or expected_max != c_max_bytes:
        return None
    return [(rp_min, Transcript(b"libzkp_range_min"), expected_min, bits),
            (rp_max, Transcript(b"libzkp_range_max"), expected_max, bits)]


def threshold_instances(body: bytes, commit_bytes: bytes, threshold: int,
                        bits: int) -> Optional[List[Instance]]:
    if len(body) < 12 or _u64(body, 0) != threshold or _u32(body, 8) != bits:
        return None
    rp, pos = _read_rp(body, 12)
    if rp is None or len(body) != pos + 32:
        return None
    diff_commit = body[pos : pos + 32]
    sum_commit = ed.decompress(commit_bytes)
    if sum_commit is None:
        return None
    B, _ = pedersen_gens()
    expected = ed.compress(ed.point_add(sum_commit, ed.point_neg(ed.scalar_mul(threshold % L, B))))
    if expected != diff_commit:
        return None
    return [(rp, Transcript(b"libzkp_threshold"), expected, bits)]


def consistency_instances(body: bytes, digest: bytes, count: int,
                          bits: int) -> Optional[List[Instance]]:
    """Instances of a consistency proof over ``count`` values; the proof
    states its count, and the statement's must match it."""
    if len(digest) != 32 or len(body) < 4 or _u32(body, 0) != count or count == 0:
        return None
    pos = 4
    if len(body) < pos + count * 32:
        return None
    commit_bytes = [body[pos + i * 32 : pos + (i + 1) * 32] for i in range(count)]
    pos += count * 32
    if hashlib.sha256(b"".join(commit_bytes)).digest() != digest:
        return None
    commitments = [ed.decompress(c) for c in commit_bytes]
    if any(c is None for c in commitments):
        return None
    proofs = []
    for _ in range(1, count):
        rp, pos = _read_rp(body, pos)
        if rp is None:
            return None
        proofs.append(rp)
    out = []
    for i in range(1, count):
        if len(body) < pos + 32:
            return None
        diff_commit = body[pos : pos + 32]
        pos += 32
        expected = ed.compress(ed.point_add(commitments[i], ed.point_neg(commitments[i - 1])))
        if expected != diff_commit:
            return None
        out.append((proofs[i - 1], Transcript(b"libzkp_consistency"), diff_commit, bits))
    if pos != len(body):
        return None
    return out
