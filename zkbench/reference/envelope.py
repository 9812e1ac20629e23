"""The versioned proof envelope shared by the six schemes, and the
scheme ids.

``[version:u8][scheme:u8][proof_len:u32 LE][commitment_len:u32 LE][proof]
[commitment]``, version 2 (the Rust reference's ``proof/mod.rs``).
"""

from __future__ import annotations

from typing import Optional, Tuple

PROOF_VERSION = 2
MAX_PROOF_TOTAL_BYTES = 1024 * 1024
MAX_PROOF_PAYLOAD_BYTES = 900 * 1024
MAX_COMMITMENT_BYTES = 256

SCHEMES = {"range": 1, "equality": 2, "threshold": 3, "membership": 4, "improvement": 5,
           "consistency": 6}


def parse(data: bytes, kind: str) -> Optional[Tuple[bytes, bytes]]:
    """``(payload, commitment)`` of an envelope of ``kind``'s scheme, or None."""
    data = bytes(data)
    if len(data) > MAX_PROOF_TOTAL_BYTES or len(data) < 10:
        return None
    if data[0] != PROOF_VERSION or data[1] != SCHEMES[kind]:
        return None
    proof_len = int.from_bytes(data[2:6], "little")
    comm_len = int.from_bytes(data[6:10], "little")
    if proof_len > MAX_PROOF_PAYLOAD_BYTES or comm_len > MAX_COMMITMENT_BYTES:
        return None
    if len(data) != 10 + proof_len + comm_len:
        return None
    return data[10 : 10 + proof_len], data[10 + proof_len :]
