"""u64-vector and backend-payload codecs.

Copy of the JAX package's ``libzkp_tpu/utils/serialization.py`` (the Rust
reference's ``utils/serialization.rs``: layouts and limits).
"""

from __future__ import annotations

from typing import List, Tuple

from .encoding import u32_le, u64_le
from .errors import SerializationError
from .limits import (
    MAX_BACKEND_OPERATION_LEN,
    MAX_BACKEND_PAYLOAD_BYTES,
    MAX_U64_VEC_LEN,
)


def serialize_u64_vec(values: List[int]) -> bytes:
    out = bytearray(u32_le(len(values)))
    for v in values:
        out += u64_le(v)
    return bytes(out)


def deserialize_u64_vec(data: bytes) -> List[int]:
    if len(data) < 4:
        raise SerializationError("data too short for length field")
    n = int.from_bytes(data[0:4], "little")
    if n > MAX_U64_VEC_LEN:
        raise SerializationError(f"vector too large: len={n}, max={MAX_U64_VEC_LEN}")
    expected = 4 + n * 8
    if len(data) != expected:
        raise SerializationError(
            f"data size mismatch: expected {expected}, got {len(data)}"
        )
    return [
        int.from_bytes(data[4 + i * 8 : 12 + i * 8], "little") for i in range(n)
    ]


def create_backend_payload(operation: str, params: bytes) -> bytes:
    """``[u32 op_len][op][u32 params_len][params]`` with bounds (serialization.rs:68-97)."""
    op_bytes = operation.encode("utf-8")
    if len(op_bytes) > MAX_BACKEND_OPERATION_LEN:
        return b""
    if 8 + len(op_bytes) + len(params) > MAX_BACKEND_PAYLOAD_BYTES:
        return b""
    return u32_le(len(op_bytes)) + op_bytes + u32_le(len(params)) + bytes(params)


def parse_backend_payload(data: bytes) -> Tuple[str, bytes]:
    if len(data) > MAX_BACKEND_PAYLOAD_BYTES:
        raise SerializationError(
            f"payload too large: max {MAX_BACKEND_PAYLOAD_BYTES} bytes"
        )
    if len(data) < 4:
        raise SerializationError("payload too short")
    op_len = int.from_bytes(data[0:4], "little")
    if op_len > MAX_BACKEND_OPERATION_LEN:
        raise SerializationError("operation too long")
    op_end = 4 + op_len
    if len(data) < op_end + 4:
        raise SerializationError("truncated before params length")
    params_len = int.from_bytes(data[op_end : op_end + 4], "little")
    expected = op_end + 4 + params_len
    if len(data) != expected:
        raise SerializationError("payload size mismatch")
    try:
        operation = data[4:op_end].decode("utf-8")
    except UnicodeDecodeError:
        raise SerializationError("invalid operation string") from None
    return operation, data[op_end + 4 :]
