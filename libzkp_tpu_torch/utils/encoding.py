"""Little-endian byte helpers shared by backends and proof parsing.

Copy of the JAX package's ``libzkp_tpu/utils/encoding.py`` (the Rust reference's
``utils/encoding.rs``).
"""

from __future__ import annotations

import struct
from typing import Optional, Tuple


def u32_le(x: int) -> bytes:
    return struct.pack("<I", x & 0xFFFFFFFF)


def u64_le(x: int) -> bytes:
    return struct.pack("<Q", x & 0xFFFFFFFFFFFFFFFF)


def read_u64_le(data: bytes, offset: int) -> Optional[int]:
    """Read a u64 from ``data`` at ``offset`` if at least 8 bytes are available."""
    if offset < 0 or offset + 8 > len(data):
        return None
    return struct.unpack_from("<Q", data, offset)[0]


def read_u32_le(data: bytes, offset: int) -> Optional[int]:
    if offset < 0 or offset + 4 > len(data):
        return None
    return struct.unpack_from("<I", data, offset)[0]


def read_length_prefixed_u32(data: bytes, offset: int) -> Optional[Tuple[bytes, int]]:
    """Consume ``[u32 len][payload...]`` starting at ``offset``.

    Returns ``(payload, new_offset)`` or ``None`` on truncation — the Python
    shape of the reference's ``read_length_prefixed_u32`` (encoding.rs:11-23),
    which advances a slice cursor.
    """
    n = read_u32_le(data, offset)
    if n is None:
        return None
    offset += 4
    if offset + n > len(data):
        return None
    return data[offset : offset + n], offset + n


def check_u64(value: int, name: str = "value") -> int:
    """Validate that a Python int fits in u64 (the API's integer domain).

    Exception classes match PyO3's conversion behavior at the bindings layer:
    TypeError for non-ints, OverflowError for out-of-range ints.
    """
    if not isinstance(value, int) or isinstance(value, bool):
        raise TypeError(f"{name} must be an integer")
    if value < 0 or value > 0xFFFFFFFFFFFFFFFF:
        raise OverflowError("out of range integral type conversion attempted")
    return value
