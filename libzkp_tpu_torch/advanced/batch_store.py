"""Disk-backed batch persistence (``LZB1`` container, advisory file locks).

Copy of the JAX package's ``libzkp_tpu/advanced/batch_store.py`` (the Rust
reference's ``advanced/batch_store.rs``), so either package reads the
other's files: directory from ``set_batch_store_dir`` override or the
reference API's documented ``LIBZKP_BATCH_DIR`` setting; files
``batch_{id:016x}.bin`` = magic ``LZB1`` + u32 version + encoded operations;
exclusive-lock temp write + fsync + atomic rename; shared-lock reads.

The body layout is our bincode-equivalent (documented here, versioned):
``[u32 num_ops]`` then per op ``[u8 tag][fields...]`` with u64 LE scalars and
``[u32 n][u64 x n]`` vectors. Cross-implementation file compatibility with the
Rust store is a non-goal (SURVEY.md §2.2); container semantics are preserved.
"""

from __future__ import annotations

import fcntl
import os
import struct
import threading
from pathlib import Path
from typing import List, Optional

from ..utils.composition import BatchOperation, ProofBatch
from ..utils.encoding import u32_le, u64_le
from ..utils.errors import ConfigError, InvalidProofFormat, SerializationError, StorageError

FILE_MAGIC = b"LZB1"
FORMAT_VERSION = 1

_store_lock = threading.Lock()
_store_override: Optional[Path] = None

_OP_TAGS = {"range": 1, "equality": 2, "threshold": 3, "membership": 4,
            "improvement": 5, "consistency": 6}
_TAG_OPS = {v: k for k, v in _OP_TAGS.items()}


def set_batch_store_dir(path: str) -> None:
    """Override store directory (created if missing); beats ``LIBZKP_BATCH_DIR``."""
    global _store_override
    p = Path(path)
    try:
        p.mkdir(parents=True, exist_ok=True)
    except OSError as e:
        raise StorageError(f"create batch store directory: {e}") from None
    with _store_lock:
        _store_override = p


def get_batch_store_dir() -> Optional[Path]:
    with _store_lock:
        if _store_override is not None:
            return _store_override
    env = os.environ.get("LIBZKP_BATCH_DIR")
    return Path(env) if env else None


def _store_dir_required() -> Path:
    d = get_batch_store_dir()
    if d is None:
        raise ConfigError(
            "batch store not configured: set_batch_store_dir or LIBZKP_BATCH_DIR"
        )
    return d


def batch_file_path(directory: Path, batch_id: int) -> Path:
    return directory / f"batch_{batch_id:016x}.bin"


# -- codec -------------------------------------------------------------------


def _encode_op(op: BatchOperation) -> bytes:
    out = bytearray([_OP_TAGS[op.kind]])
    if op.kind == "range":
        v, lo, hi = op.args
        out += u64_le(v) + u64_le(lo) + u64_le(hi)
    elif op.kind == "equality":
        a, b = op.args
        out += u64_le(a) + u64_le(b)
    elif op.kind == "threshold":
        values, threshold = op.args
        out += u32_le(len(values))
        for v in values:
            out += u64_le(v)
        out += u64_le(threshold)
    elif op.kind == "membership":
        value, the_set = op.args
        out += u64_le(value) + u32_le(len(the_set))
        for v in the_set:
            out += u64_le(v)
    elif op.kind == "improvement":
        old, new = op.args
        out += u64_le(old) + u64_le(new)
    elif op.kind == "consistency":
        (data,) = op.args
        out += u32_le(len(data))
        for v in data:
            out += u64_le(v)
    else:
        raise SerializationError(f"unknown batch operation: {op.kind}")
    return bytes(out)


def encode_batch(batch: ProofBatch) -> bytes:
    body = bytearray(u32_le(len(batch.operations)))
    for op in batch.operations:
        body += _encode_op(op)
    return FILE_MAGIC + struct.pack("<I", FORMAT_VERSION) + bytes(body)


class _Cursor:
    def __init__(self, data: bytes, pos: int = 0):
        self.data = data
        self.pos = pos

    def u8(self) -> int:
        if self.pos + 1 > len(self.data):
            raise SerializationError("batch file decode: truncated")
        v = self.data[self.pos]
        self.pos += 1
        return v

    def u32(self) -> int:
        if self.pos + 4 > len(self.data):
            raise SerializationError("batch file decode: truncated")
        v = int.from_bytes(self.data[self.pos : self.pos + 4], "little")
        self.pos += 4
        return v

    def u64(self) -> int:
        if self.pos + 8 > len(self.data):
            raise SerializationError("batch file decode: truncated")
        v = int.from_bytes(self.data[self.pos : self.pos + 8], "little")
        self.pos += 8
        return v

    def u64_vec(self) -> List[int]:
        n = self.u32()
        if n > 1 << 20:
            raise SerializationError("batch file decode: vector too large")
        return [self.u64() for _ in range(n)]


def decode_batch_bytes(data: bytes) -> ProofBatch:
    if len(data) < 8:
        raise InvalidProofFormat("batch file too short")
    if data[:4] != FILE_MAGIC:
        raise InvalidProofFormat("batch file: bad magic")
    ver = struct.unpack("<I", data[4:8])[0]
    if ver != FORMAT_VERSION:
        raise InvalidProofFormat(f"batch file: unsupported version {ver}")
    cur = _Cursor(data, 8)
    n = cur.u32()
    if n > 1 << 20:
        raise SerializationError("batch file decode: too many operations")
    ops: List[BatchOperation] = []
    for _ in range(n):
        tag = cur.u8()
        kind = _TAG_OPS.get(tag)
        if kind is None:
            raise SerializationError(f"batch file decode: unknown op tag {tag}")
        if kind == "range":
            ops.append(BatchOperation(kind, (cur.u64(), cur.u64(), cur.u64())))
        elif kind == "equality":
            ops.append(BatchOperation(kind, (cur.u64(), cur.u64())))
        elif kind == "threshold":
            ops.append(BatchOperation(kind, (cur.u64_vec(), cur.u64())))
        elif kind == "membership":
            ops.append(BatchOperation(kind, (cur.u64(), cur.u64_vec())))
        elif kind == "improvement":
            ops.append(BatchOperation(kind, (cur.u64(), cur.u64())))
        elif kind == "consistency":
            ops.append(BatchOperation(kind, (cur.u64_vec(),)))
    if cur.pos != len(data):
        raise SerializationError("batch file decode: trailing bytes")
    return ProofBatch.from_operations(ops)


# -- file IO (flock + atomic rename) ------------------------------------------


def write_batch_file(directory: Path, batch_id: int, batch: ProofBatch) -> None:
    final_path = batch_file_path(directory, batch_id)
    tmp_path = directory / f".batch_{batch_id:016x}.tmp"
    data = encode_batch(batch)
    try:
        with open(tmp_path, "wb") as f:
            fcntl.flock(f.fileno(), fcntl.LOCK_EX)
            f.write(data)
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp_path, final_path)
    except OSError as e:
        raise StorageError(f"write batch file: {e}") from None


def read_batch_file(directory: Path, batch_id: int) -> ProofBatch:
    path = batch_file_path(directory, batch_id)
    try:
        with open(path, "rb") as f:
            fcntl.flock(f.fileno(), fcntl.LOCK_SH)
            data = f.read()
    except OSError as e:
        raise StorageError(f"open batch file: {e}") from None
    return decode_batch_bytes(data)


def delete_batch_file_if_configured(batch_id: int) -> None:
    directory = get_batch_store_dir()
    if directory is None:
        return
    path = batch_file_path(directory, batch_id)
    if path.exists():
        try:
            path.unlink()
        except OSError as e:
            raise StorageError(f"remove batch file: {e}") from None


def persist_batch_if_configured(batch_id: int, batch: ProofBatch) -> None:
    directory = get_batch_store_dir()
    if directory is None:
        return
    write_batch_file(directory, batch_id, batch)


def list_batch_ids_in_store() -> List[int]:
    directory = _store_dir_required()
    ids = []
    try:
        entries = os.listdir(directory)
    except OSError as e:
        raise StorageError(f"read batch store: {e}") from None
    for name in entries:
        if name.startswith("batch_") and name.endswith(".bin"):
            hexpart = name[len("batch_") : -len(".bin")]
            try:
                ids.append(int(hexpart, 16))
            except ValueError:
                continue
    return sorted(ids)


def export_proof_batch_to_path(batch: ProofBatch, path) -> None:
    path = Path(path)
    data = encode_batch(batch)
    try:
        path.parent.mkdir(parents=True, exist_ok=True)
        tmp = path.with_suffix(".tmp")
        with open(tmp, "wb") as f:
            fcntl.flock(f.fileno(), fcntl.LOCK_EX)
            f.write(data)
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, path)
    except OSError as e:
        raise StorageError(f"write export: {e}") from None


def import_proof_batch_from_path(path) -> ProofBatch:
    try:
        with open(path, "rb") as f:
            fcntl.flock(f.fileno(), fcntl.LOCK_SH)
            data = f.read()
    except OSError as e:
        raise StorageError(f"open import: {e}") from None
    return decode_batch_bytes(data)


def _reset_for_tests() -> None:
    global _store_override
    with _store_lock:
        _store_override = None
