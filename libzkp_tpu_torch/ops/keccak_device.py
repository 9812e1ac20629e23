"""Batched Keccak-f[1600] + STROBE-128 / Merlin transcript on torch lanes.

Port of the JAX package's ``libzkp_tpu/ops/keccak_device.py``: the
Fiat–Shamir layer of the batched prover, so a whole proof batch advances in
lockstep on the device with no host round trip per transcript operation.

* State: the 25 Keccak lanes of B transcripts as one ``(25, B)`` int64
  tensor, a 64-bit lane per word (torch has no unsigned 64-bit shifts, so
  right shifts are masked to act as logical ones). The JAX version kept 50
  uint32 half-words tiled for TPU vector registers; the bytes are the same.
* The STROBE schedule is static for a batch of same-shape instances: every
  absorb/squeeze position, flag byte and permutation point is a Python int,
  identical across lanes; only the absorbed and squeezed values are tensors.
  Lane-constant bytes (labels, lengths, padding) are XORed in as host-built
  lane words; per-lane data is packed into lane words in one step per run of
  bytes that does not cross the rate.
* Byte tensors (messages, challenges) are ``(L, B)`` int32, one byte each.
"""

from __future__ import annotations

from typing import Sequence

import numpy as np
import torch

from .keccak import ROTATION, ROUND_CONSTANTS

STROBE_R = 166

FLAG_I = 1
FLAG_A = 1 << 1
FLAG_C = 1 << 2
FLAG_T = 1 << 3
FLAG_M = 1 << 4
FLAG_K = 1 << 5

_MASK64 = (1 << 64) - 1


def _signed64(v: int) -> int:
    v &= _MASK64
    return v - (1 << 64) if v >> 63 else v


# rho offsets per lane index x + 5y, and the pi destination of each lane
_RHO = [ROTATION[i % 5][i // 5] for i in range(25)]
_PI_SRC = [0] * 25
for _x in range(5):
    for _y in range(5):
        _PI_SRC[_y + 5 * ((2 * _x + 3 * _y) % 5)] = _x + 5 * _y
_RC = [_signed64(rc) for rc in ROUND_CONSTANTS]


def _rotl(x: torch.Tensor, s: torch.Tensor, low_mask: torch.Tensor) -> torch.Tensor:
    """64-bit rotate-left by per-row amounts s; low_mask = 2^s - 1 masks the
    arithmetic right shift into a logical one (and to 0 where s = 0)."""
    return (x << s) | ((x >> ((64 - s) % 64)) & low_mask)


def keccak_f1600_device(state: torch.Tensor) -> torch.Tensor:
    """Permute a (25, B) int64 lane state (lane i = x + 5y, little-endian
    bytes); returns the new state."""
    dev = state.device
    rho = torch.tensor(_RHO, dtype=torch.int64, device=dev)[:, None]
    rho_mask = torch.tensor([(1 << s) - 1 for s in _RHO], dtype=torch.int64, device=dev)[:, None]
    pi_src = torch.tensor(_PI_SRC, dtype=torch.int64, device=dev)
    a = state
    for rc in _RC:
        # theta
        a5 = a.view(5, 5, -1)  # [y][x]
        c = a5[0] ^ a5[1] ^ a5[2] ^ a5[3] ^ a5[4]  # (5, B) over x
        c_next = c.roll(-1, dims=0)
        d = c.roll(1, dims=0) ^ ((c_next << 1) | ((c_next >> 63) & 1))
        a = (a5 ^ d[None]).reshape(25, -1)
        # rho + pi
        b = _rotl(a, rho, rho_mask)[pi_src].view(5, 5, -1)  # [y][x]
        # chi
        a = (b ^ (~b.roll(-1, dims=1) & b.roll(-2, dims=1))).reshape(25, -1)
        # iota
        a[0] ^= rc
    return a


def _lane_words(data: bytes) -> np.ndarray:
    """200 state bytes -> (25, 1) int64 lane words."""
    return np.frombuffer(bytes(data), dtype="<i8").reshape(25, 1).copy()


class StrobeDevice:
    """Lockstep STROBE-128 sponge over B lanes (``models/strobe.Strobe128``
    with tensor message values)."""

    def __init__(self, protocol_label: bytes, B: int, *, device):
        from .keccak import keccak_f1600_bytes

        init = bytearray(200)
        init[0:6] = bytes([1, STROBE_R + 2, 1, 0, 1, 96])
        init[6:18] = b"STROBEv1.0.2"
        keccak_f1600_bytes(init)
        self.B = B
        self.device = torch.device(device)
        self.state = torch.from_numpy(_lane_words(init)).to(self.device).expand(25, B).contiguous()
        self.pos = 0
        self.pos_begin = 0
        self.cur_flags = 0
        self.meta_ad(protocol_label, False)

    @classmethod
    def from_states(cls, snapshots: Sequence[bytes], *, device) -> "StrobeDevice":
        """Resume B lockstep sponges from 203-byte ``Strobe128.state_bytes``
        snapshots. pos/pos_begin/cur_flags must agree across lanes (the
        schedule is static); callers group instances accordingly."""
        pos, begin, flags = snapshots[0][200], snapshots[0][201], snapshots[0][202]
        if not all(s[200] == pos and s[201] == begin and s[202] == flags for s in snapshots):
            raise ValueError("mixed transcript positions in one device batch")
        self = cls.__new__(cls)
        self.B = len(snapshots)
        self.device = torch.device(device)
        words = np.stack([np.frombuffer(s[:200], dtype="<i8") for s in snapshots], axis=1)
        self.state = torch.from_numpy(np.ascontiguousarray(words)).to(self.device)
        self.pos = int(pos)
        self.pos_begin = int(begin)
        self.cur_flags = int(flags)
        return self

    def state_bytes(self, lane: int) -> bytes:
        """The 200 state bytes of one lane (for tests and checks)."""
        return self.state[:, lane].cpu().numpy().astype("<i8").tobytes()

    # -- low-level ---------------------------------------------------------
    def _xor_const(self, start: int, data: bytes) -> None:
        """XOR lane-constant bytes into state positions start.. (no wrap)."""
        buf = bytearray(200)
        buf[start : start + len(data)] = data
        self.state = self.state ^ torch.from_numpy(_lane_words(buf)).to(self.device)

    def _xor_rows(self, start: int, rows: torch.Tensor) -> None:
        """XOR (k, B) per-lane byte rows into state positions start..start+k-1."""
        grid = torch.zeros((200, self.B), dtype=torch.int64, device=self.device)
        grid[start : start + rows.shape[0]] = rows.to(torch.int64)
        shifts = torch.arange(0, 64, 8, dtype=torch.int64, device=self.device)[None, :, None]
        # the eight shifted bytes of a lane occupy disjoint bits: their sum is their OR
        self.state = self.state ^ (grid.view(25, 8, self.B) << shifts).sum(dim=1)

    def _run_f(self) -> None:
        pad = bytearray(200)
        pad[self.pos] ^= self.pos_begin
        pad[self.pos + 1] ^= 0x04
        pad[STROBE_R + 1] ^= 0x80
        self._xor_const(0, bytes(pad))
        self.state = keccak_f1600_device(self.state)
        self.pos = 0
        self.pos_begin = 0

    def _absorb(self, data) -> None:
        """data: bytes (lane-constant) or an (L, B) int byte tensor."""
        off = 0
        total = len(data) if isinstance(data, (bytes, bytearray)) else data.shape[0]
        while off < total:
            k = min(total - off, STROBE_R - self.pos)
            if isinstance(data, (bytes, bytearray)):
                self._xor_const(self.pos, bytes(data[off : off + k]))
            else:
                self._xor_rows(self.pos, data[off : off + k])
            off += k
            self.pos += k
            if self.pos == STROBE_R:
                self._run_f()

    def _squeeze(self, n: int) -> torch.Tensor:
        """-> (n, B) int32 bytes (state bytes are zeroed, as the STROBE PRF)."""
        out = []
        while n:
            k = min(n, STROBE_R - self.pos)
            shifts = torch.arange(0, 64, 8, dtype=torch.int64, device=self.device)[None, :, None]
            all_bytes = ((self.state[:, None, :] >> shifts) & 0xFF).reshape(200, self.B)
            out.append(all_bytes[self.pos : self.pos + k].to(torch.int32))
            keep = bytearray(b"\xff" * 200)
            keep[self.pos : self.pos + k] = bytes(k)
            self.state = self.state & torch.from_numpy(_lane_words(keep)).to(self.device)
            n -= k
            self.pos += k
            if self.pos == STROBE_R:
                self._run_f()
        return torch.cat(out, dim=0)

    def _begin_op(self, flags: int, more: bool) -> None:
        if more:
            assert self.cur_flags == flags, "flag mismatch on more=True"
            return
        assert flags & FLAG_T == 0, "transport flags not supported"
        old_begin = self.pos_begin
        self.pos_begin = self.pos + 1
        self.cur_flags = flags
        self._absorb(bytes([old_begin, flags]))
        if flags & (FLAG_C | FLAG_K) and self.pos != 0:
            self._run_f()

    # -- operations (merlin subset) ----------------------------------------
    def meta_ad(self, data, more: bool) -> None:
        self._begin_op(FLAG_M | FLAG_A, more)
        self._absorb(data)

    def ad(self, data, more: bool) -> None:
        self._begin_op(FLAG_A, more)
        self._absorb(data)

    def prf(self, n: int, more: bool = False) -> torch.Tensor:
        self._begin_op(FLAG_I | FLAG_A | FLAG_C, more)
        return self._squeeze(n)


class TranscriptDevice:
    """Merlin v1.0 transcript over B lockstep lanes (``models/strobe.Transcript``
    with tensor message values)."""

    def __init__(self, label: bytes, B: int, *, device):
        self.strobe = StrobeDevice(b"Merlin v1.0", B, device=device)
        self.B = B
        self.append_message(b"dom-sep", label)

    @classmethod
    def from_transcripts(cls, transcripts, *, device) -> "TranscriptDevice":
        """Resume from per-lane host ``models.strobe.Transcript`` objects
        (equal positions required — group by protocol-label length)."""
        return cls.from_snapshots([t.strobe.state_bytes() for t in transcripts], device=device)

    @classmethod
    def from_snapshots(cls, snapshots: Sequence[bytes], *, device) -> "TranscriptDevice":
        """Resume from 203-byte STROBE snapshots, one per lane."""
        self = cls.__new__(cls)
        self.strobe = StrobeDevice.from_states(snapshots, device=device)
        self.B = self.strobe.B
        return self

    def run_phase(self, ops) -> list:
        """Run a list of ``("msg", label, message)`` (message: bytes or an
        (L, B) byte tensor) and ``("chal", label, nbytes)`` ops in order;
        returns the challenge tensors in order."""
        chals = []
        for kind, label, m in ops:
            if kind == "msg":
                self.append_message(label, m)
            elif kind == "chal":
                chals.append(self.challenge_bytes(label, int(m)))
            else:
                raise ValueError(f"unknown transcript op {kind!r}")
        return chals

    def append_message(self, label: bytes, message) -> None:
        """message: bytes (lane-constant) or (L, B) byte tensor."""
        L = len(message) if isinstance(message, (bytes, bytearray)) else message.shape[0]
        self.strobe.meta_ad(label + int(L).to_bytes(4, "little"), False)
        self.strobe.ad(message, False)

    def append_u64(self, label: bytes, value: int) -> None:
        self.append_message(label, int(value).to_bytes(8, "little"))

    def challenge_bytes(self, label: bytes, n: int) -> torch.Tensor:
        """-> (n, B) int32 byte tensor."""
        self.strobe.meta_ad(label + int(n).to_bytes(4, "little"), False)
        return self.strobe.prf(n)
