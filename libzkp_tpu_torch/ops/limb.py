"""12-bit Montgomery limb arithmetic mod p on torch int32 tensors.

Port of the JAX package's ``libzkp_tpu/ops/limb.py``:

* A field element is ``n`` relaxed signed 12-bit limbs in int32, shape
  ``(..., n)``, least significant limb first; ``n`` leaves at least 4 bits of
  headroom above p (22 for BN254 Fr and for 2^255 - 19).
* Relaxed representation: limbs stay in about (-2^13, 2^13) and values in
  (-Cp, Cp) between operations; only :meth:`LimbContext.decode` reduces mod p.
  Subtraction is ``a - b`` and one carry pass.
* The product is the Montgomery product a * b * R^-1 (R = 2^(12n)): the
  schoolbook columns, the REDC sweep in the JAX order (for i = 0..n-1:
  m = ((T[i] & mask) * ninv) & mask, T[i..i+n) += m * p, T[i+1] += T[i] >> 12)
  and three wrap carries of the high half. It is the ``mont_mul`` kernel
  (``csrc/mont.cu``) on a CUDA tensor and its plain version
  (:func:`~libzkp_tpu_torch.ops.kernels.mont_mul_plain`) on a CPU tensor; both
  give the JAX limbs exactly. The JAX package computes the same limbs by two
  formulations (a rolled loop on the CPU, unrolled updates on the TPU); the
  port has one.

int32 headroom: a column is a sum of at most n products of two limbs, and
REDC adds at most n * 4095 * 4095 ~= 2^28.5 more. Interval arithmetic over
the h pipeline, the MiMC rounds and the probes (one interval per limb and
step, ``tests/test_torch_limb.py::test_int32_headroom``, in Python ints)
bounds the limbs entering the product by 2^13.6 and every partial sum by
2^30.1 < 2^31.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from . import kernels
from .limbfold import (  # noqa: F401
    LIMB_BITS,
    LIMB_MASK,
    bytes_to_limb_rows,
    ints_to_limb_rows,
    limb_rows_to_ints,
)
from .limbfold import int_to_limbs as _int_to_limbs


def _limbs_to_int(limbs) -> int:
    x = 0
    for i, v in enumerate(np.asarray(limbs, dtype=np.int64).tolist()):
        x += int(v) << (LIMB_BITS * i)
    return x


class LimbContext:
    """Montgomery arithmetic mod ``p`` on 12-bit signed-limb int32 tensors.

    Invariants between ops: limbs in (-2^13, 2^13); |value| < ~8p (chains of
    additions such as NTT butterflies re-reduce with :meth:`reduce`).
    ``mont_*`` methods work in the Montgomery domain (x * R mod p).
    """

    def __init__(self, p: int, name: str = ""):
        self.p = p
        self.name = name
        self.n = (p.bit_length() + 4 + LIMB_BITS - 1) // LIMB_BITS
        n = self.n
        self.p_limbs = _int_to_limbs(p, n)
        self.ninv = (-pow(p, -1, 1 << LIMB_BITS)) % (1 << LIMB_BITS)
        self.R = pow(2, LIMB_BITS * n, p)
        self.R2 = self.R * self.R % p
        self.r2_limbs = _int_to_limbs(self.R2, n)
        self.one_mont = _int_to_limbs(self.R % p, n)
        ninv_row = np.zeros(n, dtype=np.int32)
        ninv_row[0] = self.ninv
        # the kernels' consts block: p, R mod p, ninv
        self.consts_np = np.stack([self.p_limbs, self.one_mont, ninv_row])
        self._tensors: dict = {}

    def tensor(self, name: str, device) -> torch.Tensor:
        """A constant on ``device``: ``consts`` (the kernels' (3, n) block),
        ``r2``, ``one_mont`` or ``one`` (the integer 1)."""
        key = (name, torch.device(device))
        t = self._tensors.get(key)
        if t is None:
            one = np.zeros(self.n, dtype=np.int32)
            one[0] = 1
            arr = {"consts": self.consts_np, "r2": self.r2_limbs, "one_mont": self.one_mont,
                   "one": one}[name]
            t = self._tensors[key] = torch.from_numpy(np.array(arr)).to(device)
        return t

    # -- host <-> device codecs -------------------------------------------
    def encode(self, values, *, device="cpu") -> torch.Tensor:
        """Python ints -> (B, n) canonical limbs (vectorised)."""
        rows = ints_to_limb_rows([int(v) % self.p for v in values], self.n)
        return torch.from_numpy(rows).to(device)

    def encode_bytes(self, buf: bytes, *, device="cpu") -> torch.Tensor:
        """Canonical 32-byte little-endian values -> (B, n) canonical limbs,
        as :meth:`encode` gives them, with no Python ints between."""
        return torch.from_numpy(bytes_to_limb_rows(buf, 32, self.n)).to(device)

    def encode_scalar(self, value: int, *, device="cpu") -> torch.Tensor:
        return self.encode([value], device=device)[0]

    def decode(self, t: torch.Tensor) -> list:
        """(..., n) relaxed limbs -> canonical Python ints (mod p)."""
        return limb_rows_to_ints(t.cpu().numpy().reshape(-1, self.n), self.p)

    # -- carry handling (value-preserving, no scans) -----------------------
    def _carry_pass(self, x: torch.Tensor) -> torch.Tensor:
        """One parallel carry: (x & mask) + (x >> 12 shifted up one limb),
        the carry out of the top limb folded back in as R mod p."""
        return kernels.mont_carry(x, self.tensor("one_mont", x.device))

    def _relax(self, x: torch.Tensor) -> torch.Tensor:
        """Columns |.| < 2^31 -> relaxed limbs: 3 passes."""
        return self._carry_pass(self._carry_pass(self._carry_pass(x)))

    # -- ring ops ------------------------------------------------------------
    def add(self, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        return self._carry_pass(a + b)

    def sub(self, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        return self._carry_pass(a - b)

    def neg(self, a: torch.Tensor) -> torch.Tensor:
        return self._carry_pass(-a)

    def mont_mul(self, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        """Montgomery product a * b * R^-1 (relaxed in, relaxed out); ``b``
        broadcasts over ``a``'s leading axes."""
        return kernels.mont_mul(self.tensor("consts", a.device), a.contiguous(), b.contiguous())

    def to_mont(self, a: torch.Tensor) -> torch.Tensor:
        return self.mont_mul(a, self.tensor("r2", a.device))

    def from_mont(self, a: torch.Tensor) -> torch.Tensor:
        """Times the integer 1, not R mod p: leaves the Montgomery domain."""
        return self.mont_mul(a, self.tensor("one", a.device))

    def reduce(self, a: torch.Tensor) -> torch.Tensor:
        """Bring a Montgomery-domain value back into (-p, 2p): x * R * R^-1."""
        return self.mont_mul(a, self.tensor("one_mont", a.device))

    # -- derived ops ---------------------------------------------------------
    def mont_pow5(self, a: torch.Tensor) -> torch.Tensor:
        a2 = self.mont_mul(a, a)
        a4 = self.mont_mul(a2, a2)
        return self.mont_mul(a4, a)


@functools.lru_cache(maxsize=None)
def get_context(p: int, name: str = "") -> LimbContext:
    return LimbContext(p, name)
