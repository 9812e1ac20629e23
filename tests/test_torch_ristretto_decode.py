"""The port's Ristretto255 decode and batched encode against the JAX package,
on the CPU.

``_decompress_impl`` (``ops/ristretto.py``) on the same canonical s limbs
gives the JAX ``_decompress_impl``'s ``ok`` and x, y, t limbs exactly, on
the 17 encodings of ``tests/test_ristretto_device.py`` and on crafted ones:
s >= p (reduced mod p, as the wrapper's limbs are), an odd s, a value whose
decode is no square, and 1 - s^2 = 0. ``ristretto_decompress_device`` and
``ristretto_compress_device`` (``device="cpu"``) equal the JAX wrappers and
the host ``ed25519.decompress`` / ``compress`` lane for lane, ``None``
included, and the round trip holds.

Tolerance: every comparison is exact (limbs, flags, ints, bytes).
"""

from __future__ import annotations

import random

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from libzkp_tpu.ops import curve_jax as jcj

from libzkp_tpu_torch.ops import ed25519 as ed
from libzkp_tpu_torch.ops import ristretto
from libzkp_tpu_torch.ops.curve import edwards_engine


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the suite runs in several worker processes at
    once, and OpenMP pools oversubscribing the cores stall each other."""
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _reference_encodings() -> list:
    """The 17 encodings of ``tests/test_ristretto_device.py``."""
    random.seed(9)
    encs = [ed.compress(ed.scalar_mul(random.randrange(1, ed.L), ed.BASEPOINT)) for _ in range(12)]
    return encs + [b"\x00" * 32, b"\x01" + b"\x00" * 31, bytes(range(32)), b"\xff" * 32, b"\x12" * 31]


def _not_square_encoding() -> bytes:
    """The first even s whose decode finds no square root: v * u2^2 is no
    square mod p, v = -(d * u1^2) - u2^2, u1 = 1 - s^2, u2 = 1 + s^2."""
    s = 2
    while True:
        u1, u2 = (1 - s * s) % ed.P, (1 + s * s) % ed.P
        v = (-ed.D * u1 * u1 - u2 * u2) % ed.P
        if pow(v * u2 * u2 % ed.P, (ed.P - 1) // 2, ed.P) == ed.P - 1:
            return s.to_bytes(32, "little")
        s += 2


def _crafted() -> list:
    return [
        (ed.P + 2).to_bytes(32, "little"),      # s >= p: rejected on the host
        (ed.P - 1).to_bytes(32, "little"),      # even, the largest canonical s
        (12345).to_bytes(32, "little"),         # odd s
        _not_square_encoding(),
        (1).to_bytes(32, "little"),             # 1 - s^2 = 0 (odd anyway)
        ed.compress(ed.BASEPOINT),
        ed.compress(ed.IDENTITY),
        b"",                                    # wrong length
    ]


ENCODINGS = _reference_encodings() + _crafted()


def test_crafted_cases_cover_the_rejections():
    want = [ed.decompress(e) for e in _crafted()]
    assert [w is None for w in want] == [True, True, True, True, True, False, False, True]


def test_decompress_impl_limbs_equal_jax():
    """``ok`` and the x, y, t limbs of every lane, from the wrapper's s
    limbs (each 32-byte string's value mod p; the host pre-check aside)."""
    ctx = edwards_engine().ctx
    vals = [int.from_bytes(e, "little") % ed.P for e in ENCODINGS if len(e) == 32]
    s_np = np.ascontiguousarray(ctx.encode_ints(vals).T)
    consts = ristretto._compress_consts()
    got = ristretto._decompress_impl(torch.from_numpy(consts), torch.from_numpy(s_np))
    want = jcj._decompress_impl(jnp.asarray(consts), jnp.asarray(s_np))
    for name, g, w in zip(("ok", "x", "y", "t"), got, want):
        w = np.asarray(w)
        assert g.numpy().dtype == w.dtype and np.array_equal(g.numpy(), w), name
    assert got[0].any() and not got[0].all()


def test_decompress_wrapper_equals_jax_and_host():
    got = ristretto.ristretto_decompress_device(ENCODINGS, device="cpu")
    assert got == jcj.ristretto_decompress_device(ENCODINGS)
    assert got == [ed.decompress(e) for e in ENCODINGS]
    assert sum(g is None for g in got) == 10  # 4 of the 17, 6 crafted


def test_compress_wrapper_equals_jax_and_host():
    random.seed(7)
    pts = [ed.IDENTITY, ed.BASEPOINT] + [ed.scalar_mul(random.randrange(1, ed.L), ed.BASEPOINT)
                                         for _ in range(10)]
    lam = random.randrange(2, ed.P)  # another representative of the last point
    pts.append(tuple(c * lam % ed.P for c in pts[-1]))
    got = ristretto.ristretto_compress_device(pts, device="cpu")
    assert got == jcj.ristretto_compress_device(pts) == [ed.compress(p) for p in pts]
    assert got[-1] == got[-2]


def test_round_trip():
    random.seed(10)
    pts = [ed.scalar_mul(random.randrange(1, ed.L), ed.BASEPOINT) for _ in range(8)]
    back = ristretto.ristretto_decompress_device(ristretto.ristretto_compress_device(pts, device="cpu"),
                                                 device="cpu")
    assert all(q is not None and ed.ristretto_eq(p, q) for p, q in zip(pts, back))
    assert ristretto.ristretto_decompress_device([], device="cpu") == []
