"""Round-1 ``LZTK`` Groth16 key files in the port and the JAX package.

The port's equality key (its own setup, as ``snark_backend`` makes it),
written by hand in the ``LZTK`` container (magic, u32 version, the fields
with u32 counts and ``b_g2_query`` last), loads in both packages to the same
key; a raw arkworks key whose ``alpha_g1.x`` begins with ``b"LZTK"`` falls
through to the raw reader in both; containers that do not parse give
``None`` in both; and ``set_snark_key_dir`` on a directory of ``LZTK``
files loads them (the port raised ``ConfigError`` there before).

Tolerance: every comparison is exact (key bytes).
"""

from __future__ import annotations

import struct

import pytest
import torch

from libzkp_tpu.models import groth16 as jg

from libzkp_tpu_torch.models import groth16 as tg
from libzkp_tpu_torch.models import snark_backend as tsb
from libzkp_tpu_torch.ops import bn254 as bn


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the suite runs in several worker processes at
    once, and OpenMP pools oversubscribing the cores stall each other."""
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


@pytest.fixture(scope="module")
def pk():
    return tg.setup(tsb.build_equality_circuit(0, 0, 0))


def _g1s(points) -> bytes:
    return struct.pack("<I", len(points)) + b"".join(tg._g1_bytes(p) for p in points)


def _lztk_vk(vk) -> bytes:
    return (b"LZTK" + struct.pack("<I", 1) + tg._g1_bytes(vk.alpha_g1)
            + b"".join(tg._g2_bytes(p) for p in (vk.beta_g2, vk.gamma_g2, vk.delta_g2))
            + _g1s(vk.gamma_abc_g1))


def _lztk_pk(pk) -> bytes:
    return (_lztk_vk(pk.vk) + tg._g1_bytes(pk.beta_g1) + tg._g1_bytes(pk.delta_g1)
            + _g1s(pk.a_query) + _g1s(pk.b_g1_query) + _g1s(pk.h_query) + _g1s(pk.l_query)
            + struct.pack("<I", len(pk.b_g2_query)) + b"".join(tg._g2_bytes(p) for p in pk.b_g2_query))


def _lztk_point() -> tuple:
    """A G1 point whose x begins, little-endian, with the bytes ``LZTK``:
    the first such x with x^3 + 3 a square mod p (BN254 p = 3 mod 4)."""
    x = int.from_bytes(b"LZTK", "little")
    while True:
        rhs = (x ** 3 + 3) % bn.P
        y = pow(rhs, (bn.P + 1) // 4, bn.P)
        if y * y % bn.P == rhs:
            return (x, y, 1)
        x += 1 << 32


def test_lztk_keys_load_in_both_packages(pk):
    data, vdata = _lztk_pk(pk), _lztk_vk(pk.vk)
    ours, theirs = tg.pk_from_bytes(data), jg.pk_from_bytes(data)
    assert tg.pk_to_bytes(ours) == jg.pk_to_bytes(theirs) == tg.pk_to_bytes(pk)
    ours_vk, theirs_vk = tg.vk_from_bytes(vdata), jg.vk_from_bytes(vdata)
    assert tg.vk_to_bytes(ours_vk) == jg.vk_to_bytes(theirs_vk) == tg.vk_to_bytes(pk.vk)


def test_raw_key_beginning_with_the_magic_falls_through(pk):
    alpha = _lztk_point()
    raw = bytearray(tg.pk_to_bytes(pk))
    raw[:64] = tg._g1_bytes(alpha)
    vraw = bytearray(tg.vk_to_bytes(pk.vk))
    vraw[:64] = tg._g1_bytes(alpha)
    assert raw[:4] == vraw[:4] == b"LZTK"
    ours, theirs = tg.pk_from_bytes(bytes(raw)), jg.pk_from_bytes(bytes(raw))
    assert tg.pk_to_bytes(ours) == jg.pk_to_bytes(theirs) == bytes(raw)
    assert bn.g1_to_affine(ours.vk.alpha_g1) == alpha[:2]
    assert tg.vk_to_bytes(tg.vk_from_bytes(bytes(vraw))) == jg.vk_to_bytes(jg.vk_from_bytes(bytes(vraw))) == vraw


@pytest.mark.parametrize("cut", ["version", "truncated", "trailing"])
def test_bad_containers_load_in_neither_package(pk, cut):
    data, vdata = _lztk_pk(pk), _lztk_vk(pk.vk)
    if cut == "version":
        data, vdata = data[:4] + struct.pack("<I", 2) + data[8:], vdata[:4] + struct.pack("<I", 2) + vdata[8:]
    elif cut == "truncated":
        data, vdata = data[:-1], vdata[:-1]
    else:
        data, vdata = data + b"\x00", vdata + b"\x00"
    assert tg.pk_from_bytes(data) is None and jg.pk_from_bytes(data) is None
    assert tg.vk_from_bytes(vdata) is None and jg.vk_from_bytes(vdata) is None


def test_key_directory_of_lztk_files_loads(pk, tmp_path):
    (tmp_path / "equality_mimc_pk.bin").write_bytes(_lztk_pk(pk))
    (tmp_path / "equality_mimc_vk.bin").write_bytes(_lztk_vk(pk.vk))
    saved = tsb._equality_setup
    tsb._reset_for_tests()
    try:
        tsb.set_snark_key_dir(str(tmp_path))
        assert tg.pk_to_bytes(tsb._get_equality_setup()) == tg.pk_to_bytes(pk)
    finally:
        tsb._reset_for_tests()
        tsb._equality_setup = saved
