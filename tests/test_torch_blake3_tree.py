"""The port's device BLAKE3 tier against the JAX package, on the CPU.

``hash_leaves_device`` and ``merkle_tree_device`` (``device="cpu"``: the
``blake3`` kernel's plain version, ``compress_vec``) on seeded rows of 1,
16, 33 and 64 bytes and trees of 2, 4, 32 and 1024 leaves equal the JAX
package's functions digest for digest, and the native tier's
``blake3_batch`` and ``blake3_merkle_levels``; ``hash_element_rows(F,
rows, device="cpu")`` equals the JAX one with ``LIBZKP_DEVICE_HASH=1``.
The launches a call makes (one for the leaves, one a level, one for the
improvement batch's leaf commit) are counted at the wrapper. Rows of
unequal length raise ``ValueError`` (the JAX package hashed them with the
first row's length), a row over 64 bytes and a tree of a count that is not
a power of two above 1 raise the reference's ``AssertionError``, and the
wrapper refuses a tensor on neither a CUDA device nor the CPU.

Tolerance: every comparison is exact (digests, words).
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

from libzkp_tpu.models import merkle as jmerkle
from libzkp_tpu.ops import blake3_device as jb3d
from libzkp_tpu.ops.field import BN254_FR as JBN254_FR, F128 as JF128

from libzkp_tpu_torch import native
from libzkp_tpu_torch.models import merkle
from libzkp_tpu_torch.ops import blake3, blake3_device, kernels, stark_device as sd
from libzkp_tpu_torch.ops.field import BN254_FR, F128


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the suite runs in several worker processes at
    once, and OpenMP pools oversubscribing the cores stall each other."""
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _rows(count: int, width: int, seed: int) -> list:
    rng = np.random.default_rng(seed)
    return [rng.integers(0, 256, width, dtype=np.uint8).tobytes() for _ in range(count)]


@pytest.fixture
def launches(monkeypatch):
    """The ``blake3`` wrapper's calls: (lanes, block_len) each."""
    calls = []
    real = kernels.blake3

    def counted(m, block_len, flags):
        calls.append((m.shape[0], block_len))
        return real(m, block_len, flags)

    monkeypatch.setattr(kernels, "blake3", counted)
    return calls


@pytest.mark.parametrize("width", [1, 16, 33, 64])
def test_hash_leaves_equal_jax_and_native(width, launches):
    rows = _rows(12, width, seed=width)
    got = blake3_device.hash_leaves_device(rows, device="cpu")
    assert got == jb3d.hash_leaves_device(rows)
    assert got == native.blake3_batch(rows, width) == [blake3.blake3_256_py(r) for r in rows]
    assert launches == [(12, width)]


@pytest.mark.parametrize("count,width", [(2, 16), (4, 64), (32, 33), (1024, 16)])
def test_merkle_tree_equals_jax_and_native(count, width, launches):
    rows = _rows(count, width, seed=count)
    leaves, levels = blake3_device.merkle_tree_device(rows, device="cpu")
    want_leaves, want_levels = jb3d.merkle_tree_device(rows)
    assert (leaves, levels) == (want_leaves, want_levels)
    assert leaves == native.blake3_batch(rows, width)
    assert levels == native.blake3_merkle_levels(leaves) == merkle.MerkleTree(leaves).levels[1:]
    depth = count.bit_length() - 1
    assert [len(lv) for lv in levels] == [count >> k for k in range(1, depth + 1)]
    assert launches == [(count, width)] + [(count >> k, 64) for k in range(1, depth + 1)]


@pytest.mark.parametrize("field,jfield,elems", [(F128, JF128, 1), (F128, JF128, 4), (BN254_FR, JBN254_FR, 2)],
                         ids=["f128x1", "f128x4", "bn254x2"])
def test_hash_element_rows_device_equals_jax_device_hash(field, jfield, elems, monkeypatch):
    rng = np.random.default_rng(elems)
    rows = [[int.from_bytes(rng.bytes(32), "little") % field.p for _ in range(elems)] for _ in range(9)]
    got = merkle.hash_element_rows(field, rows, device="cpu")
    assert got == merkle.hash_element_rows(field, rows)  # the native route
    monkeypatch.setenv("LIBZKP_DEVICE_HASH", "1")
    assert got == jmerkle.hash_element_rows(jfield, rows)


def test_improvement_leaf_commit_is_one_launch(launches):
    """``coset_lde_commit_batch`` hashes a batch's leaves in one call of
    the wrapper, at block_len 16, and its digests equal the host's."""
    traces = [[(7 * b + i) % F128.p for i in range(8)] for b in range(3)]
    _, ldes, leaf_rows = sd.coset_lde_commit_batch(F128.p, traces, 8, 3, device="cpu")
    assert launches == [(3 * 64, 16)]
    assert leaf_rows == [merkle.hash_element_rows(F128, [[v] for v in lde]) for lde in ldes]


def test_unequal_rows_and_over_long_rows_raise():
    with pytest.raises(ValueError, match="rows of one length"):
        blake3_device.hash_leaves_device([b"ab", b"abc"], device="cpu")
    with pytest.raises(ValueError, match="rows of one length"):
        blake3_device.merkle_tree_device([b"ab", b"abc"], device="cpu")
    with pytest.raises(ValueError, match="rows of one length"):
        merkle.hash_element_rows(F128, [[1], [1, 2]], device="cpu")
    with pytest.raises(AssertionError, match="single-block"):
        blake3_device.hash_leaves_device([bytes(65)] * 2, device="cpu")
    with pytest.raises(AssertionError, match="single-block"):
        merkle.hash_element_rows(F128, [[1] * 5], device="cpu")  # 80 bytes
    # the host route keeps the JAX package's: unequal rows hash one by one
    assert merkle.hash_element_rows(F128, [[1], [1, 2]]) == jmerkle.hash_element_rows(JF128, [[1], [1, 2]])


@pytest.mark.parametrize("count", [0, 1, 3, 6])
def test_tree_of_no_power_of_two_raises(count):
    with pytest.raises(AssertionError, match="power-of-two"):
        blake3_device.merkle_tree_device(_rows(count, 8, seed=count), device="cpu")


def test_wrapper_plain_version_and_refusals():
    """``blake3`` on the CPU is ``blake3_plain``, the IV's compression at
    counter 0, equal to the JAX ``_compress_vec`` word for word; one
    instance, registered with its source; a tensor on neither device is
    refused."""
    import jax.numpy as jnp

    assert kernels.KERNEL_CURVES["blake3"] == (None,) and "blake3" in kernels.INSTANCES
    assert kernels.SOURCES["blake3"] == "blake3.cu" and "blake3" in kernels.LIBRARIES
    rng = np.random.default_rng(3)
    m = rng.integers(0, 1 << 32, (40, 16), dtype=np.uint64).astype(np.uint32)
    iv = np.broadcast_to(np.asarray(blake3.IV, dtype=np.uint32), (40, 8))
    for block_len, flags in ((64, blake3_device.STANDALONE), (16, blake3_device.STANDALONE), (0, 0)):
        got = kernels.blake3(torch.from_numpy(m.astype(np.int64)), block_len, flags)
        want = np.asarray(jb3d._compress_vec(jnp.asarray(iv), jnp.asarray(m), 0, block_len, flags))
        assert got.dtype == torch.int64 and np.array_equal(got.numpy(), want.astype(np.int64))
        assert torch.equal(got, kernels.blake3_plain(torch.from_numpy(m.astype(np.int64)), block_len, flags))
    with pytest.raises(ValueError, match="CUDA or CPU"):
        kernels.blake3(torch.empty((8, 16), dtype=torch.int64, device="meta"), 64, 11)
