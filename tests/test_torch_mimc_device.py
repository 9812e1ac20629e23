"""The port's device MiMC batch against the JAX package: the Montgomery
round constants, the limbs of ``mimc_batch_device``, and the digests of
``mimc_hash_batch`` on one device and split over a dp 2 mesh, all equal to
the JAX package's and to the host ``mimc_hash_native``."""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from libzkp_tpu.ops import mimc as jmimc
from libzkp_tpu_torch import convert
from libzkp_tpu_torch import mimc_hash_batch
from libzkp_tpu_torch.ops import kernels
from libzkp_tpu_torch.ops import mimc as tmimc
from libzkp_tpu_torch.ops.field import BN254_FR
from libzkp_tpu_torch.ops.limb import get_context
from libzkp_tpu_torch.parallel import mesh as meshmod

VALUES = [0, 1, 42, 43, 2**64 - 1, 123456789]  # tests/test_mimc.py's


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the suite runs in several worker processes at
    once, and OpenMP pools oversubscribing the cores stall each other."""
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def test_mont_constants_equal_jax():
    want = convert.limb_table(jmimc._mont_constants(), device="cpu")
    assert torch.equal(torch.from_numpy(tmimc._mont_constants()), want)
    assert tuple(want.shape) == (tmimc.MIMC_ROUNDS, 22)


def test_mimc_hash_batch_equals_jax_and_host():
    got = mimc_hash_batch(VALUES, device="cpu")
    assert got == jmimc.mimc_hash_batch(VALUES)
    assert got == [tmimc.mimc_hash_native(v) for v in VALUES]
    assert mimc_hash_batch([], device="cpu") == []
    assert not any(kernels.launches().values())  # the CPU runs the plain versions


def test_mimc_hash_batch_on_a_dp2_mesh():
    """Split over the two dp positions of a CPU mesh (an odd count, so the
    blocks differ in size): the same digests."""
    mesh = meshmod.get_mesh(dp=2, devices=["cpu"] * 2)
    vals = VALUES + [7]
    assert mimc_hash_batch(vals, device="cpu", mesh=mesh) == [tmimc.mimc_hash_native(v) for v in vals]
    assert mimc_hash_batch(VALUES[:1], device="cpu", mesh=mesh) == [tmimc.mimc_hash_native(0)]


def test_mimc_hash_batch_rejects_a_mesh_of_another_device_type():
    mesh = meshmod.get_mesh(dp=2, devices=["meta"] * 2)
    with pytest.raises(ValueError, match="mesh is on meta"):
        mimc_hash_batch(VALUES, device="cpu", mesh=mesh)


def test_mimc_batch_device_exact_limbs_vs_jax(monkeypatch):
    """Canonical limbs in, the JAX ``mimc_batch_device`` limbs out, with
    332 products (to_mont, 110 rounds of 3, from_mont)."""
    ctx = get_context(BN254_FR.p, "bn254_fr")
    rows = ctx.encode(VALUES)
    calls = []
    orig = kernels.mont_mul
    monkeypatch.setattr(kernels, "mont_mul", lambda *a: calls.append(1) or orig(*a))
    got = tmimc.mimc_batch_device(rows)
    assert len(calls) == 332
    np.testing.assert_array_equal(got.numpy(), np.asarray(jmimc.mimc_batch_device(jnp.asarray(rows.numpy()))))
