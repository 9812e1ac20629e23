"""The port's device NTT tier and Groth16 h pipeline against the JAX package:
the twiddle, bit-reversal and h tables equal the JAX arrays (through
``convert.limb_table``); ``ntt_device`` and the h program give the JAX limbs
exactly; ``h_batch_device`` equals the JAX ``h_batch_device`` and the port's
host h on real equality assignments."""

from __future__ import annotations

import random
from types import SimpleNamespace

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from libzkp_tpu.ops import groth16_device as jg16
from libzkp_tpu.ops import limb as jlimb
from libzkp_tpu.ops import ntt as jntt
from libzkp_tpu_torch import convert
from libzkp_tpu_torch.models import groth16 as tg
from libzkp_tpu_torch.models import snark_backend as tsb
from libzkp_tpu_torch.ops import groth16_device as tg16
from libzkp_tpu_torch.ops import kernels
from libzkp_tpu_torch.ops import ntt as tntt
from libzkp_tpu_torch.ops.field import BN254_FR
from libzkp_tpu_torch.ops.limb import get_context
from libzkp_tpu_torch.utils.commitment import commit_value_snark

P = BN254_FR.p


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the suite runs in several worker processes at
    once, and OpenMP pools oversubscribing the cores stall each other."""
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _ctxs():
    return jlimb.get_context(P, "bn254_fr"), get_context(P, "bn254_fr")


@pytest.mark.parametrize("n", [8, 64, 512, 1024])
def test_tables_equal_jax(n):
    for invert in (False, True):
        want = convert.limb_table(jntt._twiddle_table(P, n, invert), device="cpu")
        assert torch.equal(torch.from_numpy(tntt._twiddle_table(P, n, invert)), want)
    np.testing.assert_array_equal(tntt._bitrev_indices(n), jntt._bitrev_indices(n))
    for ours, theirs in zip(tg16._h_tables(n, 5), jg16._h_tables(n, 5)):
        assert torch.equal(torch.from_numpy(ours), convert.limb_table(theirs, device="cpu"))


@pytest.mark.parametrize("n", [8, 64, 512, 1024])
def test_ntt_device_exact_limbs_vs_jax(n):
    """Forward and inverse over a batch of two: the JAX ``ntt_batch`` limbs,
    decoding to the host NTT."""
    jc, tc = _ctxs()
    rng = random.Random(n)
    vals = [rng.randrange(P) for _ in range(2 * n)]
    xt = tc.to_mont(tc.encode(vals)).reshape(2, n, tc.n)
    xj = jc.to_mont(jc.encode(vals)).reshape(2, n, jc.n)
    for invert in (False, True):
        got = tntt.ntt_device(tc, xt, invert)
        np.testing.assert_array_equal(got.numpy(), np.asarray(jntt.ntt_batch(jc, xj, invert)))
        host = [v for k in range(2) for v in tntt.ntt(BN254_FR, vals[k * n:(k + 1) * n], invert)]
        assert tc.decode(tc.from_mont(got)) == host
    assert torch.equal(tntt.ntt_batch(tc, xt), tntt.ntt_device(tc, xt))


def test_h_body_exact_limbs_vs_jax_h_jitted():
    """The h program on random limbs at n = 64 (the degree check comes after
    it, so any input will do): the limbs of the JAX ``_h_jitted(64, 5)``."""
    _, tc = _ctxs()
    abc = np.random.default_rng(64).integers(0, 4096, (6, 64, tc.n), dtype=np.int32)
    tables = tg16._device_h_tables(64, 5, torch.device("cpu"))
    got = tg16.h_body(tc, torch.from_numpy(abc), *tables)
    np.testing.assert_array_equal(got.numpy(), np.asarray(jg16._h_jitted(64, 5)(jnp.asarray(abc))))


def test_h_body_makes_43_products_at_512(monkeypatch):
    """The launch count chip_smoke holds the Groth16 path to: 43 mont_mul
    calls per h batch at n = 512 (13 per inverse NTT, 11 for the forward
    one, to_mont, two coset shifts, two pointwise products, from_mont)."""
    calls = []
    orig = kernels.mont_mul
    monkeypatch.setattr(kernels, "mont_mul", lambda *a: calls.append(1) or orig(*a))
    _, tc = _ctxs()
    abc = torch.zeros((3, 512, tc.n), dtype=torch.int32)
    tg16.h_body(tc, abc, *tg16._device_h_tables(512, 5, torch.device("cpu")))
    assert len(calls) == 43


def _assignments(values):
    num_instance, csr = tsb._equality_shape()
    zs = [tsb._equality_assignment(v, v, int.from_bytes(commit_value_snark(v), "little"))
          for v in values]
    return num_instance, csr, zs


def _rows(abc):
    """(az, bz, cz) as the 32-byte little-endian rows ``h_batch_device``
    takes."""
    return tuple(b"".join(v.to_bytes(32, "little") for v in vec) for vec in abc)


def test_h_batch_device_equals_jax_and_host():
    """Three real equality assignments (az, bz, cz from the port's sparse
    products) at n = 512: the JAX ``h_batch_device`` and the port's host
    ``_h_from_csr``; the batch prover's ``_h_many`` (the native sparse
    products' rows) gives the same h."""
    num_instance, csr, zs = _assignments([3, 77, (1 << 64) - 1])
    abc = [tg._abc_from_csr(512, num_instance, csr, z) for z in zs]
    args = ([t[0] for t in abc], [t[1] for t in abc], [t[2] for t in abc])
    got = tg16.h_batch_device(512, [_rows(t) for t in abc], device="cpu")
    assert got == jg16.h_batch_device(512, *args)
    assert got == [tg._h_from_csr(512, num_instance, csr, z) for z in zs]
    key = SimpleNamespace(h_query=[None] * 511)  # _h_many reads the domain size off the key
    assert tg._h_many(key, zs, num_instance, csr, device="cpu") == got


def test_h_batch_device_rejects_unsatisfied_assignment():
    """An assignment that breaks a constraint leaves h of degree n - 1: the
    device h raises as the host h does."""
    num_instance, csr, zs = _assignments([5])
    z = list(zs[0])
    z[-1] = (z[-1] + 1) % P
    abc = tg._abc_from_csr(512, num_instance, csr, z)
    with pytest.raises(AssertionError, match="degree"):
        tg16.h_batch_device(512, [_rows(abc)], device="cpu")
    with pytest.raises(AssertionError, match="degree"):
        tg._h_from_csr(512, num_instance, csr, z)
