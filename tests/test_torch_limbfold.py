"""The port's fold-field engine against the JAX package's, limb for limb.

Same relaxed inputs (|limb| up to ~2^13.1, made by numpy from a seed) through
``libzkp_tpu.ops.limbfold.FieldOps`` and ``libzkp_tpu_torch.ops.limbfold.FieldOps``;
every op must give identical int32 limbs (exact: integer arithmetic).
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from libzkp_tpu.ops import limbfold as jl
from libzkp_tpu.ops.field import BN254_FQ, ED25519_FP, RISTRETTO_L
from libzkp_tpu_torch.ops import limbfold as tl

PRIMES = {"p25519": ED25519_FP.p, "l": RISTRETTO_L.p, "bn254_fq": BN254_FQ.p}
RELAXED = 8800  # ~2^13.1


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the suite runs in several worker processes at
    once, and OpenMP pools oversubscribing the cores stall each other."""
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _pair(p):
    ctx = jl.get_fold_ctx(p)
    consts = ctx.consts_block()
    return (ctx.n, jl.FieldOps(ctx.n, jnp.asarray(consts)),
            tl.FieldOps(ctx.n, torch.from_numpy(consts)))


def _relaxed(n, seed, lead=(3,), lanes=16):
    rng = np.random.default_rng(seed)
    return rng.integers(-RELAXED, RELAXED, size=(*lead, n, lanes), dtype=np.int32)


@pytest.mark.parametrize("prime", sorted(PRIMES))
def test_ctx_constants_match(prime):
    p = PRIMES[prime]
    a, b = jl.get_fold_ctx(p), tl.get_fold_ctx(p)
    assert a.n == b.n == 24
    assert (a.consts_block() == b.consts_block()).all()
    vals = [0, 1, p - 1, p // 3, (1 << 200) + 12345]
    assert (a.encode_ints(vals) == b.encode_ints(vals)).all()
    assert b.decode(b.encode_ints(vals)) == [v % p for v in vals]


@pytest.mark.parametrize("op", ["add", "sub", "mul"])
@pytest.mark.parametrize("prime", sorted(PRIMES))
def test_binary_ops_match_jax(prime, op):
    n, fj, ft = _pair(PRIMES[prime])
    a, b = _relaxed(n, 1), _relaxed(n, 2)
    want = np.asarray(getattr(fj, op)(jnp.asarray(a), jnp.asarray(b)))
    got = getattr(ft, op)(torch.from_numpy(a), torch.from_numpy(b)).numpy()
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("prime", sorted(PRIMES))
def test_carry_and_smul_match_jax(prime):
    n, fj, ft = _pair(PRIMES[prime])
    wide = _relaxed(n, 3) * 300  # columns well above the relaxed bound
    np.testing.assert_array_equal(
        ft.carry(torch.from_numpy(wide)).numpy(), np.asarray(fj.carry(jnp.asarray(wide)))
    )
    a = _relaxed(n, 4)
    for k in (9, -3, 1 << 15):
        np.testing.assert_array_equal(
            ft.smul(torch.from_numpy(a), k).numpy(), np.asarray(fj.smul(jnp.asarray(a), k))
        )


@pytest.mark.parametrize("prime", sorted(PRIMES))
def test_mul_chain_values(prime):
    """A chain of products stays relaxed and decodes to the right values."""
    p = PRIMES[prime]
    n, fj, ft = _pair(p)
    ctx = tl.get_fold_ctx(p)
    rng = np.random.default_rng(5)
    xs = [int.from_bytes(rng.bytes(40), "little") % p for _ in range(8)]
    x = torch.from_numpy(np.ascontiguousarray(ctx.encode_ints(xs).T))
    acc, acc_j = x, jnp.asarray(x.numpy())
    for _ in range(6):
        acc = ft.mul(acc, x)
        acc_j = fj.mul(acc_j, jnp.asarray(x.numpy()))
    np.testing.assert_array_equal(acc.numpy(), np.asarray(acc_j))
    assert int(acc.abs().max()) < RELAXED
    assert ctx.decode(acc.numpy().T) == [pow(v, 7, p) for v in xs]


@pytest.mark.parametrize("lead, lanes", [((), 1), ((3,), 16), ((2, 5), 7)])
def test_schoolbook_formulations_agree(lead, lanes):
    """The CPU's row-by-row columns equal the outer product's, which the
    CUDA path runs, limb for limb, with limbs up to the relaxed bound and a
    little past it."""
    n = 24
    rng = np.random.default_rng(6)
    for bound in (RELAXED, 9000):
        a = torch.from_numpy(rng.integers(-bound, bound, size=(*lead, n, lanes), dtype=np.int32))
        b = torch.from_numpy(rng.integers(-bound, bound, size=(*lead, n, lanes), dtype=np.int32))
        rows, outer = tl.schoolbook_rows(a, b, n), tl.schoolbook_outer(a, b, n)
        assert rows.shape == outer.shape == (*lead, 2 * n + 2, lanes)
        assert torch.equal(rows, outer)
        assert not outer[..., 2 * n - 1 :, :].any()
