"""The port's mod-l device engine against the JAX package's, on the five
cases of ``tests/test_scalar_device.py``: limbs and digit rows must be
identical to the JAX functions', and the values right."""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from libzkp_tpu.ops import scalar_device as jsd
from libzkp_tpu_torch import convert
from libzkp_tpu_torch.ops import scalar_device as sd

L = sd.L_ORDER
B = 8


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the suite runs in several worker processes at
    once, and OpenMP pools oversubscribing the cores stall each other."""
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


@pytest.fixture(scope="module")
def fields():
    jc, tc = jsd.get_scalar_ctx(), sd.get_scalar_ctx()
    assert (jc.consts_np == tc.consts_np).all()
    return (jc, jc.field(jnp.asarray(jc.consts_np)),
            tc, tc.field(convert.consts_block(tc.consts_np, device="cpu")))


def _enc(ctx, vals):
    return np.ascontiguousarray(np.transpose(ctx.encode(vals), (1, 0)))  # (n, B)


def _windows_value(col):
    v = 0
    for row in col:
        v = (v << 8) + int(row)
    return v


def test_mul_add_inv(fields):
    jc, fj, tc, ft = fields
    rng = np.random.default_rng(1)
    xs = [int.from_bytes(rng.bytes(32), "little") % L for _ in range(B)]
    ys = [int.from_bytes(rng.bytes(32), "little") % L for _ in range(B)]
    X, Y = _enc(tc, xs), _enc(tc, ys)
    Xt, Yt = torch.from_numpy(X), torch.from_numpy(Y)
    assert tc.decode(ft.mul(Xt, Yt).numpy().T) == [x * y % L for x, y in zip(xs, ys)]
    assert tc.decode(ft.add(Xt, Yt).numpy().T) == [(x + y) % L for x, y in zip(xs, ys)]
    inv = sd.inv_device(ft, Xt)
    np.testing.assert_array_equal(inv.numpy(), np.asarray(jsd.inv_device(fj, jnp.asarray(X))))
    assert tc.decode(inv.numpy().T) == [pow(x, -1, L) for x in xs]


def test_digit_windows_represent_value_mod_l(fields):
    jc, fj, tc, ft = fields
    rng = np.random.default_rng(2)
    xs = [int.from_bytes(rng.bytes(32), "little") % L for _ in range(B)]
    X = _enc(tc, xs)
    # ring ops first so the input limbs are RELAXED
    X2 = ft.sub(ft.mul(torch.from_numpy(X), torch.from_numpy(X)), torch.from_numpy(X))
    want = [(x * x - x) % L for x in xs]
    dw = sd.strict_digit_windows(ft, tc, X2).numpy()  # (32, B) high first
    np.testing.assert_array_equal(dw, np.asarray(jsd.strict_digit_windows(fj, jc, jnp.asarray(X2.numpy()))))
    assert dw.min() >= 0 and dw.max() <= 255
    for b in range(B):
        assert _windows_value(dw[:, b]) % L == want[b], f"lane {b}"


def test_digit_windows_vector_shape(fields):
    """(K, n, B) scalar vectors -> (32, K, B) windows, all lanes correct."""
    jc, fj, tc, ft = fields
    rng = np.random.default_rng(3)
    K = 4
    vals = [[int.from_bytes(rng.bytes(32), "little") % L for _ in range(B)] for _ in range(K)]
    stacked = np.stack([_enc(tc, v) for v in vals], axis=0)  # (K, n, B)
    dw = sd.strict_digit_windows(ft, tc, torch.from_numpy(stacked)).numpy()
    np.testing.assert_array_equal(dw, np.asarray(jsd.strict_digit_windows(fj, jc, jnp.asarray(stacked))))
    assert dw.shape == (32, K, B)
    for k in range(K):
        for b in range(B):
            assert _windows_value(dw[:, k, b]) % L == vals[k][b]


def test_reduce_wide_matches_int(fields):
    jc, fj, tc, ft = fields
    rng = np.random.default_rng(4)
    raws = [rng.bytes(64) for _ in range(B)]
    rows = np.zeros((64, B), dtype=np.int32)
    for b, r in enumerate(raws):
        rows[:, b] = np.frombuffer(r, dtype=np.uint8)
    out = sd.reduce_wide(ft, tc, torch.from_numpy(rows))
    want_limbs = np.asarray(jsd.reduce_wide(fj, jc, jnp.asarray(rows.astype(np.uint32))))
    np.testing.assert_array_equal(out.numpy(), want_limbs)
    assert tc.decode(out.numpy().T) == [int.from_bytes(r, "little") % L for r in raws]


def test_digit_windows_adversarial_values(fields):
    """Worst cases for the strict normalization: saturated top limbs, values
    next to multiples of l, and the prover's 64-term relaxed sums."""
    jc, fj, tc, ft = fields
    special = [
        0, 1, L - 1, L - 2, (1 << 252) - 1, 1 << 252, (1 << 252) + 1,
        sd.DELTA, L - sd.DELTA,
        int("fff" * 21, 16) % L,  # all-0xFFF limb pattern
        (1 << 251) + (1 << 128),
    ]
    rng = np.random.default_rng(5)
    special += [int.from_bytes(rng.bytes(32), "little") % L for _ in range(5)]
    X = torch.from_numpy(_enc(tc, special))
    # a 64-term product sum followed by three carries (the prover's exact
    # pattern), then one more product
    summed = torch.stack([ft.mul(X, X) for _ in range(64)], dim=0).sum(0, dtype=torch.int32)
    relaxed = ft.mul(ft.carry(ft.carry(ft.carry(summed))), X)
    want = [pow(x, 2, L) * 64 % L * x % L for x in special]
    dw = sd.strict_digit_windows(ft, tc, relaxed).numpy()
    np.testing.assert_array_equal(
        dw, np.asarray(jsd.strict_digit_windows(fj, jc, jnp.asarray(relaxed.numpy())))
    )
    assert dw.min() >= 0 and dw.max() <= 255
    for b, x in enumerate(special):
        assert _windows_value(dw[:, b]) % L == want[b], f"value {x:#x}"
