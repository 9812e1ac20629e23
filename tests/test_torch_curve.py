"""The port's Edwards engine, MSM kernels' plain versions, table build, MSM
window loop and Ristretto compression against the JAX package.

The JAX side runs as its own tests run it on the CPU: each Pallas factory
returns its jnp branch. Limbs must be identical wherever the operation order
is the same; the MSM and the encodings must equal the host golden values.
"""

from __future__ import annotations

import random

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from libzkp_tpu.ops import curve_jax as cj
from libzkp_tpu.ops import ed25519 as jed
from libzkp_tpu_torch import convert
from libzkp_tpu_torch.ops import curve as tc
from libzkp_tpu_torch.ops import ed25519 as ed
from libzkp_tpu_torch.ops import kernels
from libzkp_tpu_torch.ops import ristretto


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the suite runs in several worker processes at
    once, and OpenMP pools oversubscribing the cores stall each other."""
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _rand_points(rng, k):
    return [ed.from_uniform_bytes(rng.randbytes(64)) for _ in range(k)]


def _lanes(enc):
    """(B, C, n) -> (C, n, B)."""
    return np.ascontiguousarray(np.transpose(enc, (1, 2, 0)))


@pytest.fixture(scope="module")
def engines():
    ej, et = cj.edwards_engine(), tc.edwards_engine()
    assert (ej.consts_np == et.consts_np).all()
    return ej, et, jnp.asarray(ej.consts_np), torch.from_numpy(et.consts_np)


@pytest.fixture(scope="module")
def small_tables(engines):
    """A 6-point basis: JAX table (Kp = 8) and the port's plain-K3 build."""
    ej, et, cj_consts, _ = engines
    pts = _rand_points(random.Random(11), 6)
    base = et.encode_points(pts)
    assert (base == ej.encode_points(pts)).all()
    ours = tc.DeviceTable(base, device="cpu")
    padded = np.concatenate(
        [base, np.broadcast_to(ej.identity_np()[None], (ours.Kp - 6, 4, ej.n))], axis=0
    )
    theirs = np.asarray(cj._table_build_jit("ed25519", ours.Kp)(cj_consts, jnp.asarray(padded)))
    return pts, base, ours, theirs


def test_padd_pdouble_limbs_and_identities(engines):
    ej, et, cj_consts, ct = engines
    pts = _rand_points(random.Random(1), 4)
    qts = pts[1:] + pts[:1]
    P, Q = _lanes(et.encode_points(pts)), _lanes(et.encode_points(qts))
    got = et.padd(ct, torch.from_numpy(P), torch.from_numpy(Q))
    np.testing.assert_array_equal(got.numpy(), np.asarray(ej.padd(cj_consts, jnp.asarray(P), jnp.asarray(Q))))
    # relaxed inputs: double the sums
    dbl = et.pdouble(ct, got)
    np.testing.assert_array_equal(dbl.numpy(), np.asarray(ej.pdouble(cj_consts, jnp.asarray(got.numpy()))))
    decoded = et.decode_points(np.transpose(got.numpy(), (2, 0, 1)))
    for i in range(4):
        assert ed.point_equal(decoded[i], ed.point_add(pts[i], qts[i]))
    # complete law: P+P == double(P); P+identity == P
    Pt = torch.from_numpy(P)
    ident = et.identity(4, "cpu")
    for out, want in (
        (et.padd(ct, Pt, Pt), [ed.point_double(p) for p in pts]),
        (et.pdouble(ct, Pt), [ed.point_double(p) for p in pts]),
        (et.padd(ct, Pt, ident), pts),
    ):
        for g, w in zip(et.decode_points(np.transpose(out.numpy(), (2, 0, 1))), want):
            assert ed.point_equal(g, w)


def test_table_build_matches_jax_limbs(small_tables):
    _, _, ours, theirs = small_tables
    assert ours.table.dtype == torch.int16
    np.testing.assert_array_equal(ours.table.numpy(), theirs)


def test_window_sum_plain_matches_jax(engines, small_tables):
    _, _, cj_consts, ct = engines
    _, base, ours, theirs = small_tables
    B = 8
    dig = np.random.default_rng(0).integers(0, 256, size=(ours.Kp, B)).astype(np.int32)
    jt = cj.DeviceTable("ed25519", base)  # the JAX table, fed to the port below
    want = np.asarray(cj._window_fused_call("ed25519", ours.Kp, B)(
        cj_consts, jt.table_int8_packed, jnp.asarray(dig)))
    table = convert.multiples_table(np.asarray(jt.table), 6, device="cpu")
    got = kernels.window_sum(ct, table.table, torch.from_numpy(dig))
    np.testing.assert_array_equal(got.numpy(), want)


def test_horner_and_pair_add_plain_match_jax(engines, small_tables):
    _, _, cj_consts, ct = engines
    _, _, ours, _ = small_tables
    rows = ours.table.view(ours.Kp, 256, 4, -1)
    acc = rows[:, 77].permute(1, 2, 0).to(torch.int32).contiguous()
    w = rows[:, 201].permute(1, 2, 0).to(torch.int32).contiguous()
    Kp = ours.Kp
    want_h = np.asarray(cj._horner_call("ed25519", Kp)(cj_consts, jnp.asarray(acc.numpy()), jnp.asarray(w.numpy())))
    np.testing.assert_array_equal(kernels.horner(ct, acc, w).numpy(), want_h)
    want_a = np.asarray(cj._pair_add_call("ed25519", Kp)(cj_consts, jnp.asarray(acc.numpy()), jnp.asarray(w.numpy())))
    np.testing.assert_array_equal(kernels.pair_add(ct, acc, w).numpy(), want_a)
    assert not any(kernels.launches().values())


def test_basis_table_decodes_to_host_table():
    """The 130-point prover basis built by the plain table-add chain holds
    the same points as the JAX package's host-built table."""
    from libzkp_tpu_torch.models import bp_device as tbp

    pts = tbp._basis_points(64)
    assert len(pts) == 130
    ours = tbp._basis_table(64, torch.device("cpu"))
    assert (ours.K, ours.Kp) == (130, 160)
    host = cj._host_table("ed25519", list(pts), ours.Kp)  # canonical limbs
    eng = tc.edwards_engine()
    got = eng.decode_points(ours.table.numpy())
    want = eng.decode_points(host)
    assert len(got) == len(want) == 160 * 256
    assert all(ed.point_equal(g, w) for g, w in zip(got, want))


def test_msm_matches_host(small_tables):
    pts, _, ours, _ = small_tables
    rng = random.Random(7)
    vecs = [[rng.randrange(ed.L) for _ in range(6)] for _ in range(5)]
    vecs[0] = [0] * 6  # all-zero vector -> identity
    vecs[1][3] = 0
    for sv, g in zip(vecs, tc.msm_many(ours, vecs)):
        want = ed.msm(sv, pts)
        assert ed.point_equal(g, want)
        assert ed.compress(g) == jed.compress(want)


def test_compress_matches_jax_limbs_and_host_bytes(engines):
    ej, et, _, _ = engines
    rng = random.Random(3)
    pts = _rand_points(rng, 6) + [ed.IDENTITY, ed.BASEPOINT]
    # scaled representatives (Z != 1) exercise the projective path
    pts = [tuple(c * 7 % ed.P for c in p) for p in pts]
    enc = _lanes(et.encode_points(pts))
    consts = ristretto._compress_consts()
    assert (consts == cj._compress_consts()).all()
    want = np.asarray(cj._compress_impl(jnp.asarray(consts), jnp.asarray(enc)))
    got = ristretto._compress_impl(convert.consts_block(consts, device="cpu"), torch.from_numpy(enc))
    np.testing.assert_array_equal(got.numpy(), want)
    encodings = [int(s).to_bytes(32, "little") for s in et.ctx.decode(got.numpy().T)]
    assert encodings == [jed.compress(p) for p in pts]


def test_wrappers_take_cpu_or_cuda_only():
    """A tensor on neither device is refused before any build or launch."""
    eng = tc.edwards_engine()
    consts = torch.empty(eng.consts_np.shape, dtype=torch.int32, device="meta")
    pts = torch.empty((4, eng.n, 8), dtype=torch.int32, device="meta")
    table = torch.empty((16 * 256, 4, eng.n), dtype=torch.int16, device="meta")
    digits = torch.empty((16, 8), dtype=torch.int32, device="meta")
    for call in (
        lambda: kernels.window_sum(consts, table, digits),
        lambda: kernels.horner(consts, pts, pts),
        lambda: kernels.pair_add(consts, pts, pts),
    ):
        with pytest.raises(ValueError, match="CUDA or CPU"):
            call()
    assert not any(kernels.launches().values())
