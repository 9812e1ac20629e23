"""The plain versions of the probe kernels (P2 ``padd_chain``, P4
``fe_mul``) against the JAX package's point engine and field ops and the
host's integer arithmetic, and ``libzkp_tpu_torch.probes`` end to end on the
CPU at tiny sizes."""

from __future__ import annotations

import random

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from libzkp_tpu.ops import curve_jax as cj
from libzkp_tpu.ops import limbfold as jlimbfold
from libzkp_tpu_torch import probes
from libzkp_tpu_torch.ops import kernels
from libzkp_tpu_torch.ops.weierstrass import get_engine


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the suite runs in several worker processes at
    once, and OpenMP pools oversubscribing the cores stall each other."""
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def test_padd_chain_plain_matches_jax_padd_loop():
    """R = 4 chained additions over 8 lanes: the limbs of a loop of JAX
    ``EdwardsEngine.padd``."""
    consts, p, q, _, _ = probes.chain_inputs("cpu", lanes=8)
    got = kernels.padd_chain(consts, p, q, 4)
    jeng = cj.edwards_engine()
    jc = jnp.asarray(jeng.consts_np)
    want, jq = jnp.asarray(p.numpy()), jnp.asarray(q.numpy())
    for _ in range(4):
        want = jeng.padd(jc, want, jq)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("curve", ["ed25519", "bn254_g1"])
def test_fe_mul_plain_matches_jax_field_ops(curve):
    """Products of canonical and of relaxed operands (a chained product, as
    the kernels feed them): the limbs of JAX ``limbfold.FieldOps.mul``, and
    a*b mod p."""
    consts, a, b, av, bv = probes.mul_inputs("cpu", curve, lanes=96)
    got = kernels.fe_mul(consts, a, b, curve=curve)
    relaxed = kernels.fe_mul(consts, got, a, curve=curve)
    ops = jlimbfold.FieldOps(get_engine(curve).n, jnp.asarray(consts.numpy()))
    np.testing.assert_array_equal(got.numpy(), np.asarray(ops.mul(jnp.asarray(a.numpy()), jnp.asarray(b.numpy()))))
    np.testing.assert_array_equal(relaxed.numpy(),
                                  np.asarray(ops.mul(jnp.asarray(got.numpy()), jnp.asarray(a.numpy()))))
    ctx = get_engine(curve).ctx
    vals = ctx.decode(relaxed.numpy().T)
    for i in range(96):
        x, y = av[i % probes.DISTINCT], bv[i % probes.DISTINCT]
        assert vals[i] == x * y % ctx.p * x % ctx.p


def test_probes_run_end_to_end_on_cpu(capsys):
    """Every probe runs its plain version, checks it against the host and
    reports no device time."""
    out = probes.run("cpu", chain_lanes=8, mul_lanes=64, add_lanes=80)
    assert [(r["probe"], r["name"]) for r in out] == [
        ("P2", "padd_chain"), ("P4", "fe_mul"), ("P4", "fe_mul_bn254_g1"), ("P5", "pair_add")]
    assert all(r["ms"] is None for r in out)
    assert out[0]["macs"] == 9 * probes.MUL_MACS * probes.CHAIN_R * 8
    assert not any(kernels.launches().values())
    assert probes.main(["--device", "cpu", "--chain-lanes", "4", "--mul-lanes", "8",
                        "--add-lanes", "8"]) == 0
    lines = capsys.readouterr().out.strip().splitlines()
    assert len(lines) == 5 and '"device": "cpu"' in lines[0]


def test_probe_wrappers_take_cpu_or_cuda_only():
    for call in (
        lambda: kernels.padd_chain(*(torch.empty(s, dtype=torch.int32, device="meta")
                                     for s in ((28, 24), (4, 24, 8), (4, 24, 8))), 4),
        lambda: kernels.fe_mul(*(torch.empty(s, dtype=torch.int32, device="meta")
                                 for s in ((27, 24), (24, 8), (24, 8))), curve="bn254_g1"),
    ):
        with pytest.raises(ValueError, match="CUDA or CPU"):
            call()


def test_probe_inputs_tile_distinct_operands():
    """Lane i holds operand i % DISTINCT, as the TPU scripts tiled theirs."""
    _, a, _, av, _ = probes.mul_inputs("cpu", "ed25519", lanes=130)
    ctx = get_engine("ed25519").ctx
    vals = ctx.decode(a.numpy().T)
    assert vals == [av[i % probes.DISTINCT] for i in range(130)]
    rng = random.Random(0)
    assert probes._points(rng, 2) != probes._points(rng, 2)
