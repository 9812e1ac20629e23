"""The port's G2 subgroup check against a twist point outside the order-R
subgroup.

``g2_in_subgroup`` tests [R]p = infinity with the multiplication not reduced
mod R ([R - 1]p + p on the native tier). The JAX package's check multiplies
by R reduced mod R, so it accepts every point of the twist; the port
diverges from it on purpose. A proof whose B is such a point is refused by
``verify``, ``verify_batch`` and ``verify_proofs_parallel`` before any
pairing is computed for it.
"""

from __future__ import annotations

import pytest
import torch

import libzkp_tpu_torch as zkpt
from libzkp_tpu.models import snark_backend as jsb
from libzkp_tpu.models.schemes import equality_proof as jeq
from libzkp_tpu.ops import bn254 as jbn
from libzkp_tpu_torch import convert, native
from libzkp_tpu_torch.models import groth16 as tg
from libzkp_tpu_torch.models import snark_backend as tsb
from libzkp_tpu_torch.ops import bn254 as bn
from libzkp_tpu_torch.utils.envelope import Proof as Envelope

VALUE = 4242


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the suite runs in several worker processes at
    once, and OpenMP pools oversubscribing the cores stall each other."""
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _fq_sqrt(v: int):
    r = pow(v % bn.P, (bn.P + 1) // 4, bn.P)  # p = 3 mod 4
    return r if r * r % bn.P == v % bn.P else None


def _fq2_sqrt(a):
    """A square root in Fq2 = Fq[i] / (i^2 + 1), or None."""
    a0, a1 = a
    norm = _fq_sqrt((a0 * a0 + a1 * a1) % bn.P)
    if norm is None:
        return None
    for s in (norm, bn.P - norm):
        x0 = _fq_sqrt((a0 + s) * pow(2, -1, bn.P) % bn.P)
        if x0:
            return (x0, a1 * pow(2 * x0, -1, bn.P) % bn.P)
    return None


@pytest.fixture(scope="module")
def outside():
    """The twist point of smallest x = (k, 1), k >= 1: on the curve, not of
    order R (the twist's cofactor is about p, so no small x is)."""
    k = 1
    while True:
        x = (k, 1)
        y = _fq2_sqrt(bn.fq2_add(bn.fq2_mul(bn.fq2_sq(x), x), bn.B_G2))
        if y is not None:
            return (x, y, bn.FQ2_ONE)
        k += 1


def test_point_outside_subgroup(outside):
    """On the twist, outside the subgroup by an unreduced double-and-add,
    refused by the port, accepted by the JAX package; the generator and a
    multiple of it pass both."""
    assert bn.g2_is_on_curve(outside)
    acc, base, k = bn.G2_INF, outside, bn.R
    while k:
        if k & 1:
            acc = bn.g2_add(acc, base)
        base, k = bn.g2_double(base), k >> 1
    assert not bn.g2_is_inf(acc)
    assert bn.g2_to_affine(bn.g2_scalar_mul(bn.R - 1, outside)) == bn.g2_to_affine(
        bn.g2_scalar_mul_py(bn.R - 1, outside))
    assert not bn.g2_in_subgroup(outside)
    assert jbn.g2_in_subgroup(outside)
    g = bn.g2_from_affine((bn.G2_GEN_X, bn.G2_GEN_Y))
    for p in (g, bn.g2_scalar_mul(123456789, g), bn.G2_INF):
        assert bn.g2_in_subgroup(p) and jbn.g2_in_subgroup(p)


@pytest.fixture(scope="module")
def proofs(outside):
    """The JAX package's equality proof of VALUE under its key (carried
    into the port's setup cache), and the same envelope with B replaced by
    the point outside the subgroup."""
    jpk = jsb._get_equality_setup()
    tsb._reset_for_tests()
    tsb._equality_setup = convert.proving_key(jpk)
    good = jeq.prove_equality(VALUE, VALUE)
    env = Envelope.from_bytes(good)
    body = tg.proof_from_bytes(env.proof)
    bad_body = tg.proof_to_bytes(tg.Proof(a=body.a, b=outside, c=body.c))
    assert tg.proof_from_bytes(bad_body) is not None  # it parses: only the subgroup check stands
    bad = Envelope(env.version, env.scheme, bad_body, env.commitment).to_bytes()
    yield tsb._equality_setup, env, body, bad, tg.proof_from_bytes(bad_body)
    tsb._reset_for_tests()


def test_verify_refuses_before_pairing(proofs, monkeypatch):
    pk, env, body, bad_env, bad = proofs
    calls = []
    premul = native.bn254_multi_pairing_premul
    monkeypatch.setattr(native, "bn254_multi_pairing_premul", lambda *a: calls.append(1) or premul(*a))
    inputs = [int.from_bytes(env.commitment, "little")]
    assert tg.verify(pk.vk, inputs, body) and len(calls) == 1
    assert not tg.verify(pk.vk, inputs, bad)
    assert not zkpt.verify_equality(bad_env, VALUE, VALUE)
    assert len(calls) == 1  # the forged proofs reached no pairing


def test_verify_batch_and_parallel_refuse(proofs, monkeypatch, outside):
    """The forged proof never joins the random linear combination: one
    multi-pairing checks the good ones, with no halving."""
    pk, env, body, bad_env, bad = proofs
    calls = []
    multi = bn.multi_pairing
    monkeypatch.setattr(bn, "multi_pairing", lambda pairs: calls.append(len(pairs)) or multi(pairs))
    inputs = [int.from_bytes(env.commitment, "little")]
    assert tg.verify_batch(pk.vk, [(inputs, body), (inputs, bad), (inputs, body)]) == [True, False, True]
    assert calls == [2 + 3]
    calls.clear()
    good_env = env.to_bytes()
    assert zkpt.verify_proofs_parallel([(good_env, "equality"), (bad_env, "equality")]) == [True, False]
    assert calls == [1 + 3]
