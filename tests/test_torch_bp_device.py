"""The port's batched range prover against the JAX package.

* Each compute segment between transcript phases (setup, after_x, hc,
  ipp_pre, ipp_post, final) gives outputs identical to the JAX
  ``bp_device._segs(Kp)[name]`` program on the same inputs, at B = 8.
* The whole slice: the port's ``prove_single_batch_device`` on the CPU gives
  byte-identical 672-byte proofs and V commitments to the JAX package's host
  ``prove_single`` under the same injected randomness (lane value 2^63+12345
  included: the regression case of the 64-term-sum carry bound), as does the
  port's native whole-pipeline prover ``_prove_batch_native``, and both
  packages' verifiers accept them.
"""

from __future__ import annotations

import random

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from libzkp_tpu.models import bp_device as jbp
from libzkp_tpu.models import bulletproofs as jbulp
from libzkp_tpu.models.strobe import Transcript as JTranscript
from libzkp_tpu_torch.models import bp_device as tbp
from libzkp_tpu_torch.models import bulletproofs as bp
from libzkp_tpu_torch.models.strobe import Transcript
from libzkp_tpu_torch.ops import scalar_device as sd

L = bp.L
B = 8
KP = 160
N = 64


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the suite runs in several worker processes at
    once, and OpenMP pools oversubscribing the cores stall each other."""
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _np(x):
    return np.asarray(x)


def _cols(vals):
    return np.ascontiguousarray(sd.get_scalar_ctx().encode(vals).T)  # (nl, B)


def _bytes_rows(rng, nbytes):
    return rng.integers(0, 256, size=(nbytes, B)).astype(np.int32)


@pytest.fixture(scope="module")
def seg_runs():
    """Run the segment chain on both sides from the same seeded inputs.

    Returns {name: (port outputs, JAX outputs)} as numpy arrays."""
    rng = np.random.default_rng(21)
    prng = random.Random(22)
    jsegs = jbp._segs(KP)
    tsegs = tbp._Segs(KP, torch.device("cpu"))
    T = lambda a: torch.from_numpy(np.ascontiguousarray(a))  # noqa: E731
    J = lambda a: jnp.asarray(np.asarray(a))  # noqa: E731
    runs = {}

    def both(name, port_fn, jax_fn, args):
        got = port_fn(*[T(a) for a in args])
        want = jax_fn(*[J(a) for a in args])
        got = got if isinstance(got, tuple) else (got,)
        want = want if isinstance(want, tuple) else (want,)
        runs[name] = ([g.numpy() for g in got], [_np(w) for w in want])
        return runs[name][0]

    values = [prng.randrange(1 << 64) for _ in range(B)]
    values[1] = (1 << 63) + 12345
    aL = np.stack([_cols([(v >> i) & 1 for v in values]) for i in range(N)])
    sL = np.stack([_cols([prng.randrange(L) for _ in range(B)]) for _ in range(N)])
    sR = np.stack([_cols([prng.randrange(L) for _ in range(B)]) for _ in range(N)])
    t1b, t2b, gamma, ab, sb = (_cols([prng.randrange(L) for _ in range(B)]) for _ in range(5))
    y, z2, l0, r0, r1, _, _ = both(
        "setup", tsegs.setup, jsegs["setup"],
        [_bytes_rows(rng, 64), _bytes_rows(rng, 64), aL, sL, sR, t1b, t2b],
    )
    l_vec, r_vec, _, _, _ = both(
        "after_x", tsegs.after_x, jsegs["after_x"],
        [_bytes_rows(rng, 64), l0, r0, r1, sL, z2, gamma, t1b, t2b, ab, sb],
    )
    gc, hc = both("hc", tsegs.hc, jsegs["hc"], [y])
    (w,) = both("w", tsegs.w, jsegs["w"], [_bytes_rows(rng, 64)])
    both("ipp_pre", tsegs.ipp_pre, jsegs["ipp_pre"], [w, l_vec, r_vec, gc, hc])
    a2, b2, _, _ = both("ipp_post", tsegs.ipp_post, jsegs["ipp_post"],
                        [_bytes_rows(rng, 64), l_vec, r_vec, gc, hc])
    both("final", tsegs.final, jsegs["final"], [a2[0], b2[0]])
    return runs


@pytest.mark.parametrize("name", ["setup", "after_x", "hc", "w", "ipp_pre", "ipp_post", "final"])
def test_segment_matches_jax(seg_runs, name):
    got, want = seg_runs[name]
    assert len(got) == len(want)
    for i, (g, w) in enumerate(zip(got, want)):
        assert g.shape == w.shape, f"{name} output {i}"
        np.testing.assert_array_equal(g, w.astype(g.dtype), err_msg=f"{name} output {i}")


def test_device_prover_matches_jax_host_prover_and_verifies(monkeypatch):
    rng = random.Random(0xBDD)
    rnd_lanes = [[rng.randrange(1, L) for _ in range(2 * 64 + 4)] for _ in range(2)]
    values = [7, (1 << 63) + 12345]
    gammas = [123456789, 987654321]

    # JAX host reference with the same randomness, in prove_single's draw
    # order (= the device rnd layout): a, s, s_L(64), s_R(64), t1, t2
    monkeypatch.setattr(jbulp, "_use_native_prover", lambda: False)
    host_out = []
    for lane, (v, g) in enumerate(zip(values, gammas)):
        it = iter(rnd_lanes[lane])
        monkeypatch.setattr(jbulp, "_random_scalar", lambda it=it: next(it))
        proof, V = jbulp.prove_single(JTranscript(b"libzkp_range_min"), v, g, 64)
        host_out.append((proof.to_bytes(), V))

    # the port's own host golden prover agrees on a lane
    it = iter(rnd_lanes[1])
    monkeypatch.setattr(bp, "_random_scalar", lambda: next(it))
    proof, V = bp.prove_single(Transcript(b"libzkp_range_min"), values[1], gammas[1], 64)
    assert (proof.to_bytes(), V) == host_out[1]

    dev_out = tbp.prove_single_batch_device(
        b"libzkp_range_min", values, gammas, rnd=rnd_lanes, device="cpu"
    )
    for lane in range(2):
        assert len(dev_out[lane][0]) == 672
        assert dev_out[lane][1] == host_out[lane][1], f"V lane {lane}"
        assert dev_out[lane][0] == host_out[lane][0], f"proof lane {lane}"

    # the native prover under the same draws (each scalar < l as a wide draw)
    rand = b"".join(s.to_bytes(64, "little") for lane in rnd_lanes for s in lane)
    insts = [(Transcript(b"libzkp_range_min"), v, g, 64) for v, g in zip(values, gammas)]
    native = bp._prove_batch_native(insts, 64, rand)
    assert [(rp.to_bytes(), V) for rp, V in native] == host_out

    for proof_bytes, V in dev_out:
        assert bp.verify_single(bp.RangeProof.from_bytes(proof_bytes),
                                Transcript(b"libzkp_range_min"), V, 64)
        assert jbulp.verify_single(jbulp.RangeProof.from_bytes(proof_bytes),
                                   JTranscript(b"libzkp_range_min"), V, 64)
