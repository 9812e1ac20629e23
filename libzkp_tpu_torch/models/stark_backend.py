"""STARK backend: improvement proofs (new > old).

Port of the JAX package's ``libzkp_tpu/models/stark_backend.py``, which
mirrors the reference's winterfell backend (its stark.rs):

* ``ImprovementAir``: 1 column x 8 rows, a linear interpolation trace, one
  degree-1 transition constraint ``next - current - step`` (stark.rs:63-76)
  and two boundary assertions (first = old, last = new, stark.rs:78-83);
* ``step = (new - old) / (trace_length - 1)`` in f128 (stark.rs:160-175), so
  the trace interpolates exactly;
* the byte interface: ``StarkBackend.prove(data)`` takes ``[old:8 LE][new:8
  LE]`` and ``StarkBackend.verify(proof, data)`` the same (stark.rs:215-252).

Routes, all byte-identical (the protocol has no randomness: grinding 0):

* :func:`prove_improvement_batch`, the entry points' route at every batch
  size: every trace's coset LDE and leaf digests in one device program
  (``ops/stark_device.py``, the card unless ``device="cpu"`` asks for the
  plain versions), then each proof's transcript, composition, FRI and
  serialisation on the host (``stark.prove`` with ``precomputed``);
* :func:`_prove_native`, the whole pipeline on the native tier
  (``stark_prove_improvement_batch``): the baseline, to which no entry point
  routes.

Verification runs on the native verifier; ``stark.verify`` is its golden
(:func:`verify_improvement_py`). The JAX package's fork pool for the host
assembly and its environment switches are not carried.
"""

from __future__ import annotations

from typing import List, Tuple

from .. import native
from ..device import resolve
from ..ops.field import F128
from ..ops.stark_device import coset_lde_commit_batch
from ..utils import tracing
from ..utils.encoding import read_u64_le
from . import stark


class ImprovementAir(stark.Air):
    """Linear interpolation from ``old`` to ``new`` over the trace."""

    field = F128

    def __init__(self, trace_length: int, pub_inputs, options: stark.ProofOptions):
        assert len(pub_inputs) == 2
        super().__init__(trace_length, 1, pub_inputs, options)
        F = self.field
        old_v, new_v = self.pub_inputs
        diff = F.sub(new_v % F.p, old_v % F.p)
        steps = (trace_length - 1) % F.p
        self.step_size = F.div(diff, steps)

    def transition_degrees(self) -> List[int]:
        return [1]

    def evaluate_transition(self, current: List[int], nxt: List[int]) -> List[int]:
        F = self.field
        # next = current + step  <=>  next - current - step == 0
        return [F.sub(F.sub(nxt[0], current[0]), self.step_size)]

    def get_assertions(self) -> List[Tuple[int, int, int]]:
        return [
            (0, 0, self.pub_inputs[0] % self.field.p),
            (0, self.trace_length - 1, self.pub_inputs[1] % self.field.p),
        ]


TRACE_LENGTH = 8  # stark.rs:157

DEFAULT_OPTIONS = stark.ProofOptions(
    num_queries=32, blowup=8, grinding=0, folding=8, max_remainder_degree=31
)

_U64 = 1 << 64


def _root64() -> int:
    """The LDE domain's root of unity (the native tier's ``root64``)."""
    return F128.root_of_unity(TRACE_LENGTH * DEFAULT_OPTIONS.blowup)


def _check_pairs(pairs) -> None:
    for old, new in pairs:
        if new <= old:
            raise ValueError("new value must be greater than old value")


def _build_trace(air: ImprovementAir, old: int) -> List[int]:
    F = F128
    col = []
    cur = old % F.p
    for i in range(TRACE_LENGTH):
        col.append(cur)
        if i < TRACE_LENGTH - 1:
            cur = F.add(cur, air.step_size)
    return col


def _prove_native(pairs) -> List[bytes]:
    """The whole pipeline of each pair on the native tier
    (``zkp_stark_prove_improvement_batch``, its proofs across the team):
    the baseline beside the card route, byte-identical to it."""
    pairs = list(pairs)
    _check_pairs(pairs)
    ctxs = [ImprovementAir(TRACE_LENGTH, [o, n], DEFAULT_OPTIONS).context_bytes() for o, n in pairs]
    return native.stark_prove_improvement_batch(pairs, F128.p, _root64(), ctxs)


def prove_improvement_batch(pairs, *, device=None) -> List[bytes]:
    """STARK proofs that ``new > old`` for each pair (stark.rs:151-186).
    Every trace's interpolation, coset LDE at blowup 8 and leaf digests run
    as one program on ``device`` (default the CUDA card); each proof's
    transcript, composition, FRI and serialisation follow on the host.
    Raises ``ValueError`` when a pair has ``new <= old``."""
    device = resolve(device)
    pairs = list(pairs)
    _check_pairs(pairs)
    if not pairs:
        return []
    airs = [ImprovementAir(TRACE_LENGTH, [old, new], DEFAULT_OPTIONS) for old, new in pairs]
    cols = [_build_trace(air, old) for air, (old, _) in zip(airs, pairs)]
    with tracing.span("stark.lde"):
        polys, ldes, leaf_rows = coset_lde_commit_batch(F128.p, cols, DEFAULT_OPTIONS.blowup,
                                                        stark.DOMAIN_OFFSET, device=device)
    with tracing.span("stark.prove"):
        return [stark.prove(air, [col], precomputed=([poly], [lde], leaves))
                for air, col, poly, lde, leaves in zip(airs, cols, polys, ldes, leaf_rows)]


def prove_improvement(old: int, new: int, *, device=None) -> bytes:
    """One proof: the batch of one on :func:`prove_improvement_batch`'s route."""
    return prove_improvement_batch([(old, new)], device=device)[0]


def verify_improvement(proof_bytes: bytes, old: int, new: int) -> bool:
    """Verify with public inputs [old, new] (stark.rs:188-212) on the native
    verifier. Public inputs outside u64 give False (the verifier takes
    u64, as the byte interface does); the library bounds every read of the
    proof, so malformed bytes give False."""
    if not (0 <= old < _U64 and 0 <= new < _U64):
        return False
    air = ImprovementAir(TRACE_LENGTH, [old, new], DEFAULT_OPTIONS)
    return native.stark_verify_improvement(old, new, F128.p, _root64(), air.context_bytes(),
                                           bytes(proof_bytes))


def verify_improvement_py(proof_bytes: bytes, old: int, new: int) -> bool:
    """The golden of :func:`verify_improvement`: ``stark.verify``, the Python
    verifier."""
    if not (0 <= old < _U64 and 0 <= new < _U64):
        return False
    return stark.verify(ImprovementAir(TRACE_LENGTH, [old, new], DEFAULT_OPTIONS), proof_bytes)


class StarkBackend:
    """Byte-oriented ZkpBackend interface (stark.rs:215-252)."""

    @staticmethod
    def prove(data: bytes, *, device=None) -> bytes:
        """A proof for ``[old:8 LE][new:8 LE]``, or ``b""`` for its defined
        failures: input that is not 16 bytes, and ``new <= old``."""
        if len(data) != 16:
            return b""
        old = read_u64_le(data, 0)
        new = read_u64_le(data, 8)
        if new <= old:
            return b""
        return prove_improvement(old, new, device=device)

    @staticmethod
    def verify(proof: bytes, data: bytes) -> bool:
        if len(data) != 16:
            return False
        return verify_improvement(proof, read_u64_le(data, 0), read_u64_le(data, 8))
