"""Hooks that break the timed path underneath a run, for the control and
the planted faults that the comparison has to catch (``control.py`` and
``tests/test_zkbench_faults.py``; the benchmark's own runs use none).

Each hook takes the program's package and returns a context manager under
which the run's set-up and window go.

* ``narrow`` (the control of the Bulletproofs cells): the program's own
  32-bit path for every range and threshold op, where the deployment states
  64-bit proofs: the precision step below the stated one.
* ``foreign_keys`` (the control of the Groth16 cell): the program's own
  per-process setup in place of the deployment's key files.
* ``stale``: ``process_batch`` hands back the previous batch's proofs, a
  step that returns its state unchanged.
* ``half``: only the first half of each batch's ops gets a proof.
* ``altered``: one byte of every proof flipped where it is produced.
"""

from __future__ import annotations

import contextlib


@contextlib.contextmanager
def _patched(obj, attr, make):
    orig = getattr(obj, attr)
    setattr(obj, attr, make(orig))
    try:
        yield
    finally:
        setattr(obj, attr, orig)


def narrow(zkpt):
    from libzkp_tpu_torch.models.bulletproofs_backend import BulletproofsBackend
    from libzkp_tpu_torch.parallel import batch_prover
    from libzkp_tpu_torch.utils.envelope import SCHEME_RANGE, SCHEME_THRESHOLD

    def make(orig):
        def prepare(op, *, device):
            if op.kind == "range":
                return (SCHEME_RANGE, *BulletproofsBackend.prepare_range_bits(*op.args, 32))
            if op.kind == "threshold":
                values, threshold = op.args
                return (SCHEME_THRESHOLD,
                        *BulletproofsBackend.prepare_threshold_bits(list(values), threshold, 32))
            return orig(op, device=device)
        return prepare

    return _patched(batch_prover, "_prepare", make)


@contextlib.contextmanager
def foreign_keys(zkpt):
    from libzkp_tpu_torch.models import snark_backend

    snark_backend._reset_for_tests()  # no key directory: a fresh setup in this process
    yield


def stale(zkpt):
    previous = []

    def make(orig):
        def process_batch(batch_id, *, device=None):
            out = orig(batch_id, device=device)
            handed = previous[0] if previous else out
            previous[:] = [out]
            return handed
        return process_batch

    return _patched(zkpt, "process_batch", make)


def half(zkpt):
    def make(orig):
        def process_batch(batch_id, *, device=None):
            out = orig(batch_id, device=device)
            return out[: len(out) // 2]
        return process_batch

    return _patched(zkpt, "process_batch", make)


def altered(zkpt):
    from libzkp_tpu_torch.advanced import batch

    def flip(proof: bytes) -> bytes:
        b = bytearray(proof)
        b[len(b) // 2] ^= 0x01
        return bytes(b)

    def make(orig):
        def process_operations(ops, *, device=None):
            return [flip(p) for p in orig(ops, device=device)]
        return process_operations

    return _patched(batch, "process_operations", make)


HOOKS = {"narrow": narrow, "foreign_keys": foreign_keys, "stale": stale, "half": half,
         "altered": altered}
