"""The reference's verdict on each proof of a sample: the proof, checked
against its op's public statement, the deployment's parameters and, for the
Groth16 kinds, the deployment's verifying keys.

What each kind's verdict covers:

* ``range`` ``(value, min, max)``: the envelope's min and max are the op's,
  both single proofs at the stated width verify, and their commitments are
  ``C - min*B`` and ``max*B - C``;
* ``threshold`` ``(values, threshold)``: the threshold is the op's, the
  proof of ``sum - threshold`` verifies at the stated width;
* ``consistency`` ``(values,)``: as many commitments as values, each step's
  proof verifies at the stated width;
* ``equality`` ``(a, b)``: ``a == b``, the envelope's commitment is
  MiMC-5(a), and the Groth16 proof verifies under the equality key;
* ``membership`` ``(value, set)``: the embedded set is the op's set, the
  commitment is MiMC-5(value), and the proof verifies under the membership
  key with the set as public input;
* ``improvement`` ``(old, new)``: the payload's old and new are the op's,
  the commitment is ``SHA256("libzkp_improvement_v1" || old || new)``, and
  the STARK proof verifies.

The Bulletproofs instances of the whole sample are checked as one random
linear combination, the Groth16 proofs of a key as another; a failed
combination is halved until each bad proof stands alone.
"""

from __future__ import annotations

import hashlib
import os
from typing import Dict, List, Optional, Sequence, Tuple

from . import bp_envelopes, circuits, envelope, groth16, stark
from .bulletproofs import check_terms, verification_terms

BP_KINDS = ("range", "threshold", "consistency")


def _u64(x: int) -> bytes:
    return int(x).to_bytes(8, "little")


def _weight() -> int:
    return int.from_bytes(os.urandom(16), "little") | 1


def _bp_instances(kind: str, args, proof: bytes, bits: int):
    parsed = envelope.parse(proof, kind)
    if parsed is None:
        return None
    body, commitment = parsed
    if len(commitment) != 32:
        return None
    if kind == "range":
        return bp_envelopes.range_instances(body, commitment, args[1], args[2], bits)
    if kind == "threshold":
        return bp_envelopes.threshold_instances(body, commitment, args[1], bits)
    return bp_envelopes.consistency_instances(body, commitment, len(args[0]), bits)


def _bp_verdicts(items: List[Tuple[str, tuple, bytes]], bits: int) -> List[bool]:
    groups: List[Optional[list]] = []
    for kind, args, proof in items:
        insts = _bp_instances(kind, args, proof, bits)
        terms = None if insts is None else [verification_terms(*inst) for inst in insts]
        groups.append(None if terms is None or any(t is None for t in terms) else terms)
    out = [False] * len(items)

    def check(idxs: List[int]) -> None:
        if check_terms([(t, _weight(), _weight()) for i in idxs for t in groups[i]]):
            for i in idxs:
                out[i] = True
        elif len(idxs) > 1:
            check(idxs[: len(idxs) // 2])
            check(idxs[len(idxs) // 2 :])

    live = [i for i, g in enumerate(groups) if g is not None]
    if live:
        check(live)
    return out


def _snark_statement(kind: str, args, proof: bytes):
    """``(public inputs, Groth16 proof)`` of an equality or membership
    envelope checked against its op, or None."""
    parsed = envelope.parse(proof, kind)
    if parsed is None:
        return None
    payload, commitment = parsed
    value = args[0]
    if commitment != circuits.commit_value_snark(value):
        return None
    commitment_fr = circuits.fr_from_commitment(commitment)
    if kind == "equality":
        if args[0] != args[1]:
            return None
        snark, public = payload, [commitment_fr]
    else:
        the_set = list(args[1])
        if len(payload) < 4:
            return None
        size = int.from_bytes(payload[:4], "little")
        need = 4 + 8 * size
        if size != len(the_set) or len(payload) <= need:
            return None
        embedded = [int.from_bytes(payload[4 + 8 * i : 12 + 8 * i], "little") for i in range(size)]
        if sorted(embedded) != sorted(the_set):
            return None
        snark, public = payload[need:], circuits.membership_public(embedded, commitment_fr)
    g = groth16.proof_from_bytes(snark)
    return None if g is None else (public, g)


def _improvement_verdict(args, proof: bytes) -> bool:
    parsed = envelope.parse(proof, "improvement")
    if parsed is None:
        return False
    payload, commitment = parsed
    old, new = args
    if len(payload) < 16 or payload[:16] != _u64(old) + _u64(new):
        return False
    want = hashlib.sha256(b"libzkp_improvement_v1" + _u64(old) + _u64(new)).digest()
    return commitment == want and stark.verify_improvement(payload[16:], old, new)


def verdicts(items: Sequence[Tuple[str, tuple, bytes]], *, bits: int,
             vks: Dict[str, groth16.VerifyingKey]) -> List[bool]:
    """One verdict for each ``(kind, args, proof)`` item: the Bulletproofs
    kinds at ``bits`` bits, the Groth16 kinds under ``vks[kind]``."""
    items = list(items)
    out = [False] * len(items)
    bp = [i for i, (kind, _, _) in enumerate(items) if kind in BP_KINDS]
    for i, ok in zip(bp, _bp_verdicts([items[i] for i in bp], bits)):
        out[i] = ok
    for kind in ("equality", "membership"):
        idx = [i for i, it in enumerate(items) if it[0] == kind]
        stmts = [_snark_statement(*items[i]) for i in idx]
        live = [(i, s) for i, s in zip(idx, stmts) if s is not None]
        if live:
            for (i, _), ok in zip(live, groth16.verify_batch(vks[kind], [s for _, s in live])):
                out[i] = ok
    for i, (kind, args, proof) in enumerate(items):
        if kind == "improvement":
            out[i] = _improvement_verdict(args, proof)
    return out
