"""The two Groth16 circuits of the SNARK backend, MiMC-5 and the
commitments they bind, in pure Python.

Frozen copy of the port's two circuits and host MiMC (the Rust
reference's ``src/backend/snark.rs``):

* MiMC-5 over BN254 Fr: 110 rounds of ``x <- (x + c_i)^5``, round constants
  ``SHA256(b"libzkp_mimc_v1:" || u64_le(i))`` reduced mod r; a commitment is
  the canonical 32-byte little-endian Fr;
* ``equality``: witnesses a, b; ``a == b``; in-circuit MiMC-5 of a (3
  constraints a round); public input ``[commitment]``;
* ``membership``: witness value and a one-hot selector; public inputs
  ``[commitment, set[0..64], is_real[0..64]]``, :data:`MAX_SET_SIZE` = 64.
"""

from __future__ import annotations

import functools
import hashlib
from typing import List, Optional, Tuple

from .field import BN254_FR
from .r1cs import ONE, ConstraintSystem

R = BN254_FR.p
MIMC_ROUNDS = 110
MAX_SET_SIZE = 64


@functools.lru_cache(maxsize=1)
def mimc_constants() -> tuple:
    out = []
    for i in range(MIMC_ROUNDS):
        h = hashlib.sha256(b"libzkp_mimc_v1:" + i.to_bytes(8, "little")).digest()
        out.append(BN254_FR.from_le_bytes_mod(h))
    return tuple(out)


def mimc_hash(value: int) -> int:
    x = value % R
    for c in mimc_constants():
        x = pow((x + c) % R, 5, R)
    return x


def commit_value_snark(value: int) -> bytes:
    """The 32-byte MiMC-5 commitment of ``value``."""
    return mimc_hash(value).to_bytes(32, "little")


def fr_from_commitment(data: bytes) -> Optional[int]:
    if len(data) != 32:
        return None
    return BN254_FR.from_le_bytes_canonical(data)


def _mimc_gadget(cs: ConstraintSystem, x_var: int, x_val: int) -> Tuple[object, int]:
    cur_lc = cs.lc((1, x_var))
    cur_val = x_val % R
    for c in mimc_constants():
        t_lc = dict(cur_lc)
        t_lc[0] = (t_lc.get(0, 0) + c) % R
        t_val = (cur_val + c) % R
        t2_val = t_val * t_val % R
        t2 = cs.new_witness(t2_val)
        cs.enforce(t_lc, t_lc, cs.lc((1, t2)))
        t4_val = t2_val * t2_val % R
        t4 = cs.new_witness(t4_val)
        cs.enforce(cs.lc((1, t2)), cs.lc((1, t2)), cs.lc((1, t4)))
        x5_val = t4_val * t_val % R
        x5 = cs.new_witness(x5_val)
        cs.enforce(cs.lc((1, t4)), t_lc, cs.lc((1, x5)))
        cur_lc = cs.lc((1, x5))
        cur_val = x5_val
    return cur_lc, cur_val


def equality_circuit() -> ConstraintSystem:
    """The equality circuit at the all-zero assignment (its matrices are
    every statement's)."""
    cs = ConstraintSystem()
    a_var = cs.new_witness(0)
    b_var = cs.new_witness(0)
    cs.enforce_equal(cs.lc((1, a_var)), cs.lc((1, b_var)))
    hash_lc, _ = _mimc_gadget(cs, a_var, 0)
    commitment_var = cs.new_input(0)
    cs.enforce_equal(hash_lc, cs.lc((1, commitment_var)))
    return cs


def membership_circuit() -> ConstraintSystem:
    """The membership circuit at the all-zero assignment."""
    cs = ConstraintSystem()
    value_var = cs.new_witness(0)
    hash_lc, _ = _mimc_gadget(cs, value_var, 0)
    commitment_var = cs.new_input(0)
    cs.enforce_equal(hash_lc, cs.lc((1, commitment_var)))
    set_vars = [cs.new_input(0) for _ in range(MAX_SET_SIZE)]
    is_real_vars = [cs.new_boolean_input(False) for _ in range(MAX_SET_SIZE)]
    sel_vars = [cs.new_boolean_witness(False) for _ in range(MAX_SET_SIZE)]
    cs.enforce_equal(cs.lc(*[(1, sv) for sv in sel_vars]), cs.lc((1, ONE)))
    for sv, rv in zip(sel_vars, is_real_vars):
        cs.enforce(cs.lc((1, sv)), cs.lc((1, ONE), (R - 1, rv)), {})
    acc_terms = []
    for i, sv in enumerate(sel_vars):
        prod = cs.new_witness(0)
        cs.enforce(cs.lc((1, sv)), cs.lc((1, value_var), (R - 1, set_vars[i])), cs.lc((1, prod)))
        acc_terms.append((1, prod))
    cs.enforce_equal(cs.lc(*acc_terms), {})
    return cs


def membership_public(the_set: List[int], commitment_fr: int) -> List[int]:
    pad = MAX_SET_SIZE - len(the_set)
    return [commitment_fr] + list(the_set) + [0] * pad + [1] * len(the_set) + [0] * pad
