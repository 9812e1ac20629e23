"""SNARK backend: Groth16 equality and set-membership proofs with MiMC-5
commitments.

Port of the JAX package's ``libzkp_tpu/models/snark_backend.py`` (the Rust
reference's ``src/backend/snark.rs``):

* ``EqualityCircuit``: witnesses a, b; enforce ``a == b``; in-circuit MiMC-5
  of a (3 constraints per round); public input ``[commitment]``.
* ``MembershipCircuit``: witness value and a one-hot boolean selector;
  public inputs ``[commitment, set[0..64], is_real[0..64]]`` (129);
  :data:`MAX_SET_SIZE` = 64.
* Key directory: :func:`set_snark_key_dir` before the first setup; files
  ``{equality_mimc,membership_mimc}_{pk,vk}.bin`` with
  load-else-generate-then-persist semantics, in the JAX package's format,
  so the two packages can share one key. The port reads no environment
  variable for it.
* The batched provers (:meth:`SnarkBackend.prove_equality_zk_many`,
  :meth:`SnarkBackend.prove_membership_zk_many`) build each statement's
  assignment vector directly and prove the batch with
  :func:`.groth16.prove_assigned_many` on the caller's device, with the CSR
  rows of the setup circuit; the batch verifiers run
  :func:`.groth16.verify_batch`.
* The byte interface ``prove([a:8][b:8][commitment:32])`` /
  ``verify(proof, commitment)`` of the reference's backend trait.
"""

from __future__ import annotations

import functools
import threading
from pathlib import Path
from typing import List, Optional, Tuple

from ..ops.field import BN254_FR
from ..ops.mimc import fr_from_commitment, mimc_constants
from ..utils import tracing
from ..utils.encoding import read_u64_le
from ..utils.errors import ConfigError
from . import groth16
from .r1cs import ONE, ConstraintSystem

R = BN254_FR.p

MAX_SET_SIZE = 64

_key_dir_lock = threading.Lock()
_key_dir_override: Optional[Path] = None

_setup_lock = threading.Lock()
_equality_setup: Optional[groth16.ProvingKey] = None
_membership_setup: Optional[groth16.ProvingKey] = None


def set_snark_key_dir(path: str) -> None:
    """Directory the equality proving/verifying keys are read from (and
    written to when absent); must be set before the first setup."""
    global _key_dir_override
    if not path:
        raise ConfigError("SNARK key directory cannot be empty")
    if is_snark_initialized():
        raise ConfigError("SNARK setup is already initialized; set the key directory first")
    requested = Path(path)
    with _key_dir_lock:
        if _key_dir_override is not None and _key_dir_override != requested:
            raise ConfigError(
                f"SNARK key directory already set to {_key_dir_override}; "
                f"new value {requested} rejected"
            )
        _key_dir_override = requested


def is_snark_initialized() -> bool:
    return _equality_setup is not None or _membership_setup is not None


def _reset_for_tests() -> None:
    """Drop the setup caches and the key directory (a fresh process)."""
    global _equality_setup, _membership_setup, _key_dir_override
    with _setup_lock:
        _equality_setup = None
        _membership_setup = None
    with _key_dir_lock:
        _key_dir_override = None


def _load_or_generate(prefix: str, generate) -> groth16.ProvingKey:
    with _key_dir_lock:
        key_dir = _key_dir_override
    if key_dir is None:
        return generate()
    pk_path = key_dir / f"{prefix}_pk.bin"
    vk_path = key_dir / f"{prefix}_vk.bin"
    if pk_path.exists() and vk_path.exists():
        pk = groth16.pk_from_bytes(pk_path.read_bytes())
        vk = groth16.vk_from_bytes(vk_path.read_bytes())
        if pk is not None and vk is not None:
            pk.vk = vk
            return pk
        raise ConfigError(f"failed to deserialize SNARK keys in {key_dir}")
    pk = generate()
    try:
        key_dir.mkdir(parents=True, exist_ok=True)
        pk_path.write_bytes(groth16.pk_to_bytes(pk))
        vk_path.write_bytes(groth16.vk_to_bytes(pk.vk))
    except OSError:
        pass  # persistence failures are non-fatal (snark.rs:131-133)
    return pk


# ===== Circuit =====


def _mimc_gadget(cs: ConstraintSystem, x_var: int, x_val: int) -> Tuple[object, int]:
    """In-circuit MiMC-5: returns (output LC, output value). 3 constraints/round."""
    cur_lc = cs.lc((1, x_var))
    cur_val = x_val % R
    for c in mimc_constants():
        t_lc = dict(cur_lc)
        t_lc[0] = (t_lc.get(0, 0) + c) % R  # t = x + c (linear, 0 constraints)
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


def build_equality_circuit(a: int, b: int, commitment_fr: int) -> ConstraintSystem:
    cs = ConstraintSystem()
    a_var = cs.new_witness(a)
    b_var = cs.new_witness(b)
    cs.enforce_equal(cs.lc((1, a_var)), cs.lc((1, b_var)))
    hash_lc, _ = _mimc_gadget(cs, a_var, a)
    commitment_var = cs.new_input(commitment_fr)
    cs.enforce_equal(hash_lc, cs.lc((1, commitment_var)))
    return cs


def build_membership_circuit(value: int, sel: List[bool], set_values: List[int],
                             is_real: List[bool], commitment_fr: int) -> ConstraintSystem:
    assert len(sel) == len(set_values) == len(is_real) == MAX_SET_SIZE
    cs = ConstraintSystem()
    value_var = cs.new_witness(value)
    hash_lc, _ = _mimc_gadget(cs, value_var, value)
    commitment_var = cs.new_input(commitment_fr)
    cs.enforce_equal(hash_lc, cs.lc((1, commitment_var)))

    set_vars = [cs.new_input(v) for v in set_values]
    is_real_vars = [cs.new_boolean_input(b) for b in is_real]
    sel_vars = [cs.new_boolean_witness(s) for s in sel]

    # one-hot: sum(sel) == 1 and sel[i] <= is_real[i]
    cs.enforce_equal(cs.lc(*[(1, sv) for sv in sel_vars]), cs.lc((1, ONE)))
    for sv, rv in zip(sel_vars, is_real_vars):
        cs.enforce(cs.lc((1, sv)), cs.lc((1, ONE), (R - 1, rv)), {})  # sel * (1 - is_real) == 0

    # sum_i sel[i] * (value - set[i]) == 0, the set through its input
    # variables, so the matrices do not depend on the set's values (the
    # setup's circuit has the same QAP as every statement's)
    acc_terms = []
    for i, sv in enumerate(sel_vars):
        prod = cs.new_witness((1 if sel[i] else 0) * ((value - set_values[i]) % R) % R)
        cs.enforce(cs.lc((1, sv)), cs.lc((1, value_var), (R - 1, set_vars[i])), cs.lc((1, prod)))
        acc_terms.append((1, prod))
    cs.enforce_equal(cs.lc(*acc_terms), {})
    return cs


def _membership_setup_circuit() -> ConstraintSystem:
    return build_membership_circuit(0, [False] * MAX_SET_SIZE, [0] * MAX_SET_SIZE,
                                    [False] * MAX_SET_SIZE, 0)


def _get_equality_setup() -> groth16.ProvingKey:
    global _equality_setup
    with _setup_lock:
        if _equality_setup is None:
            _equality_setup = _load_or_generate(
                "equality_mimc", lambda: groth16.setup(build_equality_circuit(0, 0, 0))
            )
        return _equality_setup


def _get_membership_setup() -> groth16.ProvingKey:
    global _membership_setup
    with _setup_lock:
        if _membership_setup is None:
            _membership_setup = _load_or_generate(
                "membership_mimc", lambda: groth16.setup(_membership_setup_circuit()))
        return _membership_setup


@functools.lru_cache(maxsize=1)
def _membership_shape():
    """(num_instance, CSR rows) of the membership circuit, from the setup
    circuit."""
    cs = _membership_setup_circuit()
    return cs.num_instance, groth16.pack_csr(cs)


@functools.lru_cache(maxsize=1)
def _equality_shape():
    """(num_instance, CSR rows) of the equality circuit, from the setup
    circuit: its matrices are the same for every statement."""
    cs = build_equality_circuit(0, 0, 0)
    return cs.num_instance, groth16.pack_csr(cs)


# ===== Witness-only assignment =====


def _mimc_wires(x: int) -> List[int]:
    """Witness wires of the MiMC gadget: (t2, t4, x5) per round, in the
    gadget's allocation order."""
    wires: List[int] = []
    cur = x % R
    for c in mimc_constants():
        t = (cur + c) % R
        t2 = t * t % R
        t4 = t2 * t2 % R
        x5 = t4 * t % R
        wires += [t2, t4, x5]
        cur = x5
    return wires


def _equality_assignment(a: int, b: int, commitment_fr: int) -> List[int]:
    return [1, commitment_fr % R, a % R, b % R] + _mimc_wires(a)


def _membership_assignment(value: int, sel, set_values, is_real, commitment_fr: int) -> List[int]:
    """The membership circuit's assignment vector, in its allocation order:
    one, the commitment, the set, is_real, the value, the MiMC wires, the
    selector, the products sel[i] * (value - set[i])."""
    z = [1, commitment_fr % R]
    z += [v % R for v in set_values]
    z += [1 if b else 0 for b in is_real]
    z.append(value % R)
    z += _mimc_wires(value)
    z += [1 if s else 0 for s in sel]
    z += [(1 if sel[i] else 0) * ((value - set_values[i]) % R) % R for i in range(len(sel))]
    return z


def _membership_public(the_set: List[int], commitment_fr: int) -> List[int]:
    """Public inputs: [commitment, set[0..64], is_real[0..64]]."""
    pad = MAX_SET_SIZE - len(the_set)
    return [commitment_fr] + list(the_set) + [0] * pad + [1] * len(the_set) + [0] * pad


def _membership_statement(value: int, the_set: List[int], commitment: bytes) -> Optional[List[int]]:
    """The assignment of ``value in the_set`` under ``commitment``, or None
    when the statement cannot be proved: an empty set or one over
    :data:`MAX_SET_SIZE`, a non-canonical commitment, a value outside the
    set, or a commitment other than MiMC5(value)."""
    if not the_set or len(the_set) > MAX_SET_SIZE:
        return None
    commitment_fr = fr_from_commitment(bytes(commitment))
    if commitment_fr is None or value not in the_set:
        return None
    pad = MAX_SET_SIZE - len(the_set)
    sel = [False] * MAX_SET_SIZE
    sel[the_set.index(value)] = True
    z = _membership_assignment(value, sel, list(the_set) + [0] * pad,
                               [True] * len(the_set) + [False] * pad, commitment_fr)
    # the last MiMC wire, at 2 + 2 * 64 + 1 + 3 * rounds - 1, is MiMC5(value)
    if z[2 * MAX_SET_SIZE + 2 + 3 * len(mimc_constants())] != commitment_fr:
        return None
    return z


# ===== Backend API =====


class SnarkBackend:
    @staticmethod
    def prove_equality_zk(a: int, b: int, hash_input: bytes, *, device) -> bytes:
        """Prove MiMC5(a) == commitment AND a == b. Empty bytes on failure."""
        out = SnarkBackend.prove_equality_zk_many([(a, b, hash_input)], device=device)
        return out[0]

    @staticmethod
    def verify_equality_zk(proof_data: bytes, hash_input: bytes) -> bool:
        proof = groth16.proof_from_bytes(proof_data)
        if proof is None:
            return False
        commitment_fr = fr_from_commitment(bytes(hash_input))
        if commitment_fr is None:
            return False
        try:
            pk = _get_equality_setup()
        except Exception:
            return False
        return groth16.verify(pk.vk, [commitment_fr], proof)

    @staticmethod
    def prove_equality_zk_many(entries: List[Tuple[int, int, bytes]], *, device) -> List[bytes]:
        """Batched equality proving of ``(a, b, commitment)`` entries on
        ``device``: the five query MSMs of all distinct statements walk each
        proving-key table once. An entry that cannot be proved (a != b, a
        non-canonical commitment, a commitment other than MiMC5(a)) gets
        empty bytes; the rest are proved."""
        pk = _get_equality_setup()
        z_list, where = [], []
        with tracing.span("g16.assign"):
            for i, (a, b, commitment) in enumerate(entries):
                commitment_fr = fr_from_commitment(bytes(commitment))
                if a != b or commitment_fr is None:
                    continue
                z = _equality_assignment(a, b, commitment_fr)
                if z[-1] != commitment_fr:  # the last MiMC wire is MiMC5(a)
                    continue
                z_list.append(z)
                where.append(i)
        return _prove_many(pk, _equality_shape(), z_list, where, len(entries), device=device)

    @staticmethod
    def prove_membership_zk(value: int, the_set: List[int], commitment: bytes, *,
                            device) -> bytes:
        """Prove MiMC5(value) == commitment AND value in the_set. Empty bytes
        on failure."""
        return SnarkBackend.prove_membership_zk_many([(value, the_set, commitment)],
                                                     device=device)[0]

    @staticmethod
    def prove_membership_zk_many(entries: List[Tuple[int, List[int], bytes]], *,
                                 device) -> List[bytes]:
        """Batched membership proving of ``(value, set, commitment)`` entries
        on ``device`` (as :meth:`prove_equality_zk_many`). An entry that
        cannot be proved gets empty bytes; the rest are proved."""
        pk = _get_membership_setup()
        z_list, where = [], []
        with tracing.span("g16.assign"):
            for i, (value, the_set, commitment) in enumerate(entries):
                z = _membership_statement(value, list(the_set), commitment)
                if z is not None:
                    z_list.append(z)
                    where.append(i)
        return _prove_many(pk, _membership_shape(), z_list, where, len(entries), device=device)

    @staticmethod
    def verify_membership_zk(proof_data: bytes, the_set: List[int], commitment: bytes) -> bool:
        if not the_set or len(the_set) > MAX_SET_SIZE or len(commitment) != 32:
            return False
        proof = groth16.proof_from_bytes(proof_data)
        if proof is None:
            return False
        commitment_fr = fr_from_commitment(bytes(commitment))
        if commitment_fr is None:
            return False
        try:
            pk = _get_membership_setup()
        except Exception:
            return False
        return groth16.verify(pk.vk, _membership_public(list(the_set), commitment_fr), proof)

    @staticmethod
    def verify_equality_batch(entries: List[Tuple[bytes, bytes]]) -> List[bool]:
        """Verdicts of :meth:`verify_equality_zk` for ``(proof_data,
        commitment)`` entries, their pairing checks combined into one
        multi-pairing (:func:`.groth16.verify_batch`)."""
        items, where = [], []
        for i, (proof_data, commitment) in enumerate(entries):
            proof = groth16.proof_from_bytes(proof_data)
            commitment_fr = fr_from_commitment(bytes(commitment))
            if proof is not None and commitment_fr is not None:
                items.append(([commitment_fr], proof))
                where.append(i)
        return _verify_many(_get_equality_setup, items, where, len(entries))

    @staticmethod
    def verify_membership_batch(entries: List[Tuple[bytes, List[int], bytes]]) -> List[bool]:
        """Verdicts of :meth:`verify_membership_zk` for ``(proof_data, set,
        commitment)`` entries, as :meth:`verify_equality_batch`."""
        items, where = [], []
        for i, (proof_data, the_set, commitment) in enumerate(entries):
            if not the_set or len(the_set) > MAX_SET_SIZE or len(commitment) != 32:
                continue
            proof = groth16.proof_from_bytes(proof_data)
            commitment_fr = fr_from_commitment(bytes(commitment))
            if proof is not None and commitment_fr is not None:
                items.append((_membership_public(list(the_set), commitment_fr), proof))
                where.append(i)
        return _verify_many(_get_membership_setup, items, where, len(entries))

    # -- the reference's backend trait: prove([a:8][b:8][commitment:32]) --
    @staticmethod
    def prove(data: bytes, *, device) -> bytes:
        if len(data) != 48:
            return b""
        a = read_u64_le(data, 0)
        b = read_u64_le(data, 8)
        if a is None or b is None:
            return b""
        return SnarkBackend.prove_equality_zk(a, b, data[16:48], device=device)

    @staticmethod
    def verify(proof: bytes, data: bytes) -> bool:
        return SnarkBackend.verify_equality_zk(proof, data)


def _prove_many(pk: groth16.ProvingKey, shape, z_list: List[List[int]], where: List[int],
                count: int, *, device) -> List[bytes]:
    """``count`` proof slots: the proofs of ``z_list`` at ``where``, empty
    bytes elsewhere."""
    num_instance, csr = shape
    out = [b""] * count
    proofs = groth16.prove_assigned_many(pk, z_list, num_instance, csr, device=device)
    for i, proof in zip(where, proofs):
        out[i] = groth16.proof_to_bytes(proof)
    return out


def _verify_many(get_setup, items, where: List[int], count: int) -> List[bool]:
    """``count`` verdicts: :func:`.groth16.verify_batch` of ``items`` at
    ``where``, False elsewhere."""
    results = [False] * count
    try:
        pk = get_setup()
    except Exception:
        return results
    for i, ok in zip(where, groth16.verify_batch(pk.vk, items)):
        results[i] = ok
    return results
