"""SNARK backend, equality part: Groth16 equality proofs with MiMC-5
commitments.

Port of the equality half of the JAX package's
``libzkp_tpu/models/snark_backend.py`` (the Rust reference's
``src/backend/snark.rs``):

* ``EqualityCircuit``: witnesses a, b; enforce ``a == b``; in-circuit MiMC-5
  of a (3 constraints per round); public input ``[commitment]``.
* Key directory: :func:`set_snark_key_dir` before the first setup; files
  ``equality_mimc_{pk,vk}.bin`` with load-else-generate-then-persist
  semantics, in the JAX package's format, so the two packages can share one
  key. The port reads no environment variable for it.
* The batched prover (:meth:`SnarkBackend.prove_equality_zk_many`) builds
  each statement's assignment vector directly and proves the batch with
  :func:`.groth16.prove_assigned_many` on the caller's device, with the CSR
  rows of the setup circuit.
"""

from __future__ import annotations

import functools
import threading
from pathlib import Path
from typing import List, Optional, Tuple

from ..ops.field import BN254_FR
from ..ops.mimc import fr_from_commitment, mimc_constants
from ..utils.errors import ConfigError
from . import groth16
from .r1cs import ConstraintSystem

R = BN254_FR.p

_key_dir_lock = threading.Lock()
_key_dir_override: Optional[Path] = None

_setup_lock = threading.Lock()
_equality_setup: Optional[groth16.ProvingKey] = None


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
    return _equality_setup is not None


def _reset_for_tests() -> None:
    """Drop the setup cache and the key directory (a fresh process)."""
    global _equality_setup, _key_dir_override
    with _setup_lock:
        _equality_setup = None
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


def _get_equality_setup() -> groth16.ProvingKey:
    global _equality_setup
    with _setup_lock:
        if _equality_setup is None:
            _equality_setup = _load_or_generate(
                "equality_mimc", lambda: groth16.setup(build_equality_circuit(0, 0, 0))
            )
        return _equality_setup


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
        num_instance, csr = _equality_shape()
        z_list, where = [], []
        for i, (a, b, commitment) in enumerate(entries):
            commitment_fr = fr_from_commitment(bytes(commitment))
            if a != b or commitment_fr is None:
                continue
            z = _equality_assignment(a, b, commitment_fr)
            if z[-1] != commitment_fr:  # the last MiMC wire is MiMC5(a)
                continue
            z_list.append(z)
            where.append(i)
        out = [b""] * len(entries)
        proofs = groth16.prove_assigned_many(pk, z_list, num_instance, csr, device=device)
        for i, proof in zip(where, proofs):
            out[i] = groth16.proof_to_bytes(proof)
        return out
