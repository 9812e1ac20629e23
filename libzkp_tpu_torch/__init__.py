"""libzkp_tpu_torch — the PyTorch / CUDA port of libzkp_tpu for NVIDIA Hopper.

A second package beside the JAX reference ``libzkp_tpu``, ported slice by
slice. Ported: the Bulletproofs backend, its three proof types on one
lockstep batch prover — range proofs (:func:`prove_range_batch`, the main
path), threshold proofs (:func:`prove_threshold_batch`) and consistency
proofs (:func:`prove_consistency_batch`): 64-bit single proofs on the
batched device prover, narrower widths (:func:`prove_range_with_bits`,
:func:`prove_threshold_with_bits`) on the lockstep host prover with its
MSMs on the device; the Groth16 backend, its equality proofs
(:func:`prove_equality_batch`) and set-membership proofs
(:func:`prove_membership_batch`, sets of up to 64 values) on one batched
prover, whose query MSMs over BN254 G1 and G2 run on the same family of
hand-written CUDA kernels (``ops/kernels.py``, sources in ``csrc/``) and
whose h polynomial runs on the device NTT over the Montgomery product
kernel; the MiMC batch (:func:`mimc_hash_batch`) on that kernel; and the
STARK backend, its improvement proofs (:func:`prove_improvement_batch`):
every trace's coset LDE over f128 on the same kernel at 11 limbs and its
leaf digests in one device program, each proof's FRI and serialisation on
the host. The
query MSMs also run sharded over a (dp, shard) device mesh (``parallel/``,
``ops.curve.msm_many_sharded``) when ``parallel.mesh.set_mesh`` names one or
more than one CUDA device is visible. The host primitives (the transcript's
Keccak, Ristretto encode and decode, ed25519 scalar multiplication and MSMs,
the BN254 group operations, the Groth16 sparse products and finish) and
verification run on the native host tier (``native/``, the JAX package's
``zkpcore.cpp``, built with ``g++`` at first use). Proofs and
envelopes are byte-compatible with the JAX package's.

The package exports the reference API's 49 names (:mod:`.api`: the single
proofs, composite proofs, the proof cache and metrics, benchmarks,
``verify_proofs_parallel``, the batch registry with :func:`process_batch`
over all six proof types, and the batch store), beside the port's own batch
entry points. Entry points run on the CUDA card unless called with
``device="cpu"``, which runs the plain PyTorch path. The package imports
neither jax nor ``libzkp_tpu``.
"""

from .api import *  # noqa: F401,F403 (the reference API's 49 names)
from .api import __all__ as _api_names
from .models.schemes.consistency_proof import prove_consistency_batch  # noqa: F401
from .models.schemes.equality_proof import prove_equality_batch  # noqa: F401
from .models.schemes.improvement_proof import prove_improvement_batch  # noqa: F401
from .models.schemes.range_proof import prove_range_batch, prove_range_with_bits  # noqa: F401
from .models.schemes.set_membership import prove_membership_batch  # noqa: F401
from .models.schemes.threshold_proof import (  # noqa: F401
    prove_threshold_batch,
    prove_threshold_with_bits,
)
from .ops.mimc import mimc_hash_batch  # noqa: F401

__all__ = [
    *_api_names,
    # the port's batch entry points
    "mimc_hash_batch",
    "prove_consistency_batch",
    "prove_equality_batch",
    "prove_improvement_batch",
    "prove_membership_batch",
    "prove_range_batch",
    "prove_range_with_bits",
    "prove_threshold_batch",
    "prove_threshold_with_bits",
]
