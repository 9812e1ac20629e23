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

Entry points run on the CUDA card unless called with ``device="cpu"``, which
runs the plain PyTorch path. The package imports neither jax nor
``libzkp_tpu``.
"""

from .models.schemes.consistency_proof import (  # noqa: F401
    prove_consistency,
    prove_consistency_batch,
    verify_consistency,
)
from .models.schemes.equality_proof import (  # noqa: F401
    prove_equality,
    prove_equality_batch,
    verify_equality,
    verify_equality_with_commitment,
)
from .models.schemes.improvement_proof import (  # noqa: F401
    prove_improvement,
    prove_improvement_batch,
    verify_improvement,
)
from .models.schemes.range_proof import (  # noqa: F401
    prove_range,
    prove_range_batch,
    prove_range_with_bits,
    verify_range,
)
from .models.schemes.set_membership import (  # noqa: F401
    prove_membership,
    prove_membership_batch,
    verify_membership,
)
from .models.schemes.threshold_proof import (  # noqa: F401
    prove_threshold,
    prove_threshold_batch,
    prove_threshold_with_bits,
    verify_threshold,
)
from .ops.mimc import mimc_hash_batch  # noqa: F401

# the reference API's alias (libzkp_tpu/advanced/misc.py)
prove_threshold_optimized = prove_threshold

__all__ = [
    "mimc_hash_batch",
    "prove_consistency",
    "prove_consistency_batch",
    "prove_equality",
    "prove_equality_batch",
    "prove_improvement",
    "prove_improvement_batch",
    "prove_membership",
    "prove_membership_batch",
    "prove_range",
    "prove_range_batch",
    "prove_range_with_bits",
    "prove_threshold",
    "prove_threshold_batch",
    "prove_threshold_optimized",
    "prove_threshold_with_bits",
    "verify_consistency",
    "verify_equality",
    "verify_equality_with_commitment",
    "verify_improvement",
    "verify_membership",
    "verify_range",
    "verify_threshold",
]
