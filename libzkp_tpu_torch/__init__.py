"""libzkp_tpu_torch — the PyTorch / CUDA port of libzkp_tpu for NVIDIA Hopper.

A second package beside the JAX reference ``libzkp_tpu``, ported slice by
slice. Ported: the main path, the batched 64-bit Bulletproofs range prover
(:func:`prove_range_batch`); the batched Groth16 equality prover
(:func:`prove_equality_batch`), whose query MSMs over BN254 G1 and G2 run on
the same family of hand-written CUDA kernels (``ops/kernels.py``, sources in
``csrc/``) and whose h polynomial runs on the device NTT over the Montgomery
product kernel; and the MiMC batch (:func:`mimc_hash_batch`) on that kernel. The query MSMs also run
sharded over a (dp, shard) device mesh (``parallel/``,
``ops.curve.msm_many_sharded``) when ``parallel.mesh.set_mesh`` names one or
more than one CUDA device is visible. Proofs and envelopes are
byte-compatible with the JAX package's.

Entry points run on the CUDA card unless called with ``device="cpu"``, which
runs the plain PyTorch path. The package imports neither jax nor
``libzkp_tpu``.
"""

from .models.schemes.equality_proof import (  # noqa: F401
    prove_equality,
    prove_equality_batch,
    verify_equality,
    verify_equality_with_commitment,
)
from .models.schemes.range_proof import (  # noqa: F401
    prove_range,
    prove_range_batch,
    prove_range_with_bits,
    verify_range,
)
from .ops.mimc import mimc_hash_batch  # noqa: F401

__all__ = [
    "mimc_hash_batch",
    "prove_equality",
    "prove_equality_batch",
    "prove_range",
    "prove_range_batch",
    "prove_range_with_bits",
    "verify_equality",
    "verify_equality_with_commitment",
    "verify_range",
]
