"""libzkp_tpu_torch — the PyTorch / CUDA port of libzkp_tpu for NVIDIA Hopper.

A second package beside the JAX reference ``libzkp_tpu``, ported slice by
slice. This slice is the main path: the batched 64-bit Bulletproofs range
prover, from :func:`prove_range_batch` down to three hand-written CUDA
kernels (``ops/kernels.py``, sources in ``csrc/``). Proofs and envelopes are
byte-compatible with the JAX package's.

Entry points run on the CUDA card unless called with ``device="cpu"``, which
runs the plain PyTorch path. The package imports neither jax nor
``libzkp_tpu``.
"""

from .models.schemes.range_proof import (  # noqa: F401
    prove_range,
    prove_range_batch,
    prove_range_with_bits,
    verify_range,
)

__all__ = ["prove_range", "prove_range_batch", "prove_range_with_bits", "verify_range"]
