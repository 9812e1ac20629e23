"""Production safety limits (DoS guards).

Values mirror the Rust reference ``reference utils/limits.rs:6-27``.
"""

MAX_PROOF_TOTAL_BYTES = 1 * 1024 * 1024  # 1 MiB per serialized Proof
MAX_PROOF_PAYLOAD_BYTES = 900 * 1024  # payload within a Proof
MAX_COMMITMENT_BYTES = 256  # commitment field within a Proof
MAX_U64_VEC_LEN = 4096  # u64 vector deserialization
MAX_BACKEND_PAYLOAD_BYTES = 256 * 1024  # backend op + params payload
MAX_BACKEND_OPERATION_LEN = 64  # backend operation string
MAX_COMPOSITE_PROOF_BYTES = 4 * 1024 * 1024  # serialized CompositeProof
MAX_BULLETPROOFS_BACKEND_PROOF_BYTES = 2 * 1024 * 1024  # bulletproofs backend proofs

U64_MAX = (1 << 64) - 1
U32_MAX = (1 << 32) - 1
