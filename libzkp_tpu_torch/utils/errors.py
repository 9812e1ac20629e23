"""Error taxonomy for libzkp_tpu_torch.

Mirrors the 9-variant ``ZkpError`` enum of the Rust reference
(``reference utils/error_handling.rs:8-18``) and its PyO3 exception
mapping (``error_handling.rs:39-50``):

* ``InvalidInput``                      -> ``ValueError``
* ``InvalidProofFormat``/``ConfigError``-> ``TypeError``
* ``StorageError``                      -> ``RuntimeError``
* everything else                       -> ``RuntimeError``

We realise the mapping structurally: each error class multiply-inherits the
Python builtin the reference maps it to, so ``except ValueError`` etc. behave
identically for callers while ``except ZkpError`` still catches everything.
"""

from __future__ import annotations


class ZkpError(Exception):
    """Base class for all libzkp_tpu_torch errors."""

    kind = "ZkpError"

    def __str__(self) -> str:  # match the reference Display prefixes
        prefix = _DISPLAY_PREFIX.get(type(self).__name__)
        msg = super().__str__()
        if prefix and not msg.startswith(prefix):
            return f"{prefix}{msg}"
        return msg


class InvalidInput(ZkpError, ValueError):
    kind = "InvalidInput"


class ProofGenerationFailed(ZkpError, RuntimeError):
    kind = "ProofGenerationFailed"


class VerificationFailed(ZkpError, RuntimeError):
    kind = "VerificationFailed"


class InvalidProofFormat(ZkpError, TypeError):
    kind = "InvalidProofFormat"


class BackendError(ZkpError, RuntimeError):
    kind = "BackendError"


class SerializationError(ZkpError, RuntimeError):
    kind = "SerializationError"


class CryptoError(ZkpError, RuntimeError):
    kind = "CryptoError"


class ConfigError(ZkpError, TypeError):
    kind = "ConfigError"


class StorageError(ZkpError, RuntimeError):
    kind = "StorageError"


_DISPLAY_PREFIX = {
    "InvalidInput": "Invalid input: ",
    "ProofGenerationFailed": "Proof generation failed: ",
    "VerificationFailed": "Verification failed: ",
    "InvalidProofFormat": "Invalid proof format: ",
    "BackendError": "Backend error: ",
    "SerializationError": "Serialization error: ",
    "CryptoError": "Cryptographic error: ",
    "ConfigError": "Configuration error: ",
    "StorageError": "Storage error: ",
}
