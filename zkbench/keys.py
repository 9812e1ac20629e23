"""The deployment's Groth16 key files: made once from the configuration's
key seed by the reference's setup, written in the arkworks layout the
program reads (``{equality,membership}_mimc_{pk,vk}.bin``), and read back
by every later run. The program is pointed at the directory; the reference
reads the verifying keys from the same files."""

from __future__ import annotations

import os
import random
from pathlib import Path
from typing import Dict

from .reference import circuits, groth16

CIRCUITS = {"equality": ("equality_mimc", circuits.equality_circuit),
            "membership": ("membership_mimc", circuits.membership_circuit)}

KEY_ROOT = Path(__file__).resolve().parent / "keys"


def _write(path: Path, data: bytes) -> None:
    tmp = path.with_name(path.name + ".part")
    tmp.write_bytes(data)
    os.replace(tmp, path)


def ensure(config: dict) -> Path:
    """The key directory of ``config``, made if any file is missing."""
    directory = KEY_ROOT / config["name"]
    directory.mkdir(parents=True, exist_ok=True)
    for kind, (prefix, build) in CIRCUITS.items():
        pk_path, vk_path = directory / f"{prefix}_pk.bin", directory / f"{prefix}_vk.bin"
        if pk_path.exists() and vk_path.exists():
            continue
        pk = groth16.setup(build(), random.Random(f"{config['snark_key_seed']}:{kind}"))
        _write(pk_path, groth16.pk_to_bytes(pk))
        _write(vk_path, groth16.vk_to_bytes(pk.vk))
    return directory


def verifying_keys(directory: Path) -> Dict[str, groth16.VerifyingKey]:
    out = {}
    for kind, (prefix, _) in CIRCUITS.items():
        vk = groth16.vk_from_bytes((directory / f"{prefix}_vk.bin").read_bytes())
        if vk is None:
            raise ValueError(f"unreadable verifying key in {directory}")
        out[kind] = vk
    return out
