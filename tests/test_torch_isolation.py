"""The port stands alone: it imports neither jax nor the JAX package, and its
entry points run on CUDA unless the CPU is asked for by name."""

from __future__ import annotations

import json
import os
import subprocess
import sys
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parent.parent


def _run(code: str, hide_gpus: bool = False) -> subprocess.CompletedProcess:
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = str(REPO)
    env["OMP_NUM_THREADS"] = "1"  # several test workers share the cores
    if hide_gpus:
        env["CUDA_VISIBLE_DEVICES"] = ""
    return subprocess.run(
        [sys.executable, "-c", code], cwd=REPO, env=env, capture_output=True, text=True,
        timeout=600,
    )


def test_port_imports_neither_jax_nor_reference():
    code = """
import json, sys
import libzkp_tpu_torch as zkp
from libzkp_tpu_torch import convert
from libzkp_tpu_torch.ops import kernels, ristretto
env = zkp.prove_range(7, 0, 10, device="cpu")
ok = zkp.verify_range(env, 0, 10)
mods = [m for m in sys.modules if m == "jax" or m.startswith(("jax.", "jaxlib", "libzkp_tpu."))
        or m == "libzkp_tpu"]
print(json.dumps({"ok": ok, "mods": mods}))
"""
    proc = _run(code)
    assert proc.returncode == 0, proc.stderr
    out = json.loads(proc.stdout.strip().splitlines()[-1])
    assert out == {"ok": True, "mods": []}


@pytest.mark.parametrize("call", [
    "zkp.prove_range(7, 0, 10)",
    "zkp.prove_range_batch([(7, 0, 10)])",
    "bp.prove_single_batch([(Transcript(b'x'), 7, 1, 64)])",
])
def test_entry_points_raise_without_cuda(call):
    code = f"""
import libzkp_tpu_torch as zkp
from libzkp_tpu_torch.models import bulletproofs as bp
from libzkp_tpu_torch.models.strobe import Transcript
try:
    {call}
except RuntimeError as e:
    assert "torch.cuda.is_available() is False" in str(e), e
    print("raised")
"""
    proc = _run(code, hide_gpus=True)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip() == "raised"
