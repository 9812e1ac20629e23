"""The port stands alone: it imports neither jax nor the JAX package, and its
entry points run on CUDA unless the CPU is asked for by name. The JAX
package is imported here only to make a membership key and proof, which a
subprocess of the port alone verifies."""

from __future__ import annotations

import json
import os
import subprocess
import sys
from pathlib import Path

import pytest

from libzkp_tpu.models import groth16 as jg
from libzkp_tpu.models import snark_backend as jsb
from libzkp_tpu.models.schemes import set_membership as jsm

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


def test_port_imports_neither_jax_nor_reference(tmp_path):
    jpk = jsb._get_membership_setup()
    (tmp_path / "membership_mimc_pk.bin").write_bytes(jg.pk_to_bytes(jpk))
    (tmp_path / "membership_mimc_vk.bin").write_bytes(jg.vk_to_bytes(jpk.vk))
    membership = jsm.prove_membership(25, [10, 20, 25])
    code = f"""
import json, sys
import libzkp_tpu_torch as zkp
from libzkp_tpu_torch import convert, native, probes
from libzkp_tpu_torch.parallel import collective, mesh
from libzkp_tpu_torch.models import groth16, r1cs, snark_backend
from libzkp_tpu_torch.models import merkle, random_coin, stark, stark_backend, winterfell_wire
from libzkp_tpu_torch.models.schemes import consistency_proof, equality_proof, set_membership
from libzkp_tpu_torch.models.schemes import improvement_proof, threshold_proof
from libzkp_tpu_torch.ops import bn254, field, kernels, mimc, msm_device, ntt, ristretto, weierstrass
from libzkp_tpu_torch.ops import blake3, blake3_device, groth16_device, limb, stark_device
from libzkp_tpu_torch.utils.commitment import commit_value_snark
from libzkp_tpu_torch import advanced, api
from libzkp_tpu_torch.advanced import batch, batch_store, composite, misc
from libzkp_tpu_torch.models.schemes import dispatch
from libzkp_tpu_torch.parallel import batch_prover, dryrun
from libzkp_tpu_torch.ops.field import F128
from libzkp_tpu_torch.utils import composition, performance, serialization
env = zkp.prove_range(7, 0, 10, device="cpu")
# verification runs on the port's own native library
rlc_calls = []
verify_rlc = native.bp_verify_rlc
native.bp_verify_rlc = lambda *a: rlc_calls.append(1) or verify_rlc(*a)
ok = zkp.verify_range(env, 0, 10) and len(rlc_calls) == 1
ok = ok and native.load()._name.startswith(str(native.BUILD_DIR))
ok = ok and zkp.verify_threshold(zkp.prove_threshold([3, 4], 5, device="cpu"), 5)
# the Groth16 slice's host pipeline: commitment, circuit, CSR, h
v = 7
fr = int.from_bytes(commit_value_snark(v), "little")
cs = snark_backend.build_equality_circuit(v, v, fr)
num_instance, csr = snark_backend._equality_shape()
z = snark_backend._equality_assignment(v, v, fr)
h = groth16._h_from_csr(512, num_instance, csr, z)
ok = ok and cs.is_satisfied() and h == groth16._compute_h(cs, 512)
# the device h and the MiMC batch on their plain versions
rows = native.groth16_spmv(512, len(csr[0][0]) - 1, num_instance, groth16.R,
                           groth16._packed_csr(csr), z)
ok = ok and groth16_device.h_batch_device(512, [rows], device="cpu") == [h]
ok = ok and zkp.mimc_hash_batch([v], device="cpu") == [mimc.mimc_hash_native(v)] == [fr]
# a membership proof of the JAX package's key verifies on one native pairing
snark_backend.set_snark_key_dir({str(tmp_path)!r})
pairings = []
premul = native.bn254_multi_pairing_premul
native.bn254_multi_pairing_premul = lambda *a: pairings.append(1) or premul(*a)
ok = ok and zkp.verify_membership(bytes.fromhex("{membership.hex()}"), [25, 10, 20])
ok = ok and len(pairings) == 1
# an improvement proof on the CPU route, verified natively and by the golden
imp = zkp.prove_improvement(30, 50, device="cpu")
ok = ok and zkp.verify_improvement(imp, 30) and not zkp.verify_improvement(imp, 31)
ok = ok and stark_backend.verify_improvement_py(imp[26:-32], 30, 50)
# the reference API's composite and batched verification over them
ok = ok and zkp.verify_composite_proof(zkp.create_composite_proof([env, imp]))
ok = ok and zkp.verify_proofs_parallel([(env, "range"), (imp, "improvement"), (imp, "range")]) == [
    True, True, False]
# the multi-device layer: a collective, the four-step NTT and the LDE's dp split
cpu4 = mesh.get_mesh(dp=2, shard=2, devices=["cpu"] * 4)
ok = ok and collective.axis_size("dp", mesh=cpu4) == 2 and mesh.init_distributed() is False
ok = ok and ntt.ntt_sharded(F128.p, list(range(16)), cpu4) == ntt.ntt_py(F128, list(range(16)))
ok = ok and ntt.coset_lde_batch(F128.p, [[1] * 8] * 3, 8, 3, device="cpu", mesh=cpu4) == ntt.coset_lde_batch(
    F128.p, [[1] * 8] * 3, 8, 3, device="cpu")
# the device BLAKE3 tree, the Ristretto decode and encode, round-1 key files
leaves, levels = blake3_device.merkle_tree_device([b"a", b"b"], device="cpu")
ok = ok and levels[0][0] == merkle.MerkleTree(leaves).root
ok = ok and merkle.hash_element_rows(F128, [[5]], device="cpu") == merkle.hash_element_rows(F128, [[5]])
from libzkp_tpu_torch.ops import ed25519 as ed
enc = ristretto.ristretto_compress_device([ed.BASEPOINT], device="cpu")
ok = ok and enc == [ed.compress(ed.BASEPOINT)]
ok = ok and ristretto.ristretto_decompress_device(enc + [b"x"], device="cpu") == [ed.decompress(enc[0]), None]
ok = ok and groth16.pk_from_bytes(b"LZTK" + bytes(4)) is None
mods = [m for m in sys.modules if m == "jax" or m.startswith(("jax.", "jaxlib", "libzkp_tpu."))
        or m == "libzkp_tpu"]
print(json.dumps({{"ok": ok, "mods": mods}}))
"""
    proc = _run(code)
    assert proc.returncode == 0, proc.stderr
    out = json.loads(proc.stdout.strip().splitlines()[-1])
    assert out == {"ok": True, "mods": []}


@pytest.mark.parametrize("call", [
    "zkp.prove_range(7, 0, 10)",
    "zkp.prove_range_batch([(7, 0, 10)])",
    "zkp.prove_range_with_bits(7, 0, 10, 8)",
    "zkp.prove_threshold([3, 4], 5)",
    "zkp.prove_threshold_batch([([3, 4], 5)])",
    "zkp.prove_consistency([1, 2])",
    "zkp.prove_consistency_batch([[1, 2]])",
    "bp.prove_single_batch([(Transcript(b'x'), 7, 1, 64)])",
    "zkp.prove_equality(7, 7)",
    "zkp.prove_equality_batch([(7, 7), (8, 8)])",
    "zkp.prove_membership(7, [3, 7])",
    "zkp.prove_membership_batch([(7, [7]), (8, [8, 9])])",
    "mesh.get_mesh()",
    "probes.run()",
    "zkp.mimc_hash_batch([1, 2])",
    "zkp.prove_improvement(1, 8)",
    "zkp.prove_improvement_batch([(1, 8)])",
    "zkp.process_batch(zkp.create_proof_batch())",
    "zkp.prove_range_cached(7, 0, 10)",
    "zkp.benchmark_proof_generation_numeric('improvement', 1)",
    "dryrun.dryrun_multichip(4)",
    "blake3_device.hash_leaves_device([b'x'])",
    "blake3_device.merkle_tree_device([b'x', b'y'])",
    "merkle.hash_element_rows(F128, [[1]], device='cuda')",
    "ristretto.ristretto_decompress_device([bytes(32)])",
    "ristretto.ristretto_compress_device([(0, 1, 1, 0)])",
])
def test_entry_points_raise_without_cuda(call):
    code = f"""
import libzkp_tpu_torch as zkp
from libzkp_tpu_torch import probes
from libzkp_tpu_torch.models import bulletproofs as bp
from libzkp_tpu_torch.models.strobe import Transcript
from libzkp_tpu_torch.parallel import dryrun, mesh
from libzkp_tpu_torch.models import merkle
from libzkp_tpu_torch.ops import blake3_device, ristretto
from libzkp_tpu_torch.ops.field import F128
try:
    {call}
except RuntimeError as e:
    assert "torch.cuda.is_available() is False" in str(e), e
    print("raised")
"""
    proc = _run(code, hide_gpus=True)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip() == "raised"
