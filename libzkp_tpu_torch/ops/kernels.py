"""The hand-written Hopper kernels, their build and their wrappers.

Nine CUDA C++ sources under ``libzkp_tpu_torch/csrc/``, each compiled for
``sm_90a`` by ``nvcc`` into its own shared library with a plain C interface
and bound with ``ctypes``; the field and curve code they share is
``csrc/fold_curves.cuh``, the Montgomery field code ``csrc/mont.cuh``, the
cooperative padds (BN254 G1 and G2, the Edwards padd and pdouble of
ed25519) and tree sum ``csrc/coop_sum.cuh`` (window_sum ed25519,
window_sum4 G1 and G2, tree_sum on every curve) and the Horner chain on them
``csrc/coop_horner.cuh`` (horner and pair_add on every curve, horner4 G1
and G2, and the P2 chain ``padd_chain``). Each kernel is instantiated
for the curves its path runs, and each instance is a kernel of its own,
named ``<kernel>`` for ed25519 or a field-generic kernel and
``<kernel>_<curve>`` for BN254 or ``<kernel>_<variant>`` for a probe's
variant (:data:`INSTANCES`):

* ``window_sum`` (K1, ``csrc/window_sum.cu``, ed25519) replaces
  ``libzkp_tpu/ops/curve_jax.py:_window_fused_call``;
* ``horner`` (K2, ``csrc/horner.cu``; ed25519, bn254_g1, bn254_g2) replaces
  ``_horner_call``;
* ``pair_add`` (K3, ``csrc/pair_add.cu``; ed25519, bn254_g1, bn254_g2)
  replaces ``_pair_add_call``;
* ``window_sum4`` (``csrc/window_sum4.cu``; bn254_g1, bn254_g2) replaces
  ``_window_fused4_call``;
* ``horner4`` (``csrc/horner4.cu``; bn254_g1, bn254_g2) replaces
  ``_horner4_call``;
* ``tree_sum`` (``csrc/tree_sum.cu``; ed25519, bn254_g1, bn254_g2) replaces
  ``_window_sum_call``, the window sum of the mesh-sharded MSM;
* ``padd_chain`` and ``fe_mul`` (``csrc/probes.cu``) replace the Pallas
  probes of ``scripts/bench_pallas_padd.py`` (``bench_current``) and
  ``scripts/bench_fold.py`` (``bench_field``); ``fe_mul`` runs in the field of
  the curve it is named for (ed25519: p = 2^255 - 19; bn254_g1: BN254 Fq);
* ``mont_mul`` (``csrc/mont.cu``, header ``csrc/mont.cuh``) is the 12-bit
  Montgomery product of :mod:`.limb` (``scripts/bench_pallas_mul.py``
  ``main.pallas_mul``): every product of the Groth16 h pipeline and of the
  MiMC batch, and of the STARK batch's coset LDE over f128. It takes its
  field from its consts block, so it has one instance per limb count
  (:data:`MONT_NS`): ``mont_mul`` at 22 limbs (BN254 Fr, 2^255 - 19) and
  ``mont_mul_n11`` at 11 (f128);
* ``mont_padd``, ``fold_ablate`` and ``padd_f32_chain`` (``csrc/probes.cu``)
  replace the Pallas probes ``main.pallas_add`` of
  ``scripts/bench_pallas_mul.py`` (P7), ``run`` of
  ``scripts/bench_ablate.py`` (P1; one instance per variant) and
  ``bench_mxu`` of ``scripts/bench_pallas_padd.py`` (P3);
* ``blake3`` (``csrc/blake3.cu``) is the BLAKE3 compression of
  :mod:`.blake3_device`, one lane a thread: it replaces no Pallas kernel but
  the jnp program ``_leaves_run`` (``libzkp_tpu/ops/blake3_device.py``),
  one launch for a batch's leaf digests and one for each Merkle level.

Each wrapper takes the kernel's plain PyTorch version (``*_plain``, in this
module) for tensors on the CPU, and launches the kernel for tensors on a CUDA
device, or raises: there is no fall back from a failed build or launch. The
libraries are built at first use into ``libzkp_tpu_torch/_build/`` (all
``nvcc`` processes at once), never at import. Each wrapper adds one to its
instance's count in :func:`launches` where it launches the kernel.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import re
import shutil
import subprocess
from pathlib import Path
from typing import Dict

import torch
import torch.nn.functional as F

from .edwards import _tree_reduce
from .limbfold import LIMB_BITS, LIMB_MASK, FieldOps
from .weierstrass import CURVES, get_engine

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"
SOURCES = {
    "window_sum": "window_sum.cu",
    "horner": "horner.cu",
    "pair_add": "pair_add.cu",
    "window_sum4": "window_sum4.cu",
    "horner4": "horner4.cu",
    "tree_sum": "tree_sum.cu",
    "padd_chain": "probes.cu",
    "fe_mul": "probes.cu",
    "mont_mul": "mont.cu",
    "mont_padd": "probes.cu",
    "fold_ablate": "probes.cu",
    "padd_f32_chain": "probes.cu",
    "blake3": "blake3.cu",
}
ABLATE_VARIANTS = ("conv", "conv8", "carry5", "fold", "mac")  # P1, scripts/bench_ablate.py
KERNEL_CURVES = {
    "window_sum": ("ed25519",),
    "horner": CURVES,
    "pair_add": CURVES,
    "window_sum4": ("bn254_g1", "bn254_g2"),
    "horner4": ("bn254_g1", "bn254_g2"),
    "tree_sum": CURVES,
    "padd_chain": ("ed25519",),
    "fe_mul": ("ed25519", "bn254_g1"),
    "mont_mul": (None, "n11"),  # field-generic: one instance a limb count (MONT_NS)
    "mont_padd": (None,),
    "fold_ablate": ABLATE_VARIANTS,
    "padd_f32_chain": (None,),
    "blake3": (None,),
}
LIBRARIES = tuple(dict.fromkeys(Path(src).stem for src in SOURCES.values()))  # one per source
WIN_GROUP = 4  # windows per window_sum4 / horner4 launch
NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
]

_P = ctypes.c_void_p
_I = ctypes.c_int
_L = ctypes.c_longlong
_ARGTYPES = {
    "window_sum": [_P, _P, _P, _P, _I, _I, _I, _I, _P],  # cooperative: (blocks,) warps, shared bytes
    "horner": [_P, _P, _P, _P, _I, _I, _I, _I, _P],
    "pair_add": [_P, _P, _P, _P, _I, _I, _I, _I, _P],
    "window_sum4": [_P, _P, _P, _P, _I, _I, _I, _I, _P],  # G2: warps, shared bytes
    "horner4": [_P, _P, _P, _P, _I, _I, _I, _I, _P],
    "tree_sum": [_P, _P, _P, _I, _I, _I, _I, _P],  # cooperative: warps, shared bytes
    "padd_chain": [_P, _P, _P, _P, _I, _I, _I, _I, _I, _P],  # + blocks, warps, shared bytes
    "fe_mul": [_P, _P, _P, _P, _I, _P],
    "mont_mul": [_P, _P, _P, _P, _I, _L, _L, _I, _P],  # + rows a block
    "mont_padd": [_P, _P, _P, _P, _I, _I, _P],  # + threads a block
    "fold_ablate": [_P, _P, _P, _P, _I, _I, _P],
    "padd_f32_chain": [_P, _P, _P, _P, _I, _I, _P],
    "blake3": [_P, _P, _L, _I, _I, _P],  # msg, out, lanes, block_len, flags
    # the other cooperative instances also take their geometry
    "window_sum4_bn254_g1": [_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _P],  # + partials
}

# Geometry of the cooperative kernels (csrc/coop_sum.cuh): six threads share
# a BN254 padd, five padds a warp, four an ed25519 padd or pdouble, eight a
# warp, each with its int32 scratch rows (horner G2's and pair_add G2's
# padd: 18 threads, one a warp); the tree sums (window_sum ed25519,
# window_sum4 G2, tree_sum on every curve) run one block per output lane with
# a level store of ceil(K/2) int16 points; window_sum4 G1 first gives each of
# a lane's G nodes of the same tree to one group (window_sum4_g1_geometry);
# the Horner steps (horner on every curve, horner4 G1 and G2) and pair_add
# on every curve one group per lane, holding its accumulator and its window
# sums (pair_add: p and q) as int16 points.
COOP_PADDS_PER_WARP = {"ed25519": 8, "bn254_g1": 5, "bn254_g2": 5}
COOP_MAX_WARPS = 12        # 384 threads a block (the kernels' launch bounds)
POINT_BYTES = {"ed25519": 4 * 24 * 2, "bn254_g1": 3 * 24 * 2, "bn254_g2": 6 * 24 * 2}
COOP_SCRATCH_BYTES = {"ed25519": 4 * 24 * 4, "bn254_g1": 15 * 24 * 4, "bn254_g2": 32 * 24 * 4}
COOP_HORNER_WARPS = 1      # one warp a block, each alone on its SM at the paths' lane counts
# P2's chain (padd_chain): four warps a block, 16 blocks at its 512 lanes
# (chip_smoke's ed_chain line: 9 % faster than one or two warps a block)
CHAIN_WARPS = 4
# The ed25519 tree sums (K1, tree_sum): at most this many warps an SM over
# all lanes. The four-thread padd keeps the card's integer pipes busy from
# about 8 warps an SM on; more warps a lane then only lengthen the tree's
# tail (chip_smoke's k1_warps line: 1 warp a lane fastest at 1024 lanes, 2
# at 512).
ED_SUM_WARPS_PER_SM = 8
G2_HORNER_PER_WARP = 1     # horner G2, pair_add G2: one 18-thread group a warp
# window_sum4 G1 (csrc/window_sum4.cu): kernel 1's one-warp blocks an SM and
# kernel 2's largest block, both as the kernels' launch bounds promise them
# registers (at most 112 and 128 a thread), and the waves of kernel 1 blocks
# the rule asks for: one wave of padd chains ends ragged (chip_smoke's
# ws4_g1_groups line: at Kp 512 and 1024 lanes, G = 32, 2.8 waves, 6 %
# faster than G = 8, 0.7 of a wave)
WS4_G1_NODE_BLOCKS = 18
WS4_G1_TOP_WARPS = 8
WS4_G1_WAVES = 2
SMEM_BLOCK_MAX = 232_448   # dynamic shared memory one block may use (H100)
SMEM_SM = 233_472          # shared memory of an SM; each resident block also holds 1 KiB


def coop_sum_geometry(curve: str, K: int, lanes: int, sms: int) -> tuple:
    """(warps per block, dynamic shared bytes) of a cooperative tree sum
    over ``K`` points of ``curve`` for ``lanes`` output lanes on a card of
    ``sms`` SMs: enough warps for level 1's K // 2 padds at once, up to what
    shared memory holds; when the lanes outnumber twice the SMs, few enough
    that two blocks share an SM; for ed25519 (K1, tree_sum), no more than
    ED_SUM_WARPS_PER_SM warps an SM over all lanes. Raises where the level
    store and one warp's scratch exceed a block's shared memory."""
    if K < 1:
        raise ValueError(f"a {curve} tree sum needs at least one point, got {K}")
    store = (K + 1) // 2 * POINT_BYTES[curve]
    padds = COOP_PADDS_PER_WARP[curve]
    per_warp = padds * COOP_SCRATCH_BYTES[curve]
    if store + per_warp > SMEM_BLOCK_MAX:
        raise ValueError(f"a {curve} tree sum over {K} points needs {store + per_warp} bytes of "
                         f"shared memory a block, above the {SMEM_BLOCK_MAX} the card allows")
    limit = SMEM_BLOCK_MAX if lanes < 2 * sms else SMEM_SM // 2 - 1024
    warps = min(COOP_MAX_WARPS, -(-(K // 2) // padds), (limit - store) // per_warp)
    if curve == "ed25519":
        warps = min(warps, ED_SUM_WARPS_PER_SM * sms // lanes)
    warps = max(1, warps)
    return warps, store + warps * per_warp


def coop_horner_geometry(curve: str, lanes: int, windows: int, warps: int = COOP_HORNER_WARPS) -> tuple:
    """(blocks, warps per block, dynamic shared bytes) of a cooperative
    Horner step of ``windows`` windows (1: horner, or pair_add, one
    addition over ``lanes`` = K lanes, or P2's chain; WIN_GROUP: horner4)
    over ``lanes`` lanes of ``curve``, ``warps`` warps a block: eight lanes
    a warp on four-thread Edwards steps, five on six-thread padds, one on
    the 18-thread G2 padd of horner G2 and pair_add G2. Each lane's group
    holds its accumulator, its window sums and its padd scratch."""
    if lanes < 1:
        raise ValueError(f"a {curve} Horner step needs at least one lane, got {lanes}")
    per_warp = G2_HORNER_PER_WARP if (curve, windows) == ("bn254_g2", 1) else COOP_PADDS_PER_WARP[curve]
    per_block = warps * per_warp
    smem = per_block * ((1 + windows) * POINT_BYTES[curve] + COOP_SCRATCH_BYTES[curve])
    return -(-lanes // per_block), warps, smem


def window_sum4_g1_geometry(Kp: int, lanes: int, sms: int, groups: int = None) -> tuple:
    """(G, kernel 1's dynamic shared bytes, kernel 2's warps per block and
    dynamic shared bytes) of window_sum4 G1 over ``Kp`` points for ``lanes``
    output lanes on a card of ``sms`` SMs (``csrc/window_sum4.cu``).

    Every lane's tree splits into G nodes of 2^l = Kp / G points each, G
    one of Kp, Kp / 2, ... down to Kp's odd part; kernel 1 runs one
    six-thread group a node (G = Kp: none), with l int16 points and its padd
    scratch in shared memory, and kernel 2 the tree over a lane's G nodes.
    The rule, among the G whose kernel 1 blocks fit WS4_G1_NODE_BLOCKS to
    an SM's shared memory: the fewest nodes (the longest chains) that still
    give WS4_G1_WAVES waves of such blocks an SM; with too few lanes for
    that, the card is not full and the G of the fewest dependent padd steps
    (kernel 1's chain, then kernel 2's block steps of 5 padds a warp, a
    level at a time), the larger G on a tie. ``groups`` forces G. Every G
    sums the plain tree, so the limbs do not depend on it. Raises for a G
    that does not split Kp so, or where kernel 2's level store and one
    warp's scratch exceed a block's shared memory."""
    if Kp < 1 or lanes < 1:
        raise ValueError(f"window_sum4 G1 needs points and lanes, got Kp {Kp}, {lanes} lanes")
    point, scratch = POINT_BYTES["bn254_g1"], COOP_SCRATCH_BYTES["bn254_g1"]
    padds = COOP_PADDS_PER_WARP["bn254_g1"]

    def nodes_smem(G):
        ell = (Kp // G).bit_length() - 1
        return padds * (ell * point + scratch) if ell else 0

    per_warp = padds * scratch

    def top_warps(G):
        store = (G + 1) // 2 * point
        return max(1, min(WS4_G1_TOP_WARPS, -(-(G // 2) // padds), (SMEM_SM // 2 - 1024 - store) // per_warp))

    def steps(G):  # dependent padd steps of one lane: kernel 1's chain, kernel 2's levels
        n, out = G, Kp // G - 1
        while n > 1:
            out += -(-(n // 2) // (padds * top_warps(G)))
            n -= n // 2
        return out

    cands = [Kp]
    while cands[-1] % 2 == 0:
        cands.append(cands[-1] // 2)
    if groups is None:
        fit = [G for G in cands if WS4_G1_NODE_BLOCKS * (nodes_smem(G) + 1024) <= SMEM_SM]
        full = [G for G in fit if -(-lanes * G // padds) >= WS4_G1_WAVES * WS4_G1_NODE_BLOCKS * sms]
        G = min(full) if full else min(fit, key=lambda G: (steps(G), -G))
    elif groups in cands:
        G = groups
    else:
        raise ValueError(f"{groups} nodes do not split {Kp} points into powers of two")
    store = (G + 1) // 2 * point
    if store + per_warp > SMEM_BLOCK_MAX:
        raise ValueError(f"window_sum4 G1's tree over {G} nodes needs {store + per_warp} bytes of "
                         f"shared memory a block, above the {SMEM_BLOCK_MAX} the card allows")
    warps = top_warps(G)
    return G, nodes_smem(G), warps, store + warps * per_warp


def _coop_geometry(dev: torch.device, curve: str, K: int, lanes: int) -> tuple:
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    return coop_sum_geometry(curve, K, lanes, sms)


def instance(kernel: str, curve) -> str:
    """Name of a kernel's instance for one curve (or variant; None for a
    kernel with one instance)."""
    return kernel if curve in ("ed25519", None) else f"{kernel}_{curve}"


INSTANCES = tuple(instance(k, c) for k in SOURCES for c in KERNEL_CURVES[k])
_LAUNCHES: Dict[str, int] = dict.fromkeys(INSTANCES, 0)


def reset_launches() -> None:
    for name in _LAUNCHES:
        _LAUNCHES[name] = 0


def launches() -> Dict[str, int]:
    """Kernel launches per instance since the last :func:`reset_launches`."""
    return dict(_LAUNCHES)


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    return str(Path(os.environ.get("CUDA_HOME", "/usr/local/cuda")) / "bin" / "nvcc")


def _sources(lib: str) -> list:
    """``{lib}.cu`` and every header it includes from ``csrc/``, directly or
    through another header, in include order."""
    out, todo = [], [f"{lib}.cu"]
    while todo:
        name = todo.pop(0)
        if name in out:
            continue
        out.append(name)
        todo += re.findall(r'^\s*#\s*include\s+"([^"]+)"', (CSRC / name).read_text(), re.M)
    return out


def _library_path(lib: str) -> Path:
    """Build output named by a digest of the source, the headers it includes
    and the flags, so an edited source or header is rebuilt and never served
    a stale library."""
    h = hashlib.sha256()
    for part in _sources(lib):
        h.update(part.encode())
        h.update((CSRC / part).read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"{lib}-{h.hexdigest()[:16]}.so"


def build() -> Dict[str, Path]:
    """Compile every kernel library not built yet, one ``nvcc`` per source
    (:data:`LIBRARIES`), all started together. Returns ``{library: path}``;
    raises on a failed compile with the compiler's log. ``-Xptxas -v`` leaves
    each source's registers and spills in ``_build/<library>.log``."""
    BUILD_DIR.mkdir(exist_ok=True)
    paths = {lib: _library_path(lib) for lib in LIBRARIES}
    procs = {}
    try:
        for lib, so in paths.items():
            if so.exists():
                continue
            tmp = so.with_name(f"{so.stem}.{os.getpid()}.tmp.so")
            with open(BUILD_DIR / f"{lib}.log", "wb") as log:
                cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{lib}.cu")]
                procs[lib] = (subprocess.Popen(cmd, stdout=log, stderr=subprocess.STDOUT), tmp)
        failed = []
        for lib, (proc, tmp) in procs.items():
            if proc.wait() != 0:
                failed.append(lib)
            else:
                os.replace(tmp, paths[lib])
        if failed:
            logs = "\n".join(
                f"--- {n} ---\n" + (BUILD_DIR / f"{n}.log").read_text(errors="replace")
                for n in failed
            )
            raise RuntimeError(f"nvcc failed for {failed}:\n{logs}")
    finally:
        for proc, _ in procs.values():
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    return paths


@functools.lru_cache(maxsize=None)
def _launcher(name: str, curve):
    lib = ctypes.CDLL(str(build()[Path(SOURCES[name]).stem]))
    fn = getattr(lib, f"{name}_{curve}_launch" if curve else f"{name}_launch")
    fn.argtypes = _ARGTYPES.get(instance(name, curve), _ARGTYPES[name])
    fn.restype = ctypes.c_int
    return fn


def _run(name: str, curve, dev: torch.device, *args) -> None:
    with torch.cuda.device(dev):
        err = _launcher(name, curve)(*args, torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"{instance(name, curve)} kernel launch failed with CUDA error {err}")
    _LAUNCHES[instance(name, curve)] += 1


def _engine(kernel: str, curve: str):
    if curve not in KERNEL_CURVES[kernel]:
        raise ValueError(f"{kernel} has no {curve} instance")
    return get_engine(curve)


def _check_cuda(eng, consts: torch.Tensor, **tensors) -> torch.device:
    """The kernels take contiguous tensors on one CUDA device and the
    curve's int32 consts block."""
    dev = consts.device
    if dev.type != "cuda":
        raise ValueError(f"kernel wrappers take CUDA or CPU tensors, got {dev}")
    if consts.dtype != torch.int32 or tuple(consts.shape) != eng.consts_np.shape:
        raise ValueError(f"consts must be the {eng.consts_np.shape} int32 consts block")
    for key, t in {"consts": consts, **tensors}.items():
        if t.device != dev:
            raise ValueError(f"{key} is on {t.device}, consts on {dev}")
        if not t.is_contiguous():
            raise ValueError(f"{key} must be contiguous")
    return dev


def _check_points(eng, name: str, t: torch.Tensor, lanes: int) -> None:
    if t.dtype != torch.int32 or tuple(t.shape) != (eng.coords, eng.n, lanes):
        raise ValueError(f"{name} must be ({eng.coords}, {eng.n}, {lanes}) int32")


def _check_table(eng, table: torch.Tensor, digits: torch.Tensor, Kp: int) -> None:
    if digits.dtype != torch.int32:
        raise ValueError("digits must be int32")
    if table.dtype != torch.int16 or tuple(table.shape) != (Kp * 256, eng.coords, eng.n):
        raise ValueError(f"table must be ({Kp * 256}, {eng.coords}, {eng.n}) int16")


def _gather(table: torch.Tensor, digits: torch.Tensor) -> torch.Tensor:
    """Rows of the int16 multiples table for (Kp, L) digits -> (L, Kp, C, n)
    int16, the lane-major layout ``tree_sum`` reads."""
    Kp = digits.shape[0]
    koff = torch.arange(Kp, device=digits.device, dtype=torch.int64) * 256
    return table[digits.T.to(torch.int64) + koff]


# ---------------------------------------------------------------------------
# K1: window sum (ed25519)
# ---------------------------------------------------------------------------


def window_sum_plain(consts: torch.Tensor, table: torch.Tensor, digits: torch.Tensor) -> torch.Tensor:
    """Plain version of K1 (limbs equal the JAX ``_window_fused_call`` CPU
    branch)."""
    return tree_sum_plain(consts, _gather(table, digits), curve="ed25519")


def window_sum(consts: torch.Tensor, table: torch.Tensor, digits: torch.Tensor) -> torch.Tensor:
    """Sum over the basis of each lane's table multiples for one window.

    ``table``: (Kp*256, 4, n) int16; ``digits``: (Kp, B) int32 in [0, 256).
    Returns (4, n, B) int32. The kernel sums in the plain version's tree
    order, so its limbs equal ``window_sum_plain``'s."""
    if table.device.type == "cpu":
        return window_sum_plain(consts, table, digits)
    eng = _engine("window_sum", "ed25519")
    dev = _check_cuda(eng, consts, table=table, digits=digits)
    Kp, B = digits.shape
    _check_table(eng, table, digits, Kp)
    out = torch.empty((eng.coords, eng.n, B), dtype=torch.int32, device=table.device)
    _run("window_sum", "ed25519", dev, consts.data_ptr(), table.data_ptr(), digits.data_ptr(),
         out.data_ptr(), Kp, B, *_coop_geometry(dev, "ed25519", Kp, B))
    return out


# ---------------------------------------------------------------------------
# K2: Horner step, every curve
# ---------------------------------------------------------------------------


def horner_plain(consts: torch.Tensor, acc: torch.Tensor, wsum: torch.Tensor, *,
                 curve: str = "ed25519") -> torch.Tensor:
    """Plain version of K2: 8 doublings then one addition (the loop of the
    JAX ``_horner_call`` CPU branch)."""
    eng = get_engine(curve)
    for _ in range(8):
        acc = eng.pdouble(consts, acc)
    return eng.padd(consts, acc, wsum)


def horner(consts: torch.Tensor, acc: torch.Tensor, wsum: torch.Tensor, *,
           curve: str = "ed25519") -> torch.Tensor:
    """acc <- 2^8 * acc + wsum over (C, n, B) int32 lanes.

    The kernels narrow ``acc`` and ``wsum`` to int16 (their precondition):
    every limb must lie in int16, as on the range prover's window walk,
    where ``acc`` is the identity or an earlier ``horner`` output and
    ``wsum`` a ``window_sum`` output, and on the mesh's v1 walk, where
    ``wsum`` is a ``tree_sum`` output; every padd output limb lies in
    [-7643, 11737] (BN254, ``csrc/fold_curves.cuh``) or [-1536, 5631]
    (ed25519, ``csrc/coop_sum.cuh``)."""
    if acc.device.type == "cpu":
        return horner_plain(consts, acc, wsum, curve=curve)
    eng = _engine("horner", curve)
    dev = _check_cuda(eng, consts, acc=acc, wsum=wsum)
    B = acc.shape[-1]
    _check_points(eng, "acc", acc, B)
    _check_points(eng, "wsum", wsum, B)
    out = torch.empty_like(acc)
    _run("horner", curve, dev, consts.data_ptr(), acc.data_ptr(), wsum.data_ptr(),
         out.data_ptr(), B, *coop_horner_geometry(curve, B, 1))
    return out


# ---------------------------------------------------------------------------
# K3: elementwise point addition (table-build step), every curve
# ---------------------------------------------------------------------------


def pair_add_plain(consts: torch.Tensor, p: torch.Tensor, q: torch.Tensor, *,
                   curve: str = "ed25519") -> torch.Tensor:
    """Plain version of K3: one ``padd``."""
    return get_engine(curve).padd(consts, p, q)


def pair_add(consts: torch.Tensor, p: torch.Tensor, q: torch.Tensor, *,
             curve: str = "ed25519") -> torch.Tensor:
    """p + q per lane over (C, n, K) int32.

    The kernels narrow ``p`` and ``q`` to int16 (their precondition): every
    limb must lie in int16. Their callers meet it: ``DeviceTable``'s build
    adds a table row (the identity or a padd output) and the encoded base
    point (canonical limbs in [0, 4095]); the mesh fold (``reduce_points``)
    adds partial sums, each a ``horner`` or ``pair_add`` output; P5's
    inputs (``probes.add_inputs``) are encoded points. Every padd output limb
    lies in [-7643, 11737] (BN254, ``csrc/fold_curves.cuh``) or [-1536,
    5631] (ed25519, ``csrc/coop_sum.cuh``)."""
    if p.device.type == "cpu":
        return pair_add_plain(consts, p, q, curve=curve)
    eng = _engine("pair_add", curve)
    dev = _check_cuda(eng, consts, p=p, q=q)
    K = p.shape[-1]
    _check_points(eng, "p", p, K)
    _check_points(eng, "q", q, K)
    out = torch.empty_like(p)
    _run("pair_add", curve, dev, consts.data_ptr(), p.data_ptr(), q.data_ptr(), out.data_ptr(), K,
         *coop_horner_geometry(curve, K, 1))
    return out


# ---------------------------------------------------------------------------
# A4: window sum of a group of WIN_GROUP windows (BN254)
# ---------------------------------------------------------------------------


def window_sum4_plain(consts: torch.Tensor, table: torch.Tensor, digits: torch.Tensor, *,
                      curve: str) -> torch.Tensor:
    """Plain version of ``window_sum4``: the (WG, Kp, B) digits laid out as
    (Kp, WG*B), lane w*B + b, then the gather and tree sum (limbs equal the
    JAX ``_window_fused4_call`` CPU branch)."""
    WG, Kp, B = digits.shape
    d = digits.permute(1, 0, 2).reshape(Kp, WG * B)
    return tree_sum_plain(consts, _gather(table, d), curve=curve)


def window_sum4_order(consts: torch.Tensor, table: torch.Tensor, digits: torch.Tensor, *,
                      groups: int, padd=None) -> torch.Tensor:
    """The G1 kernel's order, on the CPU: each lane's ``groups`` nodes of
    2^l = Kp / G points summed one padd at a time as kernel 1 sums them
    (the leaf pairs in bit-reversed order, a binary counter of pending left
    nodes), then the tree over the nodes as kernel 2 sums it, every padd
    output narrowed to int16 as the kernels' shared and global memory hold
    it (raises where a limb leaves int16). ``padd(p, q)`` on (3, n, L) int32
    lanes is the plain padd unless given (a test passes the cooperative
    schedule's). The plain tree's order, so the limbs equal
    ``window_sum4_plain``'s; for tests and chip_smoke only."""
    eng = get_engine("bn254_g1")
    padd = padd or (lambda p, q: eng.padd(consts, p, q))
    WG, Kp, B = digits.shape
    G, L, C, n = groups, WG * B, eng.coords, eng.n
    ell = (Kp // G).bit_length() - 1
    if Kp % G or Kp // G != 1 << ell:
        raise ValueError(f"{G} nodes do not split {Kp} points into powers of two")
    rows = _gather(table, digits.permute(1, 0, 2).reshape(Kp, L))  # (L, Kp, C, n) int16

    def narrowed(x):
        x16 = x.to(torch.int16)
        if not torch.equal(x16.to(torch.int32), x):
            raise ValueError("a padd output left int16")
        return x16.to(torch.int32)

    def leaves(m):  # point r + m G of every lane's node r, as lanes j * G + r
        return rows[:, m * G:(m + 1) * G].reshape(L * G, C, n).permute(1, 2, 0).to(torch.int32)

    nodes, pending = leaves(0), {}
    for u in range(1 << ell >> 1):
        m = int(f"{2 * u:0{ell}b}"[::-1], 2)
        p, q, v = leaves(m), leaves(m + (1 << ell >> 1)), u
        for lvl in range(1, ell + 1):
            out = narrowed(padd(p, q))
            if lvl == ell:
                nodes = out
            elif v & 1:
                p, q, v = pending[lvl], out, v >> 1
                continue
            else:
                pending[lvl] = out
            break
    v = nodes.reshape(C, n, L, G).permute(3, 0, 1, 2)  # (G, C, n, L)
    while v.shape[0] > 1:
        half = v.shape[0] // 2

        def lanes(x):
            return x.permute(1, 2, 0, 3).reshape(C, n, half * L)

        s = narrowed(padd(lanes(v[:half]), lanes(v[half:2 * half]))).reshape(C, n, half, L).permute(2, 0, 1, 3)
        v = torch.cat([s, v[-1:]]) if v.shape[0] % 2 else s
    return v[0]


def window_sum4(consts: torch.Tensor, table: torch.Tensor, digits: torch.Tensor, *,
                curve: str) -> torch.Tensor:
    """Window sums of WIN_GROUP windows at once.

    ``table``: (Kp*256, C, n) int16; ``digits``: (WIN_GROUP, Kp, B) int32 in
    [0, 256), window 0 the highest of the group. Returns (C, n, WIN_GROUP*B)
    int32, window w of lane b in lane w*B + b. Both kernels sum in the plain
    tree's order, so their limbs equal ``window_sum4_plain``'s."""
    if table.device.type == "cpu":
        return window_sum4_plain(consts, table, digits, curve=curve)
    eng = _engine("window_sum4", curve)
    dev = _check_cuda(eng, consts, table=table, digits=digits)
    WG, Kp, B = digits.shape
    if WG != WIN_GROUP:
        raise ValueError(f"digits must hold {WIN_GROUP} windows, got {WG}")
    _check_table(eng, table, digits, Kp)
    out = torch.empty((eng.coords, eng.n, WG * B), dtype=torch.int32, device=table.device)
    if curve == "bn254_g2":
        _run("window_sum4", curve, dev, consts.data_ptr(), table.data_ptr(), digits.data_ptr(),
             out.data_ptr(), Kp, B, *_coop_geometry(dev, curve, Kp, WG * B))
        return out
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    G, nodes_smem, warps, smem = window_sum4_g1_geometry(Kp, WG * B, sms)
    nodes = (torch.empty((WG * B * G, eng.coords, eng.n), dtype=torch.int16, device=table.device)
             if G < Kp else None)
    _run("window_sum4", curve, dev, consts.data_ptr(), table.data_ptr(), digits.data_ptr(),
         nodes.data_ptr() if nodes is not None else None, out.data_ptr(), Kp, B, G, nodes_smem, warps,
         smem)
    return out


# ---------------------------------------------------------------------------
# A5: WIN_GROUP Horner steps (BN254)
# ---------------------------------------------------------------------------


def horner4_plain(consts: torch.Tensor, acc: torch.Tensor, wsums: torch.Tensor, *,
                  curve: str) -> torch.Tensor:
    """Plain version of ``horner4``: one Horner step per window of the group
    (the loop of the JAX ``_horner4_call`` CPU branch)."""
    B = acc.shape[-1]
    for w in range(WIN_GROUP):
        acc = horner_plain(consts, acc, wsums[..., w * B : (w + 1) * B], curve=curve)
    return acc


def horner4(consts: torch.Tensor, acc: torch.Tensor, wsums: torch.Tensor, *,
            curve: str) -> torch.Tensor:
    """acc <- 2^8 * acc + wsums[window w], for w = 0..WIN_GROUP-1, over
    (C, n, B) int32 lanes; ``wsums`` is ``window_sum4``'s (C, n, WG*B).

    The kernels narrow ``acc`` and ``wsums`` to int16 (their precondition):
    every limb must lie in int16, as on the Groth16 path, where ``acc`` is
    the identity or an earlier ``horner4`` output and ``wsums`` a
    ``window_sum4`` output, and every padd output limb lies in
    [-7643, 11737] (``csrc/fold_curves.cuh``)."""
    if acc.device.type == "cpu":
        return horner4_plain(consts, acc, wsums, curve=curve)
    eng = _engine("horner4", curve)
    dev = _check_cuda(eng, consts, acc=acc, wsums=wsums)
    B = acc.shape[-1]
    _check_points(eng, "acc", acc, B)
    _check_points(eng, "wsums", wsums, WIN_GROUP * B)
    out = torch.empty_like(acc)
    _run("horner4", curve, dev, consts.data_ptr(), acc.data_ptr(), wsums.data_ptr(),
         out.data_ptr(), B, *coop_horner_geometry(curve, B, WIN_GROUP))
    return out


# ---------------------------------------------------------------------------
# A6: tree sum of gathered points (the mesh-sharded MSM), every curve
# ---------------------------------------------------------------------------


def tree_sum_plain(consts: torch.Tensor, pts: torch.Tensor, *, curve: str) -> torch.Tensor:
    """Plain version of ``tree_sum``: widen, then the halving tree over the
    basis in the JAX ``_tree_reduce`` pairing (limbs equal the JAX
    ``_window_sum_call`` CPU branch fed ``pts`` as (Kp, C, n, B))."""
    eng = get_engine(curve)
    v = pts.permute(1, 2, 3, 0).to(torch.int32)  # (Kp, C, n, B)
    return _tree_reduce(lambda a, b: eng.padd(consts, a, b), v)


def tree_sum(consts: torch.Tensor, pts: torch.Tensor, *, curve: str) -> torch.Tensor:
    """Sum over k of the points ``pts[b, k]`` for every lane b.

    ``pts``: (B, Kp, C, n) int16, lane-major (``csrc/tree_sum.cu`` says why).
    Returns (C, n, B) int32. The kernels sum in the plain version's tree
    order (one block a lane on the curve's cooperative padd), so their limbs
    equal ``tree_sum_plain``'s."""
    if pts.device.type == "cpu":
        return tree_sum_plain(consts, pts, curve=curve)
    eng = _engine("tree_sum", curve)
    dev = _check_cuda(eng, consts, pts=pts)
    if pts.dtype != torch.int16 or pts.dim() != 4 or tuple(pts.shape[2:]) != (eng.coords, eng.n):
        raise ValueError(f"pts must be (B, Kp, {eng.coords}, {eng.n}) int16")
    B, Kp = pts.shape[:2]
    out = torch.empty((eng.coords, eng.n, B), dtype=torch.int32, device=pts.device)
    _run("tree_sum", curve, dev, consts.data_ptr(), pts.data_ptr(), out.data_ptr(), Kp, B,
         *_coop_geometry(dev, curve, Kp, B))
    return out


# ---------------------------------------------------------------------------
# Probes (P2, P4): chained Edwards additions, the field product
# ---------------------------------------------------------------------------


def padd_chain_plain(consts: torch.Tensor, p: torch.Tensor, q: torch.Tensor, R: int) -> torch.Tensor:
    """Plain version of ``padd_chain``: ``R`` times p <- p + q (ed25519)."""
    eng = get_engine("ed25519")
    for _ in range(R):
        p = eng.padd(consts, p, q)
    return p


def padd_chain(consts: torch.Tensor, p: torch.Tensor, q: torch.Tensor, R: int) -> torch.Tensor:
    """p + R * q per lane by R chained additions over (4, n, B) int32, in
    one launch of the four-thread chain (``csrc/coop_horner.cuh``
    ``coop_chain_kernel<EdCoop>``), on pair_add ed25519's layout with
    CHAIN_WARPS warps a block (``coop_horner_geometry``: eight lanes a
    warp).

    The kernel narrows ``p`` and ``q`` to int16 once (its precondition):
    every limb must lie in int16. P2's callers meet it: ``p`` and ``q`` are
    encoded points (``probes.chain_inputs``, limbs in [0, 4096)), and every
    padd output limb lies in [-1536, 5631] (``csrc/coop_sum.cuh``), so the
    chain's accumulator stays exact in int16."""
    if p.device.type == "cpu":
        return padd_chain_plain(consts, p, q, R)
    eng = _engine("padd_chain", "ed25519")
    dev = _check_cuda(eng, consts, p=p, q=q)
    B = p.shape[-1]
    _check_points(eng, "p", p, B)
    _check_points(eng, "q", q, B)
    out = torch.empty_like(p)
    _run("padd_chain", "ed25519", dev, consts.data_ptr(), p.data_ptr(), q.data_ptr(),
         out.data_ptr(), R, B, *coop_horner_geometry("ed25519", B, 1, CHAIN_WARPS))
    return out


def fe_mul_plain(consts: torch.Tensor, a: torch.Tensor, b: torch.Tensor, *,
                 curve: str) -> torch.Tensor:
    """Plain version of ``fe_mul``: one fold product per lane."""
    return FieldOps(get_engine(curve).n, consts).mul(a, b)


def fe_mul(consts: torch.Tensor, a: torch.Tensor, b: torch.Tensor, *, curve: str) -> torch.Tensor:
    """a * b per lane over (n, E) int32, in the coordinate field of ``curve``
    (ed25519: p = 2^255 - 19; bn254_g1: BN254 Fq) whose consts block is
    ``consts``, limb for limb as :func:`fe_mul_plain`.

    The kernel (``csrc/probes.cu``) has its field's constants in its code
    (``ed_mul``; ``bn_fq_mul``, ``csrc/bn254_fq.cuh``), so on the card
    ``consts`` is checked and picks nothing: it feeds only the plain
    version. One lane a thread, any E >= 1."""
    if a.device.type == "cpu":
        return fe_mul_plain(consts, a, b, curve=curve)
    eng = _engine("fe_mul", curve)
    dev = _check_cuda(eng, consts, a=a, b=b)
    E = a.shape[-1]
    for key, t in (("a", a), ("b", b)):
        if t.dtype != torch.int32 or tuple(t.shape) != (eng.n, E):
            raise ValueError(f"{key} must be ({eng.n}, {E}) int32")
    out = torch.empty_like(a)
    _run("fe_mul", curve, dev, consts.data_ptr(), a.data_ptr(), b.data_ptr(), out.data_ptr(), E)
    return out


# ---------------------------------------------------------------------------
# P6: the 12-bit Montgomery product (ops/limb.py), any field
# ---------------------------------------------------------------------------

MONT_N = 22  # limbs of the mont_mul instance (BN254 Fr, 2^255 - 19) and of mont_padd
# the limb counts mont_mul is instantiated for, each its instance's variant
# (None: the instance named mont_mul): 22, and 11 for f128 (the STARK LDE)
MONT_NS = {22: None, 11: "n11"}
# rows (threads) a mont_mul block (csrc/mont.cu: 128 rows of a and of b,
# 22.8 KB of shared memory): of 32, 64, 128 and 256, the fastest on the card
# both at an NTT stage of the h (196,608 rows) and at the MiMC batch's 4096,
# where 128-row blocks fill only 32 SMs (chip_smoke's mont_pair line: four
# warps a block share an SM's four schedulers, so a row's latency is the
# same, and fewer blocks stage the consts fewer times)
MONT_ROWS = 128
# lanes (threads) a mont_padd block (csrc/probes.cu: 352 bytes of int16 rows
# a lane in shared memory): of 64, 128 and 256, the fastest at P7's 2^18
# lanes (chip_smoke's mont_padd line: 2 % ahead of 128, 256 6 % behind)
MONT_PADD_THREADS = 64


def mont_carry(x: torch.Tensor, one_mont: torch.Tensor) -> torch.Tensor:
    """One wrap-carry pass over (..., n) limbs: (x & mask) + (x >> 12)
    shifted up one limb + (top carry) * (R mod p)."""
    hi = x >> LIMB_BITS
    return (x & LIMB_MASK) + F.pad(hi[..., :-1], (1, 0)) + hi[..., -1:] * one_mont


def mont_mul_plain(consts: torch.Tensor, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Plain version of ``mont_mul``: the schoolbook columns, the REDC sweep
    in the JAX order and three wrap carries (the limbs of the JAX
    ``LimbContext.mont_mul``). ``consts``: (3+, n) int32, rows p, R mod p and
    ninv in word 0."""
    n = consts.shape[1]
    p, one, ninv = consts[0], consts[1], int(consts[2, 0])
    a, b = torch.broadcast_tensors(a, b)
    T = torch.zeros(a.shape[:-1] + (2 * n,), dtype=torch.int32, device=a.device)
    for j in range(n):
        T[..., j : j + n] += a * b[..., j : j + 1]
    for i in range(n):
        m = ((T[..., i] & LIMB_MASK) * ninv) & LIMB_MASK
        T[..., i : i + n] += m[..., None] * p
        T[..., i + 1] += T[..., i] >> LIMB_BITS
    x = T[..., n:]
    for _ in range(3):
        x = mont_carry(x, one)
    return x


def _check_mont(consts: torch.Tensor, rows: int, limbs=tuple(MONT_NS), **tensors) -> torch.device:
    """The Montgomery kernels take contiguous int32 tensors on one CUDA
    device and a (rows, n) int32 consts block, n one of ``limbs`` (the limb
    counts the kernel is instantiated for)."""
    dev = consts.device
    if dev.type != "cuda":
        raise ValueError(f"kernel wrappers take CUDA or CPU tensors, got {dev}")
    if consts.dtype != torch.int32 or consts.dim() != 2 or consts.shape[0] != rows or consts.shape[1] not in limbs:
        raise ValueError(f"consts must be a ({rows}, n) int32 Montgomery consts block, n in {tuple(limbs)}")
    for key, t in {"consts": consts, **tensors}.items():
        if t.device != dev:
            raise ValueError(f"{key} is on {t.device}, consts on {dev}")
        if t.dtype != torch.int32:
            raise ValueError(f"{key} must be int32")
        if not t.is_contiguous():
            raise ValueError(f"{key} must be contiguous")
    return dev


def mont_rows(a: torch.Tensor, b: torch.Tensor, n: int) -> tuple:
    """(M, Mb): the rows of ``a`` and of ``b`` that the kernel takes, a as
    (M, n) and b as (Mb, n) with row i of a meeting row i % Mb of b. Raises
    unless a is (..., n) and b's shape, leading 1s aside, is a suffix of
    a's. Any int32 address will do: the kernel takes 16-byte copies only
    where the addresses allow them."""
    bshape = list(b.shape)
    while len(bshape) > 1 and bshape[0] == 1:
        bshape.pop(0)
    if a.dim() < 1 or a.shape[-1] != n or list(a.shape[a.dim() - len(bshape):]) != bshape:
        raise ValueError(f"mont_mul takes (..., {n}) limbs with b's shape a suffix of a's, "
                         f"got {tuple(a.shape)} and {tuple(b.shape)}")
    return a.numel() // n, b.numel() // n


def mont_mul(consts: torch.Tensor, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a * b * R^-1 over (..., n) int32 limbs; ``b`` broadcasts over
    ``a``'s leading axes (its shape, leading 1s aside, is ``a``'s trailing
    shape). The kernel stages a block's MONT_ROWS rows of ``a`` and ``b``
    and the consts block through shared memory (``csrc/mont.cu``); the
    consts block's limb count n picks the instance (:data:`MONT_NS`)."""
    if a.device.type == "cpu":
        return mont_mul_plain(consts, a, b)
    dev = _check_mont(consts, 3, a=a, b=b)
    n = consts.shape[1]
    M, Mb = mont_rows(a, b, n)
    out = torch.empty_like(a)
    if M:
        _run("mont_mul", MONT_NS[n], dev, consts.data_ptr(), a.data_ptr(), b.data_ptr(),
             out.data_ptr(), n, M, Mb, MONT_ROWS)
    return out


# ---------------------------------------------------------------------------
# P7: Edwards addition in the Montgomery domain (2^255 - 19)
# ---------------------------------------------------------------------------


def mont_padd_plain(consts: torch.Tensor, p: torch.Tensor, q: torch.Tensor) -> torch.Tensor:
    """Plain version of ``mont_padd``: ``point_add_val`` of
    ``scripts/bench_pallas_mul.py`` over (4, n, E) limbs-major Montgomery
    coordinates; ``consts`` (4, n): p, R mod p, ninv, 2d * R mod p."""
    mc = consts[:3]
    one = consts[1]

    def mm(x, y):
        return mont_mul_plain(mc, x, y)

    def add(x, y):
        return mont_carry(x + y, one)

    def sub(x, y):
        return mont_carry(x - y, one)

    X1, Y1, Z1, T1 = p.transpose(1, 2)  # each (E, n)
    X2, Y2, Z2, T2 = q.transpose(1, 2)
    A = mm(sub(Y1, X1), sub(Y2, X2))
    B = mm(add(Y1, X1), add(Y2, X2))
    C = mm(mm(T1, T2), consts[3])
    zz = mm(Z1, Z2)
    D = add(zz, zz)
    E, Fv, G, H = sub(B, A), sub(D, C), add(D, C), add(B, A)
    return torch.stack([mm(E, Fv), mm(G, H), mm(Fv, G), mm(E, H)]).transpose(1, 2).contiguous()


def mont_padd(consts: torch.Tensor, p: torch.Tensor, q: torch.Tensor) -> torch.Tensor:
    """p + q per lane over (4, n, E) int32 Montgomery limbs, limbs-major.

    The kernel (``csrc/probes.cu``) serves p = 2^255 - 19 only: p, R mod p
    and ninv are written into its product, and it reads only the consts
    block's 2d * R mod p row. It holds a lane's points as int16 rows in
    shared memory (its precondition): every limb of ``p`` and ``q`` must lie
    in int16, as P7's canonical Montgomery limbs (``probes.mont_padd_inputs``,
    [0, 4096)) do. MONT_PADD_THREADS lanes a block."""
    if p.device.type == "cpu":
        return mont_padd_plain(consts, p, q)
    dev = _check_mont(consts, 4, (MONT_N,), p=p, q=q)
    E = p.shape[-1]
    for key, t in (("p", p), ("q", q)):
        if tuple(t.shape) != (4, MONT_N, E):
            raise ValueError(f"{key} must be (4, {MONT_N}, {E}) int32")
    out = torch.empty_like(p)
    _run("mont_padd", None, dev, consts.data_ptr(), p.data_ptr(), q.data_ptr(), out.data_ptr(), E,
         MONT_PADD_THREADS)
    return out


# ---------------------------------------------------------------------------
# P1: the parts of the fold product alone (scripts/bench_ablate.py)
# ---------------------------------------------------------------------------


def _conv_shifted(a: torch.Tensor, b: torch.Tensor, nc: int) -> torch.Tensor:
    """``conv_a``: the (nc, E) columns as a sum of shifted pads."""
    n = a.shape[0]
    return sum(F.pad(a * b[j : j + 1], (0, 0, j, nc - n - j)) for j in range(n))


def _conv_aligned(a: torch.Tensor, b: torch.Tensor, nc: int) -> torch.Tensor:
    """``conv_b``: the same columns grouped by j mod 8, aligned pads summed
    first, then 8 residual shifts."""
    n = a.shape[0]
    out = None
    for r in range(8):
        u = None
        for j in range(r, n, 8):
            t = F.pad(a * b[j : j + 1], (0, 0, j - r, nc - n - (j - r)))
            u = t if u is None else u + t
        if u is None:
            continue
        su = F.pad(u[: nc - r], (0, 0, r, 0)) if r else u
        out = su if out is None else out + su
    return out


def fold_ablate_plain(consts: torch.Tensor, a: torch.Tensor, b, *, variant: str) -> torch.Tensor:
    """Plain version of ``fold_ablate``: the variant's function of
    ``scripts/bench_ablate.py`` over limbs-major int32 lanes, at n limbs
    (the fold consts block of ed25519 gives ONE and FOLD):

    * ``conv``: conv_a(a, b)[:n] + conv_a(a, b)[n:2n] * 0;
    * ``conv8``: the same with conv_b;
    * ``carry5``: 5 wrap-carry passes of a;
    * ``fold``: a[:n] + sum_i a[n + i] * FOLD[i] over the n + 2 high rows of
      a (2n + 2, E);
    * ``mac``: sum_j a * b[j], n plain multiply-adds with no shift."""
    n = consts.shape[1]
    nc = 2 * n + 2
    if variant in ("conv", "conv8"):
        T = (_conv_shifted if variant == "conv" else _conv_aligned)(a, b, nc)
        return T[:n] + T[n : 2 * n] * 0
    if variant == "carry5":
        one = consts[0][:, None]
        t = a
        for _ in range(5):
            hi = t >> LIMB_BITS
            t = (t & LIMB_MASK) + F.pad(hi[:-1], (0, 0, 1, 0)) + hi[-1:] * one
        return t
    if variant == "fold":
        acc = a[:n]
        for i in range(n + 2):
            acc = acc + a[n + i : n + i + 1] * consts[1 + i][:, None]
        return acc
    if variant == "mac":
        acc = a * b[0:1]
        for j in range(1, n):
            acc = acc + a * b[j : j + 1]
        return acc
    raise ValueError(f"fold_ablate has no variant {variant!r}")


def fold_ablate(consts: torch.Tensor, a: torch.Tensor, b, *, variant: str) -> torch.Tensor:
    """One part of the fold product per lane (``fold_ablate_plain``): ``a``
    (n, E) int32, or (2n + 2, E) for ``fold``; ``b`` (n, E) for ``conv``,
    ``conv8`` and ``mac``, None otherwise. Returns (n, E) int32."""
    if a.device.type == "cpu":
        return fold_ablate_plain(consts, a, b, variant=variant)
    if variant not in ABLATE_VARIANTS:
        raise ValueError(f"fold_ablate has no variant {variant!r}")
    eng = get_engine("ed25519")
    n = eng.n
    two = variant in ("conv", "conv8", "mac")
    if two != (b is not None):
        raise ValueError(f"fold_ablate {variant} takes {'two operands' if two else 'one operand'}")
    dev = _check_cuda(eng, consts, a=a, **({"b": b} if two else {}))
    E = a.shape[-1]
    rows = 2 * n + 2 if variant == "fold" else n
    if a.dtype != torch.int32 or tuple(a.shape) != (rows, E):
        raise ValueError(f"a must be ({rows}, {E}) int32")
    if two and (b.dtype != torch.int32 or tuple(b.shape) != (n, E)):
        raise ValueError(f"b must be ({n}, {E}) int32")
    out = torch.empty((n, E), dtype=torch.int32, device=a.device)
    _run("fold_ablate", variant, dev, consts.data_ptr(), a.data_ptr(), b.data_ptr() if two else 0,
         out.data_ptr(), E, 0)
    return out


# ---------------------------------------------------------------------------
# P3: chained Edwards additions on f32 balanced 9-bit limbs
# ---------------------------------------------------------------------------

F32_W = 9                   # bits per balanced limb
F32_NF = 29                 # limbs (261 bits)
F32_NC = 2 * F32_NF + 2     # convolution columns
F32_RND = float(3 << (22 + F32_W))  # (x + RND) - RND rounds x to a multiple of 2^W
F32_ITW = 1.0 / (1 << F32_W)


def padd_f32_chain_plain(consts: torch.Tensor, p: torch.Tensor, q: torch.Tensor, R: int) -> torch.Tensor:
    """Plain version of ``padd_f32_chain``: ``R`` times p <- p + q with the
    padd of ``scripts/bench_pallas_padd.py`` ``bench_mxu``, the convolution
    (a one-hot (NC, NF^2) matrix), the fold and the carry shift as float32
    matrix products as the TPU ran them on its MXU. Exact: every partial sum
    is an integer below 2^24 (float32 products must run in full float32, not
    TF32). ``consts`` (NF + 4, NF) float32: ONE, FOLD[NF + 2], 2d."""
    NF, NC = F32_NF, F32_NC
    one, fold, twod = consts[0], consts[1 : NF + 3], consts[NF + 3][:, None]
    dev = p.device
    Cm = torch.zeros((NC, NF * NF), dtype=torch.float32, device=dev)
    idx = torch.arange(NF, device=dev)
    Cm[(idx[:, None] + idx[None, :]).reshape(-1), torch.arange(NF * NF, device=dev)] = 1.0
    FT = fold.T.contiguous()
    U = torch.zeros((NF, NF), dtype=torch.float32, device=dev)
    U[idx[1:], idx[:-1]] = 1.0
    U[:, NF - 1] = one

    def carry(x):
        hi = (x + F32_RND) - F32_RND
        return (x - hi) + U @ (hi * F32_ITW)

    def carry_nw(T):
        hi = (T + F32_RND) - F32_RND
        return (T - hi) + F.pad((hi * F32_ITW)[:-1], (0, 0, 1, 0))

    def mul(a, b):
        O = (a[:, None, :] * b[None, :, :]).reshape(NF * NF, -1)
        T = carry_nw(carry_nw(Cm @ O))
        return carry(carry(carry(T[:NF] + FT @ T[NF:])))

    X2, Y2, Z2, T2 = q
    for _ in range(R):
        X1, Y1, Z1, T1 = p
        A = mul(Y1 - X1, Y2 - X2)
        B = mul(Y1 + X1, Y2 + X2)
        C = mul(mul(T1, T2), twod)
        zz = mul(Z1, Z2)
        D = zz + zz
        E, Fv, G, H = B - A, D - C, D + C, B + A
        p = torch.stack([mul(E, Fv), mul(G, H), mul(Fv, G), mul(E, H)])
    return p


def padd_f32_chain(consts: torch.Tensor, p: torch.Tensor, q: torch.Tensor, R: int) -> torch.Tensor:
    """p + R * q per lane by R chained additions over (4, NF, B) float32
    balanced limbs."""
    if p.device.type == "cpu":
        return padd_f32_chain_plain(consts, p, q, R)
    dev = consts.device
    if dev.type != "cuda":
        raise ValueError(f"kernel wrappers take CUDA or CPU tensors, got {dev}")
    shape = (F32_NF + 4, F32_NF)
    if consts.dtype != torch.float32 or tuple(consts.shape) != shape:
        raise ValueError(f"consts must be the {shape} float32 consts block")
    B = p.shape[-1]
    for key, t in (("consts", consts), ("p", p), ("q", q)):
        if t.device != dev or not t.is_contiguous():
            raise ValueError(f"{key} must be contiguous on {dev}")
        if key != "consts" and (t.dtype != torch.float32 or tuple(t.shape) != (4, F32_NF, B)):
            raise ValueError(f"{key} must be (4, {F32_NF}, {B}) float32")
    out = torch.empty_like(p)
    _run("padd_f32_chain", None, dev, consts.data_ptr(), p.data_ptr(), q.data_ptr(), out.data_ptr(),
         R, B)
    return out


# ---------------------------------------------------------------------------
# BLAKE3: the compression of the device BLAKE3 tier (ops/blake3_device.py)
# ---------------------------------------------------------------------------


def blake3_plain(m: torch.Tensor, block_len: int, flags: int) -> torch.Tensor:
    """Plain version of ``blake3``: ``compress_vec`` of every lane from the
    IV at counter 0."""
    from .blake3_device import IV, compress_vec  # blake3_device imports this module

    iv = torch.tensor(IV, dtype=torch.int64, device=m.device).expand(m.shape[0], 8)
    return compress_vec(iv, m, 0, block_len, flags)


def blake3(m: torch.Tensor, block_len: int, flags: int) -> torch.Tensor:
    """The BLAKE3 compression of each lane from the IV at counter 0:
    message words ``m`` (L, 16) int64 in [0, 2^32) -> (L, 8) int64 output
    chaining values; ``block_len`` (0 to 64) and ``flags`` the same for
    every lane (``csrc/blake3.cu``: one lane a thread)."""
    if m.device.type == "cpu":
        return blake3_plain(m, block_len, flags)
    dev = m.device
    if dev.type != "cuda":
        raise ValueError(f"kernel wrappers take CUDA or CPU tensors, got {dev}")
    if m.dtype != torch.int64 or m.dim() != 2 or m.shape[1] != 16 or not m.is_contiguous():
        raise ValueError(f"blake3 takes contiguous (L, 16) int64 message words, got {tuple(m.shape)} {m.dtype}")
    if not 0 <= block_len <= 64:
        raise ValueError(f"a one-block message has 0 to 64 bytes, not {block_len}")
    out = torch.empty((m.shape[0], 8), dtype=torch.int64, device=dev)
    if m.shape[0]:
        _run("blake3", None, dev, m.data_ptr(), out.data_ptr(), m.shape[0], block_len, flags)
    return out
