"""The hand-written Hopper kernels, their build and their wrappers.

Seven CUDA C++ sources under ``libzkp_tpu_torch/csrc/``, each compiled for
``sm_90a`` by ``nvcc`` into its own shared library with a plain C interface
and bound with ``ctypes``; the field and curve code they share is
``csrc/fold_curves.cuh``. Each kernel is instantiated for the curves its path
runs, and each instance is a kernel of its own, named ``<kernel>`` for
ed25519 and ``<kernel>_<curve>`` for BN254 (:data:`INSTANCES`):

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
  the curve it is named for (ed25519: p = 2^255 - 19; bn254_g1: BN254 Fq).

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
import shutil
import subprocess
from pathlib import Path
from typing import Dict

import torch

from .edwards import _tree_reduce
from .limbfold import FieldOps
from .weierstrass import CURVES, get_engine

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"
HEADER = "fold_curves.cuh"
SOURCES = {
    "window_sum": "window_sum.cu",
    "horner": "horner.cu",
    "pair_add": "pair_add.cu",
    "window_sum4": "window_sum4.cu",
    "horner4": "horner4.cu",
    "tree_sum": "tree_sum.cu",
    "padd_chain": "probes.cu",
    "fe_mul": "probes.cu",
}
KERNEL_CURVES = {
    "window_sum": ("ed25519",),
    "horner": CURVES,
    "pair_add": CURVES,
    "window_sum4": ("bn254_g1", "bn254_g2"),
    "horner4": ("bn254_g1", "bn254_g2"),
    "tree_sum": CURVES,
    "padd_chain": ("ed25519",),
    "fe_mul": ("ed25519", "bn254_g1"),
}
LIBRARIES = tuple(dict.fromkeys(Path(src).stem for src in SOURCES.values()))  # one per source
WIN_GROUP = 4  # windows per window_sum4 / horner4 launch
NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
]

_P = ctypes.c_void_p
_I = ctypes.c_int
_ARGTYPES = {
    "window_sum": [_P, _P, _P, _P, _I, _I, _P],
    "horner": [_P, _P, _P, _P, _I, _P],
    "pair_add": [_P, _P, _P, _P, _I, _P],
    "window_sum4": [_P, _P, _P, _P, _I, _I, _P],
    "horner4": [_P, _P, _P, _P, _I, _P],
    "tree_sum": [_P, _P, _P, _I, _I, _P],
    "padd_chain": [_P, _P, _P, _P, _I, _I, _P],
    "fe_mul": [_P, _P, _P, _P, _I, _P],
}


def instance(kernel: str, curve: str) -> str:
    """Name of a kernel's instance for one curve."""
    return kernel if curve == "ed25519" else f"{kernel}_{curve}"


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


def _library_path(lib: str) -> Path:
    """Build output named by a digest of the source and flags, so an edited
    source is rebuilt and never served a stale library."""
    h = hashlib.sha256()
    for part in (f"{lib}.cu", HEADER):
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
def _launcher(name: str, curve: str):
    lib = ctypes.CDLL(str(build()[Path(SOURCES[name]).stem]))
    fn = getattr(lib, f"{name}_{curve}_launch")
    fn.argtypes = _ARGTYPES[name]
    fn.restype = ctypes.c_int
    return fn


def _run(name: str, curve: str, dev: torch.device, *args) -> None:
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
    Returns (4, n, B) int32."""
    if table.device.type == "cpu":
        return window_sum_plain(consts, table, digits)
    eng = _engine("window_sum", "ed25519")
    dev = _check_cuda(eng, consts, table=table, digits=digits)
    Kp, B = digits.shape
    _check_table(eng, table, digits, Kp)
    out = torch.empty((eng.coords, eng.n, B), dtype=torch.int32, device=table.device)
    _run("window_sum", "ed25519", dev, consts.data_ptr(), table.data_ptr(), digits.data_ptr(),
         out.data_ptr(), Kp, B)
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
    """acc <- 2^8 * acc + wsum over (C, n, B) int32 lanes."""
    if acc.device.type == "cpu":
        return horner_plain(consts, acc, wsum, curve=curve)
    eng = _engine("horner", curve)
    dev = _check_cuda(eng, consts, acc=acc, wsum=wsum)
    B = acc.shape[-1]
    _check_points(eng, "acc", acc, B)
    _check_points(eng, "wsum", wsum, B)
    out = torch.empty_like(acc)
    _run("horner", curve, dev, consts.data_ptr(), acc.data_ptr(), wsum.data_ptr(),
         out.data_ptr(), B)
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
    """p + q per lane over (C, n, K) int32."""
    if p.device.type == "cpu":
        return pair_add_plain(consts, p, q, curve=curve)
    eng = _engine("pair_add", curve)
    dev = _check_cuda(eng, consts, p=p, q=q)
    K = p.shape[-1]
    _check_points(eng, "p", p, K)
    _check_points(eng, "q", q, K)
    out = torch.empty_like(p)
    _run("pair_add", curve, dev, consts.data_ptr(), p.data_ptr(), q.data_ptr(), out.data_ptr(), K)
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


def window_sum4(consts: torch.Tensor, table: torch.Tensor, digits: torch.Tensor, *,
                curve: str) -> torch.Tensor:
    """Window sums of WIN_GROUP windows at once.

    ``table``: (Kp*256, C, n) int16; ``digits``: (WIN_GROUP, Kp, B) int32 in
    [0, 256), window 0 the highest of the group. Returns (C, n, WIN_GROUP*B)
    int32, window w of lane b in lane w*B + b."""
    if table.device.type == "cpu":
        return window_sum4_plain(consts, table, digits, curve=curve)
    eng = _engine("window_sum4", curve)
    dev = _check_cuda(eng, consts, table=table, digits=digits)
    WG, Kp, B = digits.shape
    if WG != WIN_GROUP:
        raise ValueError(f"digits must hold {WIN_GROUP} windows, got {WG}")
    _check_table(eng, table, digits, Kp)
    out = torch.empty((eng.coords, eng.n, WG * B), dtype=torch.int32, device=table.device)
    _run("window_sum4", curve, dev, consts.data_ptr(), table.data_ptr(), digits.data_ptr(),
         out.data_ptr(), Kp, B)
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
    (C, n, B) int32 lanes; ``wsums`` is ``window_sum4``'s (C, n, WG*B)."""
    if acc.device.type == "cpu":
        return horner4_plain(consts, acc, wsums, curve=curve)
    eng = _engine("horner4", curve)
    dev = _check_cuda(eng, consts, acc=acc, wsums=wsums)
    B = acc.shape[-1]
    _check_points(eng, "acc", acc, B)
    _check_points(eng, "wsums", wsums, WIN_GROUP * B)
    out = torch.empty_like(acc)
    _run("horner4", curve, dev, consts.data_ptr(), acc.data_ptr(), wsums.data_ptr(),
         out.data_ptr(), B)
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
    Returns (C, n, B) int32."""
    if pts.device.type == "cpu":
        return tree_sum_plain(consts, pts, curve=curve)
    eng = _engine("tree_sum", curve)
    dev = _check_cuda(eng, consts, pts=pts)
    if pts.dtype != torch.int16 or pts.dim() != 4 or tuple(pts.shape[2:]) != (eng.coords, eng.n):
        raise ValueError(f"pts must be (B, Kp, {eng.coords}, {eng.n}) int16")
    B, Kp = pts.shape[:2]
    out = torch.empty((eng.coords, eng.n, B), dtype=torch.int32, device=pts.device)
    _run("tree_sum", curve, dev, consts.data_ptr(), pts.data_ptr(), out.data_ptr(), Kp, B)
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
    """p + R * q per lane by R chained additions over (4, n, B) int32."""
    if p.device.type == "cpu":
        return padd_chain_plain(consts, p, q, R)
    eng = _engine("padd_chain", "ed25519")
    dev = _check_cuda(eng, consts, p=p, q=q)
    B = p.shape[-1]
    _check_points(eng, "p", p, B)
    _check_points(eng, "q", q, B)
    out = torch.empty_like(p)
    _run("padd_chain", "ed25519", dev, consts.data_ptr(), p.data_ptr(), q.data_ptr(),
         out.data_ptr(), R, B)
    return out


def fe_mul_plain(consts: torch.Tensor, a: torch.Tensor, b: torch.Tensor, *,
                 curve: str) -> torch.Tensor:
    """Plain version of ``fe_mul``: one fold product per lane."""
    return FieldOps(get_engine(curve).n, consts).mul(a, b)


def fe_mul(consts: torch.Tensor, a: torch.Tensor, b: torch.Tensor, *, curve: str) -> torch.Tensor:
    """a * b per lane over (n, E) int32, in the coordinate field of ``curve``
    (ed25519: p = 2^255 - 19; bn254_g1: BN254 Fq) whose consts block is
    ``consts``."""
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
