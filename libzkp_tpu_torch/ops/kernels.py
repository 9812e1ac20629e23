"""The hand-written Hopper kernels of the MSM, their build and their wrappers.

Three CUDA C++ kernels under ``libzkp_tpu_torch/csrc/``, each compiled for
``sm_90a`` by ``nvcc`` into its own shared library with a plain C interface
and bound with ``ctypes``:

* ``window_sum`` (K1, ``csrc/window_sum.cu``) replaces
  ``libzkp_tpu/ops/curve_jax.py:_window_fused_call``;
* ``horner`` (K2, ``csrc/horner.cu``) replaces ``curve_jax.py:_horner_call``;
* ``pair_add`` (K3, ``csrc/pair_add.cu``) replaces ``curve_jax.py:_pair_add_call``.

Each wrapper takes the kernel's plain PyTorch version (``*_plain``, in this
module) for tensors on the CPU, and launches the kernel for tensors on a CUDA
device, or raises: there is no fall back from a failed build or launch. The
libraries are built at first use into ``libzkp_tpu_torch/_build/`` (all
``nvcc`` processes at once), never at import. Each wrapper counts its kernel
launches in its ``launches`` attribute.
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

from .edwards import _tree_reduce, edwards_engine

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"
HEADER = "fe25519_fold.cuh"
SOURCES = {"window_sum": "window_sum.cu", "horner": "horner.cu", "pair_add": "pair_add.cu"}
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
}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    return str(Path(os.environ.get("CUDA_HOME", "/usr/local/cuda")) / "bin" / "nvcc")


def _library_path(name: str) -> Path:
    """Build output named by a digest of the sources and flags, so an edited
    source is rebuilt and never served a stale library."""
    h = hashlib.sha256()
    for part in (SOURCES[name], HEADER):
        h.update((CSRC / part).read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"{name}-{h.hexdigest()[:16]}.so"


def build() -> Dict[str, Path]:
    """Compile every kernel library not built yet, one ``nvcc`` per source,
    all started together. Returns ``{name: library path}``; raises on a
    failed compile with the compiler's log. ``-Xptxas -v`` leaves each
    kernel's registers and spills in ``_build/<name>.log``."""
    BUILD_DIR.mkdir(exist_ok=True)
    paths = {name: _library_path(name) for name in SOURCES}
    procs = {}
    try:
        for name, so in paths.items():
            if so.exists():
                continue
            tmp = so.with_name(f"{so.stem}.{os.getpid()}.tmp.so")
            with open(BUILD_DIR / f"{name}.log", "wb") as log:
                cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / SOURCES[name])]
                procs[name] = (subprocess.Popen(cmd, stdout=log, stderr=subprocess.STDOUT), tmp)
        failed = []
        for name, (proc, tmp) in procs.items():
            if proc.wait() != 0:
                failed.append(name)
            else:
                os.replace(tmp, paths[name])
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
def _launcher(name: str):
    lib = ctypes.CDLL(str(build()[name]))
    fn = getattr(lib, f"{name}_launch")
    fn.argtypes = _ARGTYPES[name]
    fn.restype = ctypes.c_int
    return fn


def _run(name: str, dev: torch.device, *args) -> None:
    with torch.cuda.device(dev):
        err = _launcher(name)(*args, torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"{name} kernel launch failed with CUDA error {err}")


def _check_cuda(consts: torch.Tensor, **tensors) -> torch.device:
    """The kernels take contiguous tensors on one CUDA device and the
    (n + 4, n) int32 Edwards consts block."""
    eng = edwards_engine()
    dev = consts.device
    if dev.type != "cuda":
        raise ValueError(f"kernel wrappers take CUDA or CPU tensors, got {dev}")
    if consts.dtype != torch.int32 or tuple(consts.shape) != (eng.n + 4, eng.n):
        raise ValueError("consts must be the (n + 4, n) int32 Edwards consts block")
    for key, t in {"consts": consts, **tensors}.items():
        if t.device != dev:
            raise ValueError(f"{key} is on {t.device}, consts on {dev}")
        if not t.is_contiguous():
            raise ValueError(f"{key} must be contiguous")
    return dev


def _check_points(name: str, t: torch.Tensor, lanes: int) -> None:
    eng = edwards_engine()
    if t.dtype != torch.int32 or tuple(t.shape) != (eng.coords, eng.n, lanes):
        raise ValueError(f"{name} must be ({eng.coords}, {eng.n}, {lanes}) int32")


# ---------------------------------------------------------------------------
# K1: window sum
# ---------------------------------------------------------------------------


def window_sum_plain(consts: torch.Tensor, table: torch.Tensor, digits: torch.Tensor) -> torch.Tensor:
    """Plain version of K1: index the int16 table, widen, tree-reduce with
    ``padd`` in the JAX ``_tree_reduce`` pairing (limbs equal the JAX
    ``_window_fused_call`` CPU branch)."""
    eng = edwards_engine()
    Kp = digits.shape[0]
    koff = torch.arange(Kp, device=digits.device, dtype=torch.int64)[:, None] * 256
    pts = table[digits.to(torch.int64) + koff]  # (Kp, B, C, n) int16
    pts = pts.permute(0, 2, 3, 1).to(torch.int32)  # (Kp, C, n, B)
    return _tree_reduce(lambda a, b: eng.padd(consts, a, b), pts)


def window_sum(consts: torch.Tensor, table: torch.Tensor, digits: torch.Tensor) -> torch.Tensor:
    """Sum over the basis of each lane's table multiples for one window.

    ``table``: (Kp*256, 4, n) int16; ``digits``: (Kp, B) int32 in [0, 256).
    Returns (4, n, B) int32."""
    if table.device.type == "cpu":
        return window_sum_plain(consts, table, digits)
    eng = edwards_engine()
    dev = _check_cuda(consts, table=table, digits=digits)
    Kp, B = digits.shape
    if digits.dtype != torch.int32:
        raise ValueError("digits must be int32")
    if table.dtype != torch.int16 or tuple(table.shape) != (Kp * 256, eng.coords, eng.n):
        raise ValueError(f"table must be ({Kp * 256}, {eng.coords}, {eng.n}) int16")
    out = torch.empty((eng.coords, eng.n, B), dtype=torch.int32, device=table.device)
    _run("window_sum", dev, consts.data_ptr(), table.data_ptr(), digits.data_ptr(),
         out.data_ptr(), Kp, B)
    window_sum.launches += 1
    return out


window_sum.launches = 0


# ---------------------------------------------------------------------------
# K2: Horner step
# ---------------------------------------------------------------------------


def horner_plain(consts: torch.Tensor, acc: torch.Tensor, wsum: torch.Tensor) -> torch.Tensor:
    """Plain version of K2: 8 doublings then one addition (the loop of the
    JAX ``_horner_call`` CPU branch)."""
    eng = edwards_engine()
    for _ in range(8):
        acc = eng.pdouble(consts, acc)
    return eng.padd(consts, acc, wsum)


def horner(consts: torch.Tensor, acc: torch.Tensor, wsum: torch.Tensor) -> torch.Tensor:
    """acc <- 2^8 * acc + wsum over (4, n, B) int32 lanes."""
    if acc.device.type == "cpu":
        return horner_plain(consts, acc, wsum)
    dev = _check_cuda(consts, acc=acc, wsum=wsum)
    B = acc.shape[-1]
    _check_points("acc", acc, B)
    _check_points("wsum", wsum, B)
    out = torch.empty_like(acc)
    _run("horner", dev, consts.data_ptr(), acc.data_ptr(), wsum.data_ptr(), out.data_ptr(), B)
    horner.launches += 1
    return out


horner.launches = 0


# ---------------------------------------------------------------------------
# K3: elementwise point addition (table-build step)
# ---------------------------------------------------------------------------


def pair_add_plain(consts: torch.Tensor, p: torch.Tensor, q: torch.Tensor) -> torch.Tensor:
    """Plain version of K3: one ``padd``."""
    return edwards_engine().padd(consts, p, q)


def pair_add(consts: torch.Tensor, p: torch.Tensor, q: torch.Tensor) -> torch.Tensor:
    """p + q per lane over (4, n, K) int32."""
    if p.device.type == "cpu":
        return pair_add_plain(consts, p, q)
    dev = _check_cuda(consts, p=p, q=q)
    K = p.shape[-1]
    _check_points("p", p, K)
    _check_points("q", q, K)
    out = torch.empty_like(p)
    _run("pair_add", dev, consts.data_ptr(), p.data_ptr(), q.data_ptr(), out.data_ptr(), K)
    pair_add.launches += 1
    return out


pair_add.launches = 0

WRAPPERS = {"window_sum": window_sum, "horner": horner, "pair_add": pair_add}


def reset_launches() -> None:
    for fn in WRAPPERS.values():
        fn.launches = 0


def launches() -> Dict[str, int]:
    return {name: fn.launches for name, fn in WRAPPERS.items()}
