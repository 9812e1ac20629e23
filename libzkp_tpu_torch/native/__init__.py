"""Native host tier: ctypes over ``zkpcore.cpp``, built at first use.

``zkpcore.cpp`` is the JAX package's C++ host tier, kept here as the port's
own copy: Keccak-f[1600] for the STROBE transcript, the curve25519 group
(point add, scalar multiplication, Pippenger and fixed-basis MSMs),
Ristretto255 encode and decode, and the whole-pipeline Bulletproofs batch
prover and RLC batch verifier. Every hook is held against the pure-Python
goldens (``*_py`` in :mod:`..ops.keccak` and :mod:`..ops.ed25519`).

The library is compiled by ``g++`` (:data:`CXXFLAGS`) on the first call that
needs it, never at import, into ``libzkp_tpu_torch/_build/``, under a name
that carries a digest of the source, the flags and the target ``g++``
resolves ``-march=native`` to; the build runs under a file lock and lands
by an atomic rename, so concurrent processes compile it once. A failed
build raises with the compiler's log. There is no pure-Python fallback.

OpenMP: the team of each call's parallel regions is set on the calling
thread just before the call, whether or not the libgomp that ``-fopenmp``
links is the runtime torch loaded (a wheel may bundle its own, which
``torch.set_num_threads`` alone would leave at every core). The process's
thread budget, ``torch.get_num_threads()``, runs the batch prover, the
verifier from 8 instances (where its own loop goes two-wide) and an MSM of
at least :data:`TEAM_MIN_POINTS` points, whose windows a fixed-basis MSM
splits into one chunk a thread; smaller calls run serial. On an H100
machine's 8-core host a team of 4 or 8 took an MSM of 1 to 7 points up to
13 times longer than one thread, and an MSM of 33 or 130 points 2 to 6
times shorter (PERF.md §5).
"""

from __future__ import annotations

import contextlib
import ctypes
import fcntl
import hashlib
import os
import subprocess
import threading
import time
from pathlib import Path
from typing import List, Optional, Sequence, Tuple

import torch

SRC = Path(__file__).resolve().with_name("zkpcore.cpp")
BUILD_DIR = Path(__file__).resolve().parent.parent / "_build"
CXX = "g++"
CXXFLAGS = ("-O3", "-std=c++17", "-shared", "-fPIC", "-march=native", "-fopenmp")
# the smallest MSM that runs on the thread budget's team (see above)
TEAM_MIN_POINTS = 32
# the registries keep every table (the C++ side never frees one): cap the
# distinct bases a process may register
MAX_FIXED_BASES = 64

_ZERO32 = bytes(32)
_P25519 = 2**255 - 19

Point = Tuple[int, int, int, int]

_lib: Optional[ctypes.CDLL] = None
_load_lock = threading.Lock()
_reg_lock = threading.Lock()
_ed_handles: dict = {}


def library_path() -> Path:
    """The build output for this source, these flags and this host's
    ``-march=native`` target."""
    target = subprocess.run([CXX, *CXXFLAGS, "-Q", "--help=target"], capture_output=True,
                            check=True).stdout
    h = hashlib.sha256(SRC.read_bytes())
    h.update(" ".join(CXXFLAGS).encode())
    h.update(target)
    return BUILD_DIR / f"zkpcore-{h.hexdigest()[:16]}.so"


def build() -> Tuple[Path, Optional[float]]:
    """Compile :data:`SRC` unless this host has built it. Returns the
    library's path and the seconds ``g++`` took in this call (None when the
    library was there). Raises ``RuntimeError`` with the compiler's log on a
    failed compile."""
    so = library_path()
    if so.exists():
        return so, None
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    with open(BUILD_DIR / "zkpcore.lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)  # released when the file closes or the process dies
        if so.exists():  # another process built it while this one waited
            return so, None
        tmp = so.with_name(f"{so.stem}.{os.getpid()}.tmp.so")
        t0 = time.perf_counter()
        proc = subprocess.run([CXX, *CXXFLAGS, "-o", str(tmp), str(SRC)], capture_output=True,
                              text=True)
        seconds = time.perf_counter() - t0
        if proc.returncode != 0:
            tmp.unlink(missing_ok=True)
            raise RuntimeError(f"{CXX} failed to build {SRC} (exit {proc.returncode}):\n"
                               f"{proc.stdout}{proc.stderr}")
        os.replace(tmp, so)
    return so, seconds


def _declare(lib: ctypes.CDLL) -> None:
    u64 = ctypes.c_uint64
    cp = ctypes.c_char_p
    lib.zkp_blake3.argtypes = [cp, u64, cp]
    lib.zkp_blake3_batch.argtypes = [cp, u64, u64, cp]
    lib.zkp_blake3_merge_level.argtypes = [cp, u64, cp]
    lib.zkp_blake3_merkle.argtypes = [cp, u64, cp]
    lib.zkp_keccak_f1600.argtypes = [cp]
    lib.zkp_ed_point_add.argtypes = [cp] * 3
    lib.zkp_ed_point_double.argtypes = [cp] * 2
    lib.zkp_ed_scalar_mul.argtypes = [cp] * 3
    lib.zkp_ed_msm.argtypes = [u64, cp, cp, cp]
    lib.zkp_ristretto_compress.argtypes = [cp, cp]
    lib.zkp_ristretto_decompress.argtypes = [cp, cp]
    lib.zkp_ristretto_decompress.restype = ctypes.c_int
    lib.zkp_bn254_init.argtypes = [cp, cp, cp, u64]
    lib.zkp_bn254_g1_msm.argtypes = [u64, cp, cp, cp]
    lib.zkp_bn254_g2_msm.argtypes = [u64, cp, cp, cp]
    lib.zkp_bn254_g1_scalar_mul.argtypes = [cp] * 3
    lib.zkp_bn254_g2_scalar_mul.argtypes = [cp] * 3
    lib.zkp_bn254_multi_pairing.argtypes = [u64, cp, cp, cp]
    lib.zkp_bn254_miller.argtypes = [cp] * 3
    lib.zkp_bn254_multi_pairing_premul.argtypes = [cp, u64, cp, cp, cp]
    lib.zkp_ntt.argtypes = [u64, cp, cp, cp, cp]
    lib.zkp_groth16_h_register.argtypes = [
        u64, u64, u64, u64, cp, cp, cp, cp, cp, cp, u64, cp, cp, cp, u64, cp, cp, cp, u64]
    lib.zkp_groth16_h_register.restype = ctypes.c_int
    lib.zkp_groth16_h_run.argtypes = [ctypes.c_int, cp, cp]
    lib.zkp_groth16_h_run.restype = ctypes.c_int
    lib.zkp_ed_msm_register.argtypes = [u64, cp]
    lib.zkp_ed_msm_register.restype = ctypes.c_int
    lib.zkp_ed_msm_fixed.argtypes = [ctypes.c_int, cp, cp]
    lib.zkp_ed_msm_fixed_mt.argtypes = [ctypes.c_int, cp, cp, ctypes.c_int]
    lib.zkp_ed_msm_fixed_many.argtypes = [ctypes.c_int, u64, cp, cp]
    for g in ("g1", "g2"):
        getattr(lib, f"zkp_bn254_{g}_msm_register").argtypes = [u64, cp]
        getattr(lib, f"zkp_bn254_{g}_msm_register").restype = ctypes.c_int
        getattr(lib, f"zkp_bn254_{g}_msm_fixed").argtypes = [ctypes.c_int, cp, cp]
        getattr(lib, f"zkp_bn254_{g}_msm_fixed_mt").argtypes = [ctypes.c_int, cp, cp, ctypes.c_int]
        getattr(lib, f"zkp_bn254_{g}_msm_fixed_many").argtypes = [ctypes.c_int, u64, cp, cp]
    lib.zkp_bp_prove_batch.argtypes = [
        ctypes.c_int, ctypes.c_int, ctypes.c_int, u64, u64, cp, cp, cp, cp, cp, cp]
    lib.zkp_bp_prove_batch.restype = ctypes.c_int
    lib.zkp_ed_pedersen_compressed.argtypes = [ctypes.c_int, u64, cp, cp]
    lib.zkp_ed_pedersen_compressed.restype = ctypes.c_int
    lib.zkp_groth16_prove_msms.argtypes = [
        ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int, u64, u64, u64,
        cp, cp, cp]
    lib.zkp_bp_verify_rlc.argtypes = [
        ctypes.c_int, u64, cp, ctypes.POINTER(ctypes.c_uint32), cp, cp, cp, cp, cp, cp]
    lib.zkp_bp_verify_rlc.restype = ctypes.c_int
    lib.zkp_groth16_spmv.argtypes = [
        u64, u64, u64, u64, cp, cp, cp, cp, u64, cp, cp, cp, u64, cp, cp, cp, u64, cp, cp, cp, cp]
    lib.zkp_groth16_spmv.restype = ctypes.c_int
    lib.zkp_stark_prove_improvement_batch.argtypes = [
        u64, ctypes.POINTER(ctypes.c_uint64), cp, cp, cp, u64, cp, u64,
        ctypes.POINTER(ctypes.c_int64)]
    lib.zkp_stark_verify_improvement.argtypes = [cp, cp, u64, u64, cp, u64, cp, u64]
    lib.zkp_stark_verify_improvement.restype = ctypes.c_int
    # the OpenMP runtime the library links (dlsym through the handle searches
    # its dependencies)
    lib.omp_set_num_threads.argtypes = [ctypes.c_int]
    lib.omp_set_num_threads.restype = None
    lib.omp_get_max_threads.argtypes = []
    lib.omp_get_max_threads.restype = ctypes.c_int


def load() -> ctypes.CDLL:
    """The library, built on first use and loaded once a process."""
    global _lib
    if _lib is None:
        with _load_lock:
            if _lib is None:
                lib = ctypes.CDLL(str(build()[0]))
                _declare(lib)
                _lib = lib
    return _lib


@contextlib.contextmanager
def _team(parallel: bool = True):
    """The library, with the OpenMP team of this thread's parallel regions
    set to the process's budget, ``torch.get_num_threads()``, or to one
    thread for the body. The budget is set back after it: where the library
    shares torch's runtime, one setting is both."""
    lib = load()
    budget = torch.get_num_threads()
    lib.omp_set_num_threads(budget if parallel else 1)
    try:
        yield lib
    finally:
        lib.omp_set_num_threads(budget)


def max_threads() -> int:
    """The team a parallel region of the native tier opens from this thread."""
    with _team() as lib:
        return lib.omp_get_max_threads()


# ---------------------------------------------------------------------------
# hashing
# ---------------------------------------------------------------------------


def keccak_f1600_bytes(state: bytearray) -> None:
    """Permute a 200-byte state buffer in place."""
    buf = ctypes.create_string_buffer(bytes(state), 200)
    load().zkp_keccak_f1600(buf)
    state[:] = buf.raw


# ---------------------------------------------------------------------------
# curve25519 / ristretto; wire format X||Y||Z||T, 32-byte canonical LE each
# ---------------------------------------------------------------------------


def _to_wire(pt: Point) -> bytes:
    return b"".join((v % _P25519).to_bytes(32, "little") for v in pt)


def _from_wire(b: bytes) -> Point:
    return tuple(int.from_bytes(b[i : i + 32], "little") for i in range(0, 128, 32))


def ed_point_add(p: Point, q: Point) -> Point:
    out = ctypes.create_string_buffer(128)
    load().zkp_ed_point_add(_to_wire(p), _to_wire(q), out)
    return _from_wire(out.raw)


def ed_scalar_mul(k: int, p: Point, order: int) -> Point:
    out = ctypes.create_string_buffer(128)
    load().zkp_ed_scalar_mul((k % order).to_bytes(32, "little"), _to_wire(p), out)
    return _from_wire(out.raw)


# generator bases are process-constant and reused by every MSM: memoize their
# wire encoding
_wire_cache: dict = {}


def _to_wire_cached(pt: Point) -> bytes:
    w = _wire_cache.get(pt)
    if w is None:
        if len(_wire_cache) > 1 << 16:
            _wire_cache.clear()
        w = _wire_cache[pt] = _to_wire(pt)
    return w


def ed_msm(scalars: Sequence[int], points: Sequence[Point], order: int) -> Point:
    """Pippenger MSM, its windows across the team from
    :data:`TEAM_MIN_POINTS` points."""
    if len(scalars) != len(points):
        raise ValueError(f"{len(scalars)} scalars for {len(points)} points")
    sc = b"".join((s % order).to_bytes(32, "little") for s in scalars)
    pb = b"".join(_to_wire_cached(p) for p in points)
    out = ctypes.create_string_buffer(128)
    with _team(len(points) >= TEAM_MIN_POINTS) as lib:
        lib.zkp_ed_msm(len(points), sc, pb, out)
    return _from_wire(out.raw)


def ed_fixed_handle(key, points: Sequence[Point]) -> int:
    """Registered-table handle of a process-constant basis, registered on
    first use. Raises ``MemoryError`` past :data:`MAX_FIXED_BASES` bases."""
    h = _ed_handles.get(key)
    if h is None:
        with _reg_lock:
            h = _ed_handles.get(key)
            if h is None:
                if len(_ed_handles) >= MAX_FIXED_BASES:
                    raise MemoryError(f"the native fixed-basis registry holds {MAX_FIXED_BASES} "
                                      "bases and never frees one")
                h = _ed_handles[key] = load().zkp_ed_msm_register(
                    len(points), b"".join(_to_wire(p) for p in points))
    return h


def ed_msm_fixed(key, scalars: Sequence[int], points: Sequence[Point], order: int) -> Point:
    """One MSM over the registered basis ``key`` (``points``): one window
    chunk a thread of the team from :data:`TEAM_MIN_POINTS` points, else
    serial."""
    if len(scalars) != len(points):
        raise ValueError(f"{len(scalars)} scalars for {len(points)} points")
    h = ed_fixed_handle(key, points)
    sc = b"".join(_ZERO32 if s == 0 else (s % order).to_bytes(32, "little") for s in scalars)
    out = ctypes.create_string_buffer(128)
    with _team(len(points) >= TEAM_MIN_POINTS) as lib:
        lib.zkp_ed_msm_fixed_mt(h, sc, out, lib.omp_get_max_threads())
    return _from_wire(out.raw)


def ristretto_compress(pt: Point) -> bytes:
    out = ctypes.create_string_buffer(32)
    load().zkp_ristretto_compress(_to_wire(pt), out)
    return out.raw


def ristretto_decompress(data: bytes) -> Optional[Point]:
    """The decoded point, or None for an invalid encoding."""
    if len(data) != 32:
        return None
    out = ctypes.create_string_buffer(128)
    if load().zkp_ristretto_decompress(bytes(data), out) != 1:
        return None
    return _from_wire(out.raw)


# ---------------------------------------------------------------------------
# Bulletproofs: whole-pipeline batch prover and RLC batch verifier
# ---------------------------------------------------------------------------


def bp_prove_batch(h_vs: int, h_as: int, h_ipp: int, n: int, values: Sequence[int],
                   gammas: Sequence[int], rnd: bytes, transcripts: bytes):
    """Range proofs of ``values`` at ``n`` bits over the registered bases
    ``[B, B_blinding]``, ``[B_blinding] + G + H`` and ``G + H + [B]``
    (``zkp_bp_prove_batch``, OpenMP across proofs). ``rnd``: (2n + 4) wide
    64-byte draws a proof; ``transcripts``: each proof's 203-byte STROBE
    state. Returns (compressed V list, proof bytes list); raises
    ``ValueError`` on an identity value commitment."""
    batch = len(values)
    rounds = n.bit_length() - 1
    plen = (9 + 2 * rounds) * 32
    if not (0 < n <= 64 and n & (n - 1) == 0):
        raise ValueError(f"bit width {n} is not a power of two in [1, 64]")
    if len(gammas) != batch or len(rnd) != (2 * n + 4) * 64 * batch or len(transcripts) != 203 * batch:
        raise ValueError("bp_prove_batch: gammas, rnd or transcripts do not match the batch")
    vb = b"".join(int(v).to_bytes(8, "little") for v in values)
    gb = b"".join(int(g).to_bytes(32, "little") for g in gammas)
    out_v = ctypes.create_string_buffer(32 * batch)
    out_p = ctypes.create_string_buffer(plen * batch)
    with _team() as lib:
        rc = lib.zkp_bp_prove_batch(h_vs, h_as, h_ipp, n, batch, vb, gb, bytes(rnd),
                                    bytes(transcripts), out_v, out_p)
    if rc == 1:
        raise ValueError("value commitment is the identity")
    if rc != 0:
        raise RuntimeError(f"zkp_bp_prove_batch failed with {rc}")
    raw_v, raw_p = out_v.raw, out_p.raw
    return ([raw_v[i * 32 : (i + 1) * 32] for i in range(batch)],
            [raw_p[i * plen : (i + 1) * plen] for i in range(batch)])


def bp_verify_rlc(h_fix: int, ns: Sequence[int], proofs: Sequence[bytes], vs: Sequence[bytes],
                  transcripts: Sequence[bytes], rhos: Sequence[bytes],
                  sigmas: Sequence[bytes]) -> Tuple[int, List[int]]:
    """RLC batch verification over the registered basis ``[B_blinding, B] +
    G(64) + H(64)``: ``(rc, bad)``, rc 1 the combined relation holds, 0 it
    does not, 2 structural failures flagged in ``bad`` (relation not
    evaluated). Each n must be a power of two in [1, 64], each V 32 bytes,
    each transcript 203 bytes, each weight a 32-byte scalar."""
    count = len(ns)
    if not all(0 < n <= 64 and n & (n - 1) == 0 for n in ns):
        raise ValueError(f"bit widths {list(ns)}: each must be a power of two in [1, 64]")
    for name, items, size in (("V", vs, 32), ("transcript", transcripts, 203),
                              ("rho", rhos, 32), ("sigma", sigmas, 32)):
        if len(items) != count or any(len(x) != size for x in items):
            raise ValueError(f"bp_verify_rlc: {count} {size}-byte {name} values expected")
    offs = (ctypes.c_uint32 * (count + 1))()
    blob = bytearray()
    for i, p in enumerate(proofs):
        offs[i] = len(blob)
        blob += p
    offs[count] = len(blob)
    bad = ctypes.create_string_buffer(count)
    with _team(count >= 8) as lib:
        rc = lib.zkp_bp_verify_rlc(
            h_fix, count, bytes(ns), offs, bytes(blob), b"".join(vs), b"".join(transcripts),
            b"".join(rhos), b"".join(sigmas), bad)
    return rc, list(bad.raw[:count])
