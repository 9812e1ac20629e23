"""Native host tier: ctypes over ``zkpcore.cpp``, built at first use.

``zkpcore.cpp`` is the JAX package's C++ host tier, kept here as the port's
own copy: Keccak-f[1600] for the STROBE transcript, the curve25519 group
(point add, scalar multiplication, Pippenger and fixed-basis MSMs),
Ristretto255 encode and decode, the whole-pipeline Bulletproofs batch
prover and RLC batch verifier, and the BN254 and Groth16 host half: G1 and
G2 scalar multiplication, Pippenger and fixed-basis MSMs, the five query
MSMs of a proof in one call, the sparse products and the whole h pipeline
of a circuit, and the optimal-ate multi-pairing; and the STARK host half:
BLAKE3 and the Merkle levels over its digests, the radix-2 NTT, and the
whole-pipeline f128 improvement prover and its verifier. Every hook is held
against the pure-Python goldens (``*_py`` in :mod:`..ops.keccak`,
:mod:`..ops.ed25519`, :mod:`..ops.bn254`, :mod:`..ops.blake3` and
:mod:`..ops.ntt`). The BN254 calls need the
curve's constants, handed over once a process by :func:`bn254_init` (which
:mod:`..ops.bn254` calls on its first hook call); before that they raise.

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
thread budget, ``torch.get_num_threads()``, runs the batch provers
(Bulletproofs, and the STARK's from 9 pairs, where its loop opens), the
verifier from 8 instances (where its own loop goes two-wide) and an MSM of
at least :data:`TEAM_MIN_POINTS` points, whose windows a fixed-basis MSM
splits into one chunk a thread, the five Groth16 query MSMs of a proof and
a multi-pairing of at least :data:`TEAM_MIN_PAIRS` pairs; smaller calls run
serial. On an H100 machine's 8-core host a team of 4 or 8 took an MSM of 1
to 7 points up to 13 times longer than one thread, and an MSM of 33 or 130
points 2 to 6 times shorter; a team of 8 took a multi-pairing of 4 pairs
1.5-2 times and one of 259 pairs 6-7 times shorter (PERF.md §5).
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
# the smallest multi-pairing whose Miller loops run on the team (the
# library opens its region from 4 pairs)
TEAM_MIN_PAIRS = 4
# the registries keep every table (the C++ side never frees one): cap the
# distinct bases a process may register, in each registry (ed25519, G1, G2,
# and the Groth16 h circuits)
MAX_FIXED_BASES = 64

_ZERO32 = bytes(32)
_P25519 = 2**255 - 19

Point = Tuple[int, int, int, int]

_lib: Optional[ctypes.CDLL] = None
_load_lock = threading.Lock()
_reg_lock = threading.Lock()
_ed_handles: dict = {}
_g1_handles: dict = {}
_g2_handles: dict = {}
_g16h_handles: dict = {}
_bn254_lock = threading.Lock()
_bn254: Optional[tuple] = None  # (q, r, frob, hard) once bn254_init has run


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


def blake3_256(data: bytes) -> bytes:
    """BLAKE3 with a 32-byte output. Serial."""
    data = bytes(data)
    out = ctypes.create_string_buffer(32)
    load().zkp_blake3(data, len(data), out)
    return out.raw


def blake3_batch(items: Sequence[bytes], item_len: int) -> List[bytes]:
    """BLAKE3-256 of each of ``items``, byte strings of ``item_len`` bytes
    each, in one call. Serial."""
    if any(len(x) != item_len for x in items):
        raise ValueError(f"blake3_batch: every item must be {item_len} bytes")
    n = len(items)
    out = ctypes.create_string_buffer(32 * n)
    load().zkp_blake3_batch(b"".join(items), n, item_len, out)
    raw = out.raw
    return [raw[i * 32 : (i + 1) * 32] for i in range(n)]


def blake3_merkle_levels(leaves: Sequence[bytes]) -> List[List[bytes]]:
    """Every level above the leaves of a Merkle tree over a power-of-two
    count of 32-byte leaf digests, bottom-up (each node the BLAKE3-256 of its
    children's 64 bytes). Serial."""
    n = len(leaves)
    if n < 1 or n & (n - 1) or any(len(x) != 32 for x in leaves):
        raise ValueError("blake3_merkle_levels takes a power-of-two count of 32-byte digests")
    out = ctypes.create_string_buffer(32 * (n - 1))
    load().zkp_blake3_merkle(b"".join(leaves), n, out)
    raw = out.raw
    levels, off, width = [], 0, n // 2
    while width:
        levels.append([raw[(off + i) * 32 : (off + i + 1) * 32] for i in range(width)])
        off += width
        width //= 2
    return levels


# ---------------------------------------------------------------------------
# NTT and the STARK improvement prover and verifier (f128)
# ---------------------------------------------------------------------------


def ntt(p: int, values: Sequence[int], root: int, scale: Optional[int]) -> List[int]:
    """Radix-2 NTT over the prime ``p`` (below 2^256) with the size-n root
    ``root``; the inverse transform takes the inverted root and ``scale`` =
    n^-1 mod p. Serial."""
    n = len(values)
    if n < 1 or n & (n - 1):
        raise ValueError(f"ntt: size {n} is not a power of two")
    buf = ctypes.create_string_buffer(b"".join((v % p).to_bytes(32, "little") for v in values), 32 * n)
    sc = (scale % p).to_bytes(32, "little") if scale is not None else None
    load().zkp_ntt(n, buf, p.to_bytes(32, "little"), (root % p).to_bytes(32, "little"), sc)
    raw = buf.raw
    return [int.from_bytes(raw[i * 32 : (i + 1) * 32], "little") for i in range(n)]


# room for one improvement proof in the batch prover's output (a proof is
# about 5 KB)
STARK_OUT_STRIDE = 8192
_U64 = 1 << 64


def stark_prove_improvement_batch(pairs: Sequence[Tuple[int, int]], p: int, root64: int,
                                  ctxs: Sequence[bytes]) -> List[bytes]:
    """The whole improvement pipeline of each ``(old, new)`` pair (u64
    values) in one call, its proofs across the team: ``root64`` is the LDE
    domain's root of unity, ``ctxs`` each pair's random-coin seed material
    (``ImprovementAir.context_bytes``, all one length). Raises ``ValueError``
    for a pair with no valid witness."""
    batch = len(pairs)
    if batch == 0:
        return []
    if len(ctxs) != batch or len({len(c) for c in ctxs}) != 1:
        raise ValueError("stark_prove_improvement_batch: one seed of one length a pair")
    pair_arr = (ctypes.c_uint64 * (2 * batch))()
    for i, (old, new) in enumerate(pairs):
        if not (0 <= old < _U64 and 0 <= new < _U64):
            raise ValueError(f"pair {i}: values must be u64")
        pair_arr[2 * i], pair_arr[2 * i + 1] = old, new
    out = ctypes.create_string_buffer(STARK_OUT_STRIDE * batch)
    lens = (ctypes.c_int64 * batch)()
    with _team() as lib:
        lib.zkp_stark_prove_improvement_batch(
            batch, pair_arr, p.to_bytes(32, "little"), (root64 % p).to_bytes(32, "little"),
            b"".join(ctxs), len(ctxs[0]), out, STARK_OUT_STRIDE, lens)
    raw = out.raw
    res = []
    for i in range(batch):
        if lens[i] < 0:
            raise ValueError("invalid improvement witness")
        res.append(raw[i * STARK_OUT_STRIDE : i * STARK_OUT_STRIDE + lens[i]])
    return res


def stark_verify_improvement(old: int, new: int, p: int, root64: int, ctx: bytes,
                             proof: bytes) -> bool:
    """Verify one improvement proof against its u64 public inputs; the
    library parses every length and bound of ``proof`` itself, so malformed
    bytes give False. Serial."""
    if not (0 <= old < _U64 and 0 <= new < _U64):
        raise ValueError("stark_verify_improvement: values must be u64")
    proof, ctx = bytes(proof), bytes(ctx)
    return bool(load().zkp_stark_verify_improvement(
        p.to_bytes(32, "little"), (root64 % p).to_bytes(32, "little"), old, new, ctx, len(ctx),
        proof, len(proof)))


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


def _handle(registry: dict, key, register, what: str = "fixed-basis") -> int:
    """The handle ``registry`` holds for ``key``, registered on first use by
    ``register()``. Raises ``MemoryError`` past :data:`MAX_FIXED_BASES`
    entries."""
    h = registry.get(key)
    if h is None:
        with _reg_lock:
            h = registry.get(key)
            if h is None:
                if len(registry) >= MAX_FIXED_BASES:
                    raise MemoryError(f"the native {what} registry holds {MAX_FIXED_BASES} "
                                      "entries and never frees one")
                h = registry[key] = register()
    return h


def ed_fixed_handle(key, points: Sequence[Point]) -> int:
    """Registered-table handle of a process-constant basis, registered on
    first use. Raises ``MemoryError`` past :data:`MAX_FIXED_BASES` bases."""
    return _handle(_ed_handles, key, lambda: load().zkp_ed_msm_register(
        len(points), b"".join(_to_wire(p) for p in points)))


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


# ---------------------------------------------------------------------------
# BN254: wire formats G1 Jacobian X||Y||Z (96 bytes), G2 Jacobian over Fq2
# x.c0||x.c1||y.c0||y.c1||z.c0||z.c1 (192 bytes), Fq12 12 x 32 bytes in the
# tower's nesting order; every field element 32 bytes little-endian
# ---------------------------------------------------------------------------


def bn254_init(q: int, r: int, frob_gamma1, hard_exp: int) -> None:
    """Hand the library BN254's constants, once a process: the base field's
    modulus q, the group order r (scalars are reduced mod r), the Frobenius
    coefficients gamma_1 (six Fq2 pairs) and the final exponentiation's hard
    part (q^4 - q^2 + 1) / r. Builds the library if needed. A second call
    with the same values does nothing; with other values it raises
    ``ValueError``."""
    global _bn254
    consts = (q, r, tuple(tuple(pair) for pair in frob_gamma1), hard_exp)
    with _bn254_lock:
        if _bn254 is not None:
            if _bn254 != consts:
                raise ValueError("bn254_init: the library holds other BN254 constants")
            return
        frob = b"".join(c.to_bytes(32, "little") for pair in consts[2] for c in pair)
        he = hard_exp.to_bytes((hard_exp.bit_length() + 7) // 8, "little")
        load().zkp_bn254_init(q.to_bytes(32, "little"), frob, he, len(he))
        _bn254 = consts


def _bn254_consts() -> tuple:
    if _bn254 is None:
        raise RuntimeError("BN254 constants not set: call native.bn254_init first "
                           "(ops.bn254 does on its first hook call)")
    return _bn254


def _bn254_lib() -> ctypes.CDLL:
    """The library, once :func:`bn254_init` has set its BN254 constants."""
    _bn254_consts()
    return load()


def _bn254_team(parallel: bool = True):
    """:func:`_team` over the library with its BN254 constants set."""
    _bn254_lib()
    return _team(parallel)


def _scalars(scalars: Sequence[int]) -> bytes:
    r = _bn254_consts()[1]
    return b"".join((s % r).to_bytes(32, "little") for s in scalars)


def _g1_to_wire(p) -> bytes:
    q = _bn254_consts()[0]
    return b"".join((int(v) % q).to_bytes(32, "little") for v in p)


def _g1_from_wire(b: bytes):
    return tuple(int.from_bytes(b[i : i + 32], "little") for i in range(0, 96, 32))


def _g2_to_wire(p) -> bytes:
    q = _bn254_consts()[0]
    return b"".join((int(c) % q).to_bytes(32, "little") for coord in p for c in coord)


def _g2_from_wire(b: bytes):
    v = [int.from_bytes(b[i : i + 32], "little") for i in range(0, 192, 32)]
    return ((v[0], v[1]), (v[2], v[3]), (v[4], v[5]))


def _fq12_from_wire(b: bytes):
    v = [int.from_bytes(b[i : i + 32], "little") for i in range(0, 384, 32)]
    return (((v[0], v[1]), (v[2], v[3]), (v[4], v[5])),
            ((v[6], v[7]), (v[8], v[9]), (v[10], v[11])))


# proving-key query points are process-constant and reused by every MSM:
# memoize their wire encoding
_g1_wire_cache: dict = {}
_g2_wire_cache: dict = {}


def _wire_cached(cache: dict, encode, p) -> bytes:
    w = cache.get(p)
    if w is None:
        if len(cache) > 1 << 16:
            cache.clear()
        w = cache[p] = encode(p)
    return w


def _msm(g: str, scalars: Sequence[int], points) -> bytes:
    if len(scalars) != len(points):
        raise ValueError(f"{len(scalars)} scalars for {len(points)} points")
    cache, encode, size = ((_g1_wire_cache, _g1_to_wire, 96) if g == "g1"
                           else (_g2_wire_cache, _g2_to_wire, 192))
    pb = b"".join(_wire_cached(cache, encode, p) for p in points)
    out = ctypes.create_string_buffer(size)
    with _bn254_team(len(points) >= TEAM_MIN_POINTS) as lib:
        getattr(lib, f"zkp_bn254_{g}_msm")(len(points), _scalars(scalars), pb, out)
    return out.raw


def bn254_g1_msm(scalars: Sequence[int], points):
    """Pippenger MSM over G1 (Jacobian points), its windows across the team
    from :data:`TEAM_MIN_POINTS` points."""
    return _g1_from_wire(_msm("g1", scalars, points))


def bn254_g2_msm(scalars: Sequence[int], points):
    """Pippenger MSM over G2, as :func:`bn254_g1_msm`."""
    return _g2_from_wire(_msm("g2", scalars, points))


def bn254_g1_scalar_mul(k: int, p):
    """k * p over G1 (a one-point MSM), serial."""
    out = ctypes.create_string_buffer(96)
    with _bn254_team(False) as lib:
        lib.zkp_bn254_g1_scalar_mul(_scalars([k]), _g1_to_wire(p), out)
    return _g1_from_wire(out.raw)


def bn254_g2_scalar_mul(k: int, p):
    """k * p over G2, serial."""
    out = ctypes.create_string_buffer(192)
    with _bn254_team(False) as lib:
        lib.zkp_bn254_g2_scalar_mul(_scalars([k]), _g2_to_wire(p), out)
    return _g2_from_wire(out.raw)


def g1_fixed_handle(key, points) -> int:
    """Registered-table handle of a process-constant G1 basis (as
    :func:`ed_fixed_handle`)."""
    return _handle(_g1_handles, key, lambda: _bn254_lib().zkp_bn254_g1_msm_register(
        len(points), b"".join(_g1_to_wire(p) for p in points)))


def g2_fixed_handle(key, points) -> int:
    """Registered-table handle of a process-constant G2 basis."""
    return _handle(_g2_handles, key, lambda: _bn254_lib().zkp_bn254_g2_msm_register(
        len(points), b"".join(_g2_to_wire(p) for p in points)))


def _msm_fixed(g: str, key, scalars: Sequence[int], points) -> bytes:
    if len(scalars) != len(points):
        raise ValueError(f"{len(scalars)} scalars for {len(points)} points")
    h = (g1_fixed_handle if g == "g1" else g2_fixed_handle)(key, points)
    out = ctypes.create_string_buffer(96 if g == "g1" else 192)
    with _bn254_team(len(points) >= TEAM_MIN_POINTS) as lib:
        getattr(lib, f"zkp_bn254_{g}_msm_fixed_mt")(h, _scalars(scalars), out,
                                                     lib.omp_get_max_threads())
    return out.raw


def bn254_g1_msm_fixed(key, scalars: Sequence[int], points):
    """One MSM over the registered G1 basis ``key`` (``points``): one window
    chunk a thread of the team from :data:`TEAM_MIN_POINTS` points, else
    serial."""
    return _g1_from_wire(_msm_fixed("g1", key, scalars, points))


def bn254_g2_msm_fixed(key, scalars: Sequence[int], points):
    """One MSM over the registered G2 basis ``key``, as
    :func:`bn254_g1_msm_fixed`."""
    return _g2_from_wire(_msm_fixed("g2", key, scalars, points))


def groth16_prove_msms(ha: int, hb1: int, hh: int, hl: int, hb2: int, z: Sequence[int],
                       h: Sequence[int], wit_off: int):
    """The five query MSMs of one Groth16 proof in one call over the
    registered a, b_g1, h, l (G1) and b_g2 (G2) queries: every MSM cut into
    two window halves, all ten tasks under one OpenMP loop on the team.
    Returns (a, b_g1, h, l, b_g2) accumulators."""
    out = ctypes.create_string_buffer(4 * 96 + 192)
    with _bn254_team() as lib:
        lib.zkp_groth16_prove_msms(ha, hb1, hh, hl, hb2, len(z), len(h), wit_off, _scalars(z),
                                   _scalars(h), out)
    raw = out.raw
    return (*(_g1_from_wire(raw[i * 96 : (i + 1) * 96]) for i in range(4)),
            _g2_from_wire(raw[384:576]))


def _unpack(raw: bytes, count: int) -> List[int]:
    return [int.from_bytes(raw[i * 32 : (i + 1) * 32], "little") for i in range(count)]


def groth16_h(n: int, n_constraints: int, n_instance: int, p: int, root: int, coset_g: int,
              csr, z: Sequence[int]) -> List[int]:
    """h of assignment ``z`` in one call: the sparse products, seven NTTs
    over Fr of size ``n``, the coset scalings and the pointwise combine (the
    library runs the three vectors' chains as three OpenMP sections of its
    own from n = 256). ``csr`` is the circuit's packed rows, ``((ptr, idx,
    coef, nnz),) * 3`` (A, B, C; uint32 ptr and idx, 32-byte little-endian
    coefficients). The circuit's constants register once, keyed by ``csr``
    (at most :data:`MAX_FIXED_BASES` circuits, then ``MemoryError``). Raises
    ``AssertionError`` when h has degree above n - 2 (an unsatisfied
    constraint system)."""
    key = (n, n_constraints, n_instance, len(z), p, root, coset_g, csr)

    def register():
        (ap, ai, ac, an), (bp, bi, bc, bn_), (cp, ci, cc, cn) = csr
        return load().zkp_groth16_h_register(
            n, n_constraints, n_instance, len(z), p.to_bytes(32, "little"),
            (root % p).to_bytes(32, "little"), (coset_g % p).to_bytes(32, "little"),
            ap, ai, ac, an, bp, bi, bc, bn_, cp, ci, cc, cn)

    h = _handle(_g16h_handles, key, register, "Groth16 h circuit")
    out = ctypes.create_string_buffer(32 * (n - 1))
    if load().zkp_groth16_h_run(h, b"".join((v % p).to_bytes(32, "little") for v in z), out) != 0:
        raise AssertionError("h degree exceeds n-2: unsatisfied constraint system?")
    return _unpack(out.raw, n - 1)


def groth16_spmv(n: int, n_constraints: int, n_instance: int, p: int, csr,
                 z: Sequence[int]) -> Tuple[bytes, bytes, bytes]:
    """The sparse half of the h pipeline: A, B and C over the size-``n``
    domain for assignment ``z`` (``csr`` as in :func:`groth16_h`; the
    instance-consistency rows add z[i] to A), each as ``n`` canonical
    32-byte little-endian values, the rows the device h takes. Serial;
    registers nothing."""
    (ap, ai, ac, an), (bp, bi, bc, bn_), (cp, ci, cc, cn) = csr
    bufs = [ctypes.create_string_buffer(32 * n) for _ in range(3)]
    load().zkp_groth16_spmv(n, n_constraints, n_instance, len(z), p.to_bytes(32, "little"),
                            ap, ai, ac, an, bp, bi, bc, bn_, cp, ci, cc, cn,
                            b"".join((v % p).to_bytes(32, "little") for v in z), *bufs)
    return tuple(b.raw for b in bufs)


def _pairs_wire(pairs) -> Tuple[bytes, bytes]:
    return (b"".join(_g1_to_wire(p) for p, _ in pairs), b"".join(_g2_to_wire(q) for _, q in pairs))


def bn254_multi_pairing(pairs):
    """prod e(P_i, Q_i) over ``(G1, G2)`` pairs with one final
    exponentiation (pairs with a point at infinity skipped): the Miller
    loops across the team from :data:`TEAM_MIN_PAIRS` pairs. -> Fq12."""
    pairs = list(pairs)
    g1b, g2b = _pairs_wire(pairs)
    out = ctypes.create_string_buffer(384)
    with _bn254_team(len(pairs) >= TEAM_MIN_PAIRS) as lib:
        lib.zkp_bn254_multi_pairing(len(pairs), g1b, g2b, out)
    return _fq12_from_wire(out.raw)


def bn254_miller_bytes(g1, g2) -> bytes:
    """The Miller loop of (g1, g2) before the final exponentiation, as wire
    bytes (for a pair that is constant per key)."""
    out = ctypes.create_string_buffer(384)
    _bn254_lib().zkp_bn254_miller(_g1_to_wire(g1), _g2_to_wire(g2), out)
    return out.raw


def bn254_multi_pairing_premul(f_pre: bytes, pairs):
    """:func:`bn254_multi_pairing` with the Miller value ``f_pre``
    (:func:`bn254_miller_bytes`) multiplied in before the final
    exponentiation. Serial."""
    pairs = list(pairs)
    g1b, g2b = _pairs_wire(pairs)
    out = ctypes.create_string_buffer(384)
    _bn254_lib().zkp_bn254_multi_pairing_premul(bytes(f_pre), len(pairs), g1b, g2b, out)
    return _fq12_from_wire(out.raw)
