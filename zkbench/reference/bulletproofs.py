"""Bulletproofs range-proof verification in pure Python.

Frozen copy of the port's pure-Python verifier (``verification_terms`` and
``check_terms``): the merlin transcript schedule (``dom-sep``/``n``/``m``/
``V``/``A``/``S``/``T_1``/``T_2``/``t_x``/``t_x_blinding``/``e_blinding``/
``w`` and the ``ipp v1`` rounds), the proof layout
``[A|S|T1|T2|t_x|t_x_bl|e_bl|L_i R_i ...|a|b]``, and one random linear
combination of the t and IPP checks of many proofs as one MSM.
"""

from __future__ import annotations

import os
from dataclasses import dataclass
from typing import List, Optional, Tuple

from . import ed25519 as ed
from .bp_generators import bp_gens, pedersen_gens
from .strobe import Transcript

L = ed.L

IDENTITY_COMPRESSED = b"\x00" * 32


def _challenge_scalar(t: Transcript, label: bytes) -> int:
    return ed.scalar_from_bytes_mod_order_wide(t.challenge_bytes(label, 64))


def _append_point(t: Transcript, label: bytes, compressed: bytes) -> None:
    t.append_message(label, compressed)


def _validate_and_append_point(t: Transcript, label: bytes, compressed: bytes) -> bool:
    if compressed == IDENTITY_COMPRESSED:
        return False
    t.append_message(label, compressed)
    return True


def _append_scalar(t: Transcript, label: bytes, s: int) -> None:
    t.append_message(label, ed.scalar_to_bytes(s))


@dataclass
class InnerProductProof:
    L_vec: List[bytes]
    R_vec: List[bytes]
    a: int
    b: int

    def to_bytes(self) -> bytes:
        out = bytearray()
        for l, r in zip(self.L_vec, self.R_vec):
            out += l
            out += r
        out += ed.scalar_to_bytes(self.a)
        out += ed.scalar_to_bytes(self.b)
        return bytes(out)

    @classmethod
    def from_bytes(cls, data: bytes, rounds: int) -> Optional["InnerProductProof"]:
        if len(data) != rounds * 64 + 64:
            return None
        L_vec, R_vec = [], []
        for j in range(rounds):
            L_vec.append(data[j * 64 : j * 64 + 32])
            R_vec.append(data[j * 64 + 32 : j * 64 + 64])
        a = ed.scalar_from_canonical_bytes(data[rounds * 64 : rounds * 64 + 32])
        b = ed.scalar_from_canonical_bytes(data[rounds * 64 + 32 :])
        if a is None or b is None:
            return None
        return cls(L_vec, R_vec, a, b)


def ipp_verification_scalars(
    proof: InnerProductProof, n: int, t: Transcript
) -> Optional[Tuple[List[int], List[int], List[int]]]:
    """Replay the IPP transcript: (u_sq, u_inv_sq, s) per dalek naming."""
    rounds = len(proof.L_vec)
    if n != (1 << rounds):
        return None
    t.append_message(b"dom-sep", b"ipp v1")
    t.append_u64(b"n", n)
    challenges = []
    for Lc, Rc in zip(proof.L_vec, proof.R_vec):
        if not _validate_and_append_point(t, b"L", Lc):
            return None
        if not _validate_and_append_point(t, b"R", Rc):
            return None
        challenges.append(_challenge_scalar(t, b"u"))
    u_sq = [u * u % L for u in challenges]
    u_inv = [pow(u, -1, L) for u in challenges]
    u_inv_sq = [u * u % L for u in u_inv]
    # s[i] = prod_j u_j^{+-1}: +1 when bit (rounds-1-j) of i is set
    allinv = 1
    for ui in u_inv:
        allinv = allinv * ui % L
    s = [allinv]
    for i in range(1, n):
        lg = i.bit_length() - 1
        k = 1 << lg
        s.append(s[i - k] * u_sq[rounds - 1 - lg] % L)
    return u_sq, u_inv_sq, s


@dataclass
class RangeProof:
    A: bytes
    S: bytes
    T_1: bytes
    T_2: bytes
    t_x: int
    t_x_blinding: int
    e_blinding: int
    ipp: InnerProductProof

    def to_bytes(self) -> bytes:
        return (
            self.A
            + self.S
            + self.T_1
            + self.T_2
            + ed.scalar_to_bytes(self.t_x)
            + ed.scalar_to_bytes(self.t_x_blinding)
            + ed.scalar_to_bytes(self.e_blinding)
            + self.ipp.to_bytes()
        )

    @classmethod
    def from_bytes(cls, data: bytes) -> Optional["RangeProof"]:
        if len(data) < 7 * 32 + 64 or (len(data) - 7 * 32 - 64) % 64 != 0:
            return None
        rounds = (len(data) - 7 * 32 - 64) // 64
        pts = [data[i * 32 : (i + 1) * 32] for i in range(4)]
        sc = []
        for i in range(4, 7):
            v = ed.scalar_from_canonical_bytes(data[i * 32 : (i + 1) * 32])
            if v is None:
                return None
            sc.append(v)
        ipp = InnerProductProof.from_bytes(data[7 * 32 :], rounds)
        if ipp is None:
            return None
        return cls(pts[0], pts[1], pts[2], pts[3], sc[0], sc[1], sc[2], ipp)


def _delta(n: int, y: int, z: int) -> int:
    """delta(y, z) = (z - z^2) <1, y^n> - z^3 <1, 2^n> (single-party m=1)."""
    sum_y = 0
    yi = 1
    for _ in range(n):
        sum_y = (sum_y + yi) % L
        yi = yi * y % L
    sum_2 = (1 << n) - 1
    z2 = z * z % L
    return ((z - z2) * sum_y - z2 * z % L * (sum_2 % L)) % L


@dataclass
class VerificationTerms:
    """One range-proof verification, reduced to MSM coefficients.

    The t-commitment check and the folded IPP check are linear relations
    over the shared basis ``[B_blinding, B] + G + H`` plus per-proof points;
    a random linear combination of many such relations is one MSM whose
    result must be the identity (see :func:`check_terms`).
    """

    n: int
    c1_b: int  # coefficient on B in the t-commitment check
    c1_bb: int  # coefficient on B_blinding in the t-commitment check
    c1_dyn: List[Tuple[int, object]]  # (scalar, point): V, T1, T2
    c2_b: int  # coefficient on B in the IPP check
    c2_bb: int  # coefficient on B_blinding in the IPP check
    g_scalars: List[int]  # per-generator coefficients, length n
    h_scalars: List[int]
    c2_dyn: List[Tuple[int, object]]  # (scalar, point): A, S, L_j, R_j


def verification_terms(
    proof: RangeProof, t: Transcript, V: bytes, n: int
) -> Optional[VerificationTerms]:
    """Replay the transcript and derive all verification scalars; None on
    any structural failure (bad points, identity V, wrong IPP length)."""
    if not (0 < n <= 64 and n & (n - 1) == 0):
        return None

    t.append_message(b"dom-sep", b"rangeproof v1")
    t.append_u64(b"n", n)
    t.append_u64(b"m", 1)
    if not _validate_and_append_point(t, b"V", V):
        return None
    _append_point(t, b"A", proof.A)
    _append_point(t, b"S", proof.S)
    y = _challenge_scalar(t, b"y")
    z = _challenge_scalar(t, b"z")
    _append_point(t, b"T_1", proof.T_1)
    _append_point(t, b"T_2", proof.T_2)
    x = _challenge_scalar(t, b"x")
    _append_scalar(t, b"t_x", proof.t_x)
    _append_scalar(t, b"t_x_blinding", proof.t_x_blinding)
    _append_scalar(t, b"e_blinding", proof.e_blinding)
    w = _challenge_scalar(t, b"w")

    out = ipp_verification_scalars(proof.ipp, n, t)
    if out is None:
        return None
    u_sq, u_inv_sq, s = out

    V_pt = ed.decompress(V)
    A_pt = ed.decompress(proof.A)
    S_pt = ed.decompress(proof.S)
    T1_pt = ed.decompress(proof.T_1)
    T2_pt = ed.decompress(proof.T_2)
    Ls = [ed.decompress(c) for c in proof.ipp.L_vec]
    Rs = [ed.decompress(c) for c in proof.ipp.R_vec]
    if any(p is None for p in [V_pt, A_pt, S_pt, T1_pt, T2_pt] + Ls + Rs):
        return None

    z2 = z * z % L
    x2 = x * x % L

    a, b = proof.ipp.a, proof.ipp.b
    y_inv = pow(y, -1, L)
    g_scalars = [(-z - a * s[i]) % L for i in range(n)]
    # flipping every bit of i inverts every factor of s[i]: s_inv[i] == s[n-1-i]
    s_inv = s[::-1]
    h_scalars = []
    yi_inv = 1
    pow2 = 1
    for i in range(n):
        h_scalars.append((z + (z2 * pow2 - b * s_inv[i]) % L * yi_inv) % L)
        yi_inv = yi_inv * y_inv % L
        pow2 = pow2 * 2 % L
    return VerificationTerms(
        n=n,
        c1_b=(proof.t_x - _delta(n, y, z)) % L,
        c1_bb=proof.t_x_blinding,
        c1_dyn=[((-z2) % L, V_pt), ((-x) % L, T1_pt), ((-x2) % L, T2_pt)],
        c2_b=w * ((proof.t_x - a * b) % L) % L,
        c2_bb=(-proof.e_blinding) % L,
        g_scalars=g_scalars,
        h_scalars=h_scalars,
        c2_dyn=[(1, A_pt), (x % L, S_pt)] + list(zip(u_sq, Ls)) + list(zip(u_inv_sq, Rs)),
    )


def check_terms(weighted: List[Tuple[VerificationTerms, int, int]]) -> bool:
    """Evaluate a random linear combination of verification relations.

    ``weighted`` is ``[(terms, rho, sigma)]`` — rho weights the IPP check,
    sigma the t check. A proof that fails either check passes the combined
    relation with probability ~2^-128 over the weights.
    """
    if not weighted:
        return True
    B, B_blinding = pedersen_gens()
    G, H = bp_gens(64)  # superset chain; n<64 instances use a prefix
    acc_b = 0
    acc_bb = 0
    g_acc = [0] * 64
    h_acc = [0] * 64
    dyn_s: List[int] = []
    dyn_p: List[object] = []
    for terms, rho, sigma in weighted:
        acc_b = (acc_b + rho * terms.c2_b + sigma * terms.c1_b) % L
        acc_bb = (acc_bb + rho * terms.c2_bb + sigma * terms.c1_bb) % L
        for i, gs in enumerate(terms.g_scalars):
            g_acc[i] = (g_acc[i] + rho * gs) % L
        for i, hs in enumerate(terms.h_scalars):
            h_acc[i] = (h_acc[i] + rho * hs) % L
        for sc, pt in terms.c2_dyn:
            dyn_s.append(sc * rho % L)
            dyn_p.append(pt)
        for sc, pt in terms.c1_dyn:
            dyn_s.append(sc * sigma % L)
            dyn_p.append(pt)
    c_fixed = ed.msm(
        [acc_bb, acc_b] + g_acc + h_acc, [B_blinding, B] + list(G) + list(H)
    )
    c_dyn = ed.msm(dyn_s, dyn_p)
    return ed.ristretto_eq(ed.point_add(c_fixed, c_dyn), ed.IDENTITY)


def _rlc_weight() -> int:
    """128-bit nonzero random weight for batch combination."""
    w = 0
    while w == 0:
        w = int.from_bytes(os.urandom(16), "little")
    return w
