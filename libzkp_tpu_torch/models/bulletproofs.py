"""Bulletproofs range-proof protocol: proofs, host golden prover, verifier
and the batched entry that runs on the device prover.

Port of the parts of the JAX package's ``libzkp_tpu/models/bulletproofs.py``
that the Bulletproofs backend needs: the same transcript schedule (merlin labels
``dom-sep``/``n``/``m``/``V``/``A``/``S``/``T_1``/``T_2``/``t_x``/
``t_x_blinding``/``e_blinding``/``w`` and the ``ipp v1`` rounds) and the same
672-byte (n=64) serialization ``[A|S|T1|T2|t_x|t_x_bl|e_bl|L_i R_i ...|a|b]``.

* :func:`prove_single` / :func:`ipp_create`: the pure-Python host prover, the
  byte-exact reference of the batched device prover.
* :func:`verify_single`, :func:`batch_verify_groups`: verification on the
  native tier's RLC batch verifier (``zkp_bp_verify_rlc``), as the
  reference's; :func:`verify_single_py`, :func:`batch_verify_groups_py` over
  :func:`verification_terms` and :func:`check_terms`: the pure-Python
  verifier, their golden.
* :func:`prove_single_batch`: sends every 64-bit group of instances to
  :func:`.bp_device.prove_insts_device` on the caller's device, and every
  narrower width to the lockstep host prover, whose MSMs run on that device
  (:func:`..ops.ed25519.msm_fixed_many`).
* :func:`_prove_batch_native`: the native tier's whole-pipeline batch prover
  (``zkp_bp_prove_batch``), byte-identical under the same draws. It is the
  host baseline the card's routes are measured beside; no entry point calls
  it.
"""

from __future__ import annotations

import os
from dataclasses import dataclass
from typing import List, Optional, Tuple

from .. import native
from ..device import resolve
from ..ops import ed25519 as ed
from .bp_generators import bp_gens, pedersen_commit, pedersen_gens
from .strobe import Transcript

L = ed.L

IDENTITY_COMPRESSED = b"\x00" * 32


def _random_scalar() -> int:
    return ed.scalar_from_bytes_mod_order_wide(os.urandom(64))


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


def _inner(a: List[int], b: List[int]) -> int:
    acc = 0
    for x, y in zip(a, b):
        acc = (acc + x * y) % L
    return acc


# ---------------------------------------------------------------------------
# Inner-product argument
# ---------------------------------------------------------------------------


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


def ipp_create(
    t: Transcript,
    G_factors: List[int],
    H_factors: List[int],
    G: List[ed.Point],
    H: List[ed.Point],
    a: List[int],
    b: List[int],
    q_scalar: int,
    B: ed.Point,
) -> InnerProductProof:
    """Inner-product argument prover over Q = q_scalar * B.

    The folded generators are never materialized: after j rounds the current
    generator ``G'(j)_i`` is ``sum_k gc[k] * G_k`` over original indices
    ``k ≡ i (mod m)``, so every L/R is one MSM over the original basis
    ``G + H + [B]`` (the fixed basis the device prover's table holds).
    """
    n = len(a)
    assert n & (n - 1) == 0
    t.append_message(b"dom-sep", b"ipp v1")
    t.append_u64(b"n", n)
    a = list(a)
    b = list(b)
    gc = list(G_factors)  # coefficient of original G_k in the current basis
    hc = list(H_factors)
    L_vec: List[bytes] = []
    R_vec: List[bytes] = []
    m = n
    while m > 1:
        half = m // 2
        cL = _inner(a[:half], b[half:])
        cR = _inner(a[half:], b[:half])
        g_scal = [0] * n
        h_scal = [0] * n
        for k in range(n):
            i = k % m
            if i >= half:  # contributes to L via a_L against G_R
                g_scal[k] = a[i - half] * gc[k] % L
            else:  # H_L against b_R
                h_scal[k] = b[half + i] * hc[k] % L
        Lp = ed.msm_fixed(g_scal + h_scal + [cL * q_scalar % L], G + H + [B])
        for k in range(n):
            i = k % m
            if i < half:
                g_scal[k] = a[half + i] * gc[k] % L
                h_scal[k] = 0
            else:
                g_scal[k] = 0
                h_scal[k] = b[i - half] * hc[k] % L
        Rp = ed.msm_fixed(g_scal + h_scal + [cR * q_scalar % L], G + H + [B])
        Lc, Rc = ed.compress(Lp), ed.compress(Rp)
        L_vec.append(Lc)
        R_vec.append(Rc)
        _append_point(t, b"L", Lc)
        _append_point(t, b"R", Rc)
        u = _challenge_scalar(t, b"u")
        u_inv = pow(u, -1, L)
        a = [(a[i] * u + u_inv * a[half + i]) % L for i in range(half)]
        b = [(b[i] * u_inv + u * b[half + i]) % L for i in range(half)]
        for k in range(n):
            if (k % m) < half:
                gc[k] = gc[k] * u_inv % L
                hc[k] = hc[k] * u % L
            else:
                gc[k] = gc[k] * u % L
                hc[k] = hc[k] * u_inv % L
        m = half
    return InnerProductProof(L_vec, R_vec, a[0], b[0])


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


# ---------------------------------------------------------------------------
# Range proof
# ---------------------------------------------------------------------------


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


def prove_single(
    t: Transcript, value: int, blinding: int, n: int
) -> Tuple[RangeProof, bytes]:
    """Host golden prover: a range proof that value in [0, 2^n); returns
    (proof, V_compressed). Randomness from :func:`_random_scalar`, drawn in
    the order a, s, s_L(n), s_R(n), t1, t2."""
    assert 0 < n <= 64 and n & (n - 1) == 0
    assert value < (1 << n)
    B, B_blinding = pedersen_gens()
    G, H = bp_gens(n)
    G = list(G)
    H = list(H)

    t.append_message(b"dom-sep", b"rangeproof v1")
    t.append_u64(b"n", n)
    t.append_u64(b"m", 1)

    gamma = blinding % L
    V = ed.compress(pedersen_commit(value % L, gamma))
    if not _validate_and_append_point(t, b"V", V):
        raise ValueError("value commitment is the identity")

    a_L = [(value >> i) & 1 for i in range(n)]
    a_blinding = _random_scalar()
    # A = a_blinding*B_b + sum(aL_i G_i) - sum((1-aL_i) H_i), one fixed-base MSM
    A_pt = ed.msm_fixed(
        [a_blinding] + a_L + [(b - 1) % L for b in a_L], [B_blinding] + G + H
    )
    s_blinding = _random_scalar()
    s_L = [_random_scalar() for _ in range(n)]
    s_R = [_random_scalar() for _ in range(n)]
    S_pt = ed.msm_fixed([s_blinding] + s_L + s_R, [B_blinding] + G + H)
    A_c, S_c = ed.compress(A_pt), ed.compress(S_pt)
    _append_point(t, b"A", A_c)
    _append_point(t, b"S", S_c)

    y = _challenge_scalar(t, b"y")
    z = _challenge_scalar(t, b"z")
    z2 = z * z % L

    # t(x) = <l(x), r(x)> = t0 + t1 x + t2 x^2
    l0 = [(a_L[i] - z) % L for i in range(n)]
    l1 = s_L
    yi = 1
    r0, r1 = [], []
    for i in range(n):
        a_R_i = (a_L[i] - 1) % L
        r0.append((yi * ((a_R_i + z) % L) + z2 * pow(2, i, L)) % L)
        r1.append(yi * s_R[i] % L)
        yi = yi * y % L
    t1 = (_inner(l0, r1) + _inner(l1, r0)) % L
    t2 = _inner(l1, r1)
    t1_blinding = _random_scalar()
    t2_blinding = _random_scalar()
    T_1 = ed.compress(pedersen_commit(t1, t1_blinding))
    T_2 = ed.compress(pedersen_commit(t2, t2_blinding))
    _append_point(t, b"T_1", T_1)
    _append_point(t, b"T_2", T_2)

    x = _challenge_scalar(t, b"x")
    l_vec = [(l0[i] + l1[i] * x) % L for i in range(n)]
    r_vec = [(r0[i] + r1[i] * x) % L for i in range(n)]
    t_x = _inner(l_vec, r_vec)
    t_x_blinding = (z2 * gamma + x * t1_blinding + x * x % L * t2_blinding) % L
    e_blinding = (a_blinding + x * s_blinding) % L
    _append_scalar(t, b"t_x", t_x)
    _append_scalar(t, b"t_x_blinding", t_x_blinding)
    _append_scalar(t, b"e_blinding", e_blinding)

    w = _challenge_scalar(t, b"w")
    y_inv = pow(y, -1, L)
    H_factors = []
    yi = 1
    for _ in range(n):
        H_factors.append(yi)
        yi = yi * y_inv % L
    # Q = w*B is never materialized: cL*w folds onto the basis point B
    ipp = ipp_create(t, [1] * n, H_factors, G, H, l_vec, r_vec, q_scalar=w, B=B)
    return RangeProof(A_c, S_c, T_1, T_2, t_x, t_x_blinding, e_blinding, ipp), V


def prove_single_batch(
    instances: List[Tuple[Transcript, int, int, int]], *, device=None
) -> List[Tuple[RangeProof, bytes]]:
    """Lockstep batch prover on ``device`` (default: the CUDA card).

    Instances are ``(transcript, value, blinding, n)``, grouped by ``n``:
    64-bit instances run on the batched device prover
    (:func:`.bp_device.prove_insts_device`), every other width the reference
    takes (n a power of two up to 32) on the lockstep host prover, whose
    MSMs run on ``device`` through :func:`..ops.ed25519.msm_fixed_many`.
    """
    out: List[Optional[Tuple[RangeProof, bytes]]] = [None] * len(instances)
    by_n: dict = {}
    for i, inst in enumerate(instances):
        by_n.setdefault(inst[3], []).append(i)
    for n, idxs in by_n.items():
        res = _prove_batch_fixed_n([instances[i] for i in idxs], n, device=device)
        for i, r in zip(idxs, res):
            out[i] = r
    return out  # type: ignore[return-value]


def _prove_batch_fixed_n(
    insts, n: int, rand: Optional[bytes] = None, *, device=None
) -> List[Tuple[RangeProof, bytes]]:
    """Batched prover for one bit width.

    ``rand`` supplies the per-proof randomness as ``(2n + 4)`` wide 64-byte
    draws per proof, ordered ``a_blind, s_blind, s_L[0..n-1], s_R[0..n-1],
    t1_blinding, t2_blinding`` (:func:`prove_single`'s draw order, so both
    give the same bytes under the same draws); ``None`` draws from
    ``os.urandom``. A width the reference refuses raises its
    ``AssertionError``.
    """
    from . import bp_device

    if not (0 < n <= 64 and n & (n - 1) == 0):
        raise AssertionError(f"bit width {n} is not a power of two in [1, 64]")
    dev = resolve(device)
    m0 = len(insts)
    per = (2 * n + 4) * 64
    if rand is None:
        rand = os.urandom(per * m0)
    if len(rand) != per * m0:
        raise ValueError("rand must hold (2n+4) 64-byte draws per instance")
    for _, value, _, _ in insts:
        if not 0 <= value < (1 << n):
            raise ValueError(f"value {value} is not in [0, 2^{n})")
    if n != bp_device.N_BITS:
        return _prove_batch_lockstep(insts, n, rand, dev)
    # the device prover resumes every lane's transcript at one STROBE
    # position: group by it
    groups: dict = {}
    for idx, (t, _, _, _) in enumerate(insts):
        groups.setdefault(t.strobe.state_bytes()[200:203], []).append(idx)
    out: List[Optional[Tuple[RangeProof, bytes]]] = [None] * m0
    for idxs in groups.values():
        sub = [insts[i] for i in idxs]
        sub_rand = b"".join(rand[i * per : (i + 1) * per] for i in idxs)
        res = bp_device.prove_insts_device(sub, rand=sub_rand, device=dev)
        for i, (pbytes, v) in zip(idxs, res):
            rp = RangeProof.from_bytes(pbytes)
            if rp is None:
                raise RuntimeError("device prover emitted an unparseable proof")
            out[i] = (rp, v)
    return out  # type: ignore[return-value]


def _prove_batch_lockstep(insts, n: int, rand: bytes, dev) -> List[Tuple[RangeProof, bytes]]:
    """The JAX package's lockstep host prover (its ``_prove_batch_fixed_n``
    after the native and device branches): every instance advances through
    :func:`prove_single`'s phases together, each phase's MSMs one
    :func:`..ops.ed25519.msm_fixed_many` batch on ``dev`` (V; A‖S; T1‖T2;
    L‖R per inner-product round), the transcripts and the scalar algebra on
    the host."""
    m0 = len(insts)
    per = (2 * n + 4) * 64

    def _wide(j: int, slot: int) -> int:
        off = j * per + slot * 64
        return ed.scalar_from_bytes_mod_order_wide(rand[off : off + 64])

    B, B_blinding = pedersen_gens()
    G, H = bp_gens(n)
    G = list(G)
    H = list(H)
    basis_vs = [B, B_blinding]
    basis_as = [B_blinding] + G + H
    basis_ipp = G + H + [B]

    # -- phase 1: value commitments -----------------------------------------
    gammas = [blinding % L for _, _, blinding, _ in insts]
    a_Ls = [[(value >> i) & 1 for i in range(n)] for _, value, _, _ in insts]
    V_pts = ed.msm_fixed_many(
        [[value % L, g] for (_, value, _, _), g in zip(insts, gammas)], basis_vs, device=dev
    )
    Vs = [ed.compress(p) for p in V_pts]

    # -- phase 2: A and S commitments (one batch for both) ------------------
    a_blind = [_wide(j, 0) for j in range(m0)]
    s_blind = [_wide(j, 1) for j in range(m0)]
    s_Ls = [[_wide(j, 2 + i) for i in range(n)] for j in range(m0)]
    s_Rs = [[_wide(j, 2 + n + i) for i in range(n)] for j in range(m0)]
    as_vecs = []
    for j in range(m0):
        a_L = a_Ls[j]
        as_vecs.append([a_blind[j]] + a_L + [(b - 1) % L for b in a_L])
        as_vecs.append([s_blind[j]] + s_Ls[j] + s_Rs[j])
    as_pts = ed.msm_fixed_many(as_vecs, basis_as, device=dev)

    ys, zs, A_cs, S_cs = [], [], [], []
    for j, (t, _, _, _) in enumerate(insts):
        t.append_message(b"dom-sep", b"rangeproof v1")
        t.append_u64(b"n", n)
        t.append_u64(b"m", 1)
        if not _validate_and_append_point(t, b"V", Vs[j]):
            raise ValueError("value commitment is the identity")
        A_c, S_c = ed.compress(as_pts[2 * j]), ed.compress(as_pts[2 * j + 1])
        _append_point(t, b"A", A_c)
        _append_point(t, b"S", S_c)
        A_cs.append(A_c)
        S_cs.append(S_c)
        ys.append(_challenge_scalar(t, b"y"))
        zs.append(_challenge_scalar(t, b"z"))

    # -- phase 3: t(x) commitments ------------------------------------------
    l0s, r0s, r1s, t1b, t2b, t_vecs = [], [], [], [], [], []
    for j in range(m0):
        y, z = ys[j], zs[j]
        z2 = z * z % L
        a_L, s_L, s_R = a_Ls[j], s_Ls[j], s_Rs[j]
        l0 = [(a_L[i] - z) % L for i in range(n)]
        yi = 1
        pow2 = 1
        r0, r1 = [], []
        for i in range(n):
            r0.append((yi * ((a_L[i] - 1 + z) % L) + z2 * pow2) % L)
            r1.append(yi * s_R[i] % L)
            yi = yi * y % L
            pow2 = pow2 * 2 % L
        t1 = (_inner(l0, r1) + _inner(s_L, r0)) % L
        t2 = _inner(s_L, r1)
        t1b.append(_wide(j, 2 + 2 * n))
        t2b.append(_wide(j, 3 + 2 * n))
        l0s.append(l0)
        r0s.append(r0)
        r1s.append(r1)
        t_vecs.append([t1, t1b[j]])
        t_vecs.append([t2, t2b[j]])
    t_pts = ed.msm_fixed_many(t_vecs, basis_vs, device=dev)

    # -- phase 4: x and w challenges, the inner-product inputs -----------------
    states = []
    for j, (t, _, _, _) in enumerate(insts):
        z2 = zs[j] * zs[j] % L
        T_1 = ed.compress(t_pts[2 * j])
        T_2 = ed.compress(t_pts[2 * j + 1])
        _append_point(t, b"T_1", T_1)
        _append_point(t, b"T_2", T_2)
        x = _challenge_scalar(t, b"x")
        l0, r0, r1, s_L = l0s[j], r0s[j], r1s[j], s_Ls[j]
        l_vec = [(l0[i] + s_L[i] * x) % L for i in range(n)]
        r_vec = [(r0[i] + r1[i] * x) % L for i in range(n)]
        t_x = _inner(l_vec, r_vec)
        t_x_blinding = (z2 * gammas[j] + x * t1b[j] + x * x % L * t2b[j]) % L
        e_blinding = (a_blind[j] + x * s_blind[j]) % L
        _append_scalar(t, b"t_x", t_x)
        _append_scalar(t, b"t_x_blinding", t_x_blinding)
        _append_scalar(t, b"e_blinding", e_blinding)
        w = _challenge_scalar(t, b"w")
        y_inv = pow(ys[j], -1, L)
        hf = []
        yi = 1
        for _ in range(n):
            hf.append(yi)
            yi = yi * y_inv % L
        t.append_message(b"dom-sep", b"ipp v1")
        t.append_u64(b"n", n)
        states.append({"t": t, "a": l_vec, "b": r_vec, "gc": [1] * n, "hc": hf, "w": w,
                       "L": [], "R": [], "T_1": T_1, "T_2": T_2, "t_x": t_x,
                       "t_x_blinding": t_x_blinding, "e_blinding": e_blinding})

    # -- phase 5: the inner-product rounds in lockstep ---------------------------
    m = n
    while m > 1:
        half = m // 2
        vecs = []
        for st in states:
            a, b, gc, hc, w = st["a"], st["b"], st["gc"], st["hc"], st["w"]
            cL = _inner(a[:half], b[half:])
            cR = _inner(a[half:], b[:half])
            gl, hl, gr, hr = [0] * n, [0] * n, [0] * n, [0] * n
            for k in range(n):
                i = k % m
                if i >= half:
                    gl[k] = a[i - half] * gc[k] % L
                    hr[k] = b[i - half] * hc[k] % L
                else:
                    hl[k] = b[half + i] * hc[k] % L
                    gr[k] = a[half + i] * gc[k] % L
            vecs.append(gl + hl + [cL * w % L])
            vecs.append(gr + hr + [cR * w % L])
        pts = ed.msm_fixed_many(vecs, basis_ipp, device=dev)
        for j, st in enumerate(states):
            t = st["t"]
            Lc = ed.compress(pts[2 * j])
            Rc = ed.compress(pts[2 * j + 1])
            st["L"].append(Lc)
            st["R"].append(Rc)
            _append_point(t, b"L", Lc)
            _append_point(t, b"R", Rc)
            u = _challenge_scalar(t, b"u")
            u_inv = pow(u, -1, L)
            a, b, gc, hc = st["a"], st["b"], st["gc"], st["hc"]
            st["a"] = [(a[i] * u + u_inv * a[half + i]) % L for i in range(half)]
            st["b"] = [(b[i] * u_inv + u * b[half + i]) % L for i in range(half)]
            for k in range(n):
                if (k % m) < half:
                    gc[k] = gc[k] * u_inv % L
                    hc[k] = hc[k] * u % L
                else:
                    gc[k] = gc[k] * u % L
                    hc[k] = hc[k] * u_inv % L
        m = half

    return [
        (
            RangeProof(A_cs[j], S_cs[j], st["T_1"], st["T_2"], st["t_x"], st["t_x_blinding"],
                       st["e_blinding"], InnerProductProof(st["L"], st["R"], st["a"][0], st["b"][0])),
            Vs[j],
        )
        for j, st in enumerate(states)
    ]


def _prove_batch_native(insts, n: int, rand: bytes) -> List[Tuple[RangeProof, bytes]]:
    """The native tier's whole-pipeline batch prover (``zkp_bp_prove_batch``:
    one call, OpenMP across proofs) under the draws of
    :func:`_prove_batch_fixed_n`'s ``rand``; reads each transcript's STROBE
    state and leaves the transcript as it was. The host baseline of the
    card's routes: no entry point calls it. Raises ``MemoryError`` when the
    native basis registry is full."""
    B, B_blinding = pedersen_gens()
    G, H = bp_gens(n)
    basis_vs = [B, B_blinding]
    basis_as = [B_blinding] + list(G) + list(H)
    basis_ipp = list(G) + list(H) + [B]
    handles = [native.ed_fixed_handle(tuple(b), b) for b in (basis_vs, basis_as, basis_ipp)]
    vs, ps = native.bp_prove_batch(
        *handles, n, [value for _, value, _, _ in insts], [bl % L for _, _, bl, _ in insts],
        rand, b"".join(t.strobe.state_bytes() for t, _, _, _ in insts))
    out = []
    for pbytes, v in zip(ps, vs):
        rp = RangeProof.from_bytes(pbytes)
        if rp is None:
            raise RuntimeError("the native prover emitted an unparseable proof")
        out.append((rp, v))
    return out


# ---------------------------------------------------------------------------
# Verification
# ---------------------------------------------------------------------------


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
    c_fixed = ed.msm_fixed(
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


def verify_single_py(proof: RangeProof, t: Transcript, V: bytes, n: int) -> bool:
    """Pure-Python :func:`verify_single`. Never raises: a malformed proof is
    ``False``."""
    try:
        terms = verification_terms(proof, t, V, n)
        if terms is None:
            return False
        # combine the two checks with a random weight: one MSM total
        return check_terms([(terms, 1, _rlc_weight())])
    except Exception:
        return False


def batch_verify_groups_py(
    groups: List[List[Tuple[RangeProof, Transcript, bytes, int]]]
) -> List[bool]:
    """Pure-Python :func:`batch_verify_groups`: one combined MSM, bisecting
    on a failed combined check."""
    results = [False] * len(groups)
    term_groups: List[Optional[List[VerificationTerms]]] = []
    for g in groups:
        try:
            terms = [verification_terms(p, t, V, n) for p, t, V, n in g]
        except Exception:
            terms = [None]
        term_groups.append(None if any(x is None for x in terms) else terms)

    def _check(idxs: List[int]) -> None:
        weighted = [
            (t, _rlc_weight(), _rlc_weight()) for i in idxs for t in term_groups[i]
        ]
        try:
            ok = check_terms(weighted)
        except Exception:
            ok = False
        if ok:
            for i in idxs:
                results[i] = True
        elif len(idxs) > 1:
            mid = len(idxs) // 2
            _check(idxs[:mid])
            _check(idxs[mid:])

    live = [i for i, tg in enumerate(term_groups) if tg is not None]
    if live:
        _check(live)
    return results


def verify_single(proof: RangeProof, t: Transcript, V: bytes, n: int) -> bool:
    """Verify a single-value range proof against compressed commitment V, on
    the native RLC verifier. A malformed proof is ``False``."""
    return batch_verify_groups([[(proof, t, V, n)]])[0]


def _verify_fix_handle() -> int:
    """Registered handle of the verification basis [B_blinding, B] + G + H."""
    B, B_blinding = pedersen_gens()
    G, H = bp_gens(64)
    basis = [B_blinding, B] + list(G) + list(H)
    return native.ed_fixed_handle(tuple(basis), basis)


# an instance that cannot reach the native verifier (a proof that does not
# serialise, a V that is not 32 bytes, a width the verifier refuses): a
# zero-length proof, which the verifier flags as structurally bad
_MALFORMED = (b"", b"\0" * 32, b"\0" * 203, 64)


def batch_verify_groups(
    groups: List[List[Tuple[RangeProof, Transcript, bytes, int]]]
) -> List[bool]:
    """Verify groups of range-proof instances in one native call: the
    transcript replays, the scalars and one grand MSM (``zkp_bp_verify_rlc``).

    A group is the set of single-proof instances of one envelope-level proof;
    its verdict is all-instances-pass, and an empty group is vacuously
    ``True``. Groups holding a structurally bad instance fail and the rest are
    checked again; on a failed combined check the batch bisects on group
    boundaries, so a few bad proofs cost O(log n) extra calls. A malformed
    proof is ``False``; a failure of the native call itself raises.
    """
    results = [not g for g in groups]
    flat = []  # (group index, proof bytes, V, transcript state, n)
    for gi, g in enumerate(groups):
        for p, t, V, n in g:
            try:
                parts = (p.A, p.S, p.T_1, p.T_2, *p.ipp.L_vec, *p.ipp.R_vec, V)
                inst = (p.to_bytes(), bytes(V), t.strobe.state_bytes(), n)
            except Exception:  # malformed input: a failing instance, not an error
                parts, inst = (), _MALFORMED
            if any(len(c) != 32 for c in parts) or not (
                isinstance(n, int) and 0 < n <= 64 and n & (n - 1) == 0
            ):
                inst = _MALFORMED
            flat.append((gi, *inst))
    if not flat:
        return results
    h_fix = _verify_fix_handle()

    def _check(idxs: List[int], allow_struct: bool) -> None:
        rhos = [_rlc_weight().to_bytes(32, "little") for _ in idxs]
        sigmas = [_rlc_weight().to_bytes(32, "little") for _ in idxs]
        rc, bad = native.bp_verify_rlc(
            h_fix, [flat[i][4] for i in idxs], [flat[i][1] for i in idxs],
            [flat[i][2] for i in idxs], [flat[i][3] for i in idxs], rhos, sigmas)
        if rc == 2 and allow_struct:
            # drop every group holding a structurally bad instance, retry
            bad_groups = {flat[idxs[j]][0] for j, b in enumerate(bad) if b}
            keep = [i for i in idxs if flat[i][0] not in bad_groups]
            if keep:
                _check(keep, False)
            return
        if rc == 1:
            for i in idxs:
                results[flat[i][0]] = True
            return
        # the combined relation failed: bisect on group boundaries
        gidxs = sorted({flat[i][0] for i in idxs})
        if len(gidxs) > 1:
            lo = set(gidxs[: len(gidxs) // 2])
            _check([i for i in idxs if flat[i][0] in lo], False)
            _check([i for i in idxs if flat[i][0] not in lo], False)

    _check(list(range(len(flat))), True)
    return results
