"""Groth16 over BN254 in pure Python: the deployment's keys and the
verifier.

Frozen copy of the port's host golden tier: the circuit-specific setup
(R1CS -> QAP over a radix-2 Fr domain) with its toxic waste drawn from a
seeded generator, so that one key seed gives one pair of keys; the
arkworks ``serialize_uncompressed`` key and proof layouts; and the batch
verifier, one random linear combination of many proofs' pairing checks in
one multi-pairing.
"""

from __future__ import annotations

import os
import random
import struct
from dataclasses import dataclass
from typing import List, Optional, Tuple

from . import bn254 as bn
from .field import BN254_FR
from .r1cs import ConstraintSystem

R = BN254_FR.p


class _FixedBase:
    """Windowed multiples of one base point for the setup's many scalar
    multiplications (``add``/``double``/``inf`` of G1 or G2)."""

    def __init__(self, base, add, double, inf, window: int = 8):
        self.window = window
        self.add = add
        self.inf = inf
        self.tables = []
        cur = base
        for _ in range((254 + window - 1) // window):
            row = [inf]
            for i in range(1, 1 << window):
                row.append(add(row[i - 1], cur))
            self.tables.append(row)
            for _ in range(window):
                cur = double(cur)

    def mul(self, k: int):
        k %= R
        acc = self.inf
        w = 0
        mask = (1 << self.window) - 1
        while k:
            digit = k & mask
            if digit:
                acc = self.add(acc, self.tables[w][digit])
            k >>= self.window
            w += 1
        return acc


@dataclass
class VerifyingKey:
    alpha_g1: bn.G1
    beta_g2: bn.G2
    gamma_g2: bn.G2
    delta_g2: bn.G2
    gamma_abc_g1: List[bn.G1]  # per instance variable (incl. ONE)


@dataclass
class ProvingKey:
    vk: VerifyingKey
    beta_g1: bn.G1
    delta_g1: bn.G1
    a_query: List[bn.G1]  # u_i(tau) G1, all variables
    b_g1_query: List[bn.G1]
    b_g2_query: List[bn.G2]
    h_query: List[bn.G1]  # tau^j Z(tau)/delta G1
    l_query: List[bn.G1]  # witness variables


def _domain_size(cs: ConstraintSystem) -> int:
    need = len(cs.constraints) + cs.num_instance
    n = 1
    while n < need:
        n <<= 1
    return n


def _qap_evals_at_tau(cs: ConstraintSystem, tau: int, n: int):
    """u_i(tau), v_i(tau), w_i(tau) per variable, plus Z(tau).

    Row j of the QAP corresponds to Lagrange basis L_j over the size-n domain;
    rows beyond the constraints are the instance-consistency rows
    (A=instance_i, B=0, C=0) that make the input polynomials independent.
    """
    F = BN254_FR
    omega = F.root_of_unity(n)
    z_tau = (pow(tau, n, R) - 1) % R
    omegas = []
    w = 1
    for _ in range(n):
        omegas.append(w)
        w = w * omega % R
    inv_denoms = F.batch_inv([(tau - o) % R for o in omegas])
    n_inv = F.inv(n)
    lag = [z_tau * o % R * n_inv % R * inv_denoms[j] % R for j, o in enumerate(omegas)]

    nv = cs.num_variables
    u = [0] * nv
    v = [0] * nv
    w_ = [0] * nv
    for j, (a, b, c) in enumerate(cs.constraints):
        lj = lag[j]
        for tag, coeff in a.items():
            u[cs._resolve(tag)] = (u[cs._resolve(tag)] + coeff * lj) % R
        for tag, coeff in b.items():
            v[cs._resolve(tag)] = (v[cs._resolve(tag)] + coeff * lj) % R
        for tag, coeff in c.items():
            w_[cs._resolve(tag)] = (w_[cs._resolve(tag)] + coeff * lj) % R
    for i in range(cs.num_instance):
        lj = lag[len(cs.constraints) + i]
        u[i] = (u[i] + lj) % R
    return u, v, w_, z_tau


def setup(cs: ConstraintSystem, rng: random.Random) -> ProvingKey:
    """Circuit-specific trusted setup, its toxic waste drawn from ``rng``."""
    g1b = _FixedBase(bn.g1_from_affine(bn.G1_GEN), bn.g1_add, bn.g1_double, bn.G1_INF)
    g2b = _FixedBase(bn.g2_from_affine((bn.G2_GEN_X, bn.G2_GEN_Y)), bn.g2_add, bn.g2_double,
                     bn.G2_INF)
    F = BN254_FR
    n = _domain_size(cs)
    alpha, beta, gamma, delta, tau = (rng.randrange(1, R) for _ in range(5))
    u, v, w_, z_tau = _qap_evals_at_tau(cs, tau, n)
    gamma_inv = F.inv(gamma)
    delta_inv = F.inv(delta)
    nv = cs.num_variables
    ni = cs.num_instance
    zd = z_tau * delta_inv % R
    h_query = []
    t_pow = 1
    for _ in range(n - 1):
        h_query.append(g1b.mul(t_pow * zd % R))
        t_pow = t_pow * tau % R
    vk = VerifyingKey(
        alpha_g1=g1b.mul(alpha),
        beta_g2=g2b.mul(beta),
        gamma_g2=g2b.mul(gamma),
        delta_g2=g2b.mul(delta),
        gamma_abc_g1=[
            g1b.mul((beta * u[i] + alpha * v[i] + w_[i]) % R * gamma_inv % R) for i in range(ni)
        ],
    )
    return ProvingKey(
        vk=vk,
        beta_g1=g1b.mul(beta),
        delta_g1=g1b.mul(delta),
        a_query=[g1b.mul(u[i]) for i in range(nv)],
        b_g1_query=[g1b.mul(v[i]) for i in range(nv)],
        b_g2_query=[g2b.mul(v[i]) for i in range(nv)],
        h_query=h_query,
        l_query=[
            g1b.mul((beta * u[i] + alpha * v[i] + w_[i]) % R * delta_inv % R)
            for i in range(ni, nv)
        ],
    )


@dataclass
class Proof:
    a: bn.G1
    b: bn.G2
    c: bn.G1


_FLAG_INF = 0x40
_FLAG_NEG = 0x80
_FLAG_MASK = 0xC0


def _fq_is_neg(y: int) -> bool:
    """arkworks SWFlags::from_y_coordinate: negative iff y > -y."""
    return y > (bn.P - y) % bn.P


def _fq2_is_neg(y0: int, y1: int) -> bool:
    """Fq2 ordering compares c1 first, then c0 (arkworks QuadExtField)."""
    n0, n1 = (bn.P - y0) % bn.P, (bn.P - y1) % bn.P
    return (y1, y0) > (n1, n0)


def _g1_bytes(p: bn.G1) -> bytes:
    aff = bn.g1_to_affine(p)
    if aff is None:
        return b"\x00" * 63 + bytes([_FLAG_INF])
    out = bytearray(aff[0].to_bytes(32, "little") + aff[1].to_bytes(32, "little"))
    if _fq_is_neg(aff[1]):
        out[63] |= _FLAG_NEG
    return bytes(out)


def _g1_from(data: bytes) -> Optional[bn.G1]:
    if len(data) != 64:
        return None
    flags = data[63] & _FLAG_MASK
    body = bytes(data[:63]) + bytes([data[63] & ~_FLAG_MASK])
    if flags & _FLAG_INF or body == b"\x00" * 64:
        # all-zero without the flag = the JAX package's round-1 infinity
        return bn.G1_INF if body == b"\x00" * 64 else None
    x = int.from_bytes(body[:32], "little")
    y = int.from_bytes(body[32:], "little")
    if x >= bn.P or y >= bn.P:
        return None
    p = (x, y, 1)
    return p if bn.g1_is_on_curve(p) else None


def _g2_bytes(p: bn.G2) -> bytes:
    aff = bn.g2_to_affine(p)
    if aff is None:
        return b"\x00" * 127 + bytes([_FLAG_INF])
    (x0, x1), (y0, y1) = aff
    out = bytearray(b"".join(v.to_bytes(32, "little") for v in (x0, x1, y0, y1)))
    if _fq2_is_neg(y0, y1):
        out[127] |= _FLAG_NEG
    return bytes(out)


def _g2_from(data: bytes) -> Optional[bn.G2]:
    if len(data) != 128:
        return None
    flags = data[127] & _FLAG_MASK
    body = bytes(data[:127]) + bytes([data[127] & ~_FLAG_MASK])
    if flags & _FLAG_INF or body == b"\x00" * 128:
        return bn.G2_INF if body == b"\x00" * 128 else None
    vals = [int.from_bytes(body[i * 32 : (i + 1) * 32], "little") for i in range(4)]
    if any(v >= bn.P for v in vals):
        return None
    p = ((vals[0], vals[1]), (vals[2], vals[3]), bn.FQ2_ONE)
    return p if bn.g2_is_on_curve(p) else None


def proof_to_bytes(proof: Proof) -> bytes:
    """256 bytes: A (G1) || B (G2) || C (G1) — arkworks element order."""
    return _g1_bytes(proof.a) + _g2_bytes(proof.b) + _g1_bytes(proof.c)


def proof_from_bytes(data: bytes) -> Optional[Proof]:
    if len(data) != 256:
        return None
    a = _g1_from(data[0:64])
    b = _g2_from(data[64:192])
    c = _g1_from(data[192:256])
    if a is None or b is None or c is None:
        return None
    return Proof(a=a, b=b, c=c)


# Key files: raw arkworks `CanonicalSerialize` concatenation, exactly what
# `ProvingKey::<Bn254>::serialize_uncompressed` emits: struct fields in
# declaration order, `Vec<T>` as u64-LE length + elements.
#   VerifyingKey { alpha_g1, beta_g2, gamma_g2, delta_g2, gamma_abc_g1 }
#   ProvingKey   { vk, beta_g1, delta_g1, a_query, b_g1_query, b_g2_query,
#                  h_query, l_query }


class _Reader:
    def __init__(self, data: bytes):
        self.data = data
        self.pos = 0

    def g1(self) -> bn.G1:
        p = _g1_from(self.data[self.pos : self.pos + 64])
        self.pos += 64
        if p is None:
            raise ValueError("bad G1")
        return p

    def g2(self) -> bn.G2:
        p = _g2_from(self.data[self.pos : self.pos + 128])
        self.pos += 128
        if p is None:
            raise ValueError("bad G2")
        return p

    def vec_len(self, width: int = 8) -> int:
        c = int.from_bytes(self.data[self.pos : self.pos + width], "little")
        self.pos += width
        if c > 1 << 24:
            raise ValueError("bad count")
        return c

    def done(self) -> bool:
        return self.pos == len(self.data)


def _vk_write(out: bytearray, vk: VerifyingKey) -> None:
    out += _g1_bytes(vk.alpha_g1)
    out += _g2_bytes(vk.beta_g2)
    out += _g2_bytes(vk.gamma_g2)
    out += _g2_bytes(vk.delta_g2)
    out += struct.pack("<Q", len(vk.gamma_abc_g1))
    for p in vk.gamma_abc_g1:
        out += _g1_bytes(p)


def _vk_read(r: _Reader) -> VerifyingKey:
    alpha_g1 = r.g1()
    beta_g2 = r.g2()
    gamma_g2 = r.g2()
    delta_g2 = r.g2()
    gamma_abc = [r.g1() for _ in range(r.vec_len())]
    return VerifyingKey(alpha_g1, beta_g2, gamma_g2, delta_g2, gamma_abc)


def pk_to_bytes(pk: ProvingKey) -> bytes:
    out = bytearray()
    _vk_write(out, pk.vk)
    out += _g1_bytes(pk.beta_g1)
    out += _g1_bytes(pk.delta_g1)
    for name in ("a_query", "b_g1_query"):
        vec = getattr(pk, name)
        out += struct.pack("<Q", len(vec))
        for p in vec:
            out += _g1_bytes(p)
    out += struct.pack("<Q", len(pk.b_g2_query))
    for p in pk.b_g2_query:
        out += _g2_bytes(p)
    for name in ("h_query", "l_query"):
        vec = getattr(pk, name)
        out += struct.pack("<Q", len(vec))
        for p in vec:
            out += _g1_bytes(p)
    return bytes(out)


def pk_from_bytes(data: bytes) -> Optional[ProvingKey]:
    try:
        r = _Reader(data)
        vk = _vk_read(r)
        beta_g1 = r.g1()
        delta_g1 = r.g1()
        a_query = [r.g1() for _ in range(r.vec_len())]
        b_g1_query = [r.g1() for _ in range(r.vec_len())]
        b_g2_query = [r.g2() for _ in range(r.vec_len())]
        h_query = [r.g1() for _ in range(r.vec_len())]
        l_query = [r.g1() for _ in range(r.vec_len())]
        if not r.done():
            return None
        return ProvingKey(
            vk, beta_g1, delta_g1, a_query, b_g1_query, b_g2_query, h_query, l_query
        )
    except Exception:
        return None


def vk_to_bytes(vk: VerifyingKey) -> bytes:
    out = bytearray()
    _vk_write(out, vk)
    return bytes(out)


def vk_from_bytes(data: bytes) -> Optional[VerifyingKey]:
    try:
        r = _Reader(data)
        vk = _vk_read(r)
        return vk if r.done() else None
    except Exception:
        return None


def verify_batch(vk: VerifyingKey, items: List[Tuple[List[int], Proof]]) -> List[bool]:
    """The verdict of each ``(public_inputs, proof)`` item under ``vk``:
    A and C on G1, B on G2 and in its subgroup, and, with 128-bit weights
    w_i drawn from the OS,

        prod_i e(w_i A_i, B_i) * e(-sum_i w_i IC_i, gamma)
             * e(-sum_i w_i C_i, delta) * e(-(sum_i w_i) alpha, beta) == 1

    as one multi-pairing over N + 3 pairs, the IC sum one MSM over
    gamma_abc. On failure the set is halved until each bad proof stands
    alone."""
    results = [False] * len(items)
    n_pub = len(vk.gamma_abc_g1) - 1
    live: List[int] = []
    for i, (public_inputs, proof) in enumerate(items):
        if (len(public_inputs) == n_pub and bn.g1_is_on_curve(proof.a)
                and bn.g1_is_on_curve(proof.c) and bn.g2_is_on_curve(proof.b)
                and bn.g2_in_subgroup(proof.b)):
            live.append(i)
    neg_alpha = bn.g1_neg(vk.alpha_g1)

    def check(idxs: List[int]) -> None:
        weights = [int.from_bytes(os.urandom(16), "little") | 1 for _ in idxs]
        pairs = []
        ic_scalars = [0] * (n_pub + 1)
        for w, i in zip(weights, idxs):
            public_inputs, proof = items[i]
            pairs.append((bn.g1_scalar_mul(w, proof.a), proof.b))
            ic_scalars[0] = (ic_scalars[0] + w) % R
            for j, x in enumerate(public_inputs):
                ic_scalars[j + 1] = (ic_scalars[j + 1] + w * (x % R)) % R
        ic = bn.g1_msm(ic_scalars, vk.gamma_abc_g1)
        c_sum = bn.g1_msm(weights, [items[i][1].c for i in idxs])
        pairs.append((bn.g1_neg(ic), vk.gamma_g2))
        pairs.append((bn.g1_neg(c_sum), vk.delta_g2))
        pairs.append((bn.g1_scalar_mul(sum(weights) % R, neg_alpha), vk.beta_g2))
        if bn.multi_pairing(pairs) == bn.FQ12_ONE:
            for i in idxs:
                results[i] = True
        elif len(idxs) > 1:
            check(idxs[: len(idxs) // 2])
            check(idxs[len(idxs) // 2 :])

    if live:
        check(live)
    return results
