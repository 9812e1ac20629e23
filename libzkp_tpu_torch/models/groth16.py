"""Groth16 zk-SNARK over BN254: setup, prove, batched prove, verify, bytes.

Port of the JAX package's ``libzkp_tpu/models/groth16.py`` (the
``ark-groth16`` pipeline of the Rust reference): circuit-specific setup
(R1CS -> QAP over a radix-2 Fr domain), proving (the query MSMs on G1/G2 and
the h query) and pairing-based verification. The host's group operations
run where the JAX package runs them, on the native tier through the hooks
of :mod:`..ops.bn254`. The batched prover, :func:`prove_assigned_many`, runs
its five query MSMs (four over G1, one over G2) on a device through
``bn254.g1_msm_fixed_many`` / ``g2_msm_fixed_many`` and the MSM kernels,
and the NTTs of h there too; the sparse products and the finishing fold of
each proof run on the native tier:

* h for a distinct statement is the native sparse product over the CSR
  rows of the constraint matrices (:func:`pack_csr`, built from the setup
  circuit; ``native.groth16_spmv``), then the NTTs of every distinct
  statement of the batch in one ``h_batch_device`` program on the entry
  point's device, the rows going from the native tier to the device as
  bytes (:func:`_h_many`; the golden :func:`prove` keeps the pure-Python
  sparse products and host NTTs, :func:`_compute_h`, and
  :func:`_abc_from_csr` is the pure-Python sparse product over the CSR);
* statements repeated inside one batch are proved once up to the (r, s)
  blinding; a statement repeated 8 or more times folds its proofs as
  fixed-basis MSMs on the device (:func:`_finish_proof_group`).

:func:`prove_assigned_native` is the whole-pipeline host baseline (the
native h and query MSMs); no entry point calls it. :func:`verify` runs the
native pairing with the key's constant Miller value cached, and
:func:`verify_batch` checks many proofs of one key with one final
exponentiation. The JAX package's cross-batch accumulator memo is not
carried over.
"""

from __future__ import annotations

import os
import struct
import threading
from concurrent.futures import ThreadPoolExecutor
from dataclasses import dataclass
from typing import List, Optional, Tuple

import torch

from .. import native
from ..ops import bn254 as bn
from ..ops import ntt as poly
from ..ops.field import BN254_FR
from ..ops.groth16_device import h_batch_device
from ..utils import tracing
from .r1cs import ConstraintSystem

R = BN254_FR.p
COSET = 5  # Fr multiplicative generator: the coset offset of the h pipeline
GROUP_MIN = 8  # proofs of one statement that take the grouped finish


def _rand_fr() -> int:
    while True:
        v = int.from_bytes(os.urandom(32), "little") % R
        if v != 0:
            return v


# ---------------------------------------------------------------------------
# Fixed-base windowed multiplication (setup)
# ---------------------------------------------------------------------------


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


_g_bases: Optional[Tuple[_FixedBase, _FixedBase]] = None


def _bases() -> Tuple[_FixedBase, _FixedBase]:
    global _g_bases
    if _g_bases is None:
        _g_bases = (
            _FixedBase(bn.g1_from_affine(bn.G1_GEN), bn.g1_add, bn.g1_double, bn.G1_INF),
            _FixedBase(bn.g2_from_affine((bn.G2_GEN_X, bn.G2_GEN_Y)), bn.g2_add, bn.g2_double,
                       bn.G2_INF),
        )
    return _g_bases


# ---------------------------------------------------------------------------
# Keys
# ---------------------------------------------------------------------------


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


# ---------------------------------------------------------------------------
# QAP construction and setup
# ---------------------------------------------------------------------------


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


def setup(cs: ConstraintSystem) -> ProvingKey:
    """Circuit-specific trusted setup (toxic waste sampled from OS RNG)."""
    g1b, g2b = _bases()
    F = BN254_FR
    n = _domain_size(cs)
    alpha, beta, gamma, delta, tau = (_rand_fr() for _ in range(5))
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


# ---------------------------------------------------------------------------
# The h polynomial
# ---------------------------------------------------------------------------


def _h_from_evals(n: int, az: List[int], bz: List[int], cz: List[int]) -> List[int]:
    """Coefficients of h(x) = (A(x)B(x) - C(x)) / Z(x) from the evaluations
    of A, B, C over the size-n domain, via coset evaluation."""
    F = BN254_FR
    a_ev = poly.evaluate_coset(F, poly.interpolate(F, az), n, COSET)
    b_ev = poly.evaluate_coset(F, poly.interpolate(F, bz), n, COSET)
    c_ev = poly.evaluate_coset(F, poly.interpolate(F, cz), n, COSET)
    # Z on the coset is the constant g^n - 1
    z_inv = F.inv((pow(COSET, n, R) - 1) % R)
    h_ev = [(a_ev[i] * b_ev[i] - c_ev[i]) % R * z_inv % R for i in range(n)]
    h_coeffs = poly.interpolate_coset(F, h_ev, COSET)
    assert h_coeffs[-1] == 0, "h degree exceeds n-2: unsatisfied constraint system?"
    return h_coeffs[: n - 1]


def _compute_h(cs: ConstraintSystem, n: int) -> List[int]:
    """h for a full constraint system (the golden prover)."""
    z = cs.full_assignment()
    az = [0] * n
    bz = [0] * n
    cz = [0] * n
    for j, (a, b, c) in enumerate(cs.constraints):
        az[j] = cs.eval_lc(a, z)
        bz[j] = cs.eval_lc(b, z)
        cz[j] = cs.eval_lc(c, z)
    for i in range(cs.num_instance):
        az[len(cs.constraints) + i] = z[i]
    return _h_from_evals(n, az, bz, cz)


def pack_csr(cs: ConstraintSystem):
    """CSR rows ``(ptr, idx, coef)`` of the A, B and C matrices of ``cs``.

    The matrices of a circuit do not depend on its witness, so the CSR of
    the setup circuit serves every statement of that circuit."""
    out = []
    for which in range(3):
        ptr, idx, coef = [0], [], []
        for row in cs.constraints:
            for tag, coeff in row[which].items():
                idx.append(cs._resolve(tag))
                coef.append(coeff)
            ptr.append(len(idx))
        out.append((ptr, idx, coef))
    return tuple(out)


def _spmv(csr, z: List[int], n: int) -> List[int]:
    ptr, idx, coef = csr
    out = [0] * n
    for j in range(len(ptr) - 1):
        acc = 0
        for k in range(ptr[j], ptr[j + 1]):
            acc += coef[k] * z[idx[k]]
        out[j] = acc % R
    return out


_packed: dict = {}  # id(csr) -> (csr, packed rows): keeps csr alive so its id stays its own
_packed_lock = threading.Lock()


def _packed_csr(csr):
    """``csr``'s rows packed for the native tier, once a circuit: per matrix
    (uint32 ptr, uint32 idx, 32-byte little-endian coefficients, nnz), as the
    JAX ``_pack_csr`` packs them."""
    hit = _packed.get(id(csr))
    if hit is not None and hit[0] is csr:
        return hit[1]
    packed = tuple(
        (struct.pack(f"<{len(ptr)}I", *ptr), struct.pack(f"<{len(idx)}I", *idx),
         b"".join(c.to_bytes(32, "little") for c in coef), len(idx))
        for ptr, idx, coef in csr)
    with _packed_lock:
        if len(_packed) >= 16:
            _packed.pop(next(iter(_packed)))
        _packed[id(csr)] = (csr, packed)
    return packed


def _abc_from_csr(n: int, num_instance: int, csr, z: List[int]):
    """A, B, C over the domain for assignment ``z``: the sparse products of
    the circuit's CSR rows in pure Python (:func:`_spmv`), the
    instance-consistency rows adding z[i] to A (the golden of
    ``native.groth16_spmv``)."""
    n_constraints = len(csr[0][0]) - 1
    az = _spmv(csr[0], z, n)
    bz = _spmv(csr[1], z, n)
    cz = _spmv(csr[2], z, n)
    for i in range(num_instance):
        az[n_constraints + i] = z[i]
    return az, bz, cz


def _h_from_csr(n: int, num_instance: int, csr, z: List[int]) -> List[int]:
    """h for assignment ``z`` from the circuit's CSR rows, with the host
    NTTs (the JAX ``_h_unfused``)."""
    return _h_from_evals(n, *_abc_from_csr(n, num_instance, csr, z))


def _h_native(n: int, num_instance: int, csr, z: List[int]) -> List[int]:
    """h for assignment ``z`` in one native call (``native.groth16_h``: the
    sparse products and the seven NTTs; the JAX ``_compute_h_native``)."""
    return native.groth16_h(n, len(csr[0][0]) - 1, num_instance, R, BN254_FR.root_of_unity(n),
                            COSET, _packed_csr(csr), z)


def _h_many(pk: ProvingKey, distinct: List[List[int]], num_instance: int, csr, *,
            device) -> List[List[int]]:
    """h for every distinct assignment of a batch: the native sparse
    products, their rows handed over as bytes, then the seven NTTs of all of
    them in one :func:`~..ops.groth16_device.h_batch_device` program on
    ``device``."""
    with tracing.span("g16.h"):
        n = len(pk.h_query) + 1
        with tracing.span("g16.h.spmv"):
            packed = _packed_csr(csr)
            abc = [native.groth16_spmv(n, len(csr[0][0]) - 1, num_instance, R, packed, z)
                   for z in distinct]
        with tracing.span("g16.h.ntt"):
            return h_batch_device(n, abc, COSET, device=device)


# ---------------------------------------------------------------------------
# Proving
# ---------------------------------------------------------------------------


@dataclass
class Proof:
    a: bn.G1
    b: bn.G2
    c: bn.G1


def _finish_proof(pk: ProvingKey, a_acc, b_g2_acc, b_g1_acc, h_acc, l_acc) -> Proof:
    """Fold the query-MSM accumulators and fresh r/s blinding into (A, B, C)."""
    r = _rand_fr()
    s = _rand_fr()
    a = bn.g1_add(bn.g1_add(pk.vk.alpha_g1, a_acc), bn.g1_msm_fixed([r], [pk.delta_g1]))
    b = bn.g2_add(bn.g2_add(pk.vk.beta_g2, b_g2_acc), bn.g2_msm_fixed([s], [pk.vk.delta_g2]))
    b_g1 = bn.g1_add(bn.g1_add(pk.beta_g1, b_g1_acc), bn.g1_msm_fixed([s], [pk.delta_g1]))
    c = bn.g1_add(h_acc, l_acc)
    c = bn.g1_add(c, bn.g1_scalar_mul(s, a))
    c = bn.g1_add(c, bn.g1_scalar_mul(r, b_g1))
    c = bn.g1_add(c, bn.g1_neg(bn.g1_msm_fixed([r * s % R], [pk.delta_g1])))
    return Proof(a=a, b=b, c=c)


def _prove_accs(pk: ProvingKey, z: List[int], num_instance: int, h: List[int]):
    """The five query-MSM accumulators (a, b_g2, b_g1, h, l) for assignment
    z on the host — a deterministic function of z (all proof randomness
    enters later via (r, s) in :func:`_finish_proof`)."""
    wit = z[num_instance:]
    b_g2_acc = bn.g2_msm_fixed(z, pk.b_g2_query)
    a_acc = bn.g1_msm_fixed(z, pk.a_query)
    b_g1_acc = bn.g1_msm_fixed(z, pk.b_g1_query)
    h_acc = bn.g1_msm_fixed(h, pk.h_query)
    l_acc = bn.g1_msm_fixed(wit, pk.l_query)
    return (a_acc, b_g2_acc, b_g1_acc, h_acc, l_acc)


def prove(pk: ProvingKey, cs: ConstraintSystem) -> Proof:
    """The golden single prover, all on the host."""
    n = len(pk.h_query) + 1
    h = _compute_h(cs, n)
    return _finish_proof(pk, *_prove_accs(pk, cs.full_assignment(), cs.num_instance, h))


def _accs_many(pk: ProvingKey, z_list: List[List[int]], num_instance: int, h_list, *, device):
    """The five query MSMs of a batch on ``device``: each proving-key table
    is walked once for the whole batch. Returns one (a, b_g2, b_g1, h, l)
    tuple per z."""
    with tracing.span("g16.msm"):
        b_g2_accs = bn.g2_msm_fixed_many(z_list, pk.b_g2_query, device=device)
        a_accs = bn.g1_msm_fixed_many(z_list, pk.a_query, device=device)
        b_g1_accs = bn.g1_msm_fixed_many(z_list, pk.b_g1_query, device=device)
        h_accs = bn.g1_msm_fixed_many(h_list, pk.h_query, device=device)
        l_accs = bn.g1_msm_fixed_many([z[num_instance:] for z in z_list], pk.l_query,
                                      device=device)
        return list(zip(a_accs, b_g2_accs, b_g1_accs, h_accs, l_accs))


def prove_assigned_many(
    pk: ProvingKey, z_list: List[List[int]], num_instance: int, csr, *, device
) -> List[Proof]:
    """Batched proving of one circuit from assignment vectors.

    Duplicate statements (identical assignment vectors) are deduplicated:
    the query-MSM accumulators and the h polynomial are deterministic
    functions of z, so they are computed once per distinct z; every proof
    still draws fresh (r, s) blinding and is indistinguishable from an
    unbatched one. Proofs draw r then s in the order of the statements'
    first occurrence, a group of :data:`GROUP_MIN` or more in one
    :func:`_finish_proof_group`.
    """
    if not z_list:
        return []
    distinct, assign = _distinct(z_list)
    h_list = _h_many(pk, distinct, num_instance, csr, device=device)
    accs = _accs_many(pk, distinct, num_instance, h_list, device=device)

    out: List[Optional[Proof]] = [None] * len(assign)
    with tracing.span("g16.finish"):
        for slot, idxs in _by_slot(assign).items():
            if len(idxs) >= GROUP_MIN:
                group = _finish_proof_group(pk, accs[slot], len(idxs), device=device)
                for i, pr in zip(idxs, group):
                    out[i] = pr
            else:
                for i in idxs:
                    out[i] = _finish_proof(pk, *accs[slot])
    return out  # type: ignore[return-value]


def _distinct(z_list: List[List[int]]):
    """The distinct assignments of a batch in order of first occurrence, and
    each proof's index among them."""
    slot_of: dict = {}
    distinct: List[List[int]] = []
    assign: List[int] = []
    for z in z_list:
        zk = tuple(z)
        slot = slot_of.get(zk)
        if slot is None:
            slot = slot_of[zk] = len(distinct)
            distinct.append(z)
        assign.append(slot)
    return distinct, assign


def prove_assigned_native(pk: ProvingKey, z_list: List[List[int]], num_instance: int,
                          csr, *, h_workers: Optional[int] = None) -> List[Proof]:
    """The whole-pipeline host baseline of :func:`prove_assigned_many`: for
    each distinct statement the native h (``native.groth16_h``, the
    statements spread over a thread pool as the JAX ``_h_many`` spreads
    them), then the five query MSMs in one native call
    (``native.groth16_prove_msms``, on the thread budget's team), then
    :func:`_finish_proof` per proof. Proofs draw r then s in the order
    :func:`prove_assigned_many` draws them, so under the same draws both
    give the same bytes. ``h_workers`` sizes the pool of the native h calls
    (default: the thread budget, ``torch.get_num_threads()``; of 1, 2, 4
    and 8 workers on an 8-core host, 8 proved membership fastest and
    equality within 0.5 % of the fastest, PERF.md §5). No entry point calls
    it."""
    if not z_list:
        return []
    distinct, assign = _distinct(z_list)
    n = len(pk.h_query) + 1
    workers = min(len(distinct), h_workers or torch.get_num_threads())
    h_of = lambda z: _h_native(n, num_instance, csr, z)  # noqa: E731
    if workers > 1:
        with ThreadPoolExecutor(workers) as pool:
            h_list = list(pool.map(h_of, distinct))
    else:
        h_list = [h_of(z) for z in distinct]
    tier = bn.native_tier()
    handles = [tier.g1_fixed_handle(tuple(q), q)
               for q in (pk.a_query, pk.b_g1_query, pk.h_query, pk.l_query)]
    handles.append(tier.g2_fixed_handle(tuple(pk.b_g2_query), pk.b_g2_query))
    accs = []
    for z, h in zip(distinct, h_list):
        a_acc, b_g1_acc, h_acc, l_acc, b_g2_acc = tier.groth16_prove_msms(*handles, z, h,
                                                                          num_instance)
        accs.append((a_acc, b_g2_acc, b_g1_acc, h_acc, l_acc))
    out: List[Optional[Proof]] = [None] * len(assign)
    for slot, idxs in _by_slot(assign).items():
        for i in idxs:
            out[i] = _finish_proof(pk, *accs[slot])
    return out  # type: ignore[return-value]


def _by_slot(assign: List[int]) -> dict:
    """Each distinct statement's proof indices, statements in order of first
    occurrence."""
    by_slot: dict = {}
    for i, slot in enumerate(assign):
        by_slot.setdefault(slot, []).append(i)
    return by_slot


def _finish_proof_group(pk: ProvingKey, acc, count: int, *, device) -> List[Proof]:
    """Batched :func:`_finish_proof` for ``count`` proofs of ONE statement.

    With P1 = alpha + a_acc, P2 = beta_g1 + b_g1_acc, B2 = beta_g2 + b_g2_acc
    and HL = h_acc + l_acc, and fresh (r, s) per proof:

        A = P1 + r*delta_g1
        B = B2 + s*delta_g2
        C = HL + s*P1 + r*P2 + (r*s)*delta_g1

    so every per-proof term is a fixed-basis MSM over [delta_g1] (K = 1),
    [delta_g2] (K = 1) or [P1, P2, delta_g1] (K = 3), one device batch each
    across the group. The first two bases are the key's and their tables are
    cached; [P1, P2, delta_g1] belongs to this statement, so its table is
    built for this group only.
    """
    a_acc, b_g2_acc, b_g1_acc, h_acc, l_acc = acc
    P1 = bn.g1_add(pk.vk.alpha_g1, a_acc)
    P2 = bn.g1_add(pk.beta_g1, b_g1_acc)
    B2 = bn.g2_add(pk.vk.beta_g2, b_g2_acc)
    HL = bn.g1_add(h_acc, l_acc)
    rs = [(_rand_fr(), _rand_fr()) for _ in range(count)]
    r_delta = bn.g1_msm_fixed_many([[r] for r, _ in rs], [pk.delta_g1], device=device)
    s_delta2 = bn.g2_msm_fixed_many([[s] for _, s in rs], [pk.vk.delta_g2], device=device)
    c_terms = bn.g1_msm_fixed_many(
        [[s, r, r * s % R] for r, s in rs], [P1, P2, pk.delta_g1], device=device, cache=False
    )
    return [
        Proof(a=bn.g1_add(P1, r_delta[i]), b=bn.g2_add(B2, s_delta2[i]),
              c=bn.g1_add(HL, c_terms[i]))
        for i in range(count)
    ]


# ---------------------------------------------------------------------------
# Verification
# ---------------------------------------------------------------------------


def _verify_pairs(vk: VerifyingKey, public_inputs: List[int], proof: Proof, scalar_mul):
    """The pairs (A, B), (-IC, gamma), (-C, delta) of one proof's check, or
    None when the proof or its inputs are malformed."""
    if len(public_inputs) != len(vk.gamma_abc_g1) - 1:
        return None
    if not (bn.g1_is_on_curve(proof.a) and bn.g1_is_on_curve(proof.c)):
        return None
    if not bn.g2_is_on_curve(proof.b) or not bn.g2_in_subgroup(proof.b):
        return None
    ic = vk.gamma_abc_g1[0]
    for x, base in zip(public_inputs, vk.gamma_abc_g1[1:]):
        ic = bn.g1_add(ic, scalar_mul(x % R, base))
    return [(proof.a, proof.b), (bn.g1_neg(ic), vk.gamma_g2), (bn.g1_neg(proof.c), vk.delta_g2)]


_vk_miller: dict = {}  # id(vk) -> (Miller value bytes, vk): keeps vk alive so its id stays its own
_vk_miller_lock = threading.Lock()


def _vk_miller_bytes(vk: VerifyingKey) -> bytes:
    """The Miller value of (-alpha, beta), constant per verifying key."""
    hit = _vk_miller.get(id(vk))
    if hit is not None and hit[1] is vk:
        return hit[0]
    f = bn.native_tier().bn254_miller_bytes(bn.g1_neg(vk.alpha_g1), vk.beta_g2)
    with _vk_miller_lock:
        if len(_vk_miller) >= 64:
            _vk_miller.pop(next(iter(_vk_miller)))
        _vk_miller[id(vk)] = (f, vk)
    return f


def verify(vk: VerifyingKey, public_inputs: List[int], proof: Proof) -> bool:
    """e(A,B) == e(alpha,beta) e(ic,gamma) e(C,delta) on the native tier,
    the (-alpha, beta) Miller value cached per key; returns False on error."""
    try:
        pairs = _verify_pairs(vk, public_inputs, proof, bn.g1_scalar_mul)
        if pairs is None:
            return False
        f_pre = _vk_miller_bytes(vk)
        return bn.native_tier().bn254_multi_pairing_premul(f_pre, pairs) == bn.FQ12_ONE
    except Exception:
        return False


def verify_py(vk: VerifyingKey, public_inputs: List[int], proof: Proof) -> bool:
    """:func:`verify` in pure Python (the golden)."""
    try:
        pairs = _verify_pairs(vk, public_inputs, proof, bn.g1_scalar_mul_py)
        if pairs is None:
            return False
        pairs.append((bn.g1_neg(vk.alpha_g1), vk.beta_g2))
        return bn.multi_pairing_py(pairs) == bn.FQ12_ONE
    except Exception:
        return False


def verify_batch(vk: VerifyingKey, items: List[Tuple[List[int], Proof]]) -> List[bool]:
    """Verdicts of :func:`verify` for ``(public_inputs, proof)`` items of one
    key, by a random linear combination of their pairing checks: with
    128-bit weights w_i (:func:`_rlc_weight`) the check

        prod_i e(w_i A_i, B_i) * e(-sum_i w_i IC_i, gamma)
             * e(-sum_i w_i C_i, delta) * e(-(sum_i w_i) alpha, beta) == 1

    is one multi-pairing over N + 3 pairs with one final exponentiation, the
    IC sum one MSM over gamma_abc (Pippenger: it registers no table, so a
    full fixed-basis registry leaves the verdicts alone). On failure the set is halved
    until each bad proof stands alone, so a few bad proofs still get exact
    verdicts."""
    results = [False] * len(items)
    n_pub = len(vk.gamma_abc_g1) - 1
    live: List[int] = []
    for i, (public_inputs, proof) in enumerate(items):
        try:
            if (len(public_inputs) == n_pub and bn.g1_is_on_curve(proof.a)
                    and bn.g1_is_on_curve(proof.c) and bn.g2_is_on_curve(proof.b)
                    and bn.g2_in_subgroup(proof.b)):
                live.append(i)
        except Exception:
            continue
    neg_alpha = bn.g1_neg(vk.alpha_g1)

    def check(idxs: List[int]) -> None:
        try:
            weights = [_rlc_weight() for _ in idxs]
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
            ok = bn.multi_pairing(pairs) == bn.FQ12_ONE
        except Exception:
            ok = False
        if ok:
            for i in idxs:
                results[i] = True
        elif len(idxs) > 1:
            check(idxs[: len(idxs) // 2])
            check(idxs[len(idxs) // 2 :])

    if live:
        check(live)
    return results


def _rlc_weight() -> int:
    """A nonzero 128-bit random weight of :func:`verify_batch`."""
    w = 0
    while w == 0:
        w = int.from_bytes(os.urandom(16), "little")
    return w


# ---------------------------------------------------------------------------
# Serialization: arkworks `serialize_uncompressed` layout. G1 = x||y 64B
# little-endian canonical; G2 = x.c0||x.c1||y.c0||y.c1 128B; ark-serialize
# SWFlags ride the top two bits of the final byte of y (resp. y.c1):
# bit 6 = point at infinity (coordinates zero), bit 7 = y-is-negative
# (y > -y; informational — arkworks' uncompressed deserializer derives y
# from the bytes and only consumes the infinity bit, so readers MUST mask
# both). BN254's 254-bit modulus leaves those two bits free.
# ---------------------------------------------------------------------------

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
# Round-1 files used a framework-private `LZTK` container (magic, u32
# version, the fields with u32 counts and b_g2_query last); the readers try
# it first and fall through to the raw form, as the JAX package's do.

_KEY_MAGIC = b"LZTK"
_KEY_VERSION = 1


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
    if data[:4] == _KEY_MAGIC:
        # A raw arkworks key whose alpha_g1.x begins with these 4 bytes
        # (~2^-32) must still load: fall through on LZTK parse failure.
        pk = _pk_from_lztk(data)
        if pk is not None:
            return pk
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
    if data[:4] == _KEY_MAGIC:
        vk = _vk_from_lztk(data)
        if vk is not None:
            return vk
    try:
        r = _Reader(data)
        vk = _vk_read(r)
        return vk if r.done() else None
    except Exception:
        return None


# -- round-1 `LZTK` container readers -----------------------------------------


def _pk_from_lztk(data: bytes) -> Optional[ProvingKey]:
    try:
        if struct.unpack("<I", data[4:8])[0] != _KEY_VERSION:
            return None
        r = _Reader(data)
        r.pos = 8
        alpha_g1 = r.g1()
        beta_g2 = r.g2()
        gamma_g2 = r.g2()
        delta_g2 = r.g2()
        gamma_abc = [r.g1() for _ in range(r.vec_len(4))]
        beta_g1 = r.g1()
        delta_g1 = r.g1()
        a_query = [r.g1() for _ in range(r.vec_len(4))]
        b_g1_query = [r.g1() for _ in range(r.vec_len(4))]
        h_query = [r.g1() for _ in range(r.vec_len(4))]
        l_query = [r.g1() for _ in range(r.vec_len(4))]
        b_g2_query = [r.g2() for _ in range(r.vec_len(4))]
        if not r.done():
            return None
        vk = VerifyingKey(alpha_g1, beta_g2, gamma_g2, delta_g2, gamma_abc)
        return ProvingKey(
            vk, beta_g1, delta_g1, a_query, b_g1_query, b_g2_query, h_query, l_query
        )
    except Exception:
        return None


def _vk_from_lztk(data: bytes) -> Optional[VerifyingKey]:
    try:
        if struct.unpack("<I", data[4:8])[0] != _KEY_VERSION:
            return None
        r = _Reader(data)
        r.pos = 8
        alpha_g1 = r.g1()
        beta_g2 = r.g2()
        gamma_g2 = r.g2()
        delta_g2 = r.g2()
        abc = [r.g1() for _ in range(r.vec_len(4))]
        if not r.done():
            return None
        return VerifyingKey(alpha_g1, beta_g2, gamma_g2, delta_g2, abc)
    except Exception:
        return None
