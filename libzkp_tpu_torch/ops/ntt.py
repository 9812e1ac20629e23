"""Radix-2 NTT over a prime field on Python ints (the host golden tier).

Copy of the host functions of the JAX package's ``libzkp_tpu/ops/ntt.py``
(without its native hook): the in-order iterative NTT over the size-n
root-of-unity domain, interpolation, and coset evaluation / interpolation for
the Groth16 h polynomial. The device NTT is not ported yet.
"""

from __future__ import annotations

from typing import List

from .field import PrimeField


def _bit_reverse_permute(a: List[int]) -> List[int]:
    n = len(a)
    bits = n.bit_length() - 1
    out = list(a)
    for i in range(n):
        j = int(bin(i)[2:].zfill(bits)[::-1], 2)
        if j > i:
            out[i], out[j] = out[j], out[i]
    return out


def ntt(F: PrimeField, values: List[int], invert: bool = False) -> List[int]:
    """In-order iterative radix-2 NTT over the size-n root-of-unity domain."""
    n = len(values)
    assert n & (n - 1) == 0, "size must be a power of two"
    p = F.p
    a = _bit_reverse_permute([v % p for v in values])
    root = F.root_of_unity(n)
    if invert:
        root = F.inv(root)
    length = 2
    while length <= n:
        w_len = pow(root, n // length, p)
        for start in range(0, n, length):
            w = 1
            half = length // 2
            for k in range(start, start + half):
                u = a[k]
                v = a[k + half] * w % p
                a[k] = (u + v) % p
                a[k + half] = (u - v) % p
                w = w * w_len % p
        length *= 2
    if invert:
        n_inv = F.inv(n)
        a = [x * n_inv % p for x in a]
    return a


def interpolate(F: PrimeField, evals: List[int]) -> List[int]:
    """Coefficients of the poly whose evaluations over the size-n domain are ``evals``."""
    return ntt(F, evals, invert=True)


def evaluate(F: PrimeField, coeffs: List[int], domain_size: int) -> List[int]:
    """Evaluate over the root-of-unity domain of ``domain_size`` (>= len(coeffs))."""
    padded = list(coeffs) + [0] * (domain_size - len(coeffs))
    return ntt(F, padded)


def evaluate_coset(F: PrimeField, coeffs: List[int], domain_size: int, offset: int) -> List[int]:
    """Evaluate over the coset ``offset * <g_n>``."""
    p = F.p
    shifted = []
    power = 1
    for c in coeffs:
        shifted.append(c * power % p)
        power = power * offset % p
    return evaluate(F, shifted, domain_size)


def interpolate_coset(F: PrimeField, evals: List[int], offset: int) -> List[int]:
    """Inverse of :func:`evaluate_coset` on a full coset evaluation vector."""
    p = F.p
    coeffs = ntt(F, evals, invert=True)
    inv_off = F.inv(offset)
    out = []
    power = 1
    for c in coeffs:
        out.append(c * power % p)
        power = power * inv_off % p
    return out
