"""Radix-2 NTT over a prime field: the host golden tier and the batched
device tier.

Port of the JAX package's ``libzkp_tpu/ops/ntt.py``:

* Host tier on Python ints: the in-order iterative NTT over the size-n
  root-of-unity domain (:func:`ntt_py`, the golden; :func:`ntt` runs it on
  the native tier, as the reference's hook does), interpolation, coset
  evaluation and interpolation, Horner evaluation.
* Device tier (:func:`ntt_device`): many transforms at once on Montgomery
  limb tensors (:mod:`.limb`), the butterfly stages eager torch around the
  ``mont_mul`` kernel, with the JAX schedule of reduces, so the limbs equal
  the JAX ``ntt_batch``'s; and :func:`coset_lde_batch`, a batch of traces'
  interpolation and coset low-degree extension on it. The four-step NTT
  sharded over a mesh (``ntt_sharded``) and ``coset_lde_batch``'s split of
  the batch over a mesh's dp axis are not ported yet.
"""

from __future__ import annotations

import functools
from typing import List

import numpy as np
import torch

from .. import native
from ..device import resolve
from .field import PrimeField
from .limb import LimbContext, get_context, ints_to_limb_rows


def _bit_reverse_permute(a: List[int]) -> List[int]:
    n = len(a)
    bits = n.bit_length() - 1
    out = list(a)
    for i in range(n):
        j = int(bin(i)[2:].zfill(bits)[::-1], 2)
        if j > i:
            out[i], out[j] = out[j], out[i]
    return out


def ntt_py(F: PrimeField, values: List[int], invert: bool = False) -> List[int]:
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


def ntt(F: PrimeField, values: List[int], invert: bool = False) -> List[int]:
    """:func:`ntt_py` on the native tier (``zkp_ntt``)."""
    n = len(values)
    assert n & (n - 1) == 0, "size must be a power of two"
    if n == 1:
        return [values[0] % F.p]
    root = F.root_of_unity(n)
    if invert:
        return native.ntt(F.p, values, F.inv(root), F.inv(n))
    return native.ntt(F.p, values, root, None)


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


def poly_eval(F: PrimeField, coeffs: List[int], x: int) -> int:
    """Horner evaluation at a single point."""
    acc = 0
    for c in reversed(coeffs):
        acc = (acc * x + c) % F.p
    return acc


def poly_degree(coeffs: List[int]) -> int:
    for i in range(len(coeffs) - 1, -1, -1):
        if coeffs[i] != 0:
            return i
    return 0


# ---------------------------------------------------------------------------
# Device tier: batched NTT over Montgomery limb tensors
# ---------------------------------------------------------------------------


@functools.lru_cache(maxsize=None)
def _twiddle_table(p: int, n: int, invert: bool) -> np.ndarray:
    """Per-stage Montgomery twiddles, shape (log n, n//2, limbs), host
    numpy: stage s holds w_len^k for k < half, tiled across the
    butterflies."""
    F = PrimeField(p, "tw")
    ctx = get_context(p, "tw")
    root = F.root_of_unity(n)
    if invert:
        root = F.inv(root)
    vals = []
    length = 2
    while length <= n:
        w_len = pow(root, n // length, p)
        ws = []
        w = 1
        for _ in range(length // 2):
            ws.append(w * ctx.R % p)
            w = w * w_len % p
        vals += ws * (n // length)
        length *= 2
    return ints_to_limb_rows(vals, ctx.n).reshape(-1, n // 2, ctx.n)


def _bitrev_indices(n: int) -> np.ndarray:
    bits = n.bit_length() - 1
    idx = np.arange(n)
    rev = np.zeros(n, dtype=np.int32)
    for b in range(bits):
        rev |= ((idx >> b) & 1) << (bits - 1 - b)
    return rev


@functools.lru_cache(maxsize=None)
def _device_tables(p: int, n: int, invert: bool, device: torch.device):
    """The twiddles and the bit-reversal permutation on ``device``."""
    return (torch.from_numpy(_twiddle_table(p, n, invert)).to(device),
            torch.from_numpy(_bitrev_indices(n).astype(np.int64)).to(device))


def ntt_device(ctx: LimbContext, values_mont: torch.Tensor, invert: bool = False) -> torch.Tensor:
    """Batched NTT on Montgomery-domain limb tensors.

    ``values_mont``: (..., n_points, n_limbs); every leading axis is batch.
    Each stage is one ``mont_mul`` of the odd halves by the stage's twiddles
    and an add and a sub (one carry pass each); the values are reduced after
    stage s when s % 4 == 3 and s is not the last, which keeps the butterfly
    values inside the limbs' headroom (the JAX schedule: changing it changes
    the limbs)."""
    n = values_mont.shape[-2]
    tw, rev = _device_tables(ctx.p, n, invert, values_mont.device)
    a = values_mont.index_select(-2, rev)
    log_n = n.bit_length() - 1
    for s in range(log_n):
        length = 2 << s
        half = length >> 1
        blk = a.reshape(a.shape[:-2] + (n // length, length, ctx.n))
        u = blk[..., :half, :]
        v = ctx.mont_mul(blk[..., half:, :], tw[s].reshape(n // length, half, ctx.n))
        a = torch.cat([ctx.add(u, v), ctx.sub(u, v)], dim=-2).reshape(values_mont.shape)
        if s % 4 == 3 and s != log_n - 1:
            a = ctx.reduce(a)
    if invert:
        n_inv = pow(n, -1, ctx.p)
        a = ctx.mont_mul(a, ctx.to_mont(ctx.encode_scalar(n_inv, device=a.device)))
    return a


def ntt_batch(ctx: LimbContext, values_mont: torch.Tensor, invert: bool = False) -> torch.Tensor:
    """The JAX package's jitted entry; eager here, so :func:`ntt_device`."""
    return ntt_device(ctx, values_mont, invert)


@functools.lru_cache(maxsize=None)
def _offset_powers(p: int, n: int, offset: int, device: torch.device) -> torch.Tensor:
    """offset^i * R mod p for i < n: the coset shift, (n, limbs) Montgomery
    limbs on ``device``."""
    ctx = get_context(p)
    return torch.from_numpy(ints_to_limb_rows([pow(offset, i, p) * ctx.R % p for i in range(n)],
                                              ctx.n)).to(device)


def coset_lde_device(ctx: LimbContext, x: torch.Tensor, blowup: int, offset: int) -> tuple:
    """Interpolate a batch of size-n traces and evaluate each over the coset
    ``offset * <g_N>`` of size N = n * blowup: ``x`` (B, n, limbs) canonical
    limbs -> (coefficients, LDE), (B, n, limbs) and (B, N, limbs) relaxed,
    out of the Montgomery domain. The inverse NTT, the shift by the offset's
    powers, the zero pad and the forward NTT, all on ``x``'s device."""
    n = x.shape[-2]
    coeffs_m = ntt_device(ctx, ctx.to_mont(x), invert=True)
    shifted = ctx.mont_mul(coeffs_m, _offset_powers(ctx.p, n, offset, x.device))
    padded = torch.nn.functional.pad(shifted, (0, 0, 0, n * (blowup - 1)))
    lde_m = ntt_device(ctx, padded, invert=False)
    return ctx.from_mont(coeffs_m), ctx.from_mont(lde_m)


def coset_lde_batch(p: int, traces, blowup: int, offset: int, *, device=None) -> tuple:
    """A batch of size-n traces -> ([coefficient lists], [LDE lists]) as
    canonical ints, one upload and one download: :func:`coset_lde_device` on
    ``device`` (default the CUDA card; ``"cpu"`` runs the plain versions).
    The batch is not padded (no compile step to serve)."""
    device = resolve(device)
    ctx = get_context(p)
    B, n = len(traces), len(traces[0])
    x = ctx.encode([v for t in traces for v in t], device=device).reshape(B, n, ctx.n)
    coeffs, lde = coset_lde_device(ctx, x, blowup, offset)
    ints = ctx.decode(torch.cat([coeffs, lde], dim=1))
    N = n * blowup
    step = n + N
    return ([ints[b * step : b * step + n] for b in range(B)],
            [ints[b * step + n : (b + 1) * step] for b in range(B)])
