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
  the JAX ``ntt_batch``'s; :func:`coset_lde_batch`, a batch of traces'
  interpolation and coset low-degree extension on it, split over a mesh's
  dp rows; and :func:`ntt_sharded`, one transform split over a mesh's
  ``shard`` axis by the four-step decomposition.

The JAX package's gate in front of the sharded NTT (``maybe_ntt_sharded``:
an environment size threshold, and a catch-all that falls back to the local
tier) is not ported: :func:`ntt` stays local, as the JAX package's does by
default, and :func:`ntt_sharded` is called by name.
"""

from __future__ import annotations

import functools
from typing import List

import numpy as np
import torch

from .. import native
from ..device import resolve
from ..parallel import collective
from ..parallel import mesh as meshmod
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


def coset_lde_batch(p: int, traces, blowup: int, offset: int, *, device=None, mesh=None) -> tuple:
    """A batch of size-n traces -> ([coefficient lists], [LDE lists]) as
    canonical ints, one upload and one download: :func:`coset_lde_device` on
    ``device`` (default the CUDA card; ``"cpu"`` runs the plain versions).

    ``mesh`` defaults to the one the MSM seam would take
    (``parallel.mesh.mesh_for``). On a mesh whose dp is above 1 the traces
    are cut into dp contiguous blocks (:func:`.parallel.mesh.dp_sharding`),
    block d runs on the first device of dp row d, and the results come back
    to ``device``; the values are the one-device route's. The batch is not
    padded (no compile step to serve), so a batch smaller than dp takes as
    many blocks as it has traces."""
    device = resolve(device)
    if mesh is None:
        mesh = meshmod.mesh_for(device)
    elif mesh.device_type != device.type:
        raise ValueError(f"the mesh is on {mesh.device_type}, the entry device is {device}")
    ctx = get_context(p)
    B, n = len(traces), len(traces[0])
    x = ctx.encode([v for t in traces for v in t], device=device).reshape(B, n, ctx.n)
    if mesh is None or meshmod.num_dp(mesh) == 1:
        coeffs, lde = coset_lde_device(ctx, x, blowup, offset)
    else:
        blocks = [coset_lde_device(ctx, row[0], blowup, offset)
                  for row in meshmod.dp_sharding(mesh).put(x) if row[0].shape[0]]
        coeffs = torch.cat([c.to(device) for c, _ in blocks])
        lde = torch.cat([e.to(device) for _, e in blocks])
    ints = ctx.decode(torch.cat([coeffs, lde], dim=1))
    N = n * blowup
    step = n + N
    return ([ints[b * step : b * step + n] for b in range(B)],
            [ints[b * step + n : (b + 1) * step] for b in range(B)])


# ---------------------------------------------------------------------------
# One transform split over a mesh's shard axis: the four-step (Bailey)
# decomposition N = N1 * N2. Size-N1 column transforms on each position,
# a twiddle product, one all_to_all over ``shard``, size-N2 row transforms.
# ---------------------------------------------------------------------------


@functools.lru_cache(maxsize=8)
def _four_step_twiddles(p: int, n1: int, n2: int, invert: bool) -> np.ndarray:
    """(N2, N1, limbs) table of w^(j2 * k1) (w the N1*N2-th root of unity,
    inverted for the inverse) in Montgomery limb form, host numpy."""
    F = PrimeField(p, "tw4")
    ctx = get_context(p)
    w = F.root_of_unity(n1 * n2)
    if invert:
        w = F.inv(w)
    vals = []
    for j2 in range(n2):
        wj = pow(w, j2, p)
        cur = ctx.R % p
        for _ in range(n1):
            vals.append(cur)
            cur = cur * wj % p
    return ints_to_limb_rows(vals, ctx.n).reshape(n2, n1, ctx.n)


@functools.lru_cache(maxsize=8)
def _four_step_tensor(p: int, n1: int, n2: int, invert: bool, device: torch.device) -> torch.Tensor:
    """:func:`_four_step_twiddles` on ``device``."""
    return torch.from_numpy(_four_step_twiddles(p, n1, n2, invert)).to(device)


def four_step_shape(n: int, shard: int) -> tuple:
    """(N1, N2) of a size-``n`` transform over ``shard`` positions: N1 =
    2^(log n // 2), raised to ``shard`` when either factor does not divide
    by it. Raises ``AssertionError`` (the JAX package's assert, explicit so
    ``-O`` keeps it) when n is no power of two or below ``shard``^2."""
    if n < 1 or n & (n - 1):
        raise AssertionError("N must be a power of two")
    n1 = 1 << ((n.bit_length() - 1) // 2)
    n2 = n // n1
    if n1 % shard or n2 % shard:
        n1 = max(n1, shard)
        n2 = n // n1
    if n1 % shard or n2 % shard:
        raise AssertionError("N too small for this mesh")
    return n1, n2


def ntt_sharded_device(ctx: LimbContext, x: torch.Tensor, mesh, invert: bool = False) -> torch.Tensor:
    """The four-step NTT of canonical limbs ``x`` (N, limbs) over the
    ``shard`` positions of the mesh's first dp row -> (N, limbs) relaxed
    limbs out of the Montgomery domain, in natural order, on ``x``'s device.

    A[j2][j1] = x[j1 * N2 + j2] is split by rows over ``shard``; each
    position runs its N2/shard size-N1 transforms (:func:`ntt_device`), the
    product by its twiddle rows, then one ``all_to_all`` makes each position
    hold N1/shard complete rows of N2 for the size-N2 transforms; X[N1 * k2
    + k1] is row k1's entry k2. Every product is the ``mont_mul`` kernel on
    a card. The JAX package's ``shard_map`` replicates the transform over
    ``dp`` and takes one row's result; here one row runs it."""
    N = x.shape[0]
    row_mesh = meshmod.Mesh((mesh.devices[0],))
    n1, n2 = four_step_shape(N, len(row_mesh.devices[0]))
    a = x.reshape(n1, n2, ctx.n).transpose(0, 1)
    tw = _four_step_tensor(ctx.p, n1, n2, invert, row_mesh.devices[0][0])
    cols = meshmod.Sharding(row_mesh, "shard")
    b = tuple(ctx.mont_mul(ntt_device(ctx, ctx.to_mont(xl), invert=invert), twl)
              for xl, twl in zip(cols.put(a)[0], cols.put(tw)[0]))
    c = collective.all_to_all((b,), "shard", split_axis=1, concat_axis=0, mesh=row_mesh)[0]
    out = [ctx.from_mont(ntt_device(ctx, ci.transpose(0, 1), invert=invert)) for ci in c]
    return torch.cat([o.to(x.device) for o in out]).transpose(0, 1).reshape(N, ctx.n)


def ntt_sharded(p: int, values, mesh, invert: bool = False) -> List[int]:
    """One size-N NTT split over the mesh's ``shard`` axis; returns the
    values as ints, equal to :func:`ntt_py`'s. Needs N = N1 * N2 with both
    factors divisible by the shard count, so N >= shard^2
    (:func:`four_step_shape`). Runs on the mesh's devices (the CPU's plain
    versions for a mesh of ``cpu`` positions)."""
    ctx = get_context(p)
    dev = mesh.devices[0][0]
    x = ctx.encode(list(values), device=dev)
    return ctx.decode(ntt_sharded_device(ctx, x, mesh, invert=invert))
