"""Device tier of the Groth16 QAP h polynomial.

Port of the JAX package's ``libzkp_tpu/ops/groth16_device.py``. After the
sparse products (az, bz, cz over the domain, on the host), h is seven radix-2
NTTs over BN254 Fr per proof: interpolate az, bz, cz, evaluate each on the
coset g * <w>, take (az * bz - cz) / Z there, interpolate back off the coset.
This module runs them for a whole batch of proofs at once
(:func:`~.ntt.ntt_device` batched over proofs x 3 vectors, which arrive as
the native sparse products' bytes) on the caller's device: on the
``mont_mul`` kernel on a CUDA device, on its plain version on the CPU. The
limbs equal the JAX ``_h_jitted``'s.
"""

from __future__ import annotations

import functools
from typing import List, Sequence

import torch

from ..device import resolve
from .field import BN254_FR
from .limb import LimbContext, get_context, ints_to_limb_rows
from .ntt import ntt_device


@functools.lru_cache(maxsize=8)
def _h_tables(n: int, coset_g: int):
    """Host Montgomery tables: g^i and g^-i for i < n, (n, limbs), and
    (g^n - 1)^-1, (limbs,)."""
    p = BN254_FR.p
    ctx = get_context(p, "bn254_fr")
    g_inv = pow(coset_g, -1, p)
    pows, ipows = [], []
    cur, curi = 1, 1
    for _ in range(n):
        pows.append(cur * ctx.R % p)
        ipows.append(curi * ctx.R % p)
        cur = cur * coset_g % p
        curi = curi * g_inv % p
    zinv = pow((pow(coset_g, n, p) - 1) % p, -1, p)
    return (ints_to_limb_rows(pows, ctx.n), ints_to_limb_rows(ipows, ctx.n),
            ints_to_limb_rows([zinv * ctx.R % p], ctx.n)[0])


@functools.lru_cache(maxsize=8)
def _device_h_tables(n: int, coset_g: int, device: torch.device):
    return tuple(torch.from_numpy(t).to(device) for t in _h_tables(n, coset_g))


def h_body(ctx: LimbContext, abc: torch.Tensor, g_pows: torch.Tensor, gi_pows: torch.Tensor,
           zinv: torch.Tensor) -> torch.Tensor:
    """The JAX ``_h_jitted`` program: ``abc`` (3B, n, limbs) canonical limbs,
    az of the B proofs, then bz, then cz -> (B, n, limbs) canonical limbs of
    the h coefficients. 43 products at n = 512 (13 per inverse NTT, 11 for
    the forward one, to_mont, the two coset shifts, two pointwise products
    and from_mont)."""
    xm = ctx.to_mont(abc)
    coeffs = ntt_device(ctx, xm, invert=True)           # interpolate
    shifted = ctx.mont_mul(coeffs, g_pows)
    on_coset = ntt_device(ctx, shifted, invert=False)   # coset evaluations
    b3 = on_coset.shape[0] // 3
    az, bz, cz = on_coset[:b3], on_coset[b3 : 2 * b3], on_coset[2 * b3 :]
    h_ev = ctx.mont_mul(ctx.sub(ctx.mont_mul(az, bz), cz), zinv)
    h = ntt_device(ctx, h_ev, invert=True)              # interpolate off the coset
    h = ctx.mont_mul(h, gi_pows)
    return ctx.from_mont(h)


def h_batch_device(n: int, abc: Sequence, coset_g: int = 5, *, device=None) -> List[List[int]]:
    """h coefficient vectors for a batch of proofs, one device program.

    ``abc`` holds each proof's (az, bz, cz) over the size-n domain, each as
    ``n`` canonical 32-byte little-endian values (the native sparse
    products' rows, ``native.groth16_spmv``), which go to the limbs with no
    Python ints between; returns each proof's ``h[: n-1]``, as the host
    ``_h_from_evals``. Raises AssertionError when an h has degree above
    n - 2 (an unsatisfied constraint system, the host tier's check).
    ``device`` defaults to the CUDA card; ``device="cpu"`` runs the plain
    versions."""
    dev = resolve(device)
    ctx = get_context(BN254_FR.p, "bn254_fr")
    B = len(abc)
    buf = b"".join(rows[k] for k in range(3) for rows in abc)
    x = ctx.encode_bytes(buf, device=dev).reshape(3 * B, n, ctx.n)
    out = h_body(ctx, x, *_device_h_tables(n, coset_g, dev))
    ints = ctx.decode(out)
    res = []
    for j in range(B):
        h = ints[j * n : (j + 1) * n]
        assert h[n - 1] == 0, "h degree exceeds n-2: unsatisfied constraints?"
        res.append(h[: n - 1])
    return res
