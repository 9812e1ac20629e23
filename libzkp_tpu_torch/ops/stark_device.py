"""The STARK batch program on the device: coset LDE and leaf commit.

Port of the JAX package's ``libzkp_tpu/ops/stark_device.py``. For a batch of
improvement traces (8 f128 values each) one eager torch program on the
card: the upload of the canonical limbs; to the Montgomery domain; the
inverse NTT (interpolation), the shift by the coset offset's powers, the
zero pad to blowup 8 and the forward NTT (``ntt.coset_lde_device``, every
product a ``mont_mul`` launch at f128's 11 limbs); out of the Montgomery
domain; the LDE canonicalised mod p; its 16-byte little-endian leaf
messages as u32 words; and the BLAKE3 leaf digest of every row
(``blake3_device.hash_blocks``: one ``blake3`` kernel launch on the
card, the plain compression on the CPU). One download brings back the
coefficients, the words (the LDE's exact ints) and the digests; the host
prover (``models/stark.py``) builds each proof's Merkle levels above them.
The batch is not padded: the JAX package padded it to a power of two for its
compile cache, and the port has no compile step.

Canonicalisation mod p = 2^128 - 45 * 2^40 + 1: values leave ``mont_mul``
relaxed, in (-p, 2p), limbs in about (-2^13, 2^13). Strict digits and two
folds of the bits at and above 2^128 through e = 2^128 mod p = 45 * 2^40 - 1
bring the value below 2^128 + small; one conditional subtract follows by
the identity v >= p iff v + e has bit 128 set (p + e = 2^128). Each fold
adds e at the low limbs, which can ripple through a run of 0xFFF limbs (p
has about 7 of them) one limb a carry pass, so each fold is followed by a
full cascade of n + 1 passes (the hazard the JAX package fixed).
"""

from __future__ import annotations

import functools

import torch

from ..device import resolve
from .blake3_device import hash_blocks
from .field import F128
from .limb import LIMB_BITS, LimbContext, _int_to_limbs, get_context, limb_rows_to_ints
from .ntt import coset_lde_device

P128 = F128.p
E128 = (1 << 128) - P128  # 45 * 2^40 - 1
_TI = 128 // LIMB_BITS    # 10: the limb holding bit 128 (at offset 8)
_TOFF = 128 % LIMB_BITS   # 8
_TOP_MASK = (1 << _TOFF) - 1


@functools.lru_cache(maxsize=None)
def _canon_consts(n: int, device: torch.device) -> tuple:
    """(4p, e) as strict limbs on ``device``."""
    return (torch.from_numpy(_int_to_limbs(4 * P128, n)).to(device),
            torch.from_numpy(_int_to_limbs(E128, n)).to(device))


def _strict(ctx: LimbContext, x: torch.Tensor, passes: int) -> torch.Tensor:
    for _ in range(passes):
        x = ctx._carry_pass(x)
    return x


def _split_top(x: torch.Tensor) -> tuple:
    """(x with the bits at and above 2^128 cleared, those bits' value)."""
    top = x[..., _TI]
    lo = torch.cat([x[..., :_TI], (top & _TOP_MASK)[..., None],
                    torch.zeros_like(x[..., _TI + 1:])], dim=-1)
    return lo, top >> _TOFF


def canon_f128_device(ctx: LimbContext, x: torch.Tensor) -> torch.Tensor:
    """Relaxed (-p, 2p) f128 limbs (..., n) int32 -> strict canonical limbs
    in [0, 2^12), value < p: the JAX package's sequence of carry passes,
    folds and the conditional subtract, so the limbs equal its."""
    n = ctx.n
    bias, e = _canon_consts(n, x.device)
    x = _strict(ctx, x, 3) + bias  # limbs near [0, 2^12); value in (3p, 6p) > 0
    x = _strict(ctx, x, n + 2)
    for _ in range(2):  # v = lo + hi * e  (2^128 == e mod p)
        lo, hi = _split_top(x)
        x = _strict(ctx, lo + hi[..., None] * e, n + 1)
    w_lo, w_hi = _split_top(_strict(ctx, x + e, n + 1))
    return torch.where((w_hi > 0)[..., None], w_lo, x)


def limbs_to_u32_words(x: torch.Tensor, nbytes: int = 16) -> torch.Tensor:
    """Strict 12-bit limbs (..., n) -> (..., nbytes // 4) little-endian u32
    words of the value, as int64 in [0, 2^32)."""
    n = x.shape[-1]
    x = x.to(torch.int64)
    words = []
    for w in range(nbytes // 4):
        lo_bit = 32 * w
        acc = None
        i = lo_bit // LIMB_BITS
        while i < n and LIMB_BITS * i < lo_bit + 32:
            shift = LIMB_BITS * i - lo_bit  # the limb's position in the word
            piece = x[..., i] >> -shift if shift < 0 else x[..., i] << shift
            acc = piece if acc is None else acc | piece
            i += 1
        words.append(acc & 0xFFFFFFFF)
    return torch.stack(words, dim=-1)


def lde_commit_device(ctx: LimbContext, x: torch.Tensor, blowup: int, offset: int) -> tuple:
    """``x`` (B, n, limbs) canonical f128 trace limbs -> (coefficients (B,
    n, limbs) relaxed, LDE (B, N, limbs) relaxed, LDE words (B, N, 4) int64
    u32 words of the canonical values, leaf digests (B, N, 8) int64 u32
    words), N = n * blowup, all on ``x``'s device."""
    B, n = x.shape[0], x.shape[1]
    N = n * blowup
    coeffs, lde = coset_lde_device(ctx, x, blowup, offset)
    words = limbs_to_u32_words(canon_f128_device(ctx, lde), 16)
    m = torch.nn.functional.pad(words.reshape(B * N, 4), (0, 12))  # zero-padded 64-byte blocks
    return coeffs, lde, words, hash_blocks(m, 16).reshape(B, N, 8)


def upload_traces(ctx: LimbContext, traces, device: torch.device) -> torch.Tensor:
    """Traces (equal lengths, canonical ints) -> (B, n, limbs) canonical
    limbs on ``device``: the batch's one upload."""
    B, n = len(traces), len(traces[0])
    return ctx.encode([v for t in traces for v in t], device=device).reshape(B, n, ctx.n)


def download_commit(ctx: LimbContext, coeffs: torch.Tensor, words: torch.Tensor,
                    digests: torch.Tensor) -> tuple:
    """:func:`lde_commit_device`'s coefficients, words and digests -> (polys,
    ldes, leaf digest rows) on the host: the batch's one download, then the
    coefficients decoded mod p, the LDE's ints read from its words and the
    digests as 32-byte strings."""
    B, n, N = coeffs.shape[0], coeffs.shape[1], words.shape[1]
    out = torch.cat([coeffs.reshape(B, -1).to(torch.int64), words.reshape(B, -1),
                     digests.reshape(B, -1)], dim=1).cpu().numpy()
    nc, nw = n * ctx.n, N * 4
    polys = limb_rows_to_ints(out[:, :nc].reshape(-1, ctx.n), ctx.p)
    lde_raw = out[:, nc : nc + nw].astype("<u4").tobytes()
    leaf_raw = out[:, nc + nw :].astype("<u4").tobytes()
    return ([polys[b * n : (b + 1) * n] for b in range(B)],
            [[int.from_bytes(lde_raw[16 * (b * N + r) : 16 * (b * N + r + 1)], "little")
              for r in range(N)] for b in range(B)],
            [[leaf_raw[32 * (b * N + r) : 32 * (b * N + r + 1)] for r in range(N)]
             for b in range(B)])


def coset_lde_commit_batch(p: int, traces, blowup: int, offset: int, *, device=None) -> tuple:
    """A batch of f128 traces -> (polys, ldes, leaf digest rows): each
    trace's coefficients and LDE as canonical ints and its N 32-byte leaf
    digests (the digests ``hash_element_rows`` gives the LDE's one-element
    rows): :func:`upload_traces`, :func:`lde_commit_device`,
    :func:`download_commit`. ``device`` defaults to the CUDA card; ``"cpu"``
    runs the plain versions."""
    device = resolve(device)
    if p != P128:
        raise ValueError("coset_lde_commit_batch canonicalises mod f128's p only")
    ctx = get_context(p)
    coeffs, _, words, digests = lde_commit_device(ctx, upload_traces(ctx, traces, device), blowup,
                                                  offset)
    return download_commit(ctx, coeffs, words, digests)
