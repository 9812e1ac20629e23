"""Whole-pipeline batched Bulletproofs range prover on a torch device.

Port of the JAX package's ``libzkp_tpu/models/bp_device.py``. A batch of
64-bit single range proofs advances in lockstep through every phase — V/A/S
commitments, the Merlin/STROBE transcript, the t(x) algebra, the six
inner-product rounds and Ristretto compression — with one upload of inputs
and randomness and one download of the finished 672-byte proofs.

The schedule is byte-identical to :func:`.bulletproofs.prove_single` (same
labels, same append order, the same IPP over the fixed basis
``[B_blinding] + G + H + [B]`` that never materializes folded generators).
The MSMs run through the window-sum and Horner kernels
(:mod:`..ops.kernels`); the programs between them (``_segs``) are eager torch
on the same device.
"""

from __future__ import annotations

import functools
import os
from typing import List, Sequence, Tuple

import numpy as np
import torch

from ..device import resolve
from ..ops import curve
from ..ops import ed25519 as ed
from ..ops import scalar_device as sd
from ..ops.keccak_device import TranscriptDevice
from ..ops.limbfold import FieldOps, int_to_limbs
from ..ops.ristretto import _compress_consts, _compress_impl
from ..utils import tracing
from . import bp_generators as gens

L = ed.L
N_BITS = 64


# ---------------------------------------------------------------------------
# helpers on fold-limb tensors
# ---------------------------------------------------------------------------


def _canonical_scalar_rows(f: FieldOps, sc, x: torch.Tensor) -> torch.Tensor:
    """Relaxed mod-l limbs (n, B) -> canonical strict limbs (value < l).

    strict_digit_windows' representative (< 2^256, = x + k*l) is made
    canonical by subtracting the right multiple of l: k in {0..4} after the
    +4l bias, found by lexicographic sign tests against k*l.
    """
    n = sc.n
    x = f.carry(f.carry(f.carry(x)))
    x = sd.fold252(f, sc, x)
    x = sd.fold252(f, sc, x)
    x = x + f.extra_const(sd.ScalarDeviceCtx.IDX_BIAS)  # +4l, value >= 0
    for _ in range(n + 2):
        x = f.carry(x)
    # x strict, value in (4l - 2^138, 4l + 2^252) subset [0, 6l)
    for k in (4, 3, 2, 1):  # greedy: subtract largest k*l that fits
        kl = torch.from_numpy(int_to_limbs(k * L, n)).to(x.device)[:, None]
        w = x - kl
        # leading-sign test: sign of the most-significant nonzero limb diff
        nz = (w != 0).to(torch.int32)
        csum = torch.flip(torch.cumsum(torch.flip(nz, dims=(0,)), dim=0), dims=(0,))
        lead = ((csum == 1) & (nz == 1)).to(torch.int32)
        sign = torch.sum(lead * torch.sign(w), dim=-2)  # (B,): +1, -1, or 0
        x = torch.where((sign >= 0)[None, :], w, x)
        if k > 1:
            # re-strict after a subtract (borrows): value >= 0
            for _ in range(n + 1):
                x = f.carry(x)
    for _ in range(n + 1):
        x = f.carry(x)
    return x  # strict, < l


def _limbs_to_byte_rows(x: torch.Tensor, nbytes: int = 32) -> torch.Tensor:
    """Strict 12-bit limbs (n, B) -> (nbytes, B) int32 byte rows (LE)."""
    return torch.stack(sd._byte_rows(x, nbytes), dim=0)


# ---------------------------------------------------------------------------
# fixed basis table: [B_blinding] + G + H + [B]
# ---------------------------------------------------------------------------


def _basis_points(n_bits: int):
    B_base, B_blinding = gens.pedersen_gens()
    G, H = gens.bp_gens(n_bits)
    return [B_blinding] + list(G) + list(H) + [B_base]


@functools.lru_cache(maxsize=None)
def _basis_table(n_bits: int, device: torch.device) -> curve.DeviceTable:
    """The basis multiples table, built once per process and device."""
    pts = _basis_points(n_bits)
    return curve.DeviceTable(curve.edwards_engine().encode_points(pts), device=device)


def _pad_digit_windows(dw: torch.Tensor, Kp: int) -> torch.Tensor:
    """(32, K, B) digits -> (32, Kp, B) (zero rows for padded basis)."""
    K = dw.shape[1]
    if K == Kp:
        return dw.contiguous()
    return torch.nn.functional.pad(dw, (0, 0, 0, Kp - K)).contiguous()


# ---------------------------------------------------------------------------
# compute segments: everything between two transcript phases
# ---------------------------------------------------------------------------


class _Segs:
    """The prover's compute programs between transcript phases (the JAX
    ``_segs`` dictionary of jitted programs, as eager torch functions)."""

    def __init__(self, Kp: int, device: torch.device):
        self.Kp = Kp
        self.sc = sd.get_scalar_ctx()
        self.nl = self.sc.n
        self.device = device
        self.f = self.sc.field(torch.from_numpy(self.sc.consts_np).to(device))
        self.one_col = torch.from_numpy(self.sc.encode([1])[0]).to(device)[:, None]
        self.two_i = torch.from_numpy(
            self.sc.encode([pow(2, i, L) for i in range(N_BITS)])
        ).to(device)  # (n, nl)
        self.compress_consts = torch.from_numpy(_compress_consts()).to(device)

    def carry3(self, x):
        # 64-term relaxed sums can set the top limb, whose ONE-sized wrap
        # needs three passes to settle back under ~2^13
        f = self.f
        return f.carry(f.carry(f.carry(x)))

    def sum64(self, x):
        return self.carry3(x.sum(dim=0, dtype=torch.int32))

    def msm2_dw(self, val, blind):
        n = N_BITS
        stacked = torch.cat(
            [blind[None], torch.zeros((2 * n,) + tuple(val.shape), dtype=val.dtype,
                                      device=val.device), val[None]],
            dim=0,
        )
        return _pad_digit_windows(sd.strict_digit_windows(self.f, self.sc, stacked), self.Kp)

    def pow_stack(self, base):
        """[base^0 .. base^(n-1)] as (n, nl, B) via log-depth doubling."""
        f = self.f
        stack = torch.stack([self.one_col.expand_as(base), base], dim=0)
        step_pow = base
        while stack.shape[0] < N_BITS:
            step_pow = f.mul(step_pow, step_pow) if stack.shape[0] > 2 else f.mul(base, base)
            stack = torch.cat([stack, f.mul(stack, step_pow[None])], dim=0)[:N_BITS]
        return stack

    def setup(self, y_raw, z_raw, aL_d, sL_d, sR_d, t1b, t2b):
        f, sc = self.f, self.sc
        y = sd.reduce_wide(f, sc, y_raw)
        z = sd.reduce_wide(f, sc, z_raw)
        z2 = f.mul(z, z)
        y_pow = self.pow_stack(y)
        l0 = f.sub(aL_d, z[None])
        aR_z = f.sub(f.add(aL_d, z[None]), self.one_col[None].expand_as(aL_d))
        r0 = f.add(f.mul(y_pow, aR_z), f.mul(z2[None], self.two_i[:, :, None]))
        r1 = f.mul(y_pow, sR_d)
        t1_s = self.carry3(
            f.mul(l0, r1).sum(dim=0, dtype=torch.int32)
            + f.mul(sL_d, r0).sum(dim=0, dtype=torch.int32)
        )
        t2_s = self.sum64(f.mul(sL_d, r1))
        dwT1 = self.msm2_dw(t1_s, t1b)
        dwT2 = self.msm2_dw(t2_s, t2b)
        return y, z2, l0, r0, r1, dwT1, dwT2

    def after_x(self, x_raw, l0, r0, r1, sL_d, z2, gamma_d, t1b, t2b, ab, sb):
        f, sc = self.f, self.sc
        x = sd.reduce_wide(f, sc, x_raw)
        l_vec = f.add(l0, f.mul(sL_d, x[None]))
        r_vec = f.add(r0, f.mul(r1, x[None]))
        t_x = self.sum64(f.mul(l_vec, r_vec))
        x2 = f.mul(x, x)
        t_x_blind = f.add(f.mul(z2, gamma_d), f.add(f.mul(x, t1b), f.mul(x2, t2b)))
        e_blind = f.add(ab, f.mul(x, sb))
        tx_r = _limbs_to_byte_rows(_canonical_scalar_rows(f, sc, t_x))
        txb_r = _limbs_to_byte_rows(_canonical_scalar_rows(f, sc, t_x_blind))
        eb_r = _limbs_to_byte_rows(_canonical_scalar_rows(f, sc, e_blind))
        return l_vec, r_vec, tx_r, txb_r, eb_r

    def hc(self, y_arr):
        y_inv = sd.inv_device(self.f, y_arr)
        B = y_arr.shape[-1]
        gc = self.one_col[None].expand(N_BITS, self.nl, B).contiguous()
        return gc, self.pow_stack(y_inv)

    def ipp_pre(self, w_arr, a_v, b_v, gc, hc):
        f, sc, nl, n = self.f, self.sc, self.nl, N_BITS
        m = a_v.shape[0]
        half = m // 2
        reps = n // m
        B = a_v.shape[-1]
        a_lo, a_hi = a_v[:half], a_v[half:]
        b_lo, b_hi = b_v[:half], b_v[half:]
        cL = self.sum64(f.mul(a_lo, b_hi))
        cR = self.sum64(f.mul(a_hi, b_lo))
        gc_r = gc.reshape(reps, m, nl, B)
        hc_r = hc.reshape(reps, m, nl, B)
        zero_row = torch.zeros((1, nl, B), dtype=torch.int32, device=a_v.device)

        def scal(a_sel, b_sel, g_side, c):
            gl = torch.zeros_like(gc_r)
            hl = torch.zeros_like(hc_r)
            a_b = a_sel[None].expand(reps, half, nl, B)
            b_b = b_sel[None].expand(reps, half, nl, B)
            if g_side == "R":  # L point: a_lo vs G_R, b_hi vs H_L
                gl[:, half:] = f.mul(a_b, gc_r[:, half:])
                hl[:, :half] = f.mul(b_b, hc_r[:, :half])
            else:
                gl[:, :half] = f.mul(a_b, gc_r[:, :half])
                hl[:, half:] = f.mul(b_b, hc_r[:, half:])
            q = f.mul(c, w_arr)
            return torch.cat(
                [zero_row, gl.reshape(n, nl, B), hl.reshape(n, nl, B), q[None]], dim=0
            )

        dwL = _pad_digit_windows(sd.strict_digit_windows(f, sc, scal(a_lo, b_hi, "R", cL)), self.Kp)
        dwR = _pad_digit_windows(sd.strict_digit_windows(f, sc, scal(a_hi, b_lo, "L", cR)), self.Kp)
        return dwL, dwR

    def ipp_post(self, u_raw, a_v, b_v, gc, hc):
        f, sc, nl, n = self.f, self.sc, self.nl, N_BITS
        m = a_v.shape[0]
        half = m // 2
        reps = n // m
        B = a_v.shape[-1]
        u = sd.reduce_wide(f, sc, u_raw)
        u_inv = sd.inv_device(f, u)
        a_lo, a_hi = a_v[:half], a_v[half:]
        b_lo, b_hi = b_v[:half], b_v[half:]
        a2 = f.add(f.mul(a_lo, u[None]), f.mul(a_hi, u_inv[None]))
        b2 = f.add(f.mul(b_lo, u_inv[None]), f.mul(b_hi, u[None]))
        gc_r = gc.reshape(reps, m, nl, B)
        hc_r = hc.reshape(reps, m, nl, B)
        gc2 = torch.cat(
            [f.mul(gc_r[:, :half], u_inv[None, None]), f.mul(gc_r[:, half:], u[None, None])],
            dim=1,
        ).reshape(n, nl, B)
        hc2 = torch.cat(
            [f.mul(hc_r[:, :half], u[None, None]), f.mul(hc_r[:, half:], u_inv[None, None])],
            dim=1,
        ).reshape(n, nl, B)
        return a2, b2, gc2, hc2

    def w(self, w_raw):
        return sd.reduce_wide(self.f, self.sc, w_raw)

    def final(self, a0, b0):
        f, sc = self.f, self.sc
        return (
            _limbs_to_byte_rows(_canonical_scalar_rows(f, sc, a0)),
            _limbs_to_byte_rows(_canonical_scalar_rows(f, sc, b0)),
        )

    def compress(self, pts):
        return _limbs_to_byte_rows(_compress_impl(self.compress_consts, pts), 32)


# ---------------------------------------------------------------------------
# the batched prover
# ---------------------------------------------------------------------------


def prove_single_batch_device(
    label: bytes,
    values: Sequence[int],
    blindings: Sequence[int],
    rnd: Sequence[Sequence[int]] = None,
    *,
    device=None,
) -> List[Tuple[bytes, bytes]]:
    """Convenience wrapper: fresh per-lane transcripts under one label."""
    from .strobe import Transcript

    insts = [(Transcript(label), v, g, N_BITS) for v, g in zip(values, blindings)]
    return prove_insts_device(insts, rnd=rnd, device=device)


def _encode_cols(sc, vals, device) -> torch.Tensor:
    """ints -> (nl, B) limb columns on the device."""
    return torch.from_numpy(np.ascontiguousarray(sc.encode(vals).T)).to(device)


def prove_insts_device(
    insts, rand: bytes = None, rnd: Sequence[Sequence[int]] = None, *, device=None
) -> List[Tuple[bytes, bytes]]:
    """Batch of 64-bit single range proofs, whole pipeline on the device.

    ``insts``: ``(transcript, value, blinding, n)`` tuples; the transcripts
    resume on the device and must share their STROBE position (group by
    label length). ``rand``: ``(2n+4)`` wide 64-byte draws per lane, ordered
    ``a_blind, s_blind, s_L[0..n-1], s_R[0..n-1], t1_blind, t2_blind``;
    ``rnd``: the same per lane as pre-reduced scalars. Neither: drawn from
    ``os.urandom``.

    Returns [(proof_672_bytes, V_compressed)] per lane, byte-identical to
    :func:`.bulletproofs.prove_single` under the same randomness.
    """
    dev = resolve(device)
    B0 = len(insts)
    if B0 == 0:
        raise ValueError("empty batch")
    n = N_BITS
    if any(i[3] != n for i in insts):
        raise ValueError("the device prover is 64-bit only")
    # pad to the shared power-of-two buckets; pad lanes clone lane 0 and are
    # dropped on exit
    B = curve._pad_batch(B0)
    per = (2 * n + 4) * 64
    if B != B0:
        insts = list(insts) + [insts[0]] * (B - B0)
        if rnd is not None:
            rnd = list(rnd) + [rnd[0]] * (B - B0)
        if rand is not None:
            rand = rand + rand[:per] * (B - B0)
    transcripts = [i[0] for i in insts]
    values = [i[1] for i in insts]
    blindings = [i[2] for i in insts]
    sc = sd.get_scalar_ctx()
    table = _basis_table(n, dev)
    K, Kp = table.K, table.Kp

    # -- randomness --------------------------------------------------------
    with tracing.span("bp.draw"):
        if rnd is None:
            if rand is None:
                rand = os.urandom(per * B)
            if len(rand) != per * B:
                raise ValueError("rand must hold (2n+4) 64-byte draws per lane")
            rnd = [
                [
                    ed.scalar_from_bytes_mod_order_wide(
                        rand[per * b + 64 * s : per * b + 64 * s + 64])
                    for s in range(2 * n + 4)
                ]
                for b in range(B)
            ]
        a_blind = [r[0] for r in rnd]
        s_blind = [r[1] for r in rnd]
        s_L = [[r[2 + i] for r in rnd] for i in range(n)]  # (n)(B)
        s_R = [[r[2 + n + i] for r in rnd] for i in range(n)]
        t1_blind = [r[2 + 2 * n] for r in rnd]
        t2_blind = [r[3 + 2 * n] for r in rnd]

    # -- host-known MSMs: V, A, S (digits prepared on host) ---------------
    with tracing.span("bp.digits"):
        gamma = [b % L for b in blindings]
        aL = [[(v >> i) & 1 for v in values] for i in range(n)]  # (n)(B)
        # basis rows: 0 = B_blinding, 1..n = G, n+1..2n = H, 2n+1 = B
        v_scals = [[gamma[b], *(0 for _ in range(2 * n)), values[b] % L] for b in range(B)]
        a_scals = [
            [a_blind[b]] + [aL[i][b] for i in range(n)] + [(aL[i][b] - 1) % L for i in range(n)]
            + [0]
            for b in range(B)
        ]
        s_scals = [
            [s_blind[b]] + [s_L[i][b] for i in range(n)] + [s_R[i][b] for i in range(n)] + [0]
            for b in range(B)
        ]
        vas_digits = [torch.from_numpy(curve._digits_from_scalars(scals, K, Kp)).to(dev)
                      for scals in (v_scals, a_scals, s_scals)]

    segs = _Segs(Kp, dev)
    V_b, A_b, S_b = (segs.compress(curve.msm_windows(table, curve._digits_to_windows(d)))
                     for d in vas_digits)

    # -- transcript to y, z --------------------------------------------------
    with tracing.span("bp.transcript"):
        t = TranscriptDevice.from_transcripts(transcripts, device=dev)
        y_raw, z_raw = t.run_phase([
            ("msg", b"dom-sep", b"rangeproof v1"),
            ("msg", b"n", n.to_bytes(8, "little")),
            ("msg", b"m", (1).to_bytes(8, "little")),
            ("msg", b"V", V_b),
            ("msg", b"A", A_b),
            ("msg", b"S", S_b),
            ("chal", b"y", 64),
            ("chal", b"z", 64),
        ])

    with tracing.span("bp.upload"):
        aL_d = torch.stack([_encode_cols(sc, aL[i], dev) for i in range(n)], dim=0)  # (n, nl, B)
        sL_d = torch.stack([_encode_cols(sc, s_L[i], dev) for i in range(n)], dim=0)
        sR_d = torch.stack([_encode_cols(sc, s_R[i], dev) for i in range(n)], dim=0)
        gamma_d = _encode_cols(sc, gamma, dev)
        a_blind_d = _encode_cols(sc, a_blind, dev)
        s_blind_d = _encode_cols(sc, s_blind, dev)
        t1_blind_d = _encode_cols(sc, t1_blind, dev)
        t2_blind_d = _encode_cols(sc, t2_blind, dev)

    with tracing.span("bp.poly"):
        y, z2, l0, r0, r1, dwT1, dwT2 = segs.setup(
            y_raw, z_raw, aL_d, sL_d, sR_d, t1_blind_d, t2_blind_d
        )

        # T1/T2 (and each round's L/R below) share the basis: one double-wide
        # MSM batch and one compress
        Tb = segs.compress(curve.msm_windows(table, torch.cat([dwT1, dwT2], dim=2)))
        T1_b, T2_b = Tb[:, :B], Tb[:, B:]
        with tracing.span("bp.transcript"):
            (x_raw,) = t.run_phase([
                ("msg", b"T_1", T1_b),
                ("msg", b"T_2", T2_b),
                ("chal", b"x", 64),
            ])

        l_vec, r_vec, tx_r, txb_r, eb_r = segs.after_x(
            x_raw, l0, r0, r1, sL_d, z2, gamma_d, t1_blind_d, t2_blind_d, a_blind_d, s_blind_d
        )
    with tracing.span("bp.transcript"):
        (w_raw,) = t.run_phase([
            ("msg", b"t_x", tx_r),
            ("msg", b"t_x_blinding", txb_r),
            ("msg", b"e_blinding", eb_r),
            ("chal", b"w", 64),
            ("msg", b"dom-sep", b"ipp v1"),
            ("msg", b"n", n.to_bytes(8, "little")),
        ])

    with tracing.span("bp.ipp"):
        w = segs.w(w_raw)
        gc, hc = segs.hc(y)
        a_v, b_v = l_vec, r_vec
        L_bytes: List = []
        R_bytes: List = []
        m = n
        while m > 1:
            dwL, dwR = segs.ipp_pre(w, a_v, b_v, gc, hc)
            LRb = segs.compress(curve.msm_windows(table, torch.cat([dwL, dwR], dim=2)))
            Lb, Rb = LRb[:, :B], LRb[:, B:]
            L_bytes.append(Lb)
            R_bytes.append(Rb)
            with tracing.span("bp.transcript"):
                (u_raw,) = t.run_phase([
                    ("msg", b"L", Lb),
                    ("msg", b"R", Rb),
                    ("chal", b"u", 64),
                ])
            a_v, b_v, gc, hc = segs.ipp_post(u_raw, a_v, b_v, gc, hc)
            m //= 2
        a_rows, b_rows = segs.final(a_v[0], b_v[0])

    # -- assemble: (704, B) byte rows, one download ---------------------------
    with tracing.span("bp.assemble"):
        rows = [A_b, S_b, T1_b, T2_b, tx_r, txb_r, eb_r]
        for Lb, Rb in zip(L_bytes, R_bytes):
            rows.append(Lb)
            rows.append(Rb)
        rows += [a_rows, b_rows, V_b]
        blob = torch.cat(rows, dim=0).to(torch.uint8).cpu().numpy()  # (704, B)
        cols = np.ascontiguousarray(blob.T)  # (B, 704)
        out = []
        for bidx in range(B0):  # drop pad lanes
            col = cols[bidx].tobytes()
            out.append((col[:672], col[672:704]))
    return out
