"""STARK verification (DEEP-ALI + FRI over f128, BLAKE3 Merkle
commitments) in pure Python.

Frozen copy of the port's Python verifier (``stark.verify``), the rebuild
of the reference's winterfell 0.10 verifier: the proof options
``ProofOptions::new(32, 8, 0, None, 8, 31)``, the winterfell ``Proof``
container (:mod:`.winterfell_wire`), and the improvement AIR (one column of
8 rows, ``next - current - step``, first = old, last = new).
"""

from __future__ import annotations

import struct
from dataclasses import dataclass
from typing import List, Optional, Sequence, Tuple

from . import winterfell_wire as ww
from .blake3 import blake3_256
from .field import F128, PrimeField
from .random_coin import RandomCoin

DOMAIN_OFFSET = 3


def poly_eval(F: PrimeField, coeffs: List[int], x: int) -> int:
    acc = 0
    for c in reversed(coeffs):
        acc = (acc * x + c) % F.p
    return acc


def hash_elements(F, elements: Sequence[int]) -> bytes:
    """BLAKE3 over the elements' fixed-width little-endian bytes."""
    return blake3_256(b"".join(int(e).to_bytes(F.nbytes, "little") for e in elements))


@dataclass(frozen=True)
class ProofOptions:
    """Mirrors winterfell ProofOptions (stark.rs:94-102)."""

    num_queries: int = 32
    blowup: int = 8
    grinding: int = 0
    folding: int = 8
    max_remainder_degree: int = 31

    def to_bytes(self) -> bytes:
        return struct.pack(
            "<BBBBH",
            self.num_queries,
            self.blowup,
            self.grinding,
            self.folding,
            self.max_remainder_degree,
        )

    @classmethod
    def from_bytes(cls, data: bytes) -> "ProofOptions":
        nq, bl, gr, fo, mrd = struct.unpack("<BBBBH", data)
        return cls(nq, bl, gr, fo, mrd)


class Air:
    """Algebraic intermediate representation: subclass per statement."""

    field: PrimeField = F128

    def __init__(self, trace_length: int, trace_width: int, pub_inputs: Sequence[int], options: ProofOptions):
        assert trace_length & (trace_length - 1) == 0
        self.trace_length = trace_length
        self.trace_width = trace_width
        self.pub_inputs = [int(x) for x in pub_inputs]
        self.options = options

    # -- to be overridden --------------------------------------------------
    def transition_degrees(self) -> List[int]:
        raise NotImplementedError

    def evaluate_transition(self, current: List[int], nxt: List[int]) -> List[int]:
        raise NotImplementedError

    def get_assertions(self) -> List[Tuple[int, int, int]]:
        """List of (column, step, value) boundary assertions."""
        raise NotImplementedError

    # -- derived -----------------------------------------------------------
    def num_composition_columns(self) -> int:
        return max(1, max(self.transition_degrees()))

    def context_bytes(self) -> bytes:
        """Random-coin seed material: binds field, trace shape, options, inputs."""
        out = bytearray(b"libzkp_tpu_stark_v1")
        out += self.field.p.to_bytes(32, "little")
        out += struct.pack("<IB", self.trace_length, self.trace_width)
        out += self.options.to_bytes()
        out += struct.pack("<I", len(self.pub_inputs))
        for x in self.pub_inputs:
            out += int(x).to_bytes(self.field.nbytes, "little")
        return bytes(out)


def _fri_layer_plan(options: ProofOptions, lde_size: int) -> List[int]:
    """Domain sizes at each committed FRI layer (before remainder)."""
    max_rem = (options.max_remainder_degree + 1) * options.blowup
    sizes = []
    size = lde_size
    while size > max_rem:
        sizes.append(size)
        size //= options.folding
    return sizes


def _lagrange_eval(F: PrimeField, xs: List[int], ys: List[int], at: int) -> int:
    """Evaluate the interpolating polynomial through (xs, ys) at ``at``."""
    p = F.p
    total = 0
    for i in range(len(xs)):
        num, den = 1, 1
        for j in range(len(xs)):
            if i == j:
                continue
            num = num * ((at - xs[j]) % p) % p
            den = den * ((xs[i] - xs[j]) % p) % p
        total = (total + ys[i] * num % p * F.inv(den)) % p
    return total


def verify(air: Air, proof_bytes: bytes) -> bool:
    """Return True iff the proof verifies. Malformed input gives False: a
    truncated or inconsistent container raises ``ValueError`` or
    ``IndexError`` in its parse, and a query point on the OOD point
    ``ZeroDivisionError`` in an inversion."""
    try:
        return _verify_inner(air, proof_bytes)
    except (ValueError, IndexError, ZeroDivisionError):
        return False


def _verify_inner(air: Air, proof_bytes: bytes) -> bool:
    F = air.field
    p = F.p
    opts = air.options

    # --- parse the winterfell container (winterfell_wire field map) ---
    data = bytes(proof_bytes)
    w_ctx, n_ctx, modulus, opt_tuple, pos = ww.read_context(data, 0)
    if n_ctx != air.trace_length or w_ctx != air.trace_width or modulus != p:
        return False
    # AcceptableOptions::OptionSet equivalent (stark.rs:199-201)
    if opt_tuple != (
        opts.num_queries, opts.blowup, opts.grinding, opts.folding,
        opts.max_remainder_degree,
    ):
        return False
    n, w = n_ctx, w_ctx
    N = n * opts.blowup
    g_n = F.root_of_unity(n)
    g_N = F.root_of_unity(N)
    offset = DOMAIN_OFFSET
    k = air.num_composition_columns()
    layer_sizes = _fri_layer_plan(opts, N)
    num_layers = len(layer_sizes)

    n_positions = data[pos]
    pos += 1
    trace_root, comp_root, fri_roots, pos = ww.read_commitments(
        data, pos, num_layers
    )
    n_segments, pos = ww.read_usize(data, pos)
    if n_segments != 1:
        return False
    t_paths, t_values, pos = ww.read_queries(data, pos)
    c_paths, c_values, pos = ww.read_queries(data, pos)
    ood_states, ood_evals, pos = ww.read_ood_frame(data, pos)
    fri_layer_blobs, rem_bytes, pos = ww.read_fri_proof(data, pos)
    if len(fri_layer_blobs) != num_layers:
        return False
    if len(data) < pos + 8:
        return False
    nonce = int.from_bytes(data[pos : pos + 8], "little")
    if pos + 8 != len(data):
        return False

    def _felts(blob: bytes, count: int) -> Optional[List[int]]:
        if len(blob) != count * F.nbytes:
            return None
        out = []
        for i in range(count):
            v = int.from_bytes(blob[i * F.nbytes : (i + 1) * F.nbytes], "little")
            if v >= p:
                return None
            out.append(v)
        return out

    ood_all = _felts(ood_states, 2 * w)
    ood_comp = _felts(ood_evals, k)
    if ood_all is None or ood_comp is None:
        return False
    ood_cur, ood_nxt = ood_all[:w], ood_all[w:]
    rem_count = len(rem_bytes) // F.nbytes
    if rem_count > opts.max_remainder_degree + 1:
        return False
    remainder = _felts(rem_bytes, rem_count)
    if remainder is None:
        return False

    # Rebuild the coin transcript
    coin = RandomCoin(air.context_bytes())
    coin.reseed(trace_root)
    t_degrees = air.transition_degrees()
    assertions = air.get_assertions()
    alphas = coin.draw_felts(F, len(t_degrees))
    betas = coin.draw_felts(F, len(assertions))
    coin.reseed(comp_root)
    z = coin.draw_felt(F)
    zg = z * g_n % p
    coin.reseed(hash_elements(F, ood_cur + ood_nxt + ood_comp))
    gammas = coin.draw_felts(F, 2 * w + k)
    fri_betas = []
    for root in fri_roots:
        coin.reseed(root)
        fri_betas.append(coin.draw_felt(F))
    coin.reseed(hash_elements(F, remainder))
    if not coin.check_leading_zeros(nonce, opts.grinding):
        return False
    positions = coin.draw_integers(opts.num_queries, N, nonce)
    if n_positions != len(positions):
        return False

    # --- OOD constraint check (the ALI equation) ---
    exemption = pow(g_n, n - 1, p)
    zn = pow(z, n, p)
    if zn == 1:
        return False
    t_evals = air.evaluate_transition(ood_cur, ood_nxt)
    acc = 0
    zinv = F.inv((zn - 1) % p) * ((z - exemption) % p) % p
    for a, ev in zip(alphas, t_evals):
        acc = (acc + a * ev % p * zinv) % p
    for j, (col, step, value) in enumerate(assertions):
        den = (z - pow(g_n, step, p)) % p
        if den == 0:
            return False
        acc = (acc + betas[j] * ((ood_cur[col] - value) % p) % p * F.inv(den)) % p
    hz = 0
    for j in range(k):
        hz = (hz + pow(z, j * n, p) * ood_comp[j]) % p
    if acc != hz:
        return False

    # --- query checks (winterfell BatchMerkleProof openings) ---
    depth_t = (N - 1).bit_length()
    flat = _felts(t_values, w * len(positions))
    if flat is None:
        return False
    trace_rows = [flat[qi * w : (qi + 1) * w] for qi in range(len(positions))]
    if not ww.batch_proof_verify(
        trace_root, depth_t, positions,
        [hash_elements(F, row) for row in trace_rows], t_paths,
    ):
        return False
    flat = _felts(c_values, k * len(positions))
    if flat is None:
        return False
    comp_rows = [flat[qi * k : (qi + 1) * k] for qi in range(len(positions))]
    if not ww.batch_proof_verify(
        comp_root, depth_t, positions,
        [hash_elements(F, row) for row in comp_rows], c_paths,
    ):
        return False

    # FRI layer rows
    fri_layer_rows = []  # per layer: dict r -> row
    cur_positions = list(positions)
    for li, size_l in enumerate(layer_sizes):
        stride = size_l // opts.folding
        fold_positions = sorted(set(q % stride for q in cur_positions))
        values, paths = fri_layer_blobs[li]
        flat = _felts(values, opts.folding * len(fold_positions))
        if flat is None:
            return False
        rows = {
            r: flat[i * opts.folding : (i + 1) * opts.folding]
            for i, r in enumerate(fold_positions)
        }
        depth_l = (stride - 1).bit_length()
        if not ww.batch_proof_verify(
            fri_roots[li], depth_l, fold_positions,
            [hash_elements(F, rows[r]) for r in fold_positions], paths,
        ):
            return False
        fri_layer_rows.append(rows)
        cur_positions = fold_positions

    final_size = N // (opts.folding ** num_layers) if num_layers else N
    for qi, q in enumerate(positions):
        x_q = offset * pow(g_N, q, p) % p
        trace_row = trace_rows[qi]
        comp_row = comp_rows[qi]

        # recompute DEEP value at q
        inv_xz = F.inv((x_q - z) % p)
        inv_xzg = F.inv((x_q - zg) % p)
        deep_val = 0
        for i in range(w):
            deep_val = (deep_val + gammas[i] * ((trace_row[i] - ood_cur[i]) % p) % p * inv_xz) % p
            deep_val = (deep_val + gammas[w + i] * ((trace_row[i] - ood_nxt[i]) % p) % p * inv_xzg) % p
        for j in range(k):
            deep_val = (deep_val + gammas[2 * w + j] * ((comp_row[j] - ood_comp[j]) % p) % p * inv_xz) % p

        # walk FRI layers
        q_l = q
        cur_val = deep_val
        cur_offset = offset
        for li, size_l in enumerate(layer_sizes):
            f = opts.folding
            stride = size_l // f
            r = q_l % stride
            t_idx = q_l // stride
            row = fri_layer_rows[li][r]
            if row[t_idx] != cur_val:
                return False
            g_cur = F.root_of_unity(size_l)
            eta = pow(g_cur, stride, p)
            x0 = cur_offset * pow(g_cur, r, p) % p
            pts = [x0 * pow(eta, t, p) % p for t in range(f)]
            cur_val = _lagrange_eval(F, pts, row, fri_betas[li])
            cur_offset = pow(cur_offset, f, p)
            q_l = r
        # final: against the remainder polynomial over the last domain
        g_fin = F.root_of_unity(final_size)
        x_fin = cur_offset * pow(g_fin, q_l, p) % p
        if poly_eval(F, remainder, x_fin) != cur_val:
            return False

    return True


class ImprovementAir(Air):
    """Linear interpolation from ``old`` to ``new`` over the trace."""

    field = F128

    def __init__(self, old: int, new: int):
        super().__init__(TRACE_LENGTH, 1, [old, new], OPTIONS)
        F = self.field
        self.step_size = F.div(F.sub(new % F.p, old % F.p), (TRACE_LENGTH - 1) % F.p)

    def transition_degrees(self) -> List[int]:
        return [1]

    def evaluate_transition(self, current: List[int], nxt: List[int]) -> List[int]:
        F = self.field
        return [F.sub(F.sub(nxt[0], current[0]), self.step_size)]

    def get_assertions(self) -> List[Tuple[int, int, int]]:
        return [(0, 0, self.pub_inputs[0] % self.field.p),
                (0, self.trace_length - 1, self.pub_inputs[1] % self.field.p)]


TRACE_LENGTH = 8
OPTIONS = ProofOptions(num_queries=32, blowup=8, grinding=0, folding=8, max_remainder_degree=31)


def verify_improvement(proof_bytes: bytes, old: int, new: int) -> bool:
    if not (0 <= old < 1 << 64 and 0 <= new < 1 << 64):
        return False
    return verify(ImprovementAir(old, new), proof_bytes)
