"""STARK proof system (DEEP-ALI + FRI) over f128, Blake3 Merkle commitments.

Port of the JAX package's ``libzkp_tpu/models/stark.py``, its rebuild of the
reference's winterfell-based STARK backend (the reference's stark.rs): the
same AIR interface (a trace of power-of-two length, transition constraints,
boundary assertions), the same parameters (``ProofOptions::new(32, 8, 0,
None, 8, 31)``, stark.rs:94-102), field (f128) and hash (Blake3-256). The
pipeline is winterfell's (trace LDE -> Merkle commit -> constraint
composition -> DEEP -> FRI -> queries); proof bytes are a winterfell 0.10
``Proof`` container (:mod:`.winterfell_wire`).

:func:`prove` runs on the host's Python ints and the native tier's NTT and
BLAKE3; its ``precomputed`` argument takes a trace's coefficients, LDE and
leaf digests from the card's batch program (``ops/stark_device.py``).
:func:`verify` is the Python verifier, the golden of the native one.
"""

from __future__ import annotations

import functools
import struct
from dataclasses import dataclass
from typing import List, Optional, Sequence, Tuple

from ..ops import ntt as poly
from ..ops.field import F128, PrimeField
from . import winterfell_wire as ww
from .merkle import MerkleTree, hash_element_rows, hash_elements
from .random_coin import RandomCoin

# LDE coset offset; any element outside the 2-adic subgroups works. We pin 3
# (asserted at prove time via offset^N != 1).
DOMAIN_OFFSET = 3



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


# ---------------------------------------------------------------------------
# Serialization helpers
# ---------------------------------------------------------------------------


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


# ---------------------------------------------------------------------------
# Prover
# ---------------------------------------------------------------------------


@functools.lru_cache(maxsize=32)
def _domain_ctx(F: PrimeField, n: int, N: int, offset: int, steps: Tuple[int, ...]):
    """Proof-independent evaluation-domain constants, cached per AIR shape.

    xs (the coset points), the inverted transition zerofier with its
    last-step exemption folded in, and the inverted boundary zerofiers for
    the assertion steps depend only on (field, trace shape, offset) — one
    proof pays for them, every later proof of the same shape reuses them.
    """
    p = F.p
    g_n = F.root_of_unity(n)
    g_N = F.root_of_unity(N)
    xs = [offset % p]
    for _ in range(N - 1):
        xs.append(xs[-1] * g_N % p)
    exemption = pow(g_n, n - 1, p)
    zerofier_den = []
    for x in xs:
        xn = x
        m = n
        while m > 1:  # n is a power of two: square-chain instead of pow()
            xn = xn * xn % p
            m >>= 1
        zerofier_den.append((xn - 1) % p)
    inv_zerofier = F.batch_inv(zerofier_den)
    zinv = [inv_zerofier[r] * ((xs[r] - exemption) % p) % p for r in range(N)]
    inv_boundary = []
    for step in steps:
        pt = pow(g_n, step, p)
        inv_boundary.append(F.batch_inv([(x - pt) % p for x in xs]))
    return xs, zinv, inv_boundary


def prove(air: Air, trace_columns: List[List[int]], precomputed=None) -> bytes:
    """``precomputed``: optional (trace_polys, trace_lde) pair, or with the
    trace's leaf digests a triple: the batch prover computes those for many
    proofs at once on the device (``ops/stark_device.py``)."""
    F = air.field
    p = F.p
    n = air.trace_length
    w = air.trace_width
    opts = air.options
    N = n * opts.blowup
    assert len(trace_columns) == w and all(len(c) == n for c in trace_columns)

    g_n = F.root_of_unity(n)
    g_N = F.root_of_unity(N)
    offset = DOMAIN_OFFSET
    assert pow(offset, N, p) != 1, "domain offset lies in the LDE subgroup"

    # 1. trace polynomials + LDE (optionally with device-precomputed
    #    leaf digests: the fused LDE+commit program, ops/stark_device.py)
    trace_leaves = None
    if precomputed is not None:
        if len(precomputed) == 3:
            trace_polys, trace_lde, trace_leaves = precomputed
        else:
            trace_polys, trace_lde = precomputed
    else:
        trace_polys = [poly.interpolate(F, col) for col in trace_columns]
        trace_lde = [poly.evaluate_coset(F, c, N, offset) for c in trace_polys]

    # 2. trace commitment
    if trace_leaves is None:
        trace_leaves = hash_element_rows(
            F, [[trace_lde[i][r] for i in range(w)] for r in range(N)]
        )
    trace_tree = MerkleTree(trace_leaves)

    coin = RandomCoin(air.context_bytes())
    coin.reseed(trace_tree.root)

    # 3. constraint composition coefficients
    t_degrees = air.transition_degrees()
    assertions = air.get_assertions()
    alphas = coin.draw_felts(F, len(t_degrees))
    betas = coin.draw_felts(F, len(assertions))

    # 4. composition evaluations over the LDE domain (cached domain consts)
    xs, zinv_all, inv_boundary = _domain_ctx(
        F, n, N, offset, tuple(step for (_, step, _) in assertions)
    )

    comp_evals = []
    for r in range(N):
        cur = [trace_lde[i][r] for i in range(w)]
        nxt = [trace_lde[i][(r + opts.blowup) % N] for i in range(w)]
        t_evals = air.evaluate_transition(cur, nxt)
        acc = 0
        zinv = zinv_all[r]
        for a, ev in zip(alphas, t_evals):
            acc = (acc + a * ev % p * zinv) % p
        for j, (col, _, value) in enumerate(assertions):
            acc = (acc + betas[j] * ((cur[col] - value) % p) % p * inv_boundary[j][r]) % p
        comp_evals.append(acc)

    comp_coeffs = poly.interpolate_coset(F, comp_evals, offset)
    k = air.num_composition_columns()
    deg = poly.poly_degree(comp_coeffs)
    assert deg < k * n, f"composition degree {deg} exceeds {k}*{n}"
    comp_chunks = [comp_coeffs[j * n : (j + 1) * n] for j in range(k)]
    comp_chunks = [c + [0] * (n - len(c)) for c in comp_chunks]
    comp_lde = [poly.evaluate_coset(F, c, N, offset) for c in comp_chunks]
    comp_leaves = hash_element_rows(F, [[comp_lde[j][r] for j in range(k)] for r in range(N)])
    comp_tree = MerkleTree(comp_leaves)
    coin.reseed(comp_tree.root)

    # 5. OOD evaluations
    z = coin.draw_felt(F)
    zg = z * g_n % p
    ood_cur = [poly.poly_eval(F, c, z) for c in trace_polys]
    ood_nxt = [poly.poly_eval(F, c, zg) for c in trace_polys]
    ood_comp = [poly.poly_eval(F, c, z) for c in comp_chunks]
    coin.reseed(hash_elements(F, ood_cur + ood_nxt + ood_comp))

    # 6. DEEP composition
    gammas = coin.draw_felts(F, 2 * w + k)
    inv_xz = F.batch_inv([(x - z) % p for x in xs])
    inv_xzg = F.batch_inv([(x - zg) % p for x in xs])
    deep = []
    for r in range(N):
        acc = 0
        for i in range(w):
            acc = (acc + gammas[i] * ((trace_lde[i][r] - ood_cur[i]) % p) % p * inv_xz[r]) % p
            acc = (acc + gammas[w + i] * ((trace_lde[i][r] - ood_nxt[i]) % p) % p * inv_xzg[r]) % p
        for j in range(k):
            acc = (acc + gammas[2 * w + j] * ((comp_lde[j][r] - ood_comp[j]) % p) % p * inv_xz[r]) % p
        deep.append(acc)

    # 7. FRI commit phase
    layer_sizes = _fri_layer_plan(opts, N)
    fri_trees: List[MerkleTree] = []
    fri_rows: List[List[List[int]]] = []
    fri_betas: List[int] = []
    evals = deep
    cur_offset = offset
    cur_size = N
    for _size in layer_sizes:
        f = opts.folding
        stride = cur_size // f
        rows = [[evals[r + t * stride] for t in range(f)] for r in range(stride)]
        tree = MerkleTree(hash_element_rows(F, rows))
        fri_trees.append(tree)
        fri_rows.append(rows)
        coin.reseed(tree.root)
        beta = coin.draw_felt(F)
        fri_betas.append(beta)
        g_cur = F.root_of_unity(cur_size)
        eta = pow(g_cur, stride, p)  # folding-th root of unity
        new_evals = []
        for r in range(stride):
            x0 = cur_offset * pow(g_cur, r, p) % p
            pts = [x0 * pow(eta, t, p) % p for t in range(f)]
            new_evals.append(_lagrange_eval(F, pts, rows[r], beta))
        evals = new_evals
        cur_offset = pow(cur_offset, f, p)
        cur_size = stride

    remainder = poly.interpolate_coset(F, evals, cur_offset)
    rem_deg = poly.poly_degree(remainder)
    assert rem_deg <= opts.max_remainder_degree, "FRI remainder degree too high"
    remainder = remainder[: opts.max_remainder_degree + 1]
    coin.reseed(hash_elements(F, remainder))

    # 8. proof-of-work + query positions
    nonce = 0
    while not coin.check_leading_zeros(nonce, opts.grinding):
        nonce += 1
    positions = coin.draw_integers(opts.num_queries, N, nonce)

    # 9. serialize as a winterfell 0.10 Proof (see winterfell_wire field map)
    buf = bytearray()
    ww.write_context(buf, w, n, p, opts)
    buf.append(len(positions))  # num_unique_queries
    ww.write_commitments(
        buf, [trace_tree.root, comp_tree.root] + [t.root for t in fri_trees]
    )

    def _rows_bytes(lde, width, qs):
        out = bytearray()
        for q in qs:
            for i in range(width):
                out += int(lde[i][q]).to_bytes(F.nbytes, "little")
        return bytes(out)

    # trace segments: Vec<Queries> with one (main) segment
    ww.write_usize(buf, 1)
    ww.write_queries(
        buf,
        ww.batch_proof_nodes(trace_tree, positions),
        _rows_bytes(trace_lde, w, positions),
    )
    # constraint segment queries
    ww.write_queries(
        buf,
        ww.batch_proof_nodes(comp_tree, positions),
        _rows_bytes(comp_lde, k, positions),
    )
    # OOD frame: current ‖ next trace rows, then composition evaluations
    felt = lambda vs: b"".join(int(v).to_bytes(F.nbytes, "little") for v in vs)
    ww.write_ood_frame(buf, felt(ood_cur + ood_nxt), felt(ood_comp))
    # FRI proof
    fri_layers = []
    cur_positions = list(positions)
    for li, size_l in enumerate(layer_sizes):
        stride = size_l // opts.folding
        fold_positions = sorted(set(q % stride for q in cur_positions))
        values = b"".join(felt(fri_rows[li][r]) for r in fold_positions)
        paths = ww.batch_proof_nodes(fri_trees[li], fold_positions)
        fri_layers.append((values, paths))
        cur_positions = fold_positions
    ww.write_fri_proof(buf, fri_layers, felt(remainder))
    buf += nonce.to_bytes(8, "little")
    return bytes(buf)


# ---------------------------------------------------------------------------
# Verifier
# ---------------------------------------------------------------------------


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
        if poly.poly_eval(F, remainder, x_fin) != cur_val:
            return False

    return True
