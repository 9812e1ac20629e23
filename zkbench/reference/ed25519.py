"""Curve25519 / Ristretto255 group in pure Python.

Frozen copy of the port's host golden tier: Edwards point arithmetic
(extended coordinates, a=-1), Ristretto255 encode/decode per RFC 9496,
Elligator hash-to-group (``from_uniform_bytes``), scalars mod l and a
Pippenger MSM. No native tier and no device.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple


P = (1 << 255) - 19  # Curve25519 base field
L = (1 << 252) + 27742317777372353535851937790883648493  # Ristretto255 group order

# Twisted Edwards: -x^2 + y^2 = 1 + d x^2 y^2
D = (-121665 * pow(121666, -1, P)) % P
TWO_D = 2 * D % P
SQRT_M1 = pow(2, (P - 1) // 4, P)
if SQRT_M1 & 1:
    SQRT_M1 = P - SQRT_M1  # canonical: dalek uses the even sqrt(-1)
assert SQRT_M1 * SQRT_M1 % P == P - 1


def _is_negative(x: int) -> bool:
    return (x % P) & 1 == 1


def _abs(x: int) -> int:
    x %= P
    return P - x if _is_negative(x) else x


def sqrt_ratio_m1(u: int, v: int) -> Tuple[bool, int]:
    """(was_square, r) with r = sqrt(u/v) or sqrt(SQRT_M1 * u/v), r non-negative.

    RFC 9496 SQRT_RATIO_M1.
    """
    v3 = v * v % P * v % P
    v7 = v3 * v3 % P * v % P
    r = u * v3 % P * pow(u * v7 % P, (P - 5) // 8, P) % P
    check = v * r % P * r % P
    u_mod = u % P
    correct = check == u_mod
    flipped = check == (P - u_mod) % P
    flipped_i = check == (P - u_mod) * SQRT_M1 % P
    if flipped or flipped_i:
        r = r * SQRT_M1 % P
    r = _abs(r)
    return (correct or flipped), r


INVSQRT_A_MINUS_D = sqrt_ratio_m1(1, (P - 1 - D) % P)[1]
ONE_MINUS_D_SQ = (1 - D * D) % P
D_MINUS_ONE_SQ = (D - 1) * (D - 1) % P
# dalek pins the *negative* (odd) root for sqrt(a*d - 1) = sqrt(-(d+1)).
SQRT_AD_MINUS_ONE = P - sqrt_ratio_m1((P - (D + 1)) % P, 1)[1]
assert SQRT_AD_MINUS_ONE * SQRT_AD_MINUS_ONE % P == (P - (D + 1)) % P


Point = Tuple[int, int, int, int]  # extended (X, Y, Z, T), T = XY/Z

IDENTITY: Point = (0, 1, 1, 0)


def point_add(p1: Point, p2: Point) -> Point:
    """Unified addition, add-2008-hwcd-3 for a=-1 (works for doubling)."""
    X1, Y1, Z1, T1 = p1
    X2, Y2, Z2, T2 = p2
    A = (Y1 - X1) * (Y2 - X2) % P
    B = (Y1 + X1) * (Y2 + X2) % P
    C = T1 * TWO_D % P * T2 % P
    Dv = 2 * Z1 % P * Z2 % P
    E = (B - A) % P
    F = (Dv - C) % P
    G = (Dv + C) % P
    H = (B + A) % P
    return (E * F % P, G * H % P, F * G % P, E * H % P)


def point_double(p1: Point) -> Point:
    """dbl-2008-hwcd for a=-1."""
    X1, Y1, Z1, _ = p1
    A = X1 * X1 % P
    B = Y1 * Y1 % P
    C = 2 * Z1 % P * Z1 % P
    H = (A + B) % P
    E = (H - (X1 + Y1) * (X1 + Y1)) % P
    G = (A - B) % P
    F = (C + G) % P
    return (E * F % P, G * H % P, F * G % P, E * H % P)


def point_neg(p1: Point) -> Point:
    X, Y, Z, T = p1
    return ((P - X) % P, Y, Z, (P - T) % P)


def point_equal(p1: Point, p2: Point) -> bool:
    """Projective equality X1/Z1 == X2/Z2 and Y1/Z1 == Y2/Z2."""
    X1, Y1, Z1, _ = p1
    X2, Y2, Z2, _ = p2
    return (X1 * Z2 - X2 * Z1) % P == 0 and (Y1 * Z2 - Y2 * Z1) % P == 0


def scalar_mul_py(k: int, p1: Point) -> Point:
    """Double-and-add with a simple 4-bit fixed window."""
    k %= L
    if k == 0:
        return IDENTITY
    table = [IDENTITY, p1]
    for _ in range(14):
        table.append(point_add(table[-1], p1))
    acc = IDENTITY
    nibbles = []
    while k:
        nibbles.append(k & 0xF)
        k >>= 4
    for nib in reversed(nibbles):
        for _ in range(4):
            acc = point_double(acc)
        if nib:
            acc = point_add(acc, table[nib])
    return acc


def msm_py(scalars: Sequence[int], points: Sequence[Point], window: int = 6) -> Point:
    """Pippenger multi-scalar multiplication (host golden model)."""
    assert len(scalars) == len(points)
    pairs = [(s % L, pt) for s, pt in zip(scalars, points) if s % L != 0]
    if not pairs:
        return IDENTITY
    scalars = [s for s, _ in pairs]
    points = [pt for _, pt in pairs]
    nbits = 253
    nwin = (nbits + window - 1) // window
    acc = IDENTITY
    for w in range(nwin - 1, -1, -1):
        for _ in range(window):
            acc = point_double(acc)
        buckets: dict = {}
        shift = w * window
        mask = (1 << window) - 1
        for s, pt in zip(scalars, points):
            idx = (s >> shift) & mask
            if idx:
                buckets[idx] = point_add(buckets[idx], pt) if idx in buckets else pt
        # running-sum bucket reduction
        running = IDENTITY
        total = IDENTITY
        for idx in range(mask, 0, -1):
            if idx in buckets:
                running = point_add(running, buckets[idx])
            total = point_add(total, running)
        acc = point_add(acc, total)
    return acc


scalar_mul = scalar_mul_py
msm = msm_py


# ---------------------------------------------------------------------------
# Ristretto255 encode / decode / hash-to-group (RFC 9496)
# ---------------------------------------------------------------------------


def compress_py(p1: Point) -> bytes:
    X, Y, Z, T = p1
    u1 = (Z + Y) * (Z - Y) % P
    u2 = X * Y % P
    _, invsqrt = sqrt_ratio_m1(1, u1 * u2 % P * u2 % P)
    den1 = invsqrt * u1 % P
    den2 = invsqrt * u2 % P
    z_inv = den1 * den2 % P * T % P
    ix = X * SQRT_M1 % P
    iy = Y * SQRT_M1 % P
    enchanted = den1 * INVSQRT_A_MINUS_D % P
    rotate = _is_negative(T * z_inv % P)
    if rotate:
        X, Y = iy, ix
        den_inv = enchanted
    else:
        den_inv = den2
    if _is_negative(X * z_inv % P):
        Y = (P - Y) % P
    s = den_inv * ((Z - Y) % P) % P
    s = _abs(s)
    return s.to_bytes(32, "little")


def decompress_py(data: bytes) -> Optional[Point]:
    if len(data) != 32:
        return None
    s = int.from_bytes(data, "little")
    if s >= P or _is_negative(s):
        return None
    ss = s * s % P
    u1 = (1 - ss) % P
    u2 = (1 + ss) % P
    u2_sqr = u2 * u2 % P
    v = (P - (D * u1 % P * u1 % P) - u2_sqr) % P
    was_square, invsqrt = sqrt_ratio_m1(1, v * u2_sqr % P)
    den_x = invsqrt * u2 % P
    den_y = invsqrt * den_x % P * v % P
    x = _abs((s + s) * den_x % P)
    y = u1 * den_y % P
    t = x * y % P
    if not was_square or _is_negative(t) or y == 0:
        return None
    return (x, y, 1, t)


compress = compress_py
decompress = decompress_py


def ristretto_eq(p1: Point, p2: Point) -> bool:
    """Ristretto group equality: X1*Y2 == Y1*X2 or X1*X2 == Y1*Y2."""
    X1, Y1, _, _ = p1
    X2, Y2, _, _ = p2
    return (X1 * Y2 - Y1 * X2) % P == 0 or (X1 * X2 - Y1 * Y2) % P == 0


def _elligator_map(r0: int) -> Point:
    """RFC 9496 MAP function."""
    r = SQRT_M1 * r0 % P * r0 % P
    Ns = (r + 1) % P * ONE_MINUS_D_SQ % P
    c = P - 1
    Dv = (c - D * r) % P * ((r + D) % P) % P
    ns_d_is_sq, s = sqrt_ratio_m1(Ns, Dv)
    s_prime = (P - _abs(s * r0 % P)) % P
    if not ns_d_is_sq:
        s = s_prime
        c = r
    Nt = (c * ((r - 1) % P) % P * D_MINUS_ONE_SQ - Dv) % P
    W0 = 2 * s % P * Dv % P
    W1 = Nt * SQRT_AD_MINUS_ONE % P
    W2 = (1 - s * s) % P
    W3 = (1 + s * s) % P
    return (W0 * W3 % P, W2 * W1 % P, W1 * W3 % P, W0 * W2 % P)


def from_uniform_bytes(data: bytes) -> Point:
    """Hash-to-group on 64 uniform bytes (dalek ``from_uniform_bytes``)."""
    assert len(data) == 64
    r1 = int.from_bytes(data[0:32], "little") & ((1 << 255) - 1)
    r2 = int.from_bytes(data[32:64], "little") & ((1 << 255) - 1)
    return point_add(_elligator_map(r1 % P), _elligator_map(r2 % P))


# ---------------------------------------------------------------------------
# Scalars mod l
# ---------------------------------------------------------------------------


def scalar_from_bytes_mod_order(data: bytes) -> int:
    assert len(data) == 32
    return int.from_bytes(data, "little") % L


def scalar_from_bytes_mod_order_wide(data: bytes) -> int:
    assert len(data) == 64
    return int.from_bytes(data, "little") % L


def scalar_to_bytes(s: int) -> bytes:
    return (s % L).to_bytes(32, "little")


def scalar_from_canonical_bytes(data: bytes) -> Optional[int]:
    if len(data) != 32:
        return None
    v = int.from_bytes(data, "little")
    return v if v < L else None


# ---------------------------------------------------------------------------
# Basepoint
# ---------------------------------------------------------------------------

_BASE_Y = 4 * pow(5, -1, P) % P
_BASE_X = 15112221349535400772501151409588531511454012693041857206046113283949847762202
BASEPOINT: Point = (_BASE_X, _BASE_Y, 1, _BASE_X * _BASE_Y % P)
RISTRETTO_BASEPOINT_COMPRESSED = compress_py(BASEPOINT)
