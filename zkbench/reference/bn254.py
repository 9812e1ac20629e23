"""BN254 (alt_bn128) curve in pure Python: tower fields, G1/G2, the
optimal-ate pairing.

Frozen copy of the port's host golden tier (Fq/Fq2/Fq6/Fq12, Jacobian
G1/G2, scalar multiplication, Pippenger MSM, the multi-pairing), with no
native tier and no device.

Tower: Fq2 = Fq[u]/(u^2+1); Fq6 = Fq2[v]/(v^3 - xi), xi = 9+u;
Fq12 = Fq6[w]/(w^2 - v).
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

from .field import BN254_FQ, BN254_FR

P = BN254_FQ.p
R = BN254_FR.p

# curve: y^2 = x^3 + 3 over Fq; G2 twist: y^2 = x^3 + 3/(9+u) over Fq2
B_G1 = 3
BN_X = 4965661367192848881  # BN parameter x
ATE_LOOP_COUNT = 6 * BN_X + 2

G1_GEN = (1, 2)

G2_GEN_X = (
    10857046999023057135944570762232829481370756359578518086990519993285655852781,
    11559732032986387107991004021392285783925812861821192530917403151452391805634,
)
G2_GEN_Y = (
    8495653923123431417604973247489272438418190587263600148770280649306958101930,
    4082367875863433681332203403145435568316851327593401208105741076214120093531,
)

Fq2 = Tuple[int, int]


# ---------------------------------------------------------------------------
# Fq2
# ---------------------------------------------------------------------------

def fq2_add(a: Fq2, b: Fq2) -> Fq2:
    return ((a[0] + b[0]) % P, (a[1] + b[1]) % P)


def fq2_sub(a: Fq2, b: Fq2) -> Fq2:
    return ((a[0] - b[0]) % P, (a[1] - b[1]) % P)


def fq2_neg(a: Fq2) -> Fq2:
    return ((P - a[0]) % P, (P - a[1]) % P)


def fq2_mul(a: Fq2, b: Fq2) -> Fq2:
    a0, a1 = a
    b0, b1 = b
    t0 = a0 * b0 % P
    t1 = a1 * b1 % P
    return ((t0 - t1) % P, ((a0 + a1) * (b0 + b1) - t0 - t1) % P)


def fq2_sq(a: Fq2) -> Fq2:
    a0, a1 = a
    return ((a0 + a1) * (a0 - a1) % P, 2 * a0 * a1 % P)


def fq2_mul_scalar(a: Fq2, k: int) -> Fq2:
    return (a[0] * k % P, a[1] * k % P)


def fq2_inv(a: Fq2) -> Fq2:
    a0, a1 = a
    norm = (a0 * a0 + a1 * a1) % P
    ninv = pow(norm, -1, P)
    return (a0 * ninv % P, (P - a1) * ninv % P)


def fq2_conj(a: Fq2) -> Fq2:
    return (a[0], (P - a[1]) % P)


def fq2_pow(a: Fq2, e: int) -> Fq2:
    result = (1, 0)
    base = a
    while e:
        if e & 1:
            result = fq2_mul(result, base)
        base = fq2_sq(base)
        e >>= 1
    return result


XI: Fq2 = (9, 1)
B_G2: Fq2 = fq2_mul_scalar(fq2_inv(XI), 3)

FQ2_ZERO: Fq2 = (0, 0)
FQ2_ONE: Fq2 = (1, 0)


def fq2_mul_by_xi(a: Fq2) -> Fq2:
    # (9 + u) * (a0 + a1 u) = (9 a0 - a1) + (9 a1 + a0) u
    return ((9 * a[0] - a[1]) % P, (9 * a[1] + a[0]) % P)


# ---------------------------------------------------------------------------
# Fq6 = Fq2[v]/(v^3 - xi): elements (c0, c1, c2)
# ---------------------------------------------------------------------------

Fq6 = Tuple[Fq2, Fq2, Fq2]
FQ6_ZERO: Fq6 = (FQ2_ZERO, FQ2_ZERO, FQ2_ZERO)
FQ6_ONE: Fq6 = (FQ2_ONE, FQ2_ZERO, FQ2_ZERO)


def fq6_add(a: Fq6, b: Fq6) -> Fq6:
    return (fq2_add(a[0], b[0]), fq2_add(a[1], b[1]), fq2_add(a[2], b[2]))


def fq6_sub(a: Fq6, b: Fq6) -> Fq6:
    return (fq2_sub(a[0], b[0]), fq2_sub(a[1], b[1]), fq2_sub(a[2], b[2]))


def fq6_neg(a: Fq6) -> Fq6:
    return (fq2_neg(a[0]), fq2_neg(a[1]), fq2_neg(a[2]))


def fq6_mul(a: Fq6, b: Fq6) -> Fq6:
    a0, a1, a2 = a
    b0, b1, b2 = b
    t0 = fq2_mul(a0, b0)
    t1 = fq2_mul(a1, b1)
    t2 = fq2_mul(a2, b2)
    c0 = fq2_add(
        t0,
        fq2_mul_by_xi(
            fq2_sub(fq2_sub(fq2_mul(fq2_add(a1, a2), fq2_add(b1, b2)), t1), t2)
        ),
    )
    c1 = fq2_add(
        fq2_sub(fq2_sub(fq2_mul(fq2_add(a0, a1), fq2_add(b0, b1)), t0), t1),
        fq2_mul_by_xi(t2),
    )
    c2 = fq2_add(
        fq2_sub(fq2_sub(fq2_mul(fq2_add(a0, a2), fq2_add(b0, b2)), t0), t2), t1
    )
    return (c0, c1, c2)


def fq6_sq(a: Fq6) -> Fq6:
    return fq6_mul(a, a)


def fq6_mul_by_v(a: Fq6) -> Fq6:
    """Multiply by v: (c0, c1, c2) -> (xi*c2, c0, c1)."""
    return (fq2_mul_by_xi(a[2]), a[0], a[1])


def fq6_inv(a: Fq6) -> Fq6:
    a0, a1, a2 = a
    t0 = fq2_sub(fq2_sq(a0), fq2_mul_by_xi(fq2_mul(a1, a2)))
    t1 = fq2_sub(fq2_mul_by_xi(fq2_sq(a2)), fq2_mul(a0, a1))
    t2 = fq2_sub(fq2_sq(a1), fq2_mul(a0, a2))
    denom = fq2_add(
        fq2_add(fq2_mul(a0, t0), fq2_mul_by_xi(fq2_mul(a2, t1))),
        fq2_mul_by_xi(fq2_mul(a1, t2)),
    )
    dinv = fq2_inv(denom)
    return (fq2_mul(t0, dinv), fq2_mul(t1, dinv), fq2_mul(t2, dinv))


# ---------------------------------------------------------------------------
# Fq12 = Fq6[w]/(w^2 - v): elements (c0, c1)
# ---------------------------------------------------------------------------

Fq12 = Tuple[Fq6, Fq6]
FQ12_ONE: Fq12 = (FQ6_ONE, FQ6_ZERO)


def fq12_mul(a: Fq12, b: Fq12) -> Fq12:
    a0, a1 = a
    b0, b1 = b
    t0 = fq6_mul(a0, b0)
    t1 = fq6_mul(a1, b1)
    c0 = fq6_add(t0, fq6_mul_by_v(t1))
    c1 = fq6_sub(fq6_sub(fq6_mul(fq6_add(a0, a1), fq6_add(b0, b1)), t0), t1)
    return (c0, c1)


def fq12_sq(a: Fq12) -> Fq12:
    return fq12_mul(a, a)


def fq12_inv(a: Fq12) -> Fq12:
    a0, a1 = a
    denom = fq6_sub(fq6_sq(a0), fq6_mul_by_v(fq6_sq(a1)))
    dinv = fq6_inv(denom)
    return (fq6_mul(a0, dinv), fq6_neg(fq6_mul(a1, dinv)))


def fq12_conj(a: Fq12) -> Fq12:
    return (a[0], fq6_neg(a[1]))


def fq12_pow(a: Fq12, e: int) -> Fq12:
    result = FQ12_ONE
    base = a
    while e:
        if e & 1:
            result = fq12_mul(result, base)
        base = fq12_sq(base)
        e >>= 1
    return result


# Frobenius coefficients: gamma_1[i] = xi^((p-1)*i/6) for i in 1..5 (in Fq2)
_FROB_GAMMA1: List[Fq2] = [fq2_pow(XI, i * (P - 1) // 6) for i in range(6)]


def fq2_frob(a: Fq2) -> Fq2:
    return fq2_conj(a)


def fq6_frob(a: Fq6) -> Fq6:
    return (
        fq2_frob(a[0]),
        fq2_mul(fq2_frob(a[1]), _FROB_GAMMA1[2]),
        fq2_mul(fq2_frob(a[2]), _FROB_GAMMA1[4]),
    )


def fq12_frob(a: Fq12) -> Fq12:
    # basis: c0 holds w^0, w^2, w^4 and c1 holds w^1, w^3, w^5; frobenius maps
    # (c w^i)^p = conj(c) gamma^i w^i with gamma = xi^((p-1)/6).
    c0 = fq6_frob(a[0])
    b0, b1, b2 = a[1]
    c1 = (
        fq2_mul(fq2_conj(b0), _FROB_GAMMA1[1]),
        fq2_mul(fq2_conj(b1), _FROB_GAMMA1[3]),
        fq2_mul(fq2_conj(b2), _FROB_GAMMA1[5]),
    )
    return (c0, c1)


# ---------------------------------------------------------------------------
# G1 (Jacobian over Fq)
# ---------------------------------------------------------------------------

G1 = Tuple[int, int, int]  # Jacobian (X, Y, Z); Z=0 -> infinity
G1_INF: G1 = (1, 1, 0)


def g1_from_affine(p: Tuple[int, int]) -> G1:
    return (p[0], p[1], 1)


def g1_is_inf(p: G1) -> bool:
    return p[2] == 0


def g1_to_affine(p: G1) -> Optional[Tuple[int, int]]:
    if g1_is_inf(p):
        return None
    zi = pow(p[2], -1, P)
    zi2 = zi * zi % P
    return (p[0] * zi2 % P, p[1] * zi2 % P * zi % P)


def g1_double(p: G1) -> G1:
    X1, Y1, Z1 = p
    if Z1 == 0 or Y1 == 0:
        return G1_INF if Y1 == 0 else p
    A = X1 * X1 % P
    B = Y1 * Y1 % P
    C = B * B % P
    D = 2 * ((X1 + B) * (X1 + B) - A - C) % P
    E = 3 * A % P
    F = E * E % P
    X3 = (F - 2 * D) % P
    Y3 = (E * (D - X3) - 8 * C) % P
    Z3 = 2 * Y1 * Z1 % P
    return (X3, Y3, Z3)


def g1_add(p: G1, q: G1) -> G1:
    if p[2] == 0:
        return q
    if q[2] == 0:
        return p
    X1, Y1, Z1 = p
    X2, Y2, Z2 = q
    Z1Z1 = Z1 * Z1 % P
    Z2Z2 = Z2 * Z2 % P
    U1 = X1 * Z2Z2 % P
    U2 = X2 * Z1Z1 % P
    S1 = Y1 * Z2 % P * Z2Z2 % P
    S2 = Y2 * Z1 % P * Z1Z1 % P
    if U1 == U2:
        if S1 != S2:
            return G1_INF
        return g1_double(p)
    H = (U2 - U1) % P
    I = 4 * H * H % P
    J = H * I % P
    r = 2 * (S2 - S1) % P
    V = U1 * I % P
    X3 = (r * r - J - 2 * V) % P
    Y3 = (r * (V - X3) - 2 * S1 * J) % P
    Z3 = ((Z1 + Z2) * (Z1 + Z2) - Z1Z1 - Z2Z2) % P * H % P
    return (X3, Y3, Z3)


def g1_neg(p: G1) -> G1:
    return (p[0], (P - p[1]) % P, p[2])


def g1_scalar_mul_py(k: int, p: G1) -> G1:
    k %= R
    acc = G1_INF
    while k:
        if k & 1:
            acc = g1_add(acc, p)
        p = g1_double(p)
        k >>= 1
    return acc


def g1_msm_py(scalars: Sequence[int], points: Sequence[G1], window: int = 6) -> G1:
    """Pippenger MSM over G1 (the golden)."""
    pairs = [(s % R, pt) for s, pt in zip(scalars, points) if s % R != 0 and pt[2] != 0]
    if not pairs:
        return G1_INF
    nbits = 254
    nwin = (nbits + window - 1) // window
    acc = G1_INF
    mask = (1 << window) - 1
    for w in range(nwin - 1, -1, -1):
        for _ in range(window):
            acc = g1_double(acc)
        buckets: dict = {}
        shift = w * window
        for s, pt in pairs:
            idx = (s >> shift) & mask
            if idx:
                buckets[idx] = g1_add(buckets[idx], pt) if idx in buckets else pt
        running = G1_INF
        total = G1_INF
        for idx in range(mask, 0, -1):
            if idx in buckets:
                running = g1_add(running, buckets[idx])
            total = g1_add(total, running)
        acc = g1_add(acc, total)
    return acc


def g1_is_on_curve(p: G1) -> bool:
    if g1_is_inf(p):
        return True
    aff = g1_to_affine(p)
    x, y = aff
    return (y * y - x * x * x - B_G1) % P == 0


# ---------------------------------------------------------------------------
# G2 (Jacobian over Fq2)
# ---------------------------------------------------------------------------

G2 = Tuple[Fq2, Fq2, Fq2]
G2_INF: G2 = (FQ2_ONE, FQ2_ONE, FQ2_ZERO)


def g2_from_affine(xy: Tuple[Fq2, Fq2]) -> G2:
    return (xy[0], xy[1], FQ2_ONE)


def g2_is_inf(p: G2) -> bool:
    return p[2] == FQ2_ZERO


def g2_to_affine(p: G2) -> Optional[Tuple[Fq2, Fq2]]:
    if g2_is_inf(p):
        return None
    zi = fq2_inv(p[2])
    zi2 = fq2_sq(zi)
    return (fq2_mul(p[0], zi2), fq2_mul(fq2_mul(p[1], zi2), zi))


def g2_double(p: G2) -> G2:
    X1, Y1, Z1 = p
    if Z1 == FQ2_ZERO or Y1 == FQ2_ZERO:
        return G2_INF if Y1 == FQ2_ZERO else p
    A = fq2_sq(X1)
    B = fq2_sq(Y1)
    C = fq2_sq(B)
    D = fq2_mul_scalar(fq2_sub(fq2_sub(fq2_sq(fq2_add(X1, B)), A), C), 2)
    E = fq2_mul_scalar(A, 3)
    F = fq2_sq(E)
    X3 = fq2_sub(F, fq2_mul_scalar(D, 2))
    Y3 = fq2_sub(fq2_mul(E, fq2_sub(D, X3)), fq2_mul_scalar(C, 8))
    Z3 = fq2_mul_scalar(fq2_mul(Y1, Z1), 2)
    return (X3, Y3, Z3)


def g2_add(p: G2, q: G2) -> G2:
    if g2_is_inf(p):
        return q
    if g2_is_inf(q):
        return p
    X1, Y1, Z1 = p
    X2, Y2, Z2 = q
    Z1Z1 = fq2_sq(Z1)
    Z2Z2 = fq2_sq(Z2)
    U1 = fq2_mul(X1, Z2Z2)
    U2 = fq2_mul(X2, Z1Z1)
    S1 = fq2_mul(fq2_mul(Y1, Z2), Z2Z2)
    S2 = fq2_mul(fq2_mul(Y2, Z1), Z1Z1)
    if U1 == U2:
        if S1 != S2:
            return G2_INF
        return g2_double(p)
    H = fq2_sub(U2, U1)
    I = fq2_mul_scalar(fq2_sq(H), 4)
    J = fq2_mul(H, I)
    r = fq2_mul_scalar(fq2_sub(S2, S1), 2)
    V = fq2_mul(U1, I)
    X3 = fq2_sub(fq2_sub(fq2_sq(r), J), fq2_mul_scalar(V, 2))
    Y3 = fq2_sub(fq2_mul(r, fq2_sub(V, X3)), fq2_mul_scalar(fq2_mul(S1, J), 2))
    Z3 = fq2_mul(fq2_sub(fq2_sub(fq2_sq(fq2_add(Z1, Z2)), Z1Z1), Z2Z2), H)
    return (X3, Y3, Z3)


def g2_neg(p: G2) -> G2:
    return (p[0], fq2_neg(p[1]), p[2])


def g2_scalar_mul_py(k: int, p: G2) -> G2:
    k %= R
    acc = G2_INF
    while k:
        if k & 1:
            acc = g2_add(acc, p)
        p = g2_double(p)
        k >>= 1
    return acc


def g2_msm_py(scalars: Sequence[int], points: Sequence[G2], window: int = 6) -> G2:
    """Pippenger MSM over G2 (the golden)."""
    pairs = [
        (s % R, pt) for s, pt in zip(scalars, points) if s % R != 0 and not g2_is_inf(pt)
    ]
    if not pairs:
        return G2_INF
    nbits = 254
    nwin = (nbits + window - 1) // window
    acc = G2_INF
    mask = (1 << window) - 1
    for w in range(nwin - 1, -1, -1):
        for _ in range(window):
            acc = g2_double(acc)
        buckets: dict = {}
        shift = w * window
        for s, pt in pairs:
            idx = (s >> shift) & mask
            if idx:
                buckets[idx] = g2_add(buckets[idx], pt) if idx in buckets else pt
        running = G2_INF
        total = G2_INF
        for idx in range(mask, 0, -1):
            if idx in buckets:
                running = g2_add(running, buckets[idx])
            total = g2_add(total, running)
        acc = g2_add(acc, total)
    return acc


def g2_is_on_curve(p: G2) -> bool:
    if g2_is_inf(p):
        return True
    x, y = g2_to_affine(p)
    return fq2_sub(fq2_sq(y), fq2_add(fq2_mul(fq2_sq(x), x), B_G2)) == FQ2_ZERO


def g2_in_subgroup(p: G2) -> bool:
    """Whether ``p`` lies in the order-R subgroup: [R]p is the point at
    infinity. Every scalar multiplication here reduces its scalar mod R (so
    [R]p would be infinity for any p), hence [R - 1]p + p, on
    ``g2_scalar_mul``. The JAX package's check multiplies by R reduced and
    accepts every point of the twist."""
    return g2_is_inf(g2_add(g2_scalar_mul(R - 1, p), p))


# ---------------------------------------------------------------------------
# Optimal ate pairing (Miller loop with Fq12-lifted Q, affine lines)
# ---------------------------------------------------------------------------

# twist embedding: E'(Fq2) -> E(Fq12); for the D-type twist y^2 = x^3 + b/xi,
# (x', y') -> (x' * w^2, y' * w^3). We represent Fq12 points as pairs of Fq12.

_W2: Fq12 = ((FQ2_ZERO, FQ2_ONE, FQ2_ZERO), FQ6_ZERO)  # w^2 = v
_W3: Fq12 = (FQ6_ZERO, (FQ2_ZERO, FQ2_ONE, FQ2_ZERO))  # w^3 = v*w


def _fq2_to_fq12(a: Fq2) -> Fq12:
    return (((a[0], a[1]), FQ2_ZERO, FQ2_ZERO), FQ6_ZERO)


def _fq_to_fq12(a: int) -> Fq12:
    return (((a % P, 0), FQ2_ZERO, FQ2_ZERO), FQ6_ZERO)


def _twist(q_aff: Tuple[Fq2, Fq2]) -> Tuple[Fq12, Fq12]:
    x = fq12_mul(_fq2_to_fq12(q_aff[0]), _W2)
    y = fq12_mul(_fq2_to_fq12(q_aff[1]), _W3)
    return (x, y)


def fq12_sub(a: Fq12, b: Fq12) -> Fq12:
    return (fq6_sub(a[0], b[0]), fq6_sub(a[1], b[1]))


def fq12_is_zero(a: Fq12) -> bool:
    return a == (FQ6_ZERO, FQ6_ZERO)


def _line(p1: Tuple[Fq12, Fq12], p2: Tuple[Fq12, Fq12], t: Tuple[Fq12, Fq12]) -> Fq12:
    """Evaluate the line through p1, p2 at point t (all in E(Fq12) affine)."""
    x1, y1 = p1
    x2, y2 = p2
    xt, yt = t
    if not fq12_is_zero(fq12_sub(x1, x2)):
        m = fq12_mul(fq12_sub(y2, y1), fq12_inv(fq12_sub(x2, x1)))
        return fq12_sub(fq12_mul(m, fq12_sub(xt, x1)), fq12_sub(yt, y1))
    if fq12_is_zero(fq12_sub(y1, y2)):
        # tangent: m = 3 x1^2 / (2 y1)
        m = fq12_mul(
            fq12_mul(_fq_to_fq12(3), fq12_sq(x1)),
            fq12_inv(fq12_mul(_fq_to_fq12(2), y1)),
        )
        return fq12_sub(fq12_mul(m, fq12_sub(xt, x1)), fq12_sub(yt, y1))
    # vertical
    return fq12_sub(xt, x1)


def miller_loop(q: G2, p: G1) -> Fq12:
    """Optimal ate Miller loop f_{6x+2,Q}(P) including the frobenius steps."""
    if g2_is_inf(q) or g1_is_inf(p):
        return FQ12_ONE
    q_aff = g2_to_affine(q)
    p_aff = g1_to_affine(p)
    Q = _twist(q_aff)
    Pt = (_fq_to_fq12(p_aff[0]), _fq_to_fq12(p_aff[1]))
    T = Q
    f = FQ12_ONE
    bits = bin(ATE_LOOP_COUNT)[2:]
    for bit in bits[1:]:
        f = fq12_mul(fq12_sq(f), _line(T, T, Pt))
        T = _ec12_double(T)
        if bit == "1":
            f = fq12_mul(f, _line(T, Q, Pt))
            T = _ec12_add(T, Q)
    # frobenius endomorphism steps: Q1 = pi(Q), Q2 = -pi^2(Q)
    q1 = (_frob_tw(q_aff, 1)[0], _frob_tw(q_aff, 1)[1])
    Q1 = _twist(q1)
    q2 = _frob_tw(q_aff, 2)
    Q2 = _twist((q2[0], fq2_neg(q2[1])))
    f = fq12_mul(f, _line(T, Q1, Pt))
    T = _ec12_add(T, Q1)
    f = fq12_mul(f, _line(T, Q2, Pt))
    return f


def _frob_tw(q_aff: Tuple[Fq2, Fq2], power: int) -> Tuple[Fq2, Fq2]:
    """Frobenius on the twist: (x,y) -> (x^p * xi^((p-1)/3), y^p * xi^((p-1)/2))."""
    x, y = q_aff
    for _ in range(power):
        x = fq2_mul(fq2_conj(x), _FROB_GAMMA1[2])  # xi^((p-1)/3)
        y = fq2_mul(fq2_conj(y), _FROB_GAMMA1[3])  # xi^((p-1)/2)
    return (x, y)


def _ec12_double(pt: Tuple[Fq12, Fq12]) -> Tuple[Fq12, Fq12]:
    x, y = pt
    m = fq12_mul(
        fq12_mul(_fq_to_fq12(3), fq12_sq(x)),
        fq12_inv(fq12_mul(_fq_to_fq12(2), y)),
    )
    xr = fq12_sub(fq12_sq(m), fq12_mul(_fq_to_fq12(2), x))
    yr = fq12_sub(fq12_mul(m, fq12_sub(x, xr)), y)
    return (xr, yr)


def _ec12_add(p1: Tuple[Fq12, Fq12], p2: Tuple[Fq12, Fq12]) -> Tuple[Fq12, Fq12]:
    x1, y1 = p1
    x2, y2 = p2
    if fq12_is_zero(fq12_sub(x1, x2)) and fq12_is_zero(fq12_sub(y1, y2)):
        return _ec12_double(p1)
    m = fq12_mul(fq12_sub(y2, y1), fq12_inv(fq12_sub(x2, x1)))
    xr = fq12_sub(fq12_sub(fq12_sq(m), x1), x2)
    yr = fq12_sub(fq12_mul(m, fq12_sub(x1, xr)), y1)
    return (xr, yr)


def final_exponentiation(f: Fq12) -> Fq12:
    """f^((p^12-1)/r). Easy part via frobenius/conjugation, hard part by pow."""
    # easy: f^(p^6-1) = conj(f) * f^-1 ; then ^(p^2+1)
    f1 = fq12_mul(fq12_conj(f), fq12_inv(f))
    f2 = fq12_mul(fq12_frob(fq12_frob(f1)), f1)
    # hard part: exponent (p^4 - p^2 + 1)/r
    hard = (P**4 - P**2 + 1) // R
    return fq12_pow(f2, hard)


def pairing_py(q: G2, p: G1) -> Fq12:
    return final_exponentiation(miller_loop(q, p))


def multi_pairing_py(pairs: Sequence[Tuple[G1, G2]]) -> Fq12:
    """prod e(P_i, Q_i) with one shared final exponentiation (the golden)."""
    f = FQ12_ONE
    for p, q in pairs:
        if g1_is_inf(p) or g2_is_inf(q):
            continue
        f = fq12_mul(f, miller_loop(q, p))
    return final_exponentiation(f)


g1_scalar_mul = g1_scalar_mul_py
g2_scalar_mul = g2_scalar_mul_py
g1_msm = g1_msm_py
g2_msm = g2_msm_py
multi_pairing = multi_pairing_py
