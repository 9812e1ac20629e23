"""Host prime-field arithmetic on Python ints (the golden tier).

Frozen copy of the port's host field arithmetic, for the fields the
reference verifiers use: the two BN254 fields of the Groth16 slice, ``BN254_FR`` (scalars,
the QAP domain) and ``BN254_FQ`` (curve coordinates), and winterfell's
``F128`` (p = 2^128 - 45 * 2^40 + 1) of the STARK. Elements are canonical
ints in ``[0, p)``.
"""

from __future__ import annotations


class PrimeField:
    """Arithmetic mod a prime ``p`` on plain Python ints."""

    __slots__ = ("p", "name", "nbytes", "nbits", "two_adicity")

    def __init__(self, p: int, name: str):
        self.p = p
        self.name = name
        self.nbits = p.bit_length()
        self.nbytes = (self.nbits + 7) // 8
        t = p - 1
        s = 0
        while t % 2 == 0:
            t //= 2
            s += 1
        self.two_adicity = s

    def add(self, a: int, b: int) -> int:
        c = a + b
        return c - self.p if c >= self.p else c

    def sub(self, a: int, b: int) -> int:
        c = a - b
        return c + self.p if c < 0 else c

    def mul(self, a: int, b: int) -> int:
        return a * b % self.p

    def pow(self, a: int, e: int) -> int:
        return pow(a, e, self.p)

    def inv(self, a: int) -> int:
        if a == 0:
            raise ZeroDivisionError(f"inverse of 0 in {self.name}")
        return pow(a, -1, self.p)

    def div(self, a: int, b: int) -> int:
        return a * self.inv(b) % self.p

    def batch_inv(self, xs: list) -> list:
        """Montgomery batch inversion: one inversion for n elements."""
        n = len(xs)
        if n == 0:
            return []
        prefix = [1] * (n + 1)
        for i, x in enumerate(xs):
            if x == 0:
                raise ZeroDivisionError(f"inverse of 0 in {self.name}")
            prefix[i + 1] = prefix[i] * x % self.p
        inv_all = self.inv(prefix[n])
        out = [0] * n
        for i in range(n - 1, -1, -1):
            out[i] = prefix[i] * inv_all % self.p
            inv_all = inv_all * xs[i] % self.p
        return out

    def to_le_bytes(self, a: int, length: int | None = None) -> bytes:
        return int(a).to_bytes(length or self.nbytes, "little")

    def from_le_bytes_mod(self, data: bytes) -> int:
        """LE bytes reduced mod p (arkworks ``from_le_bytes_mod_order``)."""
        return int.from_bytes(data, "little") % self.p

    def from_le_bytes_canonical(self, data: bytes):
        """LE bytes, rejecting non-canonical values (``None`` if >= p)."""
        v = int.from_bytes(data, "little")
        return v if v < self.p else None

    def root_of_unity(self, order: int) -> int:
        """Primitive ``order``-th root of unity (order a power of two)."""
        assert order & (order - 1) == 0, "order must be a power of two"
        assert order <= (1 << self.two_adicity), "field lacks required two-adicity"
        return pow(_GENERATORS[self.p], (self.p - 1) // order, self.p)


# Smallest multiplicative generators: bn254_fr g=5 (ark-bn254 Fr GENERATOR),
# bn254_fq g=3, f128 g=3 (winterfell's f128 GENERATOR: its two-adic roots
# are winterfell's, F128_TWO_ADIC_ROOT below).
_GENERATORS = {
    21888242871839275222246405745257275088548364400416034343698204186575808495617: 5,
    21888242871839275222246405745257275088696311157297823662689037894645226208583: 3,
    (1 << 128) - 45 * (1 << 40) + 1: 3,
}

BN254_FQ = PrimeField(
    21888242871839275222246405745257275088696311157297823662689037894645226208583,
    "bn254_fq",
)
BN254_FR = PrimeField(
    21888242871839275222246405745257275088548364400416034343698204186575808495617,
    "bn254_fr",
)

# winterfell f128 (reference stark.rs, winterfell 0.10): 2-adicity 40,
# generator 3
F128_MODULUS = (1 << 128) - 45 * (1 << 40) + 1
F128 = PrimeField(F128_MODULUS, "f128")
F128_TWO_ADIC_ROOT = 23953097886125630542083529559205016746
