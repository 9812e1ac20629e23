// 12-bit Montgomery limb arithmetic, one field element per thread: the
// device side of ops/limb.py LimbContext (and of the JAX package's
// ops/limb.py), shared by the mont_mul kernel (mont.cu) and the Montgomery
// point-addition probe P7 (probes.cu).
//
// A field element is N relaxed signed 12-bit limbs in int32, least
// significant first. The product a * b * R^-1 (R = 2^(12N)) is the schoolbook
// columns T[0..2N), the REDC sweep in the JAX order
//   for i = 0..N-1: m = ((T[i] & mask) * ninv) & mask;
//                   T[i..i+N) += m * p;  T[i+1] += T[i] >> 12
// and three wrap carries of T[N..2N), each folding the top carry back in as
// R mod p. Every step is the plain version's integer operation on the same
// operands, so the limbs equal it (ops/kernels.py mont_mul_plain) exactly.
//
// Consts block (rows of N int32): p, R mod p, ninv in word 0 of row 2, then
// the probe's curve constant (2d * R mod p for the Edwards addition). A
// product reads p, R mod p and ninv through an accessor: MontShared, the
// block's copy of the consts block in shared memory (mont_mul: the field
// enters only through the block, so one instance serves BN254 Fr and
// 2^255 - 19), or Mont25519, p = 2^255 - 19's written into the code (P7).
//
// int32 headroom (signed overflow is undefined in C++, so it must not occur):
// a column is a sum of at most N limb products, REDC adds at most
// N * 4095 * 4095 ~= 2^28.5 and carries below 2^19. Interval arithmetic over
// the h pipeline, the MiMC rounds and the probes, one interval per limb and
// step (tests/test_torch_limb.py::test_int32_headroom, in Python ints),
// bounds the limbs entering the product by 2^13.6 and every partial sum of a
// column, an add or a carry pass by 2^30.1 < 2^31.
#pragma once

#include <cstdint>
#include <cuda_runtime.h>

namespace mont {

constexpr int LIMB_BITS = 12;
constexpr int32_t MASK = (1 << LIMB_BITS) - 1;
constexpr int ROW_P = 0;
constexpr int ROW_ONE = 1;
constexpr int ROW_NINV = 2;
constexpr int ROW_CURVE = 3;

}  // namespace mont

// Word i of consts row `row` (ROW_P, ROW_ONE or ROW_NINV), i a constant
// after unrolling: from a block's shared copy of the consts block, or
// p = 2^255 - 19's in the code.
template <int N>
struct MontShared {
  const int32_t* c;  // (rows, N) int32 in shared memory
  __device__ __forceinline__ int32_t operator()(int row, int i) const { return c[row * N + i]; }
};

// p = 2^255 - 19 at N = 22: p = [4077, 4095 x 20, 7], R mod p = 2^264 mod p
// = 9728 = [1536, 2, 0 x 20], ninv = -p^-1 mod 2^12 = 2587 (pinned against
// LimbContext by tests/test_torch_probes.py). As immediates, a wrap carry's
// 20 products by zero limbs of R mod p fold away and the REDC's 20 products
// m * 4095 are one value the compiler may compute once; every nonzero term
// is kept, so the limbs are those of the consts block's product.
struct Mont25519 {
  static constexpr int32_t P0 = 4077, P_MID = 4095, P_TOP = 7;  // p's limbs 0, 1..20, 21
  static constexpr int32_t ONE0 = 1536, ONE1 = 2;                // R mod p's limbs 0, 1
  static constexpr int32_t NINV = 2587;
  __device__ __forceinline__ int32_t operator()(int row, int i) const {
    using namespace mont;
    if (row == ROW_P) return i == 0 ? P0 : i == 21 ? P_TOP : P_MID;
    if (row == ROW_ONE) return i == 0 ? ONE0 : i == 1 ? ONE1 : 0;
    return NINV;
  }
};

// One wrap-carry pass: lo + (hi shifted up one limb) + hi_top * (R mod p).
// >> on a negative int32 is arithmetic (floor), as in torch and jnp.
template <int N, class Cs>
__device__ __forceinline__ void mont_carry(int32_t* x, Cs cs) {
  using namespace mont;
  const int32_t top = x[N - 1] >> LIMB_BITS;
#pragma unroll
  for (int i = N - 1; i > 0; --i) x[i] = (x[i] & MASK) + (x[i - 1] >> LIMB_BITS);
  x[0] &= MASK;
#pragma unroll
  for (int i = 0; i < N; ++i) x[i] += top * cs(ROW_ONE, i);
}

// r = a * b * R^-1. r may alias a or b: every read of a and b comes before
// the first write of r. With constant indices throughout, the 2N columns
// stay in registers.
template <int N, class Cs>
__device__ __forceinline__ void mont_mul(int32_t* r, const int32_t* a, const int32_t* b, Cs cs) {
  using namespace mont;
  int32_t T[2 * N];
#pragma unroll
  for (int k = 0; k < 2 * N; ++k) T[k] = 0;
#pragma unroll
  for (int j = 0; j < N; ++j) {
    const int32_t bj = b[j];
#pragma unroll
    for (int i = 0; i < N; ++i) T[i + j] += a[i] * bj;
  }
  const int32_t ninv = cs(ROW_NINV, 0);
#pragma unroll
  for (int i = 0; i < N; ++i) {
    const int32_t m = ((T[i] & MASK) * ninv) & MASK;
#pragma unroll
    for (int j = 0; j < N; ++j) T[i + j] += m * cs(ROW_P, j);
    T[i + 1] += T[i] >> LIMB_BITS;
  }
  mont_carry<N>(T + N, cs);
  mont_carry<N>(T + N, cs);
  mont_carry<N>(T + N, cs);
#pragma unroll
  for (int k = 0; k < N; ++k) r[k] = T[N + k];
}
