// Fold-field arithmetic on 12-bit limbs and the consts blocks of the three
// curves of the MSM (ed25519, BN254 G1, BN254 G2), one field element per
// thread: the field product and carries of the cooperative padds
// (coop_sum.cuh), which run every tree sum, Horner step, table add and the
// P2 chain. The P4 probe (probes.cu) runs the same product with its field's
// constants in the code (ed_mul, bn254_fq.cuh bn_fq_mul) and keeps this
// one as its constant-memory ablation. No point formula runs whole in one
// thread: the padds are coop_sum.cuh's.
//
// The same schedule as the plain PyTorch version (ops/limbfold.py FieldOps,
// ops/edwards.py, ops/weierstrass.py) and the JAX package's ops/limbfold.py
// and ops/curve_jax.py: a field element is N = 24 relaxed signed 12-bit
// limbs in int32; a product is the schoolbook convolution (2N+2 columns),
// two no-wrap carry passes, the fold of the high columns through
// FOLD[k] = limbs(2^(12(N+k)) mod p), and three wrap carries through
// ONE = limbs(2^(12N) mod p). Each step is the same integer operation on the
// same operands, so limbs are identical to the plain version's. The field
// code is the same for every prime: p enters only through the consts block.
//
// Consts block (rows of N int32, in __constant__ memory): ONE, FOLD[N + 2],
// then the curve's constants — ed25519: 2d (N + 4 rows); BN254 G1: none
// (N + 3 rows, b3 = 9 is a small multiply); BN254 G2: b3 = 3 * 3/(9+u) as
// two Fq rows c0, c1 (N + 5 rows). Every lane of a warp reads the same word
// at the same time, which the constant cache broadcasts.
//
// int32 headroom (signed overflow is undefined in C++, so it must not occur):
// * p = 2^255 - 19: inputs have |limb| <= ~2^13.1, so |a_i * b_j| <= 2^26.2
//   and a column of at most N = 24 such products stays below 24 * 2^26.2 ~=
//   2^30.8 < 2^31. After the two no-wrap passes |t_k| < 2^12 + 2^7; a fold
//   term is < 2^13 * 2^12 = 2^25 and a row of N + 3 terms stays below 2^30.
//   The wrap carries keep the relaxed bound for the next product.
// * p = BN254 Fq: ONE and every FOLD row are full 254-bit values (limbs up
//   to 4095 in limbs 0..20), so the Curve25519 argument does not carry over
//   and a per-limb bound is needed. Interval arithmetic over the RCB formula
//   with this p's actual ONE, FOLD and b3 limbs (every add, sub, carry, conv
//   column, fold row and b3 product of padd, for G1 and for G2;
//   tests/test_torch_weierstrass.py::test_int32_headroom; the cooperative
//   padds of coop_sum.cuh run these rows) shows: starting from
//   canonical limbs [0, 4095], every padd output limb lies in
//   [-7643, 11737], that interval is closed under padd, and every conv
//   column (as the sum of its terms' magnitudes), fold row and carry
//   intermediate stays below 2^30.31 < 2^31. Every point the kernels see
//   (encoded basis points, the identity, table rows, window sums, Horner
//   accumulators) is canonical or a padd output, so no sum overflows; the
//   limbs also fit the int16 table.
#pragma once

#include <cstdint>
#include <cuda_runtime.h>

namespace fold {

constexpr int N = 24;             // limbs per field element
constexpr int NCOL = 2 * N + 2;   // schoolbook columns, top one spare
constexpr int NCONST_MAX = N + 5; // ONE, FOLD[N + 2], up to two curve rows
constexpr int LIMB_BITS = 12;
constexpr int32_t MASK = (1 << LIMB_BITS) - 1;
constexpr int ROW_ONE = 0;
constexpr int ROW_FOLD = 1;
constexpr int ROW_CURVE = N + 3;  // first curve constant (2d or b3.c0)

}  // namespace fold

__constant__ int32_t c_consts[fold::NCONST_MAX * fold::N];

// Copy a (rows, N) int32 consts block, a device tensor, into constant
// memory, ordered on the launch stream before the kernel that reads it.
static inline cudaError_t fold_load_consts(const int32_t* consts, int rows, cudaStream_t stream) {
  return cudaMemcpyToSymbolAsync(c_consts, consts, sizeof(int32_t) * rows * fold::N, 0,
                                 cudaMemcpyDeviceToDevice, stream);
}

// One wrap-carry pass: lo + (hi shifted up one limb) + hi_top * ONE.
// >> on a negative int32 is arithmetic (floor), as in torch and jnp.
__device__ __forceinline__ void fe_carry(int32_t* x) {
  using namespace fold;
  const int32_t top = x[N - 1] >> LIMB_BITS;
#pragma unroll
  for (int i = N - 1; i > 0; --i) x[i] = (x[i] & MASK) + (x[i - 1] >> LIMB_BITS);
  x[0] &= MASK;
#pragma unroll
  for (int i = 0; i < N; ++i) x[i] += top * c_consts[ROW_ONE * N + i];
}

// r = a * k for a small k (|k| <= ~2^16): two wrap carries.
__device__ __forceinline__ void fe_smul(int32_t* r, const int32_t* a, int32_t k) {
#pragma unroll
  for (int i = 0; i < fold::N; ++i) r[i] = a[i] * k;
  fe_carry(r);
  fe_carry(r);
}

// r = a * b. r may alias a or b: every read of a and b comes before the
// first write of r. Inlined where the operands are register arrays
// (csrc/coop_sum.cuh, the P4 ablation in probes.cu).
__device__ __forceinline__ void fe_mul_inline(int32_t* r, const int32_t* a, const int32_t* b) {
  using namespace fold;
  int32_t t[NCOL];
#pragma unroll
  for (int k = 0; k < NCOL; ++k) t[k] = 0;
#pragma unroll
  for (int i = 0; i < N; ++i) {
    const int32_t ai = a[i];
#pragma unroll
    for (int j = 0; j < N; ++j) t[i + j] += ai * b[j];
  }
  // two no-wrap passes; the carry out of the spare top column is dropped,
  // as in the plain version
#pragma unroll
  for (int pass = 0; pass < 2; ++pass) {
#pragma unroll
    for (int k = NCOL - 1; k > 0; --k) t[k] = (t[k] & MASK) + (t[k - 1] >> LIMB_BITS);
    t[0] &= MASK;
  }
#pragma unroll
  for (int i = 0; i < N; ++i) {
    int32_t acc = t[i];
#pragma unroll
    for (int k = 0; k < N + 2; ++k) acc += t[N + k] * c_consts[(ROW_FOLD + k) * N + i];
    r[i] = acc;
  }
  fe_carry(r);
  fe_carry(r);
  fe_carry(r);
}

// ---------------------------------------------------------------------------
// Curves: coordinates and consts rows
// ---------------------------------------------------------------------------

// Extended twisted Edwards a = -1 (Curve25519 / Ristretto255), (X, Y, Z, T);
// its padd and pdouble are EdCoop's (coop_sum.cuh).
struct Ed25519 {
  static constexpr int COORDS = 4;
  static constexpr int NCONST = fold::N + 4;  // ONE, FOLD[N + 2], 2d
};

// BN254 G1 over Fq, (X, Y, Z), and G2 over Fq2, (X, Y, Z) each (c0, c1):
// their consts blocks; the cooperative padds (coop_sum.cuh) run RCB'15
// algorithm 7 on them.
struct Bn254G1 {
  static constexpr int COORDS = 3;
  static constexpr int NCONST = fold::N + 3;  // ONE, FOLD[N + 2]; b3 = 9 is a small multiply
};

struct Bn254G2 {
  static constexpr int COORDS = 6;
  static constexpr int NCONST = fold::N + 5;  // ONE, FOLD[N + 2], b3.c0, b3.c1
};
