// Fold-field arithmetic mod 2^255 - 19 and the Edwards point formulas, one
// lane per thread, shared by the window-sum, Horner and table-add kernels.
//
// The same schedule as the plain PyTorch version (ops/limbfold.py FieldOps,
// ops/curve.py EdwardsEngine) and the JAX package's ops/limbfold.py:
// a field element is N = 24 relaxed signed 12-bit limbs in int32; a product
// is the schoolbook convolution (2N+2 columns), two no-wrap carry passes,
// the fold of the high columns through FOLD[k] = limbs(2^(12(N+k)) mod p),
// and three wrap carries through ONE = limbs(2^(12N) mod p). Each step is
// the same integer operation on the same operands, so limbs are identical to
// the plain version's.
//
// int32 headroom (signed overflow is undefined in C++, so it must not occur):
// inputs have |limb| <= ~2^13.1, so |a_i * b_j| <= 2^26.2 and a column of at
// most N = 24 such products stays below 24 * 2^26.2 ~= 2^30.8 < 2^31. After
// the two no-wrap passes |t_k| < 2^12 + 2^7; a fold term is < 2^13 * 2^12 =
// 2^25 and a row of N + 3 terms stays below 2^30. The wrap carries keep the
// relaxed bound for the next product.
//
// Constants (ONE, FOLD, 2d) sit in __constant__ memory: every lane of a
// warp reads the same word at the same time, which the constant cache
// broadcasts, and the fold products take it as a direct operand.
#pragma once

#include <cstdint>
#include <cuda_runtime.h>

namespace fold {

constexpr int N = 24;             // limbs per field element
constexpr int NCOL = 2 * N + 2;   // schoolbook columns, top one spare
constexpr int NCONST = N + 4;     // consts rows: ONE, FOLD[N + 2], 2d
constexpr int COORDS = 4;         // extended Edwards (X, Y, Z, T)
constexpr int LIMB_BITS = 12;
constexpr int32_t MASK = (1 << LIMB_BITS) - 1;
constexpr int ROW_ONE = 0;
constexpr int ROW_FOLD = 1;
constexpr int ROW_TWO_D = N + 3;

}  // namespace fold

__constant__ int32_t c_consts[fold::NCONST * fold::N];

// Copy the (NCONST, N) int32 consts block, a device tensor, into constant
// memory, ordered on the launch stream before the kernel that reads it.
static inline cudaError_t fold_load_consts(const int32_t* consts, cudaStream_t stream) {
  return cudaMemcpyToSymbolAsync(c_consts, consts,
                                 sizeof(int32_t) * fold::NCONST * fold::N, 0,
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

__device__ __forceinline__ void fe_add(int32_t* r, const int32_t* a, const int32_t* b) {
#pragma unroll
  for (int i = 0; i < fold::N; ++i) r[i] = a[i] + b[i];
  fe_carry(r);
}

__device__ __forceinline__ void fe_sub(int32_t* r, const int32_t* a, const int32_t* b) {
#pragma unroll
  for (int i = 0; i < fold::N; ++i) r[i] = a[i] - b[i];
  fe_carry(r);
}

// r = a * b. r may alias a or b: every read of a and b comes before the
// first write of r. Kept out of line so each point formula is a handful of
// calls and the kernels compile in seconds.
__device__ __noinline__ void fe_mul(int32_t* r, const int32_t* a, const int32_t* b) {
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

// add-2008-hwcd-3, unified and complete for Ristretto points. r may alias p
// or q.
__device__ __forceinline__ void ed_padd(int32_t (*r)[fold::N], int32_t (*p)[fold::N],
                                        int32_t (*q)[fold::N]) {
  using namespace fold;
  int32_t u[N], v[N], A[N], B[N], C[N], D[N], two_d[N];
#pragma unroll
  for (int i = 0; i < N; ++i) two_d[i] = c_consts[ROW_TWO_D * N + i];
  fe_sub(u, p[1], p[0]);
  fe_sub(v, q[1], q[0]);
  fe_mul(A, u, v);
  fe_add(u, p[1], p[0]);
  fe_add(v, q[1], q[0]);
  fe_mul(B, u, v);
  fe_mul(u, p[3], q[3]);
  fe_mul(C, u, two_d);
  fe_mul(u, p[2], q[2]);
#pragma unroll
  for (int i = 0; i < N; ++i) D[i] = u[i] + u[i];
  fe_carry(D);
  int32_t E[N], F[N], G[N], H[N];
  fe_sub(E, B, A);
  fe_sub(F, D, C);
  fe_add(G, D, C);
  fe_add(H, B, A);
  fe_mul(r[0], E, F);
  fe_mul(r[1], G, H);
  fe_mul(r[2], F, G);
  fe_mul(r[3], E, H);
}

// dbl-2008-hwcd (8 products, identity-safe). r may alias p.
__device__ __forceinline__ void ed_pdouble(int32_t (*r)[fold::N], int32_t (*p)[fold::N]) {
  using namespace fold;
  int32_t A[N], B[N], C[N], H[N], u[N], v[N];
  fe_mul(A, p[0], p[0]);
  fe_mul(B, p[1], p[1]);
  fe_mul(u, p[2], p[2]);
#pragma unroll
  for (int i = 0; i < N; ++i) C[i] = u[i] + u[i];
  fe_carry(C);
  fe_add(H, A, B);
  fe_add(u, p[0], p[1]);
  fe_mul(v, u, u);
  int32_t E[N], F[N], G[N];
  fe_sub(E, H, v);
  fe_sub(G, A, B);
  fe_add(F, C, G);
  fe_mul(r[0], E, F);
  fe_mul(r[1], G, H);
  fe_mul(r[2], F, G);
  fe_mul(r[3], E, H);
}

// Load / store one lane of a (COORDS, N, B) int32 tensor.
__device__ __forceinline__ void pt_load_lanes(int32_t (*r)[fold::N], const int32_t* __restrict__ src,
                                              int b, int B) {
#pragma unroll
  for (int c = 0; c < fold::COORDS; ++c)
#pragma unroll
    for (int i = 0; i < fold::N; ++i) r[c][i] = src[(c * fold::N + i) * (size_t)B + b];
}

__device__ __forceinline__ void pt_store_lanes(int32_t* __restrict__ dst, int32_t (*p)[fold::N],
                                               int b, int B) {
#pragma unroll
  for (int c = 0; c < fold::COORDS; ++c)
#pragma unroll
    for (int i = 0; i < fold::N; ++i) dst[(c * fold::N + i) * (size_t)B + b] = p[c][i];
}
