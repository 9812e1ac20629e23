// The BN254 G2 point sum of the window-sum kernels (window_sum4, tree_sum):
// the plain version's halving tree over one lane's K points, each addition a
// cooperative G2 padd of six threads on operands in shared memory.
//
// Cooperative padd. RCB'15 algorithm 7 as rcb_padd (fold_curves.cuh) and
// the plain WeierstrassEngine.padd order it has three rounds of independent
// Fq products: the 18 of the six Karatsuba Fq2 products t0, t1, t2, t3, t4,
// X3; the 6 of the two b3 products; the 18 of the six output products. A
// group of six threads runs one padd: thread g takes Karatsuba pair g of
// rounds 1 and 3 (its m0, m1 and t products, one after the other) and one
// product of round 2. Each product is fe_mul_inline on register arrays: the
// thread builds both operands in registers (loads, adds and the Karatsuba
// sums with their carries), multiplies, and stores the 24 limbs to the
// group's scratch. Between the rounds the adds, subs and carries (the 12
// Karatsuba rows of round 1, then 8, 6 and 6 rows) are spread over the six
// threads the same way, one row at a time, each value computed once.
// The rounds meet at __syncwarp: a group never leaves its warp. Five groups
// fill a warp (lanes 30 and 31 idle). Each row is the same integer
// operation on the same operands as in rcb_padd, so the limbs equal the
// plain version's and JAX's, and the int32 headroom argument of
// fold_curves.cuh holds unchanged.
//
// Scratch of one padd, 32 int32 rows (3072 bytes): M, rows 0..17, the
// products of a round (Karatsuba pair j's m0, m1, t at rows 3j .. 3j + 2);
// T, rows 18..29, six Fq2 values (c0, c1): t0, t1, t2, t3, t4, X3 of round 1,
// then in place t3 -= t0 + t1, t4 -= t1 + t2, Y3 = X3 - (t0 + t2), then
// after round 2 t1 - b3 t2 in t0's rows, t1 + b3 t2 (Z3) in t2's, b3 Y3 in
// Y3's; X, rows 30..31, X3 = 3 t0.
//
// Tree. Level by level in the order of ops/edwards.py _tree_reduce: point i
// plus point i + half for i < half, the odd last point carried to slot half.
// Level 1 reads its pairs from the caller's rows (global memory), later
// levels from the level store: ceil(K/2) int16 points in shared memory,
// written in place (padd i writes slot i, which no other padd of its level
// reads). A padd output's limbs lie in [-7643, 11737] (fold_curves.cuh), so
// int16 holds them exactly.
#pragma once

#include "fold_curves.cuh"

namespace g2 {

using fold::N;
constexpr int ROWS = 6;              // Fq rows of a point: X, Y, Z as (c0, c1)
constexpr int POINT = ROWS * N;      // int16 limbs of a point
constexpr int GROUP = 6;             // threads of one padd
constexpr int PADDS_PER_WARP = 5;    // 32 / GROUP
constexpr int ROW_T = 18;            // scratch rows, as above
constexpr int ROW_X = 30;
constexpr int SCRATCH = 32 * N;      // int32 of one padd's scratch
constexpr int MAX_WARPS = 12;        // 384 threads: at most 168 registers a thread

// Dynamic shared memory a block of `warps` warps needs for K points: the
// level store, then one scratch per padd.
__host__ __device__ constexpr size_t smem_bytes(int K, int warps) {
  return (size_t)((K + 1) / 2) * POINT * sizeof(int16_t) +
         (size_t)warps * PADDS_PER_WARP * SCRATCH * sizeof(int32_t);
}

}  // namespace g2

// -- rows: 24 limbs, as int16 (48 bytes) or int32 (96 bytes), 16-byte aligned

__device__ __forceinline__ void g2_ld16(int32_t* r, const int16_t* p) {
  const int4* src = reinterpret_cast<const int4*>(p);
#pragma unroll
  for (int w = 0; w < 3; ++w) {
    const int4 v = src[w];
    const int32_t words[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
    for (int h = 0; h < 4; ++h) {
      r[w * 8 + 2 * h] = (int32_t)(int16_t)(words[h] & 0xFFFF);
      r[w * 8 + 2 * h + 1] = words[h] >> 16;
    }
  }
}

__device__ __forceinline__ void g2_st16(int16_t* p, const int32_t* r) {
  int4* dst = reinterpret_cast<int4*>(p);
#pragma unroll
  for (int w = 0; w < 3; ++w) {
    int32_t words[4];
#pragma unroll
    for (int h = 0; h < 4; ++h)
      words[h] = (int32_t)(((uint32_t)r[w * 8 + 2 * h] & 0xFFFFu) | ((uint32_t)r[w * 8 + 2 * h + 1] << 16));
    dst[w] = make_int4(words[0], words[1], words[2], words[3]);
  }
}

__device__ __forceinline__ void g2_ld32(int32_t* r, const int32_t* p) {
  const int4* src = reinterpret_cast<const int4*>(p);
#pragma unroll
  for (int w = 0; w < 6; ++w) {
    const int4 v = src[w];
    r[4 * w] = v.x;
    r[4 * w + 1] = v.y;
    r[4 * w + 2] = v.z;
    r[4 * w + 3] = v.w;
  }
}

__device__ __forceinline__ void g2_st32(int32_t* p, const int32_t* r) {
  int4* dst = reinterpret_cast<int4*>(p);
#pragma unroll
  for (int w = 0; w < 6; ++w) dst[w] = make_int4(r[4 * w], r[4 * w + 1], r[4 * w + 2], r[4 * w + 3]);
}

// r = carry(r + sign * x), sign = +1 or -1
__device__ __forceinline__ void g2_add_carry(int32_t* r, const int32_t* x, int32_t sign) {
#pragma unroll
  for (int i = 0; i < fold::N; ++i) r[i] += sign * x[i];
  fe_carry(r);
}

// Component k of Karatsuba pair j from its products m0, m1, t (rows 3j ..
// 3j + 2 of M): c0 = carry(m0 - m1), c1 = carry(carry(t - m0) - m1).
__device__ __forceinline__ void g2_kara(int32_t* r, const int32_t* M, int j, int k) {
  using fold::N;
  int32_t x[N];
  g2_ld32(r, M + (3 * j + (k ? 2 : 0)) * N);
  g2_ld32(x, M + (3 * j + (k ? 0 : 1)) * N);
  g2_add_carry(r, x, -1);
  if (k) {
    g2_ld32(x, M + (3 * j + 1) * N);
    g2_add_carry(r, x, -1);
  }
}

// Row k of round 1's operand j of the int16 point pt: coordinate j (j < 3,
// X, Y, Z) or the carried sum X+Y, Y+Z, X+Z (j = 3, 4, 5).
__device__ __forceinline__ void g2_r1_row(int32_t* r, const int16_t* pt, int j, int k) {
  using fold::N;
  g2_ld16(r, pt + (2 * (j < 3 ? j : (j == 4 ? 1 : 0)) + k) * N);
  if (j >= 3) {
    int32_t x[N];
    g2_ld16(x, pt + (2 * (j == 3 ? 1 : 2) + k) * N);
    g2_add_carry(r, x, 1);
  }
}

// Karatsuba operand of product s (0: c0, 1: c1, 2: carry(c0 + c1)) of
// round 1's operand j.
__device__ __forceinline__ void g2_r1_operand(int32_t* r, const int16_t* pt, int j, int s) {
  if (s < 2) {
    g2_r1_row(r, pt, j, s);
  } else {
    int32_t x[fold::N];
    g2_r1_row(r, pt, j, 0);
    g2_r1_row(x, pt, j, 1);
    g2_add_carry(r, x, 1);
  }
}

// Karatsuba operand of product s of the Fq2 element at rows c0 (p) and c1
// (p + N) of the scratch.
__device__ __forceinline__ void g2_operand(int32_t* r, const int32_t* p, int s) {
  if (s < 2) {
    g2_ld32(r, p + s * fold::N);
  } else {
    int32_t x[fold::N];
    g2_ld32(r, p);
    g2_ld32(x, p + fold::N);
    g2_add_carry(r, x, 1);
  }
}

// out = P + Q, by the six threads g = 0..5 of one group with scratch scr.
// Every thread of the warp calls it (it meets at __syncwarp); a group with
// no padd passes act = false. out may be P or Q: P and Q are read in round
// 1 only, out written last.
__device__ __forceinline__ void g2_padd_coop(int16_t* out, const int16_t* P, const int16_t* Q,
                                            int32_t* scr, int g, bool act) {
  using fold::N;
  int32_t* M = scr;
  int32_t* T = scr + g2::ROW_T * N;
  int32_t* X = scr + g2::ROW_X * N;
  // round 1: pair g = (X1, X2), (Y1, Y2), (Z1, Z2), (X1+Y1, X2+Y2), ...
  if (act) {
#pragma unroll 1
    for (int s = 0; s < 3; ++s) {
      int32_t a[N], b[N];
      g2_r1_operand(a, P, g, s);
      g2_r1_operand(b, Q, g, s);
      fe_mul_inline(a, a, b);
      g2_st32(M + (3 * g + s) * N, a);
    }
  }
  __syncwarp();
  // T: t0, t1, t2, t3, t4, X3 from the Karatsuba pairs, pair g
  if (act) {
#pragma unroll 1
    for (int k = 0; k < 2; ++k) {
      int32_t r[N];
      g2_kara(r, M, g, k);
      g2_st32(T + (2 * g + k) * N, r);
    }
  }
  __syncwarp();
  // t3 = carry(t3 - carry(t0 + t1)), t4 = carry(t4 - carry(t1 + t2)),
  // Y3 = carry(X3 - carry(t0 + t2)) in place (v = 3, 4, 5; component g & 1),
  // then X3 = carry(t0 + t0 + t0)
  if (act) {
    const int v = 3 + (g >> 1), k = g & 1;
    int32_t r[N], x[N];
    g2_ld32(r, T + (2 * (v == 4 ? 1 : 0) + k) * N);
    g2_ld32(x, T + (2 * (v == 3 ? 1 : 2) + k) * N);
    g2_add_carry(r, x, 1);
    g2_ld32(x, T + (2 * v + k) * N);
#pragma unroll
    for (int i = 0; i < N; ++i) r[i] = x[i] - r[i];
    fe_carry(r);
    g2_st32(T + (2 * v + k) * N, r);
    if (g < 2) {
      g2_ld32(r, T + g * N);
#pragma unroll
      for (int i = 0; i < N; ++i) r[i] = r[i] + r[i] + r[i];
      fe_carry(r);
      g2_st32(X + g * N, r);
    }
  }
  __syncwarp();
  // round 2: b3 * t2 (pair 0) and b3 * Y3 (pair 1), product s = g % 3
  if (act) {
    const int s = g % 3;
    int32_t a[N], b[N];
    g2_operand(a, T + (g < 3 ? 4 : 10) * N, s);
    if (s < 2) {
#pragma unroll
      for (int i = 0; i < N; ++i) b[i] = c_consts[(fold::ROW_CURVE + s) * N + i];
    } else {
#pragma unroll
      for (int i = 0; i < N; ++i) b[i] = c_consts[fold::ROW_CURVE * N + i] + c_consts[(fold::ROW_CURVE + 1) * N + i];
      fe_carry(b);
    }
    fe_mul_inline(a, a, b);
    g2_st32(M + g * N, a);
  }
  __syncwarp();
  // t1 - b3 t2 into t0's rows, b3 Y3 into Y3's, t1 + b3 t2 (Z3) into t2's
  // (component g & 1)
  if (act) {
    const int k = g & 1, kind = g >> 1;
    int32_t r[N], x[N];
    g2_kara(r, M, kind == 1 ? 1 : 0, k);
    if (kind != 1) {
      g2_ld32(x, T + (2 + k) * N);
#pragma unroll
      for (int i = 0; i < N; ++i) r[i] = kind == 0 ? x[i] - r[i] : x[i] + r[i];
      fe_carry(r);
    }
    g2_st32(T + (2 * (kind == 0 ? 0 : (kind == 1 ? 5 : 2)) + k) * N, r);
  }
  __syncwarp();
  // round 3: (t3, t1), (t4, Y3), (t1, Z3), (Y3, X3), (Z3, t4), (X3, t3), the
  // operands' rows after T's first in units of two: A = 3, 4, 0, 5, 2, 6;
  // B = 0, 5, 2, 6, 4, 3
  if (act) {
    const int32_t* A = T + 2 * ((0x625043 >> (4 * g)) & 15) * N;
    const int32_t* B = T + 2 * ((0x346250 >> (4 * g)) & 15) * N;
#pragma unroll 1
    for (int s = 0; s < 3; ++s) {
      int32_t a[N], b[N];
      g2_operand(a, A, s);
      g2_operand(b, B, s);
      fe_mul_inline(a, a, b);
      g2_st32(M + (3 * g + s) * N, a);
    }
  }
  __syncwarp();
  // out row g: X = p1 - p2, Y = p3 + p4, Z = p5 + p6 (component g & 1)
  if (act) {
    const int c = g >> 1, k = g & 1;
    int32_t r[N], x[N];
    g2_kara(r, M, 2 * c, k);
    g2_kara(x, M, 2 * c + 1, k);
    g2_add_carry(r, x, c == 0 ? -1 : 1);
    g2_st16(out + g * N, r);
  }
  __syncwarp();
}

// Dynamic shared memory of the G2 sum kernels.
__device__ __forceinline__ int4* g2_smem() {
  extern __shared__ int4 g2_smem_words[];
  return g2_smem_words;
}

// Sum of the K int16 points row(0), ..., row(K - 1) of one lane in the
// plain version's tree order, by the whole block (blockDim.x = 32 * warps);
// the sum, widened, goes to lane `lane` of out, (ROWS, N, lanes) int32.
// Shared memory: g2::smem_bytes(K, warps). row(k) is called for k < K only.
template <class Row>
__device__ __forceinline__ void g2_tree_sum(Row row, int K, int32_t* __restrict__ out, int lane,
                                           int lanes) {
  using namespace g2;
  const int warps = blockDim.x >> 5;
  const int w = threadIdx.x >> 5;
  const int grp = (threadIdx.x & 31) / GROUP;
  const int g = (threadIdx.x & 31) - grp * GROUP;
  int16_t* store = reinterpret_cast<int16_t*>(g2_smem());
  int32_t* scr = reinterpret_cast<int32_t*>(store + (size_t)((K + 1) / 2) * POINT) +
                 (w * PADDS_PER_WARP + (grp < PADDS_PER_WARP ? grp : 0)) * SCRATCH;
  bool first = true;  // level 1 reads row(), later levels the store
  for (int n = K; n > 1; n = n / 2 + (n & 1)) {
    const int half = n / 2;
    // warp-uniform loop: every thread of a warp meets the padd's __syncwarp
    for (int base = w * PADDS_PER_WARP; base < half; base += warps * PADDS_PER_WARP) {
      const bool act = grp < PADDS_PER_WARP && base + grp < half;
      const int i = act ? base + grp : 0;
      const int16_t* P = first ? row(i) : store + (size_t)i * POINT;
      const int16_t* Q = first ? row(i + half) : store + (size_t)(i + half) * POINT;
      g2_padd_coop(store + (size_t)i * POINT, P, Q, scr, g, act);
    }
    if (n & 1) {
      __syncthreads();  // padd 0 has read slot `half`
      const int4* last = reinterpret_cast<const int4*>(first ? row(n - 1) : store + (size_t)(n - 1) * POINT);
      int4* dst = reinterpret_cast<int4*>(store + (size_t)half * POINT);
      for (int t = threadIdx.x; t < POINT / 8; t += blockDim.x) dst[t] = last[t];
    }
    __syncthreads();
    first = false;
  }
  const int16_t* sum = K == 1 ? row(0) : store;
  for (int t = threadIdx.x; t < POINT; t += blockDim.x) out[(size_t)t * lanes + lane] = sum[t];
}

// Host side of a launch: the geometry's checks and the dynamic shared
// memory attribute (set on the current device for every launch, since the
// mesh may run the kernel on several cards). Returns the CUDA error.
template <class Kernel>
inline cudaError_t g2_prepare(Kernel kernel, int K, int warps, int smem) {
  if (K < 1 || warps < 1 || warps > g2::MAX_WARPS || smem < 0 || (size_t)smem < g2::smem_bytes(K, warps))
    return cudaErrorInvalidValue;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
}
