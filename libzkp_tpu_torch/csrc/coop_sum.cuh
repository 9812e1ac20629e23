// Cooperative point additions: a BN254 G1 or G2 padd shared by six threads
// (or a G2 padd by 18) of a warp, an ed25519 padd or pdouble by four, on
// int16 operands in shared memory, and the plain version's halving tree over
// one lane's K points built on them (tree_sum on every curve, window_sum4
// G1 and G2, window_sum ed25519; the Horner steps chain them,
// coop_horner.cuh).
//
// Both padds are RCB'15 algorithm 7 as the plain WeierstrassEngine.padd
// (ops/weierstrass.py, and the JAX package's) orders it: round 1, the six
// independent products t0, t1, t2, t3, t4, X3; the rows between (the
// subtractions, the two b3 products, Z3 and t1 - b3 t2); round 3, the six
// output products; the output rows. Each row is the same integer operation
// on the same operands as in the plain padd, so the limbs equal the plain
// version's and JAX's, and the int32 headroom argument of fold_curves.cuh
// holds unchanged. The stages
// meet at __syncwarp: a group never leaves its warp. Five groups fill a warp
// (lanes 30 and 31 idle; an 18-thread group leaves lanes 18 to 31 idle); a
// group with no padd passes act = false and still meets every __syncwarp.
// out may be P or Q: P and Q are read in round 1 only, out written last.
//
// G2 (g2_padd_coop). The coordinates are Fq2 elements and each product of
// the formula a Karatsuba Fq2 product of three Fq products: 18 in round 1,
// 6 for the two b3 products, 18 in round 3. Thread g takes Karatsuba pair g
// of rounds 1 and 3 (its m0, m1 and t products, one after the other) and one
// product of round 2. Each product is fe_mul_inline on register arrays: the
// thread builds both operands in registers (loads, adds and the Karatsuba
// sums with their carries), multiplies, and stores the 24 limbs to the
// group's scratch. Between the rounds the adds, subs and carries (the 12
// Karatsuba rows of round 1, then 8, 6 and 6 rows) are spread over the six
// threads the same way, one row at a time, each value computed once.
// g2_padd_coop18 (horner G2, pair_add G2) runs the same stages and rows on
// 18 threads: one Fq product a thread in rounds 1 and 3 (product g % 3 of
// pair g / 3, at M's row g), one Karatsuba row a thread after round 1 and
// X3 = 3 t0 on threads 6 and 7, so a padd's latency is 3 products against 7. It is a
// function of its own: folding both into one template over the group cost
// the six-thread kernels about 3 % (registers and time, paired on the card).
// Scratch, 32 int32 rows (3072 bytes): M, rows 0..17, the products of a
// round (Karatsuba pair j's m0, m1, t at rows 3j .. 3j + 2); T, rows 18..29,
// six Fq2 values (c0, c1): t0, t1, t2, t3, t4, X3 of round 1, then in place
// t3 -= t0 + t1, t4 -= t1 + t2, Y3 = X3 - (t0 + t2), then after round 2
// t1 - b3 t2 in t0's rows, t1 + b3 t2 (Z3) in t2's, b3 Y3 in Y3's; X, rows
// 30..31, X3 = 3 t0.
//
// G1 (g1_padd_coop). The coordinates are Fq elements and b3 = 9 a small
// multiply, so thread g computes one product of round 1 and one of round 3:
// a padd's latency is two products, against twelve in one thread. The rows
// between are six independent values, one a thread, in one stage: X3 =
// 3 t0; t1 - b3 t2 and Z3 = t1 + b3 t2 (b3 t2 computed by both threads, the
// same integers); t3 -= t0 + t1, t4 -= t1 + t2, Y3 = X3 - (t0 + t2) then
// b3 Y3. Scratch, 15 int32 rows (1440 bytes): T, rows 0..8, t0, t1, t2, t3,
// t4, X3 of round 1 (t3, t4 and X3 rewritten in place into t3, t4, b3 Y3),
// then 3 t0, t1 - b3 t2, Z3; M, rows 9..14, the six products of round 3.
//
// Tree (coop_tree_sum). Level by level in the order of ops/edwards.py
// _tree_reduce: point i plus point i + half for i < half, the odd last point
// carried to slot half. Level 1 reads its pairs from the caller's rows
// (global memory), later levels from the level store: ceil(K/2) int16
// points in shared memory, written in place (padd i writes slot i, which no
// other padd of its level reads). A padd output's limbs lie in [-7643, 11737]
// (BN254, fold_curves.cuh) or [-1536, 5631] (ed25519, below), so int16 holds
// them exactly. A block runs Cp::PER_WARP padds a warp.
//
// ed25519 (ed_padd_coop, ed_pdouble_coop). add-2008-hwcd-3 and
// dbl-2008-hwcd as the plain EdwardsEngine.padd and pdouble order them
// fall in rounds of four independent products, so four threads share one:
// eight groups fill a warp with no idle lane. padd: round 1, thread g
// computes product g of A = carry(Y1 - X1) carry(Y2 - X2), B = carry(Y1 +
// X1) carry(Y2 + X2), T1 T2, Z1 Z2 in registers; thread 2 goes on to C =
// (T1 T2) 2d, thread 3 to D = carry(Z1Z2 + Z1Z2); each stores its row.
// Round 3: thread g builds the two operands of its product X3 = E F, Y3 =
// G H, Z3 = F G, T3 = E H from the rows (E = carry(B - A), F = carry(D -
// C), G = carry(D + C), H = carry(B + A): each value computed by two
// threads from the same integers, as g1_padd_coop does with b3 t2),
// multiplies and stores coordinate g. A padd's latency is three products
// (thread 2's chain), against nine in one thread. pdouble: round 1, X^2, Y^2, Z^2 (then C = carry(Z^2 + Z^2)) and
// carry(X + Y)^2; round 2 from the rows, H = carry(A + B), G = carry(A - B),
// E = carry(H - (X + Y)^2), F = carry(G + C), the same four products: two
// products against eight. Scratch, 4 int32 rows (384 bytes): padd A, B, C,
// D; pdouble A, B, C, (X + Y)^2. Every row is the plain version's integer
// operation on the same operands, so the limbs equal it. The products run
// ed_mul, the fold product with p = 2^255 - 19's 52 nonzero fold and 2
// nonzero wrap constants in the code (below): the same sums, without the
// 572 zero terms and 624 constant-memory reads of fe_mul_inline.
//
// ed25519 interval (tests/test_torch_ed_coop.py::test_edwards_int32_headroom,
// interval arithmetic over every add, sub, carry, conv column and fold row of
// padd and pdouble with p = 2^255 - 19's ONE, FOLD and 2d limbs): from
// canonical limbs [0, 4095], every padd and pdouble output limb lies in
// [-1536, 5631], that interval is closed under both, and every intermediate
// stays below 2^28.68 < 2^31. ONE = 2^288 mod p = 19 * 2^33 has two nonzero
// limbs (1536 in limb 2, 2 in limb 3), so a wrap carry moves little: a top
// carry of -1 gives the low end. The identity (0 : 1 : 1 : 0) and every
// table row are canonical or padd outputs, so the narrowing to int16 of the
// tree's level store and the Horner chain's points is exact.
#pragma once

#include "fold_curves.cuh"

namespace coop {

constexpr int GROUP = 6;             // threads of one padd
constexpr int PADDS_PER_WARP = 5;    // 32 / GROUP
constexpr int MAX_WARPS = 12;        // 384 threads: at most 168 registers a thread

}  // namespace coop

// -- rows: 24 limbs, as int16 (48 bytes) or int32 (96 bytes), 16-byte aligned

__device__ __forceinline__ void row_ld16(int32_t* r, const int16_t* p) {
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

__device__ __forceinline__ void row_st16(int16_t* p, const int32_t* r) {
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

__device__ __forceinline__ void row_ld32(int32_t* r, const int32_t* p) {
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

__device__ __forceinline__ void row_st32(int32_t* p, const int32_t* r) {
  int4* dst = reinterpret_cast<int4*>(p);
#pragma unroll
  for (int w = 0; w < 6; ++w) dst[w] = make_int4(r[4 * w], r[4 * w + 1], r[4 * w + 2], r[4 * w + 3]);
}

// r = carry(r + sign * x), sign = +1 or -1
__device__ __forceinline__ void row_add_carry(int32_t* r, const int32_t* x, int32_t sign) {
#pragma unroll
  for (int i = 0; i < fold::N; ++i) r[i] += sign * x[i];
  fe_carry(r);
}

// ---------------------------------------------------------------------------
// G2
// ---------------------------------------------------------------------------

namespace g2 {

constexpr int ROW_T = 18;            // scratch rows, as above
constexpr int ROW_X = 30;

}  // namespace g2

// Component k of Karatsuba pair j from its products m0, m1, t (rows 3j ..
// 3j + 2 of M): c0 = carry(m0 - m1), c1 = carry(carry(t - m0) - m1).
__device__ __forceinline__ void g2_kara(int32_t* r, const int32_t* M, int j, int k) {
  using fold::N;
  int32_t x[N];
  row_ld32(r, M + (3 * j + (k ? 2 : 0)) * N);
  row_ld32(x, M + (3 * j + (k ? 0 : 1)) * N);
  row_add_carry(r, x, -1);
  if (k) {
    row_ld32(x, M + (3 * j + 1) * N);
    row_add_carry(r, x, -1);
  }
}

// Row k of round 1's operand j of the int16 point pt: coordinate j (j < 3,
// X, Y, Z) or the carried sum X+Y, Y+Z, X+Z (j = 3, 4, 5).
__device__ __forceinline__ void g2_r1_row(int32_t* r, const int16_t* pt, int j, int k) {
  using fold::N;
  row_ld16(r, pt + (2 * (j < 3 ? j : (j == 4 ? 1 : 0)) + k) * N);
  if (j >= 3) {
    int32_t x[N];
    row_ld16(x, pt + (2 * (j == 3 ? 1 : 2) + k) * N);
    row_add_carry(r, x, 1);
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
    row_add_carry(r, x, 1);
  }
}

// Karatsuba operand of product s of the Fq2 element at rows c0 (p) and c1
// (p + N) of the scratch.
__device__ __forceinline__ void g2_operand(int32_t* r, const int32_t* p, int s) {
  if (s < 2) {
    row_ld32(r, p + s * fold::N);
  } else {
    int32_t x[fold::N];
    row_ld32(r, p);
    row_ld32(x, p + fold::N);
    row_add_carry(r, x, 1);
  }
}

// out = P + Q (int16 G2 points), by the six threads g = 0..5 of one group
// with scratch scr.
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
      row_st32(M + (3 * g + s) * N, a);
    }
  }
  __syncwarp();
  // T: t0, t1, t2, t3, t4, X3 from the Karatsuba pairs, pair g
  if (act) {
#pragma unroll 1
    for (int k = 0; k < 2; ++k) {
      int32_t r[N];
      g2_kara(r, M, g, k);
      row_st32(T + (2 * g + k) * N, r);
    }
  }
  __syncwarp();
  // t3 = carry(t3 - carry(t0 + t1)), t4 = carry(t4 - carry(t1 + t2)),
  // Y3 = carry(X3 - carry(t0 + t2)) in place (v = 3, 4, 5; component g & 1),
  // then X3 = carry(t0 + t0 + t0)
  if (act) {
    const int v = 3 + (g >> 1), k = g & 1;
    int32_t r[N], x[N];
    row_ld32(r, T + (2 * (v == 4 ? 1 : 0) + k) * N);
    row_ld32(x, T + (2 * (v == 3 ? 1 : 2) + k) * N);
    row_add_carry(r, x, 1);
    row_ld32(x, T + (2 * v + k) * N);
#pragma unroll
    for (int i = 0; i < N; ++i) r[i] = x[i] - r[i];
    fe_carry(r);
    row_st32(T + (2 * v + k) * N, r);
    if (g < 2) {
      row_ld32(r, T + g * N);
#pragma unroll
      for (int i = 0; i < N; ++i) r[i] = r[i] + r[i] + r[i];
      fe_carry(r);
      row_st32(X + g * N, r);
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
    row_st32(M + g * N, a);
  }
  __syncwarp();
  // t1 - b3 t2 into t0's rows, b3 Y3 into Y3's, t1 + b3 t2 (Z3) into t2's
  // (component g & 1)
  if (act) {
    const int k = g & 1, kind = g >> 1;
    int32_t r[N], x[N];
    g2_kara(r, M, kind == 1 ? 1 : 0, k);
    if (kind != 1) {
      row_ld32(x, T + (2 + k) * N);
#pragma unroll
      for (int i = 0; i < N; ++i) r[i] = kind == 0 ? x[i] - r[i] : x[i] + r[i];
      fe_carry(r);
    }
    row_st32(T + (2 * (kind == 0 ? 0 : (kind == 1 ? 5 : 2)) + k) * N, r);
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
      row_st32(M + (3 * g + s) * N, a);
    }
  }
  __syncwarp();
  // out row g: X = p1 - p2, Y = p3 + p4, Z = p5 + p6 (component g & 1)
  if (act) {
    const int c = g >> 1, k = g & 1;
    int32_t r[N], x[N];
    g2_kara(r, M, 2 * c, k);
    g2_kara(x, M, 2 * c + 1, k);
    row_add_carry(r, x, c == 0 ? -1 : 1);
    row_st16(out + g * N, r);
  }
  __syncwarp();
}

// out = P + Q (int16 G2 points), by the 18 threads g = 0..17 of one group
// with scratch scr: g2_padd_coop's stages and rows, one product a thread in
// rounds 1 and 3 (above).
__device__ __forceinline__ void g2_padd_coop18(int16_t* out, const int16_t* P, const int16_t* Q,
                                              int32_t* scr, int g, bool act) {
  using fold::N;
  int32_t* M = scr;
  int32_t* T = scr + g2::ROW_T * N;
  int32_t* X = scr + g2::ROW_X * N;
  if (act) {  // round 1: product s of pair j
    const int j = g / 3, s = g - 3 * (g / 3);
    int32_t a[N], b[N];
    g2_r1_operand(a, P, j, s);
    g2_r1_operand(b, Q, j, s);
    fe_mul_inline(a, a, b);
    row_st32(M + g * N, a);
  }
  __syncwarp();
  if (act && g < 12) {  // T row g: component g & 1 of pair g >> 1
    int32_t r[N];
    g2_kara(r, M, g >> 1, g & 1);
    row_st32(T + g * N, r);
  }
  __syncwarp();
  if (act && g < 8) {  // t3, t4, Y3 in place (g < 6), X3 = 3 t0 (g = 6, 7)
    int32_t r[N], x[N];
    if (g < 6) {
      const int v = 3 + (g >> 1), k = g & 1;
      row_ld32(r, T + (2 * (v == 4 ? 1 : 0) + k) * N);
      row_ld32(x, T + (2 * (v == 3 ? 1 : 2) + k) * N);
      row_add_carry(r, x, 1);
      row_ld32(x, T + (2 * v + k) * N);
#pragma unroll
      for (int i = 0; i < N; ++i) r[i] = x[i] - r[i];
      fe_carry(r);
      row_st32(T + (2 * v + k) * N, r);
    } else {
      row_ld32(r, T + (g - 6) * N);
#pragma unroll
      for (int i = 0; i < N; ++i) r[i] = r[i] + r[i] + r[i];
      fe_carry(r);
      row_st32(X + (g - 6) * N, r);
    }
  }
  __syncwarp();
  if (act && g < 6) {  // round 2
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
    row_st32(M + g * N, a);
  }
  __syncwarp();
  if (act && g < 6) {  // t1 - b3 t2, b3 Y3, Z3
    const int k = g & 1, kind = g >> 1;
    int32_t r[N], x[N];
    g2_kara(r, M, kind == 1 ? 1 : 0, k);
    if (kind != 1) {
      row_ld32(x, T + (2 + k) * N);
#pragma unroll
      for (int i = 0; i < N; ++i) r[i] = kind == 0 ? x[i] - r[i] : x[i] + r[i];
      fe_carry(r);
    }
    row_st32(T + (2 * (kind == 0 ? 0 : (kind == 1 ? 5 : 2)) + k) * N, r);
  }
  __syncwarp();
  if (act) {  // round 3: product s of pair j
    const int j = g / 3, s = g - 3 * (g / 3);
    const int32_t* A = T + 2 * ((0x625043 >> (4 * j)) & 15) * N;
    const int32_t* B = T + 2 * ((0x346250 >> (4 * j)) & 15) * N;
    int32_t a[N], b[N];
    g2_operand(a, A, s);
    g2_operand(b, B, s);
    fe_mul_inline(a, a, b);
    row_st32(M + g * N, a);
  }
  __syncwarp();
  if (act && g < 6) {  // out row g
    const int c = g >> 1, k = g & 1;
    int32_t r[N], x[N];
    g2_kara(r, M, 2 * c, k);
    g2_kara(x, M, 2 * c + 1, k);
    row_add_carry(r, x, c == 0 ? -1 : 1);
    row_st16(out + g * N, r);
  }
  __syncwarp();
}

// ---------------------------------------------------------------------------
// G1
// ---------------------------------------------------------------------------

// Round 1's operand j of the int16 G1 point pt: coordinate j (j < 3, X, Y,
// Z) or the carried sum X+Y, Y+Z, X+Z (j = 3, 4, 5).
__device__ __forceinline__ void g1_r1_operand(int32_t* r, const int16_t* pt, int j) {
  using fold::N;
  row_ld16(r, pt + (j < 3 ? j : (j == 4 ? 1 : 0)) * N);
  if (j >= 3) {
    int32_t x[N];
    row_ld16(x, pt + (j == 3 ? 1 : 2) * N);
    row_add_carry(r, x, 1);
  }
}

// out = P + Q (int16 G1 points), by the six threads g = 0..5 of one group
// with scratch scr. Rounds 1 and 3 run through one product call site: two
// inlined products made every G1 kernel's code larger and window_sum4 G1 7 %
// slower (paired on the card).
__device__ __forceinline__ void g1_padd_coop(int16_t* out, const int16_t* P, const int16_t* Q,
                                            int32_t* scr, int g, bool act) {
  using fold::N;
  int32_t* T = scr;
  int32_t* M = scr + 9 * N;  // after T's 9 rows
#pragma unroll 1
  for (int rnd = 0; rnd < 2; ++rnd) {
    // round 1: product g, (X1, X2), (Y1, Y2), (Z1, Z2), (X1+Y1, X2+Y2),
    // (Y1+Z1, Y2+Z2), (X1+Z1, X2+Z2): t0, t1, t2, t3, t4, X3 in T's rows
    // 0..5; round 3: (t3, t1), (t4, Y3), (t1, Z3), (Y3, X3), (Z3, t4),
    // (X3, t3), the operands' rows A = 3, 4, 7, 5, 8, 6; B = 7, 5, 8, 6, 4,
    // 3, into M's rows
    if (act) {
      int32_t a[N], b[N];
      if (rnd == 0) {
        g1_r1_operand(a, P, g);
        g1_r1_operand(b, Q, g);
      } else {
        row_ld32(a, T + ((0x685743 >> (4 * g)) & 15) * N);
        row_ld32(b, T + ((0x346857 >> (4 * g)) & 15) * N);
      }
      fe_mul_inline(a, a, b);
      row_st32((rnd == 0 ? T : M) + g * N, a);
    }
    __syncwarp();
    if (rnd == 1) break;
    // one value a thread: g = 0, X3 = carry(t0 + t0 + t0) into row 6; g = 1,
    // 2, b3 t2 = smul(t2, 9) (the plain _mul_b3), then t1 - b3 t2 into row 7
    // and Z3 = t1 + b3 t2 into row 8; g = 3, 4, 5 in place, t3 = carry(t3 -
    // carry(t0 + t1)), t4 = carry(t4 - carry(t1 + t2)), Y3 = carry(X3 -
    // carry(t0 + t2)), then b3 Y3 = smul(Y3, 9)
    if (act) {
      int32_t r[N], x[N];
      if (g == 0) {
        row_ld32(r, T);
#pragma unroll
        for (int i = 0; i < N; ++i) r[i] = r[i] + r[i] + r[i];
        fe_carry(r);
        row_st32(T + 6 * N, r);
      } else if (g < 3) {
        row_ld32(x, T + 2 * N);
        fe_smul(x, x, 9);
        row_ld32(r, T + N);
        row_add_carry(r, x, g == 1 ? -1 : 1);
        row_st32(T + (6 + g) * N, r);
      } else {
        row_ld32(r, T + (g == 4 ? 1 : 0) * N);
        row_ld32(x, T + (g == 3 ? 1 : 2) * N);
        row_add_carry(r, x, 1);
        row_ld32(x, T + g * N);
#pragma unroll
        for (int i = 0; i < N; ++i) r[i] = x[i] - r[i];
        fe_carry(r);
        if (g == 5) fe_smul(r, r, 9);
        row_st32(T + g * N, r);
      }
    }
    __syncwarp();
  }
  // out row g < 3: X = p1 - p2, Y = p3 + p4, Z = p5 + p6
  if (act && g < 3) {
    int32_t r[N], x[N];
    row_ld32(r, M + 2 * g * N);
    row_ld32(x, M + (2 * g + 1) * N);
    row_add_carry(r, x, g == 0 ? -1 : 1);
    row_st16(out + g * N, r);
  }
  __syncwarp();
}

// ---------------------------------------------------------------------------
// ed25519
// ---------------------------------------------------------------------------

// The field product for p = 2^255 - 19 (ed_mul): fe_mul_inline's integer
// operations with the consts block's ONE and FOLD rows written into the
// code and their zero limbs left out. ONE = 2^288 mod p has two nonzero
// limbs (limb 2 = 1536, limb 3 = 2) and FOLD 52 of its 624: row k < 19 is
// 19 * 2^(33 + 12k), limbs 2 + k = 1536 and 3 + k = 2; row k >= 19 wraps
// once more, limbs k - 19 = 2624 and k - 18 = 5 (ops/limbfold.py FoldCtx,
// pinned by tests/test_torch_ed_coop.py). Every sum keeps its nonzero terms,
// so the limbs are fe_mul_inline's. The generic fold reads 624 constants a
// product; this one multiplies 52 by immediates (K1 2.4x and K2 2x faster,
// paired on the card).
__device__ __forceinline__ void ed_carry(int32_t* x) {
  using namespace fold;
  const int32_t top = x[N - 1] >> LIMB_BITS;
#pragma unroll
  for (int i = N - 1; i > 0; --i) x[i] = (x[i] & MASK) + (x[i - 1] >> LIMB_BITS);
  x[0] &= MASK;
  x[2] += top * 1536;
  x[3] += top * 2;
}

// r = a * b mod 2^255 - 19, as fe_mul_inline; r may alias a or b.
__device__ __forceinline__ void ed_mul(int32_t* r, const int32_t* a, const int32_t* b) {
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
#pragma unroll
  for (int pass = 0; pass < 2; ++pass) {
#pragma unroll
    for (int k = NCOL - 1; k > 0; --k) t[k] = (t[k] & MASK) + (t[k - 1] >> LIMB_BITS);
    t[0] &= MASK;
  }
#pragma unroll
  for (int i = 0; i < N; ++i) {  // t[i] + sum over k of t[N + k] * FOLD[k][i], nonzero terms
    int32_t acc = t[i];
    if (i >= 2 && i <= 20) acc += t[N + i - 2] * 1536;  // k = i - 2 < 19
    if (i >= 3 && i <= 21) acc += t[N + i - 3] * 2;     // k = i - 3 < 19
    if (i <= 6) acc += t[N + i + 19] * 2624;            // k = i + 19
    if (i >= 1 && i <= 7) acc += t[N + i + 18] * 5;     // k = i + 18 >= 19
    r[i] = acc;
  }
  ed_carry(r);
  ed_carry(r);
  ed_carry(r);
}

// Row v of the padd's round 3 operands from the rows A, B, C, D of scr: v =
// 0, E = carry(B - A); 1, F = carry(D - C); 2, G = carry(D + C); 3, H =
// carry(B + A).
__device__ __forceinline__ void ed_padd_row(int32_t* r, const int32_t* scr, int v) {
  using fold::N;
  int32_t x[N];
  const int base = (v == 1 || v == 2) ? 2 : 0;
  row_ld32(r, scr + (base + 1) * N);
  row_ld32(x, scr + base * N);
  row_add_carry(r, x, v >= 2 ? 1 : -1);
}

// Row v (as in ed_padd_row) of the pdouble's round 2 operands from the rows
// A, B, C, (X + Y)^2 of scr: H = carry(A + B), G = carry(A - B), E =
// carry(H - (X + Y)^2), F = carry(G + C).
__device__ __forceinline__ void ed_pdouble_row(int32_t* r, const int32_t* scr, int v) {
  using fold::N;
  int32_t x[N];
  row_ld32(r, scr);
  row_ld32(x, scr + N);
  row_add_carry(r, x, (v == 0 || v == 3) ? 1 : -1);  // E, H from H; F, G from G
  if (v < 2) {
    row_ld32(x, scr + (v == 0 ? 3 : 2) * N);
    row_add_carry(r, x, v == 0 ? -1 : 1);
  }
}

// Round 3 of padd and round 2 of pdouble: thread g multiplies its operands
// (E, F), (G, H), (F, G), (E, H), rows (0, 1), (2, 3), (1, 2), (0, 3) of
// ed_padd_row or ed_pdouble_row, into coordinate g of out: X3, Y3, Z3, T3.
template <bool DOUBLE>
__device__ __forceinline__ void ed_out_coop(int16_t* out, const int32_t* scr, int g) {
  using fold::N;
  int32_t a[N], b[N];
  const int va = (0x0120 >> (4 * g)) & 15, vb = (0x3231 >> (4 * g)) & 15;
  if (DOUBLE) {
    ed_pdouble_row(a, scr, va);
    ed_pdouble_row(b, scr, vb);
  } else {
    ed_padd_row(a, scr, va);
    ed_padd_row(b, scr, vb);
  }
  ed_mul(a, a, b);
  row_st16(out + g * N, a);
}

// out = P + Q (int16 extended points X, Y, Z, T), by the four threads
// g = 0..3 of one group with scratch scr (4 int32 rows).
__device__ __forceinline__ void ed_padd_coop(int16_t* out, const int16_t* P, const int16_t* Q,
                                            int32_t* scr, int g, bool act) {
  using fold::N;
  // round 1, product g: A, B (carry(Y -/+ X) of both points), T1 T2, Z1 Z2;
  // then C = (T1 T2) 2d (g = 2), D = carry(Z1Z2 + Z1Z2) (g = 3); row g
  if (act) {
    int32_t a[N], b[N];
    if (g < 2) {
      int32_t x[N];
      row_ld16(a, P + N);
      row_ld16(x, P);
      row_add_carry(a, x, g ? 1 : -1);
      row_ld16(b, Q + N);
      row_ld16(x, Q);
      row_add_carry(b, x, g ? 1 : -1);
    } else {
      row_ld16(a, P + (g == 2 ? 3 : 2) * N);
      row_ld16(b, Q + (g == 2 ? 3 : 2) * N);
    }
    ed_mul(a, a, b);
    if (g == 2) {
#pragma unroll
      for (int i = 0; i < N; ++i) b[i] = c_consts[fold::ROW_CURVE * N + i];
      ed_mul(a, a, b);
    } else if (g == 3) {
#pragma unroll
      for (int i = 0; i < N; ++i) a[i] = a[i] + a[i];
      fe_carry(a);
    }
    row_st32(scr + g * N, a);
  }
  __syncwarp();
  if (act) ed_out_coop<false>(out, scr, g);
  __syncwarp();
}

// out = 2P (int16 extended points), by the four threads g = 0..3 of one
// group with scratch scr (4 int32 rows).
__device__ __forceinline__ void ed_pdouble_coop(int16_t* out, const int16_t* P, int32_t* scr, int g,
                                               bool act) {
  using fold::N;
  // round 1, square g: X^2, Y^2, Z^2 (then C = carry(Z^2 + Z^2)),
  // carry(X + Y)^2; row g
  if (act) {
    int32_t a[N];
    row_ld16(a, P + (g < 3 ? g : 0) * N);
    if (g == 3) {
      int32_t x[N];
      row_ld16(x, P + N);
      row_add_carry(a, x, 1);
    }
    ed_mul(a, a, a);
    if (g == 2) {
#pragma unroll
      for (int i = 0; i < N; ++i) a[i] = a[i] + a[i];
      fe_carry(a);
    }
    row_st32(scr + g * N, a);
  }
  __syncwarp();
  if (act) ed_out_coop<true>(out, scr, g);
  __syncwarp();
}

// ---------------------------------------------------------------------------
// The curves' cooperative padds and the tree
// ---------------------------------------------------------------------------

// Each Cp: its group's threads, groups a warp, point and scratch sizes,
// whether its pdouble is its padd, and padd and pdouble, both in place (out
// may be P or Q).
struct G1Coop {
  static constexpr int GROUP = coop::GROUP;              // threads of a padd
  static constexpr int PER_WARP = coop::PADDS_PER_WARP;  // padds a warp
  static constexpr int COORDS = 3;                       // coordinate rows of a point
  static constexpr int POINT = COORDS * fold::N;         // int16 limbs of a point
  static constexpr int SCRATCH = 15 * fold::N;           // int32 of one padd's scratch
  static constexpr bool PDOUBLE_IS_PADD = true;          // pdouble(p) is padd(p, p)
  static __device__ __forceinline__ void padd(int16_t* out, const int16_t* P, const int16_t* Q,
                                              int32_t* scr, int g, bool act) {
    g1_padd_coop(out, P, Q, scr, g, act);
  }
  static __device__ __forceinline__ void pdouble(int16_t* out, const int16_t* P, int32_t* scr, int g,
                                                 bool act) {
    g1_padd_coop(out, P, P, scr, g, act);  // a Weierstrass pdouble is padd(p, p)
  }
};

struct G2Coop {
  static constexpr int GROUP = coop::GROUP;
  static constexpr int PER_WARP = coop::PADDS_PER_WARP;
  static constexpr int COORDS = 6;
  static constexpr int POINT = COORDS * fold::N;
  static constexpr int SCRATCH = 32 * fold::N;
  static constexpr bool PDOUBLE_IS_PADD = true;
  static __device__ __forceinline__ void padd(int16_t* out, const int16_t* P, const int16_t* Q,
                                              int32_t* scr, int g, bool act) {
    g2_padd_coop(out, P, Q, scr, g, act);
  }
  static __device__ __forceinline__ void pdouble(int16_t* out, const int16_t* P, int32_t* scr, int g,
                                                 bool act) {
    g2_padd_coop(out, P, P, scr, g, act);  // a Weierstrass pdouble is padd(p, p)
  }
};

struct G2Coop18 {  // horner G2, pair_add G2: one 18-thread padd a warp
  static constexpr int GROUP = 18;
  static constexpr int PER_WARP = 1;
  static constexpr int COORDS = 6;
  static constexpr int POINT = COORDS * fold::N;
  static constexpr int SCRATCH = 32 * fold::N;
  static constexpr bool PDOUBLE_IS_PADD = true;
  static __device__ __forceinline__ void padd(int16_t* out, const int16_t* P, const int16_t* Q,
                                              int32_t* scr, int g, bool act) {
    g2_padd_coop18(out, P, Q, scr, g, act);
  }
  static __device__ __forceinline__ void pdouble(int16_t* out, const int16_t* P, int32_t* scr, int g,
                                                 bool act) {
    g2_padd_coop18(out, P, P, scr, g, act);  // a Weierstrass pdouble is padd(p, p)
  }
};

struct EdCoop {  // K1 window_sum, K2 horner, tree_sum ed25519: eight four-thread groups a warp
  static constexpr int GROUP = 4;
  static constexpr int PER_WARP = 8;
  static constexpr int COORDS = 4;
  static constexpr int POINT = COORDS * fold::N;
  static constexpr int SCRATCH = 4 * fold::N;
  static constexpr bool PDOUBLE_IS_PADD = false;  // dbl-2008-hwcd
  static __device__ __forceinline__ void padd(int16_t* out, const int16_t* P, const int16_t* Q,
                                              int32_t* scr, int g, bool act) {
    ed_padd_coop(out, P, Q, scr, g, act);
  }
  static __device__ __forceinline__ void pdouble(int16_t* out, const int16_t* P, int32_t* scr, int g,
                                                 bool act) {
    ed_pdouble_coop(out, P, scr, g, act);
  }
};

// Dynamic shared memory a tree-sum block of `warps` warps needs for K
// points: the level store, then one scratch per padd.
template <class Cp>
__host__ __device__ constexpr size_t coop_smem_bytes(int K, int warps) {
  return (size_t)((K + 1) / 2) * Cp::POINT * sizeof(int16_t) +
         (size_t)warps * Cp::PER_WARP * Cp::SCRATCH * sizeof(int32_t);
}

// Dynamic shared memory of the cooperative kernels.
__device__ __forceinline__ int4* coop_smem() {
  extern __shared__ int4 coop_smem_words[];
  return coop_smem_words;
}

// Sum of the K int16 points row(0), ..., row(K - 1) of one lane in the
// plain version's tree order, by the whole block (blockDim.x = 32 * warps);
// the sum, widened, goes to lane `lane` of out, (COORDS, N, lanes) int32.
// Shared memory: coop_smem_bytes<Cp>(K, warps). row(k) is called for k < K
// only.
template <class Cp, class Row>
__device__ __forceinline__ void coop_tree_sum(Row row, int K, int32_t* __restrict__ out, int lane,
                                              int lanes) {
  constexpr int POINT = Cp::POINT, GROUP = Cp::GROUP, PER_WARP = Cp::PER_WARP;
  const int warps = blockDim.x >> 5;
  const int w = threadIdx.x >> 5;
  const int grp = (threadIdx.x & 31) / GROUP;
  const int g = (threadIdx.x & 31) - grp * GROUP;
  int16_t* store = reinterpret_cast<int16_t*>(coop_smem());
  int32_t* scr = reinterpret_cast<int32_t*>(store + (size_t)((K + 1) / 2) * POINT) +
                 (w * PER_WARP + (grp < PER_WARP ? grp : 0)) * Cp::SCRATCH;
  bool first = true;  // level 1 reads row(), later levels the store
  for (int n = K; n > 1; n = n / 2 + (n & 1)) {
    const int half = n / 2;
    // warp-uniform loop: every thread of a warp meets the padd's __syncwarp
    for (int base = w * PER_WARP; base < half; base += warps * PER_WARP) {
      const bool act = grp < PER_WARP && base + grp < half;
      const int i = act ? base + grp : 0;
      const int16_t* P = first ? row(i) : store + (size_t)i * POINT;
      const int16_t* Q = first ? row(i + half) : store + (size_t)(i + half) * POINT;
      Cp::padd(store + (size_t)i * POINT, P, Q, scr, g, act);
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

// Host side of a launch: the geometry's checks (the block's warps and its
// dynamic shared memory, at least `need` bytes) and the dynamic shared
// memory attribute (set on the current device for every launch, since the
// mesh may run the kernel on several cards). Returns the CUDA error.
template <class Kernel>
inline cudaError_t coop_prepare(Kernel kernel, size_t need, int warps, int smem) {
  if (warps < 1 || warps > coop::MAX_WARPS || smem < 0 || (size_t)smem < need)
    return cudaErrorInvalidValue;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
}
