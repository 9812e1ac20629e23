// Probes of the field products and point additions the kernels inline,
// run on the production device functions of fold_curves.cuh, coop_sum.cuh
// and mont.cuh, so each measures what the kernels run.
//
// * padd_chain (P2) replaces scripts/bench_pallas_padd.py bench_current's
//   Pallas kernel: R chained Edwards padds per lane, p <- p + q, over
//   (4, N, B) int32, in one launch. Four threads share each padd (EdCoop,
//   coop_sum.cuh: three products of one thread a padd, against nine), on
//   coop_horner.cuh's chain kernel: p and q narrowed once to int16 points
//   in shared memory (encoded points, and every padd output limb lies in
//   [-1536, 5631]), eight lanes a warp, four-warp blocks (the wrapper's
//   CHAIN_WARPS): at B = 512 the 64 warps run on 16 SMs, one a scheduler,
//   so the time is the latency of a chain of 64 dependent padds, not the
//   card's throughput. Bound: R * 9 products of 576 + 52 multiply-adds per
//   lane.
// * fe_mul (P4) replaces scripts/bench_fold.py bench_field's Pallas kernel:
//   one fold product per lane, out = a * b over (N, E) int32, in the field
//   its launch is named for (p = 2^255 - 19 or BN254 Fq). Bound: bytes at
//   E = 2^20 (3 * N * 4 bytes a lane against 628 or 1140 multiply-adds).
//   One lane a thread, the product inlined on the lane's register arrays
//   with the field's constants in the code (coop_sum.cuh ed_mul,
//   bn254_fq.cuh bn_fq_mul): no stack frame, no constant-memory operand and
//   no consts copy before the launch, so the kernel reads only a and b. The
//   lanes of a warp sit on neighbouring words of each limb row, so loads
//   and stores coalesce; FE_MUL_THREADS a block. The ablation that
//   chip_smoke.py --fe-mul times against bn_fq_mul runs the same loads
//   around fe_mul_inline over the consts block in __constant__ (BN254 Fq's
//   constants as memory operands; fe_mul_bn254_g1_c_consts_launch).
//
// * mont_padd (P7) replaces scripts/bench_pallas_mul.py main.pallas_add: one
//   Edwards addition per lane in the Montgomery domain (point_add_val, 9
//   products of mont.cuh's mont_mul, the h pipeline's product) over
//   (4, 22, E) int32 limbs-major, p = 2^255 - 19, one lane per thread.
//   Bound: operations at E = 2^18, 9 * 990 multiply-adds per lane. Each
//   product is one inlined mont_mul on register arrays with p's constants
//   in the code (Mont25519), in a loop over the padd's 9 product steps
//   whose operands are rows of the lane's int16 points in shared memory:
//   no array has its address taken, so nothing lives in local memory (nine
//   out-of-line calls on pointer operands cost a 1584-byte frame a thread).
// * fold_ablate (P1) replaces scripts/bench_ablate.py run's Pallas kernel:
//   one part of the fold product alone per lane (the convolution as shifted
//   pads or grouped by j mod 8, 5 wrap carries, the fold of the 26 high
//   rows, 24 plain multiply-adds), at the port's n = 24 over (n, E) or
//   (2n + 2, E) int32 limbs-major, the variant an argument of the kernel.
//   The convolution keeps the script's `+ high * 0` with the zero a kernel
//   argument, so the compiler cannot drop the high columns. Bound: bytes.
// * padd_f32_chain (P3) replaces scripts/bench_pallas_padd.py bench_mxu's
//   Pallas kernel: R chained Edwards padds on float32 balanced 9-bit limbs
//   (29 limbs, 261 bits), p <- p + q over (4, 29, B). The TPU ran the
//   convolution, the fold and the carry shift as MXU dots; here they are FFMA
//   loops on register arrays (f32_mul, inlined once), the fold's 62 nonzero
//   constants and ONE written into the code. Four threads share a padd, as
//   EdCoop does (coop_sum.cuh): two rounds, three products of one thread a
//   padd, eight lanes a one-warp block, P, Q and the scratch rows in shared
//   memory. Exact because every partial sum is an integer below 2^24
//   (checked by tests/test_torch_probes.py), so the FMAs may run in any
//   order; the rounding carry (x + RND) - RND needs IEEE float addition, so
//   this source is built without --use_fast_math. Bound: R * 9 products of
//   841 + 62 FMAs per lane at the FP32 rate.
//
// P5 (scripts/bench_fold.py main.pl_add, one padd per lane) is exactly K3
// pair_add (pair_add.cu, on EdCoop) at its shape, so it has no kernel here.

#include "bn254_fq.cuh"
#include "coop_horner.cuh"
#include "mont.cuh"

namespace {

constexpr int MUL_THREADS = 256;  // fold_ablate's block
// P4's block: 128 threads were the fastest for ed25519 (106.6-107.4 us a
// launch against 108.2-109.0 at 256 and 117.4-118.0 at 512) and for BN254
// Fq (118.5-120.1 against 121.6-121.9 and 139.1-140.7), on an H100 80GB
// HBM3 at 700 W (chip_smoke.py --fe-mul, in turns)
constexpr int FE_MUL_THREADS = 128;

// The P4 products, r = a * b on register arrays, r aliasing a.
struct EdProduct {
  static __device__ __forceinline__ void mul(int32_t* r, const int32_t* a, const int32_t* b) { ed_mul(r, a, b); }
};

struct BnProduct {
  static __device__ __forceinline__ void mul(int32_t* r, const int32_t* a, const int32_t* b) { bn_fq_mul(r, a, b); }
};

// BN254 Fq's product on the consts block in __constant__: the same limbs as
// BnProduct, 1200 multiply-adds with constant-memory operands (the
// ablation only).
struct ConstProduct {
  static __device__ __forceinline__ void mul(int32_t* r, const int32_t* a, const int32_t* b) { fe_mul_inline(r, a, b); }
};

template <class Prod>
__global__ void __launch_bounds__(FE_MUL_THREADS)
fe_mul_kernel(const int32_t* __restrict__ a, const int32_t* __restrict__ b,
              int32_t* __restrict__ out, int E) {
  using namespace fold;
  const int e = blockIdx.x * FE_MUL_THREADS + threadIdx.x;
  if (e >= E) return;
  int32_t x[N], y[N];
#pragma unroll
  for (int i = 0; i < N; ++i) {
    x[i] = a[(size_t)i * E + e];
    y[i] = b[(size_t)i * E + e];
  }
  Prod::mul(x, x, y);
#pragma unroll
  for (int i = 0; i < N; ++i) out[(size_t)i * E + e] = x[i];
}

// ---- P7: Edwards addition in the Montgomery domain -----------------------

}  // namespace

namespace mp {
constexpr int N = 22;            // Montgomery limbs of 2^255 - 19
constexpr int W = N / 2;         // int32 words of a row of int16 limbs
constexpr int ROWS = 8;          // a lane's int16 rows
constexpr int MAX_THREADS = 256; // threads (lanes) a block
constexpr int STEPS = 9;         // the padd's products
constexpr int TWOD = 8;          // operand row 8: the block's 2d * R mod p
// Step s multiplies row (A_ROWS >> 4s) & 15 by row (B_ROWS >> 4s) & 15 into
// row (O_ROWS >> 4s) & 15 (s < 5) or coordinate s - 5 of out.
constexpr uint64_t A_ROWS = 0x032023310ull;
constexpr uint64_t B_ROWS = 0x121368754ull;
constexpr uint32_t O_ROWS = 0x23310u;
}  // namespace mp

namespace {

__device__ __forceinline__ uint32_t pack16(int32_t lo, int32_t hi) {
  return ((uint32_t)lo & 0xFFFFu) | ((uint32_t)hi << 16);
}

// Row `row` of int16 limbs, word w at row[w * stride], widened into r.
__device__ __forceinline__ void mp_ld(int32_t* r, const uint32_t* row, int stride) {
#pragma unroll
  for (int w = 0; w < mp::W; ++w) {
    const uint32_t v = row[w * stride];
    r[2 * w] = (int32_t)(int16_t)(v & 0xFFFFu);
    r[2 * w + 1] = (int32_t)v >> 16;
  }
}

__device__ __forceinline__ void mp_st(uint32_t* row, const int32_t* r, int stride) {
#pragma unroll
  for (int w = 0; w < mp::W; ++w) row[w * stride] = pack16(r[2 * w], r[2 * w + 1]);
}

// One Edwards addition per lane in mont_padd_plain's operations, one lane a
// thread. The lane's int16 rows in shared memory (word w of row r at
// rows[(r * W + w) * T + t], consecutive threads on consecutive words, so
// free of bank conflicts): X1, Y1, Z1, T1, X2, Y2, Z2, T2 as loaded, then
// (x, y) <- (carry(y - x), carry(y + x)) on rows (0, 1) and (4, 5): Y1 - X1,
// Y1 + X1, Z1, T1, Y2 - X2, Y2 + X2, Z2, T2. The nine product steps through
// one inlined product: A = 0 * 4 into row 0, B = 1 * 5 into 1, T1 T2 = 3 * 7
// into 3, C = 3 * 2d into 3, zz = 2 * 6 and D = carry(zz + zz) into 2; then
// the same pair step gives E = B - A, H = B + A in rows 0, 1 and F = D - C,
// G = D + C in rows 3, 2; X3 = E F = 0 * 3, Y3 = G H = 2 * 1, Z3 = F G =
// 3 * 2, T3 = E H = 0 * 1 go to out. Each sum, carry and product is the
// plain version's integer operation on the same operands, so the limbs
// equal mont_padd_plain's. int16 rows: the inputs' limbs lie in int16 (the
// wrapper's precondition; P7's are canonical Montgomery limbs) and every
// stored row's limbs do too, in [-1536, 7167] from canonical inputs
// (tests/test_torch_limb.py::test_int32_headroom): 352 bytes a lane.
__global__ void __launch_bounds__(mp::MAX_THREADS)
mont_padd_kernel(const int32_t* __restrict__ consts, const int32_t* __restrict__ p,
                 const int32_t* __restrict__ q, int32_t* __restrict__ out, int E) {
  using namespace mp;
  extern __shared__ uint32_t mp_smem[];
  const int T = blockDim.x, t = threadIdx.x;
  const int e = blockIdx.x * T + t;
  uint32_t* twod = mp_smem;         // W words, read once a block
  uint32_t* rows = mp_smem + W + t;  // this lane's word 0 of row 0
  if (t < W) twod[t] = pack16(consts[mont::ROW_CURVE * N + 2 * t], consts[mont::ROW_CURVE * N + 2 * t + 1]);
  __syncthreads();
  if (e >= E) return;
#pragma unroll 1
  for (int r = 0; r < ROWS; ++r) {  // coordinate r % 4 of p (r < 4) or q
    const int32_t* src = (r < 4 ? p : q) + (size_t)(r % 4) * N * E + e;
#pragma unroll
    for (int w = 0; w < W; ++w) rows[(r * W + w) * T] = pack16(src[(size_t)2 * w * E], src[(size_t)(2 * w + 1) * E]);
  }
#pragma unroll 1
  for (int s = 0; s < STEPS; ++s) {
    int32_t x[N], y[N];
    if (s == 0 || s == 5) {  // (x, y) <- (carry(y - x), carry(y + x)): X, Y of p, q; then A, B and C, D
#pragma unroll 1
      for (int k = 0; k < 2; ++k) {
        const int xr = s == 0 ? 4 * k : 3 * k;
        const int yr = s == 0 ? 4 * k + 1 : (k ? 2 : 1);
        mp_ld(x, rows + xr * W * T, T);
        mp_ld(y, rows + yr * W * T, T);
#pragma unroll
        for (int i = 0; i < N; ++i) {
          const int32_t d = y[i] - x[i];
          y[i] = y[i] + x[i];
          x[i] = d;
        }
        mont_carry<N>(x, Mont25519{});
        mont_carry<N>(y, Mont25519{});
        mp_st(rows + xr * W * T, x, T);
        mp_st(rows + yr * W * T, y, T);
      }
    }
    const int ra = (A_ROWS >> (4 * s)) & 15, rb = (B_ROWS >> (4 * s)) & 15;
    mp_ld(x, rows + ra * W * T, T);
    mp_ld(y, rb == TWOD ? twod : rows + rb * W * T, rb == TWOD ? 1 : T);
    mont_mul<N>(x, x, y, Mont25519{});
    if (s == 4) {  // D = carry(zz + zz)
#pragma unroll
      for (int i = 0; i < N; ++i) x[i] = x[i] + x[i];
      mont_carry<N>(x, Mont25519{});
    }
    if (s < 5) {
      mp_st(rows + ((O_ROWS >> (4 * s)) & 15) * W * T, x, T);
    } else {
#pragma unroll
      for (int i = 0; i < N; ++i) out[(size_t)((s - 5) * N + i) * E + e] = x[i];
    }
  }
}

// ---- P1: the parts of the fold product alone ------------------------------

enum AblateVariant { CONV = 0, CONV8 = 1, CARRY5 = 2, FOLD = 3, MAC = 4 };

__global__ void __launch_bounds__(MUL_THREADS)
fold_ablate_kernel(int variant, const int32_t* __restrict__ a, const int32_t* __restrict__ b,
                   int32_t* __restrict__ out, int E, int zero) {
  using namespace fold;
  const int e = blockIdx.x * MUL_THREADS + threadIdx.x;
  if (e >= E) return;
  int32_t r[N];
  if (variant == CONV || variant == CONV8 || variant == MAC) {
    int32_t x[N], y[N];
#pragma unroll
    for (int i = 0; i < N; ++i) {
      x[i] = a[(size_t)i * E + e];
      y[i] = b[(size_t)i * E + e];
    }
    if (variant == MAC) {
#pragma unroll
      for (int i = 0; i < N; ++i) r[i] = x[i] * y[0];
#pragma unroll
      for (int j = 1; j < N; ++j)
#pragma unroll
        for (int i = 0; i < N; ++i) r[i] += x[i] * y[j];
    } else {
      int32_t T[NCOL];
#pragma unroll
      for (int k = 0; k < NCOL; ++k) T[k] = 0;
      if (variant == CONV) {
#pragma unroll
        for (int j = 0; j < N; ++j)
#pragma unroll
          for (int i = 0; i < N; ++i) T[i + j] += x[i] * y[j];
      } else {  // grouped by j mod 8: aligned partial columns, then shifted in
#pragma unroll
        for (int g = 0; g < 8; ++g) {
          int32_t U[NCOL];
#pragma unroll
          for (int k = 0; k < NCOL; ++k) U[k] = 0;
#pragma unroll
          for (int j = g; j < N; j += 8)
#pragma unroll
            for (int i = 0; i < N; ++i) U[i + j - g] += x[i] * y[j];
#pragma unroll
          for (int k = 0; k + g < NCOL; ++k) T[k + g] += U[k];
        }
      }
#pragma unroll
      for (int i = 0; i < N; ++i) r[i] = T[i] + T[N + i] * zero;
    }
  } else if (variant == CARRY5) {
#pragma unroll
    for (int i = 0; i < N; ++i) r[i] = a[(size_t)i * E + e];
#pragma unroll 1
    for (int pass = 0; pass < 5; ++pass) fe_carry(r);
  } else {  // FOLD: a is (2N + 2, E)
#pragma unroll
    for (int i = 0; i < N; ++i) r[i] = a[(size_t)i * E + e];
#pragma unroll
    for (int k = 0; k < N + 2; ++k) {
      const int32_t t = a[(size_t)(N + k) * E + e];
#pragma unroll
      for (int i = 0; i < N; ++i) r[i] += t * c_consts[(ROW_FOLD + k) * N + i];
    }
  }
#pragma unroll
  for (int i = 0; i < N; ++i) out[(size_t)i * E + e] = r[i];
}

// ---- P3: chained Edwards padds on float32 balanced 9-bit limbs ------------

}  // namespace

namespace f32p {
constexpr int NF = 29;              // limbs
constexpr int NC = 2 * NF + 2;      // convolution columns
constexpr int ROW_TWOD = NF + 3;    // consts rows: ONE, FOLD[NF + 2], 2d
constexpr float RND = 6442450944.0f;  // 3 * 2^31: ulp 2^9 = 2^W
constexpr float ITW = 1.0f / 512.0f;
constexpr int GROUP = 4;            // threads of one padd
constexpr int PER_WARP = 8;         // padds a warp
constexpr int ROWS = 12;            // float rows of a group: P, Q, then A, B, C, D
}  // namespace f32p

namespace {

// x rounded to the nearest multiple of 2^W, by the float addition itself.
__device__ __forceinline__ float round_w(float x) {
  return (x + f32p::RND) - f32p::RND;
}

// r = a * b on balanced limbs, in registers: the convolution (FMAs in the
// order i, then j), two no-wrap carries, the fold of the NF + 2 high
// columns, three wrap carries (ONE folds the top carry back). The fold and
// ONE are p = 2^255 - 19's (tests/test_torch_probes.py pins them against
// the consts block): FOLD[k] is 192 at limb k and 2 at limb k + 1 for k <
// 28, -184 at limb k - 28 and 6 at limb k - 27 for k = 28, 29, 30; ONE is
// 192, 2 at limbs 0, 1. The 62 nonzero fold terms are summed in the dense
// fold's order of k, the 837 zero terms left out (read as constant-memory
// operands, the dense fold made the chain 3.9x slower on the card). r may
// alias a or b. Every partial sum is an integer below 2^24, so each float
// operation is exact and the limbs equal padd_f32_chain_plain's matrix
// products'.
__device__ __forceinline__ void f32_mul(float (&r)[f32p::NF], const float (&a)[f32p::NF],
                                        const float (&b)[f32p::NF]) {
  using namespace f32p;
  float T[NC];
#pragma unroll
  for (int k = 0; k < NC; ++k) T[k] = 0.0f;
#pragma unroll
  for (int i = 0; i < NF; ++i)
#pragma unroll
    for (int j = 0; j < NF; ++j) T[i + j] = fmaf(a[i], b[j], T[i + j]);
#pragma unroll
  for (int pass = 0; pass < 2; ++pass) {  // T[k] - h[k] + h[k - 1] / 2^W, the last carry dropped
    float in = 0.0f;
#pragma unroll
    for (int k = 0; k < NC; ++k) {
      const float h = round_w(T[k]);
      T[k] = (T[k] - h) + in;
      in = h * ITW;
    }
  }
#pragma unroll
  for (int i = 0; i < NF; ++i) {  // T[i] + sum over k of FOLD[k][i] T[NF + k], nonzero terms
    float s = 0.0f;
    if (i >= 1) s = fmaf(2.0f, T[NF + i - 1], s);        // k = i - 1 < 28
    if (i <= 27) s = fmaf(192.0f, T[NF + i], s);         // k = i < 28
    if (i >= 1 && i <= 3) s = fmaf(6.0f, T[NF + i + 27], s);  // k = i + 27 >= 28
    if (i <= 2) s = fmaf(-184.0f, T[NF + i + 28], s);    // k = i + 28
    r[i] = T[i] + s;
  }
#pragma unroll 1
  for (int pass = 0; pass < 3; ++pass) {  // r[i] - h[i] 2^W + h[i - 1] + ONE[i] top
    const float top = round_w(r[NF - 1]) * ITW;
    float in = 0.0f;
#pragma unroll
    for (int i = 0; i < NF; ++i) {
      const float h = round_w(r[i]) * ITW;
      const float c = i == 0 ? 192.0f * top : i == 1 ? fmaf(2.0f, top, in) : in;
      r[i] = (r[i] - h * (1 << 9)) + c;
      in = h;
    }
  }
}

// Row v of round 2's operands from the rows A, B, C, D of S: v = 0, E =
// B - A; 1, F = D - C; 2, G = D + C; 3, H = B + A.
__device__ __forceinline__ void f32_row(float (&x)[f32p::NF], const float (*S)[f32p::NF], int v) {
  const int hi = (v == 1 || v == 2) ? 3 : 1;
  const float sign = v >= 2 ? 1.0f : -1.0f;
#pragma unroll
  for (int i = 0; i < f32p::NF; ++i) x[i] = S[hi][i] + sign * S[hi - 1][i];
}

// R chained padds p <- p + q per lane, four threads a lane, eight lanes a
// one-warp block. Group grp's rows in shared memory: P (the accumulator), Q,
// and the scratch rows A, B, C, D; the block's 2d row (read once from the
// consts block). A padd is three steps through one product call site:
// step 0 (round 1), thread g's product of (Y1 - X1, Y2 - X2), (Y1 + X1,
// Y2 + X2), (T1, T2), (Z1, Z2), thread 3 then doubling its zz into D; step
// 1, thread 2's C = (T1 T2) 2d, the others idle; rows A, B, C, D stored;
// step 2 (round 2), thread g's (E, F), (G, H), (F, G), (E, H) into
// coordinate g of P: X3, Y3, Z3, T3. Three products of one thread a padd,
// against nine; one inlined product (three inlined copies ran 1.4x slower
// on the card: the loop's code outgrew the instruction cache). P and
// Q are read in step 0 only, P written in step 2, rounds closed by
// __syncwarp; groups past B pass act = false and meet every __syncwarp.
__global__ void __launch_bounds__(32)
padd_f32_coop_kernel(const float* __restrict__ consts, const float* __restrict__ p,
                     const float* __restrict__ q, float* __restrict__ out, int R, int B) {
  using namespace f32p;
  __shared__ float rows[PER_WARP][ROWS][NF];
  __shared__ float twod[NF];
  const int grp = threadIdx.x / GROUP, g = threadIdx.x % GROUP;
  const int b = blockIdx.x * PER_WARP + grp;
  const bool act = b < B;
  float (*P)[NF] = rows[grp];
  float (*Q)[NF] = rows[grp] + 4;
  float (*S)[NF] = rows[grp] + 8;
  if (threadIdx.x < NF) twod[threadIdx.x] = consts[ROW_TWOD * NF + threadIdx.x];
  if (act) {  // thread g loads coordinate g of both points
#pragma unroll 1
    for (int i = 0; i < NF; ++i) {
      P[g][i] = p[(size_t)(g * NF + i) * B + b];
      Q[g][i] = q[(size_t)(g * NF + i) * B + b];
    }
  }
  __syncwarp();
#pragma unroll 1
  for (int r = 0; r < R; ++r) {
    float x[NF], y[NF];
#pragma unroll 1
    for (int step = 0; step < 3; ++step) {
      if (act) {
        if (step == 0 && g < 2) {
          const float sign = g ? 1.0f : -1.0f;
#pragma unroll
          for (int i = 0; i < NF; ++i) {
            x[i] = P[1][i] + sign * P[0][i];
            y[i] = Q[1][i] + sign * Q[0][i];
          }
        } else if (step == 0) {
          const int c = g == 2 ? 3 : 2;
#pragma unroll
          for (int i = 0; i < NF; ++i) {
            x[i] = P[c][i];
            y[i] = Q[c][i];
          }
        } else if (step == 1) {
#pragma unroll
          for (int i = 0; i < NF; ++i) y[i] = twod[i];
        } else {
          f32_row(x, S, (0x0120 >> (4 * g)) & 15);
          f32_row(y, S, (0x3231 >> (4 * g)) & 15);
        }
        if (step != 1 || g == 2) f32_mul(x, x, y);
        if (step == 0 && g == 3) {
#pragma unroll
          for (int i = 0; i < NF; ++i) x[i] = x[i] + x[i];
        }
        if (step > 0 || g != 2) {  // row g of A, B, C, D after step 0 (C after step 1), P[g] after step 2
          float* row = step == 2 ? P[g] : S[g];
#pragma unroll
          for (int i = 0; i < NF; ++i) row[i] = x[i];
        }
      }
      if (step > 0) __syncwarp();
    }
  }
  if (act) {
#pragma unroll 1
    for (int i = 0; i < NF; ++i) out[(size_t)(g * NF + i) * B + b] = P[g][i];
  }
}

template <class Prod>
int fe_mul_launch(const int32_t* a, const int32_t* b, int32_t* out, int E, cudaStream_t st) {
  if (E < 1) return static_cast<int>(cudaErrorInvalidValue);
  fe_mul_kernel<Prod><<<(E + FE_MUL_THREADS - 1) / FE_MUL_THREADS, FE_MUL_THREADS, 0, st>>>(a, b, out, E);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// consts: (N + 4, N) int32; p, q, out: (4, N, B) int32; blocks, warps per
// block (blocks * warps * 8 >= B) and dynamic shared bytes (at least
// coop_horner_smem_bytes<EdCoop, 1>(warps)). Returns the CUDA error of the
// launch (0 on success).
extern "C" int padd_chain_ed25519_launch(const int32_t* consts, const int32_t* p, const int32_t* q,
                                         int32_t* out, int R, int B, int blocks, int warps, int smem,
                                         void* stream) {
  return coop_chain_launch<Ed25519, EdCoop>(consts, p, q, out, R, B, blocks, warps, smem, stream);
}

// consts: the curve's consts block, unread (the field's constants are in
// the code); a, b, out: (N, E) int32, E >= 1. Each returns the CUDA error
// of the launch (0 on success).
extern "C" int fe_mul_ed25519_launch(const int32_t*, const int32_t* a, const int32_t* b, int32_t* out,
                                     int E, void* stream) {
  return fe_mul_launch<EdProduct>(a, b, out, E, static_cast<cudaStream_t>(stream));
}

extern "C" int fe_mul_bn254_g1_launch(const int32_t*, const int32_t* a, const int32_t* b, int32_t* out,
                                      int E, void* stream) {
  return fe_mul_launch<BnProduct>(a, b, out, E, static_cast<cudaStream_t>(stream));
}

// The BN254 Fq product on the consts block in __constant__, for
// chip_smoke.py's ablation: consts is bn254_g1's consts block, copied
// before the launch; the rest as fe_mul_bn254_g1_launch.
extern "C" int fe_mul_bn254_g1_c_consts_launch(const int32_t* consts, const int32_t* a, const int32_t* b,
                                               int32_t* out, int E, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err = fold_load_consts(consts, Bn254G1::NCONST, st);
  if (err != cudaSuccess) return static_cast<int>(err);
  return fe_mul_launch<ConstProduct>(a, b, out, E, st);
}

// consts: (4, 22) int32 (p, R mod p, ninv, 2d * R mod p: the kernel reads
// 2d; p, R mod p and ninv are 2^255 - 19's, in the code); p, q, out:
// (4, 22, E) int32 Montgomery limbs, p's and q's in int16; threads (lanes)
// a block, a multiple of 32 up to 256. Returns the CUDA error of the
// launch.
extern "C" int mont_padd_launch(const int32_t* consts, const int32_t* p, const int32_t* q,
                                int32_t* out, int E, int threads, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (E < 1 || threads < 32 || threads > mp::MAX_THREADS || threads % 32)
    return static_cast<int>(cudaErrorInvalidValue);
  const int smem = (int)sizeof(uint32_t) * mp::W * (1 + mp::ROWS * threads);
  cudaError_t err = cudaFuncSetAttribute(mont_padd_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  mont_padd_kernel<<<(E + threads - 1) / threads, threads, smem, st>>>(consts, p, q, out, E);
  return static_cast<int>(cudaGetLastError());
}

namespace {

int fold_ablate_launch(int variant, const int32_t* consts, const int32_t* a, const int32_t* b,
                       int32_t* out, int E, int zero, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err = fold_load_consts(consts, Ed25519::NCONST, st);
  if (err != cudaSuccess) return static_cast<int>(err);
  fold_ablate_kernel<<<(E + MUL_THREADS - 1) / MUL_THREADS, MUL_THREADS, 0, st>>>(
      variant, a, b, out, E, zero);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// consts: the ed25519 consts block (ONE and FOLD are read); a: (N, E) int32,
// or (2N + 2, E) for fold; b: (N, E) int32 or null; out: (N, E) int32;
// zero: 0 (the script's `* 0` on the high columns). Each returns the CUDA
// error of the launch (0 on success).
#define FOLD_ABLATE_ENTRY(name, v)                                                           \
  extern "C" int fold_ablate_##name##_launch(const int32_t* consts, const int32_t* a,        \
                                             const int32_t* b, int32_t* out, int E, int zero, \
                                             void* stream) {                                  \
    return fold_ablate_launch(v, consts, a, b, out, E, zero, stream);                          \
  }
FOLD_ABLATE_ENTRY(conv, CONV)
FOLD_ABLATE_ENTRY(conv8, CONV8)
FOLD_ABLATE_ENTRY(carry5, CARRY5)
FOLD_ABLATE_ENTRY(fold, FOLD)
FOLD_ABLATE_ENTRY(mac, MAC)
#undef FOLD_ABLATE_ENTRY

// consts: (NF + 4, NF) float32 (ONE, FOLD[NF + 2], 2d: the kernel reads 2d;
// its ONE and FOLD are p = 2^255 - 19's, in the code); p, q, out:
// (4, NF, B) float32 balanced limbs. Returns the CUDA error of the launch.
extern "C" int padd_f32_chain_launch(const float* consts, const float* p, const float* q,
                                     float* out, int R, int B, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int blocks = (B + f32p::PER_WARP - 1) / f32p::PER_WARP;
  padd_f32_coop_kernel<<<blocks, 32, 0, st>>>(consts, p, q, out, R, B);
  return static_cast<int>(cudaGetLastError());
}
