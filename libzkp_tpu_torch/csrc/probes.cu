// Probes of the field product and point addition every kernel inlines,
// run on the production device functions of fold_curves.cuh, so each
// measures what the kernels run.
//
// * padd_chain (P2) replaces scripts/bench_pallas_padd.py bench_current's
//   Pallas kernel: R chained Edwards padds per lane, p <- p + q, over
//   (4, N, B) int32. One warp per block, one lane per thread: at B = 512 the
//   chains of 16 warps run on 16 SMs, one warp each, so the time is the
//   latency of a chain of dependent padds, not the card's throughput.
//   Bound: R * 9 field products of 1200 multiply-adds per lane.
// * fe_mul (P4) replaces scripts/bench_fold.py bench_field's Pallas kernel:
//   one fold product per lane, out = a * b over (N, E) int32, for the field
//   of the consts block it is given (p = 2^255 - 19 or BN254 Fq). One lane
//   per thread, lanes of a warp on neighbouring words of each limb row, so
//   loads and stores coalesce; E / 256 blocks fill the card. Bound: bytes at
//   E = 2^20 (3 * N * 4 bytes per lane against 1200 multiply-adds).
//
// * mont_padd (P7) replaces scripts/bench_pallas_mul.py main.pallas_add: one
//   Edwards addition per lane in the Montgomery domain (point_add_val, 9
//   products of mont.cuh's mont_mul, the h pipeline's product) over
//   (4, 22, E) int32 limbs-major, p = 2^255 - 19, one lane per thread.
//   Bound: bytes at E = 2^18 against 9 * ~1000 multiply-adds per lane.
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
//   loops in the thread, as K1 replaced A1's one-hot matmul with a gather.
//   Exact because every partial sum is an integer below 2^24 (checked by
//   tests/test_torch_probes.py); the rounding carry (x + RND) - RND needs
//   IEEE float addition, so this source is built without --use_fast_math.
//   Bound: R * 9 products of 841 + 899 FMAs per lane at the FP32 rate.
//
// P5 (scripts/bench_fold.py main.pl_add, one padd per lane) is exactly K3
// pair_add (pair_add.cu) at its shape, so it has no kernel here.

#include "fold_curves.cuh"
#include "mont.cuh"

namespace {

constexpr int CHAIN_THREADS = 32;
constexpr int MUL_THREADS = 256;

__global__ void __launch_bounds__(CHAIN_THREADS)
padd_chain_kernel(const int32_t* __restrict__ p, const int32_t* __restrict__ q,
                  int32_t* __restrict__ out, int R, int B) {
  const int b = blockIdx.x * CHAIN_THREADS + threadIdx.x;
  if (b >= B) return;
  int32_t acc[Ed25519::COORDS][fold::N];
  int32_t add[Ed25519::COORDS][fold::N];
  pt_load_lanes<Ed25519>(acc, p, b, B);
  pt_load_lanes<Ed25519>(add, q, b, B);
#pragma unroll 1
  for (int r = 0; r < R; ++r) Ed25519::padd(acc, acc, add);
  pt_store_lanes<Ed25519>(out, acc, b, B);
}

__global__ void __launch_bounds__(MUL_THREADS)
fe_mul_kernel(const int32_t* __restrict__ a, const int32_t* __restrict__ b,
              int32_t* __restrict__ out, int E) {
  using namespace fold;
  const int e = blockIdx.x * MUL_THREADS + threadIdx.x;
  if (e >= E) return;
  int32_t x[N], y[N];
#pragma unroll
  for (int i = 0; i < N; ++i) {
    x[i] = a[(size_t)i * E + e];
    y[i] = b[(size_t)i * E + e];
  }
  fe_mul(x, x, y);
#pragma unroll
  for (int i = 0; i < N; ++i) out[(size_t)i * E + e] = x[i];
}

// ---- P7: Edwards addition in the Montgomery domain -----------------------

constexpr int MN = 22;  // Montgomery limbs of 2^255 - 19

// Out of line, so the nine products are nine calls on local arrays.
__device__ __noinline__ void mont_mul22(int32_t* r, const int32_t* a, const int32_t* b) {
  mont_mul<MN>(r, a, b);
}

__global__ void __launch_bounds__(MUL_THREADS)
mont_padd_kernel(const int32_t* __restrict__ p, const int32_t* __restrict__ q,
                 int32_t* __restrict__ out, int E) {
  using namespace mont;
  const int e = blockIdx.x * MUL_THREADS + threadIdx.x;
  if (e >= E) return;
  int32_t P[4][MN], Q[4][MN], two_d[MN];
#pragma unroll
  for (int c = 0; c < 4; ++c)
#pragma unroll
    for (int i = 0; i < MN; ++i) {
      P[c][i] = p[(size_t)(c * MN + i) * E + e];
      Q[c][i] = q[(size_t)(c * MN + i) * E + e];
    }
#pragma unroll
  for (int i = 0; i < MN; ++i) two_d[i] = c_mont[ROW_CURVE * MN + i];
  int32_t u[MN], v[MN], A[MN], B[MN], C[MN], D[MN];
  mont_sub<MN>(u, P[1], P[0]);
  mont_sub<MN>(v, Q[1], Q[0]);
  mont_mul22(A, u, v);
  mont_add<MN>(u, P[1], P[0]);
  mont_add<MN>(v, Q[1], Q[0]);
  mont_mul22(B, u, v);
  mont_mul22(u, P[3], Q[3]);
  mont_mul22(C, u, two_d);
  mont_mul22(u, P[2], Q[2]);
  mont_add<MN>(D, u, u);
  int32_t Ev[MN], F[MN], G[MN], H[MN];
  mont_sub<MN>(Ev, B, A);
  mont_sub<MN>(F, D, C);
  mont_add<MN>(G, D, C);
  mont_add<MN>(H, B, A);
  mont_mul22(P[0], Ev, F);
  mont_mul22(P[1], G, H);
  mont_mul22(P[2], F, G);
  mont_mul22(P[3], Ev, H);
#pragma unroll
  for (int c = 0; c < 4; ++c)
#pragma unroll
    for (int i = 0; i < MN; ++i) out[(size_t)(c * MN + i) * E + e] = P[c][i];
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
constexpr int ROW_ONE = 0;          // consts rows: ONE, FOLD[NF + 2], 2d
constexpr int ROW_FOLD = 1;
constexpr int ROW_TWOD = NF + 3;
constexpr int NCONST = NF + 4;
constexpr float RND = 6442450944.0f;  // 3 * 2^31: ulp 2^9 = 2^W
constexpr float ITW = 1.0f / 512.0f;
}  // namespace f32p

__constant__ float c_f32[f32p::NCONST * f32p::NF];

namespace {

// x rounded to the nearest multiple of 2^W, by the float addition itself.
__device__ __forceinline__ float round_w(float x) {
  return (x + f32p::RND) - f32p::RND;
}

// r = a * b on balanced limbs: convolution, two no-wrap carries, the fold of
// the NF + 2 high columns, three wrap carries (ONE folds the top carry back).
// r may alias a or b. Out of line, so a padd is nine calls.
__device__ __noinline__ void f32_mul(float* r, const float* a, const float* b) {
  using namespace f32p;
  float T[NC];
#pragma unroll
  for (int k = 0; k < NC; ++k) T[k] = 0.0f;
#pragma unroll
  for (int i = 0; i < NF; ++i)
#pragma unroll
    for (int j = 0; j < NF; ++j) T[i + j] = fmaf(a[i], b[j], T[i + j]);
#pragma unroll
  for (int pass = 0; pass < 2; ++pass) {
    float h[NC];
#pragma unroll
    for (int k = 0; k < NC; ++k) {
      h[k] = round_w(T[k]);
      T[k] -= h[k];
    }
#pragma unroll
    for (int k = 1; k < NC; ++k) T[k] += h[k - 1] * ITW;
  }
  float acc[NF];
#pragma unroll
  for (int i = 0; i < NF; ++i) {
    float s = 0.0f;
#pragma unroll
    for (int k = 0; k < NF + 2; ++k) s = fmaf(c_f32[(ROW_FOLD + k) * NF + i], T[NF + k], s);
    acc[i] = T[i] + s;
  }
#pragma unroll 1
  for (int pass = 0; pass < 3; ++pass) {
    float h[NF];
#pragma unroll
    for (int i = 0; i < NF; ++i) {
      h[i] = round_w(acc[i]) * ITW;
      acc[i] -= h[i] * (1 << 9);
    }
    const float top = h[NF - 1];
#pragma unroll
    for (int i = 0; i < NF; ++i)
      acc[i] += (i > 0 ? h[i - 1] : 0.0f) + c_f32[ROW_ONE * NF + i] * top;
  }
#pragma unroll
  for (int i = 0; i < NF; ++i) r[i] = acc[i];
}

__global__ void __launch_bounds__(CHAIN_THREADS)
padd_f32_chain_kernel(const float* __restrict__ p, const float* __restrict__ q,
                      float* __restrict__ out, int R, int B) {
  using namespace f32p;
  const int b = blockIdx.x * CHAIN_THREADS + threadIdx.x;
  if (b >= B) return;
  float P[4][NF], Q[4][NF], twod[NF];
#pragma unroll
  for (int c = 0; c < 4; ++c)
#pragma unroll
    for (int i = 0; i < NF; ++i) {
      P[c][i] = p[(size_t)(c * NF + i) * B + b];
      Q[c][i] = q[(size_t)(c * NF + i) * B + b];
    }
#pragma unroll
  for (int i = 0; i < NF; ++i) twod[i] = c_f32[ROW_TWOD * NF + i];
#pragma unroll 1
  for (int r = 0; r < R; ++r) {
    float u[NF], v[NF], A[NF], Bv[NF], C[NF], D[NF];
#pragma unroll
    for (int i = 0; i < NF; ++i) {
      u[i] = P[1][i] - P[0][i];
      v[i] = Q[1][i] - Q[0][i];
    }
    f32_mul(A, u, v);
#pragma unroll
    for (int i = 0; i < NF; ++i) {
      u[i] = P[1][i] + P[0][i];
      v[i] = Q[1][i] + Q[0][i];
    }
    f32_mul(Bv, u, v);
    f32_mul(u, P[3], Q[3]);
    f32_mul(C, u, twod);
    f32_mul(u, P[2], Q[2]);
    float Ev[NF], F[NF], G[NF], H[NF];
#pragma unroll
    for (int i = 0; i < NF; ++i) {
      D[i] = u[i] + u[i];
      Ev[i] = Bv[i] - A[i];
      F[i] = D[i] - C[i];
      G[i] = D[i] + C[i];
      H[i] = Bv[i] + A[i];
    }
    f32_mul(P[0], Ev, F);
    f32_mul(P[1], G, H);
    f32_mul(P[2], F, G);
    f32_mul(P[3], Ev, H);
  }
#pragma unroll
  for (int c = 0; c < 4; ++c)
#pragma unroll
    for (int i = 0; i < NF; ++i) out[(size_t)(c * NF + i) * B + b] = P[c][i];
}

template <class Cv>
int fe_mul_launch(const int32_t* consts, const int32_t* a, const int32_t* b, int32_t* out, int E,
                  void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err = fold_load_consts(consts, Cv::NCONST, st);
  if (err != cudaSuccess) return static_cast<int>(err);
  fe_mul_kernel<<<(E + MUL_THREADS - 1) / MUL_THREADS, MUL_THREADS, 0, st>>>(a, b, out, E);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// consts: (N + 4, N) int32; p, q, out: (4, N, B) int32. Returns the CUDA
// error of the launch (0 on success).
extern "C" int padd_chain_ed25519_launch(const int32_t* consts, const int32_t* p, const int32_t* q,
                                         int32_t* out, int R, int B, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err = fold_load_consts(consts, Ed25519::NCONST, st);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int blocks = (B + CHAIN_THREADS - 1) / CHAIN_THREADS;
  padd_chain_kernel<<<blocks, CHAIN_THREADS, 0, st>>>(p, q, out, R, B);
  return static_cast<int>(cudaGetLastError());
}

// consts: the curve's consts block (its first N + 3 rows, ONE and FOLD, are
// the field's); a, b, out: (N, E) int32. Each returns the CUDA error of the
// launch (0 on success).
extern "C" int fe_mul_ed25519_launch(const int32_t* consts, const int32_t* a, const int32_t* b,
                                     int32_t* out, int E, void* stream) {
  return fe_mul_launch<Ed25519>(consts, a, b, out, E, stream);
}

extern "C" int fe_mul_bn254_g1_launch(const int32_t* consts, const int32_t* a, const int32_t* b,
                                      int32_t* out, int E, void* stream) {
  return fe_mul_launch<Bn254G1>(consts, a, b, out, E, stream);
}

// consts: (4, 22) int32 (p, R mod p, ninv, 2d * R mod p); p, q, out:
// (4, 22, E) int32 Montgomery limbs. Returns the CUDA error of the launch.
extern "C" int mont_padd_launch(const int32_t* consts, const int32_t* p, const int32_t* q,
                                int32_t* out, int E, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err = mont_load_consts(consts, 4, MN, st);
  if (err != cudaSuccess) return static_cast<int>(err);
  mont_padd_kernel<<<(E + MUL_THREADS - 1) / MUL_THREADS, MUL_THREADS, 0, st>>>(p, q, out, E);
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

// consts: (NF + 4, NF) float32 (ONE, FOLD[NF + 2], 2d); p, q, out:
// (4, NF, B) float32 balanced limbs. Returns the CUDA error of the launch.
extern "C" int padd_f32_chain_launch(const float* consts, const float* p, const float* q,
                                     float* out, int R, int B, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err = cudaMemcpyToSymbolAsync(c_f32, consts, sizeof(float) * f32p::NCONST * f32p::NF,
                                            0, cudaMemcpyDeviceToDevice, st);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int blocks = (B + CHAIN_THREADS - 1) / CHAIN_THREADS;
  padd_f32_chain_kernel<<<blocks, CHAIN_THREADS, 0, st>>>(p, q, out, R, B);
  return static_cast<int>(cudaGetLastError());
}
