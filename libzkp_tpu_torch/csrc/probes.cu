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
// P5 (scripts/bench_fold.py main.pl_add, one padd per lane) is exactly K3
// pair_add (pair_add.cu) at its shape, so it has no kernel here.

#include "fold_curves.cuh"

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
