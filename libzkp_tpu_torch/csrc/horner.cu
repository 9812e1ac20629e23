// K2 horner: one Horner step of the windowed MSM, acc <- 2^8 * acc + wsum
// (ed25519).
//
// Replaces the JAX package's Pallas kernel libzkp_tpu/ops/curve_jax.py
// _horner_call: 8 pdoubles and 1 padd per lane over (COORDS, N, B).
//
// Bound: integer multiply-adds. 8 pdoubles of 8 field products and one padd
// of 9, each product N^2 + (N + 2) * N = 1200 multiply-adds, against 768
// bytes read and 384 written per lane.
//
// Design: one thread per lane, the lanes of a warp on neighbouring words of
// each (COORDS, N, B) row, so loads and stores coalesce. The formula is the
// plain version's, step for step, so the limbs are identical to it.

#include "fold_curves.cuh"

namespace {

constexpr int THREADS = 128;

__global__ void __launch_bounds__(THREADS)
horner_kernel(const int32_t* __restrict__ acc_in, const int32_t* __restrict__ wsum,
              int32_t* __restrict__ out, int B) {
  using namespace fold;
  const int b = blockIdx.x * THREADS + threadIdx.x;
  if (b >= B) return;
  int32_t acc[Ed25519::COORDS][N];
  int32_t w[Ed25519::COORDS][N];
  pt_load_lanes<Ed25519>(acc, acc_in, b, B);
  pt_load_lanes<Ed25519>(w, wsum, b, B);
#pragma unroll 1
  for (int r = 0; r < 8; ++r) Ed25519::pdouble(acc, acc);
  Ed25519::padd(acc, acc, w);
  pt_store_lanes<Ed25519>(out, acc, b, B);
}

}  // namespace

// consts: (N + 4, N) int32; acc, wsum, out: (4, N, B) int32. Returns the
// CUDA error of the launch (0 on success).
extern "C" int horner_ed25519_launch(const int32_t* consts, const int32_t* acc,
                                     const int32_t* wsum, int32_t* out, int B, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err = fold_load_consts(consts, Ed25519::NCONST, st);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int blocks = (B + THREADS - 1) / THREADS;
  horner_kernel<<<blocks, THREADS, 0, st>>>(acc, wsum, out, B);
  return static_cast<int>(cudaGetLastError());
}
