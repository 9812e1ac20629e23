// K3 pair_add: elementwise complete Edwards addition, out = p + q per lane.
//
// Replaces the JAX package's Pallas kernel libzkp_tpu/ops/curve_jax.py
// _pair_add_call, the step of the multiples-table build (_table_build_jit):
// 255 chained launches give each basis point its 256 multiples.
//
// Bound: integer multiply-adds, 9 field products of 1200 multiply-adds per
// lane, against 768 bytes read and 384 written per lane.
//
// Design: one thread per lane, coalesced over the lane axis. The formula is
// the plain version's, step for step, so the limbs are identical to it.
// Fusing the 255-step chain into one launch is left for later work.

#include "fe25519_fold.cuh"

namespace {

constexpr int THREADS = 128;

__global__ void __launch_bounds__(THREADS)
pair_add_kernel(const int32_t* __restrict__ p, const int32_t* __restrict__ q,
                int32_t* __restrict__ out, int K) {
  using namespace fold;
  const int b = blockIdx.x * THREADS + threadIdx.x;
  if (b >= K) return;
  int32_t a[COORDS][N];
  int32_t c[COORDS][N];
  pt_load_lanes(a, p, b, K);
  pt_load_lanes(c, q, b, K);
  ed_padd(a, a, c);
  pt_store_lanes(out, a, b, K);
}

}  // namespace

// consts: (N + 4, N) int32; p, q, out: (COORDS, N, K) int32. Returns the
// CUDA error of the launch (0 on success).
extern "C" int pair_add_launch(const int32_t* consts, const int32_t* p, const int32_t* q,
                               int32_t* out, int K, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err = fold_load_consts(consts, st);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int blocks = (K + THREADS - 1) / THREADS;
  pair_add_kernel<<<blocks, THREADS, 0, st>>>(p, q, out, K);
  return static_cast<int>(cudaGetLastError());
}
