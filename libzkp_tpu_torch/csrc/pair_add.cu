// K3 pair_add: elementwise complete point addition, out = p + q per lane,
// for ed25519, BN254 G1 and BN254 G2.
//
// Replaces the JAX package's Pallas kernel libzkp_tpu/ops/curve_jax.py
// _pair_add_call, the step of the multiples-table build (_table_build_jit):
// 255 chained launches give each basis point its 256 multiples.
//
// Bound: integer multiply-adds per lane, against 3 * COORDS * N * 4 bytes
// moved: an Edwards padd is 9 field products, a G1 padd (RCB) 12 products
// and 2 small multiplies, a G2 padd 42 products (14 Fq2 products of 3), each
// product N^2 + (N + 2) * N = 576 + 624 = 1200 multiply-adds.
//
// Design: one thread per lane, coalesced over the lane axis. The formula is
// the plain version's, step for step, so the limbs are identical to it.
// A G2 point is 6 * 24 int32, so G2 lanes spill to local memory. Fusing the
// 255-step chain into one launch is left for later work.

#include "fold_curves.cuh"

namespace {

constexpr int THREADS = 128;

template <class Cv>
__global__ void __launch_bounds__(THREADS)
pair_add_kernel(const int32_t* __restrict__ p, const int32_t* __restrict__ q,
                int32_t* __restrict__ out, int K) {
  const int b = blockIdx.x * THREADS + threadIdx.x;
  if (b >= K) return;
  int32_t a[Cv::COORDS][fold::N];
  int32_t c[Cv::COORDS][fold::N];
  pt_load_lanes<Cv>(a, p, b, K);
  pt_load_lanes<Cv>(c, q, b, K);
  Cv::padd(a, a, c);
  pt_store_lanes<Cv>(out, a, b, K);
}

template <class Cv>
int launch(const int32_t* consts, const int32_t* p, const int32_t* q, int32_t* out, int K,
           void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err = fold_load_consts(consts, Cv::NCONST, st);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int blocks = (K + THREADS - 1) / THREADS;
  pair_add_kernel<Cv><<<blocks, THREADS, 0, st>>>(p, q, out, K);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// consts: the curve's (NCONST, N) int32 block; p, q, out: (COORDS, N, K)
// int32. Each returns the CUDA error of the launch (0 on success).
extern "C" int pair_add_ed25519_launch(const int32_t* consts, const int32_t* p, const int32_t* q,
                                       int32_t* out, int K, void* stream) {
  return launch<Ed25519>(consts, p, q, out, K, stream);
}

extern "C" int pair_add_bn254_g1_launch(const int32_t* consts, const int32_t* p, const int32_t* q,
                                        int32_t* out, int K, void* stream) {
  return launch<Bn254G1>(consts, p, q, out, K, stream);
}

extern "C" int pair_add_bn254_g2_launch(const int32_t* consts, const int32_t* p, const int32_t* q,
                                        int32_t* out, int K, void* stream) {
  return launch<Bn254G2>(consts, p, q, out, K, stream);
}
