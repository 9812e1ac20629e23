// K2 horner: one Horner step of the windowed MSM, acc <- 2^8 * acc + wsum
// (ed25519, BN254 G1, BN254 G2).
//
// Replaces the JAX package's Pallas kernel libzkp_tpu/ops/curve_jax.py
// _horner_call: 8 pdoubles and 1 padd per lane over (COORDS, N, B). The
// ed25519 instance runs in the range prover's window walk; the BN254
// instances in the v1 window walk of the mesh-sharded MSM.
//
// Bound: integer multiply-adds. Per lane, ed25519: 8 pdoubles of 8 field
// products and one padd of 9; BN254: 9 padds (a Weierstrass pdouble is
// padd(p, p)) of 12 products and 2 small multiplies (G1) or 42 products
// (G2). Each product is N^2 + (N + 2) * N = 1200 multiply-adds, against
// 3 * COORDS * N * 4 bytes moved per lane.
//
// ed25519: one thread per lane, the lanes of a warp on neighbouring words of
// each (COORDS, N, B) row, so loads and stores coalesce, in blocks of 128.
//
// BN254 G1 and G2: one group of threads per lane runs the 9 padds on the
// curve's cooperative padd (coop_horner_kernel<Cp, 1, 8>, coop_horner.cuh): G1
// six threads a lane (G1Coop), five lanes a warp, a padd's latency 2
// products of one thread where one thread per lane ran all 12; G2 18 threads
// a lane (G2Coop18), one lane a warp, a padd's latency 3 products where one
// thread ran 42 (7 on G2Coop's six threads). At the mesh block's 128 lanes
// that is 26 (G1) or 128 (G2) one-warp blocks, each alone on its SM. The
// accumulator and the window sum are narrowed once to int16 in shared
// memory; this is exact on the mesh path, where the accumulator is the
// identity or an earlier horner output and the window sum a tree_sum output,
// and every padd output limb lies in [-7643, 11737] (fold_curves.cuh).
//
// Every formula is the plain version's, step for step, so the limbs are
// identical to it.

#include "coop_horner.cuh"

namespace {

template <class Cv, int THREADS>
__global__ void __launch_bounds__(THREADS)
horner_kernel(const int32_t* __restrict__ acc_in, const int32_t* __restrict__ wsum,
              int32_t* __restrict__ out, int B) {
  const int b = blockIdx.x * THREADS + threadIdx.x;
  if (b >= B) return;
  int32_t acc[Cv::COORDS][fold::N];
  int32_t w[Cv::COORDS][fold::N];
  pt_load_lanes<Cv>(acc, acc_in, b, B);
  pt_load_lanes<Cv>(w, wsum, b, B);
#pragma unroll 1
  for (int r = 0; r < 8; ++r) Cv::pdouble(acc, acc);
  Cv::padd(acc, acc, w);
  pt_store_lanes<Cv>(out, acc, b, B);
}

template <class Cv, int THREADS>
int launch(const int32_t* consts, const int32_t* acc, const int32_t* wsum, int32_t* out, int B,
           void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err = fold_load_consts(consts, Cv::NCONST, st);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int blocks = (B + THREADS - 1) / THREADS;
  horner_kernel<Cv, THREADS><<<blocks, THREADS, 0, st>>>(acc, wsum, out, B);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// consts: the curve's (NCONST, N) int32 block; acc, wsum, out: (COORDS, N, B)
// int32; BN254 only: blocks, warps per block (blocks * warps * 5 >= B) and
// dynamic shared bytes (at least coop_horner_smem_bytes<Cp, 1>(warps)). Each
// returns the CUDA error of the launch (0 on success).
extern "C" int horner_ed25519_launch(const int32_t* consts, const int32_t* acc,
                                     const int32_t* wsum, int32_t* out, int B, void* stream) {
  return launch<Ed25519, 128>(consts, acc, wsum, out, B, stream);
}

extern "C" int horner_bn254_g1_launch(const int32_t* consts, const int32_t* acc,
                                      const int32_t* wsum, int32_t* out, int B, int blocks,
                                      int warps, int smem, void* stream) {
  return coop_horner_launch<Bn254G1, G1Coop, 1>(consts, acc, wsum, out, B, blocks, warps, smem, stream);
}

extern "C" int horner_bn254_g2_launch(const int32_t* consts, const int32_t* acc,
                                      const int32_t* wsum, int32_t* out, int B, int blocks,
                                      int warps, int smem, void* stream) {
  return coop_horner_launch<Bn254G2, G2Coop18, 1>(consts, acc, wsum, out, B, blocks, warps, smem, stream);
}
