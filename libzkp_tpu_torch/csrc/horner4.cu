// A5 horner4: four Horner steps of the windowed MSM (BN254 G1, G2):
// for w = 0..3, acc <- 2^8 * acc + wsums[..., w * B + b].
//
// Replaces the JAX package's Pallas kernel libzkp_tpu/ops/curve_jax.py
// _horner4_call: per lane, 4 x (8 pdoubles + 1 padd) over (COORDS, N, B),
// taking window w of the group from lanes w * B .. (w + 1) * B of the
// (COORDS, N, 4B) window sums that A4 (window_sum4.cu) writes.
//
// Bound: integer multiply-adds, 36 padds per lane (a Weierstrass pdouble is
// padd(p, p)): 36 * 12 field products (and 2 small multiplies) per G1 lane,
// 36 * 42 per G2 lane, each 1200 multiply-adds, against 6 * COORDS * N * 4
// bytes moved per lane. In practice a latency chain: the 36 padds of a lane
// depend on each other, and the Groth16 batch has 256 lanes, too few to fill
// the card with independent work.
//
// G1: one thread per lane, the lanes of a warp on neighbouring words of each
// (COORDS, N, B) row, so loads and stores coalesce; blocks of one warp
// spread the 256 lanes of a batch over 8 SMs. A lane's 36 padds of 12
// products each are its latency.
//
// G2: one group of six threads per lane runs the chain on the cooperative
// G2 padd (coop_horner_kernel<G2Coop, 4>, coop_horner.cuh, shared with horner
// G1 and G2): a padd's latency is the 7 products of one thread (3 in round 1,
// 1 in round 2, 3 in round 3) where one thread per lane ran all 42. Five
// groups share a warp; blocks of one warp spread the 52 warps of 256 lanes
// over 52 SMs, each warp alone on its SM. The accumulator and the lane's four
// window sums are narrowed once into shared memory as int16 points: each is
// a padd output (window_sum4, an earlier horner4) or the identity, and every
// padd output limb lies in [-7643, 11737] (fold_curves.cuh), so the
// narrowing is exact.
//
// Both formulas are the plain version's, step for step, so the limbs are
// identical to it.

#include "coop_horner.cuh"

namespace {

constexpr int WG = 4;        // windows per group
constexpr int THREADS = 32;  // lanes per block (G1)

template <class Cv>
__global__ void __launch_bounds__(THREADS)
horner4_kernel(const int32_t* __restrict__ acc_in, const int32_t* __restrict__ wsums,
               int32_t* __restrict__ out, int B) {
  const int b = blockIdx.x * THREADS + threadIdx.x;
  if (b >= B) return;
  int32_t acc[Cv::COORDS][fold::N];
  int32_t w[Cv::COORDS][fold::N];
  pt_load_lanes<Cv>(acc, acc_in, b, B);
#pragma unroll 1
  for (int g = 0; g < WG; ++g) {
#pragma unroll 1
    for (int r = 0; r < 8; ++r) Cv::pdouble(acc, acc);
    pt_load_lanes<Cv>(w, wsums, g * B + b, WG * B);
    Cv::padd(acc, acc, w);
  }
  pt_store_lanes<Cv>(out, acc, b, B);
}

template <class Cv>
int launch(const int32_t* consts, const int32_t* acc, const int32_t* wsums, int32_t* out, int B,
           void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err = fold_load_consts(consts, Cv::NCONST, st);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int blocks = (B + THREADS - 1) / THREADS;
  horner4_kernel<Cv><<<blocks, THREADS, 0, st>>>(acc, wsums, out, B);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// consts: the curve's (NCONST, N) int32 block; acc, out: (COORDS, N, B)
// int32; wsums: (COORDS, N, 4B) int32; G2 only: blocks, warps per block
// (blocks * warps * 5 >= B) and dynamic shared bytes (at least
// g2_smem_bytes(warps)). Each returns the CUDA error of the launch (0 on
// success).
extern "C" int horner4_bn254_g1_launch(const int32_t* consts, const int32_t* acc,
                                       const int32_t* wsums, int32_t* out, int B, void* stream) {
  return launch<Bn254G1>(consts, acc, wsums, out, B, stream);
}

extern "C" int horner4_bn254_g2_launch(const int32_t* consts, const int32_t* acc,
                                       const int32_t* wsums, int32_t* out, int B, int blocks,
                                       int warps, int smem, void* stream) {
  return coop_horner_launch<Bn254G2, G2Coop, WG>(consts, acc, wsums, out, B, blocks, warps, smem, stream);
}
