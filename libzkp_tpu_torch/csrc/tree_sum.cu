// A6 tree_sum: the window sum of the mesh-sharded MSM over points gathered
// before the launch (ed25519, BN254 G1, BN254 G2).
//
// Replaces the JAX package's Pallas kernel libzkp_tpu/ops/curve_jax.py
// _window_sum_call, the window sum of the v1 window walk that each block of
// the (dp, shard) mesh runs on its slice of the basis (_msm_many_sharded_impl):
// for every lane b it sums the Kp points pts[b, k], k = 0..Kp-1, int16 table
// rows already gathered by the lane's digits.
//
// Layout: pts is (B, Kp, COORDS, N) int16, lane-major. The gather that fills
// it is torch indexing outside the kernel (jnp.take in JAX), so the port
// chooses the layout: JAX's lanes-last (Kp, COORDS, N, B) would have each
// thread of a warp read 2-byte limbs strided by B, while lane-major keeps each
// point's COORDS * N * 2 bytes (192, 144 or 288) contiguous, as a row of the
// multiples table is, and is what indexing the table with (B, Kp) digits
// gives without a transpose.
//
// The TPU kernel carried each lane's sum over sequential grid steps of K
// chunks, revisiting one output block. Hopper has no grid axis that carries a
// sum, so the sum over all of Kp stays inside one block.
//
// Bound: integer multiply-adds, not bytes. A lane needs Kp - 1 padds: an
// Edwards padd is 9 field products (ed_mul: 576 convolution and 52 fold
// multiply-adds), a G1 padd (RCB) 12 products and 2 small multiplies, a G2
// padd 42 products, each N^2 + (N + 2) * N = 1200 multiply-adds ((Kp - 1) *
// 42 * 1200 per G2 lane), against COORDS * N * 2 bytes read per point.
//
// Design, every curve: one block per lane runs coop_tree_sum (coop_sum.cuh),
// the plain version's halving tree (ops/edwards.py _tree_reduce), so the limbs
// equal the plain version's and JAX's. A group of threads shares a padd in
// shared memory, each product on register arrays: six threads a BN254 padd,
// five groups a warp (G1Coop, G2Coop); four an Edwards padd, eight groups a
// warp (EdCoop, K1's padd on ed_mul). The level store (ceil(Kp/2) int16
// points: 9.2 KB for ed25519 at the range basis's Kp = 96, 18.4 KB for G1 at
// Kp = 256, 27.6 KB for G2 at Kp = 192) and the padd scratch (384 bytes an
// Edwards padd, 1440 a G1 padd, 3072 a G2 padd) are dynamic shared memory,
// the geometry the wrapper's (ops/kernels.py coop_sum_geometry; ed25519 at
// Kp = 96 and 128 lanes: 6 warps a block, level 1's 48 padds in one pass,
// then 6 levels). The first version gave a lane one warp: thread s added the
// points k = s, s + 32, ..., each in one thread, then a 5-level shuffle tree
// (ed25519 at Kp = 96: 3 chained one-thread padds, then 5 levels, each run by
// all 32 threads), and for ed25519 it summed in another order than the plain
// tree, so only the points agreed. Now an Edwards padd's latency is three
// products of one thread, a G1 padd's two and a G2 padd's seven, and a
// level's padds run side by side.

#include "coop_sum.cuh"

namespace {

// block b sums lane b; dynamic shared memory coop_smem_bytes<Cp>(Kp,
// blockDim.x / 32)
template <class Cp>
__global__ void __launch_bounds__(coop::MAX_WARPS * 32)
tree_sum_coop_kernel(const int16_t* __restrict__ pts, int32_t* __restrict__ out, int Kp, int B) {
  const int16_t* lane = pts + (size_t)blockIdx.x * Kp * Cp::POINT;
  coop_tree_sum<Cp>([=](int k) { return lane + (size_t)k * Cp::POINT; }, Kp, out, blockIdx.x, B);
}

template <class Cv, class Cp>
int launch_coop(const int32_t* consts, const int16_t* pts, int32_t* out, int Kp, int B, int warps,
                int smem, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (Kp < 1 || B < 1) return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = coop_prepare(tree_sum_coop_kernel<Cp>, coop_smem_bytes<Cp>(Kp, warps), warps, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  err = fold_load_consts(consts, Cv::NCONST, st);
  if (err != cudaSuccess) return static_cast<int>(err);
  tree_sum_coop_kernel<Cp><<<B, warps * 32, smem, st>>>(pts, out, Kp, B);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// consts: the curve's (NCONST, N) int32 block; pts: (B, Kp, COORDS, N)
// int16; out: (COORDS, N, B) int32; warps per block and dynamic shared bytes
// (at least coop_smem_bytes(Kp, warps)). Each returns the CUDA error of the
// launch (0 on success).
extern "C" int tree_sum_ed25519_launch(const int32_t* consts, const int16_t* pts, int32_t* out,
                                       int Kp, int B, int warps, int smem, void* stream) {
  return launch_coop<Ed25519, EdCoop>(consts, pts, out, Kp, B, warps, smem, stream);
}

extern "C" int tree_sum_bn254_g1_launch(const int32_t* consts, const int16_t* pts, int32_t* out,
                                        int Kp, int B, int warps, int smem, void* stream) {
  return launch_coop<Bn254G1, G1Coop>(consts, pts, out, Kp, B, warps, smem, stream);
}

extern "C" int tree_sum_bn254_g2_launch(const int32_t* consts, const int16_t* pts, int32_t* out,
                                        int Kp, int B, int warps, int smem, void* stream) {
  return launch_coop<Bn254G2, G2Coop>(consts, pts, out, Kp, B, warps, smem, stream);
}
