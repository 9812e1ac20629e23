// A6 tree_sum: the window sum of the mesh-sharded MSM over points gathered
// before the launch (ed25519, BN254 G1, BN254 G2).
//
// Replaces the JAX package's Pallas kernel libzkp_tpu/ops/curve_jax.py
// _window_sum_call, the window sum of the v1 window walk that each block of
// the (dp, shard) mesh runs on its slice of the basis (_msm_many_sharded_impl):
// for every lane b it sums the Kp points pts[b, k], k = 0..Kp-1, int16 table
// rows already gathered by the lane's digits, widened to int32 here.
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
// Edwards padd is 9 field products, a G1 padd (RCB) 12 products and 2 small
// multiplies, a G2 padd 42 products, each N^2 + (N + 2) * N = 1200
// multiply-adds ((Kp - 1) * 42 * 1200 per G2 lane), against COORDS * N * 2
// bytes read per point.
//
// ed25519: one warp per lane (warp_point_sum in fold_curves.cuh): thread s
// adds the points k = s, s + 32, ... (3 each at the range basis's k = 96),
// then a 5-level shuffle tree; one warp per block, so the 128 lanes of a
// block spread over 128 SMs. The sum is taken in another order than the
// plain version's tree, so the limbs differ while the point is the same.
//
// BN254 G1 and G2: one block per lane runs coop_tree_sum (coop_sum.cuh), the
// plain version's halving tree, so the limbs equal the plain version's and
// JAX's. Six threads share a padd in shared memory, each product on register
// arrays, and a lane's block has up to 12 warps (60 padds at once); the
// level store (ceil(Kp/2) int16 points: 18.4 KB for G1 at Kp = 256, 27.6 KB
// for G2 at Kp = 192) and the padd scratch (1440 bytes a G1 padd, 3072 a G2
// padd) are dynamic shared memory, the geometry the wrapper's
// (ops/kernels.py coop_sum_geometry). The first version gave a lane one
// warp: 128 lanes filled one warp of each SM, and each thread ran a chain of
// padds then 5 shuffle levels (G1 at Kp = 256: 12 dependent padds of 12
// products; G2 at Kp = 192: 11 of 42, out of a 5408-byte local frame). Now
// a G1 padd's latency is two products (one of round 1, one of round 3, in
// each of six threads) and a G2 padd's seven, and a level's padds run side
// by side: Kp = 256 is 8 levels, 11 passes of at most 60 padds.

#include "coop_sum.cuh"

namespace {

template <class Cv>
__global__ void __launch_bounds__(32)
tree_sum_kernel(const int16_t* __restrict__ pts, int32_t* __restrict__ out, int Kp, int B) {
  constexpr int POINT = Cv::COORDS * fold::N;  // int16 limbs per point
  const int s = threadIdx.x;
  const int b = blockIdx.x;
  const int16_t* lane = pts + (size_t)b * Kp * POINT;
  int32_t acc[Cv::COORDS][fold::N];
  int32_t pt[Cv::COORDS][fold::N];
  warp_point_sum<Cv>(acc, pt, [=](int k) { return lane + (size_t)k * POINT; }, Kp, s);
  if (s == 0) pt_store_lanes<Cv>(out, acc, b, B);
}

template <class Cv>
int launch(const int32_t* consts, const int16_t* pts, int32_t* out, int Kp, int B, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err = fold_load_consts(consts, Cv::NCONST, st);
  if (err != cudaSuccess) return static_cast<int>(err);
  tree_sum_kernel<Cv><<<B, 32, 0, st>>>(pts, out, Kp, B);
  return static_cast<int>(cudaGetLastError());
}

// BN254 G1, G2: block b sums lane b; dynamic shared memory
// coop_smem_bytes<Cp>(Kp, blockDim.x / 32).
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
  if (Kp < 1) return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = coop_prepare(tree_sum_coop_kernel<Cp>, coop_smem_bytes<Cp>(Kp, warps), warps, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  err = fold_load_consts(consts, Cv::NCONST, st);
  if (err != cudaSuccess) return static_cast<int>(err);
  tree_sum_coop_kernel<Cp><<<B, warps * 32, smem, st>>>(pts, out, Kp, B);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// consts: the curve's (NCONST, N) int32 block; pts: (B, Kp, COORDS, N)
// int16; out: (COORDS, N, B) int32; BN254 only: warps per block and dynamic
// shared bytes (at least coop_smem_bytes(Kp, warps)). Each returns the CUDA
// error of the launch (0 on success).
extern "C" int tree_sum_ed25519_launch(const int32_t* consts, const int16_t* pts, int32_t* out,
                                       int Kp, int B, void* stream) {
  return launch<Ed25519>(consts, pts, out, Kp, B, stream);
}

extern "C" int tree_sum_bn254_g1_launch(const int32_t* consts, const int16_t* pts, int32_t* out,
                                        int Kp, int B, int warps, int smem, void* stream) {
  return launch_coop<Bn254G1, G1Coop>(consts, pts, out, Kp, B, warps, smem, stream);
}

extern "C" int tree_sum_bn254_g2_launch(const int32_t* consts, const int16_t* pts, int32_t* out,
                                        int Kp, int B, int warps, int smem, void* stream) {
  return launch_coop<Bn254G2, G2Coop>(consts, pts, out, Kp, B, warps, smem, stream);
}
