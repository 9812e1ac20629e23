// A4 window_sum4: four windows of the fixed-basis MSM at once (BN254 G1, G2).
//
// Replaces the JAX package's Pallas kernel libzkp_tpu/ops/curve_jax.py
// _window_fused4_call, the window sum of the v4 MSM (_msm_jit_v4): for the four
// digit windows w of a group and every lane b, it sums
// table[k * 256 + digit[w, k, b]] over the basis k = 0..Kp-1 into output lane
// w * B + b of a (COORDS, N, 4B) tensor, the layout the JAX kernel writes.
//
// The TPU kernel gathered rows through a one-hot int8 matmul on its matrix
// unit (a TPU stand-in for a gather) and carried the sum over the basis across
// sequential grid steps. Here each output lane reads its int16 rows directly
// (144 bytes for G1, 288 for G2, as 16-byte loads), and the sum over all of Kp
// stays inside one block: Hopper has no grid axis that carries a sum.
//
// Bound: integer multiply-adds, not bytes. An output lane needs Kp - 1 padds;
// a G1 padd (RCB, algorithm 7) is 12 field products and 2 small multiplies,
// a G2 padd 42 field products, each N^2 + (N + 2) * N = 1200 multiply-adds:
// (Kp - 1) * 42 * 1200 per G2 lane. Each output lane reads Kp rows of the
// table (13 to 26 MB at the Groth16 shapes, within the 50 MB L2), far below
// the operations' time.
//
// G1: one warp per output lane (warp_window_sum in fold_curves.cuh): thread
// s adds the points k = s, s + 32, ... (16 at Kp = 512), then a 5-level
// shuffle tree. The sum is taken in another order than the plain version's
// tree, so limbs differ while the point is the same.
//
// G2: one block per output lane runs coop_tree_sum (coop_sum.cuh): the plain
// version's halving tree, so the limbs equal the plain version's and JAX's.
// A G2 point is 144 int32 and a padd's temporaries another 480, far above
// 255 registers, so one thread no longer carries a padd (the first version's
// 5392-byte local frame, every product loading its operands from it): six
// threads share one padd in shared memory and each product runs on register
// arrays. The level store (ceil(Kp/2) int16 points, 50.7 KB at Kp = 352) and
// the padd scratch (3072 bytes a padd, five padds a warp) are dynamic shared
// memory; the wrapper (ops/kernels.py coop_sum_geometry) picks the warps per
// block so that two blocks share an SM when the lanes outnumber twice the
// SMs (4 warps at Kp = 352: measured faster than one block of 11 warps).

#include "coop_sum.cuh"

namespace {

constexpr int WG = 4;     // windows per group
constexpr int WARPS = 4;  // output lanes per block

template <class Cv>
__global__ void __launch_bounds__(WARPS * 32)
window_sum4_kernel(const int16_t* __restrict__ table, const int32_t* __restrict__ digits,
                   int32_t* __restrict__ out, int Kp, int B) {
  const int s = threadIdx.x & 31;
  const int j = blockIdx.x * WARPS + (threadIdx.x >> 5);  // output lane w * B + b
  if (j >= WG * B) return;  // the whole warp shares j, so it leaves together
  const int w = j / B;
  const int b = j - w * B;
  int32_t acc[Cv::COORDS][fold::N];
  int32_t pt[Cv::COORDS][fold::N];
  warp_window_sum<Cv>(acc, pt, table, digits + (size_t)w * Kp * B + b, B, Kp, s);
  if (s == 0) pt_store_lanes<Cv>(out, acc, j, WG * B);
}

template <class Cv>
int launch(const int32_t* consts, const int16_t* table, const int32_t* digits, int32_t* out,
           int Kp, int B, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err = fold_load_consts(consts, Cv::NCONST, st);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int blocks = (WG * B + WARPS - 1) / WARPS;
  window_sum4_kernel<Cv><<<blocks, WARPS * 32, 0, st>>>(table, digits, out, Kp, B);
  return static_cast<int>(cudaGetLastError());
}

// G2: block j sums output lane j = w * B + b; dynamic shared memory
// coop_smem_bytes<G2Coop>(Kp, blockDim.x / 32).
__global__ void __launch_bounds__(coop::MAX_WARPS * 32)
window_sum4_g2_kernel(const int16_t* __restrict__ table, const int32_t* __restrict__ digits,
                      int32_t* __restrict__ out, int Kp, int B) {
  const int j = blockIdx.x;
  const int w = j / B;
  const int32_t* digit = digits + (size_t)w * Kp * B + (j - w * B);
  coop_tree_sum<G2Coop>([=](int k) {
    return table + (size_t)(k * 256 + (digit[(size_t)k * B] & 0xFF)) * G2Coop::POINT;
  }, Kp, out, j, WG * B);
}

}  // namespace

// consts: the curve's (NCONST, N) int32 block; table: (Kp * 256, COORDS, N)
// int16; digits: (4, Kp, B) int32 in [0, 256), window 0 the highest of the
// group; out: (COORDS, N, 4B) int32; G2 only: warps per block and dynamic
// shared bytes (at least coop_smem_bytes<G2Coop>(Kp, warps)). Each returns the CUDA
// error of the launch (0 on success).
extern "C" int window_sum4_bn254_g1_launch(const int32_t* consts, const int16_t* table,
                                           const int32_t* digits, int32_t* out, int Kp, int B,
                                           void* stream) {
  return launch<Bn254G1>(consts, table, digits, out, Kp, B, stream);
}

extern "C" int window_sum4_bn254_g2_launch(const int32_t* consts, const int16_t* table,
                                           const int32_t* digits, int32_t* out, int Kp, int B,
                                           int warps, int smem, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (Kp < 1) return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = coop_prepare(window_sum4_g2_kernel, coop_smem_bytes<G2Coop>(Kp, warps), warps, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  err = fold_load_consts(consts, Bn254G2::NCONST, st);
  if (err != cudaSuccess) return static_cast<int>(err);
  window_sum4_g2_kernel<<<WG * B, warps * 32, smem, st>>>(table, digits, out, Kp, B);
  return static_cast<int>(cudaGetLastError());
}
