// K1 window_sum: one window of the fixed-basis MSM (ed25519).
//
// Replaces the JAX package's fused gather + tree-sum Pallas kernel,
// libzkp_tpu/ops/curve_jax.py _window_fused_call. For every lane b it sums
// table[k * 256 + digit[k, b]] over the basis k = 0..Kp-1 with the complete
// Edwards addition. The TPU kernel gathered through a one-hot int8 matmul on
// its matrix unit (a TPU stand-in for a gather); here each padd reads its
// level-1 rows from the int16 table directly, 192 bytes each as twelve
// 16-byte loads.
//
// Bound: integer multiply-adds, not bytes. One padd is 9 field products of
// N^2 = 576 convolution and 52 fold multiply-adds (the nonzero limbs of
// p = 2^255 - 19's fold rows); a lane needs Kp - 1 padds, against 192 bytes
// of table per point.
//
// Design: one block per lane runs coop_tree_sum<EdCoop> (coop_sum.cuh), the
// plain version's halving tree (ops/edwards.py _tree_reduce), so the limbs
// equal the plain version's and JAX's. Four threads share an Edwards padd
// in shared memory, each product on register arrays, eight padds a warp; a
// padd's latency is three products of one thread. Each product is ed_mul,
// the fold product with p = 2^255 - 19's constants in the code and its 572
// zero fold terms left out (the same sums; 2.4x faster than the generic
// product in this kernel, paired on the card). The level store
// (ceil(Kp/2) int16 points, 15,360 bytes at Kp = 160) and the padd scratch
// (384 bytes a padd) are dynamic shared memory, and the wrapper
// (ops/kernels.py coop_sum_geometry) picks the warps per block. The first
// version gave a lane one warp: thread s added the points k = s, s + 32,
// ..., then a 5-level shuffle tree ran with every level's padd executed by
// all 32 threads (288 padds of one thread a lane, 159 needed, out of a
// 1728-byte local frame), and it summed in another order than the plain
// tree, so only the points agreed.

#include "coop_sum.cuh"

namespace {

// block b sums lane b; dynamic shared memory coop_smem_bytes<EdCoop>(Kp,
// blockDim.x / 32)
__global__ void __launch_bounds__(coop::MAX_WARPS * 32)
window_sum_kernel(const int16_t* __restrict__ table, const int32_t* __restrict__ digits,
                  int32_t* __restrict__ out, int Kp, int B) {
  const int32_t* digit = digits + blockIdx.x;
  coop_tree_sum<EdCoop>([=](int k) {
    return table + (size_t)(k * 256 + (digit[(size_t)k * B] & 0xFF)) * EdCoop::POINT;
  }, Kp, out, blockIdx.x, B);
}

}  // namespace

// consts: (N + 4, N) int32; table: (Kp * 256, 4, N) int16; digits:
// (Kp, B) int32 in [0, 256); out: (4, N, B) int32; warps per block and
// dynamic shared bytes (at least coop_smem_bytes<EdCoop>(Kp, warps)).
// Returns the CUDA error of the launch (0 on success).
extern "C" int window_sum_ed25519_launch(const int32_t* consts, const int16_t* table,
                                         const int32_t* digits, int32_t* out, int Kp, int B,
                                         int warps, int smem, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (Kp < 1 || B < 1) return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = coop_prepare(window_sum_kernel, coop_smem_bytes<EdCoop>(Kp, warps), warps, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  err = fold_load_consts(consts, Ed25519::NCONST, st);
  if (err != cudaSuccess) return static_cast<int>(err);
  window_sum_kernel<<<B, warps * 32, smem, st>>>(table, digits, out, Kp, B);
  return static_cast<int>(cudaGetLastError());
}
