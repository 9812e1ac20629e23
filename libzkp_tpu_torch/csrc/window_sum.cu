// K1 window_sum: one window of the fixed-basis MSM (ed25519).
//
// Replaces the JAX package's fused gather + tree-sum Pallas kernel,
// libzkp_tpu/ops/curve_jax.py _window_fused_call. For every lane b it sums
// table[k * 256 + digit[k, b]] over the basis k = 0..Kp-1 with the complete
// Edwards addition. The TPU kernel gathered through a one-hot int8 matmul on
// its matrix unit (a TPU stand-in for a gather); here each lane loads its
// rows from the int16 table directly, 192 bytes each as twelve 16-byte loads.
//
// Bound: integer multiply-adds, not bytes. One padd is 9 field products of
// N^2 = 576 convolution plus (N + 2) * N = 624 fold multiply-adds; a lane
// needs Kp - 1 padds, against 192 bytes of table per point.
//
// Design: one warp per lane (warp_window_sum in fold_curves.cuh). Thread s
// of the warp adds the points k = s, s + 32, ... (five each at Kp = 160),
// then the 32 partial sums meet in a shuffle tree, so 32 threads share a
// lane's products instead of one. The sum is taken in another order than the
// plain version's tree, so the limbs differ while the point is the same: the
// two are held to each other by point equality. Limbs and temporaries live in
// registers and local memory (spills allowed in this first version).

#include "fold_curves.cuh"

namespace {

constexpr int WARPS = 4;  // lanes per block

template <class Cv>
__global__ void __launch_bounds__(WARPS * 32)
window_sum_kernel(const int16_t* __restrict__ table, const int32_t* __restrict__ digits,
                  int32_t* __restrict__ out, int Kp, int B) {
  const int s = threadIdx.x & 31;
  const int b = blockIdx.x * WARPS + (threadIdx.x >> 5);
  if (b >= B) return;  // the whole warp shares b, so it leaves together
  int32_t acc[Cv::COORDS][fold::N];
  int32_t pt[Cv::COORDS][fold::N];
  warp_window_sum<Cv>(acc, pt, table, digits + b, B, Kp, s);
  if (s == 0) pt_store_lanes<Cv>(out, acc, b, B);
}

}  // namespace

// consts: (N + 4, N) int32; table: (Kp * 256, 4, N) int16; digits:
// (Kp, B) int32 in [0, 256); out: (4, N, B) int32. Returns the CUDA error of
// the launch (0 on success).
extern "C" int window_sum_ed25519_launch(const int32_t* consts, const int16_t* table,
                                         const int32_t* digits, int32_t* out, int Kp, int B,
                                         void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err = fold_load_consts(consts, Ed25519::NCONST, st);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int blocks = (B + WARPS - 1) / WARPS;
  window_sum_kernel<Ed25519><<<blocks, WARPS * 32, 0, st>>>(table, digits, out, Kp, B);
  return static_cast<int>(cudaGetLastError());
}
