// K1 window_sum: one window of the fixed-basis MSM.
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
// Design: one warp per lane. Thread s of the warp adds the points
// k = s, s + 32, ... (five each at Kp = 160), then the 32 partial sums meet
// in a shuffle tree (16, 8, 4, 2, 1), so 32 threads share a lane's products
// instead of one. The sum is taken in another order than the plain version's
// tree, so the limbs differ while the point is the same: the two are held to
// each other by point equality. Limbs and temporaries live in registers and
// local memory (spills allowed in this first version).

#include "fe25519_fold.cuh"

namespace {

constexpr int WARPS = 4;  // lanes per block

// Row `row` of the (Kp * 256, COORDS, N) int16 table, widened to int32.
__device__ __forceinline__ void load_row(int32_t (*pt)[fold::N], const int16_t* __restrict__ table,
                                         int row) {
  constexpr int WORDS = fold::COORDS * fold::N / 8;  // 16-byte words per row
  const int4* src = reinterpret_cast<const int4*>(table + (size_t)row * fold::COORDS * fold::N);
#pragma unroll
  for (int w = 0; w < WORDS; ++w) {
    const int4 v = __ldg(src + w);
    const int32_t words[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
    for (int h = 0; h < 4; ++h) {
      const int f = w * 8 + h * 2;
      pt[f / fold::N][f % fold::N] = (int32_t)(int16_t)(words[h] & 0xFFFF);
      pt[(f + 1) / fold::N][(f + 1) % fold::N] = words[h] >> 16;
    }
  }
}

__global__ void __launch_bounds__(WARPS * 32)
window_sum_kernel(const int16_t* __restrict__ table, const int32_t* __restrict__ digits,
                  int32_t* __restrict__ out, int Kp, int B) {
  using namespace fold;
  const int s = threadIdx.x & 31;
  const int b = blockIdx.x * WARPS + (threadIdx.x >> 5);
  if (b >= B) return;  // the whole warp shares b, so it leaves together
  int32_t acc[COORDS][N];
  int32_t pt[COORDS][N];
  bool have = false;
  for (int k = s; k < Kp; k += 32) {
    const int d = digits[(size_t)k * B + b] & 0xFF;
    if (!have) {
      load_row(acc, table, k * 256 + d);
      have = true;
    } else {
      load_row(pt, table, k * 256 + d);
      ed_padd(acc, acc, pt);
    }
  }
  if (!have) {  // Kp < 32: this thread's share is the identity
#pragma unroll
    for (int c = 0; c < COORDS; ++c)
#pragma unroll
      for (int i = 0; i < N; ++i) acc[c][i] = (i == 0 && (c == 1 || c == 2)) ? 1 : 0;
  }
#pragma unroll 1
  for (int off = 16; off > 0; off >>= 1) {
#pragma unroll
    for (int c = 0; c < COORDS; ++c)
#pragma unroll
      for (int i = 0; i < N; ++i) pt[c][i] = __shfl_down_sync(0xffffffffu, acc[c][i], off);
    if (s < off) ed_padd(acc, acc, pt);
  }
  if (s == 0) pt_store_lanes(out, acc, b, B);
}

}  // namespace

// consts: (N + 4, N) int32; table: (Kp * 256, COORDS, N) int16; digits:
// (Kp, B) int32 in [0, 256); out: (COORDS, N, B) int32. Returns the CUDA
// error of the launch (0 on success).
extern "C" int window_sum_launch(const int32_t* consts, const int16_t* table,
                                 const int32_t* digits, int32_t* out, int Kp, int B,
                                 void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err = fold_load_consts(consts, st);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int blocks = (B + WARPS - 1) / WARPS;
  window_sum_kernel<<<blocks, WARPS * 32, 0, st>>>(table, digits, out, Kp, B);
  return static_cast<int>(cudaGetLastError());
}
