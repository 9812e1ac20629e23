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
// G2 padd (g2_padd_coop, coop_sum.cuh): a padd's latency is the 7 products
// of one thread (3 in round 1, 1 in round 2, 3 in round 3) where one thread
// per lane ran all 42. Five groups share a warp; blocks of one warp (the
// wrapper's choice, ops/kernels.py coop_horner_geometry) spread the 52
// warps of 256 lanes over 52 SMs, each warp alone on its SM. The accumulator
// and the lane's four window sums are narrowed once into shared memory as
// int16 points: each is a padd output (window_sum4, an earlier horner4) or
// the identity, and every padd output limb lies in [-7643, 11737]
// (fold_curves.cuh), so the narrowing is exact. A doubling is
// padd(acc, acc) in place, which g2_padd_coop allows.
//
// Both formulas are the plain version's, step for step, so the limbs are
// identical to it.

#include "coop_sum.cuh"

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

// G2: dynamic shared memory of a block of `warps` warps: per group, the
// accumulator and its WG window sums as int16 points; then per group its
// padd scratch.
constexpr size_t g2_smem_bytes(int warps) {
  return (size_t)warps * coop::PADDS_PER_WARP *
         ((1 + WG) * G2Coop::POINT * sizeof(int16_t) + G2Coop::SCRATCH * sizeof(int32_t));
}

// G2: group `slot` of block blockIdx.x runs lane b = blockIdx.x * slots +
// slot; groups past B (and lanes 30, 31 of each warp) pass act = false and
// meet every __syncwarp of the chain.
__global__ void __launch_bounds__(coop::MAX_WARPS * 32)
horner4_g2_kernel(const int32_t* __restrict__ acc_in, const int32_t* __restrict__ wsums,
                  int32_t* __restrict__ out, int B) {
  using namespace coop;
  using fold::N;
  constexpr int POINT = G2Coop::POINT;
  const int slots = (blockDim.x >> 5) * PADDS_PER_WARP;
  const int grp = (threadIdx.x & 31) / GROUP;
  const int g = (threadIdx.x & 31) - grp * GROUP;
  const int slot = (threadIdx.x >> 5) * PADDS_PER_WARP + (grp < PADDS_PER_WARP ? grp : 0);
  const int b = blockIdx.x * slots + slot;
  const bool act = grp < PADDS_PER_WARP && b < B;
  int16_t* pts = reinterpret_cast<int16_t*>(coop_smem());
  int16_t* acc = pts + (size_t)slot * (1 + WG) * POINT;
  int16_t* wins = acc + POINT;
  int32_t* scr = reinterpret_cast<int32_t*>(pts + (size_t)slots * (1 + WG) * POINT) + slot * G2Coop::SCRATCH;
  if (act) {  // thread g narrows row g of the accumulator and of each window sum
#pragma unroll 1
    for (int i = 0; i < N; ++i) {
      const size_t r = (size_t)g * N + i;
      acc[r] = (int16_t)acc_in[r * B + b];
#pragma unroll
      for (int v = 0; v < WG; ++v) wins[v * POINT + r] = (int16_t)wsums[r * WG * B + (size_t)v * B + b];
    }
  }
  __syncwarp();
#pragma unroll 1
  for (int v = 0; v < WG; ++v) {
#pragma unroll 1
    for (int r = 0; r < 9; ++r)  // 8 doublings, then + window v
      G2Coop::padd(acc, acc, r < 8 ? acc : wins + v * POINT, scr, g, act);
  }
  if (act) {
#pragma unroll 1
    for (int i = 0; i < N; ++i) out[((size_t)g * N + i) * B + b] = acc[g * N + i];
  }
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
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (B < 1 || blocks < 1 || (long long)blocks * warps * coop::PADDS_PER_WARP < B)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = coop_prepare(horner4_g2_kernel, g2_smem_bytes(warps), warps, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  err = fold_load_consts(consts, Bn254G2::NCONST, st);
  if (err != cudaSuccess) return static_cast<int>(err);
  horner4_g2_kernel<<<blocks, warps * 32, smem, st>>>(acc, wsums, out, B);
  return static_cast<int>(cudaGetLastError());
}
