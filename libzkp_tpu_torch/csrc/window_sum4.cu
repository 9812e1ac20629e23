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
// sequential grid steps. Here each padd reads its int16 table rows directly
// (144 bytes for G1, 288 for G2, as 16-byte loads): Hopper has no grid axis
// that carries a sum.
//
// Bound: integer multiply-adds, not bytes. An output lane needs Kp - 1 padds;
// a G1 padd (RCB, algorithm 7) is 12 field products and 2 small multiplies,
// a G2 padd 42 field products, each N^2 + (N + 2) * N = 1200 multiply-adds:
// (Kp - 1) * 42 * 1200 per G2 lane. Each output lane reads Kp rows of the
// table (13 to 26 MB at the Groth16 shapes, within the 50 MB L2), far below
// the operations' time.
//
// Both curves sum in the plain version's halving tree order (ops/edwards.py
// _tree_reduce), so the limbs equal the plain version's and JAX's, on the
// cooperative padds of coop_sum.cuh (six threads share one padd in shared
// memory, each product on register arrays, five padds a warp).
//
// G2: one block per output lane runs coop_tree_sum<G2Coop>. The level store
// (ceil(Kp/2) int16 points, 50.7 KB at Kp = 352) and the padd scratch (3072
// bytes a padd) are dynamic shared memory; the wrapper (ops/kernels.py
// coop_sum_geometry) picks the warps per block so that two blocks share an
// SM when the lanes outnumber twice the SMs.
//
// G1: the same tree, scheduled so that every group stays busy. While the
// level size is even, _tree_reduce pairs point i with point i + half, so
// after l levels node r (r < G = Kp / 2^l) is the complete binary tree over
// the points k = r + m G, m < 2^l, and its top split is m even (left) against
// m odd (right): its leaves in bit-reversed order of m. Kernel 1 gives each
// of a lane's G nodes to one six-thread group, which sums its 2^l points in
// that order, one padd at a time: a binary counter over the leaf pairs, the
// pending left node of each level (and the right node being combined) held
// as int16 points in shared memory, the node itself written to `partials`
// in global memory. Kernel 2, one block a lane, runs coop_tree_sum<G1Coop>
// over the lane's G nodes: the plain tree's remaining levels. G = Kp skips
// kernel 1 (the tree over the gathered rows in one block a lane), G = 1
// leaves kernel 2 one copy. The wrapper (ops/kernels.py
// window_sum4_g1_geometry) picks G from Kp and the lanes: at the Groth16
// batch's 1024 lanes the fewest nodes that give each SM two waves of kernel
// 1 blocks (Kp = 512: G = 32, chains of 15 padds, 1.22 ms against 1.29 for
// G = Kp and 1.37 for G = 8, paired on the card), at few lanes the fewest
// dependent padd steps (Kp = 512 at 32 lanes: G = 128, 0.131 ms against
// 0.210). The G1 padd's throughput an SM, not the schedule, bounds the
// rest: about 3 padds a microsecond an SM from 12 warps an SM on, a third of
// the integer multiply-adds' rate. The first version gave a lane one warp:
// thread s added the points k = s, s + 32, ... in one thread (12 products a
// padd, with two G1 points in 255 registers and a 1616-byte local frame),
// then a 5-level shuffle tree, in another order than the plain tree's, so
// only the points agreed.

#include "coop_sum.cuh"

namespace {

constexpr int WG = 4;               // windows per group
constexpr int G1_NODE_BLOCKS = 18;  // kernel 1's one-warp blocks an SM: at most 112 registers
constexpr int G1_TOP_WARPS = 8;     // kernel 2's largest block, two an SM: at most 128 registers

// Row of point k of output lane j = w * B + b: table[k * 256 + digit[w, k, b]].
__device__ __forceinline__ const int16_t* g1_row(const int16_t* __restrict__ table,
                                                 const int32_t* __restrict__ digits, int Kp, int B,
                                                 int j, int k) {
  const int w = j / B;
  const int d = digits[((size_t)w * Kp + k) * B + (j - w * B)] & 0xFF;
  return table + (size_t)(k * 256 + d) * G1Coop::POINT;
}

// Kernel 1: group q = blockIdx.x * 5 + slot sums node r = q % G of output
// lane j = q / G over its 2^ell points into partials[q]. Shared memory per
// group: ell int16 points (the pending left nodes of levels 1..ell-1, then
// the right node being combined, W), then its padd scratch.
__global__ void __launch_bounds__(32, G1_NODE_BLOCKS)
window_sum4_g1_nodes_kernel(const int16_t* __restrict__ table, const int32_t* __restrict__ digits,
                            int16_t* __restrict__ partials, int Kp, int B, int G, int ell) {
  constexpr int POINT = G1Coop::POINT, GROUP = G1Coop::GROUP, PER_WARP = G1Coop::PER_WARP;
  const int grp = threadIdx.x / GROUP;
  const int g = threadIdx.x - grp * GROUP;
  const int slot = grp < PER_WARP ? grp : 0;
  const int q = blockIdx.x * PER_WARP + slot;
  const bool act = grp < PER_WARP && q < WG * B * G;
  const int j = act ? q / G : 0;  // an idle group reads lane 0's rows and writes nothing
  const int r = act ? q - j * G : 0;
  int16_t* pts = reinterpret_cast<int16_t*>(coop_smem());
  int16_t* S = pts + (size_t)slot * ell * POINT;  // S[l - 1]: level l's pending left node
  int16_t* W = S + (size_t)(ell - 1) * POINT;
  int32_t* scr = reinterpret_cast<int32_t*>(pts + (size_t)PER_WARP * ell * POINT) + slot * G1Coop::SCRATCH;
  int16_t* node = partials + (size_t)q * POINT;
  const int pairs = 1 << (ell - 1);
#pragma unroll 1
  for (int u = 0; u < pairs; ++u) {  // leaf positions 2u, 2u + 1: m and m + pairs
    const int m = (int)(__brev(2u * u) >> (32 - ell));
    const int16_t* P = g1_row(table, digits, Kp, B, j, r + m * G);
    const int16_t* Q = g1_row(table, digits, Kp, B, j, r + (m + pairs) * G);
    int v = u;  // index of the level-l node this padd makes
#pragma unroll 1
    for (int l = 1;; ++l) {  // uniform over the block: every thread meets every padd
      int16_t* dst = l == ell ? node : ((v & 1) ? W : S + (size_t)(l - 1) * POINT);
      G1Coop::padd(dst, P, Q, scr, g, act);
      if (l == ell || !(v & 1)) break;
      P = S + (size_t)(l - 1) * POINT;  // a right node: its left sibling + it
      Q = W;
      v >>= 1;
    }
  }
}

// Kernel 2: block j sums output lane j's G nodes (or, G = Kp, its gathered
// rows) in the plain tree's order; dynamic shared memory
// coop_smem_bytes<G1Coop>(G, blockDim.x / 32).
__global__ void __launch_bounds__(G1_TOP_WARPS * 32, 2)
window_sum4_g1_top_kernel(const int16_t* __restrict__ table, const int32_t* __restrict__ digits,
                          const int16_t* __restrict__ partials, int32_t* __restrict__ out, int Kp, int B,
                          int G) {
  const int j = blockIdx.x;
  coop_tree_sum<G1Coop>([=](int k) {
    return G == Kp ? g1_row(table, digits, Kp, B, j, k) : partials + ((size_t)j * G + k) * G1Coop::POINT;
  }, G, out, j, WG * B);
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
// group; out: (COORDS, N, 4B) int32. Each returns the CUDA error of the
// launch (0 on success; cudaErrorInvalidValue for a bad geometry).
//
// G1: partials: (4B * G, COORDS, N) int16 scratch (unused, may be null, when
// G = Kp); G divides Kp with Kp / G a power of two; kernel 1's dynamic shared
// bytes (at least 5 * (log2(Kp / G) * POINT * 2 + SCRATCH * 4)), kernel 2's
// warps (at most 8) and dynamic shared bytes (at least
// coop_smem_bytes<G1Coop>(G, warps)).
extern "C" int window_sum4_bn254_g1_launch(const int32_t* consts, const int16_t* table,
                                           const int32_t* digits, int16_t* partials, int32_t* out,
                                           int Kp, int B, int G, int nodes_smem, int warps, int smem,
                                           void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (Kp < 1 || B < 1 || G < 1 || Kp % G != 0 || ((Kp / G) & (Kp / G - 1)) != 0 || warps > G1_TOP_WARPS)
    return static_cast<int>(cudaErrorInvalidValue);
  const int ell = 31 - __builtin_clz((unsigned)(Kp / G));
  cudaError_t err;
  if (ell > 0) {
    const size_t need = (size_t)G1Coop::PER_WARP *
                        (ell * G1Coop::POINT * sizeof(int16_t) + G1Coop::SCRATCH * sizeof(int32_t));
    if (partials == nullptr) return static_cast<int>(cudaErrorInvalidValue);
    err = coop_prepare(window_sum4_g1_nodes_kernel, need, 1, nodes_smem);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  err = coop_prepare(window_sum4_g1_top_kernel, coop_smem_bytes<G1Coop>(G, warps), warps, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  err = fold_load_consts(consts, Bn254G1::NCONST, st);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (ell > 0) {
    const long long groups = (long long)WG * B * G;
    const int blocks = (int)((groups + G1Coop::PER_WARP - 1) / G1Coop::PER_WARP);
    window_sum4_g1_nodes_kernel<<<blocks, 32, nodes_smem, st>>>(table, digits, partials, Kp, B, G, ell);
    err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  window_sum4_g1_top_kernel<<<WG * B, warps * 32, smem, st>>>(table, digits, partials, out, Kp, B, G);
  return static_cast<int>(cudaGetLastError());
}

// G2: warps per block and dynamic shared bytes (at least
// coop_smem_bytes<G2Coop>(Kp, warps)).
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
