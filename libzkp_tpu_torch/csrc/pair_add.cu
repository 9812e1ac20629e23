// K3 pair_add: elementwise complete point addition, out = p + q per lane,
// for ed25519, BN254 G1 and BN254 G2.
//
// Replaces the JAX package's Pallas kernel libzkp_tpu/ops/curve_jax.py
// _pair_add_call, the step of the multiples-table build (_table_build_jit):
// 255 chained launches give each basis point its 256 multiples. The BN254
// instances also fold the mesh's partial sums (parallel/collective.py
// reduce_points).
//
// Bound: integer multiply-adds per lane, against 3 * COORDS * N * 4 bytes
// moved: an Edwards padd is 9 field products, a G1 padd (RCB) 12 products
// and 2 small multiplies, a G2 padd 42 products (14 Fq2 products of 3), each
// BN254 product N^2 + (N + 2) * N = 576 + 624 = 1200 multiply-adds, each
// ed25519 product (ed_mul) 576 + 52. At the table builds' K of a few hundred
// lanes one launch is one padd's latency.
//
// Every curve runs one cooperative group per lane on the Horner template
// with no doublings and one window (coop_horner_kernel<Cp, 1, 0>,
// coop_horner.cuh: acc_in = p, wsums = q). ed25519 runs eight four-thread
// groups a warp on EdCoop (the range prover's table build, run once a
// process, and the mesh fold of its MSM), 3 products of one thread where one
// thread per lane ran all 9; G1 five six-thread groups a warp on G1Coop, so
// a launch's latency is 2 products of one thread where one thread per lane
// ran all 12 with its two 3 x 24 int32 points in 255 registers; G2 one group
// of 18 threads a warp on G2Coop18, 3 Fq products of one thread against 42,
// its two 6 x 24 int32 points spilled to local memory. Blocks of one warp
// spread the lanes over the SMs: the range basis's table has K = 160 lanes
// (20 blocks), the grouped route's statement tables K = 8 (two blocks), the
// query tables 352 or 512. p and q are narrowed to int16
// in shared memory: each is a table row, the base point, the identity or a
// mesh partial sum (a Horner or padd output), whose limbs lie in int16
// (coop_horner.cuh states the precondition).
//
// Every formula is the plain version's, step for step, so the limbs are
// identical to it. Fusing the 255-step chain into one launch is left for
// later work.

#include "coop_horner.cuh"

// consts: the curve's (NCONST, N) int32 block; p, q, out: (COORDS, N, K)
// int32; blocks, warps per block (blocks * warps * lanes a warp >= K: 8 for
// ed25519, 5 for G1, 1 for G2) and dynamic shared bytes (at least
// coop_horner_smem_bytes<Cp, 1>(warps)). Each returns the CUDA error of the
// launch (0 on success).
extern "C" int pair_add_ed25519_launch(const int32_t* consts, const int32_t* p, const int32_t* q,
                                       int32_t* out, int K, int blocks, int warps, int smem,
                                       void* stream) {
  return coop_horner_launch<Ed25519, EdCoop, 1, 0>(consts, p, q, out, K, blocks, warps, smem, stream);
}

extern "C" int pair_add_bn254_g1_launch(const int32_t* consts, const int32_t* p, const int32_t* q,
                                        int32_t* out, int K, int blocks, int warps, int smem,
                                        void* stream) {
  return coop_horner_launch<Bn254G1, G1Coop, 1, 0>(consts, p, q, out, K, blocks, warps, smem, stream);
}

extern "C" int pair_add_bn254_g2_launch(const int32_t* consts, const int32_t* p, const int32_t* q,
                                        int32_t* out, int K, int blocks, int warps, int smem,
                                        void* stream) {
  return coop_horner_launch<Bn254G2, G2Coop18, 1, 0>(consts, p, q, out, K, blocks, warps, smem, stream);
}
