// K2 horner: one Horner step of the windowed MSM, acc <- 2^8 * acc + wsum
// (ed25519, BN254 G1, BN254 G2).
//
// Replaces the JAX package's Pallas kernel libzkp_tpu/ops/curve_jax.py
// _horner_call: 8 pdoubles and 1 padd per lane over (COORDS, N, B). The
// ed25519 instance runs in the range prover's window walk (512 or 1024
// lanes) and in the v1 window walk of the mesh-sharded MSM (128 lanes a
// block); the BN254 instances in the mesh's v1 window walk.
//
// Bound: integer multiply-adds. Per lane, ed25519: 8 pdoubles of 8 field
// products and one padd of 9, each N^2 = 576 convolution and 52 fold
// multiply-adds (the nonzero limbs of p = 2^255 - 19's fold rows); BN254: 9
// padds (a Weierstrass pdouble is padd(p, p)) of 12 products and 2 small
// multiplies (G1) or 42 products (G2), each N^2 + (N + 2) * N = 1200
// multiply-adds; against 3 * COORDS * N * 4 bytes moved per lane.
//
// Design, every curve: one group of threads per lane runs the 9 steps on
// the curve's cooperative padd and pdouble (coop_horner_kernel<Cp, 1, 8>,
// coop_horner.cuh), one warp a block. The chain is a latency chain on too
// few lanes to fill the card, so the lever is a short step:
// * ed25519, four threads a lane (EdCoop), eight lanes a warp: a pdouble's
//   latency is 2 products and the padd's 3, where one thread per lane ran 8
//   and 9 with its operands in local memory (an out-of-line product), each
//   product ed_mul, the fold product with p = 2^255 - 19's 52 nonzero fold
//   terms in the code (coop_sum.cuh). At the range prover's 1024 lanes that
//   is 128 one-warp blocks, one an SM, where blocks of 128 one-thread lanes
//   gave 8.
// * G1, six threads a lane (G1Coop), five lanes a warp: a padd's latency is
//   2 products of one thread where one thread ran all 12.
// * G2, 18 threads a lane (G2Coop18), one lane a warp: 3 products where one
//   thread ran 42 (7 on G2Coop's six threads).
// The accumulator and the window sum are narrowed once to int16 in shared
// memory; this is exact on every path (coop_horner.cuh states the
// precondition), where the accumulator is the identity or an earlier horner
// output and the window sum a window_sum or tree_sum output.
//
// Every formula is the plain version's, step for step, so the limbs are
// identical to it.

#include "coop_horner.cuh"

// consts: the curve's (NCONST, N) int32 block; acc, wsum, out: (COORDS, N, B)
// int32; blocks, warps per block (blocks * warps * Cp::PER_WARP >= B) and
// dynamic shared bytes (at least coop_horner_smem_bytes<Cp, 1>(warps)). Each
// returns the CUDA error of the launch (0 on success).
extern "C" int horner_ed25519_launch(const int32_t* consts, const int32_t* acc,
                                     const int32_t* wsum, int32_t* out, int B, int blocks,
                                     int warps, int smem, void* stream) {
  return coop_horner_launch<Ed25519, EdCoop, 1>(consts, acc, wsum, out, B, blocks, warps, smem, stream);
}

extern "C" int horner_bn254_g1_launch(const int32_t* consts, const int32_t* acc,
                                      const int32_t* wsum, int32_t* out, int B, int blocks,
                                      int warps, int smem, void* stream) {
  return coop_horner_launch<Bn254G1, G1Coop, 1>(consts, acc, wsum, out, B, blocks, warps, smem, stream);
}

extern "C" int horner_bn254_g2_launch(const int32_t* consts, const int32_t* acc,
                                      const int32_t* wsum, int32_t* out, int B, int blocks,
                                      int warps, int smem, void* stream) {
  return coop_horner_launch<Bn254G2, G2Coop18, 1>(consts, acc, wsum, out, B, blocks, warps, smem, stream);
}
