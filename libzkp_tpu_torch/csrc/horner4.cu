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
// Both curves run one design, coop_horner_kernel<Cp, 4, 8> (coop_horner.cuh,
// shared with horner G1 and G2 and pair_add G2): one group of six threads
// per lane runs the chain on the curve's cooperative padd, G1Coop or G2Coop
// (coop_sum.cuh), so a padd's latency is the products of one thread (G1: 2
// of 12; G2: 7 of 42, 3 in round 1, 1 in round 2, 3 in round 3). Five
// groups share a warp; blocks of one warp spread the 256 lanes of a batch
// over 52 warps, each alone on its SM. The accumulator and the lane's four
// window sums are narrowed once into shared memory as int16 points: each is
// a padd output (window_sum4, an earlier horner4) or the identity, and every
// padd output limb lies in [-7643, 11737] (fold_curves.cuh), so the
// narrowing is exact.
//
// Every padd's rows are the plain version's, step for step, so the limbs are
// identical to it.

#include "coop_horner.cuh"

namespace {

constexpr int WG = 4;  // windows per group

}  // namespace

// consts: the curve's (NCONST, N) int32 block; acc, out: (COORDS, N, B)
// int32; wsums: (COORDS, N, 4B) int32; blocks, warps per block
// (blocks * warps * 5 >= B) and dynamic shared bytes (at least
// coop_horner_smem_bytes<Cp, 4>(warps)). Each returns the CUDA error of the
// launch (0 on success).
extern "C" int horner4_bn254_g1_launch(const int32_t* consts, const int32_t* acc,
                                       const int32_t* wsums, int32_t* out, int B, int blocks,
                                       int warps, int smem, void* stream) {
  return coop_horner_launch<Bn254G1, G1Coop, WG>(consts, acc, wsums, out, B, blocks, warps, smem, stream);
}

extern "C" int horner4_bn254_g2_launch(const int32_t* consts, const int32_t* acc,
                                       const int32_t* wsums, int32_t* out, int B, int blocks,
                                       int warps, int smem, void* stream) {
  return coop_horner_launch<Bn254G2, G2Coop, WG>(consts, acc, wsums, out, B, blocks, warps, smem, stream);
}
