// Cooperative Horner steps: WG steps acc <- 2^D * acc + wsums[window v] per
// lane, each lane's chain of WG x D pdoubles and WG padds run by one group
// of Cp::GROUP threads on the curve's cooperative padd and pdouble
// (coop_sum.cuh; a Weierstrass pdouble is padd(p, p), the Edwards one its own
// formula). The Horner steps double D = 8 times a window; D = 0 and WG = 1
// is one addition a lane, acc_in + wsums. Instances: horner ed25519 =
// <EdCoop, 1, 8>, horner G1 = <G1Coop, 1, 8> and horner G2 = <G2Coop18, 1,
// 8> (horner.cu), horner4 G1 = <G1Coop, 4, 8> and horner4 G2 = <G2Coop, 4,
// 8> (horner4.cu), pair_add ed25519 = <EdCoop, 1, 0>, pair_add G1 =
// <G1Coop, 1, 0> and pair_add G2 = <G2Coop18, 1, 0> (pair_add.cu). The P2
// probe's chain, R padds acc <- acc + q a lane in one launch, is
// coop_chain_kernel<EdCoop> (below; probes.cu) on the same layout.
//
// A padd's latency is the products of one thread (EdCoop: 3, a pdouble 2,
// against 9 and 8 in one thread; G1Coop: 2, against 12; G2Coop: 7 and
// G2Coop18: 3, against 42) plus its rows and __syncwarp stages. The chain
// is a latency chain: the padds of a lane depend on each other, and the
// paths give 8 (pair_add G1, a statement's table on the grouped route), 128
// (horner, a mesh block), 160 (pair_add ed25519, the range basis's table),
// 256 (horner4), 352 or 512 (pair_add, the query tables), 512 or 1024 lanes
// (horner ed25519, the range prover),
// too few to fill the card with independent work. A warp holds Cp::PER_WARP
// groups (four-thread groups: eight; six-thread groups: five, lanes 30 and
// 31 idle; 18-thread groups: one, lanes 18 to 31 idle); blocks of one warp
// (the wrapper's choice, ops/kernels.py coop_horner_geometry) spread the
// lanes' warps over the SMs (P2's chain: blocks of four, CHAIN_WARPS).
//
// Narrowing precondition: every limb of the accumulator and of the window
// sums lies in int16. They are narrowed once into shared memory as int16
// points: the accumulator is the identity (the MSM's start, a table's first
// row), an earlier Horner output or a table row, each window sum a tree
// sum's or window sum's output, a table's base point or a mesh partial sum
// (a padd output, or one int16 table row), P2's p and q encoded points
// (canonical limbs in [0, 4096)), and every padd or pdouble output
// limb lies in [-7643, 11737] (BN254, fold_curves.cuh) or [-1536, 5631]
// (ed25519, coop_sum.cuh), so the narrowing is exact and every step of the
// chain writes an int16 point exactly. A curve whose pdouble is its padd
// (Cp::PDOUBLE_IS_PADD, the Weierstrass curves) runs its doublings and its
// addition through one inlined padd: a second inlined copy of the G1 padd
// made horner4 G1 16 % slower (paired on the card). The steps run in place,
// pdouble(acc, acc) and padd(acc, acc, w), which every cooperative padd and
// pdouble allows: their operands are read in round 1 only, out written in
// the last stage.
//
// Each step's rows are the plain version's integer operations, so the limbs
// are identical to it.
#pragma once

#include "coop_sum.cuh"

// Dynamic shared memory of a block of `warps` warps: per group, the
// accumulator and its WG window sums as int16 points; then per group its
// padd scratch.
template <class Cp, int WG>
constexpr size_t coop_horner_smem_bytes(int warps) {
  return (size_t)warps * Cp::PER_WARP *
         ((1 + WG) * Cp::POINT * sizeof(int16_t) + Cp::SCRATCH * sizeof(int32_t));
}

// acc_in, out: (COORDS, N, B) int32; wsums: (COORDS, N, WG * B) int32,
// window v of lane b in lane v * B + b. Group `slot` of block blockIdx.x
// runs lane b = blockIdx.x * slots + slot; groups past B (and a warp's lanes
// past its last group) pass act = false and meet every __syncwarp of the
// chain.
template <class Cp, int WG, int D>
__global__ void __launch_bounds__(coop::MAX_WARPS * 32)
coop_horner_kernel(const int32_t* __restrict__ acc_in, const int32_t* __restrict__ wsums,
                   int32_t* __restrict__ out, int B) {
  using fold::N;
  constexpr int POINT = Cp::POINT, GROUP = Cp::GROUP, PER_WARP = Cp::PER_WARP;
  const int slots = (blockDim.x >> 5) * PER_WARP;
  const int grp = (threadIdx.x & 31) / GROUP;
  const int g = (threadIdx.x & 31) - grp * GROUP;
  const int slot = (threadIdx.x >> 5) * PER_WARP + (grp < PER_WARP ? grp : 0);
  const int b = blockIdx.x * slots + slot;
  const bool act = grp < PER_WARP && b < B;
  int16_t* pts = reinterpret_cast<int16_t*>(coop_smem());
  int16_t* acc = pts + (size_t)slot * (1 + WG) * POINT;
  int16_t* wins = acc + POINT;
  int32_t* scr = reinterpret_cast<int32_t*>(pts + (size_t)slots * (1 + WG) * POINT) + slot * Cp::SCRATCH;
  if (act) {  // thread g narrows rows g, g + GROUP, ... of the accumulator and of each window sum
#pragma unroll 1
    for (int c = g; c < Cp::COORDS; c += GROUP) {
#pragma unroll 1
      for (int i = 0; i < N; ++i) {
        const size_t r = (size_t)c * N + i;
        acc[r] = (int16_t)acc_in[r * B + b];
#pragma unroll
        for (int v = 0; v < WG; ++v) wins[v * POINT + r] = (int16_t)wsums[r * WG * B + (size_t)v * B + b];
      }
    }
  }
  __syncwarp();
#pragma unroll 1
  for (int v = 0; v < WG; ++v) {  // D doublings, then + window v
    if constexpr (Cp::PDOUBLE_IS_PADD) {  // one inlined padd for both
#pragma unroll 1
      for (int r = 0; r <= D; ++r) Cp::padd(acc, acc, r < D ? acc : wins + v * POINT, scr, g, act);
    } else {
#pragma unroll 1
      for (int r = 0; r < D; ++r) Cp::pdouble(acc, acc, scr, g, act);
      Cp::padd(acc, acc, wins + v * POINT, scr, g, act);
    }
  }
  if (act) {  // the padd's last __syncwarp has passed: acc is whole
#pragma unroll 1
    for (int c = g; c < Cp::COORDS; c += GROUP) {
#pragma unroll 1
      for (int i = 0; i < N; ++i) out[((size_t)c * N + i) * B + b] = acc[c * N + i];
    }
  }
}

// Host side: checks the geometry (blocks * warps * Cp::PER_WARP >= B, the
// block's warps, at least coop_horner_smem_bytes(warps) of dynamic shared
// memory), sets the shared memory attribute, loads the curve Cv's consts and
// launches. Returns the CUDA error (cudaErrorInvalidValue for a bad
// geometry).
template <class Cv, class Cp, int WG, int D = 8>
int coop_horner_launch(const int32_t* consts, const int32_t* acc, const int32_t* wsums, int32_t* out,
                       int B, int blocks, int warps, int smem, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (B < 1 || blocks < 1 || (long long)blocks * warps * Cp::PER_WARP < B)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = coop_prepare(coop_horner_kernel<Cp, WG, D>, coop_horner_smem_bytes<Cp, WG>(warps), warps,
                                 smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  err = fold_load_consts(consts, Cv::NCONST, st);
  if (err != cudaSuccess) return static_cast<int>(err);
  coop_horner_kernel<Cp, WG, D><<<blocks, warps * 32, smem, st>>>(acc, wsums, out, B);
  return static_cast<int>(cudaGetLastError());
}

// R chained padds acc <- acc + q a lane, out = p + R q (the P2 probe): one
// group of Cp::GROUP threads a lane, laid out as coop_horner_kernel<Cp, 1,
// 0> lays out pair_add (shared memory coop_horner_smem_bytes<Cp, 1>: per
// group the accumulator and the addend as int16 points, then its scratch).
// p and q are narrowed once, the R padds run in place on the accumulator,
// and it is widened to out at the end: one launch a chain, where R
// pair_add launches would write every step to global memory.
template <class Cp>
__global__ void __launch_bounds__(coop::MAX_WARPS * 32)
coop_chain_kernel(const int32_t* __restrict__ p, const int32_t* __restrict__ q, int32_t* __restrict__ out,
                  int R, int B) {
  using fold::N;
  constexpr int POINT = Cp::POINT, GROUP = Cp::GROUP, PER_WARP = Cp::PER_WARP;
  const int slots = (blockDim.x >> 5) * PER_WARP;
  const int grp = (threadIdx.x & 31) / GROUP;
  const int g = (threadIdx.x & 31) - grp * GROUP;
  const int slot = (threadIdx.x >> 5) * PER_WARP + (grp < PER_WARP ? grp : 0);
  const int b = blockIdx.x * slots + slot;
  const bool act = grp < PER_WARP && b < B;
  int16_t* pts = reinterpret_cast<int16_t*>(coop_smem());
  int16_t* acc = pts + (size_t)slot * 2 * POINT;
  int16_t* add = acc + POINT;
  int32_t* scr = reinterpret_cast<int32_t*>(pts + (size_t)slots * 2 * POINT) + slot * Cp::SCRATCH;
  if (act) {  // thread g narrows rows g, g + GROUP, ... of p and q
#pragma unroll 1
    for (int c = g; c < Cp::COORDS; c += GROUP) {
#pragma unroll 1
      for (int i = 0; i < N; ++i) {
        const size_t r = (size_t)c * N + i;
        acc[r] = (int16_t)p[r * B + b];
        add[r] = (int16_t)q[r * B + b];
      }
    }
  }
  __syncwarp();
#pragma unroll 1
  for (int r = 0; r < R; ++r) Cp::padd(acc, acc, add, scr, g, act);
  if (act) {  // the padd's last __syncwarp has passed: acc is whole
#pragma unroll 1
    for (int c = g; c < Cp::COORDS; c += GROUP) {
#pragma unroll 1
      for (int i = 0; i < N; ++i) out[((size_t)c * N + i) * B + b] = acc[c * N + i];
    }
  }
}

// Host side of the chain: coop_horner_launch's checks (and R >= 0), then
// the launch. Returns the CUDA error (cudaErrorInvalidValue for a bad
// geometry).
template <class Cv, class Cp>
int coop_chain_launch(const int32_t* consts, const int32_t* p, const int32_t* q, int32_t* out, int R, int B,
                      int blocks, int warps, int smem, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (R < 0 || B < 1 || blocks < 1 || (long long)blocks * warps * Cp::PER_WARP < B)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = coop_prepare(coop_chain_kernel<Cp>, coop_horner_smem_bytes<Cp, 1>(warps), warps, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  err = fold_load_consts(consts, Cv::NCONST, st);
  if (err != cudaSuccess) return static_cast<int>(err);
  coop_chain_kernel<Cp><<<blocks, warps * 32, smem, st>>>(p, q, out, R, B);
  return static_cast<int>(cudaGetLastError());
}
