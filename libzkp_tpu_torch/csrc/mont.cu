// mont_mul: the 12-bit Montgomery product of ops/limb.py LimbContext, the
// one product of the Groth16 h pipeline (its NTT butterflies, coset shifts
// and pointwise products) and of the MiMC batch, both over BN254 Fr.
//
// Replaces scripts/bench_pallas_mul.py main.pallas_mul (the Pallas kernel of
// LimbContext.mont_mul, libzkp_tpu/ops/limb.py:156-199) and the jnp product
// every device program of the JAX package's h pipeline, NTT and MiMC ran.
//
// Layout: rows of N int32 limbs, (M, N) row-major, the layout of the torch
// pipeline around it (the TPU probe ran (N, 2^20) limbs-major). Operand b has
// Mb rows and broadcasts over a's leading axes: row i of a meets row i % Mb of
// b, so the twiddles (n/len, half, N), the coset powers (n, N) and a single
// row (Z^-1, R^2, the integer 1, R mod p) are read as they are, never
// expanded. One thread per row holds the 2N columns in registers.
//
// Bound: bytes at the path's shapes (2 * 88 bytes read and 88 written per
// product against about 1000 int32 multiply-adds). Each thread reads its own
// 88-byte row, so a warp's loads are strided by a row and served through L1;
// coalesced loads (limbs-major, or staged through shared memory) are left to
// the redesign.

#include "mont.cuh"

namespace {

constexpr int THREADS = 128;

template <int N>
__global__ void __launch_bounds__(THREADS)
mont_mul_kernel(const int32_t* __restrict__ a, const int32_t* __restrict__ b,
                int32_t* __restrict__ out, long long M, long long Mb) {
  const long long row = (long long)blockIdx.x * THREADS + threadIdx.x;
  if (row >= M) return;
  const int32_t* pa = a + row * N;
  const int32_t* pb = b + (row % Mb) * N;
  int32_t x[N], y[N];
#pragma unroll
  for (int i = 0; i < N; ++i) {
    x[i] = pa[i];
    y[i] = __ldg(pb + i);
  }
  mont_mul<N>(x, x, y);
  int32_t* po = out + row * N;
#pragma unroll
  for (int i = 0; i < N; ++i) po[i] = x[i];
}

template <int N>
int launch(const int32_t* consts, const int32_t* a, const int32_t* b, int32_t* out, long long M,
           long long Mb, cudaStream_t st) {
  cudaError_t err = mont_load_consts(consts, 3, N, st);
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long blocks = (M + THREADS - 1) / THREADS;
  mont_mul_kernel<N><<<(unsigned)blocks, THREADS, 0, st>>>(a, b, out, M, Mb);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// consts: (3, n) int32 (p, R mod p, ninv); a, out: (M, n) int32; b: (Mb, n)
// int32 with M % Mb == 0. Instantiated at n = 22 (BN254 Fr, 2^255 - 19).
// Returns the CUDA error of the launch (0 on success).
extern "C" int mont_mul_launch(const int32_t* consts, const int32_t* a, const int32_t* b,
                               int32_t* out, int n, long long M, long long Mb, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (M <= 0) return 0;
  switch (n) {
    case 22: return launch<22>(consts, a, b, out, M, Mb, st);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
