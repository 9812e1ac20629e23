// mont_mul: the 12-bit Montgomery product of ops/limb.py LimbContext, the
// one product of the Groth16 h pipeline (its NTT butterflies, coset shifts
// and pointwise products) and of the MiMC batch, both over BN254 Fr
// (instance mont_mul, N = 22), and of the STARK batch's coset LDE over f128
// (instance mont_mul_n11, N = 11: its two NTTs, the coset shift and the
// Montgomery conversions).
//
// Replaces scripts/bench_pallas_mul.py main.pallas_mul (the Pallas kernel of
// LimbContext.mont_mul, libzkp_tpu/ops/limb.py:156-199) and the jnp product
// every device program of the JAX package's h pipeline, NTT, MiMC and STARK
// LDE (ops/stark_device.py) ran.
//
// Layout: rows of N int32 limbs, (M, N) row-major, the layout of the torch
// pipeline around it (the TPU probe ran (N, 2^20) limbs-major). Operand b has
// Mb rows and broadcasts over a's leading axes: row i of a meets row i % Mb of
// b, so the twiddles (n/len, half, N), the coset powers (n, N) and a single
// row (Z^-1, R^2, the integer 1, R mod p) are read as they are, never
// expanded.
//
// Bound: operations at an NTT stage of the h (990 int32 multiply-adds a
// row, 11.6 us at 196,608 rows), bytes close behind (88 bytes of a read and
// 88 written a row, 10.3 us); at the MiMC batch's 4096 rows, bytes. At
// N = 11 a row is 253 multiply-adds and 88 bytes: a stage of a 256-proof
// STARK batch (8192 rows) is about 2 * 10^6 multiply-adds and 0.7 MB, a few
// microseconds of either, so that instance is bound by its launch.
//
// Design: one thread a row holds the 2N columns in registers (mont.cuh
// mont_mul, the same integer operations as before, so the same limbs), and
// a block of R rows (R threads: 128 from the wrapper, ops/kernels.py
// MONT_ROWS, the fastest of 32 to 256 at the path's shapes) stages its rows
// through shared memory, so every global load and store is coalesced:
// * the block's R * N words of a are copied to shared memory, consecutive
//   threads on consecutive words (16-byte words where the addresses allow);
// * b likewise: all Mb rows when Mb <= R (a one-row operand, read once a
//   block), else the block's run of R rows from row r0 % Mb, which wraps to
//   row 0 at most once (a stage's 256 twiddles: two runs of 128; Mb = M,
//   the pointwise products, never wraps);
// * the consts block (p, R mod p, ninv) is copied to shared memory too, so
//   a launch is one device operation (the first version copied it into
//   __constant__ memory before every launch, a second operation);
// * thread t reads its row as 8-byte words when N is even: rows are 88 bytes
//   apart at N = 22, and the 16 rows of a half warp, 22 words apart, start
//   on 16 distinct even banks, so the reads are free of bank conflicts with
//   no padding. An odd N's rows (44 bytes at N = 11) are not 8-byte aligned
//   on odd rows, so they are read as 4-byte words: the 32 rows of a warp,
//   11 words apart (an odd stride), start on 32 distinct banks, free of
//   conflicts too;
// * the product overwrites the thread's row of a, and the block stores its
//   rows as it loaded them.
// The first version read each row straight from global memory, one 4-byte
// word at a time a thread: a warp's load touched 32 rows 88 bytes apart,
// about 22 cache lines, where a coalesced load touches one.

#include "mont.cuh"

namespace {

constexpr int MAX_ROWS = 256;  // rows (threads) a block: the launch bounds

// Copy `words` int32 from src to dst, consecutive threads of the block on
// consecutive words: 16 bytes a thread where both addresses are 16-byte
// aligned, 4 bytes otherwise. Every thread of the block calls it.
__device__ __forceinline__ void copy_words(int32_t* __restrict__ dst, const int32_t* __restrict__ src,
                                           int words) {
  int w = threadIdx.x;
  if (((reinterpret_cast<uintptr_t>(dst) | reinterpret_cast<uintptr_t>(src)) & 15) == 0) {
    const int quads = words >> 2;
    for (; w < quads; w += blockDim.x)
      reinterpret_cast<int4*>(dst)[w] = reinterpret_cast<const int4*>(src)[w];
    w = (quads << 2) + threadIdx.x;
  }
  for (; w < words; w += blockDim.x) dst[w] = src[w];
}

// Block b multiplies rows b * R .. b * R + R - 1 of a (R = blockDim.x);
// dynamic shared memory (2 * R + 3) * N int32: a's rows (then the products),
// b's rows, the consts.
template <int N>
__global__ void __launch_bounds__(MAX_ROWS)
mont_mul_kernel(const int32_t* __restrict__ consts, const int32_t* __restrict__ a,
                const int32_t* __restrict__ b, int32_t* __restrict__ out, long long M, long long Mb) {
  extern __shared__ int4 mont_smem[];
  const int R = blockDim.x, t = threadIdx.x;
  int32_t* sa = reinterpret_cast<int32_t*>(mont_smem);
  int32_t* sb = sa + R * N;
  int32_t* sc = sb + R * N;
  const long long r0 = (long long)blockIdx.x * R;
  const int rows = (int)min((long long)R, M - r0);
  copy_words(sa, a + r0 * N, rows * N);
  int brow = t;  // this thread's row of b in sb
  if (Mb <= R) {
    copy_words(sb, b, (int)Mb * N);
    brow = (int)((r0 + t) % Mb);
  } else {
    const long long s = r0 % Mb;
    const int run = (int)min((long long)rows, Mb - s);
    copy_words(sb, b + s * N, run * N);
    copy_words(sb + run * N, b, (rows - run) * N);
  }
  for (int w = t; w < 3 * N; w += R) sc[w] = consts[w];
  __syncthreads();
  if (t < rows) {
    int32_t x[N], y[N];
    if constexpr (N % 2 == 0) {  // 8-byte words
      const int2* ra = reinterpret_cast<const int2*>(sa + t * N);
      const int2* rb = reinterpret_cast<const int2*>(sb + brow * N);
#pragma unroll
      for (int k = 0; k < N / 2; ++k) {
        const int2 u = ra[k], v = rb[k];
        x[2 * k] = u.x;
        x[2 * k + 1] = u.y;
        y[2 * k] = v.x;
        y[2 * k + 1] = v.y;
      }
    } else {  // 4-byte words: an odd N's rows are 4-byte aligned only
#pragma unroll
      for (int k = 0; k < N; ++k) {
        x[k] = sa[t * N + k];
        y[k] = sb[brow * N + k];
      }
    }
    mont_mul<N>(x, x, y, MontShared<N>{sc});
    if constexpr (N % 2 == 0) {
      int2* wa = reinterpret_cast<int2*>(sa + t * N);
#pragma unroll
      for (int k = 0; k < N / 2; ++k) wa[k] = make_int2(x[2 * k], x[2 * k + 1]);
    } else {
#pragma unroll
      for (int k = 0; k < N; ++k) sa[t * N + k] = x[k];
    }
  }
  __syncthreads();
  copy_words(out + r0 * N, sa, rows * N);
}

template <int N>
int launch(const int32_t* consts, const int32_t* a, const int32_t* b, int32_t* out, int n, long long M,
           long long Mb, int R, cudaStream_t st) {
  if (M <= 0) return 0;
  if (n != N || Mb < 1 || M % Mb != 0 || R < 1 || R > MAX_ROWS)
    return static_cast<int>(cudaErrorInvalidValue);
  const long long blocks = (M + R - 1) / R;
  const size_t smem = sizeof(int32_t) * (2 * R + 3) * N;
  mont_mul_kernel<N><<<(unsigned)blocks, R, smem, st>>>(consts, a, b, out, M, Mb);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// consts: (3, n) int32 (p, R mod p, ninv); a, out: (M, n) int32; b: (Mb, n)
// int32 with M % Mb == 0; rows: rows (threads) a block, 1 to 256. One entry
// per instance: mont_mul at n = 22 (BN254 Fr, 2^255 - 19), mont_mul_n11 at
// n = 11 (f128); another n is refused. Returns the CUDA error of the launch
// (0 on success).
extern "C" int mont_mul_launch(const int32_t* consts, const int32_t* a, const int32_t* b,
                               int32_t* out, int n, long long M, long long Mb, int rows,
                               void* stream) {
  return launch<22>(consts, a, b, out, n, M, Mb, rows, static_cast<cudaStream_t>(stream));
}

extern "C" int mont_mul_n11_launch(const int32_t* consts, const int32_t* a, const int32_t* b,
                                   int32_t* out, int n, long long M, long long Mb, int rows,
                                   void* stream) {
  return launch<11>(consts, a, b, out, n, M, Mb, rows, static_cast<cudaStream_t>(stream));
}
