// blake3: the BLAKE3 compression function, one lane a thread, for the
// device BLAKE3 tier (ops/blake3_device.py): the leaf digests of byte rows
// of at most 64 bytes, every level of a Merkle tree over them, and the leaf
// commit of the STARK batch (ops/stark_device.py lde_commit_device).
//
// Replaces no Pallas kernel: the JAX package runs the same compression as a
// jnp program under jax.jit (libzkp_tpu/ops/blake3_device.py _leaves_run,
// its _compress_vec). In eager torch that program is about 450 device
// operations a compression (ops/blake3_device.py compress_vec, the plain
// version), so a tree of 2^14 leaves took 15 such passes; here it is one
// launch for the leaves and one a level.
//
// Each lane computes compress(IV, m, counter 0, block_len, flags) and keeps
// the first 8 words of the state, each the xor of its two halves: the
// standalone one-block hash of the device tier (flags CHUNK_START |
// CHUNK_END | ROOT), where block_len is the message's bytes (a leaf row's
// length, 64 for a level's pair of digests). block_len and flags are the
// same for every lane of a launch.
//
// Layout: the words of compress_vec, int64 in [0, 2^32): m (L, 16) in, out
// (L, 8) out, so the kernel and its plain version compare word for word. A
// level reads the previous level's (2w, 8) output as (w, 16): digest 2i and
// 2i + 1 side by side are the 64-byte block of parent i.
//
// Bound: one compression is 7 rounds of 8 G steps of 14 add, xor and
// rotate operations, and 8 output xors: 792 int32 operations a lane, against
// 192 bytes of int64 words (128 in, 64 out). At the improvement batch's 2^14
// leaves that is 1.3 * 10^7 operations (under a microsecond at the card's
// int32 rate) and 3.1 MB (about one microsecond at 3.35 TB/s), so a launch
// costs its launch. Design: the 16 state words and the 16 message words sit
// in registers (every index below is a constant once the rounds unroll),
// rotations are __funnelshift_r, the message permutation between rounds is
// a renaming of registers, and each thread reads its row as 8-byte words
// (a warp's first load brings its 32 rows into L1, the other 15 hit it).

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int THREADS = 256;  // lanes (threads) a block: the launch bounds

__device__ __forceinline__ uint32_t rotr(uint32_t x, int n) { return __funnelshift_r(x, x, n); }

__device__ __forceinline__ void g(uint32_t& a, uint32_t& b, uint32_t& c, uint32_t& d, uint32_t mx,
                                  uint32_t my) {
  a = a + b + mx;
  d = rotr(d ^ a, 16);
  c = c + d;
  b = rotr(b ^ c, 12);
  a = a + b + my;
  d = rotr(d ^ a, 8);
  c = c + d;
  b = rotr(b ^ c, 7);
}

// BLAKE3's message permutation (2, 6, 3, 10, 7, 0, 4, 13, 1, 11, 12, 5, 9,
// 14, 15, 8): word i of the next round is word PERM[i] of this one.
__device__ __forceinline__ void permute(uint32_t (&m)[16]) {
  const uint32_t t[16] = {m[2], m[6], m[3], m[10], m[7], m[0], m[4], m[13],
                          m[1], m[11], m[12], m[5], m[9], m[14], m[15], m[8]};
#pragma unroll
  for (int i = 0; i < 16; ++i) m[i] = t[i];
}

__global__ void __launch_bounds__(THREADS)
blake3_kernel(const long long* __restrict__ msg, long long* __restrict__ out, long long L, uint32_t block_len,
              uint32_t flags) {
  const long long lane = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (lane >= L) return;
  uint32_t m[16];
  const long long* row = msg + lane * 16;
#pragma unroll
  for (int i = 0; i < 16; ++i) m[i] = (uint32_t)__ldg(row + i);
  uint32_t s[16] = {0x6A09E667u, 0xBB67AE85u, 0x3C6EF372u, 0xA54FF53Au,  // chaining value: the IV
                    0x510E527Fu, 0x9B05688Cu, 0x1F83D9ABu, 0x5BE0CD19u,
                    0x6A09E667u, 0xBB67AE85u, 0x3C6EF372u, 0xA54FF53Au,  // IV[0..3]
                    0u,          0u,          block_len,   flags};       // counter 0, block_len, flags
#pragma unroll
  for (int r = 0; r < 7; ++r) {
    g(s[0], s[4], s[8], s[12], m[0], m[1]);
    g(s[1], s[5], s[9], s[13], m[2], m[3]);
    g(s[2], s[6], s[10], s[14], m[4], m[5]);
    g(s[3], s[7], s[11], s[15], m[6], m[7]);
    g(s[0], s[5], s[10], s[15], m[8], m[9]);
    g(s[1], s[6], s[11], s[12], m[10], m[11]);
    g(s[2], s[7], s[8], s[13], m[12], m[13]);
    g(s[3], s[4], s[9], s[14], m[14], m[15]);
    if (r < 6) permute(m);
  }
  long long* o = out + lane * 8;
#pragma unroll
  for (int i = 0; i < 8; ++i) o[i] = (long long)(s[i] ^ s[i + 8]);
}

}  // namespace

// msg: (L, 16) int64 message words in [0, 2^32); out: (L, 8) int64 output
// chaining values; block_len: the message's bytes, 0 to 64; flags: the
// compression's flags. Returns the CUDA error of the launch (0 on success).
extern "C" int blake3_launch(const long long* msg, long long* out, long long L, int block_len, int flags,
                             void* stream) {
  if (L <= 0) return 0;
  if (block_len < 0 || block_len > 64 || flags < 0) return static_cast<int>(cudaErrorInvalidValue);
  const long long blocks = (L + THREADS - 1) / THREADS;
  blake3_kernel<<<(unsigned)blocks, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      msg, out, L, (uint32_t)block_len, (uint32_t)flags);
  return static_cast<int>(cudaGetLastError());
}
