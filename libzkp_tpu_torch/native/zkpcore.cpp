// zkpcore: host-side native kernels for libzkp_tpu.
//
// The TPU (jax/XLA/pallas) tier owns batched throughput; this C++ tier owns
// single-proof host latency for the transcript/commitment/curve ops that the
// reference delegates to Rust crates (blake3 via winterfell, keccak via
// merlin/STROBE, curve25519-dalek group ops — see SURVEY.md §2.2).
//
// C ABI only; loaded from Python with ctypes (no pybind11 in the image).
//
// Build: g++ -O3 -std=c++17 -shared -fPIC -o _zkpcore.so zkpcore.cpp

#include <algorithm>
#include <array>
#include <atomic>
#include <chrono>
#include <cstdint>
#include <cstdlib>
#include <deque>
#include <cstring>
#include <cstdio>
#include <map>
#include <memory>
#include <mutex>
#include <vector>
#if defined(__linux__)
#include <sys/mman.h>
#endif

#ifdef _OPENMP
#include <omp.h>
#endif

#if defined(__AVX512IFMA__) && defined(__AVX512F__)
#include <immintrin.h>  // 8-lane IFMA field tier (see fe8 below)
#endif

extern "C" {

// ===========================================================================
// BLAKE3-256 (public spec: IV, 7 rounds, message permutation, chunk tree)
// ===========================================================================

static const uint32_t B3_IV[8] = {
    0x6A09E667u, 0xBB67AE85u, 0x3C6EF372u, 0xA54FF53Au,
    0x510E527Fu, 0x9B05688Cu, 0x1F83D9ABu, 0x5BE0CD19u,
};
static const uint8_t B3_PERM[16] = {2, 6, 3, 10, 7, 0, 4, 13, 1, 11, 12, 5, 9, 14, 15, 8};

enum { B3_CHUNK_START = 1, B3_CHUNK_END = 2, B3_PARENT = 4, B3_ROOT = 8 };

static inline uint32_t rotr32(uint32_t x, int n) { return (x >> n) | (x << (32 - n)); }

static inline void b3_g(uint32_t* s, int a, int b, int c, int d, uint32_t mx, uint32_t my) {
    s[a] = s[a] + s[b] + mx;
    s[d] = rotr32(s[d] ^ s[a], 16);
    s[c] = s[c] + s[d];
    s[b] = rotr32(s[b] ^ s[c], 12);
    s[a] = s[a] + s[b] + my;
    s[d] = rotr32(s[d] ^ s[a], 8);
    s[c] = s[c] + s[d];
    s[b] = rotr32(s[b] ^ s[c], 7);
}

// Compress: writes the 8-word output (lo half of the 16-word state xor fold).
static void b3_compress(const uint32_t cv[8], const uint32_t block[16], uint64_t counter,
                        uint32_t block_len, uint32_t flags, uint32_t out[8]) {
    uint32_t s[16] = {
        cv[0], cv[1], cv[2], cv[3], cv[4], cv[5], cv[6], cv[7],
        B3_IV[0], B3_IV[1], B3_IV[2], B3_IV[3],
        (uint32_t)counter, (uint32_t)(counter >> 32), block_len, flags,
    };
    uint32_t m[16], t[16];
    std::memcpy(m, block, sizeof(m));
    for (int r = 0; r < 7; r++) {
        b3_g(s, 0, 4, 8, 12, m[0], m[1]);
        b3_g(s, 1, 5, 9, 13, m[2], m[3]);
        b3_g(s, 2, 6, 10, 14, m[4], m[5]);
        b3_g(s, 3, 7, 11, 15, m[6], m[7]);
        b3_g(s, 0, 5, 10, 15, m[8], m[9]);
        b3_g(s, 1, 6, 11, 12, m[10], m[11]);
        b3_g(s, 2, 7, 8, 13, m[12], m[13]);
        b3_g(s, 3, 4, 9, 14, m[14], m[15]);
        if (r < 6) {
            for (int i = 0; i < 16; i++) t[i] = m[B3_PERM[i]];
            std::memcpy(m, t, sizeof(m));
        }
    }
    for (int i = 0; i < 8; i++) out[i] = s[i] ^ s[i + 8];
}

static void b3_load_block(const uint8_t* data, uint64_t len, uint32_t block[16]) {
    uint8_t buf[64];
    std::memset(buf, 0, 64);
    std::memcpy(buf, data, len);
    for (int i = 0; i < 16; i++) {
        block[i] = (uint32_t)buf[4 * i] | ((uint32_t)buf[4 * i + 1] << 8) |
                   ((uint32_t)buf[4 * i + 2] << 16) | ((uint32_t)buf[4 * i + 3] << 24);
    }
}

// Chaining value of one <=1024-byte chunk.
static void b3_chunk_cv(const uint8_t* data, uint64_t len, uint64_t counter, bool root,
                        uint32_t cv_out[8]) {
    uint32_t cv[8];
    std::memcpy(cv, B3_IV, sizeof(cv));
    uint64_t nblocks = len ? (len + 63) / 64 : 1;
    for (uint64_t i = 0; i < nblocks; i++) {
        uint64_t off = i * 64;
        uint32_t blen = (uint32_t)(i == nblocks - 1 ? len - off : 64);
        uint32_t flags = 0;
        if (i == 0) flags |= B3_CHUNK_START;
        if (i == nblocks - 1) {
            flags |= B3_CHUNK_END;
            if (root) flags |= B3_ROOT;
        }
        uint32_t block[16];
        b3_load_block(data + off, blen, block);
        uint32_t out[8];
        b3_compress(cv, block, counter, blen, flags, out);
        std::memcpy(cv, out, sizeof(out));
    }
    std::memcpy(cv_out, cv, 32);
}

static void b3_parent(const uint32_t l[8], const uint32_t r[8], bool root, uint32_t out[8]) {
    uint32_t block[16];
    std::memcpy(block, l, 32);
    std::memcpy(block + 8, r, 32);
    b3_compress(B3_IV, block, 0, 64, B3_PARENT | (root ? B3_ROOT : 0), out);
}

// Tree merge: left subtree = largest power of two strictly below the count.
static void b3_merge(const uint32_t* cvs, uint64_t n, bool root, uint32_t out[8]) {
    if (n == 1) {
        std::memcpy(out, cvs, 32);
        return;
    }
    uint64_t split = 1;
    while (split * 2 < n) split *= 2;
    uint32_t l[8], r[8];
    b3_merge(cvs, split, false, l);
    b3_merge(cvs + 8 * split, n - split, false, r);
    b3_parent(l, r, root, out);
}

void zkp_blake3(const uint8_t* data, uint64_t len, uint8_t out[32]) {
    uint64_t n_chunks = len ? (len + 1023) / 1024 : 1;
    uint32_t cv[8];
    if (n_chunks == 1) {
        b3_chunk_cv(data, len, 0, true, cv);
    } else {
        std::vector<uint32_t> cvs(8 * n_chunks);
        for (uint64_t i = 0; i < n_chunks; i++) {
            uint64_t off = i * 1024;
            uint64_t clen = (i == n_chunks - 1) ? len - off : 1024;
            b3_chunk_cv(data + off, clen, i, false, cvs.data() + 8 * i);
        }
        b3_merge(cvs.data(), n_chunks, true, cv);
    }
    std::memcpy(out, cv, 32);
}

// n equal-length items, concatenated; out = n * 32 bytes.
void zkp_blake3_batch(const uint8_t* data, uint64_t n, uint64_t item_len, uint8_t* out) {
    for (uint64_t i = 0; i < n; i++) zkp_blake3(data + i * item_len, item_len, out + i * 32);
}

// One Merkle level: n_out parent digests from 2*n_out child digests.
void zkp_blake3_merge_level(const uint8_t* children, uint64_t n_out, uint8_t* out) {
    for (uint64_t i = 0; i < n_out; i++) zkp_blake3(children + i * 64, 64, out + i * 32);
}

// Full Merkle tree over n (power-of-two) 32-byte leaves.
// out receives all levels above the leaves, bottom-up: n/2 + n/4 + ... + 1 digests.
void zkp_blake3_merkle(const uint8_t* leaves, uint64_t n, uint8_t* out) {
    const uint8_t* cur = leaves;
    uint64_t level = n / 2;
    while (level >= 1) {
        zkp_blake3_merge_level(cur, level, out);
        cur = out;
        out += level * 32;
        if (level == 1) break;
        level /= 2;
    }
}

// ===========================================================================
// Keccak-f[1600] (24 rounds) — STROBE-128 / merlin transcript permutation
// ===========================================================================

static const uint64_t KECCAK_RC[24] = {
    0x0000000000000001ULL, 0x0000000000008082ULL, 0x800000000000808aULL,
    0x8000000080008000ULL, 0x000000000000808bULL, 0x0000000080000001ULL,
    0x8000000080008081ULL, 0x8000000000008009ULL, 0x000000000000008aULL,
    0x0000000000000088ULL, 0x0000000080008009ULL, 0x000000008000000aULL,
    0x000000008000808bULL, 0x800000000000008bULL, 0x8000000000008089ULL,
    0x8000000000008003ULL, 0x8000000000008002ULL, 0x8000000000000080ULL,
    0x000000000000800aULL, 0x800000008000000aULL, 0x8000000080008081ULL,
    0x8000000000008080ULL, 0x0000000080000001ULL, 0x8000000080008008ULL,
};
static const int KECCAK_ROT[24] = {1,  3,  6,  10, 15, 21, 28, 36, 45, 55, 2,  14,
                                   27, 41, 56, 8,  25, 43, 62, 18, 39, 61, 20, 44};
static const int KECCAK_PI[24] = {10, 7,  11, 17, 18, 3, 5,  16, 8,  21, 24, 4,
                                  15, 23, 19, 13, 12, 2, 20, 14, 22, 9,  6,  1};

static inline uint64_t rotl64(uint64_t x, int n) { return (x << n) | (x >> (64 - n)); }

void zkp_keccak_f1600(uint64_t* a) {
    uint64_t b[5], t, d;
    for (int round = 0; round < 24; round++) {
        // theta
        for (int i = 0; i < 5; i++) b[i] = a[i] ^ a[i + 5] ^ a[i + 10] ^ a[i + 15] ^ a[i + 20];
        for (int i = 0; i < 5; i++) {
            d = b[(i + 4) % 5] ^ rotl64(b[(i + 1) % 5], 1);
            for (int j = 0; j < 25; j += 5) a[j + i] ^= d;
        }
        // rho + pi
        t = a[1];
        for (int i = 0; i < 24; i++) {
            int j = KECCAK_PI[i];
            d = a[j];
            a[j] = rotl64(t, KECCAK_ROT[i]);
            t = d;
        }
        // chi
        for (int j = 0; j < 25; j += 5) {
            uint64_t row[5];
            for (int i = 0; i < 5; i++) row[i] = a[j + i];
            for (int i = 0; i < 5; i++) a[j + i] = row[i] ^ ((~row[(i + 1) % 5]) & row[(i + 2) % 5]);
        }
        // iota
        a[0] ^= KECCAK_RC[round];
    }
}

// ===========================================================================
// Curve25519 field: 5 x 51-bit limbs, mul via unsigned __int128
// ===========================================================================

typedef unsigned __int128 u128;
struct fe {
    uint64_t v[5];
};

static const uint64_t MASK51 = 0x7FFFFFFFFFFFFULL;

static inline fe fe_zero() { return fe{{0, 0, 0, 0, 0}}; }
static inline fe fe_one() { return fe{{1, 0, 0, 0, 0}}; }

static inline fe fe_add(const fe& a, const fe& b) {
    fe r;
    for (int i = 0; i < 5; i++) r.v[i] = a.v[i] + b.v[i];
    return r;
}

// a - b with bias 2*p to keep limbs positive (inputs must be weakly reduced).
static inline fe fe_sub(const fe& a, const fe& b) {
    fe r;
    r.v[0] = a.v[0] + 0xFFFFFFFFFFFDAULL - b.v[0];
    r.v[1] = a.v[1] + 0xFFFFFFFFFFFFEULL - b.v[1];
    r.v[2] = a.v[2] + 0xFFFFFFFFFFFFEULL - b.v[2];
    r.v[3] = a.v[3] + 0xFFFFFFFFFFFFEULL - b.v[3];
    r.v[4] = a.v[4] + 0xFFFFFFFFFFFFEULL - b.v[4];
    // carry to keep limbs in range
    uint64_t c;
    c = r.v[0] >> 51; r.v[0] &= MASK51; r.v[1] += c;
    c = r.v[1] >> 51; r.v[1] &= MASK51; r.v[2] += c;
    c = r.v[2] >> 51; r.v[2] &= MASK51; r.v[3] += c;
    c = r.v[3] >> 51; r.v[3] &= MASK51; r.v[4] += c;
    c = r.v[4] >> 51; r.v[4] &= MASK51; r.v[0] += c * 19;
    return r;
}

static inline fe fe_mul(const fe& f, const fe& g) {
    u128 r0, r1, r2, r3, r4;
    uint64_t f0 = f.v[0], f1 = f.v[1], f2 = f.v[2], f3 = f.v[3], f4 = f.v[4];
    uint64_t g0 = g.v[0], g1 = g.v[1], g2 = g.v[2], g3 = g.v[3], g4 = g.v[4];
    uint64_t g1_19 = g1 * 19, g2_19 = g2 * 19, g3_19 = g3 * 19, g4_19 = g4 * 19;
    r0 = (u128)f0 * g0 + (u128)f1 * g4_19 + (u128)f2 * g3_19 + (u128)f3 * g2_19 + (u128)f4 * g1_19;
    r1 = (u128)f0 * g1 + (u128)f1 * g0 + (u128)f2 * g4_19 + (u128)f3 * g3_19 + (u128)f4 * g2_19;
    r2 = (u128)f0 * g2 + (u128)f1 * g1 + (u128)f2 * g0 + (u128)f3 * g4_19 + (u128)f4 * g3_19;
    r3 = (u128)f0 * g3 + (u128)f1 * g2 + (u128)f2 * g1 + (u128)f3 * g0 + (u128)f4 * g4_19;
    r4 = (u128)f0 * g4 + (u128)f1 * g3 + (u128)f2 * g2 + (u128)f3 * g1 + (u128)f4 * g0;
    fe out;
    uint64_t c;
    c = (uint64_t)(r0 >> 51); out.v[0] = (uint64_t)r0 & MASK51; r1 += c;
    c = (uint64_t)(r1 >> 51); out.v[1] = (uint64_t)r1 & MASK51; r2 += c;
    c = (uint64_t)(r2 >> 51); out.v[2] = (uint64_t)r2 & MASK51; r3 += c;
    c = (uint64_t)(r3 >> 51); out.v[3] = (uint64_t)r3 & MASK51; r4 += c;
    c = (uint64_t)(r4 >> 51); out.v[4] = (uint64_t)r4 & MASK51;
    out.v[0] += c * 19;
    c = out.v[0] >> 51; out.v[0] &= MASK51; out.v[1] += c;
    return out;
}

// Dedicated squaring: 15 wide products instead of 25 (ref10 layout).
static inline fe fe_sq(const fe& f) {
    uint64_t f0 = f.v[0], f1 = f.v[1], f2 = f.v[2], f3 = f.v[3], f4 = f.v[4];
    uint64_t f0_2 = f0 * 2, f1_2 = f1 * 2, f2_2 = f2 * 2, f3_2 = f3 * 2;
    uint64_t f3_19 = f3 * 19, f4_19 = f4 * 19;
    u128 r0 = (u128)f0 * f0 + (u128)f1_2 * f4_19 + (u128)f2_2 * f3_19;
    u128 r1 = (u128)f0_2 * f1 + (u128)f2_2 * f4_19 + (u128)f3 * f3_19;
    u128 r2 = (u128)f0_2 * f2 + (u128)f1 * f1 + (u128)f3_2 * f4_19;
    u128 r3 = (u128)f0_2 * f3 + (u128)f1_2 * f2 + (u128)f4 * f4_19;
    u128 r4 = (u128)f0_2 * f4 + (u128)f1_2 * f3 + (u128)f2 * f2;
    fe out;
    uint64_t c;
    c = (uint64_t)(r0 >> 51); out.v[0] = (uint64_t)r0 & MASK51; r1 += c;
    c = (uint64_t)(r1 >> 51); out.v[1] = (uint64_t)r1 & MASK51; r2 += c;
    c = (uint64_t)(r2 >> 51); out.v[2] = (uint64_t)r2 & MASK51; r3 += c;
    c = (uint64_t)(r3 >> 51); out.v[3] = (uint64_t)r3 & MASK51; r4 += c;
    c = (uint64_t)(r4 >> 51); out.v[4] = (uint64_t)r4 & MASK51;
    out.v[0] += c * 19;
    c = out.v[0] >> 51; out.v[0] &= MASK51; out.v[1] += c;
    return out;
}

static fe fe_frombytes(const uint8_t s[32]) {
    uint64_t w[4];
    std::memcpy(w, s, 32);
    fe r;
    r.v[0] = w[0] & MASK51;
    r.v[1] = ((w[0] >> 51) | (w[1] << 13)) & MASK51;
    r.v[2] = ((w[1] >> 38) | (w[2] << 26)) & MASK51;
    r.v[3] = ((w[2] >> 25) | (w[3] << 39)) & MASK51;
    r.v[4] = (w[3] >> 12) & MASK51;
    return r;
}

static void fe_tobytes(const fe& f, uint8_t s[32]) {
    fe t = f;
    // two carry passes then canonical reduction
    uint64_t c;
    for (int pass = 0; pass < 2; pass++) {
        c = t.v[0] >> 51; t.v[0] &= MASK51; t.v[1] += c;
        c = t.v[1] >> 51; t.v[1] &= MASK51; t.v[2] += c;
        c = t.v[2] >> 51; t.v[2] &= MASK51; t.v[3] += c;
        c = t.v[3] >> 51; t.v[3] &= MASK51; t.v[4] += c;
        c = t.v[4] >> 51; t.v[4] &= MASK51; t.v[0] += c * 19;
    }
    // canonical: add 19 and check overflow past 2^255
    uint64_t q = (t.v[0] + 19) >> 51;
    q = (t.v[1] + q) >> 51;
    q = (t.v[2] + q) >> 51;
    q = (t.v[3] + q) >> 51;
    q = (t.v[4] + q) >> 51;
    t.v[0] += 19 * q;
    c = t.v[0] >> 51; t.v[0] &= MASK51; t.v[1] += c;
    c = t.v[1] >> 51; t.v[1] &= MASK51; t.v[2] += c;
    c = t.v[2] >> 51; t.v[2] &= MASK51; t.v[3] += c;
    c = t.v[3] >> 51; t.v[3] &= MASK51; t.v[4] += c;
    t.v[4] &= MASK51;
    uint64_t w[4];
    w[0] = t.v[0] | (t.v[1] << 51);
    w[1] = (t.v[1] >> 13) | (t.v[2] << 38);
    w[2] = (t.v[2] >> 26) | (t.v[3] << 25);
    w[3] = (t.v[3] >> 39) | (t.v[4] << 12);
    std::memcpy(s, w, 32);
}

static inline bool fe_isnegative(const fe& f) {
    uint8_t s[32];
    fe_tobytes(f, s);
    return s[0] & 1;
}

static inline bool fe_iszero(const fe& f) {
    uint8_t s[32];
    fe_tobytes(f, s);
    for (int i = 0; i < 32; i++)
        if (s[i]) return false;
    return true;
}

static fe fe_neg(const fe& a) { return fe_sub(fe_zero(), a); }

// f^((p-5)/8) core: returns z^(2^252 - 3) via the ref10 addition chain.
static fe fe_pow22523(const fe& z) {
    fe t0, t1, t2;
    t0 = fe_sq(z);
    t1 = fe_sq(fe_sq(t0));
    t1 = fe_mul(z, t1);
    t0 = fe_mul(t0, t1);
    t0 = fe_sq(t0);
    t0 = fe_mul(t1, t0);
    t1 = fe_sq(t0);
    for (int i = 1; i < 5; i++) t1 = fe_sq(t1);
    t0 = fe_mul(t1, t0);
    t1 = fe_sq(t0);
    for (int i = 1; i < 10; i++) t1 = fe_sq(t1);
    t1 = fe_mul(t1, t0);
    t2 = fe_sq(t1);
    for (int i = 1; i < 20; i++) t2 = fe_sq(t2);
    t1 = fe_mul(t2, t1);
    t1 = fe_sq(t1);
    for (int i = 1; i < 10; i++) t1 = fe_sq(t1);
    t0 = fe_mul(t1, t0);
    t1 = fe_sq(t0);
    for (int i = 1; i < 50; i++) t1 = fe_sq(t1);
    t1 = fe_mul(t1, t0);
    t2 = fe_sq(t1);
    for (int i = 1; i < 100; i++) t2 = fe_sq(t2);
    t1 = fe_mul(t2, t1);
    t1 = fe_sq(t1);
    for (int i = 1; i < 50; i++) t1 = fe_sq(t1);
    t0 = fe_mul(t1, t0);
    t0 = fe_sq(t0);
    t0 = fe_sq(t0);
    return fe_mul(t0, z);
}

// z^(p-2) = z^(2^255 - 21): 2^250-1 chain from pow22523 pieces, then finish.
static fe fe_invert(const fe& z) {
    // p - 2 little-endian bytes
    static const uint8_t PM2[32] = {
        0xeb, 0xff, 0xff, 0xff, 0xff, 0xff, 0xff, 0xff, 0xff, 0xff, 0xff,
        0xff, 0xff, 0xff, 0xff, 0xff, 0xff, 0xff, 0xff, 0xff, 0xff, 0xff,
        0xff, 0xff, 0xff, 0xff, 0xff, 0xff, 0xff, 0xff, 0xff, 0x7f,
    };
    fe r = fe_one();
    bool started = false;
    for (int i = 31; i >= 0; i--) {
        for (int bit = 7; bit >= 0; bit--) {
            if (started) r = fe_sq(r);
            if ((PM2[i] >> bit) & 1) {
                if (started)
                    r = fe_mul(r, z);
                else {
                    r = z;
                    started = true;
                }
            }
        }
    }
    return r;
}

// sqrt(-1): 2^((p-1)/4), the even root (matches dalek / ed25519.py SQRT_M1).
static const uint8_t SQRT_M1_BYTES[32] = {
    0xb0, 0xa0, 0x0e, 0x4a, 0x27, 0x1b, 0xee, 0xc4, 0x78, 0xe4, 0x2f, 0xad, 0x06, 0x18, 0x43, 0x2f,
    0xa7, 0xd7, 0xfb, 0x3d, 0x99, 0x00, 0x4d, 0x2b, 0x0b, 0xdf, 0xc1, 0x4f, 0x80, 0x24, 0x83, 0x2b,
};

// RFC 9496 SQRT_RATIO_M1: (was_square, r) with r = sqrt(u/v) (or i*u/v), r even.
static bool fe_sqrt_ratio_m1(const fe& u, const fe& v, fe& r_out) {
    fe v3 = fe_mul(fe_sq(v), v);
    fe v7 = fe_mul(fe_sq(v3), v);
    fe r = fe_mul(fe_mul(u, v3), fe_pow22523(fe_mul(u, v7)));
    fe check = fe_mul(v, fe_sq(r));
    fe sqrt_m1 = fe_frombytes(SQRT_M1_BYTES);
    fe neg_u = fe_neg(u);
    bool correct = fe_iszero(fe_sub(check, u));
    bool flipped = fe_iszero(fe_sub(check, neg_u));
    bool flipped_i = fe_iszero(fe_sub(check, fe_mul(neg_u, sqrt_m1)));
    if (flipped || flipped_i) r = fe_mul(r, sqrt_m1);
    if (fe_isnegative(r)) r = fe_neg(r);
    r_out = r;
    return correct || flipped;
}

// ===========================================================================
// Edwards points, extended coordinates (X, Y, Z, T), a = -1
// ===========================================================================

struct ge {
    fe X, Y, Z, T;
};

// 2*d mod p
static const uint8_t TWO_D_BYTES[32] = {
    0x59, 0xf1, 0xb2, 0x26, 0x94, 0x9b, 0xd6, 0xeb, 0x56, 0xb1, 0x83, 0x82, 0x9a, 0x14, 0xe0, 0x00,
    0x30, 0xd1, 0xf3, 0xee, 0xf2, 0x80, 0x8e, 0x19, 0xe7, 0xfc, 0xdf, 0x56, 0xdc, 0xd9, 0x06, 0x24,
};
// d mod p
static const uint8_t D_BYTES[32] = {
    0xa3, 0x78, 0x59, 0x13, 0xca, 0x4d, 0xeb, 0x75, 0xab, 0xd8, 0x41, 0x41, 0x4d, 0x0a, 0x70, 0x00,
    0x98, 0xe8, 0x79, 0x77, 0x79, 0x40, 0xc7, 0x8c, 0x73, 0xfe, 0x6f, 0x2b, 0xee, 0x6c, 0x03, 0x52,
};
// 1/sqrt(a-d) with a=-1 (dalek INVSQRT_A_MINUS_D)
static const uint8_t INVSQRT_A_MINUS_D_BYTES[32] = {
    0xea, 0x40, 0x5d, 0x80, 0xaa, 0xfd, 0xc8, 0x99, 0xbe, 0x72, 0x41, 0x5a, 0x17, 0x16, 0x2f, 0x9d,
    0x40, 0xd8, 0x01, 0xfe, 0x91, 0x7b, 0xc2, 0x16, 0xa2, 0xfc, 0xaf, 0xcf, 0x05, 0x89, 0x6c, 0x78,
};

static ge ge_identity() { return ge{fe_zero(), fe_one(), fe_one(), fe_zero()}; }

// Unified add-2008-hwcd-3 for a=-1 (same formulas as ed25519.py point_add).
static ge ge_add(const ge& p, const ge& q) {
    fe two_d = fe_frombytes(TWO_D_BYTES);
    fe A = fe_mul(fe_sub(p.Y, p.X), fe_sub(q.Y, q.X));
    fe B = fe_mul(fe_add(p.Y, p.X), fe_add(q.Y, q.X));
    fe C = fe_mul(fe_mul(p.T, two_d), q.T);
    fe D = fe_add(fe_mul(p.Z, q.Z), fe_mul(p.Z, q.Z));
    fe E = fe_sub(B, A);
    fe F = fe_sub(D, C);
    fe G = fe_add(D, C);
    fe H = fe_add(B, A);
    return ge{fe_mul(E, F), fe_mul(G, H), fe_mul(F, G), fe_mul(E, H)};
}

static ge ge_double(const ge& p) {
    fe A = fe_sq(p.X);
    fe B = fe_sq(p.Y);
    fe C = fe_add(fe_sq(p.Z), fe_sq(p.Z));
    fe H = fe_add(A, B);
    fe E = fe_sub(H, fe_sq(fe_add(p.X, p.Y)));
    fe G = fe_sub(A, B);
    fe F = fe_add(C, G);
    return ge{fe_mul(E, F), fe_mul(G, H), fe_mul(F, G), fe_mul(E, H)};
}

static ge ge_neg(const ge& p) { return ge{fe_neg(p.X), p.Y, p.Z, fe_neg(p.T)}; }

// Wire format: X||Y||Z||T, each 32 bytes canonical LE.
static ge ge_from_wire(const uint8_t* b) {
    return ge{fe_frombytes(b), fe_frombytes(b + 32), fe_frombytes(b + 64), fe_frombytes(b + 96)};
}

static void ge_to_wire(const ge& p, uint8_t* b) {
    fe_tobytes(p.X, b);
    fe_tobytes(p.Y, b + 32);
    fe_tobytes(p.Z, b + 64);
    fe_tobytes(p.T, b + 96);
}

void zkp_ed_point_add(const uint8_t* a, const uint8_t* b, uint8_t* out) {
    ge r = ge_add(ge_from_wire(a), ge_from_wire(b));
    ge_to_wire(r, out);
}

void zkp_ed_point_double(const uint8_t* a, uint8_t* out) {
    ge_to_wire(ge_double(ge_from_wire(a)), out);
}

// scalar: 32 bytes LE, already reduced mod l by the caller.
void zkp_ed_scalar_mul(const uint8_t* scalar, const uint8_t* point, uint8_t* out) {
    ge p = ge_from_wire(point);
    // 4-bit fixed window
    ge table[16];
    table[0] = ge_identity();
    table[1] = p;
    for (int i = 2; i < 16; i++) table[i] = ge_add(table[i - 1], p);
    ge acc = ge_identity();
    bool started = false;
    for (int i = 31; i >= 0; i--) {
        for (int half = 1; half >= 0; half--) {
            int nib = half ? (scalar[i] >> 4) : (scalar[i] & 0xF);
            if (started) {
                acc = ge_double(ge_double(ge_double(ge_double(acc))));
            }
            if (nib) {
                acc = started ? ge_add(acc, table[nib]) : table[nib];
                started = true;
            } else if (started) {
                // nothing
            }
        }
    }
    if (!started) acc = ge_identity();
    ge_to_wire(acc, out);
}

// Pippenger MSM over the fixed-window-parallel shared engine (defined after
// the template section below).
static void ed_msm_native(uint64_t n, const uint8_t* scalars, const uint8_t* points,
                          uint8_t* out);

void zkp_ed_msm(uint64_t n, const uint8_t* scalars, const uint8_t* points, uint8_t* out) {
    ed_msm_native(n, scalars, points, out);
}

// Ristretto255 compress (RFC 9496 ENCODE). in: 128-byte wire point.
void zkp_ristretto_compress(const uint8_t* in, uint8_t* out) {
    ge p = ge_from_wire(in);
    fe u1 = fe_mul(fe_add(p.Z, p.Y), fe_sub(p.Z, p.Y));
    fe u2 = fe_mul(p.X, p.Y);
    fe invsqrt;
    fe_sqrt_ratio_m1(fe_one(), fe_mul(u1, fe_sq(u2)), invsqrt);
    fe den1 = fe_mul(invsqrt, u1);
    fe den2 = fe_mul(invsqrt, u2);
    fe z_inv = fe_mul(fe_mul(den1, den2), p.T);
    fe sqrt_m1 = fe_frombytes(SQRT_M1_BYTES);
    fe ix = fe_mul(p.X, sqrt_m1);
    fe iy = fe_mul(p.Y, sqrt_m1);
    fe enchanted = fe_mul(den1, fe_frombytes(INVSQRT_A_MINUS_D_BYTES));
    bool rotate = fe_isnegative(fe_mul(p.T, z_inv));
    fe x = p.X, y = p.Y, den_inv;
    if (rotate) {
        x = iy;
        y = ix;
        den_inv = enchanted;
    } else {
        den_inv = den2;
    }
    if (fe_isnegative(fe_mul(x, z_inv))) y = fe_neg(y);
    fe s = fe_mul(den_inv, fe_sub(p.Z, y));
    if (fe_isnegative(s)) s = fe_neg(s);
    fe_tobytes(s, out);
}

// Ristretto255 decompress (RFC 9496 DECODE). Returns 1 ok / 0 reject.
int zkp_ristretto_decompress(const uint8_t* in, uint8_t* out) {
    // canonical check: reject s >= p or negative (odd)
    uint8_t canon[32];
    fe s_fe = fe_frombytes(in);
    fe_tobytes(s_fe, canon);
    if (std::memcmp(canon, in, 32) != 0) return 0;
    if (in[0] & 1) return 0;
    if (in[31] & 0x80) return 0;  // frombytes masks bit 255; require it clear on the wire
    fe ss = fe_sq(s_fe);
    fe u1 = fe_sub(fe_one(), ss);
    fe u2 = fe_add(fe_one(), ss);
    fe u2_sqr = fe_sq(u2);
    fe d = fe_frombytes(D_BYTES);
    fe v = fe_sub(fe_neg(fe_mul(fe_mul(d, u1), u1)), u2_sqr);
    fe invsqrt;
    bool was_square = fe_sqrt_ratio_m1(fe_one(), fe_mul(v, u2_sqr), invsqrt);
    fe den_x = fe_mul(invsqrt, u2);
    fe den_y = fe_mul(fe_mul(invsqrt, den_x), v);
    fe x = fe_mul(fe_add(s_fe, s_fe), den_x);
    if (fe_isnegative(x)) x = fe_neg(x);
    fe y = fe_mul(u1, den_y);
    fe t = fe_mul(x, y);
    if (!was_square || fe_isnegative(t) || fe_iszero(y)) return 0;
    ge p{x, y, fe_one(), t};
    ge_to_wire(p, out);
    return 1;
}

}  // extern "C"

// ===========================================================================
// BN254 (alt_bn128): Montgomery Fq, tower Fq2/Fq6/Fq12, Jacobian G1/G2,
// Pippenger MSM, optimal-ate pairing.  Mirrors the Python golden model in
// ops/bn254.py (same formulas); all constants arrive at init time from
// Python so nothing is hand-transcribed.
// ===========================================================================

extern "C" {

struct u256 {
    uint64_t v[4];
};

static u256 BQ;            // modulus q
static uint64_t BQ_NINV;   // -q^{-1} mod 2^64
static u256 BQ_R2;         // R^2 mod q (R = 2^256)
static u256 BQ_MONT_ONE;   // R mod q
static uint8_t BQ_M2[32];  // q-2 little-endian (for inversion exponent)

static inline bool u256_is_zero(const u256& a) {
    return !(a.v[0] | a.v[1] | a.v[2] | a.v[3]);
}
static inline int u256_cmp(const u256& a, const u256& b) {
    for (int i = 3; i >= 0; i--) {
        if (a.v[i] < b.v[i]) return -1;
        if (a.v[i] > b.v[i]) return 1;
    }
    return 0;
}
static inline uint64_t u256_add(u256& r, const u256& a, const u256& b) {
    u128 c = 0;
    for (int i = 0; i < 4; i++) {
        c += (u128)a.v[i] + b.v[i];
        r.v[i] = (uint64_t)c;
        c >>= 64;
    }
    return (uint64_t)c;
}
static inline uint64_t u256_sub(u256& r, const u256& a, const u256& b) {
    u128 borrow = 0;
    for (int i = 0; i < 4; i++) {
        u128 d = (u128)a.v[i] - b.v[i] - borrow;
        r.v[i] = (uint64_t)d;
        borrow = (d >> 64) & 1;
    }
    return (uint64_t)borrow;
}

// Montgomery field element (value * R mod q), always < q.
struct bfq {
    u256 m;
};

static inline bfq bfq_add(const bfq& a, const bfq& b) {
    bfq r;
    uint64_t c = u256_add(r.m, a.m, b.m);
    if (c || u256_cmp(r.m, BQ) >= 0) u256_sub(r.m, r.m, BQ);
    return r;
}
static inline bfq bfq_sub(const bfq& a, const bfq& b) {
    bfq r;
    if (u256_sub(r.m, a.m, b.m)) u256_add(r.m, r.m, BQ);
    return r;
}
static inline bfq bfq_neg(const bfq& a) {
    bfq r;
    if (u256_is_zero(a.m)) return a;
    u256_sub(r.m, BQ, a.m);
    return r;
}

// CIOS Montgomery multiplication.
static bfq bfq_mul(const bfq& a, const bfq& b) {
    uint64_t t[6] = {0, 0, 0, 0, 0, 0};
    for (int i = 0; i < 4; i++) {
        u128 c = 0;
        for (int j = 0; j < 4; j++) {
            c += (u128)t[j] + (u128)a.m.v[i] * b.m.v[j];
            t[j] = (uint64_t)c;
            c >>= 64;
        }
        c += t[4];
        t[4] = (uint64_t)c;
        t[5] = (uint64_t)(c >> 64);
        uint64_t m = t[0] * BQ_NINV;
        c = (u128)t[0] + (u128)m * BQ.v[0];
        c >>= 64;
        for (int j = 1; j < 4; j++) {
            c += (u128)t[j] + (u128)m * BQ.v[j];
            t[j - 1] = (uint64_t)c;
            c >>= 64;
        }
        c += t[4];
        t[3] = (uint64_t)c;
        t[4] = t[5] + (uint64_t)(c >> 64);
    }
    bfq r;
    for (int i = 0; i < 4; i++) r.m.v[i] = t[i];
    if (t[4] || u256_cmp(r.m, BQ) >= 0) u256_sub(r.m, r.m, BQ);
    return r;
}

// Squaring: CIOS multiply beats a dedicated SOS squaring here — the SOS
// 9-word temp plus the doubling/carry fixup passes cost more than the 6
// wide products they save (measured 53 vs 42 ns on the target host).
static inline bfq bfq_sq(const bfq& a) { return bfq_mul(a, a); }

static bfq bfq_zero() { return bfq{{{0, 0, 0, 0}}}; }
static bfq bfq_one() { return bfq{BQ_MONT_ONE}; }
static inline bool bfq_is_zero(const bfq& a) { return u256_is_zero(a.m); }

static bfq bfq_frombytes(const uint8_t b[32]) {
    bfq r;
    std::memcpy(r.m.v, b, 32);
    bfq r2{BQ_R2};
    return bfq_mul(r, r2);
}
static void bfq_tobytes(const bfq& a, uint8_t b[32]) {
    bfq one_raw{{{1, 0, 0, 0}}};
    bfq red = bfq_mul(a, one_raw);
    std::memcpy(b, red.m.v, 32);
}

// pow by little-endian exponent bytes (square-and-multiply, MSB first).
static bfq bfq_pow_bytes(const bfq& a, const uint8_t* e, int elen) {
    bfq r = bfq_one();
    bool started = false;
    for (int i = elen - 1; i >= 0; i--) {
        for (int bit = 7; bit >= 0; bit--) {
            if (started) r = bfq_sq(r);
            if ((e[i] >> bit) & 1) {
                if (started)
                    r = bfq_mul(r, a);
                else {
                    r = a;
                    started = true;
                }
            }
        }
    }
    return r;
}

// Binary extended GCD inversion (~10x faster than Fermat pow).
// Works on the Montgomery representation r = aR: extgcd gives r^{-1},
// then two extra Montgomery muls by R^2 give a^{-1}R.
static inline bool u256_is_even(const u256& a) { return !(a.v[0] & 1); }
static inline void u256_shr1(u256& a) {
    a.v[0] = (a.v[0] >> 1) | (a.v[1] << 63);
    a.v[1] = (a.v[1] >> 1) | (a.v[2] << 63);
    a.v[2] = (a.v[2] >> 1) | (a.v[3] << 63);
    a.v[3] >>= 1;
}
static inline void u256_shr1_carry(u256& a, uint64_t carry_in) {
    a.v[0] = (a.v[0] >> 1) | (a.v[1] << 63);
    a.v[1] = (a.v[1] >> 1) | (a.v[2] << 63);
    a.v[2] = (a.v[2] >> 1) | (a.v[3] << 63);
    a.v[3] = (a.v[3] >> 1) | (carry_in << 63);
}

static bfq bfq_inv(const bfq& a) {
    if (bfq_is_zero(a)) return a;  // mirror pow-based behavior: 0 -> 0
    u256 u = a.m, v = BQ;
    u256 x1{{1, 0, 0, 0}}, x2{{0, 0, 0, 0}};
    u256 one{{1, 0, 0, 0}};
    while (u256_cmp(u, one) != 0 && u256_cmp(v, one) != 0) {
        while (u256_is_even(u)) {
            u256_shr1(u);
            if (u256_is_even(x1))
                u256_shr1(x1);
            else {
                uint64_t c = u256_add(x1, x1, BQ);
                u256_shr1_carry(x1, c);
            }
        }
        while (u256_is_even(v)) {
            u256_shr1(v);
            if (u256_is_even(x2))
                u256_shr1(x2);
            else {
                uint64_t c = u256_add(x2, x2, BQ);
                u256_shr1_carry(x2, c);
            }
        }
        if (u256_cmp(u, v) >= 0) {
            u256_sub(u, u, v);
            if (u256_sub(x1, x1, x2)) u256_add(x1, x1, BQ);
        } else {
            u256_sub(v, v, u);
            if (u256_sub(x2, x2, x1)) u256_add(x2, x2, BQ);
        }
    }
    bfq raw;
    raw.m = (u256_cmp(u, one) == 0) ? x1 : x2;
    bfq r2{BQ_R2};
    return bfq_mul(bfq_mul(raw, r2), r2);
}

// ===========================================================================
// 8-lane AVX-512 IFMA tier for BN254 Fq: radix-2^52 Montgomery (R52 = 2^260).
//
// Representation: x stored as x*2^260 mod q in five 52-bit limbs, with 2q
// redundancy (values always < 2q ~ 2^254.6, so every limb stays < 2^52 and
// vpmadd52 operand truncation is safe). Multiplication needs no conditional
// subtraction: with a,b < 2q the Montgomery output (a*b + m*q)/2^260 < 1.2q.
// Add/sub pay one masked +-2q fixup. Used by the batch-affine fixed-base
// MSM insert phase (the Groth16 prove hot loop — maps ark-groth16's MSM
// internals, reference src/backend/snark.rs:364).
// ===========================================================================

// 52-limb constants, filled by zkp_bn254_init (zeros until then)
static uint64_t BQ52[5], BQ52X2[5];
static uint64_t BQ52_NINV;  // -q^{-1} mod 2^52
static u256 BQ_W252;        // 2^252 mod q (plain), for 52->64 conversion

static const uint64_t MASK52 = 0xFFFFFFFFFFFFFULL;

// split a canonical-ish u256 value (< 2^256) into 5x52 limbs
static inline void u256_split52(const u256& m, uint64_t out[5]) {
    out[0] = m.v[0] & MASK52;
    out[1] = ((m.v[0] >> 52) | (m.v[1] << 12)) & MASK52;
    out[2] = ((m.v[1] >> 40) | (m.v[2] << 24)) & MASK52;
    out[3] = ((m.v[2] >> 28) | (m.v[3] << 36)) & MASK52;
    out[4] = m.v[3] >> 16;
}
// pack 5x52 limbs (value < 2^256) back into a u256
static inline u256 u256_pack52(const uint64_t in[5]) {
    u256 m;
    m.v[0] = in[0] | (in[1] << 52);
    m.v[1] = (in[1] >> 12) | (in[2] << 40);
    m.v[2] = (in[2] >> 24) | (in[3] << 28);
    m.v[3] = (in[3] >> 36) | (in[4] << 16);
    return m;
}

// bfq (x*2^256, 4x64) -> 52-limb domain (x*2^260): four modular doublings
static inline void bfq_to52(const bfq& a, uint64_t out[5]) {
    u256 m = a.m;
    for (int i = 0; i < 4; i++) {
        uint64_t carry = u256_add(m, m, m);
        if (carry || u256_cmp(m, BQ) >= 0) u256_sub(m, m, BQ);
    }
    u256_split52(m, out);
}
// 52-limb domain (x*2^260, value < 2q) -> bfq: one Montgomery mul by 2^252
static inline bfq bfq_from52(const uint64_t in[5]) {
    bfq v{u256_pack52(in)};
    bfq w{BQ_W252};
    bfq r = bfq_mul(v, w);  // x*2^260 * 2^252 / 2^256 = x*2^256
    if (u256_cmp(r.m, BQ) >= 0) u256_sub(r.m, r.m, BQ);
    return r;
}
// scalar negate in the 52-limb domain: 2q - a (a < 2q, nonzero or exactly 0/q)
static inline void neg52(const uint64_t a[5], uint64_t out[5]) {
    int64_t borrow = 0;
    for (int i = 0; i < 5; i++) {
        int64_t d = (int64_t)BQ52X2[i] - (int64_t)a[i] + borrow;
        out[i] = (uint64_t)d & MASK52;
        borrow = d >> 52;  // arithmetic: -1 when d negative
    }
}

#if defined(__AVX512IFMA__) && defined(__AVX512F__) && defined(__AVX512DQ__)
#define ZKP_HAVE_BFQ8 1

struct bfq8 {
    __m512i v[5];
};

static inline bfq8 bfq8_set1_limbs(const uint64_t l[5]) {
    bfq8 r;
    for (int i = 0; i < 5; i++) r.v[i] = _mm512_set1_epi64((long long)l[i]);
    return r;
}

// signed carry propagate limbs 0..3 into 4 (limb 4 may stay signed/wide)
static inline void bfq8_carry_signed(__m512i r[5]) {
    const __m512i m = _mm512_set1_epi64((long long)MASK52);
    for (int i = 0; i < 4; i++) {
        __m512i c = _mm512_srai_epi64(r[i], 52);
        r[i] = _mm512_and_epi64(r[i], m);
        r[i + 1] = _mm512_add_epi64(r[i + 1], c);
    }
}
// bring a signed-top value into [0, 2q) with one masked +2q, assuming
// value > -2q and value < 2q + 2q
static inline void bfq8_reduce2q(__m512i r[5]) {
    bfq8_carry_signed(r);
    __mmask8 neg = _mm512_cmplt_epi64_mask(r[4], _mm512_setzero_si512());
    for (int i = 0; i < 5; i++)
        r[i] = _mm512_mask_add_epi64(r[i], neg, r[i],
                                     _mm512_set1_epi64((long long)BQ52X2[i]));
    bfq8_carry_signed(r);
}

static inline bfq8 bfq8_add(const bfq8& a, const bfq8& b) {
    bfq8 r;
    for (int i = 0; i < 5; i++) {
        r.v[i] = _mm512_add_epi64(a.v[i], b.v[i]);
        r.v[i] = _mm512_sub_epi64(r.v[i], _mm512_set1_epi64((long long)BQ52X2[i]));
    }
    bfq8_reduce2q(r.v);
    return r;
}
static inline bfq8 bfq8_sub(const bfq8& a, const bfq8& b) {
    bfq8 r;
    for (int i = 0; i < 5; i++) r.v[i] = _mm512_sub_epi64(a.v[i], b.v[i]);
    bfq8_reduce2q(r.v);
    return r;
}
// lane-conditional negate: mask ? (2q - a) : a.
// PRECONDITION: every selected lane must be nonzero mod q — a zero input
// returns exactly 2q, outside the documented <2q domain (and
// bfq8_is_zero_mask would misclassify 2q as nonzero). Current callers
// only negate affine y-coordinates of valid BN254 table points (never 0).
static inline bfq8 bfq8_cneg(const bfq8& a, __mmask8 mask) {
    __m512i t[5];
    for (int i = 0; i < 5; i++)
        t[i] = _mm512_sub_epi64(_mm512_set1_epi64((long long)BQ52X2[i]), a.v[i]);
    bfq8_carry_signed(t);  // 2q - a in [0, 2q], limbs normalize cleanly
    bfq8 r;
    for (int i = 0; i < 5; i++) r.v[i] = _mm512_mask_blend_epi64(mask, a.v[i], t[i]);
    return r;
}

// 8-lane Montgomery multiplication, product-scanning + interleaved reduction.
// Inputs < 2q with limbs < 2^52; output < 2q, limbs < 2^52. Column
// accumulators stay < ~21*2^52 < 2^57 (no 64-bit overflow).
static inline bfq8 bfq8_mul(const bfq8& a, const bfq8& b) {
    const __m512i z = _mm512_setzero_si512();
    __m512i t[11];
    for (int k = 0; k < 11; k++) t[k] = z;
    for (int i = 0; i < 5; i++)
        for (int j = 0; j < 5; j++) {
            t[i + j] = _mm512_madd52lo_epu64(t[i + j], a.v[i], b.v[j]);
            t[i + j + 1] = _mm512_madd52hi_epu64(t[i + j + 1], a.v[i], b.v[j]);
        }
    const __m512i ninv = _mm512_set1_epi64((long long)BQ52_NINV);
    const __m512i mask = _mm512_set1_epi64((long long)MASK52);
    __m512i q[5];
    for (int j = 0; j < 5; j++) q[j] = _mm512_set1_epi64((long long)BQ52[j]);
    for (int i = 0; i < 5; i++) {
        __m512i m = _mm512_madd52lo_epu64(z, _mm512_and_epi64(t[i], mask), ninv);
        for (int j = 0; j < 5; j++) {
            t[i + j] = _mm512_madd52lo_epu64(t[i + j], m, q[j]);
            t[i + j + 1] = _mm512_madd52hi_epu64(t[i + j + 1], m, q[j]);
        }
        t[i + 1] = _mm512_add_epi64(t[i + 1], _mm512_srli_epi64(t[i], 52));
    }
    bfq8 r;
    __m512i c = z;
    for (int k = 0; k < 5; k++) {
        __m512i v = _mm512_add_epi64(t[5 + k], c);
        r.v[k] = _mm512_and_epi64(v, mask);
        c = _mm512_srli_epi64(v, 52);
    }
    // value < 2q < 2^255 => carry out of limb 4 is impossible; fold anyway
    // into limb 4 to keep the invariant explicit (c is zero here).
    r.v[4] = _mm512_add_epi64(r.v[4], _mm512_slli_epi64(c, 52));
    return r;
}
static inline bfq8 bfq8_sqr(const bfq8& a) { return bfq8_mul(a, a); }

// gather 8 elements of a 5-plane SoA arena (plane stride `stride` u64s)
static inline bfq8 bfq8_gather(const uint64_t* base, size_t stride, __m512i idx) {
    bfq8 r;
    for (int i = 0; i < 5; i++)
        r.v[i] = _mm512_i64gather_epi64(idx, (const long long*)(base + i * stride), 8);
    return r;
}
static inline void bfq8_scatter(uint64_t* base, size_t stride, __m512i idx,
                                __mmask8 mask, const bfq8& a) {
    for (int i = 0; i < 5; i++)
        _mm512_mask_i64scatter_epi64((long long*)(base + i * stride), mask, idx,
                                     a.v[i], 8);
}
// per-lane zero test (mod q): value in [0, 2q) is 0 iff limbs == 0 or == q
static inline __mmask8 bfq8_is_zero_mask(const bfq8& a) {
    __mmask8 z = 0xFF, e = 0xFF;
    for (int i = 0; i < 5; i++) {
        z &= _mm512_cmpeq_epi64_mask(a.v[i], _mm512_setzero_si512());
        e &= _mm512_cmpeq_epi64_mask(a.v[i], _mm512_set1_epi64((long long)BQ52[i]));
    }
    return (__mmask8)(z | e);
}

// lane-wise self-test vs the scalar bfq tier; returns 0 ok
static int bfq8_selftest() {
    uint64_t seed = 0x9E3779B97F4A7C15ULL;
    auto rnd = [&]() {
        seed ^= seed << 13;
        seed ^= seed >> 7;
        seed ^= seed << 17;
        return seed;
    };
    bfq a[8], b[8];
    for (int l = 0; l < 8; l++) {
        for (int i = 0; i < 4; i++) {
            a[l].m.v[i] = rnd();
            b[l].m.v[i] = rnd();
        }
        a[l].m.v[3] &= 0x0FFFFFFFFFFFFFFFULL;
        b[l].m.v[3] &= 0x0FFFFFFFFFFFFFFFULL;
        while (u256_cmp(a[l].m, BQ) >= 0) u256_sub(a[l].m, a[l].m, BQ);
        while (u256_cmp(b[l].m, BQ) >= 0) u256_sub(b[l].m, b[l].m, BQ);
    }
    uint64_t al[8][5], bl[8][5];
    alignas(64) uint64_t lane[8];
    bfq8 av, bv;
    for (int l = 0; l < 8; l++) {
        bfq_to52(a[l], al[l]);
        bfq_to52(b[l], bl[l]);
    }
    for (int i = 0; i < 5; i++) {
        for (int l = 0; l < 8; l++) lane[l] = al[l][i];
        av.v[i] = _mm512_load_si512(lane);
        for (int l = 0; l < 8; l++) lane[l] = bl[l][i];
        bv.v[i] = _mm512_load_si512(lane);
    }
    bfq8 mv = bfq8_mul(av, bv);
    bfq8 sv = bfq8_sub(av, bv);
    bfq8 dv = bfq8_add(av, bv);
    bfq8 nv = bfq8_cneg(bv, 0xAA);
    for (int l = 0; l < 8; l++) {
        uint64_t out[5];
        auto extract = [&](const bfq8& x) {
            alignas(64) uint64_t tmp[8];
            for (int i = 0; i < 5; i++) {
                _mm512_store_si512(tmp, x.v[i]);
                out[i] = tmp[l];
            }
        };
        extract(mv);
        if (u256_cmp(bfq_from52(out).m, bfq_mul(a[l], b[l]).m) != 0) return 1;
        extract(sv);
        if (u256_cmp(bfq_from52(out).m, bfq_sub(a[l], b[l]).m) != 0) return 2;
        extract(dv);
        if (u256_cmp(bfq_from52(out).m, bfq_add(a[l], b[l]).m) != 0) return 3;
        extract(nv);
        bfq want = (l & 1) ? bfq_neg(b[l]) : b[l];
        if (u256_cmp(bfq_from52(out).m, want.m) != 0) return 4;
    }
    return 0;
}
#endif  // ZKP_HAVE_BFQ8

// ---- Fq2 = Fq[u]/(u^2+1) ----
struct bfq2 {
    bfq c0, c1;
};
static bfq2 bfq2_zero() { return bfq2{bfq_zero(), bfq_zero()}; }
static bfq2 bfq2_one() { return bfq2{bfq_one(), bfq_zero()}; }
static inline bool bfq2_is_zero(const bfq2& a) { return bfq_is_zero(a.c0) && bfq_is_zero(a.c1); }
static inline bfq2 bfq2_add(const bfq2& a, const bfq2& b) {
    return bfq2{bfq_add(a.c0, b.c0), bfq_add(a.c1, b.c1)};
}
static inline bfq2 bfq2_sub(const bfq2& a, const bfq2& b) {
    return bfq2{bfq_sub(a.c0, b.c0), bfq_sub(a.c1, b.c1)};
}
static inline bfq2 bfq2_neg(const bfq2& a) { return bfq2{bfq_neg(a.c0), bfq_neg(a.c1)}; }
static inline bfq2 bfq2_conj(const bfq2& a) { return bfq2{a.c0, bfq_neg(a.c1)}; }
static bfq2 bfq2_mul(const bfq2& a, const bfq2& b) {
    bfq t0 = bfq_mul(a.c0, b.c0);
    bfq t1 = bfq_mul(a.c1, b.c1);
    bfq s = bfq_mul(bfq_add(a.c0, a.c1), bfq_add(b.c0, b.c1));
    return bfq2{bfq_sub(t0, t1), bfq_sub(bfq_sub(s, t0), t1)};
}
static inline bfq2 bfq2_sq(const bfq2& a) { return bfq2_mul(a, a); }
static bfq2 bfq2_mul_fq(const bfq2& a, const bfq& k) {
    return bfq2{bfq_mul(a.c0, k), bfq_mul(a.c1, k)};
}
static bfq2 bfq2_inv(const bfq2& a) {
    bfq norm = bfq_add(bfq_sq(a.c0), bfq_sq(a.c1));
    bfq ni = bfq_inv(norm);
    return bfq2{bfq_mul(a.c0, ni), bfq_neg(bfq_mul(a.c1, ni))};
}
// xi = 9 + u:  (a0 + a1 u)(9 + u) = (9 a0 - a1) + (a0 + 9 a1) u
static bfq2 bfq2_mul_by_xi(const bfq2& a) {
    bfq a0_9 = a.c0, a1_9 = a.c1;
    // 9x = 8x + x
    for (int i = 0; i < 3; i++) {
        a0_9 = bfq_add(a0_9, a0_9);
        a1_9 = bfq_add(a1_9, a1_9);
    }
    a0_9 = bfq_add(a0_9, a.c0);
    a1_9 = bfq_add(a1_9, a.c1);
    return bfq2{bfq_sub(a0_9, a.c1), bfq_add(a.c0, a1_9)};
}

// ---- Fq6 = Fq2[v]/(v^3 - xi) ----
struct bfq6 {
    bfq2 c0, c1, c2;
};
static bfq6 bfq6_zero() { return bfq6{bfq2_zero(), bfq2_zero(), bfq2_zero()}; }
static bfq6 bfq6_one() { return bfq6{bfq2_one(), bfq2_zero(), bfq2_zero()}; }
static inline bool bfq6_is_zero(const bfq6& a) {
    return bfq2_is_zero(a.c0) && bfq2_is_zero(a.c1) && bfq2_is_zero(a.c2);
}
static inline bfq6 bfq6_add(const bfq6& a, const bfq6& b) {
    return bfq6{bfq2_add(a.c0, b.c0), bfq2_add(a.c1, b.c1), bfq2_add(a.c2, b.c2)};
}
static inline bfq6 bfq6_sub(const bfq6& a, const bfq6& b) {
    return bfq6{bfq2_sub(a.c0, b.c0), bfq2_sub(a.c1, b.c1), bfq2_sub(a.c2, b.c2)};
}
static inline bfq6 bfq6_neg(const bfq6& a) {
    return bfq6{bfq2_neg(a.c0), bfq2_neg(a.c1), bfq2_neg(a.c2)};
}
static bfq6 bfq6_mul(const bfq6& a, const bfq6& b) {
    bfq2 t0 = bfq2_mul(a.c0, b.c0);
    bfq2 t1 = bfq2_mul(a.c1, b.c1);
    bfq2 t2 = bfq2_mul(a.c2, b.c2);
    bfq2 c0 = bfq2_add(
        t0, bfq2_mul_by_xi(bfq2_sub(
                bfq2_sub(bfq2_mul(bfq2_add(a.c1, a.c2), bfq2_add(b.c1, b.c2)), t1), t2)));
    bfq2 c1 = bfq2_add(
        bfq2_sub(bfq2_sub(bfq2_mul(bfq2_add(a.c0, a.c1), bfq2_add(b.c0, b.c1)), t0), t1),
        bfq2_mul_by_xi(t2));
    bfq2 c2 = bfq2_add(
        bfq2_sub(bfq2_sub(bfq2_mul(bfq2_add(a.c0, a.c2), bfq2_add(b.c0, b.c2)), t0), t2), t1);
    return bfq6{c0, c1, c2};
}
static inline bfq6 bfq6_sq(const bfq6& a) { return bfq6_mul(a, a); }
static bfq6 bfq6_mul_by_v(const bfq6& a) { return bfq6{bfq2_mul_by_xi(a.c2), a.c0, a.c1}; }
static bfq6 bfq6_inv(const bfq6& a) {
    bfq2 t0 = bfq2_sub(bfq2_sq(a.c0), bfq2_mul_by_xi(bfq2_mul(a.c1, a.c2)));
    bfq2 t1 = bfq2_sub(bfq2_mul_by_xi(bfq2_sq(a.c2)), bfq2_mul(a.c0, a.c1));
    bfq2 t2 = bfq2_sub(bfq2_sq(a.c1), bfq2_mul(a.c0, a.c2));
    bfq2 denom = bfq2_add(bfq2_add(bfq2_mul(a.c0, t0), bfq2_mul_by_xi(bfq2_mul(a.c2, t1))),
                          bfq2_mul_by_xi(bfq2_mul(a.c1, t2)));
    bfq2 di = bfq2_inv(denom);
    return bfq6{bfq2_mul(t0, di), bfq2_mul(t1, di), bfq2_mul(t2, di)};
}

// ---- Fq12 = Fq6[w]/(w^2 - v) ----
struct bfq12 {
    bfq6 c0, c1;
};
static bfq12 bfq12_one() { return bfq12{bfq6_one(), bfq6_zero()}; }
static inline bool bfq12_is_zero(const bfq12& a) { return bfq6_is_zero(a.c0) && bfq6_is_zero(a.c1); }
static inline bfq12 bfq12_add(const bfq12& a, const bfq12& b) {
    return bfq12{bfq6_add(a.c0, b.c0), bfq6_add(a.c1, b.c1)};
}
static inline bfq12 bfq12_sub(const bfq12& a, const bfq12& b) {
    return bfq12{bfq6_sub(a.c0, b.c0), bfq6_sub(a.c1, b.c1)};
}
static bfq12 bfq12_mul(const bfq12& a, const bfq12& b) {
    bfq6 t0 = bfq6_mul(a.c0, b.c0);
    bfq6 t1 = bfq6_mul(a.c1, b.c1);
    bfq6 c0 = bfq6_add(t0, bfq6_mul_by_v(t1));
    bfq6 c1 = bfq6_sub(bfq6_sub(bfq6_mul(bfq6_add(a.c0, a.c1), bfq6_add(b.c0, b.c1)), t0), t1);
    return bfq12{c0, c1};
}
static bfq12 bfq12_sq(const bfq12& a) {
    // (a0 + a1 w)^2 with w^2 = v: c0 = a0^2 + v a1^2, c1 = 2 a0 a1,
    // computed with two fq6 muls via the Karatsuba-style identity.
    bfq6 ab = bfq6_mul(a.c0, a.c1);
    bfq6 t = bfq6_mul(bfq6_add(a.c0, a.c1), bfq6_add(a.c0, bfq6_mul_by_v(a.c1)));
    bfq6 c0 = bfq6_sub(bfq6_sub(t, ab), bfq6_mul_by_v(ab));
    bfq6 c1 = bfq6_add(ab, ab);
    return bfq12{c0, c1};
}
static bfq12 bfq12_conj(const bfq12& a) { return bfq12{a.c0, bfq6_neg(a.c1)}; }
static bfq12 bfq12_inv(const bfq12& a) {
    bfq6 denom = bfq6_sub(bfq6_sq(a.c0), bfq6_mul_by_v(bfq6_sq(a.c1)));
    bfq6 di = bfq6_inv(denom);
    return bfq12{bfq6_mul(a.c0, di), bfq6_neg(bfq6_mul(a.c1, di))};
}

// frobenius gamma table: gamma1[i] = xi^((q-1) i / 6), i = 0..5 (set at init)
static bfq2 FROB_G1[6];

static bfq6 bfq6_frob(const bfq6& a) {
    return bfq6{bfq2_conj(a.c0), bfq2_mul(bfq2_conj(a.c1), FROB_G1[2]),
                bfq2_mul(bfq2_conj(a.c2), FROB_G1[4])};
}
static bfq12 bfq12_frob(const bfq12& a) {
    bfq6 c0 = bfq6_frob(a.c0);
    bfq6 c1 = bfq6{bfq2_mul(bfq2_conj(a.c1.c0), FROB_G1[1]),
                   bfq2_mul(bfq2_conj(a.c1.c1), FROB_G1[3]),
                   bfq2_mul(bfq2_conj(a.c1.c2), FROB_G1[5])};
    return bfq12{c0, c1};
}

static bfq12 bfq12_pow_bytes(const bfq12& a, const uint8_t* e, int elen) {
    bfq12 r = bfq12_one();
    bool started = false;
    for (int i = elen - 1; i >= 0; i--) {
        for (int bit = 7; bit >= 0; bit--) {
            if (started) r = bfq12_sq(r);
            if ((e[i] >> bit) & 1) {
                if (started)
                    r = bfq12_mul(r, a);
                else {
                    r = a;
                    started = true;
                }
            }
        }
    }
    return r;
}

// ---- init ----
static std::vector<uint8_t> BN_HARD_EXP;  // (q^4 - q^2 + 1)/r, little-endian

void zkp_bn254_init(const uint8_t* q_bytes, const uint8_t* frob_g1_bytes,
                    const uint8_t* hard_exp, uint64_t hard_exp_len) {
    std::memcpy(BQ.v, q_bytes, 32);
    // -q^{-1} mod 2^64 by Newton iteration
    uint64_t q0 = BQ.v[0], inv = 1;
    for (int i = 0; i < 6; i++) inv *= 2 - q0 * inv;
    BQ_NINV = ~inv + 1;  // -(q^-1)
    // R mod q: 2^256 - floor(2^256/q)*q; compute by repeated doubling of 1
    u256 r{{1, 0, 0, 0}};
    for (int i = 0; i < 256; i++) {
        uint64_t carry = u256_add(r, r, r);
        if (carry || u256_cmp(r, BQ) >= 0) u256_sub(r, r, BQ);
    }
    BQ_MONT_ONE = r;
    // R^2 mod q: double 256 more times
    u256 r2 = r;
    for (int i = 0; i < 256; i++) {
        uint64_t carry = u256_add(r2, r2, r2);
        if (carry || u256_cmp(r2, BQ) >= 0) u256_sub(r2, r2, BQ);
    }
    BQ_R2 = r2;
    // 52-limb (IFMA) domain constants: q and 2q split into 5x52 limbs,
    // -q^{-1} mod 2^52, and 2^252 mod q (the 52->64 conversion factor)
    u256_split52(BQ, BQ52);
    {
        u256 q2 = BQ;
        u256_add(q2, q2, BQ);  // 2q < 2^255, no carry
        u256_split52(q2, BQ52X2);
        uint64_t i52 = 1;
        for (int i = 0; i < 6; i++) i52 *= 2 - BQ.v[0] * i52;
        BQ52_NINV = (~i52 + 1) & MASK52;
        u256 w{{1, 0, 0, 0}};
        for (int i = 0; i < 252; i++) {
            uint64_t carry = u256_add(w, w, w);
            if (carry || u256_cmp(w, BQ) >= 0) u256_sub(w, w, BQ);
        }
        BQ_W252 = w;
    }
    // q - 2
    u256 m2;
    u256 two{{2, 0, 0, 0}};
    u256_sub(m2, BQ, two);
    std::memcpy(BQ_M2, m2.v, 32);
    // frobenius gammas: 6 fq2 = 12 x 32 bytes (c0, c1 per element)
    for (int i = 0; i < 6; i++) {
        FROB_G1[i].c0 = bfq_frombytes(frob_g1_bytes + 64 * i);
        FROB_G1[i].c1 = bfq_frombytes(frob_g1_bytes + 64 * i + 32);
    }
    BN_HARD_EXP.assign(hard_exp, hard_exp + hard_exp_len);
}

// ---- G1 Jacobian ----
struct bg1 {
    bfq X, Y, Z;
};
static bg1 bg1_inf() { return bg1{bfq_one(), bfq_one(), bfq_zero()}; }
static inline bool bg1_is_inf(const bg1& p) { return bfq_is_zero(p.Z); }

static bg1 bg1_double(const bg1& p) {
    if (bg1_is_inf(p) || bfq_is_zero(p.Y)) {
        if (bfq_is_zero(p.Y)) return bg1_inf();
        return p;
    }
    bfq A = bfq_sq(p.X);
    bfq B = bfq_sq(p.Y);
    bfq C = bfq_sq(B);
    bfq xb = bfq_add(p.X, B);
    bfq D = bfq_sub(bfq_sub(bfq_sq(xb), A), C);
    D = bfq_add(D, D);
    bfq E = bfq_add(bfq_add(A, A), A);
    bfq F = bfq_sq(E);
    bfq X3 = bfq_sub(F, bfq_add(D, D));
    bfq C8 = bfq_add(C, C);
    C8 = bfq_add(C8, C8);
    C8 = bfq_add(C8, C8);
    bfq Y3 = bfq_sub(bfq_mul(E, bfq_sub(D, X3)), C8);
    bfq Z3 = bfq_mul(p.Y, p.Z);
    Z3 = bfq_add(Z3, Z3);
    return bg1{X3, Y3, Z3};
}

static bg1 bg1_add(const bg1& p, const bg1& q) {
    if (bg1_is_inf(p)) return q;
    if (bg1_is_inf(q)) return p;
    bfq Z1Z1 = bfq_sq(p.Z);
    bfq Z2Z2 = bfq_sq(q.Z);
    bfq U1 = bfq_mul(p.X, Z2Z2);
    bfq U2 = bfq_mul(q.X, Z1Z1);
    bfq S1 = bfq_mul(bfq_mul(p.Y, q.Z), Z2Z2);
    bfq S2 = bfq_mul(bfq_mul(q.Y, p.Z), Z1Z1);
    if (u256_cmp(U1.m, U2.m) == 0) {
        if (u256_cmp(S1.m, S2.m) != 0) return bg1_inf();
        return bg1_double(p);
    }
    bfq H = bfq_sub(U2, U1);
    bfq I = bfq_sq(H);
    I = bfq_add(I, I);
    I = bfq_add(I, I);
    bfq J = bfq_mul(H, I);
    bfq rr = bfq_sub(S2, S1);
    rr = bfq_add(rr, rr);
    bfq V = bfq_mul(U1, I);
    bfq X3 = bfq_sub(bfq_sub(bfq_sq(rr), J), bfq_add(V, V));
    bfq SJ = bfq_mul(S1, J);
    bfq Y3 = bfq_sub(bfq_mul(rr, bfq_sub(V, X3)), bfq_add(SJ, SJ));
    bfq zz = bfq_add(p.Z, q.Z);
    bfq Z3 = bfq_mul(bfq_sub(bfq_sub(bfq_sq(zz), Z1Z1), Z2Z2), H);
    return bg1{X3, Y3, Z3};
}

// ---- G2 Jacobian (over Fq2) ----
struct bg2 {
    bfq2 X, Y, Z;
};
static bg2 bg2_inf() { return bg2{bfq2_one(), bfq2_one(), bfq2_zero()}; }
static inline bool bg2_is_inf(const bg2& p) { return bfq2_is_zero(p.Z); }
static inline bool bfq2_eq(const bfq2& a, const bfq2& b) {
    return u256_cmp(a.c0.m, b.c0.m) == 0 && u256_cmp(a.c1.m, b.c1.m) == 0;
}

static bg2 bg2_double(const bg2& p) {
    if (bg2_is_inf(p) || bfq2_is_zero(p.Y)) {
        if (bfq2_is_zero(p.Y)) return bg2_inf();
        return p;
    }
    bfq2 A = bfq2_sq(p.X);
    bfq2 B = bfq2_sq(p.Y);
    bfq2 C = bfq2_sq(B);
    bfq2 D = bfq2_sub(bfq2_sub(bfq2_sq(bfq2_add(p.X, B)), A), C);
    D = bfq2_add(D, D);
    bfq2 E = bfq2_add(bfq2_add(A, A), A);
    bfq2 F = bfq2_sq(E);
    bfq2 X3 = bfq2_sub(F, bfq2_add(D, D));
    bfq2 C8 = bfq2_add(C, C);
    C8 = bfq2_add(C8, C8);
    C8 = bfq2_add(C8, C8);
    bfq2 Y3 = bfq2_sub(bfq2_mul(E, bfq2_sub(D, X3)), C8);
    bfq2 Z3 = bfq2_mul(p.Y, p.Z);
    Z3 = bfq2_add(Z3, Z3);
    return bg2{X3, Y3, Z3};
}

static bg2 bg2_add(const bg2& p, const bg2& q) {
    if (bg2_is_inf(p)) return q;
    if (bg2_is_inf(q)) return p;
    bfq2 Z1Z1 = bfq2_sq(p.Z);
    bfq2 Z2Z2 = bfq2_sq(q.Z);
    bfq2 U1 = bfq2_mul(p.X, Z2Z2);
    bfq2 U2 = bfq2_mul(q.X, Z1Z1);
    bfq2 S1 = bfq2_mul(bfq2_mul(p.Y, q.Z), Z2Z2);
    bfq2 S2 = bfq2_mul(bfq2_mul(q.Y, p.Z), Z1Z1);
    if (bfq2_eq(U1, U2)) {
        if (!bfq2_eq(S1, S2)) return bg2_inf();
        return bg2_double(p);
    }
    bfq2 H = bfq2_sub(U2, U1);
    bfq2 I = bfq2_sq(H);
    I = bfq2_add(I, I);
    I = bfq2_add(I, I);
    bfq2 J = bfq2_mul(H, I);
    bfq2 rr = bfq2_sub(S2, S1);
    rr = bfq2_add(rr, rr);
    bfq2 V = bfq2_mul(U1, I);
    bfq2 X3 = bfq2_sub(bfq2_sub(bfq2_sq(rr), J), bfq2_add(V, V));
    bfq2 SJ = bfq2_mul(S1, J);
    bfq2 Y3 = bfq2_sub(bfq2_mul(rr, bfq2_sub(V, X3)), bfq2_add(SJ, SJ));
    bfq2 Z3 = bfq2_mul(bfq2_sub(bfq2_sub(bfq2_sq(bfq2_add(p.Z, q.Z)), Z1Z1), Z2Z2), H);
    return bg2{X3, Y3, Z3};
}

// ---- wire codecs: fields canonical LE 32B; G1 = X||Y||Z (96B), G2 = 192B ----
static bg1 bg1_from_wire(const uint8_t* b) {
    return bg1{bfq_frombytes(b), bfq_frombytes(b + 32), bfq_frombytes(b + 64)};
}
static void bg1_to_wire(const bg1& p, uint8_t* b) {
    bfq_tobytes(p.X, b);
    bfq_tobytes(p.Y, b + 32);
    bfq_tobytes(p.Z, b + 64);
}
static bfq2 bfq2_from_wire(const uint8_t* b) {
    return bfq2{bfq_frombytes(b), bfq_frombytes(b + 32)};
}
static void bfq2_to_wire(const bfq2& a, uint8_t* b) {
    bfq_tobytes(a.c0, b);
    bfq_tobytes(a.c1, b + 32);
}
static bg2 bg2_from_wire(const uint8_t* b) {
    return bg2{bfq2_from_wire(b), bfq2_from_wire(b + 64), bfq2_from_wire(b + 128)};
}
static void bg2_to_wire(const bg2& p, uint8_t* b) {
    bfq2_to_wire(p.X, b);
    bfq2_to_wire(p.Y, b + 64);
    bfq2_to_wire(p.Z, b + 128);
}

// ---- Pippenger MSM: shared window-parallel engine ----
// Points are batch-normalized to affine form once per call (one field
// inversion via Montgomery's trick), so bucket accumulation uses cheap
// mixed additions; windows run in parallel (OpenMP when compiled in).
}  // extern "C" (template below needs C++ linkage)

// PT: full point; AF: affine/cached form used for mixed adds.
// MADD(bucket, aff): mixed add; pts_norm[i]: PT equivalent of affs[i].
template <typename PT, typename AF, PT (*ADD)(const PT&, const PT&),
          PT (*MADD)(const PT&, const AF&), PT (*DBL)(const PT&), PT (*INF)()>
static PT msm_core(uint64_t n, const uint8_t* const* sc, const PT* pts_norm,
                   const AF* affs) {
    if (n == 0) return INF();
    int c = 1;
    double best = 1e30;
    for (int cand = 1; cand <= 16; cand++) {
        double cost = (double)((254 + cand - 1) / cand) *
                          ((double)n + (double)(2ULL << cand)) +
                      254.0;
        if (cost < best) {
            best = cost;
            c = cand;
        }
    }
    int nwin = (254 + c - 1) / c;
    uint64_t nbuckets = (1ULL << c) - 1;
    std::vector<PT> parts(nwin);
    std::vector<char> part_set(nwin, 0);
#ifdef _OPENMP
#pragma omp parallel for schedule(dynamic, 1)
#endif
    for (int w = 0; w < nwin; w++) {
        std::vector<PT> buckets(nbuckets);
        std::vector<char> used(nbuckets, 0);
        int shift = w * c;
        for (uint64_t i = 0; i < n; i++) {
            int byte = shift >> 3, bit = shift & 7;
            const uint8_t* s = sc[i];
            uint32_t frag = s[byte];
            if (byte + 1 < 32) frag |= (uint32_t)s[byte + 1] << 8;
            if (byte + 2 < 32) frag |= (uint32_t)s[byte + 2] << 16;
            uint64_t idx = (frag >> bit) & nbuckets;
            if (!idx) continue;
            if (used[idx - 1])
                buckets[idx - 1] = MADD(buckets[idx - 1], affs[i]);
            else {
                buckets[idx - 1] = pts_norm[i];
                used[idx - 1] = true;
            }
        }
        PT running = INF(), total = INF();
        bool run_set = false, tot_set = false;
        for (int64_t idx = (int64_t)nbuckets - 1; idx >= 0; idx--) {
            if (used[idx]) {
                running = run_set ? ADD(running, buckets[idx]) : buckets[idx];
                run_set = true;
            }
            if (run_set) {
                total = tot_set ? ADD(total, running) : running;
                tot_set = true;
            }
        }
        parts[w] = total;
        part_set[w] = tot_set;
    }
    PT acc = INF();
    bool acc_set = false;
    for (int w = nwin - 1; w >= 0; w--) {
        if (acc_set)
            for (int k = 0; k < c; k++) acc = DBL(acc);
        if (part_set[w]) {
            acc = acc_set ? ADD(acc, parts[w]) : parts[w];
            acc_set = true;
        }
    }
    return acc;
}

// ---- BN254 G1 affine form + mixed add ----
struct g1aff {
    bfq x, y;
};

static bg1 bg1_madd(const bg1& p, const g1aff& q) {
    if (bg1_is_inf(p)) return bg1{q.x, q.y, bfq_one()};
    bfq Z1Z1 = bfq_sq(p.Z);
    bfq U2 = bfq_mul(q.x, Z1Z1);
    bfq S2 = bfq_mul(bfq_mul(q.y, p.Z), Z1Z1);
    if (u256_cmp(p.X.m, U2.m) == 0) {
        if (u256_cmp(p.Y.m, S2.m) != 0) return bg1_inf();
        return bg1_double(p);
    }
    bfq H = bfq_sub(U2, p.X);
    bfq I = bfq_sq(H);
    I = bfq_add(I, I);
    I = bfq_add(I, I);
    bfq J = bfq_mul(H, I);
    bfq rr = bfq_sub(S2, p.Y);
    rr = bfq_add(rr, rr);
    bfq V = bfq_mul(p.X, I);
    bfq X3 = bfq_sub(bfq_sub(bfq_sq(rr), J), bfq_add(V, V));
    bfq SJ = bfq_mul(p.Y, J);
    bfq Y3 = bfq_sub(bfq_mul(rr, bfq_sub(V, X3)), bfq_add(SJ, SJ));
    bfq Z3 = bfq_mul(p.Z, H);
    Z3 = bfq_add(Z3, Z3);
    return bg1{X3, Y3, Z3};
}

// batch-normalize Jacobian -> affine with one inversion
static void bg1_normalize(std::vector<bg1>& pts, std::vector<g1aff>& affs) {
    size_t n = pts.size();
    affs.resize(n);
    if (n == 0) return;
    std::vector<bfq> pref(n);
    bfq run = bfq_one();
    for (size_t i = 0; i < n; i++) {
        run = bfq_mul(run, pts[i].Z);
        pref[i] = run;
    }
    bfq inv_all = bfq_inv(run);
    for (size_t i = n; i-- > 0;) {
        bfq zi = (i == 0) ? inv_all : bfq_mul(inv_all, pref[i - 1]);
        inv_all = bfq_mul(inv_all, pts[i].Z);
        bfq zi2 = bfq_sq(zi);
        bfq x = bfq_mul(pts[i].X, zi2);
        bfq y = bfq_mul(bfq_mul(pts[i].Y, zi2), zi);
        affs[i] = g1aff{x, y};
        pts[i] = bg1{x, y, bfq_one()};
    }
}

// ---- BN254 G2 affine form + mixed add ----
struct g2aff {
    bfq2 x, y;
};

static bg2 bg2_madd(const bg2& p, const g2aff& q) {
    if (bg2_is_inf(p)) return bg2{q.x, q.y, bfq2_one()};
    bfq2 Z1Z1 = bfq2_sq(p.Z);
    bfq2 U2 = bfq2_mul(q.x, Z1Z1);
    bfq2 S2 = bfq2_mul(bfq2_mul(q.y, p.Z), Z1Z1);
    if (bfq2_eq(p.X, U2)) {
        if (!bfq2_eq(p.Y, S2)) return bg2_inf();
        return bg2_double(p);
    }
    bfq2 H = bfq2_sub(U2, p.X);
    bfq2 I = bfq2_sq(H);
    I = bfq2_add(I, I);
    I = bfq2_add(I, I);
    bfq2 J = bfq2_mul(H, I);
    bfq2 rr = bfq2_sub(S2, p.Y);
    rr = bfq2_add(rr, rr);
    bfq2 V = bfq2_mul(p.X, I);
    bfq2 X3 = bfq2_sub(bfq2_sub(bfq2_sq(rr), J), bfq2_add(V, V));
    bfq2 SJ = bfq2_mul(p.Y, J);
    bfq2 Y3 = bfq2_sub(bfq2_mul(rr, bfq2_sub(V, X3)), bfq2_add(SJ, SJ));
    bfq2 Z3 = bfq2_mul(p.Z, H);
    Z3 = bfq2_add(Z3, Z3);
    return bg2{X3, Y3, Z3};
}

static void bg2_normalize(std::vector<bg2>& pts, std::vector<g2aff>& affs) {
    size_t n = pts.size();
    affs.resize(n);
    if (n == 0) return;
    std::vector<bfq2> pref(n);
    bfq2 run = bfq2_one();
    for (size_t i = 0; i < n; i++) {
        run = bfq2_mul(run, pts[i].Z);
        pref[i] = run;
    }
    bfq2 inv_all = bfq2_inv(run);
    for (size_t i = n; i-- > 0;) {
        bfq2 zi = (i == 0) ? inv_all : bfq2_mul(inv_all, pref[i - 1]);
        inv_all = bfq2_mul(inv_all, pts[i].Z);
        bfq2 zi2 = bfq2_sq(zi);
        bfq2 x = bfq2_mul(pts[i].X, zi2);
        bfq2 y = bfq2_mul(bfq2_mul(pts[i].Y, zi2), zi);
        affs[i] = g2aff{x, y};
        pts[i] = bg2{x, y, bfq2_one()};
    }
}

// ---- ed25519 cached-affine (Niels) form + mixed add ----
struct edniels {
    fe ymx, ypx, t2d;
};

static ge ge_madd(const ge& p, const edniels& q) {
    fe A = fe_mul(fe_sub(p.Y, p.X), q.ymx);
    fe B = fe_mul(fe_add(p.Y, p.X), q.ypx);
    fe C = fe_mul(p.T, q.t2d);
    fe D = fe_add(p.Z, p.Z);
    fe E = fe_sub(B, A);
    fe F = fe_sub(D, C);
    fe G = fe_add(D, C);
    fe H = fe_add(B, A);
    return ge{fe_mul(E, F), fe_mul(G, H), fe_mul(F, G), fe_mul(E, H)};
}

static void ge_normalize(std::vector<ge>& pts, std::vector<edniels>& affs) {
    size_t n = pts.size();
    affs.resize(n);
    if (n == 0) return;
    fe two_d = fe_frombytes(TWO_D_BYTES);
    std::vector<fe> pref(n);
    fe run = fe_one();
    for (size_t i = 0; i < n; i++) {
        run = fe_mul(run, pts[i].Z);
        pref[i] = run;
    }
    fe inv_all = fe_invert(run);
    for (size_t i = n; i-- > 0;) {
        fe zi = (i == 0) ? inv_all : fe_mul(inv_all, pref[i - 1]);
        inv_all = fe_mul(inv_all, pts[i].Z);
        fe x = fe_mul(pts[i].X, zi);
        fe y = fe_mul(pts[i].Y, zi);
        fe t = fe_mul(x, y);
        affs[i] = edniels{fe_sub(y, x), fe_add(y, x), fe_mul(t, two_d)};
        pts[i] = ge{x, y, fe_one(), t};
    }
}

static void ed_msm_native(uint64_t n_in, const uint8_t* scalars, const uint8_t* points,
                          uint8_t* out) {
    std::vector<ge> pts;
    std::vector<const uint8_t*> sc;
    static const uint8_t ZERO32[32] = {0};
    for (uint64_t i = 0; i < n_in; i++) {
        if (std::memcmp(scalars + 32 * i, ZERO32, 32) != 0) {
            sc.push_back(scalars + 32 * i);
            pts.push_back(ge_from_wire(points + 128 * i));
        }
    }
    if (pts.empty()) {
        ge_to_wire(ge_identity(), out);
        return;
    }
    std::vector<edniels> affs;
    ge_normalize(pts, affs);
    ge r = msm_core<ge, edniels, ge_add, ge_madd, ge_double, ge_identity>(
        pts.size(), sc.data(), pts.data(), affs.data());
    ge_to_wire(r, out);
}

extern "C" {

void zkp_bn254_g1_msm(uint64_t n_in, const uint8_t* scalars, const uint8_t* points,
                      uint8_t* out) {
    std::vector<bg1> pts;
    std::vector<const uint8_t*> sc;
    static const uint8_t ZERO32[32] = {0};
    for (uint64_t i = 0; i < n_in; i++) {
        bg1 p = bg1_from_wire(points + 96 * i);
        if (std::memcmp(scalars + 32 * i, ZERO32, 32) != 0 && !bg1_is_inf(p)) {
            sc.push_back(scalars + 32 * i);
            pts.push_back(p);
        }
    }
    if (pts.empty()) {
        bg1_to_wire(bg1_inf(), out);
        return;
    }
    std::vector<g1aff> affs;
    bg1_normalize(pts, affs);
    bg1 r = msm_core<bg1, g1aff, bg1_add, bg1_madd, bg1_double, bg1_inf>(
        pts.size(), sc.data(), pts.data(), affs.data());
    bg1_to_wire(r, out);
}

void zkp_bn254_g2_msm(uint64_t n_in, const uint8_t* scalars, const uint8_t* points,
                      uint8_t* out) {
    std::vector<bg2> pts;
    std::vector<const uint8_t*> sc;
    static const uint8_t ZERO32[32] = {0};
    for (uint64_t i = 0; i < n_in; i++) {
        bg2 p = bg2_from_wire(points + 192 * i);
        if (std::memcmp(scalars + 32 * i, ZERO32, 32) != 0 && !bg2_is_inf(p)) {
            sc.push_back(scalars + 32 * i);
            pts.push_back(p);
        }
    }
    if (pts.empty()) {
        bg2_to_wire(bg2_inf(), out);
        return;
    }
    std::vector<g2aff> affs;
    bg2_normalize(pts, affs);
    bg2 r = msm_core<bg2, g2aff, bg2_add, bg2_madd, bg2_double, bg2_inf>(
        pts.size(), sc.data(), pts.data(), affs.data());
    bg2_to_wire(r, out);
}

void zkp_bn254_g1_scalar_mul(const uint8_t* scalar, const uint8_t* point, uint8_t* out) {
    zkp_bn254_g1_msm(1, scalar, point, out);
}

void zkp_bn254_g2_scalar_mul(const uint8_t* scalar, const uint8_t* point, uint8_t* out) {
    zkp_bn254_g2_msm(1, scalar, point, out);
}

// ---- pairing (mirrors ops/bn254.py: Fq12-lifted affine Miller loop) ----

struct ec12 {
    bfq12 x, y;
};

// w^2 = v, w^3 = v*w as Fq12 elements
static bfq12 w2_elem() {
    bfq12 r{bfq6_zero(), bfq6_zero()};
    r.c0.c1 = bfq2_one();
    return r;
}
static bfq12 w3_elem() {
    bfq12 r{bfq6_zero(), bfq6_zero()};
    r.c1.c1 = bfq2_one();
    return r;
}
static bfq12 fq2_to_fq12(const bfq2& a) {
    bfq12 r{bfq6_zero(), bfq6_zero()};
    r.c0.c0 = a;
    return r;
}
static bfq12 fq_to_fq12(const bfq& a) {
    bfq12 r{bfq6_zero(), bfq6_zero()};
    r.c0.c0.c0 = a;
    return r;
}

// Fused step: compute the slope once, emit both the line evaluation at Pt
// and the updated point (the Python golden model computes the same slope
// twice, once in _line and once in _ec12_double/_ec12_add).
static bfq12 dbl_step(ec12& T, const ec12& Pt) {
    bfq12 x2 = bfq12_sq(T.x);
    bfq12 three_x2 = bfq12_add(bfq12_add(x2, x2), x2);
    bfq12 m = bfq12_mul(three_x2, bfq12_inv(bfq12_add(T.y, T.y)));
    bfq12 line = bfq12_sub(bfq12_mul(m, bfq12_sub(Pt.x, T.x)), bfq12_sub(Pt.y, T.y));
    bfq12 xr = bfq12_sub(bfq12_sq(m), bfq12_add(T.x, T.x));
    bfq12 yr = bfq12_sub(bfq12_mul(m, bfq12_sub(T.x, xr)), T.y);
    T = ec12{xr, yr};
    return line;
}

static bfq12 add_step(ec12& T, const ec12& Q, const ec12& Pt) {
    bfq12 dx = bfq12_sub(Q.x, T.x);
    if (bfq12_is_zero(dx)) {
        if (bfq12_is_zero(bfq12_sub(T.y, Q.y))) return dbl_step(T, Pt);
        // vertical line (T + Q = infinity); matches the Python golden model
        return bfq12_sub(Pt.x, T.x);
    }
    bfq12 m = bfq12_mul(bfq12_sub(Q.y, T.y), bfq12_inv(dx));
    bfq12 line = bfq12_sub(bfq12_mul(m, bfq12_sub(Pt.x, T.x)), bfq12_sub(Pt.y, T.y));
    bfq12 xr = bfq12_sub(bfq12_sub(bfq12_sq(m), T.x), Q.x);
    bfq12 yr = bfq12_sub(bfq12_mul(m, bfq12_sub(T.x, xr)), T.y);
    T = ec12{xr, yr};
    return line;
}

static bfq12 line_eval(const ec12& p1, const ec12& p2, const ec12& t) {
    bfq12 dx = bfq12_sub(p1.x, p2.x);
    if (!bfq12_is_zero(dx)) {
        bfq12 m = bfq12_mul(bfq12_sub(p2.y, p1.y), bfq12_inv(bfq12_sub(p2.x, p1.x)));
        return bfq12_sub(bfq12_mul(m, bfq12_sub(t.x, p1.x)), bfq12_sub(t.y, p1.y));
    }
    if (bfq12_is_zero(bfq12_sub(p1.y, p2.y))) {
        bfq12 x2 = bfq12_sq(p1.x);
        bfq12 three_x2 = bfq12_add(bfq12_add(x2, x2), x2);
        bfq12 two_y = bfq12_add(p1.y, p1.y);
        bfq12 m = bfq12_mul(three_x2, bfq12_inv(two_y));
        return bfq12_sub(bfq12_mul(m, bfq12_sub(t.x, p1.x)), bfq12_sub(t.y, p1.y));
    }
    return bfq12_sub(t.x, p1.x);
}

static ec12 ec12_double(const ec12& p) {
    bfq12 x2 = bfq12_sq(p.x);
    bfq12 three_x2 = bfq12_add(bfq12_add(x2, x2), x2);
    bfq12 m = bfq12_mul(three_x2, bfq12_inv(bfq12_add(p.y, p.y)));
    bfq12 xr = bfq12_sub(bfq12_sq(m), bfq12_add(p.x, p.x));
    bfq12 yr = bfq12_sub(bfq12_mul(m, bfq12_sub(p.x, xr)), p.y);
    return ec12{xr, yr};
}

static ec12 ec12_add(const ec12& p1, const ec12& p2) {
    if (bfq12_is_zero(bfq12_sub(p1.x, p2.x)) && bfq12_is_zero(bfq12_sub(p1.y, p2.y)))
        return ec12_double(p1);
    bfq12 m = bfq12_mul(bfq12_sub(p2.y, p1.y), bfq12_inv(bfq12_sub(p2.x, p1.x)));
    bfq12 xr = bfq12_sub(bfq12_sub(bfq12_sq(m), p1.x), p2.x);
    bfq12 yr = bfq12_sub(bfq12_mul(m, bfq12_sub(p1.x, xr)), p1.y);
    return ec12{xr, yr};
}

// 6x+2 with x = 4965661367192848881 is 65 bits — must be a u128
static const u128 ATE_LOOP = (u128)6 * 4965661367192848881ULL + 2;

// q2 affine (4 fq2 coords via to_affine done by caller in Python? no — caller
// passes Jacobian wire; convert here)
static bool bg1_to_affine(const bg1& p, bfq& x, bfq& y) {
    if (bg1_is_inf(p)) return false;
    bfq zi = bfq_inv(p.Z);
    bfq zi2 = bfq_sq(zi);
    x = bfq_mul(p.X, zi2);
    y = bfq_mul(bfq_mul(p.Y, zi2), zi);
    return true;
}
static bool bg2_to_affine(const bg2& p, bfq2& x, bfq2& y) {
    if (bg2_is_inf(p)) return false;
    bfq2 zi = bfq2_inv(p.Z);
    bfq2 zi2 = bfq2_sq(zi);
    x = bfq2_mul(p.X, zi2);
    y = bfq2_mul(bfq2_mul(p.Y, zi2), zi);
    return true;
}

// Sparse-coordinate Miller loop. All twisted points are (X*w^2, Y*w^3) with
// X, Y in Fq2; slopes live at w. Substituting into the generic line
// m*(xt - x1) - (yt - y1) evaluated at P = (px, py) in E(Fq) gives the
// sparse element  -py + (m*px) w + (Y1 - m*X1) w^3  — identical value to the
// generic Fq12 computation (differentially tested), ~5x fewer muls.
struct twpt {
    bfq2 x, y;
};

static bfq12 line_sparse(const bfq2& m, const twpt& t1, const bfq& px, const bfq& py) {
    bfq12 l{bfq6_zero(), bfq6_zero()};
    l.c0.c0.c0 = bfq_neg(py);
    l.c1.c0 = bfq2_mul_fq(m, px);
    l.c1.c1 = bfq2_sub(t1.y, bfq2_mul(m, t1.x));
    return l;
}

// vertical line x - x1: at P gives px - X1 w^2
static bfq12 line_vertical(const twpt& t1, const bfq& px) {
    bfq12 l{bfq6_zero(), bfq6_zero()};
    l.c0.c0.c0 = px;
    l.c0.c1 = bfq2_neg(t1.x);
    return l;
}

static bfq12 dbl_step_tw(twpt& T, const bfq& px, const bfq& py) {
    bfq2 x2 = bfq2_sq(T.x);
    bfq2 three_x2 = bfq2_add(bfq2_add(x2, x2), x2);
    // m_full = 3x^2/(2y) = (3X^2 w^4)/(2Y w^3) = (3X^2/2Y) * xi^{0}... w^4/w^3 = w,
    // but numerator coefficient sits at w^4 = v * w: 3X^2 v w / (2Y w^3)?
    // Work it out with w^2 = v: x^2 = X^2 v^2 ... the ratio is
    // (3X^2 / 2Y) * v^2 w^... — avoided entirely by computing the slope of the
    // ORIGINAL twisted coordinates: m = (3 X^2 xi / 2Y) ... Instead we use the
    // identity derived from the generic code path: m_full = M w with
    // M = 3X^2 * xi / (2Y)?  The safe derivation: x = Xw^2, y = Yw^3:
    // m = 3x^2/(2y) = 3X^2 w^4 / (2Y w^3) = (3X^2/(2Y)) w.   (w^4 = w^3 * w)
    bfq2 M = bfq2_mul(three_x2, bfq2_inv(bfq2_add(T.y, T.y)));
    bfq12 l = line_sparse(M, T, px, py);
    // x' = m^2 - 2x: (M w)^2 = M^2 v = (M^2 xi^{1/3}) — as a w^2 coefficient:
    // m^2 = M^2 w^2, so X' = M^2 - 2X;  y' = m(x - x') - y -> Y' = M(X - X') - Y
    bfq2 Xp = bfq2_sub(bfq2_sq(M), bfq2_add(T.x, T.x));
    bfq2 Yp = bfq2_sub(bfq2_mul(M, bfq2_sub(T.x, Xp)), T.y);
    T = twpt{Xp, Yp};
    return l;
}

static bfq12 add_step_tw(twpt& T, const twpt& Q, const bfq& px, const bfq& py) {
    bfq2 dx = bfq2_sub(Q.x, T.x);
    if (bfq2_is_zero(dx)) {
        if (bfq2_is_zero(bfq2_sub(T.y, Q.y))) return dbl_step_tw(T, px, py);
        return line_vertical(T, px);
    }
    bfq2 M = bfq2_mul(bfq2_sub(Q.y, T.y), bfq2_inv(dx));
    bfq12 l = line_sparse(M, T, px, py);
    bfq2 Xp = bfq2_sub(bfq2_sub(bfq2_sq(M), T.x), Q.x);
    bfq2 Yp = bfq2_sub(bfq2_mul(M, bfq2_sub(T.x, Xp)), T.y);
    T = twpt{Xp, Yp};
    return l;
}

// f * line where line = a + b w + c w^3  (a in Fq embedded at c0.c0.c0,
// b, c in Fq2): a full mul specialised to the sparse multiplicand.
static bfq12 bfq12_mul_line(const bfq12& f, const bfq12& l) {
    return bfq12_mul(f, l);
}

// Affine-step Miller (per-step field inversions) — kept as the fallback for
// the degenerate T.x == Q.x addition the projective path punts on.
static bfq12 miller_affine(const bg2& qj, const bg1& pj) {
    bfq px, py;
    bfq2 q2x, q2y;
    if (!bg1_to_affine(pj, px, py) || !bg2_to_affine(qj, q2x, q2y)) return bfq12_one();
    twpt Q{q2x, q2y};
    twpt T = Q;
    bfq12 f = bfq12_one();
    int top = 127;
    while (!((ATE_LOOP >> top) & 1)) top--;
    for (int i = top - 1; i >= 0; i--) {
        f = bfq12_mul_line(bfq12_sq(f), dbl_step_tw(T, px, py));
        if ((ATE_LOOP >> i) & 1) f = bfq12_mul_line(f, add_step_tw(T, Q, px, py));
    }
    bfq2 q1x = bfq2_mul(bfq2_conj(q2x), FROB_G1[2]);
    bfq2 q1y = bfq2_mul(bfq2_conj(q2y), FROB_G1[3]);
    bfq2 q2x2 = bfq2_mul(bfq2_conj(q1x), FROB_G1[2]);
    bfq2 q2y2 = bfq2_mul(bfq2_conj(q1y), FROB_G1[3]);
    twpt Q1{q1x, q1y};
    twpt Q2{q2x2, bfq2_neg(q2y2)};
    f = bfq12_mul_line(f, add_step_tw(T, Q1, px, py));
    f = bfq12_mul_line(f, add_step_tw(T, Q2, px, py));
    return f;
}

// ---- projective Miller loop (no per-step inversions) ----
//
// T in homogeneous projective twist coordinates; every line is scaled by a
// nonzero Fq2 constant (2YZ for doubling, lambda for addition), which the
// final exponentiation kills ((q^2 - 1) divides (q^12 - 1)/r), so pairing
// values are unchanged bit-for-bit vs the affine path. Lines come out as
// l0 + l1 w + l3 w^3 with all three coefficients in Fq2.

struct twproj {
    bfq2 X, Y, Z;
};

// (x0 + x1 v + x2 v^2) * (d + e v) over Fq2, v^3 = xi
static inline bfq6 fq6_mul_sparse2(const bfq6& x, const bfq2& d, const bfq2& e) {
    return bfq6{
        bfq2_add(bfq2_mul(x.c0, d), bfq2_mul_by_xi(bfq2_mul(x.c2, e))),
        bfq2_add(bfq2_mul(x.c1, d), bfq2_mul(x.c0, e)),
        bfq2_add(bfq2_mul(x.c2, d), bfq2_mul(x.c1, e))};
}

// f *= l0 + l1 w + l3 w^3 = L0 + M w  with L0 = (l0,0,0), M = (l1,l3,0):
// 15 Fq2 muls vs the full mul's 18 (Karatsuba on the w level).
static bfq12 bfq12_mul_sparse013(const bfq12& f, const bfq2& l0,
                                 const bfq2& l1, const bfq2& l3) {
    bfq6 t0{bfq2_mul(f.c0.c0, l0), bfq2_mul(f.c0.c1, l0),
            bfq2_mul(f.c0.c2, l0)};
    bfq6 t1 = fq6_mul_sparse2(f.c1, l1, l3);
    bfq6 s = bfq6_add(f.c0, f.c1);
    bfq6 cross = fq6_mul_sparse2(s, bfq2_add(l0, l1), l3);
    cross = bfq6_sub(bfq6_sub(cross, t0), t1);
    return bfq12{bfq6_add(t0, bfq6_mul_by_v(t1)), cross};
}

// 2T with the line at P, scale 2YZ (AKLGL-style, verified against the
// affine slope algebra via the curve equation Y^2 Z = X^3 + b' Z^3):
//   l0 = -2YZ*yP, l1 = 3X^2*xP, l3 = 3b'Z^2 - Y^2
static void dbl_step_proj(twproj& T, const bfq2& b3tw, const bfq& px,
                          const bfq& py, bfq2& l0, bfq2& l1, bfq2& l3) {
    bfq2 A = bfq2_sq(T.X);
    bfq2 B = bfq2_sq(T.Y);
    bfq2 C = bfq2_sq(T.Z);
    bfq2 E = bfq2_mul(b3tw, C);              // 3 b' Z^2
    bfq2 F = bfq2_add(bfq2_add(E, E), E);    // 9 b' Z^2
    bfq2 H = bfq2_sub(bfq2_sub(bfq2_sq(bfq2_add(T.Y, T.Z)), B), C);  // 2YZ
    l0 = bfq2_neg(bfq2_mul_fq(H, py));
    bfq2 A3 = bfq2_add(bfq2_add(A, A), A);
    l1 = bfq2_mul_fq(A3, px);
    l3 = bfq2_sub(E, B);
    // point update, uniform scale 4: X3 = 2 XY (B - F),
    // Y3 = (B+F)^2 - 12 E^2, Z3 = 4 B H
    bfq2 XY = bfq2_mul(T.X, T.Y);
    bfq2 X3 = bfq2_mul(XY, bfq2_sub(B, F));
    X3 = bfq2_add(X3, X3);
    bfq2 E2 = bfq2_sq(E);
    bfq2 E4 = bfq2_add(E2, E2);
    E4 = bfq2_add(E4, E4);                    // 4 E^2
    bfq2 E12 = bfq2_add(bfq2_add(E4, E4), E4);
    bfq2 Y3 = bfq2_sub(bfq2_sq(bfq2_add(B, F)), E12);
    bfq2 Z3 = bfq2_mul(B, H);
    Z3 = bfq2_add(Z3, Z3);
    Z3 = bfq2_add(Z3, Z3);
    T = twproj{X3, Y3, Z3};
}

// T + Q (Q affine on the twist) with the line at P, scale lambda:
//   l0 = -lambda*yP, l1 = theta*xP, l3 = lambda*y2 - theta*x2.
// Returns false on the degenerate T.x == Q.x case (caller falls back).
static bool add_step_proj(twproj& T, const bfq2& x2, const bfq2& y2,
                          const bfq& px, const bfq& py, bfq2& l0, bfq2& l1,
                          bfq2& l3) {
    bfq2 B = bfq2_mul(x2, T.Z);
    bfq2 theta = bfq2_sub(T.Y, bfq2_mul(y2, T.Z));
    bfq2 lam = bfq2_sub(T.X, B);
    if (bfq2_is_zero(lam)) return false;
    bfq2 C = bfq2_sq(theta);
    bfq2 D = bfq2_sq(lam);
    bfq2 E = bfq2_mul(lam, D);
    bfq2 F = bfq2_mul(T.Z, C);
    bfq2 G = bfq2_mul(T.X, D);
    bfq2 H = bfq2_add(bfq2_sub(E, bfq2_add(G, G)), F);  // E + F - 2G
    l0 = bfq2_neg(bfq2_mul_fq(lam, py));
    l1 = bfq2_mul_fq(theta, px);
    l3 = bfq2_sub(bfq2_mul(lam, y2), bfq2_mul(theta, x2));
    bfq2 X3 = bfq2_mul(lam, H);
    bfq2 Y3 = bfq2_sub(bfq2_mul(theta, bfq2_sub(G, H)), bfq2_mul(T.Y, E));
    bfq2 Z3 = bfq2_mul(T.Z, E);
    T = twproj{X3, Y3, Z3};
    return true;
}

static bfq12 miller(const bg2& qj, const bg1& pj) {
    bfq px, py;
    bfq2 q2x, q2y;
    if (!bg1_to_affine(pj, px, py) || !bg2_to_affine(qj, q2x, q2y)) return bfq12_one();
    // twist constant 3 b' = 3 (y^2 - x^3) from the (valid) input point
    bfq2 btw = bfq2_sub(bfq2_sq(q2y), bfq2_mul(bfq2_sq(q2x), q2x));
    bfq2 b3tw = bfq2_add(bfq2_add(btw, btw), btw);
    twproj T{q2x, q2y, bfq2_one()};
    bfq12 f = bfq12_one();
    bfq2 l0, l1, l3;
    int top = 127;
    while (!((ATE_LOOP >> top) & 1)) top--;
    for (int i = top - 1; i >= 0; i--) {
        dbl_step_proj(T, b3tw, px, py, l0, l1, l3);
        f = bfq12_mul_sparse013(bfq12_sq(f), l0, l1, l3);
        if ((ATE_LOOP >> i) & 1) {
            if (!add_step_proj(T, q2x, q2y, px, py, l0, l1, l3))
                return miller_affine(qj, pj);  // degenerate: T.x == Q.x
            f = bfq12_mul_sparse013(f, l0, l1, l3);
        }
    }
    bfq2 q1x = bfq2_mul(bfq2_conj(q2x), FROB_G1[2]);
    bfq2 q1y = bfq2_mul(bfq2_conj(q2y), FROB_G1[3]);
    bfq2 q2x2 = bfq2_mul(bfq2_conj(q1x), FROB_G1[2]);
    bfq2 q2y2 = bfq2_mul(bfq2_conj(q1y), FROB_G1[3]);
    if (!add_step_proj(T, q1x, q1y, px, py, l0, l1, l3))
        return miller_affine(qj, pj);
    f = bfq12_mul_sparse013(f, l0, l1, l3);
    if (!add_step_proj(T, q2x2, bfq2_neg(q2y2), px, py, l0, l1, l3))
        return miller_affine(qj, pj);
    f = bfq12_mul_sparse013(f, l0, l1, l3);
    return f;
}

// Granger-Scott cyclotomic squaring (f in G_Phi6(q^2), i.e. after the easy
// part of the final exponentiation): 9 Fq2 muls instead of the full
// squaring's 18. Fq4 pairs in this tower (Fq12 = Fq4[w]/(w^3 - s),
// s = v*w): (c0.c0, c1.c1), (c1.c0, c0.c2), (c0.c1, c1.c2).
static inline void fq4_sq(const bfq2& a, const bfq2& b, bfq2& t0, bfq2& t1) {
    bfq2 t = bfq2_mul(a, b);
    t0 = bfq2_sub(
        bfq2_sub(bfq2_mul(bfq2_add(a, b), bfq2_add(a, bfq2_mul_by_xi(b))), t),
        bfq2_mul_by_xi(t));
    t1 = bfq2_add(t, t);
}
static bfq12 bfq12_cyclo_sq(const bfq12& f) {
    const bfq2 &z0 = f.c0.c0, &z4 = f.c0.c1, &z3 = f.c0.c2;
    const bfq2 &z2 = f.c1.c0, &z1 = f.c1.c1, &z5 = f.c1.c2;
    bfq2 t0, t1, t2, t3, t4, t5;
    fq4_sq(z0, z1, t0, t1);
    fq4_sq(z2, z3, t2, t3);
    fq4_sq(z4, z5, t4, t5);
    auto three_minus = [](const bfq2& t, const bfq2& z) {  // 3t - 2z
        bfq2 r = bfq2_sub(t, z);
        r = bfq2_add(r, r);
        return bfq2_add(r, t);
    };
    auto three_plus = [](const bfq2& t, const bfq2& z) {  // 3t + 2z
        bfq2 r = bfq2_add(t, z);
        r = bfq2_add(r, r);
        return bfq2_add(r, t);
    };
    bfq12 r;
    r.c0.c0 = three_minus(t0, z0);
    r.c1.c1 = three_plus(t1, z1);
    r.c1.c0 = three_plus(bfq2_mul_by_xi(t5), z2);
    r.c0.c2 = three_minus(t4, z3);
    r.c0.c1 = three_minus(t2, z4);
    r.c1.c2 = three_plus(t3, z5);
    return r;
}

// pow by LE-byte exponent in NAF form; `a` must lie in the cyclotomic
// subgroup so conj(a) = a^{-1} (true after the easy part of the final exp).
static bfq12 bfq12_pow_naf_cyclo(const bfq12& a, const uint8_t* e, int elen) {
    // digits of e in {-1, 0, 1}, LSB first
    std::vector<int8_t> naf;
    naf.reserve(8 * elen + 1);
    std::vector<uint8_t> k(e, e + elen);
    k.push_back(0);
    auto is_zero = [&]() {
        for (uint8_t b : k)
            if (b) return false;
        return true;
    };
    auto shr1 = [&]() {
        uint8_t carry = 0;
        for (int i = (int)k.size() - 1; i >= 0; i--) {
            uint8_t nxt = k[i] & 1;
            k[i] = (k[i] >> 1) | (carry << 7);
            carry = nxt;
        }
    };
    auto add_small = [&](int v) {  // v in {-1,1}; k stays non-negative
        if (v > 0) {
            int i = 0;
            while (v) {
                int s = k[i] + v;
                k[i] = (uint8_t)s;
                v = s >> 8;
                i++;
            }
        } else {
            int i = 0, borrow = 1;
            while (borrow) {
                int s = k[i] - borrow;
                borrow = s < 0;
                k[i] = (uint8_t)(s + (borrow << 8));
                i++;
            }
        }
    };
    while (!is_zero()) {
        if (k[0] & 1) {
            int d = 2 - (int)(k[0] & 3);  // 1 or -1
            naf.push_back((int8_t)d);
            add_small(-d);
        } else {
            naf.push_back(0);
        }
        shr1();
    }
    bfq12 r = bfq12_one();
    bfq12 a_inv = bfq12_conj(a);
    bool started = false;
    for (int i = (int)naf.size() - 1; i >= 0; i--) {
        if (started) r = bfq12_cyclo_sq(r);
        if (naf[i] == 1) {
            r = started ? bfq12_mul(r, a) : a;
            started = true;
        } else if (naf[i] == -1) {
            r = started ? bfq12_mul(r, a_inv) : a_inv;
            started = true;
        }
    }
    return started ? r : bfq12_one();
}

static inline bool bfq12_eq(const bfq12& a, const bfq12& b) {
    const bfq* x = (const bfq*)&a;
    const bfq* y = (const bfq*)&b;
    for (int i = 0; i < 12; i++)
        if (u256_cmp(x[i].m, y[i].m) != 0) return false;
    return true;
}

// Hard part of the BN final exponentiation via the Devegili-Scott-Dahab
// vectorial addition chain: three 63-bit x-powers (NAF, cyclotomic
// squarings) + frobenius maps instead of one generic 1016-bit pow.
// Validated at runtime against the generic (q^4-q^2+1)/r pow on the first
// nontrivial call; falls back permanently if the chain ever disagrees.
static bfq12 final_exp_hard_chain(const bfq12& m) {
    static const uint8_t XLE[8] = {0xF1, 0x09, 0x69, 0x4A,
                                   0xB4, 0x92, 0xE9, 0x44};  // 4965661367192848881 LE
    bfq12 fx = bfq12_pow_naf_cyclo(m, XLE, 8);
    bfq12 fx2 = bfq12_pow_naf_cyclo(fx, XLE, 8);
    bfq12 fx3 = bfq12_pow_naf_cyclo(fx2, XLE, 8);
    bfq12 fp = bfq12_frob(m);
    bfq12 fp2 = bfq12_frob(fp);
    bfq12 fp3 = bfq12_frob(fp2);
    bfq12 fxp = bfq12_frob(fx);
    bfq12 fx2p = bfq12_frob(fx2);
    bfq12 fx3p = bfq12_frob(fx3);
    bfq12 fx2p2 = bfq12_frob(bfq12_frob(fx2));
    bfq12 y0 = bfq12_mul(bfq12_mul(fp, fp2), fp3);
    bfq12 y1 = bfq12_conj(m);
    bfq12 y2 = fx2p2;
    bfq12 y3 = bfq12_conj(fxp);
    bfq12 y4 = bfq12_conj(bfq12_mul(fx, fx2p));
    bfq12 y5 = bfq12_conj(fx2);
    bfq12 y6 = bfq12_conj(bfq12_mul(fx3, fx3p));
    bfq12 t0 = bfq12_mul(bfq12_mul(bfq12_cyclo_sq(y6), y4), y5);
    bfq12 t1 = bfq12_mul(bfq12_mul(y3, y5), t0);
    t0 = bfq12_mul(t0, y2);
    t1 = bfq12_cyclo_sq(bfq12_mul(bfq12_cyclo_sq(t1), t0));
    t0 = bfq12_mul(t1, y1);
    t1 = bfq12_mul(t1, y0);
    t0 = bfq12_cyclo_sq(t0);
    return bfq12_mul(t0, t1);
}

static bfq12 final_exp(const bfq12& f) {
    bfq12 f1 = bfq12_mul(bfq12_conj(f), bfq12_inv(f));
    bfq12 f2 = bfq12_mul(bfq12_frob(bfq12_frob(f1)), f1);
    // -1 unvalidated, 1 chain ok, 0 fall back; atomic: ctypes releases the
    // GIL, so concurrent pairings may race here (all writers agree, relaxed
    // ordering suffices)
    static std::atomic<int> hard_ok{-1};
    int hv = hard_ok.load(std::memory_order_relaxed);
    if (hv == 1) return final_exp_hard_chain(f2);
    if (hv == 0)
        return bfq12_pow_naf_cyclo(f2, BN_HARD_EXP.data(),
                                   (int)BN_HARD_EXP.size());
    bfq12 generic = bfq12_pow_naf_cyclo(f2, BN_HARD_EXP.data(),
                                        (int)BN_HARD_EXP.size());
    if (!bfq12_eq(f2, bfq12_one())) {
        bfq12 chain = final_exp_hard_chain(f2);
        hard_ok.store(bfq12_eq(chain, generic) ? 1 : 0,
                      std::memory_order_relaxed);
    }
    return generic;
}

// pairs: n G1 (96B each) + n G2 (192B each); out: fq12 as 12 x 32B
// ordered c0.c0.c0, c0.c0.c1, c0.c1.c0, ... (tower nesting, LE fields)
static void bfq12_to_wire(const bfq12& a, uint8_t* out) {
    const bfq* els[12] = {
        &a.c0.c0.c0, &a.c0.c0.c1, &a.c0.c1.c0, &a.c0.c1.c1, &a.c0.c2.c0, &a.c0.c2.c1,
        &a.c1.c0.c0, &a.c1.c0.c1, &a.c1.c1.c0, &a.c1.c1.c1, &a.c1.c2.c0, &a.c1.c2.c1,
    };
    for (int i = 0; i < 12; i++) bfq_tobytes(*els[i], out + 32 * i);
}

void zkp_bn254_multi_pairing(uint64_t n, const uint8_t* g1s, const uint8_t* g2s,
                             uint8_t* out) {
    // Miller loops are independent (the product is taken before the shared
    // final exponentiation) -> OpenMP across pairs for batch verification.
    bfq12 f = bfq12_one();
#ifdef _OPENMP
#pragma omp parallel if (n >= 4)
    {
        bfq12 local = bfq12_one();
#pragma omp for schedule(dynamic, 1) nowait
        for (int64_t i = 0; i < (int64_t)n; i++) {
            bg1 p = bg1_from_wire(g1s + 96 * i);
            bg2 q = bg2_from_wire(g2s + 192 * i);
            if (bg1_is_inf(p) || bg2_is_inf(q)) continue;
            local = bfq12_mul(local, miller(q, p));
        }
#pragma omp critical
        f = bfq12_mul(f, local);
    }
#else
    for (uint64_t i = 0; i < n; i++) {
        bg1 p = bg1_from_wire(g1s + 96 * i);
        bg2 q = bg2_from_wire(g2s + 192 * i);
        if (bg1_is_inf(p) || bg2_is_inf(q)) continue;
        f = bfq12_mul(f, miller(q, p));
    }
#endif
    bfq12_to_wire(final_exp(f), out);
}

static bfq12 bfq12_from_wire(const uint8_t* in) {
    bfq12 a;
    bfq* els[12] = {
        &a.c0.c0.c0, &a.c0.c0.c1, &a.c0.c1.c0, &a.c0.c1.c1, &a.c0.c2.c0, &a.c0.c2.c1,
        &a.c1.c0.c0, &a.c1.c0.c1, &a.c1.c1.c0, &a.c1.c1.c1, &a.c1.c2.c0, &a.c1.c2.c1,
    };
    for (int i = 0; i < 12; i++) *els[i] = bfq_frombytes(in + 32 * i);
    return a;
}

// Miller loop only (pre-final-exp value), for caching constant pairs.
void zkp_bn254_miller(const uint8_t* g1, const uint8_t* g2, uint8_t* out) {
    bfq12_to_wire(miller(bg2_from_wire(g2), bg1_from_wire(g1)), out);
}

// multi-pairing with a precomputed extra miller factor multiplied in before
// the shared final exponentiation.
void zkp_bn254_multi_pairing_premul(const uint8_t* f_pre, uint64_t n,
                                    const uint8_t* g1s, const uint8_t* g2s,
                                    uint8_t* out) {
    bfq12 f = bfq12_from_wire(f_pre);
    for (uint64_t i = 0; i < n; i++) {
        bg1 p = bg1_from_wire(g1s + 96 * i);
        bg2 q = bg2_from_wire(g2s + 192 * i);
        if (bg1_is_inf(p) || bg2_is_inf(q)) continue;
        f = bfq12_mul(f, miller(q, p));
    }
    bfq12_to_wire(final_exp(f), out);
}

}  // extern "C"

// ===========================================================================
// Generic radix-2 NTT over a runtime ≤256-bit odd prime (used for BN254 Fr
// QAP domains and the STARK f128 LDE — mirrors ops/ntt.py ntt()).
// ===========================================================================

namespace {

struct mctx {
    u256 q;
    uint64_t ninv;
    u256 r2;
    u256 one_m;  // R mod q
};

void mctx_init(mctx& c, const uint8_t mod[32]) {
    std::memcpy(c.q.v, mod, 32);
    uint64_t q0 = c.q.v[0], inv = 1;
    for (int i = 0; i < 6; i++) inv *= 2 - q0 * inv;
    c.ninv = ~inv + 1;
    u256 r{{1, 0, 0, 0}};
    for (int i = 0; i < 256; i++) {
        uint64_t carry = u256_add(r, r, r);
        if (carry || u256_cmp(r, c.q) >= 0) u256_sub(r, r, c.q);
    }
    c.one_m = r;
    u256 r2 = r;
    for (int i = 0; i < 256; i++) {
        uint64_t carry = u256_add(r2, r2, r2);
        if (carry || u256_cmp(r2, c.q) >= 0) u256_sub(r2, r2, c.q);
    }
    c.r2 = r2;
}

u256 mx_mul(const mctx& c, const u256& a, const u256& b) {
    uint64_t t[6] = {0, 0, 0, 0, 0, 0};
    for (int i = 0; i < 4; i++) {
        u128 cc = 0;
        for (int j = 0; j < 4; j++) {
            cc += (u128)t[j] + (u128)a.v[i] * b.v[j];
            t[j] = (uint64_t)cc;
            cc >>= 64;
        }
        cc += t[4];
        t[4] = (uint64_t)cc;
        t[5] = (uint64_t)(cc >> 64);
        uint64_t m = t[0] * c.ninv;
        cc = (u128)t[0] + (u128)m * c.q.v[0];
        cc >>= 64;
        for (int j = 1; j < 4; j++) {
            cc += (u128)t[j] + (u128)m * c.q.v[j];
            t[j - 1] = (uint64_t)cc;
            cc >>= 64;
        }
        cc += t[4];
        t[3] = (uint64_t)cc;
        t[4] = t[5] + (uint64_t)(cc >> 64);
    }
    u256 r;
    for (int i = 0; i < 4; i++) r.v[i] = t[i];
    if (t[4] || u256_cmp(r, c.q) >= 0) u256_sub(r, r, c.q);
    return r;
}

inline u256 mx_add(const mctx& c, const u256& a, const u256& b) {
    u256 r;
    uint64_t carry = u256_add(r, a, b);
    if (carry || u256_cmp(r, c.q) >= 0) u256_sub(r, r, c.q);
    return r;
}

inline u256 mx_sub(const mctx& c, const u256& a, const u256& b) {
    u256 r;
    if (u256_sub(r, a, b)) u256_add(r, r, c.q);
    return r;
}

}  // namespace

extern "C" {

// data: n * 32B LE values (canonical), transformed in place.
// root: the size-n root of unity to use (caller inverts it for the inverse
// transform); scale: optional 32B multiplier applied at the end (n^{-1} for
// the inverse transform) — pass NULL for none.
void zkp_ntt(uint64_t n, uint8_t* data, const uint8_t* mod, const uint8_t* root,
             const uint8_t* scale) {
    mctx c;
    mctx_init(c, mod);
    std::vector<u256> a(n);
    for (uint64_t i = 0; i < n; i++) {
        u256 raw;
        std::memcpy(raw.v, data + 32 * i, 32);
        a[i] = mx_mul(c, raw, c.r2);  // to Montgomery
    }
    // bit-reverse permute
    int bits = 0;
    while ((1ULL << bits) < n) bits++;
    for (uint64_t i = 0; i < n; i++) {
        uint64_t j = 0;
        for (int b = 0; b < bits; b++) j |= ((i >> b) & 1) << (bits - 1 - b);
        if (j > i) std::swap(a[i], a[j]);
    }
    // stage twiddle bases: w_len(s) = root^(n / 2^(s+1)); the last stage uses
    // root itself, each earlier stage is the square of the next.
    u256 root_m;
    {
        u256 raw;
        std::memcpy(raw.v, root, 32);
        root_m = mx_mul(c, raw, c.r2);
    }
    std::vector<u256> wlen(bits);
    if (bits > 0) {
        wlen[bits - 1] = root_m;
        for (int s = bits - 2; s >= 0; s--) wlen[s] = mx_mul(c, wlen[s + 1], wlen[s + 1]);
    }
    for (int s = 0; s < bits; s++) {
        uint64_t length = 2ULL << s;
        uint64_t half = length >> 1;
        for (uint64_t start = 0; start < n; start += length) {
            u256 w = c.one_m;
            for (uint64_t k = start; k < start + half; k++) {
                u256 u = a[k];
                u256 v = mx_mul(c, a[k + half], w);
                a[k] = mx_add(c, u, v);
                a[k + half] = mx_sub(c, u, v);
                w = mx_mul(c, w, wlen[s]);
            }
        }
    }
    if (scale) {
        u256 raw;
        std::memcpy(raw.v, scale, 32);
        u256 sm = mx_mul(c, raw, c.r2);
        for (uint64_t i = 0; i < n; i++) a[i] = mx_mul(c, a[i], sm);
    }
    u256 one_raw{{1, 0, 0, 0}};
    for (uint64_t i = 0; i < n; i++) {
        u256 out = mx_mul(c, a[i], one_raw);  // from Montgomery
        std::memcpy(data + 32 * i, out.v, 32);
    }
}

}  // extern "C"

// ===========================================================================
// Fixed-base MSM (BGMW): for process-constant bases (Bulletproofs generator
// vectors, Groth16 proving-key queries) precompute 2^(c*w)-shifted affine
// tables once; every subsequent MSM is digit->shared-bucket mixed adds with
// a single bucket reduction and no doublings.
// ===========================================================================

namespace {

template <typename PT, typename AF>
struct fixed_tab {
    int c = 0, nwin = 0;
    uint64_t n = 0;
    std::vector<AF> tab;       // nwin * n cached-affine points
    std::vector<PT> tab_pt;    // same, as full points (bucket first-assign)
    std::vector<char> is_inf;  // per input point: skip (batch-inv can't norm)
    // 52-limb-domain SoA copy of `tab` for the IFMA complete-add kernels:
    // plane-major, x limbs 0-4 then y limbs 5-9 (BN254 G1; G2 uses 20
    // planes: x.c0, x.c1, y.c0, y.c1 five limbs each). Empty when the IFMA
    // tier is compiled out or the curve has no vector kernel.
    std::vector<uint64_t> tab52;
    // Table-of-multiples tier (ed25519 bulletproofs prove path): per window
    // w (radix 2^cm, signed digits) and basis point i, the 2^(cm-1)
    // multiples d * 2^(cm*w) * P_i for d = 1..2^(cm-1), cached-affine and
    // padded to exactly two cache lines (128 B) so a gathered entry costs a
    // fixed two-line fetch. Layout: tabm[((w * n + i) << (cm-1)) + |d| - 1].
    // An MSM insert is then one gather + one accumulator mixed-add: no
    // bucket arenas, no scatters, no per-window reduction — and the radix
    // is free to grow with available RAM (the working set is RAM-resident
    // and latency-hidden with hugepages + software prefetch). Built lazily
    // by ensure_tabm_ed(); empty = tier disabled.
    int cm = 0, nwin_m = 0;
    // Built-flag for the multiples table: release-stored by the builder
    // (under TABM_MUTEX) after the table fields are written, acquire-loaded
    // by the lock-free fast path in ensure_tabm_ed so readers observe the
    // fields the store publishes. ctypes releases the GIL, so concurrent
    // Python threads genuinely race here.
    std::atomic<int> tabm_ready{0};
    std::vector<uint64_t> tabm;  // 16 qwords/entry: ymx[5] ypx[5] t2d[5] pad
    size_t tabm_off = 0;         // qword offset aligning entry 0 to 128 B
};

int pick_window(uint64_t n) {
    int c = 1;
    double best = 1e30;
    for (int cand = 1; cand <= 18; cand++) {
        double cost = (double)((254 + cand - 1) / cand) * (double)n +
                      (double)(2ULL << cand);
        if (cost < best) {
            best = cost;
            c = cand;
        }
    }
    return c;
}

template <typename PT, typename AF, PT (*ADD)(const PT&, const PT&),
          PT (*MADD)(const PT&, const AF&), PT (*DBL)(const PT&), PT (*INF)(),
          void (*NORM)(std::vector<PT>&, std::vector<AF>&), bool (*ISINF)(const PT&)>
void build_fixed(fixed_tab<PT, AF>& ft, std::vector<PT>& pts) {
    uint64_t n = pts.size();
    ft.n = n;
    ft.is_inf.resize(n);
    // infinity inputs cannot be batch-normalized; park a placeholder there
    // and mark the slot so the accumulate loop skips it.
    PT placeholder = INF();
    bool have = false;
    for (uint64_t i = 0; i < n && !have; i++)
        if (!ISINF(pts[i])) {
            placeholder = pts[i];
            have = true;
        }
    for (uint64_t i = 0; i < n; i++) {
        ft.is_inf[i] = ISINF(pts[i]);
        if (ft.is_inf[i]) pts[i] = placeholder;
    }
    if (!have) {  // all-infinity basis: degenerate, tables never used
        ft.c = 1;
        ft.nwin = 0;
        return;
    }
    ft.c = pick_window(n);
    ft.nwin = (254 + ft.c - 1) / ft.c;
    ft.tab.reserve(ft.nwin * n);
    ft.tab_pt.reserve(ft.nwin * n);
    std::vector<PT> level = pts;
    for (int w = 0; w < ft.nwin; w++) {
        std::vector<AF> affs;
        NORM(level, affs);  // normalizes level in place to Z=1 too
        ft.tab.insert(ft.tab.end(), affs.begin(), affs.end());
        ft.tab_pt.insert(ft.tab_pt.end(), level.begin(), level.end());
        if (w + 1 < ft.nwin)
            for (uint64_t i = 0; i < n; i++)
                for (int k = 0; k < ft.c; k++) level[i] = DBL(level[i]);
    }
}

// want_chunks: 0 = auto (2 when OpenMP and enough windows), 1 = serial
// (caller is already running under higher-level parallelism), N = that many
// window chunks. Exists because on small hosts nested OpenMP under Python
// thread pools oversubscribes the cores and is slower than serial.
template <typename PT, typename AF, PT (*ADD)(const PT&, const PT&),
          PT (*MADD)(const PT&, const AF&), PT (*DBL)(const PT&), PT (*INF)()>
PT fixed_msm(const fixed_tab<PT, AF>& ft, const uint8_t* scalars,
             int want_chunks = 0) {
    uint64_t nbuckets = (1ULL << ft.c) - 1;
    int nchunks = 1;
#ifdef _OPENMP
    nchunks = want_chunks > 0 ? want_chunks : (ft.nwin >= 8 ? 2 : 1);
    if (nchunks > ft.nwin) nchunks = ft.nwin > 0 ? ft.nwin : 1;
#else
    (void)want_chunks;
#endif
    std::vector<PT> partial(nchunks);
    std::vector<char> partial_set(nchunks, 0);
#ifdef _OPENMP
#pragma omp parallel for schedule(static, 1)
#endif
    for (int chunk = 0; chunk < nchunks; chunk++) {
        std::vector<PT> buckets(nbuckets);
        std::vector<char> used(nbuckets, 0);
        int w_lo = chunk * ft.nwin / nchunks;
        int w_hi = (chunk + 1) * ft.nwin / nchunks;
        for (int w = w_lo; w < w_hi; w++) {
            int shift = w * ft.c;
            const AF* trow = ft.tab.data() + (size_t)w * ft.n;
            const PT* prow = ft.tab_pt.data() + (size_t)w * ft.n;
            for (uint64_t i = 0; i < ft.n; i++) {
                int byte = shift >> 3, bit = shift & 7;
                if (byte >= 32) continue;
                const uint8_t* s = scalars + 32 * i;
                uint32_t frag = s[byte];
                if (byte + 1 < 32) frag |= (uint32_t)s[byte + 1] << 8;
                if (byte + 2 < 32) frag |= (uint32_t)s[byte + 2] << 16;
                uint64_t idx = (frag >> bit) & nbuckets;
                if (!idx || ft.is_inf[i]) continue;
                if (used[idx - 1])
                    buckets[idx - 1] = MADD(buckets[idx - 1], trow[i]);
                else {
                    buckets[idx - 1] = prow[i];
                    used[idx - 1] = true;
                }
            }
        }
        PT running = INF(), total = INF();
        bool run_set = false, tot_set = false;
        for (int64_t idx = (int64_t)nbuckets - 1; idx >= 0; idx--) {
            if (used[idx]) {
                running = run_set ? ADD(running, buckets[idx]) : buckets[idx];
                run_set = true;
            }
            if (run_set) {
                total = tot_set ? ADD(total, running) : running;
                tot_set = true;
            }
        }
        partial[chunk] = total;
        partial_set[chunk] = tot_set;
    }
    PT acc = INF();
    bool acc_set = false;
    for (int chunk = 0; chunk < nchunks; chunk++) {
        if (partial_set[chunk]) {
            acc = acc_set ? ADD(acc, partial[chunk]) : partial[chunk];
            acc_set = true;
        }
    }
    return acc_set ? acc : INF();
}

// Many independent MSMs over ONE fixed table (a batch of proofs of the same
// circuit). OpenMP parallelizes across the batch — real multicore with no
// GIL in the way — and each thread walks the table window-major so a hot
// table row serves consecutive scalar vectors.
template <typename PT, typename AF, PT (*ADD)(const PT&, const PT&),
          PT (*MADD)(const PT&, const AF&), PT (*DBL)(const PT&), PT (*INF)()>
void fixed_msm_many(const fixed_tab<PT, AF>& ft, uint64_t batch,
                    const uint8_t* scalars, PT* out) {
#ifdef _OPENMP
#pragma omp parallel for schedule(dynamic, 1)
#endif
    for (uint64_t b = 0; b < batch; b++) {
        out[b] = fixed_msm<PT, AF, ADD, MADD, DBL, INF>(
            ft, scalars + b * 32 * ft.n, /*want_chunks=*/1);
    }
}

// ===========================================================================
// Batch-affine fixed-base MSM (BN254 G1/G2 — short Weierstrass, a = 0).
//
// Two wins over the Jacobian bucket path above:
//  * buckets live in AFFINE coordinates and inserts are grouped into
//    conflict-free rounds completed with one shared field inversion per
//    round (Montgomery's trick) — an insert amortizes to ~6 field muls
//    against ~14 for a Jacobian mixed add;
//  * scalars are recoded into SIGNED window digits (affine negation is
//    free), halving the bucket count and the suffix-sum reduction.
// The twisted-Edwards (ed25519) tables keep the Jacobian/Niels path: Edwards
// affine addition has no cheap shared-inversion form.
// ===========================================================================

struct fq_ops {
    using F = bfq;
    static inline F add(const F& a, const F& b) { return bfq_add(a, b); }
    static inline F sub(const F& a, const F& b) { return bfq_sub(a, b); }
    static inline F mul(const F& a, const F& b) { return bfq_mul(a, b); }
    static inline F sqr(const F& a) { return bfq_sq(a); }
    static inline F inv(const F& a) { return bfq_inv(a); }
    static inline F neg(const F& a) { return bfq_neg(a); }
    static inline bool eq(const F& a, const F& b) {
        return u256_cmp(a.m, b.m) == 0;
    }
};

struct fq2_ops {
    using F = bfq2;
    static inline F add(const F& a, const F& b) { return bfq2_add(a, b); }
    static inline F sub(const F& a, const F& b) { return bfq2_sub(a, b); }
    static inline F mul(const F& a, const F& b) { return bfq2_mul(a, b); }
    static inline F sqr(const F& a) { return bfq2_sq(a); }
    static inline F inv(const F& a) { return bfq2_inv(a); }
    static inline F neg(const F& a) { return bfq2_neg(a); }
    static inline bool eq(const F& a, const F& b) { return bfq2_eq(a, b); }
};

template <typename FO>
struct ba_buckets {
    using F = typename FO::F;
    std::vector<F> x, y;
    std::vector<char> occ;
    void init(uint32_t half) {
        x.resize(half);
        y.resize(half);
        occ.assign(half, 0);
    }
};

// Signed-digit recoding: digit_w in [-2^(c-1)+1, 2^(c-1)] with carry into
// the next window. Requires nwin*c >= 255 so the top carry is absorbed
// (canonical scalars are < 2^254); callers fall back otherwise.
static void recode_signed(const uint8_t* scalars, uint64_t n, int c, int nwin,
                          const std::vector<char>& is_inf, int16_t* digits) {
    const uint32_t full = 1u << c, half = 1u << (c - 1), mask = full - 1;
    for (uint64_t i = 0; i < n; i++) {
        const uint8_t* s = scalars + 32 * i;
        int16_t* d = digits + (size_t)i * nwin;
        if (!is_inf.empty() && is_inf[i]) {
            std::memset(d, 0, sizeof(int16_t) * nwin);
            continue;
        }
        uint32_t carry = 0;
        for (int w = 0; w < nwin; w++) {
            int shift = w * c;
            int byte = shift >> 3, bit = shift & 7;
            uint32_t frag = 0;
            if (byte < 32) {
                frag = s[byte];
                if (byte + 1 < 32) frag |= (uint32_t)s[byte + 1] << 8;
                if (byte + 2 < 32) frag |= (uint32_t)s[byte + 2] << 16;
                if (byte + 3 < 32) frag |= (uint32_t)s[byte + 3] << 24;
                frag = (frag >> bit) & mask;
            }
            uint32_t v = frag + carry;
            if (v > half) {
                d[w] = (int16_t)((int32_t)v - (int32_t)full);
                carry = 1;
            } else {
                d[w] = (int16_t)v;
                carry = 0;
            }
        }
    }
}

// Accumulate windows [w_lo, w_hi) into affine buckets via conflict-free
// batched affine additions. digits is the recode_signed array (n x nwin).
template <typename PT, typename AF, typename FO>
static void ba_insert_range(const fixed_tab<PT, AF>& ft,
                            const int16_t* digits, int w_lo, int w_hi,
                            ba_buckets<FO>& bk) {
    using F = typename FO::F;
    const uint64_t n = ft.n;
    const int nwin = ft.nwin;
    struct Ins {
        uint32_t b;  // (bucket << 1) | negate
        uint32_t t;  // table index (w * n + i)
    };
    std::vector<Ins> all;
    all.reserve((size_t)(w_hi - w_lo) * n);
    const uint32_t nbk = (uint32_t)bk.occ.size();
    std::vector<uint32_t> cnt(nbk + 1, 0);
    for (int w = w_lo; w < w_hi; w++) {
        const size_t row = (size_t)w * n;
        for (uint64_t i = 0; i < n; i++) {
            int16_t d = digits[(size_t)i * nwin + w];
            if (!d) continue;
            uint32_t b = d > 0 ? (uint32_t)d : (uint32_t)(-(int32_t)d);
            all.push_back(Ins{((b - 1) << 1) | (uint32_t)(d < 0), (uint32_t)(row + i)});
            cnt[b - 1]++;
        }
    }
    // Counting-sort by bucket, then round r processes the r-th occurrence of
    // every bucket: each insert is visited exactly once (the naive
    // defer-and-rescan loop revisits the whole tail every round, which
    // costs more than the field arithmetic for deep buckets).
    std::vector<uint32_t> off(nbk + 1, 0);
    uint32_t maxmult = 0;
    for (uint32_t b = 0; b < nbk; b++) {
        off[b + 1] = off[b] + cnt[b];
        if (cnt[b] > maxmult) maxmult = cnt[b];
    }
    std::vector<Ins> sorted(all.size());
    {
        std::vector<uint32_t> cursor(off.begin(), off.end() - 1);
        for (const Ins& e : all) sorted[cursor[e.b >> 1]++] = e;
    }
    // Active bucket list: compacted as buckets exhaust their occurrences.
    std::vector<uint32_t> active;
    active.reserve(nbk);
    for (uint32_t b = 0; b < nbk; b++)
        if (cnt[b]) active.push_back(b);
    // The shared-inversion prefix/suffix products are interleaved into LANES
    // independent chains merged by one field inversion per round: a single
    // chain is a dependent-multiply chain (~2 mul latencies per insert,
    // which dominates everything else), while 8 chains run at multiplier
    // throughput.
    constexpr size_t LANES = 8;
    struct Pend {
        uint32_t b, t;
        uint8_t dbl, neg;
    };
    std::vector<Pend> pend;
    std::vector<F> den, pref;
    for (uint32_t round = 0; round < maxmult && !active.empty(); round++) {
        pend.clear();
        den.clear();
        size_t na = 0;
        for (size_t a = 0; a < active.size(); a++) {
            uint32_t b = active[a];
            const Ins& e = sorted[off[b] + round];
            if (round + 1 < cnt[b]) active[na++] = b;
            const AF& q = ft.tab[e.t];
            F qy = (e.b & 1) ? FO::neg(q.y) : q.y;
            if (!bk.occ[b]) {
                bk.x[b] = q.x;
                bk.y[b] = qy;
                bk.occ[b] = 1;
                continue;
            }
            if (FO::eq(bk.x[b], q.x)) {
                if (FO::eq(bk.y[b], qy)) {
                    pend.push_back(Pend{b, e.t, 1, (uint8_t)(e.b & 1)});
                    den.push_back(FO::add(qy, qy));  // doubling: 2y
                } else {
                    bk.occ[b] = 0;  // P + (-P) = infinity
                }
                continue;
            }
            pend.push_back(Pend{b, e.t, 0, (uint8_t)(e.b & 1)});
            den.push_back(FO::sub(q.x, bk.x[b]));
        }
        active.resize(na);
        size_t m = den.size();
        if (m) {
            pref.resize(m);
            F run[LANES];
            size_t nl = m < LANES ? m : LANES;
            for (size_t l = 0; l < nl; l++) pref[l] = run[l] = den[l];
            for (size_t k = nl; k < m; k++)
                pref[k] = run[k % LANES] = FO::mul(run[k % LANES], den[k]);
            // merge lane products, invert once, recover per-lane inverses
            F tot = run[0];
            for (size_t l = 1; l < nl; l++) tot = FO::mul(tot, run[l]);
            F tinv = FO::inv(tot);
            F lane_inv[LANES];
            if (nl == 1) {
                lane_inv[0] = tinv;
            } else {
                F suf[LANES];  // suf[l] = run[l+1] * ... * run[nl-1]
                suf[nl - 1] = run[nl - 1];
                for (size_t l = nl - 1; l-- > 0;) suf[l] = FO::mul(run[l], suf[l + 1]);
                F pre = run[0];
                lane_inv[0] = FO::mul(tinv, suf[1]);
                for (size_t l = 1; l < nl; l++) {
                    lane_inv[l] = (l + 1 < nl) ? FO::mul(FO::mul(tinv, pre), suf[l + 1])
                                               : FO::mul(tinv, pre);
                    if (l + 1 < nl) pre = FO::mul(pre, run[l]);
                }
            }
            for (size_t k = m; k-- > 0;) {
                size_t l = k % LANES;
                F di = (k >= LANES) ? FO::mul(lane_inv[l], pref[k - LANES])
                                    : lane_inv[l];
                if (k >= LANES) lane_inv[l] = FO::mul(lane_inv[l], den[k]);
                const Pend& p = pend[k];
                const AF& q = ft.tab[p.t];
                F lam;
                if (p.dbl) {
                    F x2 = FO::sqr(bk.x[p.b]);
                    lam = FO::mul(FO::add(x2, FO::add(x2, x2)), di);  // 3x^2/2y
                } else {
                    F qy = p.neg ? FO::neg(q.y) : q.y;
                    lam = FO::mul(FO::sub(qy, bk.y[p.b]), di);
                }
                F x3 = FO::sub(FO::sub(FO::sqr(lam), bk.x[p.b]), q.x);
                F y3 = FO::sub(FO::mul(lam, FO::sub(bk.x[p.b], x3)), bk.y[p.b]);
                bk.x[p.b] = x3;
                bk.y[p.b] = y3;
            }
        }
    }
}

// Weighted suffix-sum reduction: sum_{d=1..half} d * bucket[d].
template <typename PT, typename AF, typename FO,
          PT (*ADD)(const PT&, const PT&), PT (*MADD)(const PT&, const AF&),
          PT (*INF)()>
static PT ba_reduce(const ba_buckets<FO>& bk) {
    PT running = INF(), total = INF();
    bool run_set = false;
    for (int64_t b = (int64_t)bk.occ.size() - 1; b >= 0; b--) {
        if (bk.occ[b]) {
            AF q{bk.x[b], bk.y[b]};
            running = MADD(running, q);
            run_set = true;
        }
        if (run_set) total = ADD(total, running);
    }
    return total;
}

// Range variant used by the window-task scheduler: caller provides the
// shared recoded digits so carries cross chunk boundaries correctly.
template <typename PT, typename AF, typename FO,
          PT (*ADD)(const PT&, const PT&), PT (*MADD)(const PT&, const AF&),
          PT (*INF)()>
static PT fixed_msm_ba_range(const fixed_tab<PT, AF>& ft,
                             const int16_t* digits, int w_lo, int w_hi) {
    ba_buckets<FO> bk;
    bk.init(1u << (ft.c - 1));
    ba_insert_range<PT, AF, FO>(ft, digits, w_lo, w_hi, bk);
    return ba_reduce<PT, AF, FO, ADD, MADD, INF>(bk);
}

template <typename PT, typename AF, typename FO>
static bool ba_eligible(const fixed_tab<PT, AF>& ft) {
    return ft.nwin > 0 && ft.c >= 2 && ft.c <= 16 && ft.nwin * ft.c >= 255;
}

#ifdef ZKP_HAVE_BFQ8
// ===========================================================================
// 8-lane IFMA complete-addition bucket accumulation (BN254 G1 and G2).
//
// Buckets live as projective (X:Y:Z) points in the 52-limb Montgomery
// domain, identity = (0:1:0). The a=0 complete addition law
// (Renes-Costello-Batina 2015, algorithms 7/8; both BN254 G1 and its
// sextic-twist G2 are a=0 curves) is branchless: first-assign, doubling
// and cancellation need no special cases, so eight independent bucket
// updates vectorize exactly. The conflict-free schedule (one insert per
// distinct bucket per round) comes from the same counting sort the scalar
// batch-affine path uses. Kernels are templated over a vector-field trait:
// fv_g1 = 8-lane Fq, fv_g2 = 8-lane Fq2 (Karatsuba over bfq8).
// ===========================================================================

struct fv_g1 {
    using V = bfq8;  // 8 lanes of Fq
    using S = bfq;   // scalar Fq
    static const int CP = 5;  // u64 planes per coordinate
    static inline V mul(const V& a, const V& b) { return bfq8_mul(a, b); }
    static inline V add(const V& a, const V& b) { return bfq8_add(a, b); }
    static inline V sub(const V& a, const V& b) { return bfq8_sub(a, b); }
    static inline V cneg(const V& a, __mmask8 m) { return bfq8_cneg(a, m); }
    static inline V mul_b3(const V& a) {  // b3 = 9 (y^2 = x^3 + 3): 8a + a
        V d = bfq8_add(a, a);
        d = bfq8_add(d, d);
        d = bfq8_add(d, d);
        return bfq8_add(d, a);
    }
    static inline V zero() {
        V r;
        for (int i = 0; i < 5; i++) r.v[i] = _mm512_setzero_si512();
        return r;
    }
    static inline V one() {
        uint64_t l[5];
        bfq_to52(bfq_one(), l);
        return bfq8_set1_limbs(l);
    }
    static inline V gather(const uint64_t* base, size_t stride, __m512i idx) {
        return bfq8_gather(base, stride, idx);
    }
    static inline void scatter(uint64_t* base, size_t stride, __m512i idx,
                               __mmask8 m, const V& a) {
        bfq8_scatter(base, stride, idx, m, a);
    }
    static inline S extract(const V& a, int lane) {
        alignas(64) uint64_t tmp[8];
        uint64_t l[5];
        for (int i = 0; i < 5; i++) {
            _mm512_store_si512(tmp, a.v[i]);
            l[i] = tmp[lane];
        }
        return bfq_from52(l);
    }
    static inline S smul(const S& a, const S& b) { return bfq_mul(a, b); }
    static inline S ssqr(const S& a) { return bfq_sq(a); }
};

struct bfq28 {
    bfq8 c0, c1;
};
// 3*b of the G2 twist (b' = 3/(9+u)), broadcast; set when a G2 table builds
static bfq28 G2_B3_VEC;

struct fv_g2 {
    using V = bfq28;  // 8 lanes of Fq2
    using S = bfq2;
    static const int CP = 10;  // c0 limbs 0-4, c1 limbs 5-9
    static inline V mul(const V& a, const V& b) {  // Karatsuba, 3 bfq8 muls
        bfq8 t0 = bfq8_mul(a.c0, b.c0);
        bfq8 t1 = bfq8_mul(a.c1, b.c1);
        bfq8 s = bfq8_mul(bfq8_add(a.c0, a.c1), bfq8_add(b.c0, b.c1));
        return V{bfq8_sub(t0, t1), bfq8_sub(bfq8_sub(s, t0), t1)};
    }
    static inline V add(const V& a, const V& b) {
        return V{bfq8_add(a.c0, b.c0), bfq8_add(a.c1, b.c1)};
    }
    static inline V sub(const V& a, const V& b) {
        return V{bfq8_sub(a.c0, b.c0), bfq8_sub(a.c1, b.c1)};
    }
    static inline V cneg(const V& a, __mmask8 m) {
        return V{bfq8_cneg(a.c0, m), bfq8_cneg(a.c1, m)};
    }
    static inline V mul_b3(const V& a) { return mul(a, G2_B3_VEC); }
    static inline V zero() { return V{fv_g1::zero(), fv_g1::zero()}; }
    static inline V one() { return V{fv_g1::one(), fv_g1::zero()}; }
    static inline V gather(const uint64_t* base, size_t stride, __m512i idx) {
        return V{bfq8_gather(base, stride, idx),
                 bfq8_gather(base + 5 * stride, stride, idx)};
    }
    static inline void scatter(uint64_t* base, size_t stride, __m512i idx,
                               __mmask8 m, const V& a) {
        bfq8_scatter(base, stride, idx, m, a.c0);
        bfq8_scatter(base + 5 * stride, stride, idx, m, a.c1);
    }
    static inline S extract(const V& a, int lane) {
        return S{fv_g1::extract(a.c0, lane), fv_g1::extract(a.c1, lane)};
    }
    static inline S smul(const S& a, const S& b) { return bfq2_mul(a, b); }
    static inline S ssqr(const S& a) { return bfq2_sq(a); }
};

template <typename FV>
struct p8t {
    typename FV::V X, Y, Z;
};

// P (projective) + Q (affine, never identity): RCB'15 algorithm 8.
template <typename FV>
static inline p8t<FV> p8_add_mixed(const p8t<FV>& P, const typename FV::V& qx,
                                   const typename FV::V& qy) {
    using V = typename FV::V;
    V t0 = FV::mul(P.X, qx);
    V t1 = FV::mul(P.Y, qy);
    V t3 = FV::add(qx, qy);
    V t4 = FV::add(P.X, P.Y);
    t3 = FV::mul(t3, t4);
    t4 = FV::add(t0, t1);
    t3 = FV::sub(t3, t4);  // X1Y2 + X2Y1
    t4 = FV::mul(qy, P.Z);
    t4 = FV::add(t4, P.Y);  // Y1 + Y2 Z1
    V Y3 = FV::mul(qx, P.Z);
    Y3 = FV::add(Y3, P.X);  // X1 + X2 Z1
    V X3 = FV::add(t0, t0);
    t0 = FV::add(X3, t0);     // 3 X1 X2
    V t2 = FV::mul_b3(P.Z);   // b3 Z1
    V Z3 = FV::add(t1, t2);
    t1 = FV::sub(t1, t2);
    Y3 = FV::mul_b3(Y3);
    X3 = FV::mul(t4, Y3);
    t2 = FV::mul(t3, t1);
    X3 = FV::sub(t2, X3);
    Y3 = FV::mul(Y3, t0);
    t1 = FV::mul(t1, Z3);
    Y3 = FV::add(t1, Y3);
    t0 = FV::mul(t0, t3);
    Z3 = FV::mul(Z3, t4);
    Z3 = FV::add(Z3, t0);
    return p8t<FV>{X3, Y3, Z3};
}

// P + Q, both projective: RCB'15 algorithm 7. Complete (identity, doubling,
// cancellation all flow through the same arithmetic).
template <typename FV>
static inline p8t<FV> p8_add(const p8t<FV>& P, const p8t<FV>& Q) {
    using V = typename FV::V;
    V t0 = FV::mul(P.X, Q.X);
    V t1 = FV::mul(P.Y, Q.Y);
    V t2 = FV::mul(P.Z, Q.Z);
    V t3 = FV::add(P.X, P.Y);
    V t4 = FV::add(Q.X, Q.Y);
    t3 = FV::mul(t3, t4);
    t4 = FV::add(t0, t1);
    t3 = FV::sub(t3, t4);
    t4 = FV::add(P.Y, P.Z);
    V X3 = FV::add(Q.Y, Q.Z);
    t4 = FV::mul(t4, X3);
    X3 = FV::add(t1, t2);
    t4 = FV::sub(t4, X3);
    X3 = FV::add(P.X, P.Z);
    V Y3 = FV::add(Q.X, Q.Z);
    X3 = FV::mul(X3, Y3);
    Y3 = FV::add(t0, t2);
    Y3 = FV::sub(X3, Y3);
    X3 = FV::add(t0, t0);
    t0 = FV::add(X3, t0);
    t2 = FV::mul_b3(t2);
    V Z3 = FV::add(t1, t2);
    t1 = FV::sub(t1, t2);
    Y3 = FV::mul_b3(Y3);
    X3 = FV::mul(t4, Y3);
    t2 = FV::mul(t3, t1);
    X3 = FV::sub(t2, X3);
    Y3 = FV::mul(Y3, t0);
    t1 = FV::mul(t1, Z3);
    Y3 = FV::add(t1, Y3);
    t0 = FV::mul(t0, t3);
    Z3 = FV::mul(Z3, t4);
    Z3 = FV::add(Z3, t0);
    return p8t<FV>{X3, Y3, Z3};
}

// fill ft.tab52 from the affine tables (x planes first, then y)
static void build_tab52_g1(fixed_tab<bg1, g1aff>& ft) {
    const size_t m = ft.tab.size();
    ft.tab52.assign(10 * m, 0);
    uint64_t l[5];
    for (size_t e = 0; e < m; e++) {
        bfq_to52(ft.tab[e].x, l);
        for (int i = 0; i < 5; i++) ft.tab52[i * m + e] = l[i];
        bfq_to52(ft.tab[e].y, l);
        for (int i = 0; i < 5; i++) ft.tab52[(5 + i) * m + e] = l[i];
    }
}
static void build_tab52_g2(fixed_tab<bg2, g2aff>& ft) {
    const size_t m = ft.tab.size();
    ft.tab52.assign(20 * m, 0);
    uint64_t l[5];
    for (size_t e = 0; e < m; e++) {
        const bfq* comps[4] = {&ft.tab[e].x.c0, &ft.tab[e].x.c1,
                               &ft.tab[e].y.c0, &ft.tab[e].y.c1};
        for (int k = 0; k < 4; k++) {
            bfq_to52(*comps[k], l);
            for (int i = 0; i < 5; i++) ft.tab52[(5 * k + i) * m + e] = l[i];
        }
    }
    // derive the twist constant 3*b' from a table point: b' = y^2 - x^3
    bfq2 x3 = bfq2_mul(bfq2_sq(ft.tab[0].x), ft.tab[0].x);
    bfq2 b = bfq2_sub(bfq2_sq(ft.tab[0].y), x3);
    bfq2 b3 = bfq2_add(bfq2_add(b, b), b);
    uint64_t c0[5], c1[5];
    bfq_to52(b3.c0, c0);
    bfq_to52(b3.c1, c1);
    G2_B3_VEC = bfq28{bfq8_set1_limbs(c0), bfq8_set1_limbs(c1)};
}

// Weighted bucket reduction sum_{d=1..H} d * bucket[d-1], 8 bucket segments
// in lanes: sum = sum_s [ W_s + s*L*T_s ] with W_s the in-segment weighted
// suffix sum and T_s the segment total, both accumulated with complete adds.
template <typename FV, typename PT, PT (*ADD)(const PT&, const PT&),
          PT (*DBL)(const PT&), PT (*INF)()>
static PT ca_reduce(const std::vector<uint64_t>& bpl, uint32_t H) {
    const int CP = FV::CP;
    const uint32_t L = H / 8;
    alignas(64) long long idx0[8];
    for (int s = 0; s < 8; s++) idx0[s] = (long long)(s * L);
    p8t<FV> running{FV::zero(), FV::one(), FV::zero()};
    p8t<FV> total = running;
    for (int64_t j = (int64_t)L - 1; j >= 0; j--) {
        __m512i idx = _mm512_add_epi64(_mm512_load_si512(idx0),
                                       _mm512_set1_epi64(j));
        p8t<FV> b;
        b.X = FV::gather(bpl.data(), H, idx);
        b.Y = FV::gather(bpl.data() + (size_t)CP * H, H, idx);
        b.Z = FV::gather(bpl.data() + 2 * (size_t)CP * H, H, idx);
        running = p8_add<FV>(running, b);
        total = p8_add<FV>(total, running);
    }
    // extract lanes: projective 52-domain -> scalar Jacobian (XZ, YZ^2, Z)
    PT T[8], W[8];
    for (int s = 0; s < 8; s++) {
        auto get = [&](const p8t<FV>& p) {
            typename FV::S X = FV::extract(p.X, s);
            typename FV::S Y = FV::extract(p.Y, s);
            typename FV::S Z = FV::extract(p.Z, s);
            return PT{FV::smul(X, Z), FV::smul(Y, FV::ssqr(Z)), Z};
        };
        T[s] = get(running);
        W[s] = get(total);
    }
    // sum_s W_s  +  L * sum_s s*T_s
    PT acc = INF(), stsum = INF(), wsum = INF();
    for (int s = 7; s >= 1; s--) {
        acc = ADD(acc, T[s]);
        stsum = ADD(stsum, acc);
    }
    for (int s = 0; s < 8; s++) wsum = ADD(wsum, W[s]);
    for (uint32_t v = L; v > 1; v >>= 1) stsum = DBL(stsum);
    return ADD(wsum, stsum);
}

// Accumulate windows [w_lo, w_hi) into H projective buckets with 8-lane
// complete adds, then reduce. digits = recode_signed array (n x nwin).
template <typename FV, typename PT, PT (*ADD)(const PT&, const PT&),
          PT (*DBL)(const PT&), PT (*INF)()>
static PT fixed_msm_ca_range(const std::vector<uint64_t>& tab52,
                             size_t tstride, uint64_t n, int nwin, int c,
                             const int16_t* digits, int w_lo, int w_hi) {
    const int CP = FV::CP;
    const uint32_t H = 1u << (c - 1);
    // counting-sort inserts by bucket (same scheme as ba_insert_range)
    struct Ins {
        uint32_t b;  // (bucket << 1) | negate
        uint32_t t;  // table index (w * n + i)
    };
    std::vector<Ins> all;
    all.reserve((size_t)(w_hi - w_lo) * n);
    std::vector<uint32_t> cnt(H + 1, 0);
    for (int w = w_lo; w < w_hi; w++) {
        const size_t row = (size_t)w * n;
        for (uint64_t i = 0; i < n; i++) {
            int16_t d = digits[(size_t)i * nwin + w];
            if (!d) continue;
            uint32_t b = d > 0 ? (uint32_t)d : (uint32_t)(-(int32_t)d);
            all.push_back(
                Ins{((b - 1) << 1) | (uint32_t)(d < 0), (uint32_t)(row + i)});
            cnt[b - 1]++;
        }
    }
    std::vector<uint32_t> off(H + 1, 0);
    uint32_t maxmult = 0;
    for (uint32_t b = 0; b < H; b++) {
        off[b + 1] = off[b] + cnt[b];
        if (cnt[b] > maxmult) maxmult = cnt[b];
    }
    std::vector<Ins> sorted(all.size());
    {
        std::vector<uint32_t> cursor(off.begin(), off.end() - 1);
        for (const Ins& e : all) sorted[cursor[e.b >> 1]++] = e;
    }
    std::vector<uint32_t> active;
    active.reserve(H);
    for (uint32_t b = 0; b < H; b++)
        if (cnt[b]) active.push_back(b);
    // bucket arena: 3*CP planes x H, identity (0:1:0) initialized.
    // Y = 1: limb planes 0-4 of the (first) field component carry one52,
    // any further component planes stay zero (Fq2's c1 of 1 is 0).
    std::vector<uint64_t> bpl(3 * (size_t)CP * H, 0);
    {
        uint64_t one52[5];
        bfq_to52(bfq_one(), one52);
        for (int p = 0; p < 5; p++)
            std::fill(bpl.begin() + ((size_t)CP + p) * H,
                      bpl.begin() + ((size_t)CP + p) * H + H, one52[p]);
    }
    alignas(64) long long bi[8], ti[8];
    alignas(64) uint64_t negbits[8];
    for (uint32_t round = 0; round < maxmult && !active.empty(); round++) {
        size_t na = 0, nper = active.size();
        for (size_t a0 = 0; a0 < nper; a0 += 8) {
            size_t gs = nper - a0 < 8 ? nper - a0 : 8;
            for (size_t k = 0; k < 8; k++) {
                const uint32_t b = active[a0 + (k < gs ? k : 0)];
                const Ins& e = sorted[off[b] + round];
                bi[k] = (long long)b;
                ti[k] = (long long)e.t;
                negbits[k] = (e.b & 1) ? ~0ULL : 0;
            }
            __m512i idxb = _mm512_load_si512(bi);
            __m512i idxt = _mm512_load_si512(ti);
            __mmask8 live = (__mmask8)((1u << gs) - 1);
            __mmask8 neg = _mm512_cmpneq_epi64_mask(
                _mm512_load_si512((const long long*)negbits),
                _mm512_setzero_si512());
            p8t<FV> P;
            P.X = FV::gather(bpl.data(), H, idxb);
            P.Y = FV::gather(bpl.data() + (size_t)CP * H, H, idxb);
            P.Z = FV::gather(bpl.data() + 2 * (size_t)CP * H, H, idxb);
            typename FV::V qx = FV::gather(tab52.data(), tstride, idxt);
            typename FV::V qy =
                FV::gather(tab52.data() + (size_t)CP * tstride, tstride, idxt);
            qy = FV::cneg(qy, neg);
            p8t<FV> R = p8_add_mixed<FV>(P, qx, qy);
            FV::scatter(bpl.data(), H, idxb, live, R.X);
            FV::scatter(bpl.data() + (size_t)CP * H, H, idxb, live, R.Y);
            FV::scatter(bpl.data() + 2 * (size_t)CP * H, H, idxb, live, R.Z);
        }
        for (size_t a = 0; a < nper; a++) {
            uint32_t b = active[a];
            if (round + 1 < cnt[b]) active[na++] = b;
        }
        active.resize(na);
    }
    return ca_reduce<FV, PT, ADD, DBL, INF>(bpl, H);
}
#endif  // ZKP_HAVE_BFQ8

// Window-range dispatch: IFMA complete-add kernel when compiled in and the
// 52-domain table exists, scalar batch-affine otherwise.
static inline bg1 g1_msm_range(const fixed_tab<bg1, g1aff>& ft,
                               const int16_t* digits, int w_lo, int w_hi) {
#ifdef ZKP_HAVE_BFQ8
    if (!ft.tab52.empty() && ft.c >= 4)
        return fixed_msm_ca_range<fv_g1, bg1, bg1_add, bg1_double, bg1_inf>(
            ft.tab52, ft.tab.size(), ft.n, ft.nwin, ft.c, digits, w_lo, w_hi);
#endif
    return fixed_msm_ba_range<bg1, g1aff, fq_ops, bg1_add, bg1_madd, bg1_inf>(
        ft, digits, w_lo, w_hi);
}
static inline bg2 g2_msm_range(const fixed_tab<bg2, g2aff>& ft,
                               const int16_t* digits, int w_lo, int w_hi) {
#ifdef ZKP_HAVE_BFQ8
    if (!ft.tab52.empty() && ft.c >= 4)
        return fixed_msm_ca_range<fv_g2, bg2, bg2_add, bg2_double, bg2_inf>(
            ft.tab52, ft.tab.size(), ft.n, ft.nwin, ft.c, digits, w_lo, w_hi);
#endif
    return fixed_msm_ba_range<bg2, g2aff, fq2_ops, bg2_add, bg2_madd, bg2_inf>(
        ft, digits, w_lo, w_hi);
}

// Whole-MSM entry: recode once, then accumulate (optionally in window
// chunks under OpenMP) and combine chunk sums.
template <typename PT, typename AF, typename FO,
          PT (*ADD)(const PT&, const PT&), PT (*MADD)(const PT&, const AF&),
          PT (*DBL)(const PT&), PT (*INF)()>
static PT fixed_msm_ba(const fixed_tab<PT, AF>& ft, const uint8_t* scalars,
                       int want_chunks = 0) {
    if (!ba_eligible<PT, AF, FO>(ft))
        return fixed_msm<PT, AF, ADD, MADD, DBL, INF>(ft, scalars, want_chunks);
    std::vector<int16_t> digits((size_t)ft.n * ft.nwin);
    recode_signed(scalars, ft.n, ft.c, ft.nwin, ft.is_inf, digits.data());
    int nchunks = 1;
#ifdef _OPENMP
    nchunks = want_chunks > 0 ? want_chunks : (ft.nwin >= 8 ? 2 : 1);
    if (nchunks > ft.nwin) nchunks = ft.nwin > 0 ? ft.nwin : 1;
#else
    (void)want_chunks;
#endif
    std::vector<PT> partial(nchunks);
#ifdef _OPENMP
#pragma omp parallel for schedule(static, 1)
#endif
    for (int chunk = 0; chunk < nchunks; chunk++) {
        int w_lo = chunk * ft.nwin / nchunks;
        int w_hi = (chunk + 1) * ft.nwin / nchunks;
        partial[chunk] = fixed_msm_ba_range<PT, AF, FO, ADD, MADD, INF>(
            ft, digits.data(), w_lo, w_hi);
    }
    PT acc = partial[0];
    for (int chunk = 1; chunk < nchunks; chunk++) acc = ADD(acc, partial[chunk]);
    return acc;
}

// Batch-of-MSMs over one fixed table, batch-affine per element (OpenMP
// across the batch; each element runs single-chunk like fixed_msm_many).
template <typename PT, typename AF, typename FO,
          PT (*ADD)(const PT&, const PT&), PT (*MADD)(const PT&, const AF&),
          PT (*DBL)(const PT&), PT (*INF)()>
void fixed_msm_many_ba(const fixed_tab<PT, AF>& ft, uint64_t batch,
                       const uint8_t* scalars, PT* out) {
#ifdef _OPENMP
#pragma omp parallel for schedule(dynamic, 1)
#endif
    for (uint64_t b = 0; b < batch; b++) {
        out[b] = fixed_msm_ba<PT, AF, FO, ADD, MADD, DBL, INF>(
            ft, scalars + b * 32 * ft.n, /*want_chunks=*/1);
    }
}

bool ge_is_inf(const ge& p) { return fe_iszero(p.Z); }
bool bg1_is_inf_f(const bg1& p) { return bfq_is_zero(p.Z); }
bool bg2_is_inf_f(const bg2& p) { return bfq2_is_zero(p.Z); }

std::deque<fixed_tab<ge, edniels>> ED_FIXED;
std::deque<fixed_tab<bg1, g1aff>> G1_FIXED;
std::deque<fixed_tab<bg2, g2aff>> G2_FIXED;

}  // namespace

extern "C" {

int zkp_ed_msm_register(uint64_t n, const uint8_t* points) {
    std::vector<ge> pts(n);
    for (uint64_t i = 0; i < n; i++) pts[i] = ge_from_wire(points + 128 * i);
    ED_FIXED.emplace_back();
    build_fixed<ge, edniels, ge_add, ge_madd, ge_double, ge_identity, ge_normalize, ge_is_inf>(
        ED_FIXED.back(), pts);
    return (int)ED_FIXED.size() - 1;
}

// scalars: n*32B LE (zeros allowed); out: 128B wire point
void zkp_ed_msm_fixed(int handle, const uint8_t* scalars, uint8_t* out) {
    ge r = fixed_msm<ge, edniels, ge_add, ge_madd, ge_double, ge_identity>(
        ED_FIXED[handle], scalars);
    ge_to_wire(r, out);
}

// nchunks: 0 auto, 1 serial, N window-chunks (see fixed_msm).
void zkp_ed_msm_fixed_mt(int handle, const uint8_t* scalars, uint8_t* out,
                         int nchunks) {
    ge r = fixed_msm<ge, edniels, ge_add, ge_madd, ge_double, ge_identity>(
        ED_FIXED[handle], scalars, nchunks);
    ge_to_wire(r, out);
}

// batch MSMs over one table: scalars = batch * n * 32B, out = batch * 128B.
void zkp_ed_msm_fixed_many(int handle, uint64_t batch, const uint8_t* scalars,
                           uint8_t* out) {
    std::vector<ge> res(batch);
    fixed_msm_many<ge, edniels, ge_add, ge_madd, ge_double, ge_identity>(
        ED_FIXED[handle], batch, scalars, res.data());
    for (uint64_t b = 0; b < batch; b++) ge_to_wire(res[b], out + 128 * b);
}

int zkp_bn254_g1_msm_register(uint64_t n, const uint8_t* points) {
    std::vector<bg1> pts(n);
    for (uint64_t i = 0; i < n; i++) pts[i] = bg1_from_wire(points + 96 * i);
    G1_FIXED.emplace_back();
    build_fixed<bg1, g1aff, bg1_add, bg1_madd, bg1_double, bg1_inf, bg1_normalize, bg1_is_inf_f>(
        G1_FIXED.back(), pts);
#ifdef ZKP_HAVE_BFQ8
    if (G1_FIXED.back().nwin > 0) build_tab52_g1(G1_FIXED.back());
#endif
    return (int)G1_FIXED.size() - 1;
}

// Whole-MSM G1 entry: like the generic fixed_msm_ba but window ranges run
// through g1_msm_range (IFMA complete-add kernel when available).
static bg1 g1_msm_whole(const fixed_tab<bg1, g1aff>& ft, const uint8_t* scalars,
                        int want_chunks = 0) {
    if (!ba_eligible<bg1, g1aff, fq_ops>(ft))
        return fixed_msm<bg1, g1aff, bg1_add, bg1_madd, bg1_double, bg1_inf>(
            ft, scalars, want_chunks);
    std::vector<int16_t> digits((size_t)ft.n * ft.nwin);
    recode_signed(scalars, ft.n, ft.c, ft.nwin, ft.is_inf, digits.data());
    int nchunks = 1;
#ifdef _OPENMP
    nchunks = want_chunks > 0 ? want_chunks : (ft.nwin >= 8 ? 2 : 1);
    if (nchunks > ft.nwin) nchunks = ft.nwin > 0 ? ft.nwin : 1;
#else
    (void)want_chunks;
#endif
    std::vector<bg1> partial(nchunks);
#ifdef _OPENMP
#pragma omp parallel for schedule(static, 1)
#endif
    for (int chunk = 0; chunk < nchunks; chunk++) {
        int w_lo = chunk * ft.nwin / nchunks;
        int w_hi = (chunk + 1) * ft.nwin / nchunks;
        partial[chunk] = g1_msm_range(ft, digits.data(), w_lo, w_hi);
    }
    bg1 acc = partial[0];
    for (int chunk = 1; chunk < nchunks; chunk++) acc = bg1_add(acc, partial[chunk]);
    return acc;
}

void zkp_bn254_g1_msm_fixed(int handle, const uint8_t* scalars, uint8_t* out) {
    bg1 r = g1_msm_whole(G1_FIXED[handle], scalars);
    bg1_to_wire(r, out);
}

void zkp_bn254_g1_msm_fixed_mt(int handle, const uint8_t* scalars, uint8_t* out,
                               int nchunks) {
    bg1 r = g1_msm_whole(G1_FIXED[handle], scalars, nchunks);
    bg1_to_wire(r, out);
}

void zkp_bn254_g1_msm_fixed_many(int handle, uint64_t batch,
                                 const uint8_t* scalars, uint8_t* out) {
    std::vector<bg1> res(batch);
#ifdef _OPENMP
#pragma omp parallel for schedule(dynamic, 1)
#endif
    for (uint64_t b = 0; b < batch; b++)
        res[b] = g1_msm_whole(G1_FIXED[handle],
                              scalars + b * 32 * G1_FIXED[handle].n,
                              /*want_chunks=*/1);
    for (uint64_t b = 0; b < batch; b++) bg1_to_wire(res[b], out + 96 * b);
}

int zkp_bn254_g2_msm_register(uint64_t n, const uint8_t* points) {
    std::vector<bg2> pts(n);
    for (uint64_t i = 0; i < n; i++) pts[i] = bg2_from_wire(points + 192 * i);
    G2_FIXED.emplace_back();
    build_fixed<bg2, g2aff, bg2_add, bg2_madd, bg2_double, bg2_inf, bg2_normalize, bg2_is_inf_f>(
        G2_FIXED.back(), pts);
#ifdef ZKP_HAVE_BFQ8
    if (G2_FIXED.back().nwin > 0) build_tab52_g2(G2_FIXED.back());
#endif
    return (int)G2_FIXED.size() - 1;
}

// Whole-MSM G2 entry mirroring g1_msm_whole (IFMA complete-add ranges).
static bg2 g2_msm_whole(const fixed_tab<bg2, g2aff>& ft, const uint8_t* scalars,
                        int want_chunks = 0) {
    if (!ba_eligible<bg2, g2aff, fq2_ops>(ft))
        return fixed_msm<bg2, g2aff, bg2_add, bg2_madd, bg2_double, bg2_inf>(
            ft, scalars, want_chunks);
    std::vector<int16_t> digits((size_t)ft.n * ft.nwin);
    recode_signed(scalars, ft.n, ft.c, ft.nwin, ft.is_inf, digits.data());
    int nchunks = 1;
#ifdef _OPENMP
    nchunks = want_chunks > 0 ? want_chunks : (ft.nwin >= 8 ? 2 : 1);
    if (nchunks > ft.nwin) nchunks = ft.nwin > 0 ? ft.nwin : 1;
#else
    (void)want_chunks;
#endif
    std::vector<bg2> partial(nchunks);
#ifdef _OPENMP
#pragma omp parallel for schedule(static, 1)
#endif
    for (int chunk = 0; chunk < nchunks; chunk++) {
        int w_lo = chunk * ft.nwin / nchunks;
        int w_hi = (chunk + 1) * ft.nwin / nchunks;
        partial[chunk] = g2_msm_range(ft, digits.data(), w_lo, w_hi);
    }
    bg2 acc = partial[0];
    for (int chunk = 1; chunk < nchunks; chunk++) acc = bg2_add(acc, partial[chunk]);
    return acc;
}

void zkp_bn254_g2_msm_fixed(int handle, const uint8_t* scalars, uint8_t* out) {
    bg2 r = g2_msm_whole(G2_FIXED[handle], scalars);
    bg2_to_wire(r, out);
}

void zkp_bn254_g2_msm_fixed_mt(int handle, const uint8_t* scalars, uint8_t* out,
                               int nchunks) {
    bg2 r = g2_msm_whole(G2_FIXED[handle], scalars, nchunks);
    bg2_to_wire(r, out);
}

void zkp_bn254_g2_msm_fixed_many(int handle, uint64_t batch,
                                 const uint8_t* scalars, uint8_t* out) {
    std::vector<bg2> res(batch);
#ifdef _OPENMP
#pragma omp parallel for schedule(dynamic, 1)
#endif
    for (uint64_t b = 0; b < batch; b++)
        res[b] = g2_msm_whole(G2_FIXED[handle],
                              scalars + b * 32 * G2_FIXED[handle].n,
                              /*want_chunks=*/1);
    for (uint64_t b = 0; b < batch; b++) bg2_to_wire(res[b], out + 192 * b);
}

}  // extern "C"

// ===========================================================================
// Groth16 h(x) pipeline: Az/Bz/Cz sparse matvec + 7 NTTs + coset scalings +
// pointwise combine, all in one native call (mirrors groth16._compute_h).
// ===========================================================================

namespace {

u256 mx_inv(const mctx& c, const u256& a_mont) {
    // binary extgcd on the Montgomery representation, then * R^2 twice
    u256 zero{{0, 0, 0, 0}};
    if (u256_cmp(a_mont, zero) == 0) return a_mont;
    u256 u = a_mont, v = c.q;
    u256 x1{{1, 0, 0, 0}}, x2{{0, 0, 0, 0}};
    u256 one{{1, 0, 0, 0}};
    while (u256_cmp(u, one) != 0 && u256_cmp(v, one) != 0) {
        while (u256_is_even(u)) {
            u256_shr1(u);
            if (u256_is_even(x1))
                u256_shr1(x1);
            else {
                uint64_t cy = u256_add(x1, x1, c.q);
                u256_shr1_carry(x1, cy);
            }
        }
        while (u256_is_even(v)) {
            u256_shr1(v);
            if (u256_is_even(x2))
                u256_shr1(x2);
            else {
                uint64_t cy = u256_add(x2, x2, c.q);
                u256_shr1_carry(x2, cy);
            }
        }
        if (u256_cmp(u, v) >= 0) {
            u256_sub(u, u, v);
            if (u256_sub(x1, x1, x2)) u256_add(x1, x1, c.q);
        } else {
            u256_sub(v, v, u);
            if (u256_sub(x2, x2, x1)) u256_add(x2, x2, c.q);
        }
    }
    u256 raw = (u256_cmp(u, one) == 0) ? x1 : x2;
    return mx_mul(c, mx_mul(c, raw, c.r2), c.r2);
}

// in-place NTT on Montgomery values; root_m is the size-n root (Montgomery).
// Per-stage twiddles are constant per (modulus, n, root), so they build once
// into a process cache: the per-butterfly `w *= wlen` update (n/2 * log n
// muls — half the NTT's multiplications) becomes a table read.
static std::map<std::vector<uint8_t>,
                std::shared_ptr<const std::vector<u256>>> NTT_TW_CACHE;
static std::mutex NTT_TW_MU;
// Keyed by caller-supplied (modulus, n, root) through the public zkp_ntt
// entry point, so the cache is capped: past the cap tables are built
// per-call and returned uncached (correct, just slower for that caller).
static constexpr size_t NTT_TW_CACHE_MAX = 64;

static std::shared_ptr<const std::vector<u256>> ntt_twiddles(
    const mctx& c, uint64_t n, const u256& root_m, int bits) {
    std::vector<uint8_t> key(72);
    std::memcpy(key.data(), c.q.v, 32);
    std::memcpy(key.data() + 32, &n, 8);
    std::memcpy(key.data() + 40, root_m.v, 32);
    {
        std::lock_guard<std::mutex> lk(NTT_TW_MU);
        auto it = NTT_TW_CACHE.find(key);
        if (it != NTT_TW_CACHE.end()) return it->second;
    }
    // build OUTSIDE the lock so concurrent NTTs never serialize on the O(n)
    // table construction; a racing builder just does redundant work once
    std::vector<u256> wlen(bits);
    if (bits > 0) {
        wlen[bits - 1] = root_m;
        for (int s = bits - 2; s >= 0; s--)
            wlen[s] = mx_mul(c, wlen[s + 1], wlen[s + 1]);
    }
    std::vector<u256> tw;
    tw.reserve(n > 0 ? n - 1 : 0);
    for (int s = 0; s < bits; s++) {
        uint64_t half = 1ULL << s;
        u256 w = c.one_m;
        for (uint64_t k = 0; k < half; k++) {
            tw.push_back(w);
            w = mx_mul(c, w, wlen[s]);
        }
    }
    auto sp = std::make_shared<const std::vector<u256>>(std::move(tw));
    std::lock_guard<std::mutex> lk(NTT_TW_MU);
    auto it = NTT_TW_CACHE.find(key);
    if (it != NTT_TW_CACHE.end()) return it->second;  // racing builder won
    if (NTT_TW_CACHE.size() < NTT_TW_CACHE_MAX)
        NTT_TW_CACHE.emplace(std::move(key), sp);
    return sp;
}

void ntt_mont(const mctx& c, std::vector<u256>& a, const u256& root_m) {
    uint64_t n = a.size();
    int bits = 0;
    while ((1ULL << bits) < n) bits++;
    for (uint64_t i = 0; i < n; i++) {
        uint64_t j = 0;
        for (int b = 0; b < bits; b++) j |= ((i >> b) & 1) << (bits - 1 - b);
        if (j > i) std::swap(a[i], a[j]);
    }
    auto tw_sp = ntt_twiddles(c, n, root_m, bits);
    const std::vector<u256>& tw = *tw_sp;
    size_t off = 0;
    for (int s = 0; s < bits; s++) {
        uint64_t length = 2ULL << s;
        uint64_t half = length >> 1;
        for (uint64_t start = 0; start < n; start += length) {
            for (uint64_t k = start; k < start + half; k++) {
                u256 u = a[k];
                u256 v = mx_mul(c, a[k + half], tw[off + (k - start)]);
                a[k] = mx_add(c, u, v);
                a[k + half] = mx_sub(c, u, v);
            }
        }
        off += half;
    }
}

u256 mx_from_u64(const mctx& c, uint64_t v) {
    u256 raw{{v, 0, 0, 0}};
    return mx_mul(c, raw, c.r2);
}

// sparse matvec rows: az[j] = sum idx/coeff over [ptr[j], ptr[j+1])
void spmv(const mctx& c, uint64_t rows, const uint32_t* ptr, const uint32_t* idx,
          const u256* coef_m, const u256* z_m, u256* out) {
    for (uint64_t j = 0; j < rows; j++) {
        u256 acc{{0, 0, 0, 0}};
        for (uint32_t t = ptr[j]; t < ptr[j + 1]; t++)
            acc = mx_add(c, acc, mx_mul(c, coef_m[t], z_m[idx[t]]));
        out[j] = acc;
    }
}

}  // namespace

extern "C" {

// Returns 0 on success, 1 if h has unexpected top coefficient (unsatisfied CS).
// spmv-only slice of the h-pipeline: az/bz/cz evaluation vectors (canonical
// bytes), for the DEVICE h-path which runs the 7 NTTs as one batched jit
// (libzkp_tpu/ops/groth16_device.py) while the irregular sparse part stays
// native.
int zkp_groth16_spmv(uint64_t n, uint64_t n_constraints, uint64_t n_instance,
                     uint64_t n_vars, const uint8_t* mod,
                     const uint32_t* a_ptr, const uint32_t* a_idx,
                     const uint8_t* a_coef, uint64_t a_nnz,
                     const uint32_t* b_ptr, const uint32_t* b_idx,
                     const uint8_t* b_coef, uint64_t b_nnz,
                     const uint32_t* c_ptr, const uint32_t* c_idx,
                     const uint8_t* c_coef, uint64_t c_nnz, const uint8_t* z,
                     uint8_t* az_out, uint8_t* bz_out, uint8_t* cz_out) {
    mctx c;
    mctx_init(c, mod);
    auto load_vec = [&](const uint8_t* src, uint64_t cnt) {
        std::vector<u256> v(cnt);
        for (uint64_t i = 0; i < cnt; i++) {
            u256 raw;
            std::memcpy(raw.v, src + 32 * i, 32);
            v[i] = mx_mul(c, raw, c.r2);
        }
        return v;
    };
    std::vector<u256> z_m = load_vec(z, n_vars);
    std::vector<u256> ac = load_vec(a_coef, a_nnz), bc = load_vec(b_coef, b_nnz),
                      cc = load_vec(c_coef, c_nnz);
    std::vector<u256> az(n, u256{{0, 0, 0, 0}}), bz(n, u256{{0, 0, 0, 0}}),
        cz(n, u256{{0, 0, 0, 0}});
    spmv(c, n_constraints, a_ptr, a_idx, ac.data(), z_m.data(), az.data());
    spmv(c, n_constraints, b_ptr, b_idx, bc.data(), z_m.data(), bz.data());
    spmv(c, n_constraints, c_ptr, c_idx, cc.data(), z_m.data(), cz.data());
    for (uint64_t i = 0; i < n_instance; i++) az[n_constraints + i] = z_m[i];
    u256 one_raw{{1, 0, 0, 0}};
    for (uint64_t i = 0; i < n; i++) {
        u256 a = mx_mul(c, az[i], one_raw), b = mx_mul(c, bz[i], one_raw),
             d = mx_mul(c, cz[i], one_raw);
        std::memcpy(az_out + 32 * i, a.v, 32);
        std::memcpy(bz_out + 32 * i, b.v, 32);
        std::memcpy(cz_out + 32 * i, d.v, 32);
    }
    return 0;
}

// Per-circuit constants for the h(x) pipeline, registered once per circuit
// (zkp_groth16_h_register) and addressed by handle: converted Montgomery
// coefficients, CSR structure, twiddle roots/inverses, and the coset power
// tables. Only z varies per zkp_groth16_h_run call.
struct g16h_cached {
    mctx c;
    uint64_t n = 0, n_constraints = 0, n_instance = 0, n_vars = 0;
    std::vector<uint32_t> a_ptr, a_idx, b_ptr, b_idx, c_ptr, c_idx;
    std::vector<u256> ac, bc, cc;
    u256 root_m, root_inv, n_inv, zinv;
    std::vector<u256> g_pows;        // g^i (Montgomery), i < n
    std::vector<u256> ninv_gi_pows;  // n^{-1} * g^{-i}, i < n
};
static std::deque<g16h_cached> G16H_CTXS;
static std::mutex G16H_MU;

int zkp_groth16_h_register(
    uint64_t n, uint64_t n_constraints, uint64_t n_instance, uint64_t n_vars,
    const uint8_t* mod, const uint8_t* root, const uint8_t* coset_g,
    const uint32_t* a_ptr, const uint32_t* a_idx, const uint8_t* a_coef,
    uint64_t a_nnz, const uint32_t* b_ptr, const uint32_t* b_idx,
    const uint8_t* b_coef, uint64_t b_nnz, const uint32_t* c_ptr,
    const uint32_t* c_idx, const uint8_t* c_coef, uint64_t c_nnz) {
    g16h_cached e;
    e.n = n;
    e.n_constraints = n_constraints;
    e.n_instance = n_instance;
    e.n_vars = n_vars;
    mctx_init(e.c, mod);
    const mctx& c = e.c;
    auto load_vec = [&](const uint8_t* src, uint64_t cnt) {
        std::vector<u256> v(cnt);
        for (uint64_t i = 0; i < cnt; i++) {
            u256 raw;
            std::memcpy(raw.v, src + 32 * i, 32);
            v[i] = mx_mul(c, raw, c.r2);
        }
        return v;
    };
    e.ac = load_vec(a_coef, a_nnz);
    e.bc = load_vec(b_coef, b_nnz);
    e.cc = load_vec(c_coef, c_nnz);
    e.a_ptr.assign(a_ptr, a_ptr + n_constraints + 1);
    e.a_idx.assign(a_idx, a_idx + a_nnz);
    e.b_ptr.assign(b_ptr, b_ptr + n_constraints + 1);
    e.b_idx.assign(b_idx, b_idx + b_nnz);
    e.c_ptr.assign(c_ptr, c_ptr + n_constraints + 1);
    e.c_idx.assign(c_idx, c_idx + c_nnz);
    {
        u256 raw;
        std::memcpy(raw.v, root, 32);
        e.root_m = mx_mul(c, raw, c.r2);
    }
    e.root_inv = mx_inv(c, e.root_m);
    e.n_inv = mx_inv(c, mx_from_u64(c, n));
    u256 g_m;
    {
        u256 raw;
        std::memcpy(raw.v, coset_g, 32);
        g_m = mx_mul(c, raw, c.r2);
    }
    u256 g_inv = mx_inv(c, g_m);
    e.g_pows.resize(n);
    e.ninv_gi_pows.resize(n);
    u256 pw = c.one_m, pwi = e.n_inv;
    for (uint64_t i = 0; i < n; i++) {
        e.g_pows[i] = pw;
        e.ninv_gi_pows[i] = pwi;
        pw = mx_mul(c, pw, g_m);
        pwi = mx_mul(c, pwi, g_inv);
    }
    u256 gn = mx_mul(c, e.g_pows[n - 1], g_m);  // g^n
    e.zinv = mx_inv(c, mx_sub(c, gn, c.one_m));
    std::lock_guard<std::mutex> lk(G16H_MU);
    G16H_CTXS.push_back(std::move(e));
    return (int)G16H_CTXS.size() - 1;
}

int zkp_groth16_h_run(int handle, const uint8_t* z, uint8_t* h_out) {
    const g16h_cached* ctx;
    {
        std::lock_guard<std::mutex> lk(G16H_MU);
        ctx = &G16H_CTXS[handle];  // deque nodes are reference-stable
    }
    const uint64_t n = ctx->n, n_constraints = ctx->n_constraints,
                   n_instance = ctx->n_instance, n_vars = ctx->n_vars;
    const uint32_t* a_ptr = ctx->a_ptr.data();
    const uint32_t* a_idx = ctx->a_idx.data();
    const uint32_t* b_ptr = ctx->b_ptr.data();
    const uint32_t* b_idx = ctx->b_idx.data();
    const uint32_t* c_ptr = ctx->c_ptr.data();
    const uint32_t* c_idx = ctx->c_idx.data();
    const mctx& c = ctx->c;
    std::vector<u256> z_m(n_vars);
    for (uint64_t i = 0; i < n_vars; i++) {
        u256 raw;
        std::memcpy(raw.v, z + 32 * i, 32);
        z_m[i] = mx_mul(c, raw, c.r2);
    }
    std::vector<u256> az(n, u256{{0, 0, 0, 0}}), bz(n, u256{{0, 0, 0, 0}}),
        cz(n, u256{{0, 0, 0, 0}});

    // interpolate: inverse NTT + n^{-1}; then evaluate on the coset g<w>
    auto interp = [&](std::vector<u256>& v) {
        ntt_mont(c, v, ctx->root_inv);
        for (auto& x : v) x = mx_mul(c, x, ctx->n_inv);
    };
    auto coset_eval = [&](std::vector<u256>& v) {
        for (uint64_t i = 0; i < n; i++) v[i] = mx_mul(c, v[i], ctx->g_pows[i]);
        ntt_mont(c, v, ctx->root_m);
    };
    // The three poly chains (spmv -> iNTT -> coset NTT) are independent:
    // span the cores here — this path is the serial half of a single Groth16
    // prove (the query MSMs are already window-parallel). Inside an outer
    // parallel region (batch provers) nested OMP is off and these sections
    // degrade to the serial order.
#ifdef _OPENMP
#pragma omp parallel sections num_threads(3) if (n >= 256)
#endif
    {
#ifdef _OPENMP
#pragma omp section
#endif
        {
            spmv(c, n_constraints, a_ptr, a_idx, ctx->ac.data(), z_m.data(),
                 az.data());
            for (uint64_t i = 0; i < n_instance; i++)
                az[n_constraints + i] = z_m[i];
            interp(az);
            coset_eval(az);
        }
#ifdef _OPENMP
#pragma omp section
#endif
        {
            spmv(c, n_constraints, b_ptr, b_idx, ctx->bc.data(), z_m.data(),
                 bz.data());
            interp(bz);
            coset_eval(bz);
        }
#ifdef _OPENMP
#pragma omp section
#endif
        {
            spmv(c, n_constraints, c_ptr, c_idx, ctx->cc.data(), z_m.data(),
                 cz.data());
            interp(cz);
            coset_eval(cz);
        }
    }
    // h_ev = (az*bz - cz) * (g^n - 1)^{-1}
    std::vector<u256>& h = az;
    for (uint64_t i = 0; i < n; i++)
        h[i] = mx_mul(c, mx_sub(c, mx_mul(c, az[i], bz[i]), cz[i]), ctx->zinv);
    // interpolate back off the coset: inverse NTT, scale by n^{-1} g^{-i}
    ntt_mont(c, h, ctx->root_inv);
    for (uint64_t i = 0; i < n; i++)
        h[i] = mx_mul(c, h[i], ctx->ninv_gi_pows[i]);
    u256 zero{{0, 0, 0, 0}};
    int rc = (u256_cmp(mx_mul(c, h[n - 1], u256{{1, 0, 0, 0}}), zero) == 0) ? 0 : 1;
    u256 one_raw{{1, 0, 0, 0}};
    for (uint64_t i = 0; i + 1 < n; i++) {
        u256 out = mx_mul(c, h[i], one_raw);
        std::memcpy(h_out + 32 * i, out.v, 32);
    }
    return rc;
}

}  // extern "C"

// ===========================================================================
// STARK improvement-proof fast path: the reference's whole winterfell prover
// for the fixed ImprovementAir (1 column x 8 rows, ProofOptions(32,8,0,
// None,8,31) — /root/reference/src/backend/stark.rs:87-186) runs natively:
// f128 NTT/LDE, Blake3 Merkle commitments, DEEP-ALI composition, the random
// coin, query openings and the winterfell 0.10 container. The pipeline is
// deterministic, so it is differentially pinned BYTE-EXACT against the
// Python model (models/stark.py) in tests/test_stark.py.
// ===========================================================================

namespace {

struct b3coin {  // models/random_coin.py RandomCoin (DefaultRandomCoin port)
    uint8_t seed[32];
    uint64_t counter = 0;

    void init(const uint8_t* material, uint64_t len) {
        zkp_blake3(material, len, seed);
        counter = 0;
    }
    void reseed(const uint8_t* digest) {
        uint8_t buf[64];
        std::memcpy(buf, seed, 32);
        std::memcpy(buf + 32, digest, 32);
        zkp_blake3(buf, 64, seed);
        counter = 0;
    }
    void next_digest(uint8_t out[32]) {
        counter++;
        uint8_t buf[40];
        std::memcpy(buf, seed, 32);
        std::memcpy(buf + 32, &counter, 8);
        zkp_blake3(buf, 40, out);
    }
};

// vint64 usize (winter-utils write_usize; see winterfell_wire.py)
static void wf_usize(std::vector<uint8_t>& out, uint64_t v) {
    for (int len = 1; len <= 8; len++) {
        if (v < (1ULL << (7 * len))) {
            uint64_t enc = (v << len) | (1ULL << (len - 1));
            for (int i = 0; i < len; i++) out.push_back((uint8_t)(enc >> (8 * i)));
            return;
        }
    }
    out.push_back(0);
    for (int i = 0; i < 8; i++) out.push_back((uint8_t)(v >> (8 * i)));
}

struct wf_tree {  // Blake3 Merkle tree over 32-byte leaves (power of two)
    std::vector<std::vector<uint8_t>> levels;  // levels[l]: digests * 32B

    void build(const std::vector<uint8_t>& leaves, int n) {
        levels.clear();
        levels.push_back(leaves);
        int width = n;
        while (width > 1) {
            const std::vector<uint8_t>& cur = levels.back();
            std::vector<uint8_t> nxt(32 * (width / 2));
            for (int i = 0; i < width / 2; i++)
                zkp_blake3(cur.data() + 64 * i, 64, nxt.data() + 32 * i);
            levels.push_back(std::move(nxt));
            width /= 2;
        }
    }
    const uint8_t* root() const { return levels.back().data(); }
    int depth() const { return (int)levels.size() - 1; }

    // winterfell_wire.batch_proof_nodes port (positions sorted ascending)
    void batch_nodes(const int* pos, int np, std::vector<uint8_t>& out) const {
        int d = depth();
        out.push_back((uint8_t)d);
        // coverage sets per level as bitmasks (leaf count <= 64 here)
        std::vector<uint64_t> cov(d + 1, 0);
        for (int i = 0; i < np; i++) cov[0] |= 1ULL << pos[i];
        for (int l = 0; l < d; l++) {
            uint64_t c = cov[l], up = 0;
            while (c) {
                int b = __builtin_ctzll(c);
                c &= c - 1;
                up |= 1ULL << (b >> 1);
            }
            cov[l + 1] = up;
        }
        std::vector<uint64_t> emitted(d, 0);
        for (int i = 0; i < np; i++) {
            size_t cnt_at = out.size();
            out.push_back(0);
            int idx = pos[i], cnt = 0;
            for (int l = 0; l < d; l++) {
                int sib = idx ^ 1;
                if (!((cov[l] >> sib) & 1) && !((emitted[l] >> sib) & 1)) {
                    const uint8_t* node = levels[l].data() + 32 * sib;
                    out.insert(out.end(), node, node + 32);
                    emitted[l] |= 1ULL << sib;
                    cnt++;
                }
                idx >>= 1;
            }
            out[cnt_at] = (uint8_t)cnt;
        }
    }
};

// f128 helpers over the generic Montgomery machinery (mctx / u256)
static u256 f128_from_u64(const mctx& c, uint64_t v) {
    u256 raw{{v, 0, 0, 0}};
    return mx_mul(c, raw, c.r2);
}

static void f128_to_bytes(const mctx& c, const u256& m, uint8_t out[16]) {
    u256 one_raw{{1, 0, 0, 0}};
    u256 v = mx_mul(c, m, one_raw);
    std::memcpy(out, v.v, 16);
}

static u256 f128_from_bytes(const mctx& c, const uint8_t* b) {
    u256 raw{{0, 0, 0, 0}};
    std::memcpy(raw.v, b, 16);
    return mx_mul(c, raw, c.r2);
}

// draw a field element (models/random_coin.py draw_felt: rejection on 16B LE)
static u256 coin_draw_felt(b3coin& coin, const mctx& c, const uint8_t* mod16) {
    for (int tries = 0; tries < 1000; tries++) {
        uint8_t h[32];
        coin.next_digest(h);
        // compare h[:16] (LE) < modulus
        bool less = false;
        for (int i = 15; i >= 0; i--) {
            if (h[i] < mod16[i]) { less = true; break; }
            if (h[i] > mod16[i]) break;
        }
        if (less) return f128_from_bytes(c, h);
    }
    return u256{{0, 0, 0, 0}};  // unreachable in practice
}

// Full prover for one (old, new) pair. out must hold >= 8192 bytes.
// Returns the proof length, or -1 on constraint failure.
static int stark_improve_one(const mctx& c, const uint8_t* mod32,
                             const u256& root64_m, uint64_t old_v,
                             uint64_t new_v, const uint8_t* ctx_bytes,
                             uint64_t ctx_len, uint8_t* out_buf) {
    const int n = 8, N = 64, NQ = 32, REM = 32;
    const uint8_t* mod16 = mod32;  // f128 modulus fits 16 bytes
    u256 zero{{0, 0, 0, 0}};

    // domain constants
    u256 root64_inv = mx_inv(c, root64_m);
    u256 root8_m = root64_m;  // root8 = root64^8: three squarings
    for (int i = 0; i < 3; i++) root8_m = mx_mul(c, root8_m, root8_m);
    u256 root8_inv = mx_inv(c, root8_m);
    u256 n_inv = mx_inv(c, f128_from_u64(c, n));
    u256 N_inv = mx_inv(c, f128_from_u64(c, N));
    u256 offset = f128_from_u64(c, 3);  // DOMAIN_OFFSET
    u256 offset_inv = mx_inv(c, offset);

    // trace: t[0] = old, t[i+1] = t[i] + step, step = (new-old)/7
    u256 old_m = f128_from_u64(c, old_v), new_m = f128_from_u64(c, new_v);
    u256 step = mx_mul(c, mx_sub(c, new_m, old_m),
                       mx_inv(c, f128_from_u64(c, 7)));
    std::vector<u256> trace(n);
    trace[0] = old_m;
    for (int i = 1; i < n; i++) trace[i] = mx_add(c, trace[i - 1], step);

    // trace poly + LDE
    std::vector<u256> tp = trace;
    ntt_mont(c, tp, root8_inv);
    for (auto& x : tp) x = mx_mul(c, x, n_inv);
    std::vector<u256> tl(N, zero);
    {
        u256 pw = c.one_m;
        for (int i = 0; i < n; i++) {
            tl[i] = mx_mul(c, tp[i], pw);
            pw = mx_mul(c, pw, offset);
        }
        ntt_mont(c, tl, root64_m);
    }

    // trace commitment
    std::vector<uint8_t> t_leaves(32 * N);
    for (int r = 0; r < N; r++) {
        uint8_t e[16];
        f128_to_bytes(c, tl[r], e);
        zkp_blake3(e, 16, t_leaves.data() + 32 * r);
    }
    wf_tree t_tree;
    t_tree.build(t_leaves, N);

    b3coin coin;
    coin.init(ctx_bytes, ctx_len);
    coin.reseed(t_tree.root());
    u256 alpha = coin_draw_felt(coin, c, mod16);
    u256 beta0 = coin_draw_felt(coin, c, mod16);
    u256 beta1 = coin_draw_felt(coin, c, mod16);

    // composition evaluations over the LDE domain
    std::vector<u256> xs(N);
    {
        u256 x = offset;
        u256 gN = root64_m;
        for (int r = 0; r < N; r++) {
            xs[r] = x;
            x = mx_mul(c, x, gN);
        }
    }
    u256 exemption = c.one_m;  // g8^(n-1)
    {
        u256 g = root8_m;
        for (int i = 0; i < n - 1; i++) exemption = mx_mul(c, exemption, g);
    }
    std::vector<u256> comp(N);
    std::vector<u256> den0(N), den1(N), denz(N);
    u256 g8_0 = c.one_m;                // g8^0 (assertion step 0)
    u256 g8_7 = exemption;              // g8^7 (assertion step 7)
    for (int r = 0; r < N; r++) {
        // x^n - 1 via 3 squarings
        u256 xn = xs[r];
        for (int m = n; m > 1; m >>= 1) xn = mx_mul(c, xn, xn);
        denz[r] = mx_sub(c, xn, c.one_m);
        den0[r] = mx_sub(c, xs[r], g8_0);
        den1[r] = mx_sub(c, xs[r], g8_7);
    }
    // batch inversion of the three denominator vectors
    std::vector<u256> all(3 * N);
    for (int r = 0; r < N; r++) {
        all[r] = denz[r];
        all[N + r] = den0[r];
        all[2 * N + r] = den1[r];
    }
    {
        std::vector<u256> pref(3 * N);
        u256 run = c.one_m;
        for (int i = 0; i < 3 * N; i++) {
            run = mx_mul(c, run, all[i]);
            pref[i] = run;
        }
        u256 inv = mx_inv(c, run);
        for (int i = 3 * N; i-- > 0;) {
            u256 x_inv = (i == 0) ? inv : mx_mul(c, inv, pref[i - 1]);
            inv = mx_mul(c, inv, all[i]);
            all[i] = x_inv;
        }
    }
    for (int r = 0; r < N; r++) {
        u256 cur = tl[r];
        u256 nxt = tl[(r + 8) % N];  // blowup = 8
        u256 tr = mx_sub(c, mx_sub(c, nxt, cur), step);
        u256 zinv = mx_mul(c, all[r], mx_sub(c, xs[r], exemption));
        u256 acc = mx_mul(c, mx_mul(c, alpha, tr), zinv);
        acc = mx_add(c, acc,
                     mx_mul(c, mx_mul(c, beta0, mx_sub(c, cur, old_m)),
                            all[N + r]));
        acc = mx_add(c, acc,
                     mx_mul(c, mx_mul(c, beta1, mx_sub(c, cur, new_m)),
                            all[2 * N + r]));
        comp[r] = acc;
    }
    // interpolate off the coset: iNTT + N^{-1} + offset^{-i}
    std::vector<u256> cc = comp;
    ntt_mont(c, cc, root64_inv);
    {
        u256 pw = c.one_m;
        for (int i = 0; i < N; i++) {
            cc[i] = mx_mul(c, mx_mul(c, cc[i], N_inv), pw);
            pw = mx_mul(c, pw, offset_inv);
        }
    }
    // degree < k*n = 8: take chunk 0, pad, evaluate back on the coset
    std::vector<u256> ch(cc.begin(), cc.begin() + n);
    std::vector<u256> cl(N, zero);
    {
        u256 pw = c.one_m;
        for (int i = 0; i < n; i++) {
            cl[i] = mx_mul(c, ch[i], pw);
            pw = mx_mul(c, pw, offset);
        }
        ntt_mont(c, cl, root64_m);
    }
    std::vector<uint8_t> c_leaves(32 * N);
    for (int r = 0; r < N; r++) {
        uint8_t e[16];
        f128_to_bytes(c, cl[r], e);
        zkp_blake3(e, 16, c_leaves.data() + 32 * r);
    }
    wf_tree c_tree;
    c_tree.build(c_leaves, N);
    coin.reseed(c_tree.root());

    // OOD evaluations at z / zg
    u256 z = coin_draw_felt(coin, c, mod16);
    u256 zg = mx_mul(c, z, root8_m);
    auto horner = [&](const std::vector<u256>& p, int deg_n, const u256& at) {
        u256 acc = zero;
        for (int i = deg_n - 1; i >= 0; i--)
            acc = mx_add(c, mx_mul(c, acc, at), p[i]);
        return acc;
    };
    u256 ood_cur = horner(tp, n, z);
    u256 ood_nxt = horner(tp, n, zg);
    u256 ood_comp = horner(ch, n, z);
    {
        uint8_t buf[48];
        f128_to_bytes(c, ood_cur, buf);
        f128_to_bytes(c, ood_nxt, buf + 16);
        f128_to_bytes(c, ood_comp, buf + 32);
        uint8_t dg[32];
        zkp_blake3(buf, 48, dg);
        coin.reseed(dg);
    }
    u256 g0 = coin_draw_felt(coin, c, mod16);
    u256 g1 = coin_draw_felt(coin, c, mod16);
    u256 g2 = coin_draw_felt(coin, c, mod16);

    // DEEP composition over the LDE domain
    std::vector<u256> ixz(N), ixzg(N);
    for (int r = 0; r < N; r++) {
        ixz[r] = mx_sub(c, xs[r], z);
        ixzg[r] = mx_sub(c, xs[r], zg);
    }
    {
        std::vector<u256> both(2 * N);
        for (int r = 0; r < N; r++) {
            both[r] = ixz[r];
            both[N + r] = ixzg[r];
        }
        std::vector<u256> pref(2 * N);
        u256 run = c.one_m;
        for (int i = 0; i < 2 * N; i++) {
            run = mx_mul(c, run, both[i]);
            pref[i] = run;
        }
        u256 inv = mx_inv(c, run);
        for (int i = 2 * N; i-- > 0;) {
            u256 x_inv = (i == 0) ? inv : mx_mul(c, inv, pref[i - 1]);
            inv = mx_mul(c, inv, both[i]);
            both[i] = x_inv;
        }
        for (int r = 0; r < N; r++) {
            ixz[r] = both[r];
            ixzg[r] = both[N + r];
        }
    }
    std::vector<u256> deep(N);
    for (int r = 0; r < N; r++) {
        u256 acc = mx_mul(c, mx_mul(c, g0, mx_sub(c, tl[r], ood_cur)), ixz[r]);
        acc = mx_add(
            c, acc,
            mx_mul(c, mx_mul(c, g1, mx_sub(c, tl[r], ood_nxt)), ixzg[r]));
        acc = mx_add(
            c, acc,
            mx_mul(c, mx_mul(c, g2, mx_sub(c, cl[r], ood_comp)), ixz[r]));
        deep[r] = acc;
    }

    // FRI: zero layers at these options; remainder = off-coset interpolation
    std::vector<u256> rem = deep;
    ntt_mont(c, rem, root64_inv);
    {
        u256 pw = c.one_m;
        for (int i = 0; i < N; i++) {
            rem[i] = mx_mul(c, mx_mul(c, rem[i], N_inv), pw);
            pw = mx_mul(c, pw, offset_inv);
        }
    }
    for (int i = REM; i < N; i++)
        if (u256_cmp(mx_mul(c, rem[i], u256{{1, 0, 0, 0}}), zero) != 0)
            return -1;  // FRI remainder degree too high: not a valid witness
    {
        std::vector<uint8_t> buf(16 * REM);
        for (int i = 0; i < REM; i++)
            f128_to_bytes(c, rem[i], buf.data() + 16 * i);
        uint8_t dg[32];
        zkp_blake3(buf.data(), buf.size(), dg);
        coin.reseed(dg);
    }

    // PoW (grinding 0 -> nonce 0) + query positions
    uint64_t nonce = 0;
    {
        uint8_t nb[8] = {0};
        uint8_t dg[32];
        zkp_blake3(nb, 8, dg);
        coin.reseed(dg);
    }
    int positions[NQ];
    int npos = 0;
    {
        uint64_t seen = 0;
        for (int tries = 0; tries < 1000 && npos < NQ; tries++) {
            uint8_t h[32];
            coin.next_digest(h);
            uint64_t v;
            std::memcpy(&v, h, 8);
            int q = (int)(v & (N - 1));
            if (!((seen >> q) & 1)) {
                seen |= 1ULL << q;
                positions[npos++] = q;
            }
        }
        std::sort(positions, positions + npos);
    }

    // ---- winterfell container emission ----
    std::vector<uint8_t> o;
    o.reserve(8192);
    // Context: TraceInfo + modulus + options (see winterfell_wire.py)
    wf_usize(o, 1);   // main segment width
    wf_usize(o, 0);   // aux width
    wf_usize(o, 0);   // aux rands
    wf_usize(o, n);   // trace length
    o.push_back(0);   // meta len u16
    o.push_back(0);
    o.push_back(16);  // modulus byte length
    o.insert(o.end(), mod32, mod32 + 16);
    const uint8_t opts[8] = {NQ, 8, 0, 1, 8, 31, 1, 1};
    o.insert(o.end(), opts, opts + 8);
    o.push_back((uint8_t)npos);  // num_unique_queries
    // Commitments
    wf_usize(o, 64);
    o.insert(o.end(), t_tree.root(), t_tree.root() + 32);
    o.insert(o.end(), c_tree.root(), c_tree.root() + 32);
    // trace queries: Vec<Queries> of 1
    wf_usize(o, 1);
    auto emit_queries = [&](const wf_tree& tree, const std::vector<u256>& lde) {
        std::vector<uint8_t> paths;
        tree.batch_nodes(positions, npos, paths);
        wf_usize(o, paths.size());
        o.insert(o.end(), paths.begin(), paths.end());
        wf_usize(o, (uint64_t)16 * npos);
        for (int i = 0; i < npos; i++) {
            uint8_t e[16];
            f128_to_bytes(c, lde[positions[i]], e);
            o.insert(o.end(), e, e + 16);
        }
    };
    emit_queries(t_tree, tl);
    emit_queries(c_tree, cl);
    // OOD frame
    wf_usize(o, 32);
    {
        uint8_t e[16];
        f128_to_bytes(c, ood_cur, e);
        o.insert(o.end(), e, e + 16);
        f128_to_bytes(c, ood_nxt, e);
        o.insert(o.end(), e, e + 16);
    }
    wf_usize(o, 16);
    {
        uint8_t e[16];
        f128_to_bytes(c, ood_comp, e);
        o.insert(o.end(), e, e + 16);
    }
    // FRI proof: zero layers, remainder, partitions
    wf_usize(o, 0);
    wf_usize(o, (uint64_t)16 * REM);
    for (int i = 0; i < REM; i++) {
        uint8_t e[16];
        f128_to_bytes(c, rem[i], e);
        o.insert(o.end(), e, e + 16);
    }
    o.push_back(1);
    for (int i = 0; i < 8; i++) o.push_back((uint8_t)(nonce >> (8 * i)));
    std::memcpy(out_buf, o.data(), o.size());
    return (int)o.size();
}

// vint64 reader; returns false on truncation
static bool wf_read_usize(const uint8_t* d, size_t len, size_t& pos,
                          uint64_t& out) {
    if (pos >= len) return false;
    uint8_t first = d[pos];
    if (first == 0) {
        if (pos + 9 > len) return false;
        std::memcpy(&out, d + pos + 1, 8);
        pos += 9;
        return true;
    }
    int l = __builtin_ctz(first) + 1;
    if (pos + l > (int64_t)len) return false;
    uint64_t enc = 0;
    std::memcpy(&enc, d + pos, l < 8 ? l : 8);
    out = enc >> l;
    pos += l;
    return true;
}

// Verifier twin of stark_improve_one; mirrors models/stark.py _verify_inner
// for the fixed ImprovementAir shape. Returns 1 accept / 0 reject; never
// faults on malformed input (every read is bounds-checked).
static int stark_verify_one(const mctx& c, const uint8_t* mod32,
                            const u256& root64_m, uint64_t old_v,
                            uint64_t new_v, const uint8_t* ctx_bytes,
                            uint64_t ctx_len, const uint8_t* pf, size_t plen) {
    const int n = 8, N = 64, REM = 32;
    const uint8_t* mod16 = mod32;
    u256 zero{{0, 0, 0, 0}};
    size_t pos = 0;
    uint64_t v;
    // context: TraceInfo(1, 0, 0, 8) + meta(0) + modulus + options
    if (!wf_read_usize(pf, plen, pos, v) || v != 1) return 0;
    if (!wf_read_usize(pf, plen, pos, v) || v != 0) return 0;
    if (!wf_read_usize(pf, plen, pos, v) || v != 0) return 0;
    if (!wf_read_usize(pf, plen, pos, v) || v != (uint64_t)n) return 0;
    if (pos + 2 > plen || pf[pos] || pf[pos + 1]) return 0;
    pos += 2;
    if (pos + 1 > plen || pf[pos] != 16) return 0;
    pos += 1;
    if (pos + 16 > plen || std::memcmp(pf + pos, mod16, 16)) return 0;
    pos += 16;
    static const uint8_t OPTS[8] = {32, 8, 0, 1, 8, 31, 1, 1};
    if (pos + 8 > plen || std::memcmp(pf + pos, OPTS, 8)) return 0;
    pos += 8;
    if (pos + 1 > plen) return 0;
    int npos = pf[pos++];
    if (npos < 1 || npos > 32) return 0;
    // commitments
    if (!wf_read_usize(pf, plen, pos, v) || v != 64 || pos + 64 > plen) return 0;
    const uint8_t* t_root = pf + pos;
    const uint8_t* c_root = pf + pos + 32;
    pos += 64;
    // trace queries (one segment)
    if (!wf_read_usize(pf, plen, pos, v) || v != 1) return 0;
    uint64_t tp_len, tv_len, cp_len, cv_len;
    if (!wf_read_usize(pf, plen, pos, tp_len) || pos + tp_len > plen) return 0;
    const uint8_t* t_paths = pf + pos;
    pos += tp_len;
    if (!wf_read_usize(pf, plen, pos, tv_len) || pos + tv_len > plen) return 0;
    const uint8_t* t_vals = pf + pos;
    pos += tv_len;
    if (!wf_read_usize(pf, plen, pos, cp_len) || pos + cp_len > plen) return 0;
    const uint8_t* c_paths = pf + pos;
    pos += cp_len;
    if (!wf_read_usize(pf, plen, pos, cv_len) || pos + cv_len > plen) return 0;
    const uint8_t* c_vals = pf + pos;
    pos += cv_len;
    if (tv_len != (uint64_t)16 * npos || cv_len != (uint64_t)16 * npos) return 0;
    // OOD frame
    if (!wf_read_usize(pf, plen, pos, v) || v != 32 || pos + 32 > plen) return 0;
    const uint8_t* ood_b = pf + pos;
    pos += 32;
    if (!wf_read_usize(pf, plen, pos, v) || v != 16 || pos + 16 > plen) return 0;
    const uint8_t* oodc_b = pf + pos;
    pos += 16;
    // FRI: zero layers, remainder, partitions
    if (!wf_read_usize(pf, plen, pos, v) || v != 0) return 0;
    if (!wf_read_usize(pf, plen, pos, v) || v != (uint64_t)16 * REM) return 0;
    if (pos + 16 * REM > plen) return 0;
    const uint8_t* rem_b = pf + pos;
    pos += 16 * REM;
    if (pos + 1 > plen || pf[pos] != 1) return 0;
    pos += 1;
    if (pos + 8 != plen) return 0;
    uint64_t nonce;
    std::memcpy(&nonce, pf + pos, 8);

    // canonical field-element loads (reject >= modulus)
    auto load_felt = [&](const uint8_t* b, u256& out) {
        u256 raw{{0, 0, 0, 0}};
        std::memcpy(raw.v, b, 16);
        u256 m{{0, 0, 0, 0}};
        std::memcpy(m.v, mod16, 16);
        if (u256_cmp(raw, m) >= 0) return false;
        out = mx_mul(c, raw, c.r2);
        return true;
    };
    u256 ood_cur, ood_nxt, ood_comp;
    if (!load_felt(ood_b, ood_cur) || !load_felt(ood_b + 16, ood_nxt) ||
        !load_felt(oodc_b, ood_comp))
        return 0;
    std::vector<u256> rem(REM);
    for (int i = 0; i < REM; i++)
        if (!load_felt(rem_b + 16 * i, rem[i])) return 0;
    std::vector<u256> t_rows(npos), c_rows(npos);
    for (int i = 0; i < npos; i++) {
        if (!load_felt(t_vals + 16 * i, t_rows[i])) return 0;
        if (!load_felt(c_vals + 16 * i, c_rows[i])) return 0;
    }

    // coin replay
    b3coin coin;
    coin.init(ctx_bytes, ctx_len);
    coin.reseed(t_root);
    u256 alpha = coin_draw_felt(coin, c, mod16);
    u256 beta0 = coin_draw_felt(coin, c, mod16);
    u256 beta1 = coin_draw_felt(coin, c, mod16);
    coin.reseed(c_root);
    u256 z = coin_draw_felt(coin, c, mod16);
    u256 root8_m = root64_m;
    for (int i = 0; i < 3; i++) root8_m = mx_mul(c, root8_m, root8_m);
    u256 zg = mx_mul(c, z, root8_m);
    {
        uint8_t buf[48];
        std::memcpy(buf, ood_b, 32);
        std::memcpy(buf + 32, oodc_b, 16);
        uint8_t dg[32];
        zkp_blake3(buf, 48, dg);
        coin.reseed(dg);
    }
    u256 g0 = coin_draw_felt(coin, c, mod16);
    u256 g1 = coin_draw_felt(coin, c, mod16);
    u256 g2 = coin_draw_felt(coin, c, mod16);
    {
        uint8_t dg[32];
        zkp_blake3(rem_b, 16 * REM, dg);
        coin.reseed(dg);
    }
    // grinding factor 0: any nonce passes the PoW check
    {
        uint8_t nb[8];
        std::memcpy(nb, &nonce, 8);
        uint8_t dg[32];
        zkp_blake3(nb, 8, dg);
        coin.reseed(dg);
    }
    int positions[32];
    int np = 0;
    {
        uint64_t seen = 0;
        for (int tries = 0; tries < 1000 && np < 32; tries++) {
            uint8_t h[32];
            coin.next_digest(h);
            uint64_t w;
            std::memcpy(&w, h, 8);
            int q = (int)(w & (N - 1));
            if (!((seen >> q) & 1)) {
                seen |= 1ULL << q;
                positions[np++] = q;
            }
        }
        std::sort(positions, positions + np);
    }
    if (np != npos) return 0;

    // OOD constraint check (the ALI equation)
    u256 old_m = f128_from_u64(c, old_v), new_m = f128_from_u64(c, new_v);
    u256 step = mx_mul(c, mx_sub(c, new_m, old_m),
                       mx_inv(c, f128_from_u64(c, 7)));
    u256 exemption = c.one_m;
    for (int i = 0; i < n - 1; i++) exemption = mx_mul(c, exemption, root8_m);
    u256 zn = z;
    for (int m = n; m > 1; m >>= 1) zn = mx_mul(c, zn, zn);
    u256 znm1 = mx_sub(c, zn, c.one_m);
    if (u256_cmp(mx_mul(c, znm1, u256{{1, 0, 0, 0}}), zero) == 0) return 0;
    u256 den0 = mx_sub(c, z, c.one_m);           // z - g^0
    u256 den1 = mx_sub(c, z, exemption);         // z - g^7
    if (u256_cmp(mx_mul(c, den0, u256{{1, 0, 0, 0}}), zero) == 0) return 0;
    if (u256_cmp(mx_mul(c, den1, u256{{1, 0, 0, 0}}), zero) == 0) return 0;
    u256 t_ev = mx_sub(c, mx_sub(c, ood_nxt, ood_cur), step);
    u256 zinv = mx_mul(c, mx_inv(c, znm1), mx_sub(c, z, exemption));
    u256 acc = mx_mul(c, mx_mul(c, alpha, t_ev), zinv);
    acc = mx_add(c, acc, mx_mul(c, mx_mul(c, beta0, mx_sub(c, ood_cur, old_m)),
                                mx_inv(c, den0)));
    acc = mx_add(c, acc, mx_mul(c, mx_mul(c, beta1, mx_sub(c, ood_cur, new_m)),
                                mx_inv(c, den1)));
    if (u256_cmp(mx_mul(c, mx_sub(c, acc, ood_comp), u256{{1, 0, 0, 0}}),
                 zero) != 0)
        return 0;

    // batched Merkle openings (dual of wf_tree::batch_nodes)
    auto verify_batch = [&](const uint8_t* root, const uint8_t* paths,
                            uint64_t paths_len, const u256* rows) {
        const int depth = 6;
        if (paths_len < 1 || paths[0] != depth) return false;
        // leaf digests
        uint8_t known[7][64][32];
        uint64_t have[7] = {0, 0, 0, 0, 0, 0, 0};
        for (int i = 0; i < np; i++) {
            uint8_t e[16];
            f128_to_bytes(c, rows[i], e);
            zkp_blake3(e, 16, known[0][positions[i]]);
            have[0] |= 1ULL << positions[i];
        }
        uint64_t cov[7];
        cov[0] = have[0];
        for (int l = 0; l < depth; l++) {
            uint64_t cc = cov[l], up = 0;
            while (cc) {
                int b = __builtin_ctzll(cc);
                cc &= cc - 1;
                up |= 1ULL << (b >> 1);
            }
            cov[l + 1] = up;
        }
        size_t pp = 1;
        uint64_t emitted[7] = {0, 0, 0, 0, 0, 0, 0};
        for (int i = 0; i < np; i++) {
            if (pp >= paths_len) return false;
            int cnt = paths[pp++];
            int idx = positions[i];
            for (int l = 0; l < depth; l++) {
                int sib = idx ^ 1;
                if (!((cov[l] >> sib) & 1) && !((emitted[l] >> sib) & 1)) {
                    if (cnt <= 0 || pp + 32 > paths_len) return false;
                    std::memcpy(known[l][sib], paths + pp, 32);
                    pp += 32;
                    cnt--;
                    emitted[l] |= 1ULL << sib;
                    have[l] |= 1ULL << sib;
                }
                idx >>= 1;
            }
            if (cnt != 0) return false;
        }
        if (pp != paths_len) return false;
        for (int l = 0; l < depth; l++) {
            uint64_t cc = have[l];
            while (cc) {
                int b = __builtin_ctzll(cc);
                cc &= cc - 1;
                if (b & 1) continue;
                if ((have[l] >> (b + 1)) & 1) {
                    uint8_t buf[64];
                    std::memcpy(buf, known[l][b], 32);
                    std::memcpy(buf + 32, known[l][b + 1], 32);
                    zkp_blake3(buf, 64, known[l + 1][b >> 1]);
                    have[l + 1] |= 1ULL << (b >> 1);
                }
            }
        }
        return ((have[depth] >> 0) & 1) &&
               std::memcmp(known[depth][0], root, 32) == 0;
    };
    if (!verify_batch(t_root, t_paths, tp_len, t_rows.data())) return 0;
    if (!verify_batch(c_root, c_paths, cp_len, c_rows.data())) return 0;

    // DEEP values at query positions must equal the remainder polynomial
    u256 offset = f128_from_u64(c, 3);
    for (int i = 0; i < npos; i++) {
        int q = positions[i];
        u256 xq = offset;
        {
            u256 g = root64_m;
            for (int b = 0; b < 6; b++) {
                if ((q >> b) & 1) xq = mx_mul(c, xq, g);
                g = mx_mul(c, g, g);
            }
        }
        u256 dz = mx_sub(c, xq, z), dzg = mx_sub(c, xq, zg);
        if (u256_cmp(mx_mul(c, dz, u256{{1, 0, 0, 0}}), zero) == 0) return 0;
        if (u256_cmp(mx_mul(c, dzg, u256{{1, 0, 0, 0}}), zero) == 0) return 0;
        u256 ixz = mx_inv(c, dz), ixzg = mx_inv(c, dzg);
        u256 deep =
            mx_mul(c, mx_mul(c, g0, mx_sub(c, t_rows[i], ood_cur)), ixz);
        deep = mx_add(
            c, deep,
            mx_mul(c, mx_mul(c, g1, mx_sub(c, t_rows[i], ood_nxt)), ixzg));
        deep = mx_add(
            c, deep,
            mx_mul(c, mx_mul(c, g2, mx_sub(c, c_rows[i], ood_comp)), ixz));
        u256 val = zero;
        for (int j = REM - 1; j >= 0; j--)
            val = mx_add(c, mx_mul(c, val, xq), rem[j]);
        if (u256_cmp(mx_mul(c, mx_sub(c, val, deep), u256{{1, 0, 0, 0}}),
                     zero) != 0)
            return 0;
    }
    return 1;
}

}  // namespace

extern "C" {

// Verify one improvement proof against (old, new). 1 accept / 0 reject.
int zkp_stark_verify_improvement(const uint8_t* mod32, const uint8_t* root64,
                                 uint64_t old_v, uint64_t new_v,
                                 const uint8_t* ctx_bytes, uint64_t ctx_len,
                                 const uint8_t* proof, uint64_t proof_len) {
    mctx c;
    mctx_init(c, mod32);
    u256 root_m;
    {
        u256 raw{{0, 0, 0, 0}};
        std::memcpy(raw.v, root64, 16);
        root_m = mx_mul(c, raw, c.r2);
    }
    return stark_verify_one(c, mod32, root_m, old_v, new_v, ctx_bytes,
                            ctx_len, proof, proof_len);
}

// Batch of improvement proofs (OMP across pairs). pairs: (old,new) u64 LE
// pairs; ctx_bytes: per-pair random-coin seed material at ctx_stride.
// out: batch * out_stride buffer; out_lens[i] = proof length or -1.
void zkp_stark_prove_improvement_batch(
    uint64_t batch, const uint64_t* pairs, const uint8_t* mod32,
    const uint8_t* root64, const uint8_t* ctx_bytes, uint64_t ctx_stride,
    uint8_t* out, uint64_t out_stride, int64_t* out_lens) {
    mctx c;
    mctx_init(c, mod32);
    u256 root_m;
    {
        u256 raw{{0, 0, 0, 0}};
        std::memcpy(raw.v, root64, 16);
        root_m = mx_mul(c, raw, c.r2);
    }
#ifdef _OPENMP
#pragma omp parallel for schedule(dynamic, 4) if (batch > 8)
#endif
    for (int64_t i = 0; i < (int64_t)batch; i++) {
        out_lens[i] = stark_improve_one(
            c, mod32, root_m, pairs[2 * i], pairs[2 * i + 1],
            ctx_bytes + ctx_stride * i, ctx_stride, out + out_stride * i);
    }
}

}  // extern "C"

// ===========================================================================
// Bulletproofs batch prover: the whole per-proof pipeline (value/A/S/T
// commitments, STROBE transcript, t-polynomial, inner-product rounds) runs
// natively, one OMP task per proof.  Replaces the Python lockstep prover's
// per-phase native calls (models/bulletproofs.py _prove_batch_fixed_n) with
// ONE call per bucket — same transcript schedule and byte layout as the
// bulletproofs crate 5.0 consumed by the reference
// (/root/reference/src/backend/bulletproofs.rs:138-158).
// Differentially tested bit-exact against the Python golden model with
// injected randomness (tests/test_bulletproofs.py).
// ===========================================================================

namespace {

// -- scalar field mod l = 2^252 + 27742...493 (Montgomery, 4x64) ------------

struct sc {
    uint64_t v[4];
};

static const sc SC_L = {{0x5812631A5CF5D3EDULL, 0x14DEF9DEA2F79CD6ULL, 0ULL,
                         0x1000000000000000ULL}};

struct sc_ctx {
    uint64_t n0;  // -l^{-1} mod 2^64
    sc R2;        // 2^512 mod l
};

static int sc_cmp(const sc& a, const sc& b) {
    for (int i = 3; i >= 0; i--) {
        if (a.v[i] < b.v[i]) return -1;
        if (a.v[i] > b.v[i]) return 1;
    }
    return 0;
}

static sc sc_add(const sc& a, const sc& b) {
    sc r;
    unsigned __int128 c = 0;
    for (int i = 0; i < 4; i++) {
        c += (unsigned __int128)a.v[i] + b.v[i];
        r.v[i] = (uint64_t)c;
        c >>= 64;
    }
    if (c || sc_cmp(r, SC_L) >= 0) {
        unsigned __int128 br = 0;
        for (int i = 0; i < 4; i++) {
            unsigned __int128 d = (unsigned __int128)r.v[i] - SC_L.v[i] - br;
            r.v[i] = (uint64_t)d;
            br = (d >> 64) & 1;
        }
    }
    return r;
}

static sc sc_sub(const sc& a, const sc& b) {
    sc r;
    unsigned __int128 br = 0;
    for (int i = 0; i < 4; i++) {
        unsigned __int128 d = (unsigned __int128)a.v[i] - b.v[i] - br;
        r.v[i] = (uint64_t)d;
        br = (d >> 64) & 1;
    }
    if (br) {
        unsigned __int128 c = 0;
        for (int i = 0; i < 4; i++) {
            c += (unsigned __int128)r.v[i] + SC_L.v[i];
            r.v[i] = (uint64_t)c;
            c >>= 64;
        }
    }
    return r;
}

static const sc_ctx& sc_get_ctx() {
    static sc_ctx ctx = [] {
        sc_ctx c;
        // n0 = -l^{-1} mod 2^64 via Newton iteration on the odd low limb
        uint64_t x = 1, l0 = SC_L.v[0];
        for (int i = 0; i < 6; i++) x *= 2 - l0 * x;
        c.n0 = ~x + 1;  // -x
        // R2 = 2^512 mod l by 512 modular doublings of 1
        sc r{{1, 0, 0, 0}};
        for (int i = 0; i < 512; i++) r = sc_add(r, r);
        c.R2 = r;
        return c;
    }();
    return ctx;
}

// CIOS Montgomery multiplication: returns a*b*2^-256 mod l.
static sc sc_mont_mul(const sc& a, const sc& b) {
    const sc_ctx& cx = sc_get_ctx();
    uint64_t t[6] = {0, 0, 0, 0, 0, 0};
    for (int i = 0; i < 4; i++) {
        unsigned __int128 c = 0;
        for (int j = 0; j < 4; j++) {
            c += (unsigned __int128)a.v[i] * b.v[j] + t[j];
            t[j] = (uint64_t)c;
            c >>= 64;
        }
        c += t[4];
        t[4] = (uint64_t)c;
        t[5] = (uint64_t)(c >> 64);
        uint64_t m = t[0] * cx.n0;
        c = (unsigned __int128)m * SC_L.v[0] + t[0];
        c >>= 64;
        for (int j = 1; j < 4; j++) {
            c += (unsigned __int128)m * SC_L.v[j] + t[j];
            t[j - 1] = (uint64_t)c;
            c >>= 64;
        }
        c += t[4];
        t[3] = (uint64_t)c;
        t[4] = t[5] + (uint64_t)(c >> 64);
    }
    sc r{{t[0], t[1], t[2], t[3]}};
    if (t[4] || sc_cmp(r, SC_L) >= 0) r = sc_sub(r, SC_L);
    return r;
}

// canonical a*b mod l (two Montgomery passes)
static sc sc_mul(const sc& a, const sc& b) {
    return sc_mont_mul(sc_mont_mul(a, sc_get_ctx().R2), b);
}

static sc sc_frombytes(const uint8_t* b) {
    sc r;
    std::memcpy(r.v, b, 32);
    while (sc_cmp(r, SC_L) >= 0) r = sc_sub(r, SC_L);
    return r;
}

static void sc_tobytes(const sc& a, uint8_t* b) { std::memcpy(b, a.v, 32); }

// 64 little-endian bytes reduced mod l (dalek from_bytes_mod_order_wide)
static sc sc_from_wide(const uint8_t* b) {
    sc lo = sc_frombytes(b);
    sc hi = sc_frombytes(b + 32);
    // hi * 2^256 mod l = mont_mul(hi, R2)
    return sc_add(lo, sc_mont_mul(hi, sc_get_ctx().R2));
}

static bool sc_is_zero(const sc& a) {
    return !(a.v[0] | a.v[1] | a.v[2] | a.v[3]);
}

// a^-1 mod l (Fermat); a must be nonzero
static sc sc_inv(const sc& a) {
    // l - 2
    static const uint8_t LM2[32] = {
        0xeb, 0xd3, 0xf5, 0x5c, 0x1a, 0x63, 0x12, 0x58, 0xd6, 0x9c, 0xf7,
        0xa2, 0xde, 0xf9, 0xde, 0x14, 0x00, 0x00, 0x00, 0x00, 0x00, 0x00,
        0x00, 0x00, 0x00, 0x00, 0x00, 0x00, 0x00, 0x00, 0x00, 0x10,
    };
    sc am = sc_mont_mul(a, sc_get_ctx().R2);  // to Montgomery
    sc r = am;
    bool started = false;
    (void)started;
    // MSB-first square-and-multiply; top set bit of l-2 is bit 252
    r = am;
    for (int bit = 251; bit >= 0; bit--) {
        r = sc_mont_mul(r, r);
        if ((LM2[bit >> 3] >> (bit & 7)) & 1) r = sc_mont_mul(r, am);
    }
    return sc_mont_mul(r, sc{{1, 0, 0, 0}});  // from Montgomery
}

// inner product <a, b> mod l over len elements
static sc sc_inner(const sc* a, const sc* b, int len) {
    sc acc{{0, 0, 0, 0}};
    for (int i = 0; i < len; i++) acc = sc_add(acc, sc_mul(a[i], b[i]));
    return acc;
}

// -- STROBE-128 / merlin transcript (port of models/strobe.py) --------------

static const int STROBE_R = 166;
static const uint8_t SFLAG_I = 1, SFLAG_A = 2, SFLAG_C = 4, SFLAG_M = 16,
                     SFLAG_K = 32;

struct strobe128 {
    alignas(8) uint8_t st[200];
    uint8_t pos, pos_begin, cur_flags;

    void load(const uint8_t* snapshot) {  // 203-byte snapshot from Python
        std::memcpy(st, snapshot, 200);
        pos = snapshot[200];
        pos_begin = snapshot[201];
        cur_flags = snapshot[202];
    }

    void run_f() {
        st[pos] ^= pos_begin;
        st[pos + 1] ^= 0x04;
        st[STROBE_R + 1] ^= 0x80;
        zkp_keccak_f1600((uint64_t*)st);
        pos = 0;
        pos_begin = 0;
    }

    void absorb(const uint8_t* d, size_t len) {
        for (size_t i = 0; i < len; i++) {
            st[pos] ^= d[i];
            if (++pos == STROBE_R) run_f();
        }
    }

    void squeeze(uint8_t* out, size_t len) {
        for (size_t i = 0; i < len; i++) {
            out[i] = st[pos];
            st[pos] = 0;
            if (++pos == STROBE_R) run_f();
        }
    }

    void begin_op(uint8_t flags) {
        uint8_t old_begin = pos_begin;
        pos_begin = pos + 1;
        cur_flags = flags;
        uint8_t hdr[2] = {old_begin, flags};
        absorb(hdr, 2);
        if ((flags & (SFLAG_C | SFLAG_K)) && pos != 0) run_f();
    }

    void meta_ad(const uint8_t* d, size_t len, bool more) {
        if (!more) begin_op(SFLAG_M | SFLAG_A);
        absorb(d, len);
    }

    void ad(const uint8_t* d, size_t len) {
        begin_op(SFLAG_A);
        absorb(d, len);
    }

    void prf(uint8_t* out, size_t len) {
        begin_op(SFLAG_I | SFLAG_A | SFLAG_C);
        squeeze(out, len);
    }
};

struct merlin_t {
    strobe128 s;

    void append(const char* label, const uint8_t* msg, uint32_t len) {
        s.meta_ad((const uint8_t*)label, std::strlen(label), false);
        uint8_t l4[4] = {(uint8_t)len, (uint8_t)(len >> 8), (uint8_t)(len >> 16),
                         (uint8_t)(len >> 24)};
        s.meta_ad(l4, 4, true);
        s.ad(msg, len);
    }

    void append_u64(const char* label, uint64_t x) {
        uint8_t b[8];
        for (int i = 0; i < 8; i++) b[i] = (uint8_t)(x >> (8 * i));
        append(label, b, 8);
    }

    sc challenge_scalar(const char* label) {
        s.meta_ad((const uint8_t*)label, std::strlen(label), false);
        uint8_t l4[4] = {64, 0, 0, 0};
        s.meta_ad(l4, 4, true);
        uint8_t wide[64];
        s.prf(wide, 64);
        return sc_from_wide(wide);
    }
};

// Montgomery-trick batch inversion: inverts n nonzero scalars with one
// sc_inv and 3(n-1) multiplications (the 8-lane prover inverts its per-round
// IPP challenges and y's across lanes in one shot instead of 8 pow chains).
static void sc_inv_batch(sc* vals, int n) {
    if (n <= 0) return;
    if (n == 1) {
        vals[0] = sc_inv(vals[0]);
        return;
    }
    std::vector<sc> pref(n);
    pref[0] = vals[0];
    for (int i = 1; i < n; i++) pref[i] = sc_mul(pref[i - 1], vals[i]);
    sc inv = sc_inv(pref[n - 1]);
    for (int i = n - 1; i > 0; i--) {
        sc vi = sc_mul(inv, pref[i - 1]);
        inv = sc_mul(inv, vals[i]);
        vals[i] = vi;
    }
    vals[0] = inv;
}

// -- signed-digit sparse MSM over a registered fixed table ------------------

// Recode a canonical scalar (< 2^253) into ft.nwin signed base-2^c digits in
// [-2^(c-1), 2^(c-1)-1]. Top digit absorbs the final carry (fits: scalars
// are < l < 2^253 and c*(nwin-1) >= 248 for every c the tables use).
static void sc_recode_signed(const sc& a, int c, int nwin, int16_t* digs) {
    uint8_t bytes[32];
    sc_tobytes(a, bytes);
    int half = 1 << (c - 1), full = 1 << c, mask = full - 1;
    int carry = 0;
    for (int w = 0; w < nwin; w++) {
        int bitpos = w * c;
        int byte = bitpos >> 3, bit = bitpos & 7;
        uint32_t frag = bytes[byte];
        if (byte + 1 < 32) frag |= (uint32_t)bytes[byte + 1] << 8;
        if (byte + 2 < 32) frag |= (uint32_t)bytes[byte + 2] << 16;
        int d = (int)((frag >> bit) & mask) + carry;
        if (w + 1 < nwin && d >= half) {
            d -= full;
            carry = 1;
        } else {
            carry = 0;
        }
        digs[w] = (int16_t)d;
    }
}

static edniels edniels_neg(const edniels& q) {
    return edniels{q.ypx, q.ymx, fe_neg(q.t2d)};
}

struct bp_scratch {
    std::vector<ge> buckets;
    std::vector<uint8_t> used;
    std::vector<int16_t> digs;  // nnz * nwin digit matrix

    void ensure(int c, int nwin, int max_nnz) {
        size_t nb = (size_t)1 << (c - 1);
        if (buckets.size() < nb) buckets.resize(nb);
        if (used.size() < nb) used.assign(nb, 0);
        if (digs.size() < (size_t)max_nnz * nwin)
            digs.resize((size_t)max_nnz * nwin);
    }
};

// Sparse fixed-table MSM with signed digits: sum of scals[j] * basis[cols[j]].
static ge msm_sparse(const fixed_tab<ge, edniels>& ft, const int* cols,
                     const sc* scals, int nnz, bp_scratch& scr) {
    int c = ft.c, nwin = ft.nwin;
    int nb = 1 << (c - 1);
    scr.ensure(c, nwin, nnz);
    std::memset(scr.used.data(), 0, nb);
    for (int j = 0; j < nnz; j++)
        sc_recode_signed(scals[j], c, nwin, scr.digs.data() + (size_t)j * nwin);
    for (int w = 0; w < nwin; w++) {
        const edniels* trow = ft.tab.data() + (size_t)w * ft.n;
        const ge* prow = ft.tab_pt.data() + (size_t)w * ft.n;
        for (int j = 0; j < nnz; j++) {
            int d = scr.digs[(size_t)j * nwin + w];
            if (!d) continue;
            int col = cols[j];
            if (ft.is_inf[col]) continue;
            int idx = (d > 0 ? d : -d) - 1;
            if (scr.used[idx]) {
                scr.buckets[idx] = (d > 0)
                                       ? ge_madd(scr.buckets[idx], trow[col])
                                       : ge_madd(scr.buckets[idx],
                                                 edniels_neg(trow[col]));
            } else {
                scr.buckets[idx] = (d > 0) ? prow[col] : ge_neg(prow[col]);
                scr.used[idx] = 1;
            }
        }
    }
    ge running = ge_identity(), total = ge_identity();
    bool run_set = false, tot_set = false;
    for (int idx = nb - 1; idx >= 0; idx--) {
        if (scr.used[idx]) {
            running = run_set ? ge_add(running, scr.buckets[idx])
                              : scr.buckets[idx];
            run_set = true;
        }
        if (run_set) {
            total = tot_set ? ge_add(total, running) : running;
            tot_set = true;
        }
    }
    return tot_set ? total : ge_identity();
}

static void bp_compress(const ge& p, uint8_t* out) {
    uint8_t wire[128];
    ge_to_wire(p, wire);
    zkp_ristretto_compress(wire, out);
}

// -- table-of-multiples MSM tier (ed25519 prove path) ------------------------
// See the tabm comment in fixed_tab. Default radix 2^12 (22 windows for
// 253-bit scalars): one big ed25519 basis table is 22*129*2048 entries
// (~0.7 GB) built once in ~1 s; each MSM insert becomes gather + mixed-add
// into a register accumulator, retiring the bucket arenas, scatters and
// per-MSM suffix reductions of the bucket tier (msm_sparse/msm_sparse8).

static std::mutex TABM_MUTEX;
// The multiples table only pays off when many lockstep groups walk it (the
// random-access working set is RAM-resident; a lone group reads it cold and
// the 8x per-lane scalar work of a padded group swamps a small tail). The
// batch entry point flips this on for batches of >= ZKP_TABM_MIN_BATCH
// instances; the bucket tier keeps serving small batches.
static thread_local bool TABM_ON = false;
static const uint64_t ZKP_TABM_MIN_BATCH = 32;

static int tabm_c_param() {
    // Measured on the 2-vCPU reference host (BASELINE.md round 4): the
    // RAM-resident table loses ~20% to the hot bucket arenas at mixed-batch
    // sizes (~140 instances) and only reaches parity at ~340+; random-access
    // latency, not arithmetic, is the wall. Default OFF — opt in with
    // LIBZKP_TABM_C=12..14 on hosts with bigger batches/faster memory.
    const char* e = std::getenv("LIBZKP_TABM_C");
    int c = e ? std::atoi(e) : 0;
    if (c <= 0) return 0;  // disabled: bucket tier everywhere
    if (c < 8) c = 8;
    if (c > 14) c = 14;
    return c;
}

static void ensure_tabm_ed(fixed_tab<ge, edniels>& ft) {
    if (ft.tabm_ready.load(std::memory_order_acquire)) return;
    int cm = tabm_c_param();
    std::lock_guard<std::mutex> lk(TABM_MUTEX);
    if (ft.tabm_ready.load(std::memory_order_relaxed)) return;
    if (!cm || ft.nwin == 0 || ft.n == 0) {
        // disabled / degenerate table: stay on buckets
        ft.tabm_ready.store(1, std::memory_order_release);
        return;
    }
    const int half = 1 << (cm - 1);
    const int nwin_m = (254 + cm - 1) / cm;
    const uint64_t n = ft.n;
    // window bases: base[w][i] = 2^(cm*w) * P_i (tab_pt row 0 = originals,
    // with is_inf slots parked on a placeholder — harmless, never read)
    std::vector<ge> bases((size_t)nwin_m * n);
    for (uint64_t i = 0; i < n; i++) bases[i] = ft.tab_pt[i];
    for (int w = 1; w < nwin_m; w++)
        for (uint64_t i = 0; i < n; i++) {
            ge p = bases[(size_t)(w - 1) * n + i];
            for (int k = 0; k < cm; k++) p = ge_double(p);
            bases[(size_t)w * n + i] = p;
        }
    std::vector<uint64_t> tabm((size_t)nwin_m * n * half * 16 + 16);
    size_t tabm_off =
        (128 - ((uintptr_t)tabm.data() & 127)) % 128 / sizeof(uint64_t);
#if defined(__linux__)
    {
        // Back the table with transparent hugepages: at ~0.7 GB of randomly
        // gathered entries, 4 KiB TLB misses would otherwise dominate.
        uintptr_t lo = ((uintptr_t)tabm.data() + 4095) & ~(uintptr_t)4095;
        uintptr_t hi = ((uintptr_t)(tabm.data() + tabm.size())) & ~(uintptr_t)4095;
        if (hi > lo) madvise((void*)lo, hi - lo, MADV_HUGEPAGE);
    }
#endif
#ifdef _OPENMP
#pragma omp parallel for schedule(dynamic, 4)
#endif
    for (int64_t pair = 0; pair < (int64_t)(nwin_m * n); pair++) {
        const ge& base = bases[pair];
        std::vector<ge> row(half);
        row[0] = base;
        for (int d = 1; d < half; d++) row[d] = ge_add(row[d - 1], base);
        std::vector<edniels> affs;
        ge_normalize(row, affs);
        uint64_t* dst = tabm.data() + tabm_off + (size_t)pair * half * 16;
        for (int d = 0; d < half; d++) {
            std::memcpy(dst + (size_t)d * 16, &affs[d], sizeof(edniels));
            dst[(size_t)d * 16 + 15] = 0;
        }
    }
    ft.tabm.swap(tabm);
    ft.tabm_off = tabm_off;
    ft.cm = cm;
    ft.nwin_m = nwin_m;
    ft.tabm_ready.store(1, std::memory_order_release);
}

// Sparse fixed-table MSM over the multiples table: scalar (1-lane) tier.
// Entries live in RAM (the table far exceeds cache), so each insert's
// two-line entry is software-prefetched a few iterations ahead of its
// mixed-add.
static ge msm_tab1(const fixed_tab<ge, edniels>& ft, const int* cols,
                   const sc* scals, int nnz, bp_scratch& scr) {
    const int cm = ft.cm, nwin = ft.nwin_m;
    if (scr.digs.size() < (size_t)nnz * nwin)
        scr.digs.resize((size_t)nnz * nwin);
    for (int j = 0; j < nnz; j++)
        sc_recode_signed(scals[j], cm, nwin, scr.digs.data() + (size_t)j * nwin);
    const uint8_t* base = (const uint8_t*)(ft.tabm.data() + ft.tabm_off);
    const int PD = 8;  // prefetch distance (inserts)
    auto entry_off = [&](int w, int j) -> int64_t {
        int d = scr.digs[(size_t)j * nwin + w];
        if (!d || ft.is_inf[cols[j]]) return -1;
        uint64_t idx = (uint64_t)((d > 0 ? d : -d) - 1);
        return (int64_t)(((((uint64_t)w * ft.n + cols[j]) << (cm - 1)) + idx)
                         << 7);
    };
    auto prefetch_at = [&](int w, int j) {
        // j arrives as in-window-index + PD; for tiny nnz (the V/A/T1/T2
        // MSMs have nnz = 1..2) that can overshoot by several windows, so
        // keep wrapping until it lands inside one.
        while (j >= nnz) {
            j -= nnz;
            if (++w >= nwin) return;
        }
        int64_t off = entry_off(w, j);
        if (off < 0) return;
        __builtin_prefetch((const char*)(base + off));
        __builtin_prefetch((const char*)(base + off + 64));
    };
    for (int j = 0; j < nnz && j < PD; j++) prefetch_at(0, j);
    ge acc = ge_identity();
    for (int w = 0; w < nwin; w++) {
        for (int j = 0; j < nnz; j++) {
            prefetch_at(w, j + PD);
            int64_t off = entry_off(w, j);
            if (off < 0) continue;
            const edniels& e = *(const edniels*)(base + off);
            int d = scr.digs[(size_t)j * nwin + w];
            acc = (d > 0) ? ge_madd(acc, e) : ge_madd(acc, edniels_neg(e));
        }
    }
    return acc;
}



// Optional coarse profile of the batch prover (LIBZKP_BP_PROF=1): cycles in
// MSM inserts vs Ristretto compression, per zkp_bp_prove_batch call. Lives
// OUTSIDE the IFMA guard: zkp_bp_prove_batch's epilogue reads these on every
// build, including the portable no-march fallback.
static std::atomic<uint64_t> BP_PROF_MSM{0}, BP_PROF_COMP{0};
static inline uint64_t bp_prof_now() {
#if defined(__x86_64__) || defined(__i386__)
    return __builtin_ia32_rdtsc();
#else
    // non-x86 fallback: ns since epoch (BASELINE's "cycles at 2.1 GHz"
    // reading only applies to the x86 reference host anyway)
    return (uint64_t)std::chrono::duration_cast<std::chrono::nanoseconds>(
               std::chrono::steady_clock::now().time_since_epoch())
        .count();
#endif
}
static bool bp_prof_on() {
    static int on = -1;
    if (on < 0) on = std::getenv("LIBZKP_BP_PROF") ? 1 : 0;
    return on == 1;
}

// -- AVX-512 IFMA 8-lane field tier ------------------------------------------
// Eight curve25519 field elements per vector (lane p = proof p), 5 x 51-bit
// limbs in 5 zmm registers. vpmadd52{lo,hi} on 51-bit operands: a 52x52
// product splits lo52 + hi*2^52; in radix-2^51 columns the hi part lands in
// the NEXT column doubled (2^52 = 2*2^51). Every op re-carries its result to
// limbs <= 2^51 + 2^6 so all multiplication operands stay < 2^52 (IFMA
// truncates operands at 52 bits — this bound is load-bearing).

#if defined(__AVX512IFMA__) && defined(__AVX512F__)
#define ZKP_HAVE_IFMA8 1

struct fe8 {
    __m512i v[5];
};

static const uint64_t FE8_MASK = 0x7FFFFFFFFFFFFULL;

// parallel carry: limbs < 2^53 in -> limbs < 2^51 + 77 out (one step, no chain)
static inline fe8 fe8_carry(const fe8& a) {
    __m512i m = _mm512_set1_epi64(FE8_MASK);
    __m512i c0 = _mm512_srli_epi64(a.v[0], 51);
    __m512i c1 = _mm512_srli_epi64(a.v[1], 51);
    __m512i c2 = _mm512_srli_epi64(a.v[2], 51);
    __m512i c3 = _mm512_srli_epi64(a.v[3], 51);
    __m512i c4 = _mm512_srli_epi64(a.v[4], 51);
    // 19*c4 = 16c + 2c + c
    __m512i c4_19 = _mm512_add_epi64(
        _mm512_add_epi64(_mm512_slli_epi64(c4, 4), _mm512_slli_epi64(c4, 1)), c4);
    fe8 r;
    r.v[0] = _mm512_add_epi64(_mm512_and_epi64(a.v[0], m), c4_19);
    r.v[1] = _mm512_add_epi64(_mm512_and_epi64(a.v[1], m), c0);
    r.v[2] = _mm512_add_epi64(_mm512_and_epi64(a.v[2], m), c1);
    r.v[3] = _mm512_add_epi64(_mm512_and_epi64(a.v[3], m), c2);
    r.v[4] = _mm512_add_epi64(_mm512_and_epi64(a.v[4], m), c3);
    return r;
}

static inline fe8 fe8_add(const fe8& a, const fe8& b) {
    fe8 r;
    for (int i = 0; i < 5; i++) r.v[i] = _mm512_add_epi64(a.v[i], b.v[i]);
    return fe8_carry(r);
}

// a - b with 2p bias (same constants as scalar fe_sub), then carry
static inline fe8 fe8_sub(const fe8& a, const fe8& b) {
    fe8 r;
    r.v[0] = _mm512_sub_epi64(
        _mm512_add_epi64(a.v[0], _mm512_set1_epi64(0xFFFFFFFFFFFDAULL)), b.v[0]);
    for (int i = 1; i < 5; i++)
        r.v[i] = _mm512_sub_epi64(
            _mm512_add_epi64(a.v[i], _mm512_set1_epi64(0xFFFFFFFFFFFFEULL)),
            b.v[i]);
    return fe8_carry(r);
}

// full 8-lane field multiplication (operands must be < 2^52 per limb)
static inline fe8 fe8_mul(const fe8& a, const fe8& b) {
    __m512i z = _mm512_setzero_si512();
    __m512i lo[9], hi[9];
    for (int k = 0; k < 9; k++) lo[k] = hi[k] = z;
    for (int i = 0; i < 5; i++)
        for (int j = 0; j < 5; j++) {
            lo[i + j] = _mm512_madd52lo_epu64(lo[i + j], a.v[i], b.v[j]);
            hi[i + j] = _mm512_madd52hi_epu64(hi[i + j], a.v[i], b.v[j]);
        }
    // column t value = lo[t] + 2*hi[t-1]; columns >= 5 fold with *19
    __m512i r[5];
    for (int t = 0; t < 5; t++) {
        __m512i v = lo[t];
        if (t > 0) v = _mm512_add_epi64(v, _mm512_slli_epi64(hi[t - 1], 1));
        // column 9 has no lo part (max column index is 8)
        __m512i f = (t < 4) ? lo[t + 5] : z;
        __m512i fh = _mm512_slli_epi64(hi[t + 4], 1);
        f = _mm512_add_epi64(f, fh);
        // *19 = 16 + 2 + 1
        f = _mm512_add_epi64(
            _mm512_add_epi64(_mm512_slli_epi64(f, 4), _mm512_slli_epi64(f, 1)),
            f);
        r[t] = _mm512_add_epi64(v, f);
    }
    // sequential carry (values < 2^61), then one parallel pass
    __m512i m = _mm512_set1_epi64(FE8_MASK);
    __m512i c;
    c = _mm512_srli_epi64(r[0], 51); r[0] = _mm512_and_epi64(r[0], m);
    r[1] = _mm512_add_epi64(r[1], c);
    c = _mm512_srli_epi64(r[1], 51); r[1] = _mm512_and_epi64(r[1], m);
    r[2] = _mm512_add_epi64(r[2], c);
    c = _mm512_srli_epi64(r[2], 51); r[2] = _mm512_and_epi64(r[2], m);
    r[3] = _mm512_add_epi64(r[3], c);
    c = _mm512_srli_epi64(r[3], 51); r[3] = _mm512_and_epi64(r[3], m);
    r[4] = _mm512_add_epi64(r[4], c);
    c = _mm512_srli_epi64(r[4], 51); r[4] = _mm512_and_epi64(r[4], m);
    c = _mm512_add_epi64(
        _mm512_add_epi64(_mm512_slli_epi64(c, 4), _mm512_slli_epi64(c, 1)), c);
    r[0] = _mm512_add_epi64(r[0], c);
    c = _mm512_srli_epi64(r[0], 51); r[0] = _mm512_and_epi64(r[0], m);
    r[1] = _mm512_add_epi64(r[1], c);
    fe8 out;
    for (int t = 0; t < 5; t++) out.v[t] = r[t];
    return out;
}

struct ge8 {
    fe8 X, Y, Z, T;
};

// full extended-coordinates add, 8 lanes: the unified twisted-Edwards law
// (complete on curve25519 — identity and doubling inputs need no cases),
// same formulas as scalar ge_add. two_d is the broadcast 2d constant.
static inline ge8 ge8_add(const ge8& p, const ge8& q, const fe8& two_d) {
    fe8 A = fe8_mul(fe8_sub(p.Y, p.X), fe8_sub(q.Y, q.X));
    fe8 B = fe8_mul(fe8_add(p.Y, p.X), fe8_add(q.Y, q.X));
    fe8 C = fe8_mul(fe8_mul(p.T, two_d), q.T);
    fe8 ZZ = fe8_mul(p.Z, q.Z);
    fe8 D = fe8_add(ZZ, ZZ);
    fe8 E = fe8_sub(B, A);
    fe8 F = fe8_sub(D, C);
    fe8 G = fe8_add(D, C);
    fe8 H = fe8_add(B, A);
    return ge8{fe8_mul(E, F), fe8_mul(G, H), fe8_mul(F, G), fe8_mul(E, H)};
}

// mixed add, 8 lanes: same formulas as scalar ge_madd
static inline ge8 ge8_madd(const ge8& p, const fe8& ymx, const fe8& ypx,
                           const fe8& t2d) {
    fe8 A = fe8_mul(fe8_sub(p.Y, p.X), ymx);
    fe8 B = fe8_mul(fe8_add(p.Y, p.X), ypx);
    fe8 C = fe8_mul(p.T, t2d);
    fe8 D = fe8_add(p.Z, p.Z);
    fe8 E = fe8_sub(B, A);
    fe8 F = fe8_sub(D, C);
    fe8 G = fe8_add(D, C);
    fe8 H = fe8_add(B, A);
    return ge8{fe8_mul(E, F), fe8_mul(G, H), fe8_mul(F, G), fe8_mul(E, H)};
}

// ---- 8-lane Ristretto compression --------------------------------------
// The (p-5)/8 power chain dominates a compression (~265 field ops); the
// prover compresses V/A/S/T1/T2 and every IPP round's L/R for 8 proofs in
// lockstep, so the whole RFC 9496 ENCODE runs lane-parallel with the rare
// per-lane conditionals handled by masks derived from canonical encodings.

static inline fe fe8_lane(const fe8& a, int p) {
    alignas(64) uint64_t tmp[8];
    fe r;
    for (int i = 0; i < 5; i++) {
        _mm512_store_si512(tmp, a.v[i]);
        r.v[i] = tmp[p];
    }
    return r;
}
static inline fe8 fe8_from_lanes(const fe a[8]) {
    alignas(64) uint64_t tmp[8];
    fe8 r;
    for (int i = 0; i < 5; i++) {
        for (int p = 0; p < 8; p++) tmp[p] = a[p].v[i];
        r.v[i] = _mm512_load_si512(tmp);
    }
    return r;
}
static inline __mmask8 fe8_isneg_mask(const fe8& a) {
    __mmask8 m = 0;
    for (int p = 0; p < 8; p++)
        if (fe_isnegative(fe8_lane(a, p))) m |= 1u << p;
    return m;
}
static inline fe8 fe8_blend(__mmask8 m, const fe8& a, const fe8& b) {
    fe8 r;
    for (int i = 0; i < 5; i++) r.v[i] = _mm512_mask_blend_epi64(m, a.v[i], b.v[i]);
    return r;
}
static inline fe8 fe8_bcast(const fe& a) {
    fe8 r;
    for (int i = 0; i < 5; i++) r.v[i] = _mm512_set1_epi64((long long)a.v[i]);
    return r;
}

// z^(2^252 - 3), 8 lanes (ref10 chain, mirrors fe_pow22523)
static fe8 fe8_pow22523(const fe8& z) {
    fe8 t0, t1, t2;
    t0 = fe8_mul(z, z);
    t1 = fe8_mul(t0, t0);
    t1 = fe8_mul(t1, t1);
    t1 = fe8_mul(z, t1);
    t0 = fe8_mul(t0, t1);
    t0 = fe8_mul(t0, t0);
    t0 = fe8_mul(t1, t0);
    t1 = fe8_mul(t0, t0);
    for (int i = 1; i < 5; i++) t1 = fe8_mul(t1, t1);
    t0 = fe8_mul(t1, t0);
    t1 = fe8_mul(t0, t0);
    for (int i = 1; i < 10; i++) t1 = fe8_mul(t1, t1);
    t1 = fe8_mul(t1, t0);
    t2 = fe8_mul(t1, t1);
    for (int i = 1; i < 20; i++) t2 = fe8_mul(t2, t2);
    t1 = fe8_mul(t2, t1);
    t1 = fe8_mul(t1, t1);
    for (int i = 1; i < 10; i++) t1 = fe8_mul(t1, t1);
    t0 = fe8_mul(t1, t0);
    t1 = fe8_mul(t0, t0);
    for (int i = 1; i < 50; i++) t1 = fe8_mul(t1, t1);
    t1 = fe8_mul(t1, t0);
    t2 = fe8_mul(t1, t1);
    for (int i = 1; i < 100; i++) t2 = fe8_mul(t2, t2);
    t1 = fe8_mul(t2, t1);
    t1 = fe8_mul(t1, t1);
    for (int i = 1; i < 50; i++) t1 = fe8_mul(t1, t1);
    t0 = fe8_mul(t1, t0);
    t0 = fe8_mul(t0, t0);
    t0 = fe8_mul(t0, t0);
    return fe8_mul(t0, z);
}

// 8 lockstep RFC 9496 ENCODEs; out stride 32 bytes per lane.
static void bp_compress8(const ge8& p, uint8_t* out) {
    uint64_t t0 = bp_prof_on() ? bp_prof_now() : 0;
    fe8 sqrt_m1 = fe8_bcast(fe_frombytes(SQRT_M1_BYTES));
    fe8 u1 = fe8_mul(fe8_add(p.Z, p.Y), fe8_sub(p.Z, p.Y));
    fe8 u2 = fe8_mul(p.X, p.Y);
    fe8 uv = fe8_mul(u1, fe8_mul(u2, u2));
    // invsqrt = SQRT_RATIO_M1(1, uv): r = uv^3 * (uv^7)^((p-5)/8), then
    // adjust by sqrt(-1) when check = uv*r^2 is -1 or -sqrt(-1)
    fe8 v3 = fe8_mul(fe8_mul(uv, uv), uv);
    fe8 v7 = fe8_mul(fe8_mul(v3, v3), uv);
    fe8 r = fe8_mul(v3, fe8_pow22523(v7));
    fe8 check = fe8_mul(uv, fe8_mul(r, r));
    __mmask8 adjust = 0;
    {
        fe neg_one = fe_neg(fe_one());
        fe neg_i = fe_neg(fe_frombytes(SQRT_M1_BYTES));
        for (int lp = 0; lp < 8; lp++) {
            fe c = fe8_lane(check, lp);
            if (fe_iszero(fe_sub(c, neg_one)) || fe_iszero(fe_sub(c, neg_i)))
                adjust |= 1u << lp;
        }
    }
    r = fe8_blend(adjust, r, fe8_mul(r, sqrt_m1));
    {
        __mmask8 rn = fe8_isneg_mask(r);
        fe8 zero8;
        for (int i = 0; i < 5; i++) zero8.v[i] = _mm512_setzero_si512();
        r = fe8_blend(rn, r, fe8_sub(zero8, r));
    }
    fe8 den1 = fe8_mul(r, u1);
    fe8 den2 = fe8_mul(r, u2);
    fe8 z_inv = fe8_mul(fe8_mul(den1, den2), p.T);
    fe8 ix = fe8_mul(p.X, sqrt_m1);
    fe8 iy = fe8_mul(p.Y, sqrt_m1);
    fe8 enchanted = fe8_mul(den1, fe8_bcast(fe_frombytes(INVSQRT_A_MINUS_D_BYTES)));
    __mmask8 rotate = fe8_isneg_mask(fe8_mul(p.T, z_inv));
    fe8 x = fe8_blend(rotate, p.X, iy);
    fe8 y = fe8_blend(rotate, p.Y, ix);
    fe8 den_inv = fe8_blend(rotate, den2, enchanted);
    {
        __mmask8 yn = fe8_isneg_mask(fe8_mul(x, z_inv));
        fe8 zero8;
        for (int i = 0; i < 5; i++) zero8.v[i] = _mm512_setzero_si512();
        y = fe8_blend(yn, y, fe8_sub(zero8, y));
    }
    fe8 s = fe8_mul(den_inv, fe8_sub(p.Z, y));
    {
        __mmask8 sn = fe8_isneg_mask(s);
        fe8 zero8;
        for (int i = 0; i < 5; i++) zero8.v[i] = _mm512_setzero_si512();
        s = fe8_blend(sn, s, fe8_sub(zero8, s));
    }
    for (int lp = 0; lp < 8; lp++) {
        fe sl = fe8_lane(s, lp);
        fe_tobytes(sl, out + 32 * lp);
    }
    if (t0) BP_PROF_COMP += bp_prof_now() - t0;
}

static inline ge8 ge8_from_pts(const ge a[8]) {
    fe x[8], y[8], z[8], t[8];
    for (int p = 0; p < 8; p++) {
        x[p] = a[p].X;
        y[p] = a[p].Y;
        z[p] = a[p].Z;
        t[p] = a[p].T;
    }
    return ge8{fe8_from_lanes(x), fe8_from_lanes(y), fe8_from_lanes(z),
               fe8_from_lanes(t)};
}

// lane-wise self-test of the fe8 tier against the scalar fe tier; returns 0 ok
static int fe8_selftest() {
    uint64_t seed = 0x243F6A8885A308D3ULL;
    auto rnd = [&]() {
        seed = seed * 6364136223846793005ULL + 1442695040888963407ULL;
        return seed >> 13;
    };
    for (int iter = 0; iter < 64; iter++) {
        fe a[8], b[8];
        alignas(64) uint64_t abuf[5][8], bbuf[5][8];
        for (int p = 0; p < 8; p++) {
            for (int i = 0; i < 5; i++) {
                a[p].v[i] = rnd() & FE8_MASK;
                b[p].v[i] = rnd() & FE8_MASK;
                abuf[i][p] = a[p].v[i];
                bbuf[i][p] = b[p].v[i];
            }
        }
        fe8 av, bv;
        for (int i = 0; i < 5; i++) {
            av.v[i] = _mm512_load_si512(abuf[i]);
            bv.v[i] = _mm512_load_si512(bbuf[i]);
        }
        fe8 mv = fe8_mul(av, bv);
        fe8 sv = fe8_sub(av, bv);
        fe8 dv = fe8_add(av, bv);
        alignas(64) uint64_t mbuf[5][8], sbuf[5][8], dbuf[5][8];
        for (int i = 0; i < 5; i++) {
            _mm512_store_si512(mbuf[i], mv.v[i]);
            _mm512_store_si512(sbuf[i], sv.v[i]);
            _mm512_store_si512(dbuf[i], dv.v[i]);
        }
        for (int p = 0; p < 8; p++) {
            uint8_t want[32], got[32];
            fe m = fe_mul(a[p], b[p]);
            fe g{{mbuf[0][p], mbuf[1][p], mbuf[2][p], mbuf[3][p], mbuf[4][p]}};
            fe_tobytes(m, want);
            fe_tobytes(g, got);
            if (std::memcmp(want, got, 32)) return 1;
            fe s = fe_sub(a[p], b[p]);
            fe gs{{sbuf[0][p], sbuf[1][p], sbuf[2][p], sbuf[3][p], sbuf[4][p]}};
            fe_tobytes(s, want);
            fe_tobytes(gs, got);
            if (std::memcmp(want, got, 32)) return 2;
            fe d = fe_add(a[p], b[p]);
            fe gd{{dbuf[0][p], dbuf[1][p], dbuf[2][p], dbuf[3][p], dbuf[4][p]}};
            fe_tobytes(d, want);
            fe_tobytes(gd, got);
            if (std::memcmp(want, got, 32)) return 3;
        }
    }
    return 0;
}
struct bp_scratch8 {
    std::vector<ge> buckets;   // [p * nb + idx], AoS (160 B each)
    std::vector<int16_t> digs;  // [(j * nwin + w) * 8 + p]
};

// 8 independent sparse MSMs over ONE shared column schedule (the per-round
// coefficient support is identical across proofs of the same bit-width; only
// the scalars differ). Bucket inserts run 8 lanes wide: the niels operand is
// a broadcast (shared), bucket reads/writes are masked gathers/scatters into
// per-proof bucket arenas, and the point add is the fe8 IFMA tier.
// scals8 layout: scals8[j * 8 + p] = column j's scalar for proof p.
static void msm_sparse8(const fixed_tab<ge, edniels>& ft, const int* cols,
                        const sc* scals8, int nnz, bp_scratch8& scr,
                        ge out[8]) {
    const int c = ft.c, nwin = ft.nwin, nb = 1 << (c - 1);
    scr.buckets.resize((size_t)8 * nb);
    ge ident = ge_identity();
    for (size_t i = 0; i < scr.buckets.size(); i++) scr.buckets[i] = ident;
    scr.digs.resize((size_t)nnz * nwin * 8);
    {
        std::vector<int16_t> tmp(nwin);
        for (int j = 0; j < nnz; j++)
            for (int p = 0; p < 8; p++) {
                sc_recode_signed(scals8[j * 8 + p], c, nwin, tmp.data());
                for (int w = 0; w < nwin; w++)
                    scr.digs[((size_t)j * nwin + w) * 8 + p] = tmp[w];
            }
    }
    uint8_t* base = (uint8_t*)scr.buckets.data();
    const __m512i vzero = _mm512_setzero_si512();
    const __m512i vone = _mm512_set1_epi64(1);
    // lane p's arena starts at p * nb * 160 bytes
    const __m512i lane_base = _mm512_setr_epi64(
        0ULL, (uint64_t)nb * 160, 2ULL * nb * 160, 3ULL * nb * 160,
        4ULL * nb * 160, 5ULL * nb * 160, 6ULL * nb * 160, 7ULL * nb * 160);
    for (int w = 0; w < nwin; w++) {
        const edniels* trow = ft.tab.data() + (size_t)w * ft.n;
        for (int j = 0; j < nnz; j++) {
            __m128i d16 = _mm_loadu_si128(
                (const __m128i*)&scr.digs[((size_t)j * nwin + w) * 8]);
            __m512i d = _mm512_cvtepi16_epi64(d16);
            __mmask8 m = _mm512_cmpneq_epi64_mask(d, vzero);
            if (!m) continue;
            if (ft.is_inf[cols[j]]) continue;
            __mmask8 neg = _mm512_cmplt_epi64_mask(d, vzero);
            __m512i idx = _mm512_sub_epi64(_mm512_abs_epi64(d), vone);
            // byte offset: idx * 160 = (idx << 7) + (idx << 5), plus lane base
            __m512i off = _mm512_add_epi64(
                _mm512_add_epi64(_mm512_slli_epi64(idx, 7),
                                 _mm512_slli_epi64(idx, 5)),
                lane_base);
            ge8 acc;
            __m512i addr[20];
            for (int l = 0; l < 20; l++)
                addr[l] = _mm512_add_epi64(off, _mm512_set1_epi64(8 * l));
            for (int i = 0; i < 5; i++) {
                acc.X.v[i] =
                    _mm512_mask_i64gather_epi64(vzero, m, addr[i], base, 1);
                acc.Y.v[i] = _mm512_mask_i64gather_epi64(vzero, m, addr[5 + i],
                                                         base, 1);
                acc.Z.v[i] = _mm512_mask_i64gather_epi64(vzero, m, addr[10 + i],
                                                         base, 1);
                acc.T.v[i] = _mm512_mask_i64gather_epi64(vzero, m, addr[15 + i],
                                                         base, 1);
            }
            const edniels& q = trow[cols[j]];
            fe nt2d = fe_neg(q.t2d);
            fe8 ymx, ypx, t2d;
            for (int i = 0; i < 5; i++) {
                __m512i a = _mm512_set1_epi64(q.ymx.v[i]);
                __m512i b = _mm512_set1_epi64(q.ypx.v[i]);
                // negated point: (ymx, ypx, t2d) -> (ypx, ymx, -t2d)
                ymx.v[i] = _mm512_mask_blend_epi64(neg, a, b);
                ypx.v[i] = _mm512_mask_blend_epi64(neg, b, a);
                t2d.v[i] = _mm512_mask_blend_epi64(
                    neg, _mm512_set1_epi64(q.t2d.v[i]),
                    _mm512_set1_epi64(nt2d.v[i]));
            }
            ge8 r = ge8_madd(acc, ymx, ypx, t2d);
            for (int i = 0; i < 5; i++) {
                _mm512_mask_i64scatter_epi64(base, m, addr[i], r.X.v[i], 1);
                _mm512_mask_i64scatter_epi64(base, m, addr[5 + i], r.Y.v[i], 1);
                _mm512_mask_i64scatter_epi64(base, m, addr[10 + i], r.Z.v[i], 1);
                _mm512_mask_i64scatter_epi64(base, m, addr[15 + i], r.T.v[i], 1);
            }
        }
    }
    // 8-lane bucket reduction: the unified Edwards add is complete, so
    // identity-valued (never-touched) buckets flow through with no bitmap
    // or branches — all 8 per-proof weighted suffix chains run in lockstep.
    {
        fe two_d_s = fe_frombytes(TWO_D_BYTES);
        fe8 two_d;
        for (int i = 0; i < 5; i++)
            two_d.v[i] = _mm512_set1_epi64((long long)two_d_s.v[i]);
        ge8 running, total;
        for (int i = 0; i < 5; i++) {
            __m512i zv = _mm512_setzero_si512();
            __m512i ov = _mm512_set1_epi64((long long)(i == 0 ? 1 : 0));
            running.X.v[i] = zv;
            running.Y.v[i] = ov;
            running.Z.v[i] = ov;
            running.T.v[i] = zv;
        }
        total = running;
        for (int idx = nb - 1; idx >= 0; idx--) {
            __m512i off = _mm512_add_epi64(
                lane_base, _mm512_set1_epi64((long long)idx * 160));
            ge8 b;
            for (int i = 0; i < 5; i++) {
                b.X.v[i] = _mm512_i64gather_epi64(
                    _mm512_add_epi64(off, _mm512_set1_epi64(8 * i)), base, 1);
                b.Y.v[i] = _mm512_i64gather_epi64(
                    _mm512_add_epi64(off, _mm512_set1_epi64(8 * (5 + i))), base,
                    1);
                b.Z.v[i] = _mm512_i64gather_epi64(
                    _mm512_add_epi64(off, _mm512_set1_epi64(8 * (10 + i))),
                    base, 1);
                b.T.v[i] = _mm512_i64gather_epi64(
                    _mm512_add_epi64(off, _mm512_set1_epi64(8 * (15 + i))),
                    base, 1);
            }
            running = ge8_add(running, b, two_d);
            total = ge8_add(total, running, two_d);
        }
        alignas(64) uint64_t lane[8];
        for (int p = 0; p < 8; p++) {
            ge r;
            for (int i = 0; i < 5; i++) {
                _mm512_store_si512(lane, total.X.v[i]);
                r.X.v[i] = lane[p];
                _mm512_store_si512(lane, total.Y.v[i]);
                r.Y.v[i] = lane[p];
                _mm512_store_si512(lane, total.Z.v[i]);
                r.Z.v[i] = lane[p];
                _mm512_store_si512(lane, total.T.v[i]);
                r.T.v[i] = lane[p];
            }
            out[p] = r;
        }
    }
}
// Sparse fixed-table MSM over the multiples table, 8 lanes in lockstep.
// Per (window, column): gather each lane's digit-selected multiple from
// tabm (masked lanes receive the cached-affine identity (1, 1, 0), which
// the unified mixed-add passes through), blend per-lane negation, one
// ge8_madd into a register accumulator. No bucket arena, no scatters, no
// reduction pass.
static void msm_tab8(const fixed_tab<ge, edniels>& ft, const int* cols,
                     const sc* scals8, int nnz, bp_scratch8& scr, ge out[8]) {
    const int cm = ft.cm, nwin = ft.nwin_m;
    scr.digs.resize((size_t)nnz * nwin * 8);
    {
        std::vector<int16_t> tmp(nwin);
        for (int j = 0; j < nnz; j++)
            for (int p = 0; p < 8; p++) {
                sc_recode_signed(scals8[j * 8 + p], cm, nwin, tmp.data());
                for (int w = 0; w < nwin; w++)
                    scr.digs[((size_t)j * nwin + w) * 8 + p] = tmp[w];
            }
    }
    const uint8_t* base = (const uint8_t*)(ft.tabm.data() + ft.tabm_off);
    const __m512i vzero = _mm512_setzero_si512();
    const __m512i vone64 = _mm512_set1_epi64(1);
    static const int PD = [] {  // prefetch distance: entries live in RAM
        const char* e = std::getenv("LIBZKP_TABM_PD");
        int v = e ? std::atoi(e) : 8;
        return v < 0 ? 0 : (v > 64 ? 64 : v);
    }();
    auto prefetch_at = [&](int w, int j) {
        // Same wrap discipline as msm_tab1: j + PD can overshoot several
        // whole windows when nnz is tiny.
        while (j >= nnz) {
            j -= nnz;
            if (++w >= nwin) return;
        }
        if (ft.is_inf[cols[j]]) return;
        const int16_t* dj = &scr.digs[((size_t)j * nwin + w) * 8];
        uint64_t ebase = (((uint64_t)w * ft.n + cols[j]) << (cm - 1));
        for (int p = 0; p < 8; p++) {
            int d = dj[p];
            if (!d) continue;
            const char* a =
                (const char*)(base +
                              ((ebase + (uint64_t)((d > 0 ? d : -d) - 1))
                               << 7));
            _mm_prefetch(a, _MM_HINT_T0);
            _mm_prefetch(a + 64, _MM_HINT_T0);
        }
    };
    // gather fill for masked lanes: identity edniels = (ymx=1, ypx=1, t2d=0)
    // -> plane 0 (ymx limb 0) and plane 5 (ypx limb 0) read 1, rest 0.
    ge8 acc;
    for (int i = 0; i < 5; i++) {
        __m512i z = vzero;
        __m512i o = _mm512_set1_epi64((long long)(i == 0 ? 1 : 0));
        acc.X.v[i] = z;
        acc.Y.v[i] = o;
        acc.Z.v[i] = o;
        acc.T.v[i] = z;
    }
    for (int j = 0; j < nnz && j < PD; j++) prefetch_at(0, j);
    for (int w = 0; w < nwin; w++) {
        const uint64_t wbase = ((uint64_t)w * ft.n) << (cm - 1);
        for (int j = 0; j < nnz; j++) {
            prefetch_at(w, j + PD);
            __m128i d16 = _mm_loadu_si128(
                (const __m128i*)&scr.digs[((size_t)j * nwin + w) * 8]);
            __m512i d = _mm512_cvtepi16_epi64(d16);
            __mmask8 m = _mm512_cmpneq_epi64_mask(d, vzero);
            if (!m) continue;
            if (ft.is_inf[cols[j]]) continue;
            __mmask8 neg = _mm512_cmplt_epi64_mask(d, vzero);
            __m512i idx = _mm512_sub_epi64(_mm512_abs_epi64(d), vone64);
            // entry byte offset: (wbase + (col << (cm-1)) + idx) * 128
            uint64_t ebase = wbase + ((uint64_t)cols[j] << (cm - 1));
            __m512i eidx = _mm512_add_epi64(idx, _mm512_set1_epi64(ebase));
            __m512i off = _mm512_slli_epi64(eidx, 7);
            fe8 ymx, ypx, t2d;
            for (int l = 0; l < 5; l++) {
                __m512i a0 = _mm512_add_epi64(off, _mm512_set1_epi64(8 * l));
                __m512i a1 =
                    _mm512_add_epi64(off, _mm512_set1_epi64(8 * (5 + l)));
                __m512i a2 =
                    _mm512_add_epi64(off, _mm512_set1_epi64(8 * (10 + l)));
                __m512i fill = (l == 0) ? vone64 : vzero;
                ymx.v[l] = _mm512_mask_i64gather_epi64(fill, m, a0, base, 1);
                ypx.v[l] = _mm512_mask_i64gather_epi64(fill, m, a1, base, 1);
                t2d.v[l] = _mm512_mask_i64gather_epi64(vzero, m, a2, base, 1);
            }
            // negated lanes: (ymx, ypx, t2d) -> (ypx, ymx, -t2d). Negating
            // t2d = 0 (masked lanes) stays a multiple of p: harmless.
            fe8 t2dn;
            {
                fe8 z8;
                for (int l = 0; l < 5; l++) z8.v[l] = vzero;
                t2dn = fe8_sub(z8, t2d);
            }
            fe8 bymx, bypx, bt2d;
            for (int l = 0; l < 5; l++) {
                bymx.v[l] = _mm512_mask_blend_epi64(neg, ymx.v[l], ypx.v[l]);
                bypx.v[l] = _mm512_mask_blend_epi64(neg, ypx.v[l], ymx.v[l]);
                bt2d.v[l] = _mm512_mask_blend_epi64(neg, t2d.v[l], t2dn.v[l]);
            }
            acc = ge8_madd(acc, bymx, bypx, bt2d);
        }
    }
    alignas(64) uint64_t lane[8];
    for (int p = 0; p < 8; p++) {
        ge r;
        for (int i = 0; i < 5; i++) {
            _mm512_store_si512(lane, acc.X.v[i]);
            r.X.v[i] = lane[p];
            _mm512_store_si512(lane, acc.Y.v[i]);
            r.Y.v[i] = lane[p];
            _mm512_store_si512(lane, acc.Z.v[i]);
            r.Z.v[i] = lane[p];
            _mm512_store_si512(lane, acc.T.v[i]);
            r.T.v[i] = lane[p];
        }
        out[p] = r;
    }
}

// Single-instance sparse MSM with 8-wide conflict-free bucket inserts: the
// counting-sort wavefront schedule (one insert per distinct bucket per
// round, mirroring the BN254 batch-affine accumulator above) lets eight
// *independent* bucket updates of ONE proof's MSM run per vector op — the
// scalar prove path (sub-8 batch tails, consistency's 4 sub-proofs,
// threshold singles) gets the lockstep tier's per-instance efficiency
// without needing 8 proofs.
static ge msm_sparse_v8(const fixed_tab<ge, edniels>& ft, const int* cols,
                        const sc* scals, int nnz, bp_scratch& scr) {
    const int c = ft.c, nwin = ft.nwin;
    const uint32_t nbk = 1u << (c - 1);
    if (scr.digs.size() < (size_t)nnz * nwin)
        scr.digs.resize((size_t)nnz * nwin);
    for (int j = 0; j < nnz; j++)
        sc_recode_signed(scals[j], c, nwin, scr.digs.data() + (size_t)j * nwin);
    struct Ins {
        uint32_t bn;  // (bucket << 1) | negate
        uint32_t t;   // index into ft.tab: w * n + col
    };
    std::vector<Ins> all;
    all.reserve((size_t)nnz * nwin);
    std::vector<uint32_t> cnt(nbk, 0);
    for (int w = 0; w < nwin; w++) {
        const size_t row = (size_t)w * ft.n;
        for (int j = 0; j < nnz; j++) {
            int16_t d = scr.digs[(size_t)j * nwin + w];
            if (!d) continue;
            if (ft.is_inf[cols[j]]) continue;
            uint32_t b = d > 0 ? (uint32_t)d : (uint32_t)(-(int32_t)d);
            all.push_back(
                Ins{((b - 1) << 1) | (uint32_t)(d < 0),
                    (uint32_t)(row + (uint32_t)cols[j])});
            cnt[b - 1]++;
        }
    }
    if (all.empty()) return ge_identity();
    std::vector<uint32_t> off(nbk + 1, 0);
    uint32_t maxmult = 0;
    for (uint32_t b = 0; b < nbk; b++) {
        off[b + 1] = off[b] + cnt[b];
        if (cnt[b] > maxmult) maxmult = cnt[b];
    }
    std::vector<Ins> sorted(all.size());
    {
        std::vector<uint32_t> cursor(off.begin(), off.end() - 1);
        for (const Ins& e : all) sorted[cursor[e.bn >> 1]++] = e;
    }
    std::vector<uint32_t> active;
    active.reserve(nbk);
    for (uint32_t b = 0; b < nbk; b++)
        if (cnt[b]) active.push_back(b);
    // identity-initialized bucket arena (AoS ge, 160 B stride — the same
    // layout the lockstep tier scatters into)
    scr.buckets.resize(nbk);
    ge ident = ge_identity();
    for (uint32_t b = 0; b < nbk; b++) scr.buckets[b] = ident;
    uint8_t* barena = (uint8_t*)scr.buckets.data();
    const uint8_t* tbase = (const uint8_t*)ft.tab.data();
    const __m512i vzero = _mm512_setzero_si512();
    alignas(64) uint64_t boff_l[8], toff_l[8];
    for (uint32_t round = 0; round < maxmult && !active.empty(); round++) {
        size_t na = 0;
        const size_t nact = active.size();
        for (size_t a0 = 0; a0 < nact; a0 += 8) {
            int gs = (int)((nact - a0) < 8 ? (nact - a0) : 8);
            __mmask8 m = (__mmask8)((1u << gs) - 1);
            uint8_t negbits = 0;
            for (int p = 0; p < gs; p++) {
                uint32_t b = active[a0 + p];
                const Ins& e = sorted[off[b] + round];
                if (round + 1 < cnt[b]) active[na++] = b;
                boff_l[p] = (uint64_t)b * 160;
                uint64_t t = e.t;
                toff_l[p] = (t << 7) - (t << 3);  // t * 120
                if (e.bn & 1) negbits |= (uint8_t)(1u << p);
            }
            for (int p = gs; p < 8; p++) {
                boff_l[p] = 0;
                toff_l[p] = 0;
            }
            __mmask8 neg = (__mmask8)negbits;
            __m512i boff = _mm512_load_si512(boff_l);
            __m512i toff = _mm512_load_si512(toff_l);
            ge8 acc;
            for (int l = 0; l < 5; l++) {
                __m512i a0v = _mm512_add_epi64(boff, _mm512_set1_epi64(8 * l));
                __m512i a1v =
                    _mm512_add_epi64(boff, _mm512_set1_epi64(8 * (5 + l)));
                __m512i a2v =
                    _mm512_add_epi64(boff, _mm512_set1_epi64(8 * (10 + l)));
                __m512i a3v =
                    _mm512_add_epi64(boff, _mm512_set1_epi64(8 * (15 + l)));
                acc.X.v[l] =
                    _mm512_mask_i64gather_epi64(vzero, m, a0v, barena, 1);
                acc.Y.v[l] =
                    _mm512_mask_i64gather_epi64(vzero, m, a1v, barena, 1);
                acc.Z.v[l] =
                    _mm512_mask_i64gather_epi64(vzero, m, a2v, barena, 1);
                acc.T.v[l] =
                    _mm512_mask_i64gather_epi64(vzero, m, a3v, barena, 1);
            }
            fe8 ymx, ypx, t2d;
            const __m512i vone64 = _mm512_set1_epi64(1);
            for (int l = 0; l < 5; l++) {
                __m512i b0 = _mm512_add_epi64(toff, _mm512_set1_epi64(8 * l));
                __m512i b1 =
                    _mm512_add_epi64(toff, _mm512_set1_epi64(8 * (5 + l)));
                __m512i b2 =
                    _mm512_add_epi64(toff, _mm512_set1_epi64(8 * (10 + l)));
                __m512i fill = (l == 0) ? vone64 : vzero;
                ymx.v[l] = _mm512_mask_i64gather_epi64(fill, m, b0, tbase, 1);
                ypx.v[l] = _mm512_mask_i64gather_epi64(fill, m, b1, tbase, 1);
                t2d.v[l] = _mm512_mask_i64gather_epi64(vzero, m, b2, tbase, 1);
            }
            fe8 t2dn;
            {
                fe8 z8;
                for (int l = 0; l < 5; l++) z8.v[l] = vzero;
                t2dn = fe8_sub(z8, t2d);
            }
            fe8 bymx, bypx, bt2d;
            for (int l = 0; l < 5; l++) {
                bymx.v[l] = _mm512_mask_blend_epi64(neg, ymx.v[l], ypx.v[l]);
                bypx.v[l] = _mm512_mask_blend_epi64(neg, ypx.v[l], ymx.v[l]);
                bt2d.v[l] = _mm512_mask_blend_epi64(neg, t2d.v[l], t2dn.v[l]);
            }
            ge8 r = ge8_madd(acc, bymx, bypx, bt2d);
            for (int l = 0; l < 5; l++) {
                __m512i a0v = _mm512_add_epi64(boff, _mm512_set1_epi64(8 * l));
                __m512i a1v =
                    _mm512_add_epi64(boff, _mm512_set1_epi64(8 * (5 + l)));
                __m512i a2v =
                    _mm512_add_epi64(boff, _mm512_set1_epi64(8 * (10 + l)));
                __m512i a3v =
                    _mm512_add_epi64(boff, _mm512_set1_epi64(8 * (15 + l)));
                _mm512_mask_i64scatter_epi64(barena, m, a0v, r.X.v[l], 1);
                _mm512_mask_i64scatter_epi64(barena, m, a1v, r.Y.v[l], 1);
                _mm512_mask_i64scatter_epi64(barena, m, a2v, r.Z.v[l], 1);
                _mm512_mask_i64scatter_epi64(barena, m, a3v, r.T.v[l], 1);
            }
        }
        active.resize(na);
    }
    // weighted suffix-sum over the bucket arena (identity buckets flow
    // through the complete addition law)
    ge running = ge_identity(), total = ge_identity();
    bool run_set = false, tot_set = false;
    for (int64_t b = (int64_t)nbk - 1; b >= 0; b--) {
        if (cnt[b]) {
            running =
                run_set ? ge_add(running, scr.buckets[b]) : scr.buckets[b];
            run_set = true;
        }
        if (run_set) {
            total = tot_set ? ge_add(total, running) : running;
            tot_set = true;
        }
    }
    return tot_set ? total : ge_identity();
}

static inline void msm_slot8(const fixed_tab<ge, edniels>& ft, const int* cols,
                             const sc* scals8, int nnz, bp_scratch8& scr,
                             ge out[8]) {
    uint64_t t0 = bp_prof_on() ? bp_prof_now() : 0;
    if (TABM_ON && !ft.tabm.empty())
        msm_tab8(ft, cols, scals8, nnz, scr, out);
    else
        msm_sparse8(ft, cols, scals8, nnz, scr, out);
    if (t0) BP_PROF_MSM += bp_prof_now() - t0;
}
#endif  // ZKP_HAVE_IFMA8

static inline ge msm_slot(const fixed_tab<ge, edniels>& ft, const int* cols,
                          const sc* scals, int nnz, bp_scratch& scr) {
    if (TABM_ON && !ft.tabm.empty()) return msm_tab1(ft, cols, scals, nnz, scr);
#ifdef ZKP_HAVE_IFMA8
    // the wavefront kernel needs enough independent inserts per round to
    // fill its vector lanes; tiny slots (V/T/A) stay scalar
    if (nnz >= 8 && !std::getenv("LIBZKP_NO_IFMA"))
        return msm_sparse_v8(ft, cols, scals, nnz, scr);
#endif
    return msm_sparse(ft, cols, scals, nnz, scr);
}

// -- per-proof pipeline ------------------------------------------------------

struct bp_error {
    int code;  // 0 ok; 1 identity V; 2 bad params
};

// rnd layout per proof: a_blind, s_blind, s_L[0..n-1], s_R[0..n-1], t1b, t2b
// — each 64 wide bytes (from_bytes_mod_order_wide), matching the Python
// golden model's injected-randomness order.
static int bp_prove_one(const fixed_tab<ge, edniels>& vs,
                        const fixed_tab<ge, edniels>& as_tab,
                        const fixed_tab<ge, edniels>& ipp_tab, int n,
                        uint64_t value, const sc& gamma, const uint8_t* rnd,
                        const uint8_t* tr_state, uint8_t* out_v,
                        uint8_t* out_proof, bp_scratch& scr) {
    const int rounds = [&] {
        int r = 0, m = n;
        while (m > 1) {
            m >>= 1;
            r++;
        }
        return r;
    }();
    merlin_t t;
    t.s.load(tr_state);

    // randomness
    const uint8_t* rp = rnd;
    sc a_blind = sc_from_wide(rp);
    rp += 64;
    sc s_blind = sc_from_wide(rp);
    rp += 64;
    std::vector<sc> s_L(n), s_R(n);
    for (int i = 0; i < n; i++) {
        s_L[i] = sc_from_wide(rp);
        rp += 64;
    }
    for (int i = 0; i < n; i++) {
        s_R[i] = sc_from_wide(rp);
        rp += 64;
    }
    sc t1b = sc_from_wide(rp);
    rp += 64;
    sc t2b = sc_from_wide(rp);
    rp += 64;

    // phase 1: V = value*B + gamma*B_blinding  (vs basis: col0=B, col1=B_bl)
    sc val_sc{{value, 0, 0, 0}};
    {
        int cols[2] = {0, 1};
        sc svec[2] = {val_sc, gamma};
        ge V = msm_slot(vs, cols, svec, 2, scr);
        bp_compress(V, out_v);
    }
    bool v_zero = true;
    for (int i = 0; i < 32; i++) v_zero = v_zero && out_v[i] == 0;
    if (v_zero) return 1;  // identity commitment: reject like the host tier

    // phase 2: A (0/1 subset sum) and S (dense) over [B_bl] + G + H
    sc one{{1, 0, 0, 0}};
    ge A;
    {
        int col0 = 0;
        A = msm_slot(as_tab, &col0, &a_blind, 1, scr);
        const edniels* row0 = as_tab.tab.data();
        const ge* prow0 = as_tab.tab_pt.data();
        bool started = !sc_is_zero(a_blind);
        for (int i = 0; i < n; i++) {
            if ((value >> i) & 1) {  // a_L=1: +G_i ; a_R=0
                if (started)
                    A = ge_madd(A, row0[1 + i]);
                else {
                    A = prow0[1 + i];
                    started = true;
                }
            } else {  // a_L=0 ; a_R=-1: -H_i
                if (started)
                    A = ge_madd(A, edniels_neg(row0[1 + n + i]));
                else {
                    A = ge_neg(prow0[1 + n + i]);
                    started = true;
                }
            }
        }
    }
    ge S;
    {
        std::vector<int> cols(2 * n + 1);
        std::vector<sc> svec(2 * n + 1);
        cols[0] = 0;
        svec[0] = s_blind;
        for (int i = 0; i < n; i++) {
            cols[1 + i] = 1 + i;
            svec[1 + i] = s_L[i];
            cols[1 + n + i] = 1 + n + i;
            svec[1 + n + i] = s_R[i];
        }
        S = msm_slot(as_tab, cols.data(), svec.data(), 2 * n + 1, scr);
    }

    uint8_t A_c[32], S_c[32];
    bp_compress(A, A_c);
    bp_compress(S, S_c);

    t.append("dom-sep", (const uint8_t*)"rangeproof v1", 13);
    t.append_u64("n", (uint64_t)n);
    t.append_u64("m", 1);
    t.append("V", out_v, 32);
    t.append("A", A_c, 32);
    t.append("S", S_c, 32);
    sc y = t.challenge_scalar("y");
    sc z = t.challenge_scalar("z");
    sc z2 = sc_mul(z, z);

    // phase 3: t-polynomial commitments
    std::vector<sc> l0(n), r0(n), r1(n);
    {
        sc yi = one, pow2 = one;
        sc two{{2, 0, 0, 0}};
        for (int i = 0; i < n; i++) {
            sc aL{{(value >> i) & 1, 0, 0, 0}};
            l0[i] = sc_sub(aL, z);
            sc aR = sc_sub(aL, one);
            r0[i] = sc_add(sc_mul(yi, sc_add(aR, z)), sc_mul(z2, pow2));
            r1[i] = sc_mul(yi, s_R[i]);
            yi = sc_mul(yi, y);
            pow2 = sc_mul(pow2, two);
        }
    }
    sc t1 = sc_add(sc_inner(l0.data(), r1.data(), n),
                   sc_inner(s_L.data(), r0.data(), n));
    sc t2 = sc_inner(s_L.data(), r1.data(), n);
    uint8_t T1_c[32], T2_c[32];
    {
        int cols[2] = {0, 1};
        sc v1[2] = {t1, t1b};
        sc v2[2] = {t2, t2b};
        bp_compress(msm_slot(vs, cols, v1, 2, scr), T1_c);
        bp_compress(msm_slot(vs, cols, v2, 2, scr), T2_c);
    }
    t.append("T_1", T1_c, 32);
    t.append("T_2", T2_c, 32);
    sc x = t.challenge_scalar("x");

    // phase 4: blinded t(x) openings + IPP inputs
    std::vector<sc> av(n), bv(n);
    for (int i = 0; i < n; i++) {
        av[i] = sc_add(l0[i], sc_mul(s_L[i], x));
        bv[i] = sc_add(r0[i], sc_mul(r1[i], x));
    }
    sc t_x = sc_inner(av.data(), bv.data(), n);
    sc t_x_blinding =
        sc_add(sc_add(sc_mul(z2, gamma), sc_mul(x, t1b)),
               sc_mul(sc_mul(x, x), t2b));
    sc e_blinding = sc_add(a_blind, sc_mul(x, s_blind));
    uint8_t sbytes[32];
    sc_tobytes(t_x, sbytes);
    t.append("t_x", sbytes, 32);
    sc_tobytes(t_x_blinding, sbytes);
    t.append("t_x_blinding", sbytes, 32);
    sc_tobytes(e_blinding, sbytes);
    t.append("e_blinding", sbytes, 32);
    sc w = t.challenge_scalar("w");
    sc y_inv = sc_inv(y);

    // phase 5: inner-product argument over basis G + H + [B]
    std::vector<sc> gc(n, one), hc(n);
    {
        sc yi = one;
        for (int i = 0; i < n; i++) {
            hc[i] = yi;
            yi = sc_mul(yi, y_inv);
        }
    }
    t.append("dom-sep", (const uint8_t*)"ipp v1", 6);
    t.append_u64("n", (uint64_t)n);

    uint8_t* outp = out_proof;
    std::memcpy(outp, A_c, 32);
    std::memcpy(outp + 32, S_c, 32);
    std::memcpy(outp + 64, T1_c, 32);
    std::memcpy(outp + 96, T2_c, 32);
    sc_tobytes(t_x, outp + 128);
    sc_tobytes(t_x_blinding, outp + 160);
    sc_tobytes(e_blinding, outp + 192);
    uint8_t* lr = outp + 224;

    std::vector<int> cols(n + 1);
    std::vector<sc> svec(n + 1);
    int m = n;
    while (m > 1) {
        int half = m / 2;
        sc cL{{0, 0, 0, 0}}, cR{{0, 0, 0, 0}};
        for (int i = 0; i < half; i++) {
            cL = sc_add(cL, sc_mul(av[i], bv[half + i]));
            cR = sc_add(cR, sc_mul(av[half + i], bv[i]));
        }
        // L lane: a_lo against G-class k%m>=half, b_hi against H-class k%m<half
        int nnz = 0;
        for (int k = 0; k < n; k++) {
            int i = k % m;
            if (i >= half) {
                cols[nnz] = k;
                svec[nnz++] = sc_mul(av[i - half], gc[k]);
            } else {
                cols[nnz] = n + k;
                svec[nnz++] = sc_mul(bv[half + i], hc[k]);
            }
        }
        cols[nnz] = 2 * n;
        svec[nnz++] = sc_mul(cL, w);
        uint8_t L_c[32], R_c[32];
        bp_compress(msm_slot(ipp_tab, cols.data(), svec.data(), nnz, scr),
                    L_c);
        nnz = 0;
        for (int k = 0; k < n; k++) {
            int i = k % m;
            if (i < half) {
                cols[nnz] = k;
                svec[nnz++] = sc_mul(av[half + i], gc[k]);
            } else {
                cols[nnz] = n + k;
                svec[nnz++] = sc_mul(bv[i - half], hc[k]);
            }
        }
        cols[nnz] = 2 * n;
        svec[nnz++] = sc_mul(cR, w);
        bp_compress(msm_slot(ipp_tab, cols.data(), svec.data(), nnz, scr),
                    R_c);
        std::memcpy(lr, L_c, 32);
        std::memcpy(lr + 32, R_c, 32);
        lr += 64;
        t.append("L", L_c, 32);
        t.append("R", R_c, 32);
        sc u = t.challenge_scalar("u");
        sc u_inv = sc_inv(u);
        for (int i = 0; i < half; i++) {
            av[i] = sc_add(sc_mul(av[i], u), sc_mul(u_inv, av[half + i]));
            bv[i] = sc_add(sc_mul(bv[i], u_inv), sc_mul(u, bv[half + i]));
        }
        for (int k = 0; k < n; k++) {
            if ((k % m) < half) {
                gc[k] = sc_mul(gc[k], u_inv);
                hc[k] = sc_mul(hc[k], u);
            } else {
                gc[k] = sc_mul(gc[k], u);
                hc[k] = sc_mul(hc[k], u_inv);
            }
        }
        m = half;
    }
    sc_tobytes(av[0], lr);
    sc_tobytes(bv[0], lr + 32);
    (void)rounds;
    return 0;
}

// -- window-range partial of a fixed-table MSM (task unit for the Groth16
// five-MSM dispatcher: every task is ~a dozen window rows, so four G1 MSMs
// and one G2 MSM load-balance across cores regardless of their sizes) ------

template <typename PT, typename AF, PT (*ADD)(const PT&, const PT&),
          PT (*MADD)(const PT&, const AF&), PT (*INF)()>
PT fixed_msm_range(const fixed_tab<PT, AF>& ft, const uint8_t* scalars,
                   int w_lo, int w_hi) {
    uint64_t nbuckets = (1ULL << ft.c) - 1;
    std::vector<PT> buckets(nbuckets);
    std::vector<char> used(nbuckets, 0);
    for (int w = w_lo; w < w_hi; w++) {
        int shift = w * ft.c;
        const AF* trow = ft.tab.data() + (size_t)w * ft.n;
        const PT* prow = ft.tab_pt.data() + (size_t)w * ft.n;
        for (uint64_t i = 0; i < ft.n; i++) {
            int byte = shift >> 3, bit = shift & 7;
            if (byte >= 32) continue;
            const uint8_t* s = scalars + 32 * i;
            uint32_t frag = s[byte];
            if (byte + 1 < 32) frag |= (uint32_t)s[byte + 1] << 8;
            if (byte + 2 < 32) frag |= (uint32_t)s[byte + 2] << 16;
            uint64_t idx = (frag >> bit) & nbuckets;
            if (!idx || ft.is_inf[i]) continue;
            if (used[idx - 1])
                buckets[idx - 1] = MADD(buckets[idx - 1], trow[i]);
            else {
                buckets[idx - 1] = prow[i];
                used[idx - 1] = true;
            }
        }
    }
    PT running = INF(), total = INF();
    bool run_set = false, tot_set = false;
    for (int64_t idx = (int64_t)nbuckets - 1; idx >= 0; idx--) {
        if (used[idx]) {
            running = run_set ? ADD(running, buckets[idx]) : buckets[idx];
            run_set = true;
        }
        if (run_set) {
            total = tot_set ? ADD(total, running) : running;
            tot_set = true;
        }
    }
    return tot_set ? total : INF();
}

// -- RLC batch verification ---------------------------------------------------

// delta(y, z) = (z - z^2) <1, y^n> - z^3 <1, 2^n>  (single-party m=1)
static sc bp_delta(int n, const sc& y, const sc& z) {
    sc one{{1, 0, 0, 0}};
    sc sum_y{{0, 0, 0, 0}}, yi = one;
    for (int i = 0; i < n; i++) {
        sum_y = sc_add(sum_y, yi);
        yi = sc_mul(yi, y);
    }
    uint64_t s2 = (n >= 64) ? ~0ULL : ((1ULL << n) - 1);  // 2^n - 1 fits u64
    sc sum_2{{s2, 0, 0, 0}};
    sc z2 = sc_mul(z, z);
    return sc_sub(sc_mul(sc_sub(z, z2), sum_y), sc_mul(sc_mul(z2, z), sum_2));
}

static bool sc_read_canonical(const uint8_t* b, sc& out) {
    std::memcpy(out.v, b, 32);
    return sc_cmp(out, SC_L) < 0;
}

struct bp_verify_acc {
    sc acc_b{{0, 0, 0, 0}}, acc_bb{{0, 0, 0, 0}};
    sc g_acc[64], h_acc[64];
    std::vector<uint8_t> dyn_scalars;  // 32 B each
    std::vector<uint8_t> dyn_points;   // 128 B wire each
    bp_verify_acc() {
        for (int i = 0; i < 64; i++) g_acc[i] = h_acc[i] = sc{{0, 0, 0, 0}};
    }
    void dyn(const sc& s, const uint8_t* wire) {
        uint8_t sb[32];
        sc_tobytes(s, sb);
        dyn_scalars.insert(dyn_scalars.end(), sb, sb + 32);
        dyn_points.insert(dyn_points.end(), wire, wire + 128);
    }
};

// Replay + accumulate ONE instance's two verification relations, weighted by
// rho (IPP check) and sigma (t check). Mirrors models/bulletproofs.py
// verification_terms/check_terms exactly. Returns false on structural
// failure (bad point, identity commitment, non-canonical scalar).
static bool bp_verify_accumulate(const fixed_tab<ge, edniels>& /*unused*/,
                                 int n, const uint8_t* proof, size_t plen,
                                 const uint8_t* V, const uint8_t* tr_state,
                                 const sc& rho, const sc& sigma,
                                 bp_verify_acc& acc) {
    int rounds = 0;
    for (int m = n; m > 1; m >>= 1) rounds++;
    if (plen != (size_t)(9 + 2 * rounds) * 32) return false;
    const uint8_t* A_c = proof;
    const uint8_t* S_c = proof + 32;
    const uint8_t* T1_c = proof + 64;
    const uint8_t* T2_c = proof + 96;
    sc t_x, t_x_bl, e_bl, a_sc, b_sc;
    if (!sc_read_canonical(proof + 128, t_x)) return false;
    if (!sc_read_canonical(proof + 160, t_x_bl)) return false;
    if (!sc_read_canonical(proof + 192, e_bl)) return false;
    const uint8_t* lr = proof + 224;
    if (!sc_read_canonical(lr + 64 * rounds, a_sc)) return false;
    if (!sc_read_canonical(lr + 64 * rounds + 32, b_sc)) return false;

    static const uint8_t ZERO32[32] = {0};
    if (!std::memcmp(V, ZERO32, 32)) return false;  // identity commitment

    // decompress the dynamic points
    uint8_t V_w[128], A_w[128], S_w[128], T1_w[128], T2_w[128];
    if (!zkp_ristretto_decompress(V, V_w)) return false;
    if (!zkp_ristretto_decompress(A_c, A_w)) return false;
    if (!zkp_ristretto_decompress(S_c, S_w)) return false;
    if (!zkp_ristretto_decompress(T1_c, T1_w)) return false;
    if (!zkp_ristretto_decompress(T2_c, T2_w)) return false;
    std::vector<uint8_t> L_w(128 * rounds), R_w(128 * rounds);
    for (int j = 0; j < rounds; j++) {
        if (!std::memcmp(lr + 64 * j, ZERO32, 32)) return false;
        if (!std::memcmp(lr + 64 * j + 32, ZERO32, 32)) return false;
        if (!zkp_ristretto_decompress(lr + 64 * j, &L_w[128 * j])) return false;
        if (!zkp_ristretto_decompress(lr + 64 * j + 32, &R_w[128 * j]))
            return false;
    }

    // transcript replay
    merlin_t t;
    t.s.load(tr_state);
    t.append("dom-sep", (const uint8_t*)"rangeproof v1", 13);
    t.append_u64("n", (uint64_t)n);
    t.append_u64("m", 1);
    t.append("V", V, 32);
    t.append("A", A_c, 32);
    t.append("S", S_c, 32);
    sc y = t.challenge_scalar("y");
    sc z = t.challenge_scalar("z");
    t.append("T_1", T1_c, 32);
    t.append("T_2", T2_c, 32);
    sc x = t.challenge_scalar("x");
    t.append("t_x", proof + 128, 32);
    t.append("t_x_blinding", proof + 160, 32);
    t.append("e_blinding", proof + 192, 32);
    sc w = t.challenge_scalar("w");
    t.append("dom-sep", (const uint8_t*)"ipp v1", 6);
    t.append_u64("n", (uint64_t)n);
    std::vector<sc> u(rounds), u_sq(rounds), u_inv_sq(rounds);
    for (int j = 0; j < rounds; j++) {
        t.append("L", lr + 64 * j, 32);
        t.append("R", lr + 64 * j + 32, 32);
        u[j] = t.challenge_scalar("u");
        if (sc_is_zero(u[j])) return false;  // uninvertible challenge
        u_sq[j] = sc_mul(u[j], u[j]);
    }
    // batch inversion of the round challenges (Montgomery trick)
    sc allinv;
    {
        std::vector<sc> pref(rounds);
        sc run{{1, 0, 0, 0}};
        for (int j = 0; j < rounds; j++) {
            run = sc_mul(run, u[j]);
            pref[j] = run;
        }
        sc inv_all = sc_inv(run);
        allinv = inv_all;
        for (int j = rounds; j-- > 0;) {
            sc uj_inv = (j == 0) ? inv_all : sc_mul(inv_all, pref[j - 1]);
            inv_all = sc_mul(inv_all, u[j]);
            u_inv_sq[j] = sc_mul(uj_inv, uj_inv);
        }
    }
    // s[i] = prod u_j^{+-1}, + when bit (rounds-1-j) of i is set
    std::vector<sc> s(n);
    s[0] = allinv;
    for (int i = 1; i < n; i++) {
        int lg = 63 - __builtin_clzll((uint64_t)i);
        int k = 1 << lg;
        s[i] = sc_mul(s[i - k], u_sq[rounds - 1 - lg]);
    }

    sc z2 = sc_mul(z, z);
    sc x2 = sc_mul(x, x);
    sc zero{{0, 0, 0, 0}};
    // g_scalars[i] = -z - a*s[i]; h_scalars[i] = z + (z2*2^i - b*s[n-1-i])*y^-i
    sc y_inv = sc_inv(y);
    sc yi_inv{{1, 0, 0, 0}}, pow2{{1, 0, 0, 0}};
    sc two{{2, 0, 0, 0}};
    for (int i = 0; i < n; i++) {
        sc gs = sc_sub(sc_sub(zero, z), sc_mul(a_sc, s[i]));
        acc.g_acc[i] = sc_add(acc.g_acc[i], sc_mul(rho, gs));
        sc hs = sc_add(
            z, sc_mul(sc_sub(sc_mul(z2, pow2), sc_mul(b_sc, s[n - 1 - i])),
                      yi_inv));
        acc.h_acc[i] = sc_add(acc.h_acc[i], sc_mul(rho, hs));
        yi_inv = sc_mul(yi_inv, y_inv);
        pow2 = sc_mul(pow2, two);
    }
    sc c1_b = sc_sub(t_x, bp_delta(n, y, z));
    sc c2_b = sc_mul(w, sc_sub(t_x, sc_mul(a_sc, b_sc)));
    acc.acc_b = sc_add(acc.acc_b, sc_add(sc_mul(rho, c2_b), sc_mul(sigma, c1_b)));
    acc.acc_bb = sc_add(
        acc.acc_bb,
        sc_add(sc_mul(rho, sc_sub(zero, e_bl)), sc_mul(sigma, t_x_bl)));
    // c2_dyn: A*1, S*x, L_j*u_sq, R_j*u_inv_sq (weighted rho)
    acc.dyn(rho, A_w);
    acc.dyn(sc_mul(rho, x), S_w);
    for (int j = 0; j < rounds; j++) {
        acc.dyn(sc_mul(rho, u_sq[j]), &L_w[128 * j]);
        acc.dyn(sc_mul(rho, u_inv_sq[j]), &R_w[128 * j]);
    }
    // c1_dyn: V*(-z2), T1*(-x), T2*(-x2) (weighted sigma)
    acc.dyn(sc_mul(sigma, sc_sub(zero, z2)), V_w);
    acc.dyn(sc_mul(sigma, sc_sub(zero, x)), T1_w);
    acc.dyn(sc_mul(sigma, sc_sub(zero, x2)), T2_w);
    return true;
}

#ifdef ZKP_HAVE_IFMA8
// Eight proofs advanced in lockstep: scalar transcript/sc work per proof,
// every MSM slot (V, S, T1, T2, each IPP L/R) one msm_sparse8 call. Bit-
// identical schedule to bp_prove_one (differential tests pin both paths).
static int bp_prove_eight(const fixed_tab<ge, edniels>& vs,
                          const fixed_tab<ge, edniels>& as_tab,
                          const fixed_tab<ge, edniels>& ipp_tab, int n,
                          const uint64_t value[8], const sc gamma[8],
                          const uint8_t* rnd, size_t rstride,
                          const uint8_t* tr_states, uint8_t* out_v,
                          uint8_t* out_proofs, size_t plen, bp_scratch8& scr8,
                          bp_scratch& scr) {
    merlin_t t[8];
    for (int p = 0; p < 8; p++) t[p].s.load(tr_states + 203 * p);
    sc one{{1, 0, 0, 0}}, two{{2, 0, 0, 0}};

    // randomness
    sc a_blind[8], s_blind[8], t1b[8], t2b[8];
    std::vector<sc> s_L(8 * n), s_R(8 * n);
    for (int p = 0; p < 8; p++) {
        const uint8_t* rp = rnd + rstride * p;
        a_blind[p] = sc_from_wide(rp);
        s_blind[p] = sc_from_wide(rp + 64);
        for (int i = 0; i < n; i++)
            s_L[p * n + i] = sc_from_wide(rp + 64 * (2 + i));
        for (int i = 0; i < n; i++)
            s_R[p * n + i] = sc_from_wide(rp + 64 * (2 + n + i));
        t1b[p] = sc_from_wide(rp + 64 * (2 + 2 * n));
        t2b[p] = sc_from_wide(rp + 64 * (3 + 2 * n));
    }

    // phase 1: V = value*B + gamma*B_blinding
    {
        int cols[2] = {0, 1};
        std::vector<sc> sv(2 * 8);
        for (int p = 0; p < 8; p++) {
            sv[0 * 8 + p] = sc{{value[p], 0, 0, 0}};
            sv[1 * 8 + p] = gamma[p];
        }
        ge V[8];
        msm_slot8(vs, cols, sv.data(), 2, scr8, V);
        bp_compress8(ge8_from_pts(V), out_v);
    }
    for (int p = 0; p < 8; p++) {
        bool z = true;
        for (int i = 0; i < 32; i++) z = z && out_v[32 * p + i] == 0;
        if (z) return 1;
    }

    // phase 2: A (scalar 0/1 subset sums) and S (one 8-lane dense MSM)
    uint8_t A_c[8][32], S_c[8][32];
    {
        ge A_pts[8];
        for (int p = 0; p < 8; p++) {
            int col0 = 0;
            ge A = msm_slot(as_tab, &col0, &a_blind[p], 1, scr);
            const edniels* row0 = as_tab.tab.data();
            const ge* prow0 = as_tab.tab_pt.data();
            bool started = !sc_is_zero(a_blind[p]);
            for (int i = 0; i < n; i++) {
                if ((value[p] >> i) & 1) {
                    if (started)
                        A = ge_madd(A, row0[1 + i]);
                    else {
                        A = prow0[1 + i];
                        started = true;
                    }
                } else {
                    if (started)
                        A = ge_madd(A, edniels_neg(row0[1 + n + i]));
                    else {
                        A = ge_neg(prow0[1 + n + i]);
                        started = true;
                    }
                }
            }
            A_pts[p] = A;
        }
        bp_compress8(ge8_from_pts(A_pts), &A_c[0][0]);
    }
    {
        std::vector<int> cols(2 * n + 1);
        std::vector<sc> sv((2 * n + 1) * 8);
        cols[0] = 0;
        for (int i = 0; i < n; i++) {
            cols[1 + i] = 1 + i;
            cols[1 + n + i] = 1 + n + i;
        }
        for (int p = 0; p < 8; p++) {
            sv[0 * 8 + p] = s_blind[p];
            for (int i = 0; i < n; i++) {
                sv[(1 + i) * 8 + p] = s_L[p * n + i];
                sv[(1 + n + i) * 8 + p] = s_R[p * n + i];
            }
        }
        ge S[8];
        msm_slot8(as_tab, cols.data(), sv.data(), 2 * n + 1, scr8, S);
        bp_compress8(ge8_from_pts(S), &S_c[0][0]);
    }

    sc y[8], z[8], z2[8];
    for (int p = 0; p < 8; p++) {
        t[p].append("dom-sep", (const uint8_t*)"rangeproof v1", 13);
        t[p].append_u64("n", (uint64_t)n);
        t[p].append_u64("m", 1);
        t[p].append("V", out_v + 32 * p, 32);
        t[p].append("A", A_c[p], 32);
        t[p].append("S", S_c[p], 32);
        y[p] = t[p].challenge_scalar("y");
        z[p] = t[p].challenge_scalar("z");
        z2[p] = sc_mul(z[p], z[p]);
    }

    // phase 3: t-polynomial commitments
    std::vector<sc> l0(8 * n), r0(8 * n), r1(8 * n);
    sc t1v[8], t2v[8];
    for (int p = 0; p < 8; p++) {
        sc yi = one, pow2 = one;
        for (int i = 0; i < n; i++) {
            sc aL{{(value[p] >> i) & 1, 0, 0, 0}};
            l0[p * n + i] = sc_sub(aL, z[p]);
            sc aR = sc_sub(aL, one);
            r0[p * n + i] =
                sc_add(sc_mul(yi, sc_add(aR, z[p])), sc_mul(z2[p], pow2));
            r1[p * n + i] = sc_mul(yi, s_R[p * n + i]);
            yi = sc_mul(yi, y[p]);
            pow2 = sc_mul(pow2, two);
        }
        t1v[p] = sc_add(sc_inner(&l0[p * n], &r1[p * n], n),
                        sc_inner(&s_L[p * n], &r0[p * n], n));
        t2v[p] = sc_inner(&s_L[p * n], &r1[p * n], n);
    }
    uint8_t T1_c[8][32], T2_c[8][32];
    {
        int cols[2] = {0, 1};
        std::vector<sc> sv(2 * 8);
        ge T[8];
        for (int p = 0; p < 8; p++) {
            sv[0 * 8 + p] = t1v[p];
            sv[1 * 8 + p] = t1b[p];
        }
        msm_slot8(vs, cols, sv.data(), 2, scr8, T);
        bp_compress8(ge8_from_pts(T), &T1_c[0][0]);
        for (int p = 0; p < 8; p++) {
            sv[0 * 8 + p] = t2v[p];
            sv[1 * 8 + p] = t2b[p];
        }
        msm_slot8(vs, cols, sv.data(), 2, scr8, T);
        bp_compress8(ge8_from_pts(T), &T2_c[0][0]);
    }

    // phase 4: x challenge, blinded openings, IPP inputs
    std::vector<sc> av(8 * n), bv(8 * n), gc(8 * n), hc(8 * n);
    sc w[8];
    sc t_x[8], t_x_blinding[8], e_blinding[8];
    sc y_inv8[8];
    for (int p = 0; p < 8; p++) y_inv8[p] = y[p];
    sc_inv_batch(y_inv8, 8);
    for (int p = 0; p < 8; p++) {
        t[p].append("T_1", T1_c[p], 32);
        t[p].append("T_2", T2_c[p], 32);
        sc x = t[p].challenge_scalar("x");
        for (int i = 0; i < n; i++) {
            av[p * n + i] = sc_add(l0[p * n + i], sc_mul(s_L[p * n + i], x));
            bv[p * n + i] = sc_add(r0[p * n + i], sc_mul(r1[p * n + i], x));
        }
        t_x[p] = sc_inner(&av[p * n], &bv[p * n], n);
        t_x_blinding[p] = sc_add(
            sc_add(sc_mul(z2[p], gamma[p]), sc_mul(x, t1b[p])),
            sc_mul(sc_mul(x, x), t2b[p]));
        e_blinding[p] = sc_add(a_blind[p], sc_mul(x, s_blind[p]));
        uint8_t sb[32];
        sc_tobytes(t_x[p], sb);
        t[p].append("t_x", sb, 32);
        sc_tobytes(t_x_blinding[p], sb);
        t[p].append("t_x_blinding", sb, 32);
        sc_tobytes(e_blinding[p], sb);
        t[p].append("e_blinding", sb, 32);
        w[p] = t[p].challenge_scalar("w");
        sc y_inv = y_inv8[p];
        sc yi = one;
        for (int i = 0; i < n; i++) {
            gc[p * n + i] = one;
            hc[p * n + i] = yi;
            yi = sc_mul(yi, y_inv);
        }
        t[p].append("dom-sep", (const uint8_t*)"ipp v1", 6);
        t[p].append_u64("n", (uint64_t)n);
        uint8_t* outp = out_proofs + plen * p;
        std::memcpy(outp, A_c[p], 32);
        std::memcpy(outp + 32, S_c[p], 32);
        std::memcpy(outp + 64, T1_c[p], 32);
        std::memcpy(outp + 96, T2_c[p], 32);
        sc_tobytes(t_x[p], outp + 128);
        sc_tobytes(t_x_blinding[p], outp + 160);
        sc_tobytes(e_blinding[p], outp + 192);
    }

    // phase 5: IPP rounds in lockstep
    std::vector<int> cols(n + 1);
    std::vector<sc> sv((n + 1) * 8);
    int m = n, round = 0;
    while (m > 1) {
        int half = m / 2;
        sc cL[8], cR[8];
        for (int p = 0; p < 8; p++) {
            cL[p] = sc{{0, 0, 0, 0}};
            cR[p] = sc{{0, 0, 0, 0}};
            for (int i = 0; i < half; i++) {
                cL[p] = sc_add(cL[p],
                               sc_mul(av[p * n + i], bv[p * n + half + i]));
                cR[p] = sc_add(cR[p],
                               sc_mul(av[p * n + half + i], bv[p * n + i]));
            }
        }
        ge Lp[8], Rp[8];
        // L lane
        {
            int nnz = 0;
            for (int k = 0; k < n; k++) {
                int i = k % m;
                if (i >= half) {
                    cols[nnz] = k;
                    for (int p = 0; p < 8; p++)
                        sv[nnz * 8 + p] =
                            sc_mul(av[p * n + i - half], gc[p * n + k]);
                } else {
                    cols[nnz] = n + k;
                    for (int p = 0; p < 8; p++)
                        sv[nnz * 8 + p] =
                            sc_mul(bv[p * n + half + i], hc[p * n + k]);
                }
                nnz++;
            }
            cols[nnz] = 2 * n;
            for (int p = 0; p < 8; p++)
                sv[nnz * 8 + p] = sc_mul(cL[p], w[p]);
            nnz++;
            msm_slot8(ipp_tab, cols.data(), sv.data(), nnz, scr8, Lp);
        }
        // R lane
        {
            int nnz = 0;
            for (int k = 0; k < n; k++) {
                int i = k % m;
                if (i < half) {
                    cols[nnz] = k;
                    for (int p = 0; p < 8; p++)
                        sv[nnz * 8 + p] =
                            sc_mul(av[p * n + half + i], gc[p * n + k]);
                } else {
                    cols[nnz] = n + k;
                    for (int p = 0; p < 8; p++)
                        sv[nnz * 8 + p] =
                            sc_mul(bv[p * n + i - half], hc[p * n + k]);
                }
                nnz++;
            }
            cols[nnz] = 2 * n;
            for (int p = 0; p < 8; p++)
                sv[nnz * 8 + p] = sc_mul(cR[p], w[p]);
            nnz++;
            msm_slot8(ipp_tab, cols.data(), sv.data(), nnz, scr8, Rp);
        }
        uint8_t L_c8[8][32], R_c8[8][32];
        bp_compress8(ge8_from_pts(Lp), &L_c8[0][0]);
        bp_compress8(ge8_from_pts(Rp), &R_c8[0][0]);
        sc u8[8], u_inv8[8];
        for (int p = 0; p < 8; p++) {
            const uint8_t* L_c = L_c8[p];
            const uint8_t* R_c = R_c8[p];
            uint8_t* lr = out_proofs + plen * p + 224 + 64 * round;
            std::memcpy(lr, L_c, 32);
            std::memcpy(lr + 32, R_c, 32);
            t[p].append("L", L_c, 32);
            t[p].append("R", R_c, 32);
            u8[p] = t[p].challenge_scalar("u");
            u_inv8[p] = u8[p];
        }
        sc_inv_batch(u_inv8, 8);
        for (int p = 0; p < 8; p++) {
            sc u = u8[p];
            sc u_inv = u_inv8[p];
            for (int i = 0; i < half; i++) {
                av[p * n + i] = sc_add(sc_mul(av[p * n + i], u),
                                       sc_mul(u_inv, av[p * n + half + i]));
                bv[p * n + i] = sc_add(sc_mul(bv[p * n + i], u_inv),
                                       sc_mul(u, bv[p * n + half + i]));
            }
            for (int k = 0; k < n; k++) {
                if ((k % m) < half) {
                    gc[p * n + k] = sc_mul(gc[p * n + k], u_inv);
                    hc[p * n + k] = sc_mul(hc[p * n + k], u);
                } else {
                    gc[p * n + k] = sc_mul(gc[p * n + k], u);
                    hc[p * n + k] = sc_mul(hc[p * n + k], u_inv);
                }
            }
        }
        m = half;
        round++;
    }
    for (int p = 0; p < 8; p++) {
        uint8_t* lr = out_proofs + plen * p + 224 + 64 * round;
        sc_tobytes(av[p * n], lr);
        sc_tobytes(bv[p * n], lr + 32);
    }
    return 0;
}
#endif  // ZKP_HAVE_IFMA8

}  // namespace

extern "C" {

// Groth16 prove-side query MSMs (A, B_g1, H, L over G1; B_g2 over G2) as one
// call: every MSM is cut into ~8-window tasks and the whole task list runs
// under one OpenMP loop, so the G2 MSM no longer serializes after the G1s
// (maps ark-groth16's rayon-parallel prover internals, snark.rs:364).
// z: nz*32 scalars (shared by A / B_g1 / B_g2; L reads z + wit_off*32),
// h: nh*32. out: 4 G1 Jacobian (96B) A,B_g1,H,L then 1 G2 (192B) B_g2.
void zkp_groth16_prove_msms(int ha, int hb1, int hh, int hl, int hb2,
                            uint64_t nz, uint64_t nh, uint64_t wit_off,
                            const uint8_t* z, const uint8_t* h,
                            uint8_t* out) {
    struct task {
        int msm;  // 0..3 = G1 (a, b1, h, l), 4 = G2 (b2)
        int w_lo, w_hi;
    };
    const fixed_tab<bg1, g1aff>* g1t[4] = {&G1_FIXED[ha], &G1_FIXED[hb1],
                                           &G1_FIXED[hh], &G1_FIXED[hl]};
    const uint8_t* g1s[4] = {z, z, h, z + 32 * wit_off};
    uint64_t g1n[4] = {nz, nz, nh, nz - wit_off};
    const fixed_tab<bg2, g2aff>& g2t = G2_FIXED[hb2];
    (void)g1n;
    // Signed-digit recode once per scalar vector (carries cross the window
    // halves, so the tasks share these arrays); empty = not ba-eligible.
    std::vector<int16_t> dig[5];
    for (int m = 0; m < 4; m++)
        if (ba_eligible<bg1, g1aff, fq_ops>(*g1t[m])) {
            dig[m].resize((size_t)g1t[m]->n * g1t[m]->nwin);
            recode_signed(g1s[m], g1t[m]->n, g1t[m]->c, g1t[m]->nwin,
                          g1t[m]->is_inf, dig[m].data());
        }
    if (ba_eligible<bg2, g2aff, fq2_ops>(g2t)) {
        dig[4].resize((size_t)g2t.n * g2t.nwin);
        recode_signed(z, g2t.n, g2t.c, g2t.nwin, g2t.is_inf, dig[4].data());
    }
    std::vector<task> tasks;
    // Two window-halves per MSM (same reduction count as the sequential
    //2-chunk path — more tasks would each pay a full 2^c bucket reduction).
    // G2 halves first: they are the heaviest (~3x cost per add), and dynamic
    // scheduling balances best when the big tasks lead.
    {
        int mid = (g2t.nwin + 1) / 2;
        tasks.push_back({4, 0, mid});
        tasks.push_back({4, mid, g2t.nwin});
    }
    for (int m = 0; m < 4; m++) {
        int mid = (g1t[m]->nwin + 1) / 2;
        tasks.push_back({m, 0, mid});
        tasks.push_back({m, mid, g1t[m]->nwin});
    }
    std::vector<bg1> g1_parts(tasks.size());
    std::vector<bg2> g2_parts(tasks.size());
#ifdef _OPENMP
#pragma omp parallel for schedule(dynamic, 1)
#endif
    for (int64_t t = 0; t < (int64_t)tasks.size(); t++) {
        const task& tk = tasks[t];
        if (tk.msm == 4)
            g2_parts[t] =
                dig[4].empty()
                    ? fixed_msm_range<bg2, g2aff, bg2_add, bg2_madd, bg2_inf>(
                          g2t, z, tk.w_lo, tk.w_hi)
                    : g2_msm_range(g2t, dig[4].data(), tk.w_lo, tk.w_hi);
        else
            g1_parts[t] =
                dig[tk.msm].empty()
                    ? fixed_msm_range<bg1, g1aff, bg1_add, bg1_madd, bg1_inf>(
                          *g1t[tk.msm], g1s[tk.msm], tk.w_lo, tk.w_hi)
                    : g1_msm_range(*g1t[tk.msm], dig[tk.msm].data(), tk.w_lo,
                                   tk.w_hi);
    }
    bg1 g1_acc[4] = {bg1_inf(), bg1_inf(), bg1_inf(), bg1_inf()};
    bg2 g2_acc = bg2_inf();
    for (size_t t = 0; t < tasks.size(); t++) {
        if (tasks[t].msm == 4)
            g2_acc = bg2_add(g2_acc, g2_parts[t]);
        else
            g1_acc[tasks[t].msm] = bg1_add(g1_acc[tasks[t].msm], g1_parts[t]);
    }
    for (int m = 0; m < 4; m++) bg1_to_wire(g1_acc[m], out + 96 * m);
    bg2_to_wire(g2_acc, out + 384);
}

// RLC batch verification of range-proof instances (one grand MSM).
// h_fix: registered [B_blinding, B] + G(64) + H(64) table. Per instance:
// ns[i] (8..64), proof bytes at proof_offs[i] in proof_blob, V (32 B),
// transcript snapshot (203 B), rho/sigma weights (32 B canonical scalars).
// Returns 1 = combined relation holds, 0 = it does not, 2 = structural
// failures present (bad_out[i] = 1; relation NOT evaluated — caller drops
// the bad instances' groups and calls again).
int zkp_bp_verify_rlc(int h_fix, uint64_t count, const uint8_t* ns,
                      const uint32_t* proof_offs, const uint8_t* proof_blob,
                      const uint8_t* vs, const uint8_t* trans,
                      const uint8_t* rhos, const uint8_t* sigmas,
                      uint8_t* bad_out) {
    std::vector<bp_verify_acc> partial;
    int bad = 0;
#ifdef _OPENMP
    int nthreads = count >= 8 ? 2 : 1;
#else
    int nthreads = 1;
#endif
    partial.resize(nthreads);
    const fixed_tab<ge, edniels>& ft = ED_FIXED[h_fix];
#ifdef _OPENMP
#pragma omp parallel for schedule(static) num_threads(nthreads) \
    reduction(| : bad)
#endif
    for (int64_t i = 0; i < (int64_t)count; i++) {
#ifdef _OPENMP
        bp_verify_acc& acc = partial[omp_get_thread_num() % nthreads];
#else
        bp_verify_acc& acc = partial[0];
#endif
        sc rho = sc_frombytes(rhos + 32 * i);
        sc sigma = sc_frombytes(sigmas + 32 * i);
        // proof_offs has count+1 entries (the last is the blob length)
        size_t off = proof_offs[i];
        size_t plen = proof_offs[i + 1] - off;
        bool ok = bp_verify_accumulate(ft, ns[i], proof_blob + off, plen,
                                       vs + 32 * i, trans + 203 * i, rho,
                                       sigma, acc);
        bad_out[i] = ok ? 0 : 1;
        bad |= !ok;
    }
    if (bad) return 2;
    // merge thread partials
    bp_verify_acc& acc = partial[0];
    for (int p = 1; p < nthreads; p++) {
        acc.acc_b = sc_add(acc.acc_b, partial[p].acc_b);
        acc.acc_bb = sc_add(acc.acc_bb, partial[p].acc_bb);
        for (int i = 0; i < 64; i++) {
            acc.g_acc[i] = sc_add(acc.g_acc[i], partial[p].g_acc[i]);
            acc.h_acc[i] = sc_add(acc.h_acc[i], partial[p].h_acc[i]);
        }
        acc.dyn_scalars.insert(acc.dyn_scalars.end(),
                               partial[p].dyn_scalars.begin(),
                               partial[p].dyn_scalars.end());
        acc.dyn_points.insert(acc.dyn_points.end(),
                              partial[p].dyn_points.begin(),
                              partial[p].dyn_points.end());
    }
    // fixed-basis part over [B_blinding, B] + G + H
    uint8_t fix_scalars[130 * 32];
    sc_tobytes(acc.acc_bb, fix_scalars);
    sc_tobytes(acc.acc_b, fix_scalars + 32);
    for (int i = 0; i < 64; i++) {
        sc_tobytes(acc.g_acc[i], fix_scalars + 32 * (2 + i));
        sc_tobytes(acc.h_acc[i], fix_scalars + 32 * (66 + i));
    }
    ge c_fixed = fixed_msm<ge, edniels, ge_add, ge_madd, ge_double,
                           ge_identity>(ft, fix_scalars);
    uint8_t dyn_out[128];
    ed_msm_native(acc.dyn_points.size() / 128, acc.dyn_scalars.data(),
                  acc.dyn_points.data(), dyn_out);
    ge total = ge_add(c_fixed, ge_from_wire(dyn_out));
    uint8_t comp[32];
    bp_compress(total, comp);
    for (int i = 0; i < 32; i++)
        if (comp[i]) return 0;
    return 1;
}

// 0 = vector tier matches the scalar tier; -1 = not compiled in.
int zkp_simd_selftest() {
#ifdef ZKP_HAVE_IFMA8
    int r = fe8_selftest();
    if (r) return r;
#ifdef ZKP_HAVE_BFQ8
    r = bfq8_selftest();
    if (r) return 10 + r;
#endif
    return 0;
#else
    return -1;
#endif
}

// Batch range-proof prover over registered ED_FIXED bases. Returns 0, or the
// first per-proof error code (1 = identity value commitment).
// proof stride: (9 + 2*log2(n)) * 32 bytes; rnd stride: (2n + 4) * 64 bytes.
int zkp_bp_prove_batch(int h_vs, int h_as, int h_ipp, uint64_t n,
                       uint64_t batch, const uint8_t* values,
                       const uint8_t* gammas, const uint8_t* rnd,
                       const uint8_t* transcripts, uint8_t* out_v,
                       uint8_t* out_proofs) {
    fixed_tab<ge, edniels>& vs = ED_FIXED[h_vs];
    fixed_tab<ge, edniels>& as_tab = ED_FIXED[h_as];
    fixed_tab<ge, edniels>& ipp_tab = ED_FIXED[h_ipp];
    // Build the table-of-multiples tier once (before the parallel region so
    // every worker sees a completed table); engage it for batches large
    // enough to keep it warm across lockstep groups.
    const bool want_tabm = batch >= ZKP_TABM_MIN_BATCH;
    if (want_tabm) {
        ensure_tabm_ed(vs);
        ensure_tabm_ed(as_tab);
        ensure_tabm_ed(ipp_tab);
    }
    int rounds = 0;
    for (uint64_t m = n; m > 1; m >>= 1) rounds++;
    size_t plen = (9 + 2 * (size_t)rounds) * 32;
    size_t rstride = (2 * n + 4) * 64;
    int err = 0;
    uint64_t ngroups = 0;  // leading groups of 8 on the IFMA lockstep path
    bool pad_tail = false;  // run the 1..7-instance tail as one padded group
#ifdef ZKP_HAVE_IFMA8
    if (!std::getenv("LIBZKP_NO_IFMA")) {
        ngroups = batch / 8;
        // Within a large (warm-table) batch a padded 8-lane call beats
        // 1..7 scalar tail pipelines; for small batches the per-lane
        // scalar work of 8 lanes swamps the tail, so it stays scalar.
        pad_tail = (batch % 8) != 0 && want_tabm && !as_tab.tabm.empty();
    }
#endif
#ifdef _OPENMP
#pragma omp parallel
#endif
    {
        TABM_ON = want_tabm && !as_tab.tabm.empty();
        bp_scratch scr;
#ifdef ZKP_HAVE_IFMA8
        bp_scratch8 scr8;
#ifdef _OPENMP
#pragma omp for schedule(dynamic, 1) nowait
#endif
        for (int64_t g = 0; g < (int64_t)ngroups; g++) {
            uint64_t value[8];
            sc gamma[8];
            for (int p = 0; p < 8; p++) {
                std::memcpy(&value[p], values + 8 * (8 * g + p), 8);
                gamma[p] = sc_frombytes(gammas + 32 * (8 * g + p));
            }
            int rc = bp_prove_eight(
                vs, as_tab, ipp_tab, (int)n, value, gamma,
                rnd + rstride * 8 * g, rstride, transcripts + 203 * 8 * g,
                out_v + 32 * 8 * g, out_proofs + plen * 8 * g, plen, scr8,
                scr);
            if (rc) {
#ifdef _OPENMP
#pragma omp critical
#endif
                err = rc;
            }
        }
#endif
#ifdef _OPENMP
#pragma omp for schedule(dynamic, 1)
#endif
        for (int64_t b = (int64_t)(ngroups * 8); b < (int64_t)batch; b++) {
            if (pad_tail) continue;  // tail handled below as one padded group
            uint64_t value;
            std::memcpy(&value, values + 8 * b, 8);
            sc gamma = sc_frombytes(gammas + 32 * b);
            int rc = bp_prove_one(vs, as_tab, ipp_tab, (int)n, value, gamma,
                                  rnd + rstride * b, transcripts + 203 * b,
                                  out_v + 32 * b, out_proofs + plen * b, scr);
            if (rc) {
#ifdef _OPENMP
#pragma omp critical
#endif
                err = rc;
            }
        }
    }
#ifdef ZKP_HAVE_IFMA8
    if (pad_tail && !err) {
        // Duplicate the tail's instances into the dummy lanes (their outputs
        // are discarded; reused randomness never leaves this call), prove
        // all 8 lanes in lockstep, copy back the real lanes.
        const uint64_t b0 = ngroups * 8, tail = batch - b0;
        uint64_t value[8];
        sc gamma[8];
        std::vector<uint8_t> rnd8(rstride * 8), tr8(203 * 8);
        std::vector<uint8_t> v8(32 * 8), p8(plen * 8);
        for (int p = 0; p < 8; p++) {
            uint64_t src = b0 + ((uint64_t)p < tail ? (uint64_t)p : tail - 1);
            std::memcpy(&value[p], values + 8 * src, 8);
            gamma[p] = sc_frombytes(gammas + 32 * src);
            std::memcpy(rnd8.data() + rstride * p, rnd + rstride * src,
                        rstride);
            std::memcpy(tr8.data() + 203 * p, transcripts + 203 * src, 203);
        }
        bp_scratch scr;
        bp_scratch8 scr8;
        int rc = bp_prove_eight(vs, as_tab, ipp_tab, (int)n, value, gamma,
                                rnd8.data(), rstride, tr8.data(), v8.data(),
                                p8.data(), plen, scr8, scr);
        if (rc) {
            err = rc;
        } else {
            std::memcpy(out_v + 32 * b0, v8.data(), 32 * tail);
            std::memcpy(out_proofs + plen * b0, p8.data(), plen * tail);
        }
    }
#endif
    if (bp_prof_on()) {
        std::fprintf(stderr,
                     "[bp_prof] batch=%llu msm=%.1fms comp=%.1fms (core-ms "
                     "at 2.1GHz)\n",
                     (unsigned long long)batch,
                     BP_PROF_MSM.load() / 2.1e6, BP_PROF_COMP.load() / 2.1e6);
        BP_PROF_MSM = 0;
        BP_PROF_COMP = 0;
    }
    return err;
}

// Batched compressed Pedersen commitments over the 2-column (B, B_blinding)
// fixed table `h_vs`: scalars = count * 64 B (value32 || blinding32 per
// commit), out = count * 32 B RFC 9496 encodings. 8-lane msm + lockstep
// compression; returns -1 when the IFMA tier is compiled out (caller falls
// back to the scalar path).
int zkp_ed_pedersen_compressed(int h_vs, uint64_t count,
                               const uint8_t* scalars, uint8_t* out) {
#ifdef ZKP_HAVE_IFMA8
    fixed_tab<ge, edniels>& vs = ED_FIXED[h_vs];
    if (count >= ZKP_TABM_MIN_BATCH) ensure_tabm_ed(vs);
    TABM_ON = count >= ZKP_TABM_MIN_BATCH && !vs.tabm.empty();
    bp_scratch8 scr;
    int cols[2] = {0, 1};
    for (uint64_t g0 = 0; g0 < count; g0 += 8) {
        int gs = (int)((count - g0) < 8 ? (count - g0) : 8);
        sc sv[16];
        for (int p = 0; p < 8; p++) {
            uint64_t src = g0 + (uint64_t)(p < gs ? p : 0);
            sv[0 * 8 + p] = sc_frombytes(scalars + 64 * src);
            sv[1 * 8 + p] = sc_frombytes(scalars + 64 * src + 32);
        }
        ge V[8];
        msm_slot8(vs, cols, sv, 2, scr, V);
        uint8_t c8[8][32];
        bp_compress8(ge8_from_pts(V), &c8[0][0]);
        for (int p = 0; p < gs; p++)
            std::memcpy(out + 32 * (g0 + p), c8[p], 32);
    }
    return 0;
#else
    (void)h_vs;
    (void)count;
    (void)scalars;
    (void)out;
    return -1;
#endif
}

}  // extern "C"
