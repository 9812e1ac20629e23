// The fold product in BN254 Fq with the field's constants written into the
// code: bn_fq_mul, fe_mul_inline's integer operations (fold_curves.cuh)
// with the bn254_g1 consts block's ONE and FOLD rows as immediates and
// their zero limbs left out. P4's BN254 kernel (probes.cu) runs it.
//
// ONE = 2^288 mod q and FOLD[k] = 2^(12(24 + k)) mod q are full 254-bit
// values: ONE has 21 nonzero limbs, the 26 FOLD rows 564 of their 624
// (limbs 21 to 23 are 0, 1 or 2). CONSTS holds the 27 rows as
// weierstrass.get_engine("bn254_g1").consts_np does (pinned by
// tests/test_torch_probes.py). A namespace-scope constexpr array is a host
// variable: device code may read its elements only through a constexpr call
// that is a constant expression. So every term is a template instance whose
// constant is fixed at compile time (limb(row, i) in a constexpr
// initialiser), a zero constant drops its term (if constexpr), and each
// nonzero one is an immediate operand: the product reads no constant bank
// and no consts block. Each sum keeps its nonzero terms in fe_mul_inline's
// order, so the limbs are fe_mul_inline's, and its int32 headroom argument
// (fold_curves.cuh) holds unchanged.
#pragma once

#include "fold_curves.cuh"

namespace bnfq {

constexpr int32_t CONSTS[fold::N + 3][fold::N] = {
    {3446, 2047, 1515, 3442, 3457, 2567, 2430, 840, 2813, 3721, 1150, 3202, 859, 1038, 439, 295, 622, 1730, 3820, 55, 1724, 0, 0, 0},  // ONE
    {3446, 2047, 1515, 3442, 3457, 2567, 2430, 840, 2813, 3721, 1150, 3202, 859, 1038, 439, 295, 622, 1730, 3820, 55, 1724, 0, 0, 0},  // FOLD[0]
    {4074, 2230, 2553, 1853, 3322, 1539, 3337, 168, 2950, 2184, 2867, 2168, 643, 3478, 2261, 2955, 1090, 2692, 3417, 1071, 225, 0, 0, 0},  // FOLD[1]
    {2426, 3542, 3618, 527, 1493, 4036, 374, 2555, 672, 1273, 2749, 642, 2325, 1644, 2415, 1122, 3964, 3773, 1387, 646, 1841, 1, 0, 0},  // FOLD[2]
    {147, 728, 4048, 2799, 1149, 1556, 923, 878, 255, 3294, 3131, 354, 1970, 484, 4062, 1142, 1146, 1802, 2550, 3261, 352, 0, 0, 0},  // FOLD[3]
    {3028, 1638, 2239, 2090, 3120, 1161, 1612, 3682, 2442, 1722, 1079, 2965, 710, 3207, 589, 1944, 399, 3249, 2303, 309, 3914, 1, 0, 0},  // FOLD[4]
    {2456, 3606, 1817, 2042, 1921, 3537, 3428, 187, 3666, 3877, 3991, 949, 2475, 1549, 2927, 2664, 2061, 3204, 855, 443, 938, 1, 0, 0},  // FOLD[5]
    {640, 691, 3818, 3537, 1131, 1812, 2363, 3882, 3988, 2822, 1628, 2450, 2807, 1294, 235, 2771, 2874, 3836, 1217, 1196, 1469, 1, 0, 0},  // FOLD[6]
    {432, 3257, 3760, 166, 995, 617, 1853, 3613, 2571, 3253, 2580, 1105, 2023, 3786, 4094, 1243, 3830, 71, 3176, 1830, 952, 0, 0, 0},  // FOLD[7]
    {1770, 3269, 1839, 368, 187, 39, 4088, 1411, 1987, 3648, 224, 1000, 2987, 2617, 2376, 3799, 431, 271, 2065, 2265, 3102, 2, 0, 0},  // FOLD[8]
    {1638, 1413, 790, 476, 3765, 10, 4031, 2363, 154, 3389, 3686, 654, 3913, 2907, 357, 795, 3665, 1101, 101, 1047, 457, 1, 0, 0},  // FOLD[9]
    {409, 2454, 1742, 2545, 1668, 2509, 2114, 3951, 2148, 866, 1421, 1667, 2342, 83, 390, 2151, 3542, 615, 1641, 3407, 1637, 1, 0, 0},  // FOLD[10]
    {1903, 3627, 3344, 1788, 1284, 3843, 1905, 1565, 1299, 2215, 1763, 960, 526, 2460, 3145, 3042, 915, 2125, 369, 2851, 1742, 2, 0, 0},  // FOLD[11]
    {3380, 349, 3336, 3007, 1399, 2191, 1191, 2614, 1229, 610, 3359, 3545, 1150, 3769, 2898, 1517, 1202, 2538, 1916, 3030, 1124, 2, 0, 0},  // FOLD[12]
    {456, 192, 1214, 1498, 1066, 449, 2972, 2838, 1221, 1067, 2965, 2750, 426, 2077, 2045, 758, 4092, 962, 1165, 2586, 1286, 1, 0, 0},  // FOLD[13]
    {2971, 2182, 3667, 3217, 4012, 3228, 3885, 3759, 2717, 3916, 82, 2671, 1253, 3403, 937, 2720, 266, 572, 215, 520, 269, 2, 0, 0},  // FOLD[14]
    {3909, 486, 3385, 1273, 3319, 3597, 2707, 3321, 2045, 2824, 3835, 2281, 2108, 1174, 928, 1881, 717, 3548, 3024, 3844, 2586, 1, 0, 0},  // FOLD[15]
    {3673, 1772, 4056, 38, 33, 442, 2369, 1717, 3139, 3188, 692, 1794, 3022, 2820, 2826, 3285, 3929, 3932, 1198, 3324, 3451, 1, 0, 0},  // FOLD[16]
    {2311, 3025, 3842, 2733, 3825, 2128, 3235, 2672, 1932, 1897, 1246, 3890, 2917, 75, 919, 1445, 1594, 1242, 3738, 2964, 2915, 1, 0, 0},  // FOLD[17]
    {1822, 3377, 3989, 1940, 3065, 394, 70, 318, 2513, 2653, 1427, 743, 3588, 731, 2321, 1321, 3042, 182, 459, 2391, 3926, 0, 0, 0},  // FOLD[18]
    {3586, 2906, 1927, 2776, 2702, 2635, 3210, 1846, 3066, 1771, 47, 1259, 277, 2106, 356, 161, 417, 513, 1769, 1443, 3265, 0, 0, 0},  // FOLD[19]
    {2495, 265, 228, 67, 3498, 1543, 3474, 2320, 3159, 1143, 3417, 2311, 3263, 3415, 613, 959, 201, 3840, 3800, 3205, 3804, 1, 0, 0},  // FOLD[20]
    {1940, 1339, 2094, 2898, 1069, 3346, 3934, 769, 1395, 1314, 1699, 938, 3406, 2729, 1549, 2357, 2578, 2918, 3409, 2070, 3349, 0, 0, 0},  // FOLD[21]
    {1531, 4064, 2838, 3009, 2708, 2173, 3633, 1309, 59, 2934, 3837, 1239, 345, 2606, 3381, 1499, 1229, 153, 1949, 2469, 1623, 1, 0, 0},  // FOLD[22]
    {3211, 460, 3773, 3658, 1878, 1634, 3404, 1576, 1287, 216, 1365, 840, 1640, 3951, 1850, 1446, 431, 2988, 2855, 4083, 1205, 0, 0, 0},  // FOLD[23]
    {2974, 1902, 3386, 516, 945, 3615, 3450, 1853, 2072, 460, 3917, 3900, 3120, 2706, 781, 3694, 1225, 3903, 400, 3006, 1025, 2, 0, 0},  // FOLD[24]
    {2031, 244, 3255, 1787, 2721, 838, 3144, 2900, 3723, 609, 2951, 813, 1210, 2106, 3283, 1750, 3549, 2612, 2281, 1531, 476, 2, 0, 0},  // FOLD[25]
};

constexpr __host__ __device__ int32_t limb(int row, int i) { return CONSTS[row][i]; }

// t[I] + sum over k of t[N + k] * FOLD[k][I], nonzero terms in the order of k.
template <int I, int K = 0>
__device__ __forceinline__ int32_t fold_sum(int32_t acc, const int32_t* t) {
  if constexpr (K < fold::N + 2) {
    constexpr int32_t c = limb(fold::ROW_FOLD + K, I);
    if constexpr (c != 0) acc += t[fold::N + K] * c;
    return fold_sum<I, K + 1>(acc, t);
  } else {
    return acc;
  }
}

// r[i] = fold_sum<i>(t[i]) for i = 0..N-1.
template <int I = 0>
__device__ __forceinline__ void fold_rows(int32_t* r, const int32_t* t) {
  if constexpr (I < fold::N) {
    r[I] = fold_sum<I>(t[I], t);
    fold_rows<I + 1>(r, t);
  }
}

// x[i] += top * ONE[i] for the nonzero limbs of ONE, i ascending.
template <int I = 0>
__device__ __forceinline__ void wrap_one(int32_t* x, int32_t top) {
  if constexpr (I < fold::N) {
    constexpr int32_t c = limb(fold::ROW_ONE, I);
    if constexpr (c != 0) x[I] += top * c;
    wrap_one<I + 1>(x, top);
  }
}

}  // namespace bnfq

// One wrap-carry pass in BN254 Fq: fe_carry with ONE in the code.
__device__ __forceinline__ void bn_fq_carry(int32_t* x) {
  using namespace fold;
  const int32_t top = x[N - 1] >> LIMB_BITS;
#pragma unroll
  for (int i = N - 1; i > 0; --i) x[i] = (x[i] & MASK) + (x[i - 1] >> LIMB_BITS);
  x[0] &= MASK;
  bnfq::wrap_one(x, top);
}

// r = a * b mod q, as fe_mul_inline over the bn254_g1 consts block; r may
// alias a or b: every read of a and b comes before the first write of r.
__device__ __forceinline__ void bn_fq_mul(int32_t* r, const int32_t* a, const int32_t* b) {
  using namespace fold;
  int32_t t[NCOL];
#pragma unroll
  for (int k = 0; k < NCOL; ++k) t[k] = 0;
#pragma unroll
  for (int i = 0; i < N; ++i) {
    const int32_t ai = a[i];
#pragma unroll
    for (int j = 0; j < N; ++j) t[i + j] += ai * b[j];
  }
#pragma unroll
  for (int pass = 0; pass < 2; ++pass) {
#pragma unroll
    for (int k = NCOL - 1; k > 0; --k) t[k] = (t[k] & MASK) + (t[k - 1] >> LIMB_BITS);
    t[0] &= MASK;
  }
  bnfq::fold_rows(r, t);
  bn_fq_carry(r);
  bn_fq_carry(r);
  bn_fq_carry(r);
}
