// Modular arithmetic on u32 residues for q < 2^31, as in
// fhe_fed_tpu/rns/modops.py (the JAX package's u32 formulas). Residues are
// stored as non-negative int32; Shoup companion words as int64 and
// truncated to their low 32 bits here.
#pragma once

#include <cstdint>

__device__ __forceinline__ uint32_t add_mod(uint32_t a, uint32_t b, uint32_t q) {
  uint32_t s = a + b;  // < 2^32 for a, b < q < 2^31
  return s >= q ? s - q : s;
}

__device__ __forceinline__ uint32_t sub_mod(uint32_t a, uint32_t b, uint32_t q) {
  return a >= b ? a - b : a - b + q;
}

// x * w mod q for any u32 x and a constant w < q with w_shoup =
// floor(w * 2^32 / q): r = x*w - hi(x*w_shoup)*q lies in [0, 2q).
__device__ __forceinline__ uint32_t mul_mod_shoup(uint32_t x, uint32_t w,
                                                  uint32_t w_shoup, uint32_t q) {
  uint32_t qhat = __umulhi(x, w_shoup);
  uint32_t r = x * w - qhat * q;
  return r >= q ? r - q : r;
}
