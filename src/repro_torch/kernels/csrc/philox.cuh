// Philox-4x32-10 on the device, bit for bit the port's counter-based
// generator (src/repro_torch/core/prng.py::philox): a key of two 32-bit
// words, a counter of four, ten rounds with the Random123 multipliers and
// Weyl increments, the key bumped between rounds and not after the last.
// Counter word 3 names the use of a block: 0 for draws (prng._DRAW), so a
// kernel that draws block (i, 0, 0, 0) of a row's key reads the same words
// as prng.bits / prng.uniform do for that key.
#pragma once
#include <stdint.h>

namespace philox {

constexpr uint32_t M0 = 0xD2511F53u, M1 = 0xCD9E8D57u;
constexpr uint32_t W0 = 0x9E3779B9u, W1 = 0xBB67AE85u;
constexpr uint32_t DRAW = 0u;

struct Block {
  uint32_t w[4];
};

__device__ __forceinline__ Block block(uint32_t c0, uint32_t c1, uint32_t c2, uint32_t c3,
                                       uint32_t k0, uint32_t k1) {
#pragma unroll
  for (int r = 0; r < 10; ++r) {
    const uint32_t hi0 = __umulhi(M0, c0), lo0 = M0 * c0;
    const uint32_t hi1 = __umulhi(M1, c2), lo1 = M1 * c2;
    const uint32_t n0 = hi1 ^ c1 ^ k0, n2 = hi0 ^ c3 ^ k1;
    c0 = n0;
    c1 = lo1;
    c2 = n2;
    c3 = lo0;
    if (r < 9) {
      k0 += W0;
      k1 += W1;
    }
  }
  return Block{{c0, c1, c2, c3}};
}

// a uniform in [0, 1) from a word, as jax.random.uniform and
// prng.uniform_from_bits make it: 23 high bits into the mantissa of a
// float in [1, 2), minus 1 (exact)
__device__ __forceinline__ float uniform(uint32_t bits) {
  return __uint_as_float((bits >> 9) | 0x3F800000u) - 1.0f;
}

}  // namespace philox
