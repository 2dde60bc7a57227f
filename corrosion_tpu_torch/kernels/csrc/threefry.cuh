// The threefry2x32 block hash, shared by every kernel that draws random
// bits (K5 here; a kernel that fuses its draws includes this header).
//
// Bit for bit jax's threefry2x32 (jax/_src/prng.py
// `_threefry2x32_lowering`): 20 rounds in five groups of four, rotation
// sets (13, 15, 26, 6) and (17, 29, 16, 24), a key injection after each
// group with the third key word k1 ^ k2 ^ 0x1BD11BDA.  All arithmetic is
// uint32_t, so every add wraps mod 2^32 as jax's u32 does; the rotates
// are one funnel shift each.

#pragma once

#include <cstdint>

namespace corro {

struct Pair {
  uint32_t a, b;
};

__device__ __forceinline__ uint32_t rotl32(uint32_t x, int r) {
  return __funnelshift_l(x, x, r);
}

__device__ __forceinline__ Pair threefry2x32(uint32_t k1, uint32_t k2,
                                             uint32_t x1, uint32_t x2) {
  const uint32_t k3 = k1 ^ k2 ^ 0x1BD11BDAu;
  uint32_t a = x1 + k1;
  uint32_t b = x2 + k2;
#define CORRO_TF_MIX(r) \
  a += b;               \
  b = rotl32(b, r) ^ a;
  CORRO_TF_MIX(13) CORRO_TF_MIX(15) CORRO_TF_MIX(26) CORRO_TF_MIX(6)
  a += k2; b += k3 + 1u;
  CORRO_TF_MIX(17) CORRO_TF_MIX(29) CORRO_TF_MIX(16) CORRO_TF_MIX(24)
  a += k3; b += k1 + 2u;
  CORRO_TF_MIX(13) CORRO_TF_MIX(15) CORRO_TF_MIX(26) CORRO_TF_MIX(6)
  a += k1; b += k2 + 3u;
  CORRO_TF_MIX(17) CORRO_TF_MIX(29) CORRO_TF_MIX(16) CORRO_TF_MIX(24)
  a += k2; b += k3 + 4u;
  CORRO_TF_MIX(13) CORRO_TF_MIX(15) CORRO_TF_MIX(26) CORRO_TF_MIX(6)
  a += k3; b += k1 + 5u;
#undef CORRO_TF_MIX
  return Pair{a, b};
}

}  // namespace corro
