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

// jax.random.fold_in(key, data): the hash of counter (0, data).
__device__ __forceinline__ Pair fold_in(Pair key, uint32_t data) {
  return threefry2x32(key.a, key.b, 0u, data);
}

// randint's two subkeys, split(key, 2): the hashes of counters (0, 0)
// and (0, 1), as sub[0..1] (for `higher`) and sub[2..3] (for `lower`).
__device__ __forceinline__ void randint_subkeys(Pair key, uint32_t sub[4]) {
  Pair s0 = threefry2x32(key.a, key.b, 0u, 0u);
  Pair s1 = threefry2x32(key.a, key.b, 0u, 1u);
  sub[0] = s0.a;
  sub[1] = s0.b;
  sub[2] = s1.a;
  sub[3] = s1.b;
}

// randint(key, shape, 0, maxval)'s draw at flat element idx, from its
// subkeys and its span and u32 multiplier (the wrapper's, from maxval):
// offset = ((higher % span) * mult + lower % span) % span in u32, each
// draw the xor of the element's hash under its subkey.  A multiplier of
// 0 (span 2^31 - 1, where (2^16)^2 wraps) drops `higher`, so its hash is
// skipped.
__device__ __forceinline__ uint32_t randint_at(const uint32_t sub[4],
                                               uint32_t span, uint32_t mult,
                                               uint32_t idx) {
  Pair lo = threefry2x32(sub[2], sub[3], 0u, idx);
  uint32_t off = (lo.a ^ lo.b) % span;
  if (mult != 0u) {
    Pair hi = threefry2x32(sub[0], sub[1], 0u, idx);
    off = ((hi.a ^ hi.b) % span) * mult + off;
  }
  return off % span;
}

}  // namespace corro
