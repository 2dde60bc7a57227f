// The word byte budget's row scan, shared by K16's standalone entry
// (budget_words.cu) and K3's metered entry (sync_pull.cu).
//
// One row of W u32 words is a set of payloads: bit b of word k is
// payload q = 32k + b, the payload-index (oldest-version-first) order of
// corrosion_tpu/sim/packed.py:102 budget_prefix_words, low bit first
// within a word.  A bit is kept when the inclusive running byte total of
// the row's set bits, in that order, is at most the budget.  The total
// is an int64, so it equals both of JAX's exact forms: one i32 lane up
// to 32 767 payloads, the KiB and sub-KiB lanes past that.
//
// A whole warp calls `budget_row` for one row, converged.  Lane l takes
// the contiguous words [l*per, (l+1)*per) with per = ceil(W/32): it sums
// its set bits' sizes, a warp scan turns the 32 sums into exclusive
// prefixes, and the lane walks its words again emitting the kept bits.
// `out` may be `in` (each lane reads a word before it writes it, and
// only its own words), and either may live in shared or global memory.

#pragma once

#include <cstdint>

namespace corro {

__device__ __forceinline__ void budget_row(const uint32_t* in, uint32_t* out,
                                           int w,
                                           const int32_t* __restrict__ nbytes,
                                           long long budget) {
  const int lane = threadIdx.x & 31;
  const int per = (w + 31) / 32;
  const int k0 = min(lane * per, w);
  const int k1 = min(k0 + per, w);
  long long sum = 0;
  for (int k = k0; k < k1; ++k) {
    uint32_t x = in[k];
    while (x) {
      int b = __ffs(x) - 1;
      x &= x - 1u;
      sum += nbytes[k * 32 + b];
    }
  }
  long long incl = sum;
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    long long y = __shfl_up_sync(0xFFFFFFFFu, incl, d);
    if (lane >= d) incl += y;
  }
  long long run = incl - sum;
  for (int k = k0; k < k1; ++k) {
    uint32_t x = in[k];
    uint32_t keep = 0u;
    while (x) {
      int b = __ffs(x) - 1;
      x &= x - 1u;
      run += nbytes[k * 32 + b];
      if (run <= budget) keep |= 1u << b;
    }
    out[k] = keep;
  }
}

}  // namespace corro
