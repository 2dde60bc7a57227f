// K16: the word byte budget — per row of u32 words, keep the
// oldest-first prefix of set bits whose byte total fits the budget.
//
// Replaces corrosion_tpu/sim/packed.py:102 budget_prefix_words (its
// three stages: per-word masked byte totals, an exclusive word prefix,
// the 32-step in-word scan; and the two-lane KiB/sub-KiB branch past
// 32 767 payloads).  The plain version is packed.budget_prefix_words_plain
// (unpack, the dense state.budget_prefix_mask, pack), which gives JAX's
// bits.  The broadcast's governor runs this entry on the sending words
// (rows N, budget rate_limit_bytes_round); the sync grant runs the same
// row scan inside K3's metered entry (rows N*S).
//
// K16 on the lanes' rows (B16m; counted as budget_words_lanes): the
// governor of the seed ensemble's packed lanes (packed.py:389 under the
// vmap of corrosion_tpu/campaign/ensemble.py:114) is this entry on the
// sending words [K, N, W] folded to rows = K*N.  The budget and the sizes
// are the config's, shared by every lane, and a row's scan reads only its
// own words, so the lanes need no offsets: a block of 8 rows that spans
// two lanes (N not a multiple of 8) meters each row alone all the same.
// The row index is an int: K*N < 2^31 (the wrapper checks).  Bound: bytes,
// as the solo entry's over K*N rows.
//
// The row scan is budget_words.cuh: one warp per row, a lane per run of
// ceil(W/32) contiguous words, an int64 running total (exact for any P
// the JAX package accepts, P < 2^21), a warp scan across the lanes.
//
// Bound on the H100: bytes — the rows in and out once (2*R*W*4) and the
// P sizes.  The per-bit loop reads nbytes[q] only for set bits; the 4P
// bytes of sizes stay in L1/L2 after the first warps.  Design: one warp
// per row and 8 rows per block; a lane's words are one 32-byte run at
// W = 256, so a warp's first loads cover the row in whole sectors.

#include <cstdint>
#include <cuda_runtime.h>

#include "budget_words.cuh"

namespace {

constexpr int kRowsPerBlock = 8;

__global__ void budget_words_kernel(const uint32_t* __restrict__ in,
                                    uint32_t* __restrict__ out,
                                    const int32_t* __restrict__ nbytes,
                                    int rows, int w, long long budget) {
  int row = blockIdx.x * kRowsPerBlock + (int)(threadIdx.x / 32);
  if (row >= rows) return;  // whole warps leave together
  corro::budget_row(in + (size_t)row * w, out + (size_t)row * w, w, nbytes,
                    budget);
}

}  // namespace

extern "C" int corro_budget_words(const void* in, const void* nbytes,
                                  void* out, int rows, int w, int budget,
                                  void* stream) {
  // P = 32W < 2^21, as JAX's budget_prefix_words requires
  if (rows <= 0 || w <= 0 || w >= (1 << 16)) return (int)cudaErrorInvalidValue;
  unsigned blocks = (unsigned)((rows + kRowsPerBlock - 1) / kRowsPerBlock);
  budget_words_kernel<<<blocks, kRowsPerBlock * 32, 0,
                        (cudaStream_t)stream>>>(
      (const uint32_t*)in, (uint32_t*)out, (const int32_t*)nbytes, rows, w,
      (long long)budget);
  return (int)cudaGetLastError();
}
