// K22: the delivery-order invariant, counted on the card every round.
//
// Replaces corrosion_tpu/sim/invariants.py:51 order_violation_count (with
// corrosion_tpu/proto/ordering.py:35 prev_complete), called at
// corrosion_tpu/sim/packed.py:821-838 and corrosion_tpu/sim/round.py:
// 200-216 when ordering != "none".  The plain version is
// corrosion_tpu_torch/sim/invariants.py order_violation_count.
//
// A (node, origin a, version v) triple violates FIFO delivery when v is
// touched (some chunk held) while v - 1 from the same origin is not
// complete (every chunk held); version 1 never violates, and the origin's
// own row (node == meta.actor[a * C]) is exempt.  The count is a standing
// count, re-counted from `have` every round and ADDED to the run's device
// i32 RunMetrics.order_violations — no host read.  At most N * A * V a
// round (12.8 M at the storm), as JAX's i32 sum.
//
// Two entry points, each reading `have` once:
//   words  packed u32 [N, W], one thread per (node, word k): the groups'
//          touched bits (an OR-fold of each aligned C-bit group) against
//          the complete-version bitstring shifted up one wave (A * C
//          bits: version v - 1 of the origin sits one wave below v), the
//          first wave's bits set; the origin's groups masked out.
//   dense  u8 [N, P], one thread per (node, group g = v * A + a): touched
//          = any of the group's C bytes, the predecessor complete = all C
//          bytes of group g - A (true for v = 0).
// Per-thread counts meet in a warp sum and one atomicAdd a warp.
//
// The u8 entry's lane form (corro_order_check_dense_lanes: B16v,
// corrosion_tpu/campaign/ensemble.py:114 vmaps round.py:200-210) counts a
// seed ensemble's lanes in one launch: blockIdx.y is the lane, whose rows
// are its slice of have [K, N, P] (64-bit offsets) and whose count is its
// own slot acc[k] of the [K] order_violations — the atomic a solo launch
// aims at one slot aims at the lane's.  Bound: K times the solo bound.
//
// The words entry's lane form (corro_order_check_words_lanes: B16m's
// rest, ensemble.py:114 vmaps packed.py:821-832) does the same for the
// packed round's lanes: blockIdx.y is the lane, whose rows are its slice
// of have [K, N, W] (64-bit offsets) and whose count is acc[k].  A lane
// that finishes leaves the batch with its count, which stops there, as
// JAX's select-frozen lane's does.  Bound: bytes, K times the solo
// bound (8 x 6.4 MB at the 8-lane storm).
//
// Bound on the H100: bytes — have read once (6.4 MB words at the storm,
// 51 MB u8 on the dense storm) and meta.actor's A entries.  Design: the
// neighbouring words a thread's shift needs come from L1 (each row is
// 64 B at the storm); one atomic a warp.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

__device__ __forceinline__ uint32_t group_fold(uint32_t v, int c, bool all,
                                               uint32_t low_mask) {
  for (int step = 1; step < c; step <<= 1) v = all ? (v & (v >> step))
                                                   : (v | (v >> step));
  return v & low_mask;
}

// Bits [b0, b0 + 32) of the row's complete-version low bits (one bit per
// group, at the group's first chunk), a negative position reading as set.
__device__ __forceinline__ uint32_t prev_complete_low(
    const uint32_t* __restrict__ row, int b0, int c, uint32_t low_mask) {
  if (b0 <= -32) return 0xFFFFFFFFu;
  if (b0 < 0) {
    int sh = -b0;
    return (group_fold(row[0], c, true, low_mask) << sh) | ((1u << sh) - 1u);
  }
  int j = b0 >> 5, sh = b0 & 31;
  uint32_t lo = group_fold(row[j], c, true, low_mask) >> sh;
  if (sh) lo |= group_fold(row[j + 1], c, true, low_mask) << (32 - sh);
  return lo;
}

__device__ __forceinline__ void add_count(int count, int* acc) {
#pragma unroll
  for (int d = 16; d > 0; d >>= 1) count += __shfl_xor_sync(0xFFFFFFFFu, count, d);
  if ((threadIdx.x & 31) == 0 && count) atomicAdd(acc, count);
}

__global__ void order_words_kernel(const uint32_t* __restrict__ have,
                                   const int32_t* __restrict__ actor,
                                   int* __restrict__ acc, int n, int w,
                                   int a, int c, uint32_t low_mask) {
  // the lane's rows and its own count (lane 0 on the solo entry)
  have += (size_t)blockIdx.y * n * w;
  acc += blockIdx.y;
  size_t i = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  int count = 0;
  if (i < (size_t)n * w) {
    int node = (int)(i / w);
    int k = (int)(i % w);
    const uint32_t* row = have + (size_t)node * w;
    uint32_t touched = group_fold(row[k], c, false, low_mask);
    uint32_t viol = 0u;
    if (touched) {
      int wave = a * c;
      viol = touched & ~prev_complete_low(row, 32 * k - wave, c, low_mask);
      for (uint32_t m = viol; m; m &= m - 1u) {
        int b = __ffs(m) - 1;
        int q = 32 * k + b;
        int origin = actor[((q / c) % a) * c];
        if (origin == node) viol &= ~(1u << b);
      }
    }
    count = __popc(viol);
  }
  add_count(count, acc);
}

__global__ void order_dense_kernel(const uint8_t* __restrict__ have,
                                   const int32_t* __restrict__ actor,
                                   int* __restrict__ acc, int n, int p, int a,
                                   int c) {
  // the lane's rows and its own count (lane 0 on the solo entry)
  have += (size_t)blockIdx.y * n * p;
  acc += blockIdx.y;
  int groups = p / c;
  size_t i = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  int count = 0;
  if (i < (size_t)n * groups) {
    int node = (int)(i / groups);
    int g = (int)(i % groups);
    const uint8_t* row = have + (size_t)node * p;
    bool touched = false;
    for (int j = 0; j < c; ++j) touched |= row[g * c + j] != 0;
    if (touched && g >= a && actor[(g % a) * c] != node) {
      bool prev = true;
      for (int j = 0; j < c; ++j) prev &= row[(g - a) * c + j] != 0;
      count = prev ? 0 : 1;
    }
  }
  add_count(count, acc);
}

unsigned blocks_for(size_t total, int threads) {
  return (unsigned)((total + threads - 1) / threads);
}

}  // namespace

// `acc` is the run's i32 order_violations (0-d), added to in place;
// `actor` is meta.actor i32[P]; c = chunks_per_version, a = n_writers.
extern "C" int corro_order_check_words(const void* have, const void* actor,
                                       void* acc, int n, int w, int a, int c,
                                       void* stream) {
  if (n <= 0 || w <= 0 || a <= 0 || c <= 0 || c > 32 || (c & (c - 1)) ||
      (32 * w) % (a * c))
    return (int)cudaErrorInvalidValue;
  uint32_t low = 0u;
  for (int b = 0; b < 32; b += c) low |= 1u << b;
  order_words_kernel<<<blocks_for((size_t)n * w, 256), 256, 0,
                       (cudaStream_t)stream>>>(
      (const uint32_t*)have, (const int32_t*)actor, (int*)acc, n, w, a, c,
      low);
  return (int)cudaGetLastError();
}

extern "C" int corro_order_check_dense(const void* have, const void* actor,
                                       void* acc, int n, int p, int a, int c,
                                       void* stream) {
  if (n <= 0 || p <= 0 || a <= 0 || c <= 0 || p % (a * c))
    return (int)cudaErrorInvalidValue;
  order_dense_kernel<<<blocks_for((size_t)n * (p / c), 256), 256, 0,
                       (cudaStream_t)stream>>>(
      (const uint8_t*)have, (const int32_t*)actor, (int*)acc, n, p, a, c);
  return (int)cudaGetLastError();
}

// The u8 entry's lane form: `have` [lanes, N, P], `acc` the lanes' i32
// order_violations [lanes] (one count a lane), then `lanes`.
extern "C" int corro_order_check_dense_lanes(const void* have,
                                             const void* actor, void* acc,
                                             int n, int p, int a, int c,
                                             int lanes, void* stream) {
  if (n <= 0 || p <= 0 || a <= 0 || c <= 0 || p % (a * c) || lanes <= 0 ||
      lanes > 65535)
    return (int)cudaErrorInvalidValue;
  order_dense_kernel<<<dim3(blocks_for((size_t)n * (p / c), 256), lanes), 256,
                       0, (cudaStream_t)stream>>>(
      (const uint8_t*)have, (const int32_t*)actor, (int*)acc, n, p, a, c);
  return (int)cudaGetLastError();
}

// The words entry's lane form: `have` [lanes, N, W], `acc` the lanes' i32
// order_violations [lanes] (one count a lane), then `lanes`.
extern "C" int corro_order_check_words_lanes(const void* have,
                                             const void* actor, void* acc,
                                             int n, int w, int a, int c,
                                             int lanes, void* stream) {
  if (n <= 0 || w <= 0 || a <= 0 || c <= 0 || c > 32 || (c & (c - 1)) ||
      (32 * w) % (a * c) || lanes <= 0 || lanes > 65535)
    return (int)cudaErrorInvalidValue;
  uint32_t low = 0u;
  for (int b = 0; b < 32; b += c) low |= 1u << b;
  order_words_kernel<<<dim3(blocks_for((size_t)n * w, 256), lanes), 256, 0,
                       (cudaStream_t)stream>>>(
      (const uint32_t*)have, (const int32_t*)actor, (int*)acc, n, w, a, c,
      low);
  return (int)cudaGetLastError();
}
