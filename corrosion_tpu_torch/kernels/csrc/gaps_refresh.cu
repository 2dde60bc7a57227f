// K6: gap refresh — version heads and the K gap intervals straight from
// the have words.
//
// Replaces corrosion_tpu/sim/gaps.py:137 _extract_gaps_words (V <= 32)
// and gaps.py:64 _extract_gaps_dense (V > 32) together with what feeds
// them in packed.py:772-781: group_grid(have, "any") (packed.py:249) and
// version_heads (state.py:315).  The plain version is
// gaps.refresh_gaps_plain, the port's composition of the same three.
//
// Per (node n, actor a), with payload index (v * A + a) * C + c:
//   tv      bit v set iff any of version v+1's C chunk bits is held
//   head    the highest touched version, 32 - clz(tv) (0 if none)
//   missing ~tv & bits [0, head)
//   lo/hi   1-based starts/ends of the first K runs of missing, by
//           lowest-set-bit extraction (__ffs), 0 in empty slots
//   overflow more than K runs: slot K-1's end becomes the last missing
//           version, and the run counts toward `overflow_count`
// The [N, A, V] bool grid is never built.  overflow_count is an int
// (atomicAdd of ints is order-free, so the count is deterministic); the
// wrapper divides it in f32 exactly as the plain version does.
//
// Past 32 versions (gapstress: V = 128) the same thread walks the
// versions in words of 32, tv_j for versions 32j+1 .. 32j+32:
//   head     first pass, high word to low: the first touched word gives
//            head = 32j + 32 - clz(tv_j);
//   runs     second pass, low to high over the words below the head, with
//            the next word's missing bits looked ahead: a start is a
//            missing bit whose lower neighbour is not missing (bit 0 looks
//            at the previous word's bit 31), an end one whose upper
//            neighbour is not (bit 31 looks at the next word's bit 0).
//            The i-th start and the i-th end are run i's lo and hi; the
//            first K of each are written to the slots as they are found,
//            the rest only counted, so no slot array caps K; slots past
//            the run count are zeroed, and with more than K runs slot
//            K-1's end becomes the last missing version.
//
// Bound on the H100: bytes.  It reads the have words once (N*W*4) and
// writes heads (N*A*4) and lo/hi (2*N*A*K*4) — at the storm 6.4 MB in,
// 109 MB out.  Design: one thread per (node, actor); a node's A threads
// read the same W-word row, which L1 serves after the first; each thread
// writes its K slots as consecutive ints; one atomic per warp for the
// overflow count (ballot + popc).

#include <cstdint>
#include <cuda_runtime.h>

namespace {

__global__ void gaps_refresh_kernel(const uint32_t* __restrict__ have,
                                    int32_t* __restrict__ heads,
                                    int32_t* __restrict__ lo,
                                    int32_t* __restrict__ hi,
                                    int32_t* __restrict__ overflow_count,
                                    int n, int w, int a_writers, int v_versions,
                                    int c_chunks, int k_slots) {
  size_t i = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  bool valid = i < (size_t)n * a_writers;
  bool overflow = false;
  if (valid) {
    int node = (int)(i / a_writers);
    int actor = (int)(i % a_writers);
    const uint32_t* row = have + (size_t)node * w;
    uint32_t cmask = c_chunks == 32 ? 0xFFFFFFFFu : (1u << c_chunks) - 1u;
    uint32_t tv = 0u;
    for (int v = 0; v < v_versions; ++v) {
      uint32_t g = ((uint32_t)v * a_writers + actor) * c_chunks;
      uint32_t bits = (row[g >> 5] >> (g & 31u)) & cmask;
      tv |= (uint32_t)(bits != 0u) << v;
    }
    int head = tv ? 32 - __clz(tv) : 0;
    uint32_t below = head >= 32 ? 0xFFFFFFFFu : (1u << head) - 1u;
    uint32_t missing = ~tv & below;
    uint32_t start = missing & ~(missing << 1);
    uint32_t end = missing & ~(missing >> 1);
    heads[i] = head;
    int32_t* lo_i = lo + i * k_slots;
    int32_t* hi_i = hi + i * k_slots;
    for (int j = 0; j < k_slots; ++j) {
      lo_i[j] = start ? __ffs(start) : 0;
      start &= start - 1u;
    }
    overflow = start != 0u;  // runs left after K extractions
    for (int j = 0; j < k_slots; ++j) {
      int pos = end ? __ffs(end) : 0;
      end &= end - 1u;
      if (j == k_slots - 1 && overflow) pos = 32 - __clz(missing);
      hi_i[j] = pos;
    }
  }
  unsigned ballot = __ballot_sync(0xFFFFFFFFu, overflow);
  if ((threadIdx.x & 31) == 0 && ballot) {
    atomicAdd(overflow_count, __popc(ballot));
  }
}

// Touched bits of versions 32j+1 .. 32j+32 (0 past V) of one actor.
__device__ __forceinline__ uint32_t touched_word(const uint32_t* row, int j,
                                                 int a_writers, int actor,
                                                 int v_versions, int c_chunks,
                                                 uint32_t cmask) {
  int v0 = 32 * j;
  int count = min(32, v_versions - v0);
  uint32_t tv = 0u;
  for (int b = 0; b < count; ++b) {
    uint32_t g = ((uint32_t)(v0 + b) * a_writers + actor) * c_chunks;
    uint32_t bits = (row[g >> 5] >> (g & 31u)) & cmask;
    tv |= (uint32_t)(bits != 0u) << b;
  }
  return tv;
}

// Missing bits of word j: untouched versions below the head.
__device__ __forceinline__ uint32_t missing_word(const uint32_t* row, int j,
                                                 int head, int a_writers,
                                                 int actor, int v_versions,
                                                 int c_chunks,
                                                 uint32_t cmask) {
  int below = head - 32 * j;
  if (below <= 0) return 0u;
  uint32_t mask = below >= 32 ? 0xFFFFFFFFu : (1u << below) - 1u;
  return ~touched_word(row, j, a_writers, actor, v_versions, c_chunks,
                       cmask) & mask;
}

__global__ void gaps_refresh_wide_kernel(const uint32_t* __restrict__ have,
                                         int32_t* __restrict__ heads,
                                         int32_t* __restrict__ lo,
                                         int32_t* __restrict__ hi,
                                         int32_t* __restrict__ overflow_count,
                                         int n, int w, int a_writers,
                                         int v_versions, int c_chunks,
                                         int k_slots) {
  size_t i = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  bool valid = i < (size_t)n * a_writers;
  bool overflow = false;
  if (valid) {
    int node = (int)(i / a_writers);
    int actor = (int)(i % a_writers);
    const uint32_t* row = have + (size_t)node * w;
    uint32_t cmask = c_chunks == 32 ? 0xFFFFFFFFu : (1u << c_chunks) - 1u;
    int head = 0;
    for (int j = (v_versions + 31) / 32 - 1; j >= 0; --j) {
      uint32_t tv = touched_word(row, j, a_writers, actor, v_versions,
                                 c_chunks, cmask);
      if (tv) {
        head = 32 * j + 32 - __clz(tv);
        break;
      }
    }
    heads[i] = head;
    int32_t* lo_i = lo + i * k_slots;
    int32_t* hi_i = hi + i * k_slots;
    int words = (head + 31) / 32;
    int starts = 0, ends = 0, last_missing = 0;
    uint32_t in_run = 0u;
    uint32_t m = words > 0 ? missing_word(row, 0, head, a_writers, actor,
                                          v_versions, c_chunks, cmask)
                           : 0u;
    for (int j = 0; j < words; ++j) {
      uint32_t next = j + 1 < words
                          ? missing_word(row, j + 1, head, a_writers, actor,
                                         v_versions, c_chunks, cmask)
                          : 0u;
      uint32_t start = m & ~((m << 1) | in_run);
      uint32_t end = m & ~((m >> 1) | (next << 31));
      while (start && starts < k_slots) {
        lo_i[starts++] = 32 * j + __ffs(start);
        start &= start - 1u;
      }
      starts += __popc(start);
      while (end && ends < k_slots) {
        hi_i[ends++] = 32 * j + __ffs(end);
        end &= end - 1u;
      }
      ends += __popc(end);
      if (m) last_missing = 32 * j + 32 - __clz(m);
      in_run = m >> 31;
      m = next;
    }
    for (int s = min(starts, k_slots); s < k_slots; ++s) lo_i[s] = 0;
    for (int s = min(ends, k_slots); s < k_slots; ++s) hi_i[s] = 0;
    overflow = starts > k_slots;
    if (overflow) hi_i[k_slots - 1] = last_missing;
  }
  unsigned ballot = __ballot_sync(0xFFFFFFFFu, overflow);
  if ((threadIdx.x & 31) == 0 && ballot) {
    atomicAdd(overflow_count, __popc(ballot));
  }
}

}  // namespace

extern "C" int corro_gaps_refresh(const void* have, void* heads, void* lo,
                                  void* hi, void* overflow_count, int n, int w,
                                  int a_writers, int v_versions, int c_chunks,
                                  int k_slots, void* stream) {
  if (n <= 0 || w <= 0 || a_writers <= 0 || v_versions <= 0 ||
      c_chunks <= 0 || c_chunks > 32 ||
      (c_chunks & (c_chunks - 1)) || k_slots <= 0 ||
      (size_t)v_versions * a_writers * c_chunks > (size_t)w * 32)
    return (int)cudaErrorInvalidValue;
  size_t total = (size_t)n * a_writers;
  int threads = 256;
  unsigned blocks = (unsigned)((total + threads - 1) / threads);
  // V <= 32: one version word per (node, actor); past it, the walk
  auto kernel = v_versions <= 32 ? gaps_refresh_kernel
                                 : gaps_refresh_wide_kernel;
  kernel<<<blocks, threads, 0, (cudaStream_t)stream>>>(
      (const uint32_t*)have, (int32_t*)heads, (int32_t*)lo, (int32_t*)hi,
      (int32_t*)overflow_count, n, w, a_writers, v_versions, c_chunks,
      k_slots);
  return (int)cudaGetLastError();
}
