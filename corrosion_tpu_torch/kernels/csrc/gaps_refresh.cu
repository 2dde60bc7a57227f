// K6: gap refresh — version heads and the K gap intervals straight from
// the have words.
//
// Replaces corrosion_tpu/sim/gaps.py:137 _extract_gaps_words together
// with what feeds it in packed.py:772-781: group_grid(have, "any")
// (packed.py:249) and version_heads (state.py:315).  The plain version
// is gaps.refresh_gaps_plain, the port's composition of the same three.
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

}  // namespace

extern "C" int corro_gaps_refresh(const void* have, void* heads, void* lo,
                                  void* hi, void* overflow_count, int n, int w,
                                  int a_writers, int v_versions, int c_chunks,
                                  int k_slots, void* stream) {
  if (n <= 0 || w <= 0 || a_writers <= 0 || v_versions <= 0 ||
      v_versions > 32 || c_chunks <= 0 || c_chunks > 32 ||
      (c_chunks & (c_chunks - 1)) || k_slots <= 0 ||
      (size_t)v_versions * a_writers * c_chunks > (size_t)w * 32)
    return (int)cudaErrorInvalidValue;
  size_t total = (size_t)n * a_writers;
  int threads = 256;
  unsigned blocks = (unsigned)((total + threads - 1) / threads);
  gaps_refresh_kernel<<<blocks, threads, 0, (cudaStream_t)stream>>>(
      (const uint32_t*)have, (int32_t*)heads, (int32_t*)lo, (int32_t*)hi,
      (int32_t*)overflow_count, n, w, a_writers, v_versions, c_chunks,
      k_slots);
  return (int)cudaGetLastError();
}
