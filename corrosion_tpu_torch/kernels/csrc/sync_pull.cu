// K3: anti-entropy pull — gather the peers' mask rows, apply the need
// algebra, OR-fold over peers into the sync ring slot.
//
// Replaces the per-edge half of corrosion_tpu/sim/packed.py:1138
// sync_packed: the fused dst-side gather (packed.py:1217-1224), the need
// algebra (packed.py:1225-1234), _fold_or_regular (packed.py:619) and
// the slot write plus fruitful flag (packed.py:1261-1263).  The per-node
// word masks (gaps_to_mask, grid_to_words, all_chunks_words) are built
// in plain torch before the launch.
//
// masks is [N, 4, W] = (haves, partial, below, have) per node; the
// puller's own miss words come separately as [N, W].  For node n and
// word k:
//   pulled = OR over ok peers p of
//     ((miss & haves_p) | (partial & (haves_p | partial_p))
//      | (~below & below_p)) & have_p & ~have
//   slot[n, k] |= pulled;  fruitful[n] = any word pulled
//
// Unsigned-max trap: packed.py:1262 writes `sync_buf.at[slot].max(pulled)`,
// an unsigned u32 max; on int32 carriers a word with bit 31 set would
// compare as negative.  The slot is all zero at that point (deliver
// cleared it the round before — the storm's ring has D = 2), so max and
// OR agree, and the kernel writes OR, which stays right for any word.
//
// Bound on the H100: bytes.  Per node it gathers S peers' 4W-word rows
// (random rows of 256 bytes at W = 16) and reads its own rows once.
// Design: one thread per (node, word), so the 16 threads of a node read
// each gathered 64-byte mask row as one coalesced run; each (node, word)
// has exactly one writer, so the slot update is a plain read-OR-write
// without atomics.  Threads that pull store 1 into fruitful[n]: all
// writers store the same value.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

__global__ void sync_pull_kernel(const uint32_t* __restrict__ masks,
                                 const uint32_t* __restrict__ miss,
                                 const int32_t* __restrict__ peers,
                                 const bool* __restrict__ ok,
                                 uint32_t* __restrict__ slot_words,
                                 uint8_t* __restrict__ fruitful, int n, int w,
                                 int s_peers) {
  size_t i = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= (size_t)n * w) return;
  int node = (int)(i / w);
  int k = (int)(i % w);
  const uint32_t* own = masks + (size_t)node * 4 * w;
  uint32_t miss_w = miss[(size_t)node * w + k];
  uint32_t partial_w = own[w + k];
  uint32_t below_w = own[2 * w + k];
  uint32_t have_w = own[3 * w + k];
  uint32_t pulled = 0u;
  for (int s = 0; s < s_peers; ++s) {
    size_t e = (size_t)node * s_peers + s;
    if (!ok[e]) continue;
    int p = peers[e];
    if (p < 0 || p >= n) continue;
    const uint32_t* d = masks + (size_t)p * 4 * w;
    uint32_t haves_d = d[k];
    uint32_t partial_d = d[w + k];
    uint32_t below_d = d[2 * w + k];
    uint32_t have_d = d[3 * w + k];
    uint32_t wanted = (miss_w & haves_d) | (partial_w & (haves_d | partial_d)) |
                      (~below_w & below_d);
    pulled |= wanted & have_d & ~have_w;
  }
  if (pulled != 0u) {
    slot_words[(size_t)node * w + k] |= pulled;
    fruitful[node] = 1;
  }
}

}  // namespace

extern "C" int corro_sync_pull(const void* masks, const void* miss,
                               const void* peers, const void* ok,
                               void* slot_words, void* fruitful, int n, int w,
                               int s_peers, void* stream) {
  if (n <= 0 || w <= 0 || s_peers <= 0) return (int)cudaErrorInvalidValue;
  size_t total = (size_t)n * w;
  int threads = 256;
  unsigned blocks = (unsigned)((total + threads - 1) / threads);
  sync_pull_kernel<<<blocks, threads, 0, (cudaStream_t)stream>>>(
      (const uint32_t*)masks, (const uint32_t*)miss, (const int32_t*)peers,
      (const bool*)ok, (uint32_t*)slot_words, (uint8_t*)fruitful, n, w,
      s_peers);
  return (int)cudaGetLastError();
}
