// K3: anti-entropy pull — gather the peers' mask rows, apply the need
// algebra, OR-fold over peers into the sync ring slot.
//
// Replaces the per-edge half of corrosion_tpu/sim/packed.py:1138
// sync_packed: the fused dst-side gather (packed.py:1217-1224), the need
// algebra (packed.py:1225-1234), the per-edge sync grant
// (packed.py:1238, budget_prefix_words on each edge's need row),
// _fold_or_regular (packed.py:619) and the slot write plus fruitful flag
// (packed.py:1261-1263).  The per-node word masks (gaps_to_mask,
// grid_to_words, all_chunks_words) are built in plain torch before the
// launch.
//
// masks is [N, 4, W] = (haves, partial, below, have) per node; the
// puller's own miss words come separately as [N, W].  For node n and
// word k:
//   need_p = ((miss & haves_p) | (partial & (haves_p | partial_p))
//             | (~below & below_p)) & have_p & ~have   (ok peers p)
//   pulled = OR over the S peers of grant(need_p)
//   slot[n, k] |= pulled;  fruitful[n] = any word pulled
// where grant is the identity when unmetered, and with a sync budget the
// oldest-first byte prefix of the edge's whole need row (K16's row scan,
// budget_words.cuh), so fruitful counts what the grant let through.
//
// Unsigned-max trap: packed.py:1262 writes `sync_buf.at[slot].max(pulled)`,
// an unsigned u32 max; on int32 carriers a word with bit 31 set would
// compare as negative.  The slot is all zero at that point, so max and
// OR agree: deliver clears slot t % D every round and only sync writes
// the sync ring, at slot t + 1, so slot (t + 1) % D was last written by
// round t - D's sync and cleared by round t + 1 - D's deliver — for any
// D >= 2 (the storm's 2, gapstress's 4).  The kernel writes OR, which
// stays right for any word.
//
// Bound on the H100: bytes.  Per node it gathers S peers' 4W-word rows
// (random rows of 256 bytes at W = 16) and reads its own rows once.
// Unmetered design: one thread per (node, word), so the 16 threads of a
// node read each gathered 64-byte mask row as one coalesced run; each
// (node, word) has exactly one writer, so the slot update is a plain
// read-OR-write without atomics.  Threads that pull store 1 into
// fruitful[n]: all writers store the same value.  Metered design: the
// grant needs each edge's whole row, so one block per puller and one
// warp per edge: the warp writes its need row to shared memory (S*W
// words, 3 KB at gapstress's W = 256), meters it in place with the row
// scan, and the block ORs the S rows into the slot.
//
// With the flight recorder on, both entries also write each edge's
// granted words to `granted` [E, W] (zero where the edge is not ok): the
// sync grant of corrosion_tpu/sim/packed.py:1238 that JAX pins for its
// per-payload grant counts (packed.py:1302-1322), which the pull itself
// folds into the ring and never keeps.  K17 counts them.  A null
// `granted` (telemetry off) writes nothing more.

#include <cstdint>
#include <cuda_runtime.h>

#include "budget_words.cuh"

namespace {

__device__ __forceinline__ uint32_t need_word(const uint32_t* __restrict__ d,
                                              int w, int k, uint32_t miss_w,
                                              uint32_t partial_w,
                                              uint32_t below_w,
                                              uint32_t have_w) {
  uint32_t haves_d = d[k];
  uint32_t partial_d = d[w + k];
  uint32_t below_d = d[2 * w + k];
  uint32_t have_d = d[3 * w + k];
  uint32_t wanted = (miss_w & haves_d) | (partial_w & (haves_d | partial_d)) |
                    (~below_w & below_d);
  return wanted & have_d & ~have_w;
}

__global__ void sync_pull_kernel(const uint32_t* __restrict__ masks,
                                 const uint32_t* __restrict__ miss,
                                 const int32_t* __restrict__ peers,
                                 const bool* __restrict__ ok,
                                 uint32_t* __restrict__ slot_words,
                                 uint8_t* __restrict__ fruitful,
                                 uint32_t* __restrict__ granted, int n, int w,
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
    int p = peers[e];
    uint32_t g = 0u;
    if (ok[e] && p >= 0 && p < n)
      g = need_word(masks + (size_t)p * 4 * w, w, k, miss_w, partial_w,
                    below_w, have_w);
    if (granted) granted[e * w + k] = g;
    pulled |= g;
  }
  if (pulled != 0u) {
    slot_words[(size_t)node * w + k] |= pulled;
    fruitful[node] = 1;
  }
}

constexpr int kMaxWarps = 8;

__global__ void sync_pull_metered_kernel(
    const uint32_t* __restrict__ masks, const uint32_t* __restrict__ miss,
    const int32_t* __restrict__ peers, const bool* __restrict__ ok,
    uint32_t* __restrict__ slot_words, uint8_t* __restrict__ fruitful,
    const int32_t* __restrict__ nbytes, uint32_t* __restrict__ granted, int n,
    int w, int s_peers, long long budget) {
  extern __shared__ uint32_t need[];  // [S, W]
  int node = blockIdx.x;
  int warp = threadIdx.x / 32;
  int lane = threadIdx.x & 31;
  int warps = blockDim.x / 32;
  const uint32_t* own = masks + (size_t)node * 4 * w;
  for (int s = warp; s < s_peers; s += warps) {
    size_t e = (size_t)node * s_peers + s;
    int p = peers[e];
    bool live = ok[e] && p >= 0 && p < n;
    uint32_t* row = need + (size_t)s * w;
    for (int k = lane; k < w; k += 32) {
      row[k] = live ? need_word(masks + (size_t)p * 4 * w, w, k,
                                miss[(size_t)node * w + k], own[w + k],
                                own[2 * w + k], own[3 * w + k])
                    : 0u;
    }
    __syncwarp();
    corro::budget_row(row, row, w, nbytes, budget);
  }
  __syncthreads();
  if (granted) {
    uint32_t* out = granted + (size_t)node * s_peers * w;
    for (int i = threadIdx.x; i < s_peers * w; i += blockDim.x) out[i] = need[i];
  }
  bool any = false;
  for (int k = threadIdx.x; k < w; k += blockDim.x) {
    uint32_t pulled = 0u;
    for (int s = 0; s < s_peers; ++s) pulled |= need[(size_t)s * w + k];
    if (pulled != 0u) {
      slot_words[(size_t)node * w + k] |= pulled;
      any = true;
    }
  }
  if (__syncthreads_or(any) && threadIdx.x == 0) fruitful[node] = 1;
}

}  // namespace

extern "C" int corro_sync_pull(const void* masks, const void* miss,
                               const void* peers, const void* ok,
                               void* slot_words, void* fruitful,
                               void* granted, int n, int w, int s_peers,
                               void* stream) {
  if (n <= 0 || w <= 0 || s_peers <= 0) return (int)cudaErrorInvalidValue;
  size_t total = (size_t)n * w;
  int threads = 256;
  unsigned blocks = (unsigned)((total + threads - 1) / threads);
  sync_pull_kernel<<<blocks, threads, 0, (cudaStream_t)stream>>>(
      (const uint32_t*)masks, (const uint32_t*)miss, (const int32_t*)peers,
      (const bool*)ok, (uint32_t*)slot_words, (uint8_t*)fruitful,
      (uint32_t*)granted, n, w, s_peers);
  return (int)cudaGetLastError();
}

extern "C" int corro_sync_pull_metered(const void* masks, const void* miss,
                                       const void* peers, const void* ok,
                                       void* slot_words, void* fruitful,
                                       const void* nbytes, void* granted,
                                       int n, int w, int s_peers, int budget,
                                       void* stream) {
  if (n <= 0 || w <= 0 || w >= (1 << 16) || s_peers <= 0)
    return (int)cudaErrorInvalidValue;
  size_t smem = (size_t)s_peers * w * sizeof(uint32_t);
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        sync_pull_metered_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  int warps = s_peers < kMaxWarps ? s_peers : kMaxWarps;
  sync_pull_metered_kernel<<<(unsigned)n, warps * 32, smem,
                             (cudaStream_t)stream>>>(
      (const uint32_t*)masks, (const uint32_t*)miss, (const int32_t*)peers,
      (const bool*)ok, (uint32_t*)slot_words, (uint8_t*)fruitful,
      (const int32_t*)nbytes, (uint32_t*)granted, n, w, s_peers,
      (long long)budget);
  return (int)cudaGetLastError();
}
