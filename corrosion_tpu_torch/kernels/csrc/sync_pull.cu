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
// stays right for any word, and which the delay classes below need: with
// them the slot may already hold grants.
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
// Delay classes (corrosion_tpu/sim/packed.py:1250-1279, K3's delay
// entry): under a fault plan with delay factors each edge carries its
// session delay sdelay[e] (K9's, the slower direction of the pair), and
// its grant lands d = sdelay[e] rounds late, in ring slot (base + d) % D
// of the whole sync ring [D, N, W] (base = (t + 1) % D); JAX folds the
// classes d = 0..D-2 one by one, each as a read-OR-write of its slot,
// because the slot may already hold an earlier round's slower grant (a
// slot written in round t - 1 with d = 1 is round t's d = 0 slot: an
// overwrite, or a max of u32 words, would lose grants).  A thread folds
// its S edges into one register accumulator per class (classes 0..3; a
// later class ORs straight into its slot) and ORs each nonzero
// accumulator into its own slot word; it owns that word in every slot,
// so no atomics.  fruitful counts every granted word, whatever its class
// (JAX's granted.any), and a class past D - 2 lands nowhere, as in JAX's
// loop (compile_plan keeps every delay below it).  Without delays the
// entries take the one slot as a ring of D = 1, class 0.  The metered
// entry folds its shared need rows the same way.
//
// With the flight recorder on, both entries also write each edge's
// granted words to `granted` [E, W] (zero where the edge is not ok): the
// sync grant of corrosion_tpu/sim/packed.py:1238 that JAX pins for its
// per-payload grant counts (packed.py:1302-1322), which the pull itself
// folds into the ring and never keeps.  K17 counts them.  A null
// `granted` (telemetry off) writes nothing more.

// Lane entry, corro_sync_pull_lanes: the unmetered pull over the seed
// ensemble's lanes (B16, corrosion_tpu/campaign/ensemble.py:114) as a
// grid dimension: blockIdx.y is the lane, whose masks, misses, sessions
// (lane-local peer ids), sync ring [D, N, W] and fruitful row are its
// slices of the [K, ...] tensors; the grants land in ring slot `base`
// of each lane.  Bound: K times the solo bound.
//
// K3's delay lane entry (B16l, JAX packed.py:1250-1279 under the vmap;
// the same launcher with `sdelay`, counted as sync_pull_delay_lanes)
// takes each lane's session delays sdelay [K, N * S] (K9's latency entry
// on the lanes folded into its edge axis): lane k's class d < D - 1 is
// read-OR-written into slot (base + d) % D of its own ring, a class past
// D - 2 lands nowhere, and fruitful counts every granted word whatever
// its class.  The recording forms (B16r's packed half; counted as
// sync_pull_lanes_trace and sync_pull_delay_lanes_trace) copy each lane's
// granted words to its slice of `granted` [K, N * S, W], which K17's
// grant lane entry counts into the lane's own trace row.  Edge offsets
// are 64-bit: K * N * S * W passes 2^31 at 16 lanes of the storm.
//
// K3m's lane entry (B16m, corro_sync_pull_metered_lanes, counted as
// sync_pull_metered_lanes and, with `granted`, sync_pull_metered_lanes_
// trace) is the metered pull — the per-edge sync grant of corrosion_tpu/
// sim/packed.py:1238 (budget_prefix_words on each edge's need row) — under
// the same vmap: blockIdx.y is the lane, blockIdx.x the puller, so one
// block still meters one puller's S need rows in shared memory and a
// block never spans two lanes.  The lane's masks, misses, sessions
// (lane-local peers), sync ring, fruitful row, session delays and granted
// rows are its slices at 64-bit offsets (the gapstress ensemble's granted
// words are K * 76 800 * 256 words, 630 MB at K = 8); the payload sizes
// and the budget are shared, as JAX's vmap shares the config.  With
// `sdelay` each lane's grants land by class in its own ring, a class past
// D - 2 nowhere.  Bound on the H100: bytes — K times the solo metered
// bound: the peers' mask rows the sessions gather, the pullers' own rows,
// the ring words the grants touch, in and out.

#include <cstdint>
#include <cuda_runtime.h>

#include "budget_words.cuh"

namespace {

constexpr int kFastClasses = 4;

// The sync ring and the session delays of one launch.
struct Classes {
  uint32_t* ring;         // [d_slots, n, w]
  const int32_t* sdelay;  // [n * s_peers], or null: every edge class 0
  int d_slots, base;
};

// Folds one (node, word)'s granted words by class and ORs them into the
// ring: add(g, e) per edge, then flush().
struct ClassFold {
  Classes c;
  size_t row;  // node * w + k, the word's offset within a slot
  size_t slot_stride;
  uint32_t acc[kFastClasses];
  bool any;

  __device__ ClassFold(const Classes& c_, size_t row_, size_t slot_stride_)
      : c(c_), row(row_), slot_stride(slot_stride_), any(false) {
#pragma unroll
    for (int d = 0; d < kFastClasses; ++d) acc[d] = 0u;
  }

  __device__ __forceinline__ uint32_t* word(int d) const {
    return c.ring + (size_t)((c.base + d) % c.d_slots) * slot_stride + row;
  }

  __device__ __forceinline__ void add(uint32_t g, size_t e) {
    if (g == 0u) return;
    any = true;
    int d = c.sdelay != nullptr ? c.sdelay[e] : 0;
    int classes = c.sdelay != nullptr ? c.d_slots - 1 : 1;
    if (d < 0 || d >= classes) return;  // JAX's loop never reaches it
    if (d < kFastClasses) {
#pragma unroll
      for (int q = 0; q < kFastClasses; ++q)
        if (d == q) acc[q] |= g;
    } else {
      *word(d) |= g;
    }
  }

  __device__ __forceinline__ void flush() {
#pragma unroll
    for (int d = 0; d < kFastClasses; ++d)
      if (acc[d] != 0u) *word(d) |= acc[d];
  }
};

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
                                 const bool* __restrict__ ok, Classes cls,
                                 uint8_t* __restrict__ fruitful,
                                 uint32_t* __restrict__ granted, int n, int w,
                                 int s_peers) {
  size_t i = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= (size_t)n * w) return;
  // the lane's slices (lane 0 on the solo entry): masks, miss, the
  // sessions, its sync ring [D, N, W] and its fruitful row
  {
    const size_t lane = blockIdx.y;
    const size_t edges = (size_t)n * s_peers;
    masks += lane * n * 4 * w;
    miss += lane * n * w;
    peers += lane * edges;
    ok += lane * edges;
    fruitful += lane * n;
    cls.ring += lane * cls.d_slots * n * w;
    if (granted) granted += lane * edges * w;
    if (cls.sdelay) cls.sdelay += lane * edges;
  }
  int node = (int)(i / w);
  int k = (int)(i % w);
  const uint32_t* own = masks + (size_t)node * 4 * w;
  uint32_t miss_w = miss[(size_t)node * w + k];
  uint32_t partial_w = own[w + k];
  uint32_t below_w = own[2 * w + k];
  uint32_t have_w = own[3 * w + k];
  ClassFold fold(cls, i, (size_t)n * w);
  for (int s = 0; s < s_peers; ++s) {
    size_t e = (size_t)node * s_peers + s;
    int p = peers[e];
    uint32_t g = 0u;
    if (ok[e] && p >= 0 && p < n)
      g = need_word(masks + (size_t)p * 4 * w, w, k, miss_w, partial_w,
                    below_w, have_w);
    if (granted) granted[e * w + k] = g;
    fold.add(g, e);
  }
  fold.flush();
  if (fold.any) fruitful[node] = 1;
}

constexpr int kMaxWarps = 8;

__global__ void sync_pull_metered_kernel(
    const uint32_t* __restrict__ masks, const uint32_t* __restrict__ miss,
    const int32_t* __restrict__ peers, const bool* __restrict__ ok,
    Classes cls, uint8_t* __restrict__ fruitful,
    const int32_t* __restrict__ nbytes, uint32_t* __restrict__ granted, int n,
    int w, int s_peers, long long budget) {
  extern __shared__ uint32_t need[];  // [S, W]
  // the lane's slices (lane 0 on the solo entry); nbytes and the budget
  // are shared
  {
    const size_t lane = blockIdx.y;
    const size_t edges = (size_t)n * s_peers;
    masks += lane * n * 4 * w;
    miss += lane * n * w;
    peers += lane * edges;
    ok += lane * edges;
    fruitful += lane * n;
    cls.ring += lane * cls.d_slots * n * w;
    if (granted) granted += lane * edges * w;
    if (cls.sdelay) cls.sdelay += lane * edges;
  }
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
    ClassFold fold(cls, (size_t)node * w + k, (size_t)n * w);
    for (int s = 0; s < s_peers; ++s)
      fold.add(need[(size_t)s * w + k], (size_t)node * s_peers + s);
    fold.flush();
    any |= fold.any;
  }
  if (__syncthreads_or(any) && threadIdx.x == 0) fruitful[node] = 1;
}

}  // namespace

// `ring` is the sync ring [d_slots, n, w] and `sdelay` the edges' session
// delays (null: every grant lands in slot `base`; the wrappers then pass
// the one slot as a ring of d_slots = 1).
extern "C" int corro_sync_pull(const void* masks, const void* miss,
                               const void* peers, const void* ok,
                               void* ring, void* fruitful, void* granted,
                               const void* sdelay, int n, int w, int s_peers,
                               int d_slots, int base, void* stream) {
  if (n <= 0 || w <= 0 || s_peers <= 0 || d_slots <= 0 || base < 0 ||
      base >= d_slots)
    return (int)cudaErrorInvalidValue;
  size_t total = (size_t)n * w;
  int threads = 256;
  unsigned blocks = (unsigned)((total + threads - 1) / threads);
  Classes cls{(uint32_t*)ring, (const int32_t*)sdelay, d_slots, base};
  sync_pull_kernel<<<blocks, threads, 0, (cudaStream_t)stream>>>(
      (const uint32_t*)masks, (const uint32_t*)miss, (const int32_t*)peers,
      (const bool*)ok, cls, (uint8_t*)fruitful, (uint32_t*)granted, n, w,
      s_peers);
  return (int)cudaGetLastError();
}

// The lane entry: masks [lanes, N, 4, W], miss [lanes, N, W], peers and
// ok [lanes, N, S], ring [lanes, d_slots, N, W], fruitful [lanes, N];
// with `sdelay` [lanes, N * S] (K3's delay lane entry) each lane's grants
// land by class from slot `base`, else all in slot `base`; with `granted`
// [lanes, N * S, W] (the recording forms) each lane's granted words are
// copied there too.
extern "C" int corro_sync_pull_lanes(const void* masks, const void* miss,
                                     const void* peers, const void* ok,
                                     void* ring, void* fruitful,
                                     void* granted, const void* sdelay, int n,
                                     int w, int s_peers, int d_slots,
                                     int base, int lanes, void* stream) {
  if (n <= 0 || w <= 0 || s_peers <= 0 || d_slots <= 0 || base < 0 ||
      base >= d_slots || lanes <= 0 || lanes > 65535)
    return (int)cudaErrorInvalidValue;
  size_t total = (size_t)n * w;
  int threads = 256;
  unsigned blocks = (unsigned)((total + threads - 1) / threads);
  Classes cls{(uint32_t*)ring, (const int32_t*)sdelay, d_slots, base};
  sync_pull_kernel<<<dim3(blocks, lanes), threads, 0,
                     (cudaStream_t)stream>>>(
      (const uint32_t*)masks, (const uint32_t*)miss, (const int32_t*)peers,
      (const bool*)ok, cls, (uint8_t*)fruitful, (uint32_t*)granted, n, w,
      s_peers);
  return (int)cudaGetLastError();
}

namespace {

int launch_metered(const void* masks, const void* miss, const void* peers,
                   const void* ok, void* ring, void* fruitful,
                   const void* nbytes, void* granted, const void* sdelay,
                   int n, int w, int s_peers, int d_slots, int base,
                   int budget, int lanes, void* stream) {
  if (n <= 0 || w <= 0 || w >= (1 << 16) || s_peers <= 0 || d_slots <= 0 ||
      base < 0 || base >= d_slots || lanes <= 0 || lanes > 65535)
    return (int)cudaErrorInvalidValue;
  size_t smem = (size_t)s_peers * w * sizeof(uint32_t);
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        sync_pull_metered_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  int warps = s_peers < kMaxWarps ? s_peers : kMaxWarps;
  Classes cls{(uint32_t*)ring, (const int32_t*)sdelay, d_slots, base};
  sync_pull_metered_kernel<<<dim3((unsigned)n, lanes), warps * 32, smem,
                             (cudaStream_t)stream>>>(
      (const uint32_t*)masks, (const uint32_t*)miss, (const int32_t*)peers,
      (const bool*)ok, cls, (uint8_t*)fruitful, (const int32_t*)nbytes,
      (uint32_t*)granted, n, w, s_peers, (long long)budget);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int corro_sync_pull_metered(const void* masks, const void* miss,
                                       const void* peers, const void* ok,
                                       void* ring, void* fruitful,
                                       const void* nbytes, void* granted,
                                       const void* sdelay, int n, int w,
                                       int s_peers, int d_slots, int base,
                                       int budget, void* stream) {
  return launch_metered(masks, miss, peers, ok, ring, fruitful, nbytes,
                        granted, sdelay, n, w, s_peers, d_slots, base, budget,
                        1, stream);
}

// K3m's lane entry: K3's lane layout (masks [lanes, N, 4, W], miss
// [lanes, N, W], peers and ok [lanes, N, S], ring [lanes, d_slots, N, W],
// fruitful [lanes, N], sdelay [lanes, N * S], granted [lanes, N * S, W])
// with the metered grant; `nbytes` [32W] and `budget` are shared by every
// lane.
extern "C" int corro_sync_pull_metered_lanes(
    const void* masks, const void* miss, const void* peers, const void* ok,
    void* ring, void* fruitful, const void* nbytes, void* granted,
    const void* sdelay, int n, int w, int s_peers, int d_slots, int base,
    int budget, int lanes, void* stream) {
  return launch_metered(masks, miss, peers, ok, ring, fruitful, nbytes,
                        granted, sdelay, n, w, s_peers, d_slots, base, budget,
                        lanes, stream);
}
