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
// 109 MB out, 0.0344 ms.
//
// What held the first design back (0.1873 ms at the storm's shapes, 18 %
// of the bound; the V = 128 walk 0.0655 ms against 0.0120; H100 80GB
// HBM3 at 700.00 W): one thread per (node, actor) stored its K lo and K
// hi slots one int at a time at a K*4-byte stride, so at K = 8 each warp
// store touched 32 sectors for 128 useful bytes, on outputs that are 94 %
// of the bytes; and each thread made V dependent loads of its node's
// have row through L1.
//
// The design now: a block takes a tile of `rows` consecutive (node,
// actor) rows, one thread each.
// - It loads the tile's nodes' W-word have rows into shared memory once,
//   consecutive threads on consecutive words (eight independent loads a
//   thread in flight where a thread has more than two), each row at an
//   odd stride (W | 1 words): a warp's threads span several nodes, whose
//   same word would otherwise share a bank (4-way at gapstress's W =
//   256).
// - Each thread computes its head, runs and overflow in registers with
//   the same __ffs/__clz algebra and writes its K lo and K hi into
//   shared memory, rows at an odd stride (K | 1 ints) so a warp's slot
//   stores fall in 32 distinct banks.  The wide walk stages its
//   data-dependent slots the same way.
// - The block then writes its contiguous spans of lo and hi with
//   consecutive threads on consecutive ints, so each warp store covers
//   whole 128-byte lines; heads are one int a thread, coalesced already.
// - `rows` is sized by K and W: the largest multiple of 32 up to 256
//   (down to 64) whose shared memory fits 28 KB, so that eight blocks
//   share an SM (gapstress's 1 KB have rows: 128 rows); a 64-row tile
//   may take up to 48 KB, and past that (K in the hundreds) the block
//   opts in to more with cudaFuncSetAttribute, down to 32 rows.  So
//   that no shape is refused, a shape whose 32-row tile fits the card's
//   shared memory nowhere (the tile spans 33 nodes: with one writer, past
//   about 1.7 k have words a node; or K past about 880) runs the
//   kernels' unstaged instantiation, which reads the have rows and
//   writes the slots in global memory as the first design did.  The
//   staging is a template argument, not a runtime branch, so the staged
//   form's loads and stores stay shared-memory instructions.
// - One atomic per warp for the overflow count (ballot + popc).
// Measured (H100 80GB HBM3 at 700.00 W, kernel_ab.py: the first design
// against this one in one call, medians of three): 0.0480 ms at the
// storm's shapes against 0.1872 (72 % of the bound), its 8-lane entry
// 0.3416 against 1.4035 (bound 0.2751), the V = 128 walk 0.0442 against
// 0.0632 (bound 0.0120; the walk is bound by its per-version
// shared-memory loop, up to 160 loads a thread); in storm-100k's first 3
// rounds 0.0453 device ms a round against 0.1840.  Choosing staged or
// global rows at run time instead of by template made every load and
// slot store generic: 0.0548 ms at the storm's shapes.
//
// Lane entry, corro_gaps_refresh_lanes: the refresh over the seed
// ensemble's lanes (B16, corrosion_tpu/campaign/ensemble.py:114) as a
// grid dimension: blockIdx.y is the lane, whose have words, heads, gap
// slots and overflow count are its slices of the [K, ...] tensors (the
// count per lane feeds its own overflow_frac).  Bound: K times the
// solo bound.
//
// At the 1M tier (config_fault_storm_1m: N = 1 000 000, W = 16, A = 16,
// K = 8) the (node, actor) row i < N * A = 1.6e7, the have offset node *
// W < 1.6e7 and the slots' (node * A + a) * K < 1.28e8 are size_t.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int MAX_ROWS = 256;
constexpr int MIN_ROWS = 32;
// eight blocks of 128 rows or more share an SM's 228 KB within this
constexpr size_t TILE_SMEM = 28 * 1024;
constexpr size_t DEFAULT_SMEM = 48 * 1024;
constexpr int LOAD_BATCH = 8;

struct Tile {
  const uint32_t* have;  // the lane's have words
  int32_t* heads;
  int32_t* lo;           // the lane's slots
  int32_t* hi;
  int32_t* overflow_count;
  uint32_t* s_have;      // shared: the tile's nodes' rows
  int32_t* s_lo;         // shared: rows x stride slots (unstaged: the
  int32_t* s_hi;         // tile's rows of lo and hi, stride k_slots)
  size_t i0;             // first (node, actor) row of the tile
  int valid_rows;        // rows of the tile below N*A
  int node0;             // first node of the tile
};

// Copy `words` have words from src into the tile's rows, at an odd
// stride (w | 1 words) so the same word of different nodes falls in
// different banks; (node, word) of j is tracked as j steps.  BATCH
// independent loads a thread are in flight at once.
template <int BATCH>
__device__ __forceinline__ void stage_rows(uint32_t* s_have,
                                           const uint32_t* src, int words,
                                           int w) {
  int step_node = blockDim.x / w, step_word = blockDim.x % w;
  int node = threadIdx.x / w, word = threadIdx.x % w;
  for (int j = threadIdx.x; j < words; j += BATCH * blockDim.x) {
    uint32_t got[BATCH];
    int at[BATCH];
#pragma unroll
    for (int b = 0; b < BATCH; ++b) {
      int jb = j + b * (int)blockDim.x;
      got[b] = jb < words ? __ldg(&src[jb]) : 0u;
      at[b] = node * (w | 1) + word;
      node += step_node;
      word += step_word;
      if (word >= w) {
        word -= w;
        ++node;
      }
    }
#pragma unroll
    for (int b = 0; b < BATCH; ++b) {
      if (j + b * (int)blockDim.x < words) s_have[at[b]] = got[b];
    }
  }
}

// Slice the lane, load the tile's have rows into shared memory: one
// load a thread at a time where each thread has a word or two (the
// storm's 64-byte rows), eight at a time past that (a tile of
// gapstress's 1 KB rows is 34 words a thread).  Unstaged, the tile
// points at its rows and slots in global memory.
template <bool STAGED>
__device__ __forceinline__ Tile load_tile(
    const uint32_t* have, int32_t* heads, int32_t* lo, int32_t* hi,
    int32_t* overflow_count, int n, int w, int a_writers, int k_slots,
    int stride, int have_cap) {
  extern __shared__ uint32_t smem[];
  const size_t lane = blockIdx.y;
  Tile tile;
  tile.have = have + lane * n * w;
  tile.heads = heads + lane * n * a_writers;
  tile.lo = lo + lane * n * a_writers * k_slots;
  tile.hi = hi + lane * n * a_writers * k_slots;
  tile.overflow_count = overflow_count + lane;
  size_t total = (size_t)n * a_writers;
  tile.i0 = (size_t)blockIdx.x * blockDim.x;
  tile.valid_rows = (int)min((size_t)blockDim.x, total - tile.i0);
  tile.node0 = (int)(tile.i0 / a_writers);
  if constexpr (!STAGED) {
    tile.s_have = nullptr;
    tile.s_lo = tile.lo + tile.i0 * k_slots;
    tile.s_hi = tile.hi + tile.i0 * k_slots;
  } else {
    tile.s_have = smem;
    tile.s_lo = (int32_t*)(smem + have_cap);
    tile.s_hi = tile.s_lo + (size_t)blockDim.x * stride;
    int node_last = (int)((tile.i0 + tile.valid_rows - 1) / a_writers);
    int words = (node_last - tile.node0 + 1) * w;
    const uint32_t* src = tile.have + (size_t)tile.node0 * w;
    if (words <= 2 * (int)blockDim.x)
      stage_rows<1>(tile.s_have, src, words, w);
    else
      stage_rows<LOAD_BATCH>(tile.s_have, src, words, w);
    __syncthreads();
  }
  return tile;
}

// A node's have row: staged, or in global memory.
template <bool STAGED>
__device__ __forceinline__ const uint32_t* have_row(const Tile& tile,
                                                    int node, int w) {
  if constexpr (STAGED)
    return tile.s_have + (size_t)(node - tile.node0) * (w | 1);
  return tile.have + (size_t)node * w;
}

// Write the tile's staged slots as contiguous spans (thread p of the
// block on ints p, p + rows, ...), then count the warp's overflows.
template <bool STAGED>
__device__ __forceinline__ void flush_tile(const Tile& tile, int k_slots,
                                           int stride, bool overflow) {
  if constexpr (STAGED) {
    __syncthreads();
    int count = tile.valid_rows * k_slots;
    int32_t* lo = tile.lo + tile.i0 * k_slots;
    int32_t* hi = tile.hi + tile.i0 * k_slots;
    int step_r = blockDim.x / k_slots, step_j = blockDim.x % k_slots;
    int r = threadIdx.x / k_slots, j = threadIdx.x % k_slots;
    for (int p = threadIdx.x; p < count; p += blockDim.x) {
      lo[p] = tile.s_lo[r * stride + j];
      hi[p] = tile.s_hi[r * stride + j];
      r += step_r;
      j += step_j;
      if (j >= k_slots) {
        j -= k_slots;
        ++r;
      }
    }
  }
  unsigned ballot = __ballot_sync(0xFFFFFFFFu, overflow);
  if ((threadIdx.x & 31) == 0 && ballot) {
    atomicAdd(tile.overflow_count, __popc(ballot));
  }
}

// stride: a staged slot row's ints (k_slots | 1); unstaged, k_slots
template <bool STAGED>
__global__ void gaps_refresh_kernel(const uint32_t* __restrict__ have,
                                    int32_t* __restrict__ heads,
                                    int32_t* __restrict__ lo,
                                    int32_t* __restrict__ hi,
                                    int32_t* __restrict__ overflow_count,
                                    int n, int w, int a_writers, int v_versions,
                                    int c_chunks, int k_slots, int stride,
                                    int have_cap) {
  Tile tile = load_tile<STAGED>(have, heads, lo, hi, overflow_count, n, w,
                                a_writers, k_slots, stride, have_cap);
  bool overflow = false;
  if ((int)threadIdx.x < tile.valid_rows) {
    size_t i = tile.i0 + threadIdx.x;
    int node = (int)(i / a_writers);
    int actor = (int)(i % a_writers);
    const uint32_t* row = have_row<STAGED>(tile, node, w);
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
    tile.heads[i] = head;
    int32_t* lo_r = tile.s_lo + threadIdx.x * stride;
    int32_t* hi_r = tile.s_hi + threadIdx.x * stride;
    for (int j = 0; j < k_slots; ++j) {
      lo_r[j] = start ? __ffs(start) : 0;
      start &= start - 1u;
    }
    overflow = start != 0u;  // runs left after K extractions
    for (int j = 0; j < k_slots; ++j) {
      int pos = end ? __ffs(end) : 0;
      end &= end - 1u;
      if (j == k_slots - 1 && overflow) pos = 32 - __clz(missing);
      hi_r[j] = pos;
    }
  }
  flush_tile<STAGED>(tile, k_slots, stride, overflow);
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

template <bool STAGED>
__global__ void gaps_refresh_wide_kernel(const uint32_t* __restrict__ have,
                                         int32_t* __restrict__ heads,
                                         int32_t* __restrict__ lo,
                                         int32_t* __restrict__ hi,
                                         int32_t* __restrict__ overflow_count,
                                         int n, int w, int a_writers,
                                         int v_versions, int c_chunks,
                                         int k_slots, int stride,
                                         int have_cap) {
  Tile tile = load_tile<STAGED>(have, heads, lo, hi, overflow_count, n, w,
                                a_writers, k_slots, stride, have_cap);
  bool overflow = false;
  if ((int)threadIdx.x < tile.valid_rows) {
    size_t i = tile.i0 + threadIdx.x;
    int node = (int)(i / a_writers);
    int actor = (int)(i % a_writers);
    const uint32_t* row = have_row<STAGED>(tile, node, w);
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
    tile.heads[i] = head;
    int32_t* lo_r = tile.s_lo + threadIdx.x * stride;
    int32_t* hi_r = tile.s_hi + threadIdx.x * stride;
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
        lo_r[starts++] = 32 * j + __ffs(start);
        start &= start - 1u;
      }
      starts += __popc(start);
      while (end && ends < k_slots) {
        hi_r[ends++] = 32 * j + __ffs(end);
        end &= end - 1u;
      }
      ends += __popc(end);
      if (m) last_missing = 32 * j + 32 - __clz(m);
      in_run = m >> 31;
      m = next;
    }
    for (int s = min(starts, k_slots); s < k_slots; ++s) lo_r[s] = 0;
    for (int s = min(ends, k_slots); s < k_slots; ++s) hi_r[s] = 0;
    overflow = starts > k_slots;
    if (overflow) hi_r[k_slots - 1] = last_missing;
  }
  flush_tile<STAGED>(tile, k_slots, stride, overflow);
}

// Shared memory of a `rows`-row tile: the have rows of the nodes it can
// span ((rows - 1) / A + 2 of them, w | 1 words each) and the staged lo
// and hi slots.
size_t have_words(int rows, int w, int a_writers) {
  return (size_t)((rows - 1) / a_writers + 2) * (w | 1);
}

size_t tile_smem(int rows, int w, int a_writers, int stride) {
  return (have_words(rows, w, a_writers) + 2 * (size_t)rows * stride) * 4;
}

int launch_gaps(const void* have, void* heads, void* lo, void* hi,
                void* overflow_count, int n, int w, int a_writers,
                int v_versions, int c_chunks, int k_slots, int lanes,
                void* stream) {
  if (lanes <= 0 || lanes > 65535 || n <= 0 || w <= 0 || a_writers <= 0 ||
      v_versions <= 0 || c_chunks <= 0 || c_chunks > 32 ||
      (c_chunks & (c_chunks - 1)) || k_slots <= 0 ||
      (size_t)v_versions * a_writers * c_chunks > (size_t)w * 32)
    return (int)cudaErrorInvalidValue;
  // V <= 32: one version word per (node, actor); past it, the walk
  bool narrow = v_versions <= 32;
  auto kernel = narrow ? gaps_refresh_kernel<true>
                       : gaps_refresh_wide_kernel<true>;
  int stride = k_slots | 1;
  int rows = MAX_ROWS;
  while (rows > 2 * MIN_ROWS &&
         tile_smem(rows, w, a_writers, stride) > TILE_SMEM)
    rows -= MIN_ROWS;
  size_t smem = tile_smem(rows, w, a_writers, stride);
  if (smem > DEFAULT_SMEM) {
    int device = 0, optin = 0;
    cudaError_t err = cudaGetDevice(&device);
    if (err == cudaSuccess)
      err = cudaDeviceGetAttribute(
          &optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, device);
    if (err != cudaSuccess) return (int)err;
    while (rows > MIN_ROWS && smem > (size_t)optin) {
      rows -= MIN_ROWS;
      smem = tile_smem(rows, w, a_writers, stride);
    }
    if (smem > (size_t)optin) {  // past the card: the unstaged form
      kernel = narrow ? gaps_refresh_kernel<false>
                      : gaps_refresh_wide_kernel<false>;
      rows = MAX_ROWS;
      stride = k_slots;
      smem = 0;
    } else {
      err = cudaFuncSetAttribute(kernel,
                                 cudaFuncAttributeMaxDynamicSharedMemorySize,
                                 (int)smem);
      if (err != cudaSuccess) return (int)err;
    }
  }
  size_t total = (size_t)n * a_writers;
  unsigned blocks = (unsigned)((total + rows - 1) / rows);
  kernel<<<dim3(blocks, lanes), rows, smem, (cudaStream_t)stream>>>(
      (const uint32_t*)have, (int32_t*)heads, (int32_t*)lo, (int32_t*)hi,
      (int32_t*)overflow_count, n, w, a_writers, v_versions, c_chunks,
      k_slots, stride, smem > 0 ? (int)have_words(rows, w, a_writers) : 0);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int corro_gaps_refresh(const void* have, void* heads, void* lo,
                                  void* hi, void* overflow_count, int n, int w,
                                  int a_writers, int v_versions, int c_chunks,
                                  int k_slots, void* stream) {
  return launch_gaps(have, heads, lo, hi, overflow_count, n, w, a_writers,
                     v_versions, c_chunks, k_slots, 1, stream);
}

// The lane entry: every tensor [lanes, ...], overflow_count [lanes].
extern "C" int corro_gaps_refresh_lanes(const void* have, void* heads,
                                        void* lo, void* hi,
                                        void* overflow_count, int n, int w,
                                        int a_writers, int v_versions,
                                        int c_chunks, int k_slots, int lanes,
                                        void* stream) {
  return launch_gaps(have, heads, lo, hi, overflow_count, n, w, a_writers,
                     v_versions, c_chunks, k_slots, lanes, stream);
}
