// K3: anti-entropy pull — gather the peers' mask rows, apply the need
// algebra, OR-fold over peers into the sync ring slot.
//
// Replaces all but the session draws of corrosion_tpu/sim/packed.py:1138
// sync_packed: the per-node word masks (packed.py:1201-1218, the mask
// pass below), the fused dst-side gather (packed.py:1217-1224), the need
// algebra (packed.py:1225-1234), the per-edge sync grant
// (packed.py:1238, budget_prefix_words on each edge's need row),
// _fold_or_regular (packed.py:619) and the slot write plus fruitful flag
// (packed.py:1261-1263).  Nothing but the mask pass runs between the
// state and the pull.
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
// Unmetered design: one thread per (node, run of four words) — 128-bit
// loads and stores wherever W % 4 == 0 and the tensors are 16-byte
// aligned, one word a thread otherwise — and a group of up to 32
// threads per node, so a node's threads read each gathered mask plane as
// one coalesced run.  A thread loads its peer ids, ok flags and classes
// first (four peers at a time), then issues every plane load of those
// peers before it uses any — all 4 * S at the storm's S = 3 — so its
// gathers are in flight together rather than in S dependent chains.  The
// loads take registers: the kernel asks for two blocks an SM, which
// holds a thread of four-word runs to 128 registers (146 unbounded: one
// block an SM), faster on an H100 at the storm's shapes.  Each (node,
// word) has exactly one writer, so the slot update is a plain
// read-OR-write without atomics.  The node's group ORs its `any` with
// warp shuffles and its first thread writes fruitful[n] (0 or 1) for
// every node: the wrapper allocates fruitful as bool and neither fills
// nor casts it.  Metered design: the grant needs each edge's whole row,
// so one block per puller and one warp per edge: the warp writes its
// need row to shared memory (S*W words, 3 KB at gapstress's W = 256),
// meters it in place with the row scan, and the block ORs the S rows
// into the slot.
//
// The mask pass (corro_sync_masks, counted as sync_masks, and as
// sync_masks_lanes on the lanes, whose rows it folds: no row crosses a
// lane) computes corrosion_tpu/sim/packed.py:1201-1218 — gaps.py:194
// gaps_to_mask of the advertised gap runs, packed.py:267 grid_to_words
// of it and of the head catch-up grid, packed.py:1129 all_chunks_words
// of `have`, the haves/partial algebra and the stack — from heads [R, A],
// gap_lo and gap_hi [R, A, G] and have [R, W] into masks [R, 4, W] =
// (haves, partial, below, have) and miss [R, W], the tensors every pull
// entry reads.  Word k holds the 32 / C version groups g = k * 32 / C ..
// in grid_to_words' version-major order, g = v * A + a, each C bits wide.
// Bound: bytes — heads, gaps and have in, masks and miss out, once each
// (147 MB at the storm).  Design: a block serves 256 / W rows (one at
// W >= 256).  One thread per (row, writer) reads that writer's G runs as
// 16-byte vectors (G % 4 == 0) and folds them into a bit per version, 32
// versions a word (one word at V = 8, four at gapstress's V = 128), into
// shared memory beside the rows' heads; then one thread per (row, word)
// reads its groups' bits and heads there, folds `have`'s groups for
// all_chunks_words, and smears each group's bit over its C bits with one
// multiply.  (Staging the gap runs themselves in shared memory read them
// back 8-way bank-conflicted at G = 8, and was slower.)  General in A, V,
// C (a power of two up to 32, V * A a multiple of 32 / C) and G.
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
//
// At the 1M tier (config_fault_storm_1m: N = 1 000 000, W = 16, S = 3,
// D = 2, A = 16) the mask pass's row offset row * 4 * W + k < 6.4e7 and
// the pull's session e = node * S + s < 3e6, peer row p * 4 * W < 6.4e7
// and ring slot offset < 3.2e7 are all size_t.

#include <cstdint>
#include <cuda_runtime.h>

#include "budget_words.cuh"

namespace {

constexpr int kFastClasses = 4;
// peers whose plane loads a thread issues together
constexpr int kPeerBatch = 4;

// The sync ring and the session delays of one launch.
struct Classes {
  uint32_t* ring;         // [d_slots, n, w]
  const int32_t* sdelay;  // [n * s_peers], or null: every edge class 0
  int d_slots, base;
};

__device__ __forceinline__ int edge_class(const Classes& c, size_t e) {
  return c.sdelay != nullptr ? c.sdelay[e] : 0;
}

// VEC consecutive words, one 128-bit access where VEC is 4 (the
// launcher checks the alignment).
template <int VEC>
__device__ __forceinline__ void load_vec(const uint32_t* p,
                                         uint32_t (&x)[VEC]) {
  if constexpr (VEC == 4) {
    uint4 v = *reinterpret_cast<const uint4*>(p);
    x[0] = v.x;
    x[1] = v.y;
    x[2] = v.z;
    x[3] = v.w;
  } else {
#pragma unroll
    for (int i = 0; i < VEC; ++i) x[i] = p[i];
  }
}

template <int VEC>
__device__ __forceinline__ void store_vec(uint32_t* p,
                                          const uint32_t (&x)[VEC]) {
  if constexpr (VEC == 4) {
    *reinterpret_cast<uint4*>(p) = make_uint4(x[0], x[1], x[2], x[3]);
  } else {
#pragma unroll
    for (int i = 0; i < VEC; ++i) p[i] = x[i];
  }
}

// Folds a thread's VEC granted words of one (node, run) by class and ORs
// them into the ring: add(g, d) per edge of class d, then flush().  The
// thread owns the run in every slot, so no atomics.
template <int VEC>
struct ClassFold {
  Classes c;
  size_t row;  // node * w + k, the run's offset within a slot
  size_t slot_stride;
  uint32_t acc[kFastClasses][VEC];
  bool any;

  __device__ ClassFold(const Classes& c_, size_t row_, size_t slot_stride_)
      : c(c_), row(row_), slot_stride(slot_stride_), any(false) {
#pragma unroll
    for (int d = 0; d < kFastClasses; ++d)
#pragma unroll
      for (int v = 0; v < VEC; ++v) acc[d][v] = 0u;
  }

  __device__ __forceinline__ uint32_t* word(int d) const {
    return c.ring + (size_t)((c.base + d) % c.d_slots) * slot_stride + row;
  }

  __device__ __forceinline__ void add(const uint32_t (&g)[VEC], int d) {
    uint32_t nz = 0u;
#pragma unroll
    for (int v = 0; v < VEC; ++v) nz |= g[v];
    if (nz == 0u) return;
    any = true;
    int classes = c.sdelay != nullptr ? c.d_slots - 1 : 1;
    if (d < 0 || d >= classes) return;  // JAX's loop never reaches it
    if (d < kFastClasses) {
#pragma unroll
      for (int q = 0; q < kFastClasses; ++q)
        if (d == q) {
#pragma unroll
          for (int v = 0; v < VEC; ++v) acc[q][v] |= g[v];
        }
    } else {
      uint32_t* p = word(d);
#pragma unroll
      for (int v = 0; v < VEC; ++v) p[v] |= g[v];
    }
  }

  __device__ __forceinline__ void flush() {
#pragma unroll
    for (int d = 0; d < kFastClasses; ++d) {
      uint32_t nz = 0u;
#pragma unroll
      for (int v = 0; v < VEC; ++v) nz |= acc[d][v];
      if (nz == 0u) continue;
      uint32_t cur[VEC];
      load_vec<VEC>(word(d), cur);
#pragma unroll
      for (int v = 0; v < VEC; ++v) cur[v] |= acc[d][v];
      store_vec<VEC>(word(d), cur);
    }
  }
};

__device__ __forceinline__ uint32_t need_word(uint32_t haves_d,
                                              uint32_t partial_d,
                                              uint32_t below_d,
                                              uint32_t have_d, uint32_t miss_w,
                                              uint32_t partial_w,
                                              uint32_t below_w,
                                              uint32_t have_w) {
  uint32_t wanted = (miss_w & haves_d) | (partial_w & (haves_d | partial_d)) |
                    (~below_w & below_d);
  return wanted & have_d & ~have_w;
}

// The unmetered pull: `group` threads (a power of two up to 32) per node,
// thread q of a node taking its runs q, q + group, ... of VEC words.
// Runs of four words ask for two blocks an SM: the compiler then keeps a
// thread's plane loads within 128 registers.
template <int VEC>
__global__ void __launch_bounds__(256, VEC == 4 ? 2 : 1)
    sync_pull_kernel(const uint32_t* __restrict__ masks,
                                 const uint32_t* __restrict__ miss,
                                 const int32_t* __restrict__ peers,
                                 const bool* __restrict__ ok, Classes cls,
                                 bool* __restrict__ fruitful,
                                 uint32_t* __restrict__ granted, int n, int w,
                                 int s_peers, int group) {
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
  const size_t i = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  const int node = (int)(i / group);
  const int q = (int)(i % group);
  const int runs = w / VEC;
  bool any = false;
  if (node < n) {
    const uint32_t* own = masks + (size_t)node * 4 * w;
    for (int r = q; r < runs; r += group) {
      const int k = r * VEC;
      uint32_t miss_w[VEC], partial_w[VEC], below_w[VEC], have_w[VEC];
      load_vec<VEC>(miss + (size_t)node * w + k, miss_w);
      load_vec<VEC>(own + w + k, partial_w);
      load_vec<VEC>(own + 2 * w + k, below_w);
      load_vec<VEC>(own + 3 * w + k, have_w);
      ClassFold<VEC> fold(cls, (size_t)node * w + k, (size_t)n * w);
      for (int s0 = 0; s0 < s_peers; s0 += kPeerBatch) {
        // the batch's peer ids, ok flags and classes first ...
        int p[kPeerBatch], d[kPeerBatch];
        bool live[kPeerBatch];
#pragma unroll
        for (int b = 0; b < kPeerBatch; ++b) {
          p[b] = 0;
          d[b] = 0;
          live[b] = false;
          if (s0 + b < s_peers) {
            size_t e = (size_t)node * s_peers + s0 + b;
            int pe = peers[e];
            live[b] = ok[e] && pe >= 0 && pe < n;
            p[b] = live[b] ? pe : 0;
            d[b] = edge_class(cls, e);
          }
        }
        // ... then every plane load of the batch before any is used
        uint32_t dm[kPeerBatch][4][VEC];
#pragma unroll
        for (int b = 0; b < kPeerBatch; ++b) {
          if (live[b]) {
            const uint32_t* row = masks + (size_t)p[b] * 4 * w + k;
#pragma unroll
            for (int pl = 0; pl < 4; ++pl) load_vec<VEC>(row + pl * w, dm[b][pl]);
          } else {
#pragma unroll
            for (int pl = 0; pl < 4; ++pl)
#pragma unroll
              for (int v = 0; v < VEC; ++v) dm[b][pl][v] = 0u;
          }
        }
#pragma unroll
        for (int b = 0; b < kPeerBatch; ++b) {
          if (s0 + b < s_peers) {
            uint32_t g[VEC];
#pragma unroll
            for (int v = 0; v < VEC; ++v)
              g[v] = need_word(dm[b][0][v], dm[b][1][v], dm[b][2][v],
                               dm[b][3][v], miss_w[v], partial_w[v],
                               below_w[v], have_w[v]);
            if (granted)
              store_vec<VEC>(granted + ((size_t)node * s_peers + s0 + b) * w + k,
                             g);
            fold.add(g, d[b]);
          }
        }
      }
      fold.flush();
      any |= fold.any;
    }
  }
  // fruitful: the OR over the node's group, aligned lanes of one warp
  for (int off = group / 2; off > 0; off >>= 1)
    any |= __shfl_xor_sync(0xffffffffu, (int)any, off) != 0;
  if (node < n && q == 0) fruitful[node] = any;
}

constexpr int kMaxWarps = 8;

__global__ void sync_pull_metered_kernel(
    const uint32_t* __restrict__ masks, const uint32_t* __restrict__ miss,
    const int32_t* __restrict__ peers, const bool* __restrict__ ok,
    Classes cls, bool* __restrict__ fruitful,
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
    const uint32_t* d = masks + (size_t)(live ? p : 0) * 4 * w;
    for (int k = lane; k < w; k += 32) {
      row[k] = live ? need_word(d[k], d[w + k], d[2 * w + k], d[3 * w + k],
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
    ClassFold<1> fold(cls, (size_t)node * w + k, (size_t)n * w);
    for (int s = 0; s < s_peers; ++s) {
      const uint32_t g[1] = {need[(size_t)s * w + k]};
      fold.add(g, edge_class(cls, (size_t)node * s_peers + s));
    }
    fold.flush();
    any |= fold.any;
  }
  // every node's flag, 0 or 1: the wrapper neither fills nor casts it
  any = __syncthreads_or(any);
  if (threadIdx.x == 0) fruitful[node] = any;
}

// The mask pass: `nb` rows a block.
__global__ void sync_masks_kernel(const int32_t* __restrict__ heads,
                                  const int32_t* __restrict__ gap_lo,
                                  const int32_t* __restrict__ gap_hi,
                                  const uint32_t* __restrict__ have,
                                  uint32_t* __restrict__ masks,
                                  uint32_t* __restrict__ miss, int rows,
                                  int a, int g, int c, int w, int nb,
                                  int vc) {
  // covered versions [nb, a, vc]; heads [nb, a]
  extern __shared__ uint32_t s_cov[];
  const int row0 = blockIdx.x * nb;
  const int nr = min(nb, rows - row0);
  int32_t* s_head = reinterpret_cast<int32_t*>(s_cov + nb * a * vc);
  for (int i = threadIdx.x; i < nr * a; i += blockDim.x)
    s_head[i] = heads[(size_t)row0 * a + i];
  // gaps_to_mask: version v (0-based) of (row, writer) is covered when a
  // slot has lo > 0 and lo <= v + 1 <= hi.  A thread folds one (row,
  // writer)'s g runs, read as 16-byte vectors where g allows, into a bit
  // per version, 32 versions a word.
  const bool vec = (g & 3) == 0 && ((reinterpret_cast<uintptr_t>(gap_lo) |
                                     reinterpret_cast<uintptr_t>(gap_hi)) &
                                    15) == 0;
  for (int i = threadIdx.x; i < nr * a * vc; i += blockDim.x) {
    const int ra = i / vc;
    const int first = (i - ra * vc) * 32;
    const size_t off = ((size_t)row0 * a + ra) * g;
    uint32_t bits = 0u;
    auto fold = [&](int l, int h) {
      if (l <= 0 || h < l) return;
      const int b0 = max(l - 1 - first, 0);
      const int b1 = min(h - 1 - first, 31);
      if (b0 <= b1) bits |= (0xFFFFFFFFu >> (31 - b1)) & (0xFFFFFFFFu << b0);
    };
    if (vec) {
      const int4* lo4 = reinterpret_cast<const int4*>(gap_lo + off);
      const int4* hi4 = reinterpret_cast<const int4*>(gap_hi + off);
      for (int s = 0; s < g / 4; ++s) {
        const int4 l = lo4[s], h = hi4[s];
        fold(l.x, h.x);
        fold(l.y, h.y);
        fold(l.z, h.z);
        fold(l.w, h.w);
      }
    } else {
      for (int s = 0; s < g; ++s) fold(gap_lo[off + s], gap_hi[off + s]);
    }
    s_cov[i] = bits;
  }
  __syncthreads();
  const int gpw = 32 / c;
  const uint32_t gm = c == 32 ? 0xFFFFFFFFu : ((1u << c) - 1u);
  for (int i = threadIdx.x; i < nr * w; i += blockDim.x) {
    const int r = i / w;
    const int k = i - r * w;
    const size_t row = (size_t)row0 + r;
    const uint32_t hv = have[row * w + k];
    // group g = v * A + a, version-major (grid_to_words)
    const int g0 = k * gpw;
    int v = g0 / a;
    int wa = g0 - v * a;
    uint32_t miss_lo = 0u, below_lo = 0u, comp_lo = 0u;
    for (int j = 0; j < gpw; ++j) {
      const int sh = j * c;
      const int ra = r * a + wa;
      miss_lo |= ((s_cov[ra * vc + (v >> 5)] >> (v & 31)) & 1u) << sh;
      below_lo |= (uint32_t)(v < s_head[ra]) << sh;  // v + 1 <= head
      comp_lo |= (uint32_t)(((hv >> sh) & gm) == gm) << sh;
      if (++wa == a) {
        wa = 0;
        ++v;
      }
    }
    // each group's low bit over its C bits (no carries: fields of C bits)
    const uint32_t miss_w = miss_lo * gm;
    const uint32_t below_w = below_lo * gm;
    const uint32_t comp_w = comp_lo * gm;
    uint32_t* out = masks + row * 4 * w + k;
    out[0] = below_w & ~miss_w & comp_w;
    out[w] = below_w & ~miss_w & ~comp_w;
    out[2 * w] = below_w;
    out[3 * w] = hv;
    miss[row * w + k] = miss_w;
  }
}

constexpr int kThreads = 256;

template <int VEC>
void launch_vec(const void* masks, const void* miss, const void* peers,
                const void* ok, Classes cls, void* fruitful, void* granted,
                int n, int w, int s_peers, int lanes, cudaStream_t stream) {
  const int runs = w / VEC;
  int group = 1;
  while (group < runs && group < 32) group *= 2;
  const size_t total = (size_t)n * group;
  const unsigned blocks = (unsigned)((total + kThreads - 1) / kThreads);
  sync_pull_kernel<VEC><<<dim3(blocks, lanes), kThreads, 0, stream>>>(
      (const uint32_t*)masks, (const uint32_t*)miss, (const int32_t*)peers,
      (const bool*)ok, cls, (bool*)fruitful, (uint32_t*)granted, n, w,
      s_peers, group);
}

// The unmetered pull's launch, solo (lanes = 1) or on the lanes.
int launch_pull(const void* masks, const void* miss, const void* peers,
                const void* ok, void* ring, void* fruitful, void* granted,
                const void* sdelay, int n, int w, int s_peers, int d_slots,
                int base, int lanes, cudaStream_t stream) {
  if (n <= 0 || w <= 0 || s_peers <= 0 || d_slots <= 0 || base < 0 ||
      base >= d_slots || lanes <= 0 || lanes > 65535)
    return (int)cudaErrorInvalidValue;
  // 128-bit runs where w and every word tensor allow them (the ring's
  // slots and lanes then stay 16-byte aligned too), else single words
  const bool vec = w % 4 == 0 &&
                   ((reinterpret_cast<uintptr_t>(masks) |
                     reinterpret_cast<uintptr_t>(miss) |
                     reinterpret_cast<uintptr_t>(ring) |
                     reinterpret_cast<uintptr_t>(granted)) & 15) == 0;
  Classes cls{(uint32_t*)ring, (const int32_t*)sdelay, d_slots, base};
  if (vec)
    launch_vec<4>(masks, miss, peers, ok, cls, fruitful, granted, n, w,
                  s_peers, lanes, stream);
  else
    launch_vec<1>(masks, miss, peers, ok, cls, fruitful, granted, n, w,
                  s_peers, lanes, stream);
  return (int)cudaGetLastError();
}

}  // namespace

// `ring` is the sync ring [d_slots, n, w] and `sdelay` the edges' session
// delays (null: every grant lands in slot `base`; the wrappers then pass
// the one slot as a ring of d_slots = 1).  fruitful is bool [n].
extern "C" int corro_sync_pull(const void* masks, const void* miss,
                               const void* peers, const void* ok,
                               void* ring, void* fruitful, void* granted,
                               const void* sdelay, int n, int w, int s_peers,
                               int d_slots, int base, void* stream) {
  return launch_pull(masks, miss, peers, ok, ring, fruitful, granted, sdelay,
                     n, w, s_peers, d_slots, base, 1, (cudaStream_t)stream);
}

// The lane entry: masks [lanes, N, 4, W], miss [lanes, N, W], peers and
// ok [lanes, N, S], ring [lanes, d_slots, N, W], fruitful bool [lanes,
// N]; with `sdelay` [lanes, N * S] (K3's delay lane entry) each lane's
// grants land by class from slot `base`, else all in slot `base`; with
// `granted` [lanes, N * S, W] (the recording forms) each lane's granted
// words are copied there too.
extern "C" int corro_sync_pull_lanes(const void* masks, const void* miss,
                                     const void* peers, const void* ok,
                                     void* ring, void* fruitful,
                                     void* granted, const void* sdelay, int n,
                                     int w, int s_peers, int d_slots,
                                     int base, int lanes, void* stream) {
  return launch_pull(masks, miss, peers, ok, ring, fruitful, granted, sdelay,
                     n, w, s_peers, d_slots, base, lanes,
                     (cudaStream_t)stream);
}

// The mask pass over `rows` rows (the lanes folded: K * N): heads [rows,
// a], gap_lo and gap_hi [rows, a, g], have [rows, w] in; masks [rows, 4,
// w] and miss [rows, w] out, for v versions of c chunks (w * 32 = v * a
// * c).
extern "C" int corro_sync_masks(const void* heads, const void* gap_lo,
                                const void* gap_hi, const void* have,
                                void* masks, void* miss, int rows, int a,
                                int g, int v, int c, int w, void* stream) {
  if (rows <= 0 || a <= 0 || g < 0 || v <= 0 || c <= 0 || c > 32 ||
      (c & (c - 1)) != 0 || (long long)w * 32 != (long long)v * a * c)
    return (int)cudaErrorInvalidValue;
  const int vc = (v + 31) / 32;
  const size_t per_row = ((size_t)a * vc + a) * 4;
  int nb = w >= kThreads ? 1 : kThreads / w;
  while (nb > 1 && nb * per_row > 48 * 1024) nb /= 2;
  const size_t smem = nb * per_row;
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        sync_masks_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  sync_masks_kernel<<<(rows + nb - 1) / nb, kThreads, smem,
                      (cudaStream_t)stream>>>(
      (const int32_t*)heads, (const int32_t*)gap_lo, (const int32_t*)gap_hi,
      (const uint32_t*)have, (uint32_t*)masks, (uint32_t*)miss, rows, a, g,
      c, w, nb, vc);
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
      (const bool*)ok, cls, (bool*)fruitful, (const int32_t*)nbytes,
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
