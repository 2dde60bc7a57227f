// K1: member-table target sampler.
//
// Replaces corrosion_tpu/sim/pswim.py:82 psample_member_targets whole:
// its bucket draw randint(key, (4c, N), 0, M) (pswim.py:92), the
// pswim.py:64 _pack_tables words it gathers and their pswim.py:76
// _unpack_word, swim.py:111 _dup_before and swim.py:39 _compact_targets.
//
// Per node: draw `over` = 4c bucket slots in the kernel, read the
// (pid, pkey) pair of each from the unpacked tables, pack it in
// registers as (pkey+1)<<19 | (pid+1) and unpack it as JAX does, keep
// the valid candidates (not empty, not self, not believed DOWN), drop
// any that repeats an EARLIER valid candidate, and prefix-compact the
// survivors into `count` output slots padded with -1.
//
// The draw: slot j of node v is randint's element at flat index
// j * N + v, so thread (v, j) hashes that counter under the subkeys of
// split(key, 2) (threefry.cuh randint_at; span and multiplier are the
// wrapper's rng.scalar_span(0, M)).  At M = 64 the multiplier is 0 and
// the `higher` hash is skipped; M = 48 needs it.  The key is read on the
// card from its int64[2] tensor (lane k's row of [K, 2] on the lane
// entry), once a block, so the launch never reads the host.
//
// Pack and unpack: the word is built and split exactly as _pack_tables
// and _unpack_word build and split it, in uint32_t, so every case JAX's
// words can hold is reproduced by construction — the top bit at
// pkey + 1 >= 4096 (shifted logically), an id past 2^19 - 1 spilling
// into the key field, the -1 empties.  DOWN is tested as (key & 3),
// floor-mod 4 like jnp's `%` also for the -1 sentinel.
//
// Bound on the H100: operations.  Per node it hashes `over` counters
// (twice where the multiplier is not 0) and reads `over` (pid, pkey)
// pairs of its own two 256-byte rows, then writes `count` ints; counting
// each distinct pair's 8 bytes once, the hashes take longer.  In
// practice the reads cost most: a c = 3 call's 12 picks touch on average
// 6.4 of each row's eight 32-byte sectors, in two tables, at random.
// Design: `lpn` lanes a node (the power of two at or above `over`: 4 at
// c = 1, 16 at c = 3), lane j hashing draw j and gathering its pair, so
// a node's draws and its 2 * over gathers are all in flight at once and
// a call runs over * N threads, not N.  The dedup compares each lane's
// candidate with its earlier lanes' through warp shuffles, and the
// compaction ranks the kept lanes with one ballot and a popcount; each
// node's `count` slots are written by its lanes, the kept candidate of
// rank q to slot q, lane q's -1 where fewer are kept.  A second form, a
// block staging its nodes' row pairs in shared memory with coalesced
// loads (the whole rows, 512 bytes a node), was slower on an H100 at the
// storm's shapes (N = 100 000, M = 64) at both c = 1 and c = 3, so the
// gathers stay.  The slots tensor and the packed table are never
// written.
//
// Second entry point, corro_sample_uniform: the uniform sampler of
// corrosion_tpu/sim/swim.py:59 sample_member_targets (swim.py:95-108).
// The `over` candidates of a node are column `node` of a [over, N]
// randint draw (K5) themselves, not table words; a candidate is valid
// when it is not the node and, given the full-view beliefs `view`
// (i8[N, N], null for ground-truth membership), the node does not
// believe it DOWN (view[node, cand] != DOWN).  Dedup and compaction are
// K1's.  Bound: bytes — the draws, one gathered belief byte each from
// the node's own view row, the output.
//
// Third entry point, corro_sample_view: the PeerSwap view sampler of
// corrosion_tpu/topo/sampler.py:57 psample_view_targets, which
// swim.py:59 sample_member_targets dispatches to under peer_sampler
// "peerswap" (swim.py:86-94).  Candidate o of a node is pview[node,
// slots[o, node]] (slots: a [over, N] randint draw over [0, V)); it is
// valid when it is a peer (>= 0), not the node and, given full-view
// beliefs, not believed DOWN (view[node, max(cand, 0)]).  Dedup and
// compaction are K1's (`keep_compact`, shared by all three entries).
// Bound: bytes — the slot draws, one gathered 4-byte view entry each
// from the node's own 64-byte view row, the output.
//
// Lane entry, corro_sample_targets_lanes: the member sampler over the
// seed ensemble's lanes (B16, corrosion_tpu/campaign/ensemble.py:114),
// a grid dimension: blockIdx.y is the lane, whose key [2], tables
// [N, M] and output [N, count] are its slices of the [K, ...] tensors.
// Draw counters, candidates and `node` stay lane-local, so the draws,
// the self test and the output are the solo entry's per lane under the
// lane's key.  Bound: K times the solo bound.
//
// Uniform lane entry, corro_sample_uniform_lanes: the uniform sampler
// over the lanes of a dense-round ensemble (B16, dense half:
// corrosion_tpu/campaign/ensemble.py:114 and :187), the same grid
// dimension: lane blockIdx.y's candidate draws [over, N], beliefs
// [N, N] (when given) and output [N, count], offset in 64 bits.  Bound:
// K times the solo bound.
//
// View lane entry, corro_sample_view_lanes: the PeerSwap view sampler
// over the lanes of a dense-round ensemble (B16s: corrosion_tpu/campaign/
// ensemble.py:114 vmaps sampler.py:57), the same grid dimension: lane
// blockIdx.y's views [N, V], slot draws [over, N], beliefs [N, N] (when
// given) and output [N, count], offset in 64 bits; the candidates are
// lane-local ids.  Bound: K times the solo bound.

#include <cstdint>
#include <cuda_runtime.h>

#include "threefry.cuh"

namespace {

constexpr int PACK_SHIFT = 19;
constexpr uint32_t PACK_MASK = (1u << PACK_SHIFT) - 1u;
constexpr int DOWN = 2;
constexpr int MAX_OVER = 16;

// Drop each valid candidate that repeats an EARLIER valid one
// (swim.py:111 _dup_before), then prefix-compact the survivors into the
// node's `count` output slots, -1 padding (swim.py:39 _compact_targets).
__device__ __forceinline__ void keep_compact(const int (&cand)[MAX_OVER],
                                             const bool (&valid)[MAX_OVER],
                                             int32_t* __restrict__ dst,
                                             int count) {
  int filled = 0;
#pragma unroll
  for (int j = 0; j < MAX_OVER; ++j) {
    bool keep = valid[j];
#pragma unroll
    for (int i = 0; i < j; ++i) {
      keep = keep && !(valid[i] && cand[i] == cand[j]);
    }
    if (keep && filled < count) dst[filled++] = cand[j];
  }
  for (; filled < count; ++filled) dst[filled] = -1;
}

// One candidate from its bucket's (pid, pkey) pair: the word packed as
// _pack_tables packs it and split as _unpack_word splits it.  Returns
// the candidate id if it is valid for `node`, else -1 (a valid one is
// never negative).
__device__ __forceinline__ int member_candidate(int32_t id, int32_t key,
                                                int node) {
  uint32_t w = (((uint32_t)key + 1u) << PACK_SHIFT) | ((uint32_t)id + 1u);
  int pid = (int)(w & PACK_MASK) - 1;
  int k = (int)(w >> PACK_SHIFT) - 1;
  bool valid = pid >= 0 && pid != node && (k & 3) != DOWN && k >= 0;
  return valid ? pid : -1;
}

constexpr int kMemberThreads = 256;

// The member entry: `lpn` lanes a node (a power of two, over <= lpn <=
// 32), lane j drawing candidate j and gathering its (pid, pkey) pair.
__global__ void sample_targets_kernel(const int32_t* __restrict__ pid,
                                      const int32_t* __restrict__ pkey,
                                      const int64_t* __restrict__ key,
                                      int32_t* __restrict__ out, int n,
                                      int m, int over, int count,
                                      uint32_t span, uint32_t mult,
                                      int lpn) {
  __shared__ uint32_t sub[4];
  // the lane's slices (lane 0 on the solo entry)
  const size_t lane = blockIdx.y;
  pid += lane * n * m;
  pkey += lane * n * m;
  out += lane * n * count;
  key += 2 * lane;
  if (threadIdx.x == 0)
    corro::randint_subkeys(
        corro::Pair{(uint32_t)key[0], (uint32_t)key[1]}, sub);
  const int per_block = blockDim.x / lpn;
  const int first = blockIdx.x * per_block;
  const int nodes = min(per_block, n - first);
  const int r = threadIdx.x / lpn;
  const int j = threadIdx.x % lpn;
  const int node = first + r;
  __syncthreads();
  int cand = -1;
  if (r < nodes && j < over) {
    const uint32_t sk[4] = {sub[0], sub[1], sub[2], sub[3]};
    int slot = (int)corro::randint_at(
        sk, span, mult, (uint32_t)j * (uint32_t)n + (uint32_t)node);
    // jnp gathers clamp out-of-range indices; so does this one
    slot = slot < 0 ? 0 : (slot >= m ? m - 1 : slot);
    cand = member_candidate(pid[(size_t)node * m + slot],
                            pkey[(size_t)node * m + slot], node);
  }
  // _dup_before: drop a candidate equal to an EARLIER valid one of its
  // node (an invalid one is -1 and equals no valid candidate)
  bool keep = cand >= 0;
  for (int i = 0; i + 1 < lpn; ++i) {
    int earlier = __shfl_sync(0xffffffffu, cand, i, lpn);
    keep = keep && !(i < j && earlier == cand);
  }
  // _compact_targets: kept candidate of rank q to slot q, -1 padding
  const unsigned ball = __ballot_sync(0xffffffffu, keep);
  const unsigned mine =
      lpn == 32 ? ball
                : (ball >> ((threadIdx.x & 31) & ~(lpn - 1))) &
                      ((1u << lpn) - 1u);
  const int rank = __popc(mine & ((1u << j) - 1u));
  const int kept = __popc(mine);
  if (r < nodes) {
    int32_t* dst = out + (size_t)node * count;
    if (keep && rank < count) dst[rank] = cand;
    if (j >= kept && j < count) dst[j] = -1;
  }
}

__global__ void sample_uniform_kernel(const int32_t* __restrict__ cands,
                                      const int8_t* __restrict__ view,
                                      int32_t* __restrict__ out, int n,
                                      int over, int count) {
  int node = blockIdx.x * blockDim.x + threadIdx.x;
  if (node >= n) return;
  // the lane's slices (lane 0 on the solo entry)
  const size_t lane = blockIdx.y;
  cands += lane * over * n;
  if (view != nullptr) view += lane * n * n;
  out += lane * n * count;
  int cand[MAX_OVER];
  bool valid[MAX_OVER];
#pragma unroll
  for (int j = 0; j < MAX_OVER; ++j) {
    cand[j] = -1;
    valid[j] = false;
    if (j < over) {
      int c = cands[(size_t)j * n + node];
      cand[j] = c;
      bool ok = c != node;
      if (view != nullptr) {
        // jnp gathers clamp out-of-range indices; so does this one
        int col = c < 0 ? 0 : (c >= n ? n - 1 : c);
        ok = ok && view[(size_t)node * n + col] != DOWN;
      }
      valid[j] = ok;
    }
  }
  keep_compact(cand, valid, out + (size_t)node * count, count);
}

__global__ void sample_view_kernel(const int32_t* __restrict__ pview,
                                   const int32_t* __restrict__ slots,
                                   const int8_t* __restrict__ view,
                                   int32_t* __restrict__ out, int n, int v,
                                   int over, int count) {
  int node = blockIdx.x * blockDim.x + threadIdx.x;
  if (node >= n) return;
  // the lane's slices (lane 0 on the solo entry)
  const size_t lane = blockIdx.y;
  pview += lane * n * v;
  slots += lane * over * n;
  if (view != nullptr) view += lane * n * n;
  out += lane * n * count;
  const int32_t* row = pview + (size_t)node * v;
  int cand[MAX_OVER];
  bool valid[MAX_OVER];
#pragma unroll
  for (int j = 0; j < MAX_OVER; ++j) {
    cand[j] = -1;
    valid[j] = false;
    if (j < over) {
      int slot = slots[(size_t)j * n + node];
      // jnp gathers clamp out-of-range indices; so does this one
      slot = slot < 0 ? 0 : (slot >= v ? v - 1 : slot);
      int c = row[slot];
      cand[j] = c;
      bool ok = c >= 0 && c != node;
      if (view != nullptr) {
        int col = c < 0 ? 0 : (c >= n ? n - 1 : c);
        ok = ok && view[(size_t)node * n + col] != DOWN;
      }
      valid[j] = ok;
    }
  }
  keep_compact(cand, valid, out + (size_t)node * count, count);
}

}  // namespace

namespace {

// The member entry's launch, solo (lanes = 1) or on the lanes.
int launch_members(const void* pid, const void* pkey, const void* key,
                   void* out, int n, int m, int count, int span, int mult,
                   int lanes, cudaStream_t stream) {
  const int over = 4 * count;
  if (count <= 0 || over > MAX_OVER || n <= 0 || m <= 0 || span <= 0 ||
      lanes <= 0 || lanes > 65535 || (long long)over * n >= (1ll << 31))
    return (int)cudaErrorInvalidValue;
  int lpn = 1;
  while (lpn < over) lpn *= 2;
  const int per_block = kMemberThreads / lpn;
  sample_targets_kernel<<<dim3((n + per_block - 1) / per_block, lanes),
                          kMemberThreads, 0, stream>>>(
      (const int32_t*)pid, (const int32_t*)pkey, (const int64_t*)key,
      (int32_t*)out, n, m, over, count, (uint32_t)span, (uint32_t)mult, lpn);
  return (int)cudaGetLastError();
}

}  // namespace

// pid, pkey [N, M]; key int64 [2]; out [N, count]; span and mult are
// randint's for maxval M (rng.scalar_span(0, M)).
extern "C" int corro_sample_targets(const void* pid, const void* pkey,
                                    const void* key, void* out, int n, int m,
                                    int count, int span, int mult,
                                    void* stream) {
  return launch_members(pid, pkey, key, out, n, m, count, span, mult, 1,
                        (cudaStream_t)stream);
}

// The lane entry: pid, pkey [lanes, N, M], keys [lanes, 2], out [lanes,
// N, count].
extern "C" int corro_sample_targets_lanes(const void* pid, const void* pkey,
                                          const void* keys, void* out, int n,
                                          int m, int count, int span,
                                          int mult, int lanes, void* stream) {
  return launch_members(pid, pkey, keys, out, n, m, count, span, mult, lanes,
                        (cudaStream_t)stream);
}

extern "C" int corro_sample_uniform(const void* cands, const void* view,
                                    void* out, int n, int over, int count,
                                    void* stream) {
  if (over > MAX_OVER || count > over || n <= 0) return (int)cudaErrorInvalidValue;
  int threads = 256;
  int blocks = (n + threads - 1) / threads;
  sample_uniform_kernel<<<blocks, threads, 0, (cudaStream_t)stream>>>(
      (const int32_t*)cands, (const int8_t*)view, (int32_t*)out, n, over,
      count);
  return (int)cudaGetLastError();
}

extern "C" int corro_sample_view(const void* pview, const void* slots,
                                 const void* view, void* out, int n, int v,
                                 int over, int count, void* stream) {
  if (over > MAX_OVER || count > over || n <= 0 || v <= 0)
    return (int)cudaErrorInvalidValue;
  int threads = 256;
  int blocks = (n + threads - 1) / threads;
  sample_view_kernel<<<blocks, threads, 0, (cudaStream_t)stream>>>(
      (const int32_t*)pview, (const int32_t*)slots, (const int8_t*)view,
      (int32_t*)out, n, v, over, count);
  return (int)cudaGetLastError();
}

extern "C" int corro_sample_uniform_lanes(const void* cands, const void* view,
                                          void* out, int n, int over,
                                          int count, int lanes,
                                          void* stream) {
  if (over > MAX_OVER || count > over || n <= 0 || lanes <= 0 ||
      lanes > 65535)
    return (int)cudaErrorInvalidValue;
  int threads = 256;
  int blocks = (n + threads - 1) / threads;
  sample_uniform_kernel<<<dim3(blocks, lanes), threads, 0,
                          (cudaStream_t)stream>>>(
      (const int32_t*)cands, (const int8_t*)view, (int32_t*)out, n, over,
      count);
  return (int)cudaGetLastError();
}

extern "C" int corro_sample_view_lanes(const void* pview, const void* slots,
                                       const void* view, void* out, int n,
                                       int v, int over, int count, int lanes,
                                       void* stream) {
  if (over > MAX_OVER || count > over || n <= 0 || v <= 0 || lanes <= 0 ||
      lanes > 65535)
    return (int)cudaErrorInvalidValue;
  int threads = 256;
  int blocks = (n + threads - 1) / threads;
  sample_view_kernel<<<dim3(blocks, lanes), threads, 0,
                       (cudaStream_t)stream>>>(
      (const int32_t*)pview, (const int32_t*)slots, (const int8_t*)view,
      (int32_t*)out, n, v, over, count);
  return (int)cudaGetLastError();
}
