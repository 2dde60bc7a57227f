// K1: member-table target sampler.
//
// Replaces corrosion_tpu/sim/pswim.py:82 psample_member_targets, with
// swim.py:111 _dup_before, swim.py:39 _compact_targets and the
// pswim.py:76 _unpack_word of the pswim.py:64 _pack_tables words.
//
// Per node: read `over` drawn bucket slots (the [over, N] randint draws
// stay outside, in rng.py), gather the packed (pkey+1)<<19 | (pid+1)
// word of each, keep the valid candidates (not empty, not self, not
// believed DOWN), drop any that repeats an EARLIER valid candidate, and
// prefix-compact the survivors into `count` output slots padded with -1.
//
// Bound on the H100: bytes.  Per node it reads `over` 4-byte slots
// (coalesced: the draws are [over, N], so thread `node` reads column
// `node`) and gathers `over` 4-byte table words from its own 256-byte
// table row, then writes `count` ints; there is no arithmetic to speak
// of.  Design: one thread per node keeps all <= 16 candidates in
// registers (the loops are unrolled to MAX_OVER with a runtime guard),
// so the dedup and the compaction never touch memory and the only
// device-memory traffic is the draws, the gathered words and the output.
//
// Unsigned trap: the packed word's top bit is set once pkey+1 >= 4096,
// so the word is read as uint32_t and shifted logically.  DOWN is tested
// as (key & 3), which is floor-mod 4 like jnp's `%` also for the -1
// sentinel (3 != DOWN either way).
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
// a grid dimension: blockIdx.y is the lane, whose tables [N, M], draws
// [over, N] and output [N, count] are its slices of the [K, ...]
// tensors.  Candidates and `node` stay lane-local ids, so the self test
// and the output are the solo entry's per lane.  Bound: K times the
// solo bound.
//
// Uniform lane entry, corro_sample_uniform_lanes: the uniform sampler
// over the lanes of a dense-round ensemble (B16, dense half:
// corrosion_tpu/campaign/ensemble.py:114 and :187), the same grid
// dimension: lane blockIdx.y's candidate draws [over, N], beliefs
// [N, N] (when given) and output [N, count], offset in 64 bits.  Bound:
// K times the solo bound.

#include <cstdint>
#include <cuda_runtime.h>

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

__global__ void sample_targets_kernel(const uint32_t* __restrict__ table,
                                      const int32_t* __restrict__ slots,
                                      int32_t* __restrict__ out, int n,
                                      int m, int over, int count) {
  int node = blockIdx.x * blockDim.x + threadIdx.x;
  if (node >= n) return;
  // the lane's slices (lane 0 on the solo entry)
  const size_t lane = blockIdx.y;
  table += lane * n * m;
  slots += lane * over * n;
  out += lane * n * count;
  const uint32_t* row = table + (size_t)node * m;
  int cand[MAX_OVER];
  bool valid[MAX_OVER];
#pragma unroll
  for (int j = 0; j < MAX_OVER; ++j) {
    cand[j] = -1;
    valid[j] = false;
    if (j < over) {
      int slot = slots[(size_t)j * n + node];
      // jnp gathers clamp out-of-range indices; so does this one
      slot = slot < 0 ? 0 : (slot >= m ? m - 1 : slot);
      uint32_t w = row[slot];
      int pid = (int)(w & PACK_MASK) - 1;
      int key = (int)(w >> PACK_SHIFT) - 1;
      cand[j] = pid;
      valid[j] = pid >= 0 && pid != node && (key & 3) != DOWN && key >= 0;
    }
  }
  keep_compact(cand, valid, out + (size_t)node * count, count);
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

extern "C" int corro_sample_targets(const void* table, const void* slots,
                                    void* out, int n, int m, int over,
                                    int count, void* stream) {
  if (over > MAX_OVER || count > over || n <= 0) return (int)cudaErrorInvalidValue;
  int threads = 256;
  int blocks = (n + threads - 1) / threads;
  sample_targets_kernel<<<blocks, threads, 0, (cudaStream_t)stream>>>(
      (const uint32_t*)table, (const int32_t*)slots, (int32_t*)out, n, m,
      over, count);
  return (int)cudaGetLastError();
}

extern "C" int corro_sample_targets_lanes(const void* table,
                                          const void* slots, void* out,
                                          int n, int m, int over, int count,
                                          int lanes, void* stream) {
  if (over > MAX_OVER || count > over || n <= 0 || lanes <= 0 ||
      lanes > 65535)
    return (int)cudaErrorInvalidValue;
  int threads = 256;
  int blocks = (n + threads - 1) / threads;
  sample_targets_kernel<<<dim3(blocks, lanes), threads, 0,
                          (cudaStream_t)stream>>>(
      (const uint32_t*)table, (const int32_t*)slots, (int32_t*)out, n, m,
      over, count);
  return (int)cudaGetLastError();
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
