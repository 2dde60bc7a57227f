// K9: the per-edge fault queries of a factored fault plan.
//
// Replaces corrosion_tpu/sim/faults.py:182 _factored_hits and what the
// round builds on it: faults.py:195 fault_edge_block, :207
// fault_edge_loss, :303 fault_session_refused, the cut and threshold
// half of :260 fault_wire_effects, and the fault branch of
// corrosion_tpu/sim/swim.py:125 _reachable (swim.py:161-181).  The plain
// versions are in corrosion_tpu_torch/sim/faults.py.
//
// A factor k hits edge (s, d) this round when on[k] & src_mask[k, s] &
// dst_mask[k, d] and s != d: self-edges never fault (the probe relay
// legs do evaluate (x, x) edges).  An edge is cut when any block factor
// hits it; its extra loss threshold is the max of the hitting loss
// factors' thresholds (0 when none hits).  `on` is a column of the
// plan's [K, R+1] active matrix, read with its stride.
//
// Two entry points, one thread per edge:
//   corro_fault_edges  writes the cut (optionally OR the reversed edge's
//                      cut: a sync session dies on a cut in either
//                      direction) and/or the threshold, and/or clears
//                      ok[e] on a cut — the query, session and wire calls;
//   corro_fault_reach  _reachable's whole fault branch in place:
//                      ok[e] &= !cut & !(u8 bits[e] < thr[e]), the bits
//                      being aligned_u8_bits(fold_in(fold_in(key, seed),
//                      tag), [E]): byte e%4 (little-endian) of u32 word
//                      e/4 of a bits draw, whose word i is the hash of
//                      counter (0, i) whatever the draw's padded length.
//                      Each block derives the folded key once; an edge
//                      with no threshold draws nothing (no u8 is below 0).
//
// With the flight recorder on, corro_fault_edges also counts into an
// int64 accumulator the ok edges its cut clears (`count`, which needs
// `ok`): the broadcast's cut edges (corrosion_tpu/sim/packed.py:471-477,
// sum(ok_pre & ~ok)) and the sync's refused sessions (packed.py:1194-1196,
// sum(ok & refused)).  Each warp ballots its hits and the block adds
// once.  A null `count` (telemetry off) counts nothing.
//
// Bound on the H100: launch latency.  An edge reads two int32 ids and
// K mask bytes at each of them; at the storm's E <= 300000 and K <= 2
// that is under 4 MB, about a microsecond of memory time, below the
// cost of a launch.  Design: the simplest one-pass form; the masks of a
// half-split partition are byte arrays the caches hold whole.

#include <cstdint>
#include <cuda_runtime.h>

#include "threefry.cuh"

namespace {

struct Factors {
  const uint8_t* on;   // [k], stride on_stride
  const uint8_t* src;  // [k, n]
  const uint8_t* dst;  // [k, n]
  int k;
  int on_stride;
};

__device__ __forceinline__ bool hits(const Factors& f, int kk, int n, int s,
                                     int d) {
  return f.on[(size_t)kk * f.on_stride] && f.src[(size_t)kk * n + s] &&
         f.dst[(size_t)kk * n + d];
}

__device__ __forceinline__ bool cut(const Factors& b, int n, int s, int d) {
  if (s == d) return false;
  for (int kk = 0; kk < b.k; ++kk)
    if (hits(b, kk, n, s, d)) return true;
  return false;
}

__device__ __forceinline__ uint8_t loss_threshold(const Factors& l,
                                                  const uint8_t* thr, int n,
                                                  int s, int d) {
  uint8_t m = 0;
  if (s == d) return m;
  for (int kk = 0; kk < l.k; ++kk)
    if (hits(l, kk, n, s, d) && thr[kk] > m) m = thr[kk];
  return m;
}

__device__ __forceinline__ bool in_range(int s, int d, int n) {
  return s >= 0 && s < n && d >= 0 && d < n;
}

__global__ void fault_edges_kernel(Factors b, Factors l,
                                   const uint8_t* __restrict__ thr,
                                   const int32_t* __restrict__ src,
                                   const int32_t* __restrict__ dst,
                                   uint8_t* __restrict__ cut_out,
                                   uint8_t* __restrict__ thr_out,
                                   uint8_t* __restrict__ ok,
                                   unsigned long long* __restrict__ count,
                                   int n, int e, int sym) {
  int i = blockIdx.x * blockDim.x + threadIdx.x;
  bool cleared = false;
  if (i < e) {
    int s = src[i], d = dst[i];
    bool valid = in_range(s, d, n);
    bool c = valid && (cut(b, n, s, d) || (sym && cut(b, n, d, s)));
    if (cut_out) cut_out[i] = c;
    if (thr_out) thr_out[i] = valid ? loss_threshold(l, thr, n, s, d) : 0;
    if (ok && c) {
      cleared = ok[i] != 0;
      ok[i] = 0;
    }
  }
  if (count == nullptr) return;
  __shared__ unsigned int hits;
  if (threadIdx.x == 0) hits = 0u;
  __syncthreads();
  unsigned int warp_hits = __popc(__ballot_sync(0xFFFFFFFFu, cleared));
  if ((threadIdx.x & 31) == 0 && warp_hits) atomicAdd(&hits, warp_hits);
  __syncthreads();
  if (threadIdx.x == 0 && hits) atomicAdd(count, (unsigned long long)hits);
}

__global__ void fault_reach_kernel(Factors b, Factors l,
                                   const uint8_t* __restrict__ thr,
                                   const int32_t* __restrict__ src,
                                   const int32_t* __restrict__ dst,
                                   const int64_t* __restrict__ key,
                                   uint8_t* __restrict__ ok, int n, int e,
                                   uint32_t seed, uint32_t tag) {
  __shared__ uint32_t folded[2];
  if (threadIdx.x == 0) {
    corro::Pair f = corro::threefry2x32((uint32_t)key[0], (uint32_t)key[1],
                                        0u, seed);
    corro::Pair g = corro::threefry2x32(f.a, f.b, 0u, tag);
    folded[0] = g.a;
    folded[1] = g.b;
  }
  __syncthreads();
  int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= e || !ok[i]) return;  // a cleared ok stays cleared
  int s = src[i], d = dst[i];
  if (!in_range(s, d, n)) return;
  if (cut(b, n, s, d)) {
    ok[i] = 0;
    return;
  }
  uint8_t t = loss_threshold(l, thr, n, s, d);
  if (t == 0) return;
  corro::Pair h = corro::threefry2x32(folded[0], folded[1], 0u,
                                      (uint32_t)i >> 2);
  uint32_t byte = ((h.a ^ h.b) >> (8 * (i & 3))) & 0xFFu;
  if (byte < t) ok[i] = 0;
}

constexpr int kThreads = 256;

bool shapes_ok(int kb, int kl, int n, int e) {
  return kb >= 0 && kl >= 0 && n > 0 && e >= 0;
}

}  // namespace

extern "C" int corro_fault_edges(const void* b_on, const void* b_src,
                                 const void* b_dst, const void* l_on,
                                 const void* l_src, const void* l_dst,
                                 const void* l_thr, const void* src,
                                 const void* dst, void* cut_out,
                                 void* thr_out, void* ok, void* count,
                                 int kb, int b_stride, int kl, int l_stride,
                                 int n, int e, int sym, void* stream) {
  if (!shapes_ok(kb, kl, n, e) || (count != nullptr && ok == nullptr))
    return (int)cudaErrorInvalidValue;
  if (e == 0) return (int)cudaSuccess;
  Factors b{(const uint8_t*)b_on, (const uint8_t*)b_src,
            (const uint8_t*)b_dst, kb, b_stride};
  Factors l{(const uint8_t*)l_on, (const uint8_t*)l_src,
            (const uint8_t*)l_dst, kl, l_stride};
  unsigned blocks = (unsigned)((e + kThreads - 1) / kThreads);
  fault_edges_kernel<<<blocks, kThreads, 0, (cudaStream_t)stream>>>(
      b, l, (const uint8_t*)l_thr, (const int32_t*)src, (const int32_t*)dst,
      (uint8_t*)cut_out, (uint8_t*)thr_out, (uint8_t*)ok,
      (unsigned long long*)count, n, e, sym);
  return (int)cudaGetLastError();
}

extern "C" int corro_fault_reach(const void* b_on, const void* b_src,
                                 const void* b_dst, const void* l_on,
                                 const void* l_src, const void* l_dst,
                                 const void* l_thr, const void* src,
                                 const void* dst, const void* key, void* ok,
                                 int kb, int b_stride, int kl, int l_stride,
                                 int n, int e, int seed, int tag,
                                 void* stream) {
  if (!shapes_ok(kb, kl, n, e)) return (int)cudaErrorInvalidValue;
  if (e == 0) return (int)cudaSuccess;
  Factors b{(const uint8_t*)b_on, (const uint8_t*)b_src,
            (const uint8_t*)b_dst, kb, b_stride};
  Factors l{(const uint8_t*)l_on, (const uint8_t*)l_src,
            (const uint8_t*)l_dst, kl, l_stride};
  unsigned blocks = (unsigned)((e + kThreads - 1) / kThreads);
  fault_reach_kernel<<<blocks, kThreads, 0, (cudaStream_t)stream>>>(
      b, l, (const uint8_t*)l_thr, (const int32_t*)src, (const int32_t*)dst,
      (const int64_t*)key, (uint8_t*)ok, n, e, (uint32_t)seed,
      (uint32_t)tag);
  return (int)cudaGetLastError();
}
