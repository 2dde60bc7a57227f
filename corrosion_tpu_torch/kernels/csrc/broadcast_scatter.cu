// K2: broadcast fan-out scatter into the word delay ring.
//
// Replaces the ring scatter of corrosion_tpu/sim/packed.py:369
// broadcast_packed (packed.py:507-512: `inflight.at[flat_idx].max(sent)`
// on a dense u8 [D, N, P] ring, after unpacking the sending words).
//
// Edge e = (src = e / fanout, dst[e]) with `ok[e]` built in plain torch
// exactly as packed.py:435-441.  For every word k of an ok edge the
// kernel ORs sending[src, k] into ring[slot[e], dst[e], k], with
// slot[e] = (t + delay[e]) % D.  JAX keeps the ring dense u8 only
// because XLA has no OR scatter (packed.py:285-293); the sent values
// are 0/1, so a u8 max per payload and a u32 OR per word set the same
// bits.  OR is order-independent, so the atomics keep the result
// deterministic whatever order the edges land in.
//
// Bound on the H100: bytes.  Each edge reads its sender's W words (the
// E = N*fanout rows are a regular fanout-fold repeat of the N sending
// rows, so consecutive threads read the same row and it comes from L2)
// and read-modify-writes W ring words at a random row.  Design: one
// thread per (edge, word), so a warp covers two edges' rows as
// contiguous 64-byte runs; a zero word issues no atomic at all, which
// skips most of the ring traffic once relay budgets run out.
//
// K10, the second entry point, runs the same kernel with the wire's
// per-(edge, payload) loss drawn in the kernel, from up to two streams
// whose drops OR (a bit survives only if both draws keep it):
//   topology  the flat Topology.loss of corrosion_tpu/sim/topology.py:267
//             edge_payload_drop (called at packed.py:451): byte e*P + q
//             of aligned_u8_bits(k_drop, [E, P]) below one threshold
//             topo_thr = round(loss * 256); k_drop is the broadcast key's
//             second split, used as it is; topo_thr 0 draws nothing and
//             256 or more drops every payload without a draw;
//   fault     the fault plan's loss of corrosion_tpu/sim/faults.py:260
//             fault_wire_effects (faults.py:274-284): byte e*P + q of
//             aligned_u8_bits(fold_in(fold_in(key, seed), 101), [E, P])
//             below the edge's threshold thr[e] (from K9).
// A thread's 32 payloads are bytes e*P + 32k .. +31, the eight u32 words
// from e*P/4 + 8k, each the hash of counter (0, word) — word i of a bits
// draw does not depend on the draw's length.  The counter e*8W + 8k + j
// is a u32: at gapstress (E = 76 800, W = 256) it stays below 1.6e8.
// The thread ANDs sending[src, k] with each live stream's 32-bit keep
// mask (byte >= threshold) before the atomicOr.  A stream is hashed only
// where it can drop: an edge with fault thr 0 skips the fault stream, a
// zero word skips both; jax draws the whole [E, P] every round, with the
// same result.  Bound in a lossy round: operations — up to E*P/4 hashes
// of ~72 u32 operations each per stream; outside it, K2's bytes.
//
// With the flight recorder on, K10 also counts the frames the wire ate
// (corrosion_tpu/sim/packed.py:573-581: popcount of drop & sending on ok
// edges, both streams): each thread counts the bits its keep masks
// cleared, the block sums them in shared memory and adds once to the
// int64 `dropped` accumulator.  A null `dropped` (telemetry off) skips
// the count; the scatter is the same either way.

#include <cstdint>
#include <cuda_runtime.h>

#include "threefry.cuh"

namespace {

// The keep mask of one thread's 32 payloads under one stream: bit 4j + b
// set where byte b of draw word base + j is at least the threshold.
__device__ __forceinline__ uint32_t keep_mask(uint32_t k1, uint32_t k2,
                                              uint32_t base, uint32_t t) {
  uint32_t keep = 0u;
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    corro::Pair h = corro::threefry2x32(k1, k2, 0u, base + j);
    uint32_t word = h.a ^ h.b;
#pragma unroll
    for (int b = 0; b < 4; ++b) {
      if (((word >> (8 * b)) & 0xFFu) >= t) keep |= 1u << (4 * j + b);
    }
  }
  return keep;
}

// One edge word: OR what survives the live streams into the ring and
// return how many of the word's sent bits the streams dropped.
__device__ __forceinline__ uint32_t scatter_word(
    uint32_t* __restrict__ ring, const uint32_t* __restrict__ sending,
    const int32_t* __restrict__ dst, const int32_t* __restrict__ slot,
    const bool* __restrict__ ok, const uint8_t* __restrict__ thr,
    const int64_t* __restrict__ topo_key, const uint32_t* folded, size_t i,
    int n, int d_slots, int w, int fanout, int topo_thr) {
  int e = (int)(i / w);
  int k = (int)(i % w);
  if (!ok[e]) return 0u;
  uint32_t sent = sending[(size_t)(e / fanout) * w + k];
  if (sent == 0u) return 0u;
  if (topo_thr >= 256) return __popc(sent);  // a severed channel
  uint32_t v = sent;
  uint32_t base = (uint32_t)e * (8u * (uint32_t)w) + 8u * (uint32_t)k;
  if (topo_thr > 0) {
    v &= keep_mask((uint32_t)topo_key[0], (uint32_t)topo_key[1], base,
                   (uint32_t)topo_thr);
  }
  uint32_t t = thr != nullptr ? thr[e] : 0u;
  if (t != 0u && v != 0u) v &= keep_mask(folded[0], folded[1], base, t);
  if (v != 0u) {
    int row = dst[e];
    int s = slot[e];
    // jnp scatters drop out-of-range updates; so does this one
    if (row >= 0 && row < n && s >= 0 && s < d_slots)
      atomicOr(&ring[((size_t)s * n + row) * w + k], v);
  }
  return __popc(sent & ~v);
}

// One body for both entry points: K2 passes null `thr`, `key`,
// `topo_key` and `dropped` and draws nothing; K10 passes the streams it
// has, and `dropped` when the flight recorder counts.
__global__ void broadcast_scatter_kernel(
    uint32_t* __restrict__ ring, const uint32_t* __restrict__ sending,
    const int32_t* __restrict__ dst, const int32_t* __restrict__ slot,
    const bool* __restrict__ ok, const uint8_t* __restrict__ thr,
    const int64_t* __restrict__ key, const int64_t* __restrict__ topo_key,
    unsigned long long* __restrict__ dropped, int n, int d_slots, int w,
    int fanout, int n_edges, uint32_t seed, uint32_t tag, int topo_thr) {
  __shared__ uint32_t folded[2];
  __shared__ unsigned long long lost_block;
  if (thr != nullptr) {
    if (threadIdx.x == 0) {
      corro::Pair f = corro::threefry2x32((uint32_t)key[0],
                                          (uint32_t)key[1], 0u, seed);
      corro::Pair g = corro::threefry2x32(f.a, f.b, 0u, tag);
      folded[0] = g.a;
      folded[1] = g.b;
    }
    __syncthreads();
  }
  size_t i = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  uint32_t lost = 0u;
  if (i < (size_t)n_edges * w)
    lost = scatter_word(ring, sending, dst, slot, ok, thr, topo_key, folded,
                        i, n, d_slots, w, fanout, topo_thr);
  if (dropped == nullptr) return;
  if (threadIdx.x == 0) lost_block = 0ull;
  __syncthreads();
#pragma unroll
  for (int d = 16; d > 0; d >>= 1) lost += __shfl_xor_sync(0xFFFFFFFFu, lost, d);
  if ((threadIdx.x & 31) == 0 && lost)
    atomicAdd(&lost_block, (unsigned long long)lost);
  __syncthreads();
  if (threadIdx.x == 0 && lost_block) atomicAdd(dropped, lost_block);
}

}  // namespace

extern "C" int corro_broadcast_scatter(void* ring, const void* sending,
                                       const void* dst, const void* slot,
                                       const void* ok, int n, int d_slots,
                                       int w, int fanout, void* stream) {
  if (n <= 0 || w <= 0 || fanout <= 0) return (int)cudaErrorInvalidValue;
  int n_edges = n * fanout;
  size_t total = (size_t)n_edges * w;
  int threads = 256;
  unsigned blocks = (unsigned)((total + threads - 1) / threads);
  broadcast_scatter_kernel<<<blocks, threads, 0, (cudaStream_t)stream>>>(
      (uint32_t*)ring, (const uint32_t*)sending, (const int32_t*)dst,
      (const int32_t*)slot, (const bool*)ok, nullptr, nullptr, nullptr,
      nullptr, n, d_slots, w, fanout, n_edges, 0u, 0u, 0);
  return (int)cudaGetLastError();
}

// `thr` and `key` are null without fault loss, `topo_key` is null when
// topo_thr is 0 (no topology loss), `dropped` is null when nothing counts
// the lost frames.
extern "C" int corro_broadcast_scatter_lossy(
    void* ring, const void* sending, const void* dst, const void* slot,
    const void* ok, const void* thr, const void* key, const void* topo_key,
    void* dropped, int n, int d_slots, int w, int fanout, int seed, int tag,
    int topo_thr, void* stream) {
  if (n <= 0 || w <= 0 || fanout <= 0 || topo_thr < 0 ||
      (thr == nullptr) != (key == nullptr) ||
      (topo_thr > 0 && topo_thr < 256 && topo_key == nullptr))
    return (int)cudaErrorInvalidValue;
  int n_edges = n * fanout;
  // the draw's word index e*8w + 8k + j is a u32 counter
  if ((unsigned long long)n_edges * 8ull * (unsigned long long)w >=
      (1ull << 32))
    return (int)cudaErrorInvalidValue;
  size_t total = (size_t)n_edges * w;
  int threads = 256;
  unsigned blocks = (unsigned)((total + threads - 1) / threads);
  broadcast_scatter_kernel<<<blocks, threads, 0, (cudaStream_t)stream>>>(
      (uint32_t*)ring, (const uint32_t*)sending, (const int32_t*)dst,
      (const int32_t*)slot, (const bool*)ok, (const uint8_t*)thr,
      (const int64_t*)key, (const int64_t*)topo_key,
      (unsigned long long*)dropped, n, d_slots, w, fanout, n_edges, (uint32_t)seed, (uint32_t)tag, topo_thr);
  return (int)cudaGetLastError();
}
