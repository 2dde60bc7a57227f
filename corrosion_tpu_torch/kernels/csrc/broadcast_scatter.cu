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
// K10, the second entry point, runs the same kernel with the fault
// plan's per-(edge, payload) wire loss drawn in the kernel (the loss
// bits of corrosion_tpu/sim/faults.py:260 fault_wire_effects,
// faults.py:274-284): payload q of edge e is dropped when byte
// e*P + q of aligned_u8_bits(fold_in(fold_in(key, seed), 101), [E, P])
// is below the edge's threshold thr[e] (from K9).  A thread's 32
// payloads are bytes e*P + 32k .. +31, the eight u32 words from
// e*P/4 + 8k, each the hash of counter (0, word) — word i of a bits draw
// does not depend on the draw's length.  The thread ANDs sending[src, k]
// with the 32-bit keep mask (byte >= thr) before the atomicOr.  An edge
// with thr 0 draws nothing (no u8 is below 0), and neither does a zero
// word; jax draws the whole [E, P] every round, with the same result.
// Bound in the loss window: operations — E*P/4 hashes of ~72 u32
// operations each; outside it, K2's bytes.

#include <cstdint>
#include <cuda_runtime.h>

#include "threefry.cuh"

namespace {

// One body for both entry points: K2 passes a null `thr` and `key` and
// draws nothing.
__global__ void broadcast_scatter_kernel(
    uint32_t* __restrict__ ring, const uint32_t* __restrict__ sending,
    const int32_t* __restrict__ dst, const int32_t* __restrict__ slot,
    const bool* __restrict__ ok, const uint8_t* __restrict__ thr,
    const int64_t* __restrict__ key, int n, int d_slots, int w, int fanout,
    int n_edges, uint32_t seed, uint32_t tag) {
  __shared__ uint32_t folded[2];
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
  if (i >= (size_t)n_edges * w) return;
  int e = (int)(i / w);
  int k = (int)(i % w);
  if (!ok[e]) return;
  uint32_t v = sending[(size_t)(e / fanout) * w + k];
  if (v == 0u) return;
  uint32_t t = thr != nullptr ? thr[e] : 0u;
  if (t != 0u) {
    uint32_t base = (uint32_t)e * (8u * (uint32_t)w) + 8u * (uint32_t)k;
    uint32_t keep = 0u;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      corro::Pair h = corro::threefry2x32(folded[0], folded[1], 0u, base + j);
      uint32_t word = h.a ^ h.b;
#pragma unroll
      for (int b = 0; b < 4; ++b) {
        if (((word >> (8 * b)) & 0xFFu) >= t) keep |= 1u << (4 * j + b);
      }
    }
    v &= keep;
    if (v == 0u) return;
  }
  int row = dst[e];
  int s = slot[e];
  // jnp scatters drop out-of-range updates; so does this one
  if (row < 0 || row >= n || s < 0 || s >= d_slots) return;
  atomicOr(&ring[((size_t)s * n + row) * w + k], v);
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
      (const int32_t*)slot, (const bool*)ok, nullptr, nullptr, n, d_slots, w,
      fanout, n_edges, 0u, 0u);
  return (int)cudaGetLastError();
}

extern "C" int corro_broadcast_scatter_lossy(
    void* ring, const void* sending, const void* dst, const void* slot,
    const void* ok, const void* thr, const void* key, int n, int d_slots,
    int w, int fanout, int seed, int tag, void* stream) {
  if (n <= 0 || w <= 0 || fanout <= 0) return (int)cudaErrorInvalidValue;
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
      (const int64_t*)key, n, d_slots, w, fanout, n_edges, (uint32_t)seed,
      (uint32_t)tag);
  return (int)cudaGetLastError();
}
