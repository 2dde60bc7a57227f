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

#include <cstdint>
#include <cuda_runtime.h>

namespace {

__global__ void broadcast_scatter_kernel(uint32_t* __restrict__ ring,
                                         const uint32_t* __restrict__ sending,
                                         const int32_t* __restrict__ dst,
                                         const int32_t* __restrict__ slot,
                                         const bool* __restrict__ ok, int n,
                                         int d_slots, int w, int fanout,
                                         int n_edges) {
  size_t i = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= (size_t)n_edges * w) return;
  int e = (int)(i / w);
  int k = (int)(i % w);
  if (!ok[e]) return;
  uint32_t v = sending[(size_t)(e / fanout) * w + k];
  if (v == 0u) return;
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
      (const int32_t*)slot, (const bool*)ok, n, d_slots, w, fanout, n_edges);
  return (int)cudaGetLastError();
}
