// K12: the dense round's broadcast phases on JAX's u8 state — inject,
// broadcast and deliver.
//
// Replaces corrosion_tpu/sim/broadcast.py:32 broadcast_step (the
// eligible mask, the byte budget, the flat loss and the ring scatter of
// broadcast.py:158-185, the relay spend of :224-228; with the budget of
// state.py:498 budget_prefix_mask and the flat draw of topology.py:267
// edge_payload_drop), broadcast.py:335 deliver_step and :374
// inject_step.  The plain versions are sim/broadcast.py
// inject_dense_plain, broadcast_send_plain and deliver_dense_plain;
// they update their arguments in place too.  The target draw, ring0
// tiering and the edge list (dst, slot, ok per edge) stay outside.
//
// Three entry points:
//   inject     one thread per payload q injected at round t by an up
//              writer: have[actor, q] = 1, the relay budget armed to
//              max_transmissions where it was new, injected[q] = 1.
//              Every payload owns its own (row, column) cell.
//   broadcast  one warp per sending row n, the payloads 32 at a time:
//              eligible = have & relay > 0 & injected; the oldest-first
//              byte budget as a warp inclusive scan of the eligible sizes
//              with an int64 running sum (exact, as JAX's i32 cumsum and
//              its two-lane form are for sizes <= 64 KiB), sending =
//              eligible & prefix <= budget (budget < 0: unmetered); for
//              each of the row's F edges that is ok, payload q is lost
//              where byte e*P + q of aligned_u8_bits(key, [E, P]) is below
//              thr (thr 0: never, 256: always); otherwise the thread
//              stores 1 into ring[slot[e], dst[e], q].  The ring holds
//              only 0 and 1, so JAX's row scatter-max is an idempotent
//              store and concurrent edges need no atomics.  Where the row
//              attempted a send (up, a target neither -1 nor itself) the
//              relay budget of each sent payload drops by one.
//   deliver    one thread per cell: slot t % D of the broadcast ring
//              arrives, a new arrival arms the relay budget to
//              max(max_transmissions - 1, 1), have takes the max of
//              itself, the arrival and the sync ring's slot; both slots
//              are cleared.
//
// The loss draw: under jax's partitionable threefry word i of a bits
// draw is the hash of counter (0, i) whatever the draw's length, so
// byte e*P + q is byte (e*P + q) % 4 of the hash of word (e*P + q) / 4
// (little-endian, as aligned_u8_bits unpacks), and only cells that send
// under a threshold hash anything; jax draws the whole [E, P] mask with
// the same result.
//
// With the flight recorder on, the broadcast entry also writes each
// row's transmitted frames and bytes (corrosion_tpu/sim/fused.py:225
// dense_send_stats: the count and the byte total of its sending
// payloads, i32 [N], which K18 folds over the ok edges) and adds the
// frames the loss ate on ok edges to an int64 accumulator `dropped`
// (broadcast.py:259-281) — per-lane counts, one warp sum, one add a row.
// Null pointers (telemetry off) skip all of it.
//
// Bound on the H100: bytes outside loss — have and relay read, relay
// written where sent, the ring bytes stored, deliver's have, relay and
// two slots; with loss, the hashes of the sending cells (~72 u32
// operations each).  Design: warp rows read have/relay/injected/nbytes
// coalesced; the scan is five shuffles of an int64; a lane does its
// cell's F edges itself, so a row's sends are one 32-byte segment per
// edge and chunk.

#include <cstdint>
#include <cuda_runtime.h>

#include "threefry.cuh"

namespace {

constexpr int kWarp = 32;

__global__ void dense_inject_kernel(const int32_t* __restrict__ round_of,
                                    const int32_t* __restrict__ actor,
                                    const uint8_t* __restrict__ alive,
                                    uint8_t* __restrict__ have,
                                    uint8_t* __restrict__ relay,
                                    uint8_t* __restrict__ injected, int n,
                                    int p, int t, int max_tx) {
  int q = blockIdx.x * blockDim.x + threadIdx.x;
  if (q >= p || round_of[q] != t) return;
  int a = actor[q];
  if (a < 0 || a >= n || alive[a] != 0) return;
  size_t i = (size_t)a * p + q;
  if (have[i] == 0) {
    relay[i] = (uint8_t)max_tx;
    have[i] = 1;
  }
  injected[q] = 1;
}

__device__ __forceinline__ long long warp_inclusive_scan(long long v,
                                                         int lane) {
#pragma unroll
  for (int d = 1; d < kWarp; d <<= 1) {
    long long up = __shfl_up_sync(0xFFFFFFFFu, v, d);
    if (lane >= d) v += up;
  }
  return v;
}

__device__ __forceinline__ long long warp_sum(long long v) {
#pragma unroll
  for (int d = kWarp / 2; d > 0; d >>= 1) v += __shfl_xor_sync(0xFFFFFFFFu, v, d);
  return v;
}

__global__ void dense_broadcast_kernel(
    const uint8_t* __restrict__ have, uint8_t* __restrict__ relay,
    const uint8_t* __restrict__ injected, const int32_t* __restrict__ nbytes,
    const int32_t* __restrict__ targets, const int32_t* __restrict__ dst,
    const int32_t* __restrict__ slot, const bool* __restrict__ ok,
    const uint8_t* __restrict__ alive, const int64_t* __restrict__ key,
    uint8_t* __restrict__ ring, int32_t* __restrict__ row_frames,
    int32_t* __restrict__ row_bytes, unsigned long long* __restrict__ dropped,
    int n, int p, int f, int d_slots, int budget, int thr) {
  int row = (int)(((size_t)blockIdx.x * blockDim.x + threadIdx.x) / kWarp);
  int lane = threadIdx.x & (kWarp - 1);
  if (row >= n) return;  // whole warps leave together
  bool attempt = false;
  for (int j = lane; j < f; j += kWarp) {
    int tg = targets[(size_t)row * f + j];
    attempt |= tg >= 0 && tg != row;
  }
  bool any_attempt = __any_sync(0xFFFFFFFFu, attempt) && alive[row] == 0;
  uint32_t k1 = 0u, k2 = 0u;
  if (thr > 0 && thr < 256) {
    k1 = (uint32_t)key[0];
    k2 = (uint32_t)key[1];
  }
  long long running = 0;
  long long sent_frames = 0, sent_bytes = 0, lost_frames = 0;
  for (int base = 0; base < p; base += kWarp) {
    int q = base + lane;
    size_t cell = (size_t)row * p + q;
    bool elig = q < p && have[cell] && relay[cell] && injected[q];
    bool sending = elig;
    if (budget >= 0) {
      long long size = elig ? (long long)nbytes[q] : 0;
      long long cum = running + warp_inclusive_scan(size, lane);
      sending = elig && cum <= (long long)budget;
      running = __shfl_sync(0xFFFFFFFFu, cum, kWarp - 1);
    }
    if (!sending) continue;
    sent_frames += 1;
    sent_bytes += nbytes[q];
    for (int j = 0; j < f; ++j) {
      size_t e = (size_t)row * f + j;
      if (!ok[e]) continue;
      bool lost = thr >= 256;
      if (thr > 0 && thr < 256) {
        uint32_t b = (uint32_t)(e * p + q);
        corro::Pair h = corro::threefry2x32(k1, k2, 0u, b >> 2);
        uint32_t byte = ((h.a ^ h.b) >> (8u * (b & 3u))) & 0xFFu;
        lost = byte < (uint32_t)thr;
      }
      if (lost) {
        lost_frames += 1;
        continue;
      }
      int r = dst[e];
      int s = slot[e];
      // jnp scatters drop out-of-range updates; so does this one
      if (r < 0 || r >= n || s < 0 || s >= d_slots) continue;
      ring[((size_t)s * n + r) * p + q] = 1;
    }
    if (any_attempt) relay[cell] -= 1;
  }
  if (row_frames != nullptr) {
    sent_frames = warp_sum(sent_frames);
    sent_bytes = warp_sum(sent_bytes);
    if (lane == 0) {
      row_frames[row] = (int32_t)sent_frames;
      row_bytes[row] = (int32_t)sent_bytes;
    }
  }
  if (dropped != nullptr) {
    lost_frames = warp_sum(lost_frames);
    if (lane == 0 && lost_frames)
      atomicAdd(dropped, (unsigned long long)lost_frames);
  }
}

__global__ void dense_deliver_kernel(uint8_t* __restrict__ ring,
                                     uint8_t* __restrict__ sync_ring,
                                     uint8_t* __restrict__ have,
                                     uint8_t* __restrict__ relay,
                                     size_t cells, int slot, int relay_init) {
  size_t i = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= cells) return;
  size_t at = (size_t)slot * cells + i;
  uint8_t arriving = ring[at];
  uint8_t pulled = sync_ring[at];
  if ((arriving | pulled) == 0) return;
  uint8_t h = have[i];
  if (arriving > 0 && h == 0) relay[i] = (uint8_t)relay_init;
  uint8_t m = h > arriving ? h : arriving;
  have[i] = m > pulled ? m : pulled;
  ring[at] = 0;
  sync_ring[at] = 0;
}

unsigned blocks_for(size_t threads_needed, int threads) {
  return (unsigned)((threads_needed + threads - 1) / threads);
}

}  // namespace

extern "C" int corro_dense_inject(const void* round_of, const void* actor,
                                  const void* alive, void* have, void* relay,
                                  void* injected, int n, int p, int t,
                                  int max_tx, void* stream) {
  if (n <= 0 || p <= 0) return (int)cudaErrorInvalidValue;
  dense_inject_kernel<<<blocks_for(p, 256), 256, 0, (cudaStream_t)stream>>>(
      (const int32_t*)round_of, (const int32_t*)actor, (const uint8_t*)alive,
      (uint8_t*)have, (uint8_t*)relay, (uint8_t*)injected, n, p, t, max_tx);
  return (int)cudaGetLastError();
}

extern "C" int corro_dense_broadcast(
    const void* have, void* relay, const void* injected, const void* nbytes,
    const void* targets, const void* dst, const void* slot, const void* ok,
    const void* alive, const void* key, void* ring, void* row_frames,
    void* row_bytes, void* dropped, int n, int p, int f, int d_slots,
    int budget, int thr, void* stream) {
  if (n <= 0 || p <= 0 || f <= 0 || d_slots <= 0 || thr < 0 || thr > 256 ||
      (row_frames == nullptr) != (row_bytes == nullptr))
    return (int)cudaErrorInvalidValue;
  // the draw's byte index e*P + q is a u32 counter (times 4)
  if ((unsigned long long)n * f * p >= (1ull << 32))
    return (int)cudaErrorInvalidValue;
  int threads = 256;
  dense_broadcast_kernel<<<blocks_for((size_t)n * kWarp, threads), threads, 0,
                           (cudaStream_t)stream>>>(
      (const uint8_t*)have, (uint8_t*)relay, (const uint8_t*)injected,
      (const int32_t*)nbytes, (const int32_t*)targets, (const int32_t*)dst,
      (const int32_t*)slot, (const bool*)ok, (const uint8_t*)alive,
      (const int64_t*)key, (uint8_t*)ring, (int32_t*)row_frames,
      (int32_t*)row_bytes, (unsigned long long*)dropped, n, p, f, d_slots,
      budget, thr);
  return (int)cudaGetLastError();
}

extern "C" int corro_dense_deliver(void* ring, void* sync_ring, void* have,
                                   void* relay, int n, int p, int slot,
                                   int relay_init, void* stream) {
  if (n <= 0 || p <= 0 || slot < 0) return (int)cudaErrorInvalidValue;
  size_t cells = (size_t)n * p;
  dense_deliver_kernel<<<blocks_for(cells, 256), 256, 0,
                         (cudaStream_t)stream>>>(
      (uint8_t*)ring, (uint8_t*)sync_ring, (uint8_t*)have, (uint8_t*)relay,
      cells, slot, relay_init);
  return (int)cudaGetLastError();
}
