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
// The fault entry (corro_dense_broadcast_fault, a second instantiation
// of the broadcast kernel, so the plain entry keeps its registers) adds
// the fault plan's per-(edge, payload) draws of broadcast.py:124-185,
// corrosion_tpu/sim/faults.py:260 fault_wire_effects (its cuts are
// already out of `ok` and its fixed delay in `slot`, both from K9):
//   loss    payload q of edge e is also lost where byte e*P + q of
//           aligned_u8_bits(fold_in(fold_in(phase_key, seed), 101), [E, P])
//           is below the edge's threshold fthr[e] — the phase key, not
//           the topology stream's k_drop; the two drops OR, so a payload
//           the topology already lost draws nothing more;
//   jitter  a surviving payload of an edge with jit[e] > 0 lands in slot
//           (slot[e] + j) % D, j = element e*P + q of randint(fold_in(
//           fold_in(phase_key, seed), 102), [E, P], 0, 2^31 - 1) mod
//           (jit[e] + 1) (broadcast.py:166-179); at that span randint's
//           u32 multiplier wraps to 0 and its `higher` hash drops out
//           (corro::randint_at).
// The ring still holds 0/1, so each cell is an idempotent store of 1
// and the per-payload slots need no atomics.  The block folds the two
// keys once, in shared memory.  Bound in a lossy or jittered round:
// operations — one hash per ok (edge, sending payload) under a fault
// threshold, and one per surviving payload of a jittered edge.
//
// With the flight recorder on, the broadcast entry also writes each
// row's transmitted frames and bytes (corrosion_tpu/sim/fused.py:225
// dense_send_stats: the count and the byte total of its sending
// payloads, i32 [N], which K18 folds over the ok edges) and adds the
// frames the loss ate on ok edges (either stream) to an int64
// accumulator `dropped` (broadcast.py:259-281) — per-lane counts, one
// warp sum, one add a row.
// Null pointers (telemetry off) skip all of it.
//
// Bound on the H100: bytes outside loss — have and relay read, relay
// written where sent, the ring bytes stored, deliver's have, relay and
// two slots; with loss, the hashes of the sending cells (~72 u32
// operations each).  Design: warp rows read have/relay/injected/nbytes
// coalesced; the scan is five shuffles of an int64; a lane does its
// cell's F edges itself, so a row's sends are one 32-byte segment per
// edge and chunk.
//
// The tiered instantiation (corro_dense_broadcast_tiered, counted as
// dense_broadcast_tiered) takes a geo-tiered topology's loss,
// corrosion_tpu/sim/topology.py:240 tiered_edge_drop (through :267
// edge_payload_drop's tiered branch, called at broadcast.py:120 with
// src/dst/region): the same byte e*P + q of aligned_u8_bits(key, [E, P])
// as the flat draw, compared against the edge's raw tier threshold
// (topo_tiers.cuh, from the row and dst[e]) instead of the scalar thr;
// an edge at certainty (raw >= 256) loses every payload without a draw.
// With a fault plan's loss or jitter it draws them as the fault entry
// does.  Bound: operations in a lossy round — one hash per ok (edge,
// sending payload) on an edge of a lossy tier.

// K12p, the dense pull (corro_dense_pull; counted as dense_pull,
// dense_pull_lossy and dense_pull_tiered), is the response leg of
// push-pull dissemination on the u8 ring: corrosion_tpu/sim/broadcast.py:
// 187-216 with corrosion_tpu/proto/dissemination.py:43 pull_session_ok and
// :58 pull_wire_drop.  One warp per edge e = (src = e / F, dst[e]) with
// ok_pull[e]: it recomputes the responder's sending row — eligible = have
// & relay > 0 & injected, the oldest-first budget prefix, exactly the
// broadcast entry's scan — and stores 1 into ring[slot[e], src, q] for
// every sending payload q that survives the pull's streams: byte e*P + q
// of aligned_u8_bits(k_pull, [E, P]) (k_pull = fold_in(k_drop, 1)) below
// the flat threshold or the tier threshold of (dst[e], src), and byte
// e*P + q of aligned_u8_bits(fold_in(fold_in(k_pull, seed), 101), [E, P])
// below the reverse edge's fault threshold fthr[e].  The wrapper launches
// it BEFORE the broadcast entry, whose relay spend it must not see
// (responses spend no budget: only the push does).  Slot: the push's
// fixed-delay slot, never jitter.  Under a recording run it adds the
// frames the streams ate to `dropped`.  Bound: bytes — each edge re-reads
// its responder's have, relay and nbytes rows (F times the broadcast's
// row reads) and stores the surviving cells; inside loss, one hash per
// sending cell under a threshold.
//
// K12f-o, the FIFO deliver (corro_dense_deliver_fifo, counted as
// dense_deliver_fifo): corrosion_tpu/sim/broadcast.py:346-360 with
// corrosion_tpu/proto/ordering.py:55 admit_payload_mask.  One block per
// row copies the row's have into shared memory BEFORE any write, then
// each cell q is admitted iff its group lies in the first wave (q < A*C)
// or every chunk of the group one wave earlier (same origin, version -
// 1) is held; both rings' slot t arrive only where admitted, the merge
// and the relay re-arm follow the deliver entry, and both slots are
// cleared whole.  Bound: bytes, the deliver entry's plus one row read.

// The lane entries (corro_dense_inject_lanes, _broadcast_lanes,
// _deliver_lanes) run inject, broadcast and deliver over a seed
// ensemble's lanes (B16, dense half: corrosion_tpu/campaign/ensemble.py:114
// and :187 vmap the dense round) as a grid dimension: blockIdx.y is the
// lane, whose have, relay, injected, alive, targets, edge lists (dst,
// slot, ok), flat-loss key and ring slices are its slots of the [K, ...]
// tensors, offset in 64 bits; node ids, edge ids and the draw counter
// e*P + q stay lane-local, so lane k is the solo entry on lane k's
// inputs.  The budget scan runs per row, so it is lane-local too.  The
// payload metadata (round, actor, nbytes) and the round t are shared.
// The broadcast lane entry takes no fault, tiered or recorder outputs.
// Bound: K times the solo bound.

#include <cstdint>
#include <cuda_runtime.h>

#include "threefry.cuh"
#include "topo_tiers.cuh"

namespace {

constexpr int kWarp = 32;

__global__ void dense_inject_kernel(const int32_t* __restrict__ round_of,
                                    const int32_t* __restrict__ actor,
                                    const uint8_t* __restrict__ alive,
                                    uint8_t* __restrict__ have,
                                    uint8_t* __restrict__ relay,
                                    uint8_t* __restrict__ injected, int n,
                                    int p, int t, int max_tx) {
  // the lane's slices (lane 0 on the solo entry)
  const size_t lane = blockIdx.y;
  alive += lane * n;
  have += lane * (size_t)n * p;
  relay += lane * (size_t)n * p;
  injected += lane * p;
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

// Byte b of aligned_u8_bits(key, ·): byte b % 4 of the hash of word b / 4.
__device__ __forceinline__ uint32_t draw_byte(uint32_t k1, uint32_t k2,
                                              uint32_t b) {
  corro::Pair h = corro::threefry2x32(k1, k2, 0u, b >> 2);
  return ((h.a ^ h.b) >> (8u * (b & 3u))) & 0xFFu;
}

// The fault entry's draws (null thr and jit: the plain entry, which
// draws neither): the plan's u8 loss thresholds and jitter bounds per
// edge, the folded loss key and randint's subkeys of the jitter key.
struct FaultDraws {
  const uint8_t* thr;
  const int32_t* jit;
  uint32_t loss[2];
  uint32_t sub[4];
  uint32_t span, mult;
};

template <bool kFault, bool kTiered>
__global__ void dense_broadcast_kernel(
    const uint8_t* __restrict__ have, uint8_t* __restrict__ relay,
    const uint8_t* __restrict__ injected, const int32_t* __restrict__ nbytes,
    const int32_t* __restrict__ targets, const int32_t* __restrict__ dst,
    const int32_t* __restrict__ slot, const bool* __restrict__ ok,
    const uint8_t* __restrict__ alive, const int64_t* __restrict__ key,
    uint8_t* __restrict__ ring, int32_t* __restrict__ row_frames,
    int32_t* __restrict__ row_bytes, unsigned long long* __restrict__ dropped,
    const int64_t* __restrict__ phase_key, const uint8_t* __restrict__ fthr,
    const int32_t* __restrict__ jit, const int32_t* __restrict__ tiers,
    int n, int p, int f, int d_slots, int budget, int thr, uint32_t seed,
    uint32_t loss_tag, uint32_t jit_tag, uint32_t span, uint32_t mult) {
  {
    // the lane's slices (lane 0 on the solo entry; the lane entry
    // passes no fault, tiered or recorder pointers)
    const size_t lane = blockIdx.y;
    const size_t cells = (size_t)n * p, edges = (size_t)n * f;
    have += lane * cells;
    relay += lane * cells;
    injected += lane * p;
    targets += lane * edges;
    dst += lane * edges;
    slot += lane * edges;
    ok += lane * edges;
    alive += lane * n;
    key += lane * 2;
    ring += lane * (size_t)d_slots * cells;
  }
  FaultDraws fd{fthr, jit, {0u, 0u}, {0u, 0u, 0u, 0u}, span, mult};
  if (kFault) {
    // fold_in(fold_in(phase_key, seed), tag) once a block
    __shared__ uint32_t keys[6];
    if (threadIdx.x == 0) {
      corro::Pair folded = corro::fold_in(
          corro::Pair{(uint32_t)phase_key[0], (uint32_t)phase_key[1]}, seed);
      corro::Pair lk = corro::fold_in(folded, loss_tag);
      keys[0] = lk.a;
      keys[1] = lk.b;
      corro::randint_subkeys(corro::fold_in(folded, jit_tag), keys + 2);
    }
    __syncthreads();
    fd.loss[0] = keys[0];
    fd.loss[1] = keys[1];
#pragma unroll
    for (int i = 0; i < 4; ++i) fd.sub[i] = keys[2 + i];
  }
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
  if (kTiered || (thr > 0 && thr < 256)) {
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
      // byte (and i32 element) e*P + q of the [E, P] draws
      uint32_t b = (uint32_t)(e * p + q);
      // the edge's tier threshold replaces the scalar one
      int tthr = kTiered ? corro::topo_loss_raw(tiers, row, dst[e]) : thr;
      bool lost = tthr >= 256;
      if (tthr > 0 && tthr < 256) lost = draw_byte(k1, k2, b) < (uint32_t)tthr;
      if (kFault && !lost && fd.thr != nullptr) {
        uint32_t t = fd.thr[e];
        lost = t != 0u && draw_byte(fd.loss[0], fd.loss[1], b) < t;
      }
      if (lost) {
        lost_frames += 1;
        continue;
      }
      int r = dst[e];
      int s = slot[e];
      // jnp scatters drop out-of-range updates; so does this one
      if (r < 0 || r >= n || s < 0 || s >= d_slots) continue;
      if (kFault && fd.jit != nullptr) {
        int jb = fd.jit[e];
        if (jb > 0) {
          uint32_t off = corro::randint_at(fd.sub, fd.span, fd.mult, b);
          s = (int)(((uint32_t)s + off % (uint32_t)(jb + 1)) %
                    (uint32_t)d_slots);
        }
      }
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
                                     size_t cells, int slot, int relay_init,
                                     int d_slots) {
  // the lane's slices (lane 0 on the solo entry)
  const size_t lane = blockIdx.y;
  ring += lane * (size_t)d_slots * cells;
  sync_ring += lane * (size_t)d_slots * cells;
  have += lane * cells;
  relay += lane * cells;
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

// K12p: one warp per pull edge (see the header).
template <bool kTiered>
__global__ void dense_pull_kernel(
    const uint8_t* __restrict__ have, const uint8_t* __restrict__ relay,
    const uint8_t* __restrict__ injected, const int32_t* __restrict__ nbytes,
    const int32_t* __restrict__ dst, const int32_t* __restrict__ slot,
    const bool* __restrict__ ok_pull, const int64_t* __restrict__ k_drop,
    uint8_t* __restrict__ ring, unsigned long long* __restrict__ dropped,
    const uint8_t* __restrict__ fthr, const int32_t* __restrict__ tiers,
    int n, int p, int f, int d_slots, int budget, int thr, uint32_t seed,
    uint32_t loss_tag) {
  __shared__ uint32_t keys[4];
  if (k_drop != nullptr) {
    if (threadIdx.x == 0) {
      corro::Pair pk = corro::fold_in(
          corro::Pair{(uint32_t)k_drop[0], (uint32_t)k_drop[1]}, 1u);
      keys[0] = pk.a;
      keys[1] = pk.b;
      corro::Pair fk = corro::fold_in(corro::fold_in(pk, seed), loss_tag);
      keys[2] = fk.a;
      keys[3] = fk.b;
    }
    __syncthreads();
  }
  size_t e = ((size_t)blockIdx.x * blockDim.x + threadIdx.x) / kWarp;
  int lane = threadIdx.x & (kWarp - 1);
  if (e >= (size_t)n * f || !ok_pull[e]) return;  // whole warps leave
  int row = (int)(e / f);
  int x = dst[e];
  int s = slot[e];
  if (x < 0 || x >= n) return;
  bool in_ring = row >= 0 && row < n && s >= 0 && s < d_slots;
  int tthr = kTiered ? corro::topo_loss_raw(tiers, x, row) : thr;
  uint32_t ft = fthr != nullptr ? fthr[e] : 0u;
  long long running = 0, lost_frames = 0;
  for (int base = 0; base < p; base += kWarp) {
    int q = base + lane;
    size_t cell = (size_t)x * p + q;
    bool elig = q < p && have[cell] && relay[cell] && injected[q];
    bool sending = elig;
    if (budget >= 0) {
      long long size = elig ? (long long)nbytes[q] : 0;
      long long cum = running + warp_inclusive_scan(size, lane);
      sending = elig && cum <= (long long)budget;
      running = __shfl_sync(0xFFFFFFFFu, cum, kWarp - 1);
    }
    if (!sending) continue;
    uint32_t b = (uint32_t)(e * p + q);
    bool lost = tthr >= 256;
    if (tthr > 0 && tthr < 256)
      lost = draw_byte(keys[0], keys[1], b) < (uint32_t)tthr;
    if (!lost && ft != 0u) lost = draw_byte(keys[2], keys[3], b) < ft;
    if (lost) {
      lost_frames += 1;
      continue;
    }
    if (in_ring) ring[((size_t)s * n + row) * p + q] = 1;
  }
  if (dropped != nullptr) {
    lost_frames = warp_sum(lost_frames);
    if (lane == 0 && lost_frames)
      atomicAdd(dropped, (unsigned long long)lost_frames);
  }
}

// K12f-o: one block per row, the row's pre-merge have in shared memory.
__global__ void dense_deliver_fifo_kernel(uint8_t* __restrict__ ring,
                                          uint8_t* __restrict__ sync_ring,
                                          uint8_t* __restrict__ have,
                                          uint8_t* __restrict__ relay, int n,
                                          int p, int slot, int relay_init,
                                          int c, int wave) {
  extern __shared__ uint8_t row_have[];
  int row = blockIdx.x;
  size_t base = (size_t)row * p;
  for (int q = threadIdx.x; q < p; q += blockDim.x) row_have[q] = have[base + q];
  __syncthreads();
  size_t cells = (size_t)n * p;
  for (int q = threadIdx.x; q < p; q += blockDim.x) {
    size_t i = base + q;
    size_t at = (size_t)slot * cells + i;
    uint8_t arriving = ring[at];
    uint8_t pulled = sync_ring[at];
    if ((arriving | pulled) == 0) continue;
    ring[at] = 0;
    sync_ring[at] = 0;
    int first = q - q % c;  // the group's first chunk
    bool admit = first < wave;
    if (!admit) {
      admit = true;
      for (int j = 0; j < c; ++j) admit &= row_have[first - wave + j] != 0;
    }
    if (!admit) continue;
    uint8_t h = row_have[q];
    if (arriving > 0 && h == 0) relay[i] = (uint8_t)relay_init;
    uint8_t m = h > arriving ? h : arriving;
    have[i] = m > pulled ? m : pulled;
  }
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

namespace {

int launch_broadcast(bool fault, const void* have, void* relay,
                     const void* injected, const void* nbytes,
                     const void* targets, const void* dst, const void* slot,
                     const void* ok, const void* alive, const void* key,
                     void* ring, void* row_frames, void* row_bytes,
                     void* dropped, const void* phase_key, const void* fthr,
                     const void* jit, const void* tiers, int n, int p, int f,
                     int d_slots, int budget, int thr, int seed, int loss_tag,
                     int jit_tag, int span, int mult, void* stream,
                     int lanes = 1) {
  bool tiered = tiers != nullptr;
  if (n <= 0 || p <= 0 || f <= 0 || d_slots <= 0 || thr < 0 || thr > 256 ||
      (row_frames == nullptr) != (row_bytes == nullptr) ||
      (tiered && thr != 0) || lanes <= 0 || lanes > 65535)
    return (int)cudaErrorInvalidValue;
  if (fault && (phase_key == nullptr || (fthr == nullptr && jit == nullptr) ||
                (jit != nullptr && span == 0)))
    return (int)cudaErrorInvalidValue;
  // the draws' byte and element index e*P + q is a u32 counter
  if ((unsigned long long)n * f * p >= (1ull << 32))
    return (int)cudaErrorInvalidValue;
  int threads = 256;
  auto kernel = fault ? (tiered ? dense_broadcast_kernel<true, true>
                               : dense_broadcast_kernel<true, false>)
                      : (tiered ? dense_broadcast_kernel<false, true>
                                : dense_broadcast_kernel<false, false>);
  kernel<<<dim3(blocks_for((size_t)n * kWarp, threads), lanes), threads, 0,
           (cudaStream_t)stream>>>(
      (const uint8_t*)have, (uint8_t*)relay, (const uint8_t*)injected,
      (const int32_t*)nbytes, (const int32_t*)targets, (const int32_t*)dst,
      (const int32_t*)slot, (const bool*)ok, (const uint8_t*)alive,
      (const int64_t*)key, (uint8_t*)ring, (int32_t*)row_frames,
      (int32_t*)row_bytes, (unsigned long long*)dropped,
      (const int64_t*)phase_key, (const uint8_t*)fthr, (const int32_t*)jit,
      (const int32_t*)tiers, n, p, f, d_slots, budget, thr, (uint32_t)seed,
      (uint32_t)loss_tag,
      (uint32_t)jit_tag, (uint32_t)span, (uint32_t)mult);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int corro_dense_broadcast(
    const void* have, void* relay, const void* injected, const void* nbytes,
    const void* targets, const void* dst, const void* slot, const void* ok,
    const void* alive, const void* key, void* ring, void* row_frames,
    void* row_bytes, void* dropped, int n, int p, int f, int d_slots,
    int budget, int thr, void* stream) {
  return launch_broadcast(false, have, relay, injected, nbytes, targets, dst,
                          slot, ok, alive, key, ring, row_frames, row_bytes,
                          dropped, nullptr, nullptr, nullptr, nullptr, n, p,
                          f, d_slots, budget, thr, 0, 0, 0, 1, 0, stream);
}

// The fault entry: `phase_key` is the broadcast phase key both fault
// draws fold; `fthr` is null in a round without fault loss and `jit` in
// one without jitter (not both); `span` and `mult` are randint's for the
// jitter draw's bounds [0, 2^31 - 1).
extern "C" int corro_dense_broadcast_fault(
    const void* have, void* relay, const void* injected, const void* nbytes,
    const void* targets, const void* dst, const void* slot, const void* ok,
    const void* alive, const void* key, void* ring, void* row_frames,
    void* row_bytes, void* dropped, const void* phase_key, const void* fthr,
    const void* jit, int n, int p, int f, int d_slots, int budget, int thr,
    int seed, int loss_tag, int jit_tag, int span, int mult, void* stream) {
  return launch_broadcast(true, have, relay, injected, nbytes, targets, dst,
                          slot, ok, alive, key, ring, row_frames, row_bytes,
                          dropped, phase_key, fthr, jit, nullptr, n, p, f,
                          d_slots, budget, thr, seed, loss_tag, jit_tag, span,
                          mult, stream);
}

// The tiered instantiation: the fault entry's arguments (`phase_key`,
// `fthr` and `jit` all null in a round without fault draws) and `tiers`,
// the topology's table; `thr` must be 0 (the tiers replace it).
extern "C" int corro_dense_broadcast_tiered(
    const void* have, void* relay, const void* injected, const void* nbytes,
    const void* targets, const void* dst, const void* slot, const void* ok,
    const void* alive, const void* key, void* ring, void* row_frames,
    void* row_bytes, void* dropped, const void* phase_key, const void* fthr,
    const void* jit, const void* tiers, int n, int p, int f, int d_slots,
    int budget, int thr, int seed, int loss_tag, int jit_tag, int span,
    int mult, void* stream) {
  if (tiers == nullptr) return (int)cudaErrorInvalidValue;
  return launch_broadcast(fthr != nullptr || jit != nullptr, have, relay,
                          injected, nbytes, targets, dst, slot, ok, alive,
                          key, ring, row_frames, row_bytes, dropped,
                          phase_key, fthr, jit, tiers, n, p, f, d_slots,
                          budget, thr, seed, loss_tag, jit_tag, span, mult,
                          stream);
}

extern "C" int corro_dense_deliver(void* ring, void* sync_ring, void* have,
                                   void* relay, int n, int p, int slot,
                                   int relay_init, void* stream) {
  if (n <= 0 || p <= 0 || slot < 0) return (int)cudaErrorInvalidValue;
  size_t cells = (size_t)n * p;
  dense_deliver_kernel<<<blocks_for(cells, 256), 256, 0,
                         (cudaStream_t)stream>>>(
      (uint8_t*)ring, (uint8_t*)sync_ring, (uint8_t*)have, (uint8_t*)relay,
      cells, slot, relay_init, 1);
  return (int)cudaGetLastError();
}

// The lane entries: the solo entries' arguments with every per-node and
// per-edge tensor [lanes, ...], `injected` [lanes, P], `key` [lanes, 2]
// and the rings [lanes, D, N, P], then `lanes`.
extern "C" int corro_dense_inject_lanes(const void* round_of,
                                        const void* actor, const void* alive,
                                        void* have, void* relay,
                                        void* injected, int n, int p, int t,
                                        int max_tx, int lanes,
                                        void* stream) {
  if (n <= 0 || p <= 0 || lanes <= 0 || lanes > 65535)
    return (int)cudaErrorInvalidValue;
  dense_inject_kernel<<<dim3(blocks_for(p, 256), lanes), 256, 0,
                        (cudaStream_t)stream>>>(
      (const int32_t*)round_of, (const int32_t*)actor, (const uint8_t*)alive,
      (uint8_t*)have, (uint8_t*)relay, (uint8_t*)injected, n, p, t, max_tx);
  return (int)cudaGetLastError();
}

extern "C" int corro_dense_broadcast_lanes(
    const void* have, void* relay, const void* injected, const void* nbytes,
    const void* targets, const void* dst, const void* slot, const void* ok,
    const void* alive, const void* key, void* ring, int n, int p, int f,
    int d_slots, int budget, int thr, int lanes, void* stream) {
  return launch_broadcast(false, have, relay, injected, nbytes, targets, dst,
                          slot, ok, alive, key, ring, nullptr, nullptr,
                          nullptr, nullptr, nullptr, nullptr, nullptr, n, p,
                          f, d_slots, budget, thr, 0, 0, 0, 1, 0, stream,
                          lanes);
}

extern "C" int corro_dense_deliver_lanes(void* ring, void* sync_ring,
                                         void* have, void* relay, int n,
                                         int p, int d_slots, int slot,
                                         int relay_init, int lanes,
                                         void* stream) {
  if (n <= 0 || p <= 0 || d_slots <= 0 || slot < 0 || slot >= d_slots ||
      lanes <= 0 || lanes > 65535)
    return (int)cudaErrorInvalidValue;
  size_t cells = (size_t)n * p;
  dense_deliver_kernel<<<dim3(blocks_for(cells, 256), lanes), 256, 0,
                         (cudaStream_t)stream>>>(
      (uint8_t*)ring, (uint8_t*)sync_ring, (uint8_t*)have, (uint8_t*)relay,
      cells, slot, relay_init, d_slots);
  return (int)cudaGetLastError();
}

// K12p, the dense pull: `ok` is ok_pull; `fthr` the reverse edges' fault
// thresholds (null without fault loss); `k_drop` the broadcast key's
// second split (required when a stream draws); `tiers` the topology's
// table under tiered loss (then thr must be 0).  Launch it before the
// broadcast entry: it reads the relay budget before the spend.
extern "C" int corro_dense_pull(
    const void* have, const void* relay, const void* injected,
    const void* nbytes, const void* dst, const void* slot, const void* ok,
    const void* k_drop, void* ring, void* dropped, const void* fthr,
    const void* tiers, int n, int p, int f, int d_slots, int budget, int thr,
    int seed, int loss_tag, void* stream) {
  bool tiered = tiers != nullptr;
  bool draws = fthr != nullptr || tiered || (thr > 0 && thr < 256);
  if (n <= 0 || p <= 0 || f <= 0 || d_slots <= 0 || thr < 0 || thr > 256 ||
      (draws && k_drop == nullptr) || (tiered && thr != 0))
    return (int)cudaErrorInvalidValue;
  if ((unsigned long long)n * f * p >= (1ull << 32))
    return (int)cudaErrorInvalidValue;
  int threads = 256;
  auto kernel = tiered ? dense_pull_kernel<true> : dense_pull_kernel<false>;
  kernel<<<blocks_for((size_t)n * f * kWarp, threads), threads, 0,
           (cudaStream_t)stream>>>(
      (const uint8_t*)have, (const uint8_t*)relay, (const uint8_t*)injected,
      (const int32_t*)nbytes, (const int32_t*)dst, (const int32_t*)slot,
      (const bool*)ok, draws ? (const int64_t*)k_drop : nullptr,
      (uint8_t*)ring, (unsigned long long*)dropped, (const uint8_t*)fthr,
      (const int32_t*)tiers, n, p, f, d_slots, budget, thr, (uint32_t)seed,
      (uint32_t)loss_tag);
  return (int)cudaGetLastError();
}

// K12f-o: the deliver entry behind the FIFO admit gate; `c` is
// chunks_per_version and `wave` = n_writers * c.
extern "C" int corro_dense_deliver_fifo(void* ring, void* sync_ring,
                                        void* have, void* relay, int n, int p,
                                        int slot, int relay_init, int c,
                                        int wave, void* stream) {
  if (n <= 0 || p <= 0 || slot < 0 || c <= 0 || wave < c || wave % c ||
      p % wave || p > 48 * 1024)
    return (int)cudaErrorInvalidValue;
  dense_deliver_fifo_kernel<<<(unsigned)n, 128, (size_t)p,
                              (cudaStream_t)stream>>>(
      (uint8_t*)ring, (uint8_t*)sync_ring, (uint8_t*)have, (uint8_t*)relay,
      n, p, slot, relay_init, c, wave);
  return (int)cudaGetLastError();
}
