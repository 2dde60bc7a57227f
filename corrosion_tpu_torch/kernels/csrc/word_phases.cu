// K8: the round's word phases — inject, the broadcast's relay spend, and
// deliver — updating the have words, the four relay planes and the ring
// slots in place.
//
// Replaces corrosion_tpu/sim/packed.py:336 inject_packed, the sending
// mask and relay spend of packed.py:369 broadcast_packed (planes_set at
// packed.py:195 and planes_dec at :205) and packed.py:631 deliver_packed.
// The plain versions are packed.inject_packed_plain, spend_relay_plain
// and deliver_packed_plain; they update their arguments in place too.
//
// The relay budget is a 4-bit counter per (node, payload), bit-sliced
// over four planes: counter bit j of payload bit b lives in plane j, bit
// b.  Three entry points:
//   inject   one thread per payload q injected at round t by an up
//            writer: atomicOr of its bit into injected_p and into its
//            writer's have row; where the bit was new, each plane's bit
//            is set (atomicOr) or cleared (atomicAnd) to max_transmissions.
//            Every payload owns a distinct (row, word, bit), so the atomic
//            ORs are exact and the old value says whether it was new.
//   spend    one thread per (node, word): sending = have & relay-nonzero &
//            injected_p, written for the ring scatter (K2); where the row
//            attempted a send (an up node with a target that is neither
//            -1 nor itself) the planes count the sent bits down by one
//            (a ripple borrow; sending is inside relay-nonzero, so no
//            counter wraps).  Under the broadcast's byte governor the
//            spend is two launches around K16 (JAX order: eligible,
//            budget, sending, the spend on the attempt): mode 1 writes
//            the eligible words and spends nothing, K16 meters them into
//            the sending words, and mode 2 spends those (a subset of the
//            eligible bits, so still inside relay-nonzero).
//   deliver  one thread per (node, word): the broadcast ring's slot t % D
//            arrives; newly = arriving & ~have re-arms the counters to
//            max(max_transmissions - 1, 1); have |= arriving | the sync
//            ring's slot; both slots are cleared.
//
// Bound on the H100: bytes.  Deliver reads and writes have, the planes
// and both slots (about 90 MB at the storm); spend reads have, the planes
// and targets and writes sending and the planes (about 65 MB); inject
// touches P bits and is bound by its launch.  Design: (node, word)
// threads are coalesced along the words; a word whose update is zero is
// not written back, which skips most plane traffic once budgets drain.

// K8f, the FIFO deliver (corro_word_deliver_fifo, counted as
// word_deliver_fifo), is deliver behind the per-origin FIFO admit gate of
// corrosion_tpu/sim/packed.py:644-653 (corrosion_tpu/proto/ordering.py:65
// admit_words): one warp per node row.  The warp first copies the row's
// have words into shared memory — the gate reads `have` BEFORE the merge,
// and a word's admit bits come from other words of the row — then each
// lane, per word k: the complete-version words comp(j) = the C-bit group
// AND-fold of have word j smeared back over the group (group_grid(have,
// "all")), shifted up by one wave (A * C bits: version v - 1 of the same
// origin sits exactly one wave below v in the version-major layout), the
// first wave's bits set (version 1 has no predecessor); both rings' slot
// words are ANDed with that admit word, then merged and the relay re-armed
// as deliver does, and both slots cleared whole (a rejected arrival is
// dropped).  Bound: bytes, deliver's plus nothing (the row is read once
// into shared memory).
//
// K8f's lane entry (corro_word_deliver_fifo_lanes, counted as
// word_deliver_fifo_lanes: B16m's rest, the vmap of packed.py:644-653 in
// corrosion_tpu/campaign/ensemble.py:114) is the FIFO deliver with a lane
// grid dimension: blockIdx.y is the lane, whose rings [D, N, W], have words
// and planes are its slices (64-bit offsets); c, the wave and the low mask
// are shared.  A block's warps stage rows of one lane only (the lane is
// blockIdx.y), in the same rows x W words of shared memory (W <= 1024), so
// the gate reads each lane's own pre-merge have.  Bound: bytes, K times
// the solo bound.
//
// The lane entries (corro_word_inject_lanes, _spend_lanes,
// _deliver_lanes) run inject, spend and deliver over the seed ensemble's
// lanes (B16, corrosion_tpu/campaign/ensemble.py:114) as a grid
// dimension: blockIdx.y is the lane, whose have words, planes, targets,
// alive row, injected_p and ring slices are its slots of the [K, ...]
// tensors; the payload metadata and the round t are shared.  Bound: K
// times the solo bound.
//
// At the 1M tier (config_fault_storm_1m: N = 1 000 000, W = 16, D = 2,
// F = 3) a thread's word i < N * W = 1.6e7 and the ring offset slot * N
// * W + i < 3.2e7 are size_t; targets[(size_t)node * F + j] < 3e6.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

struct PlanePtrs {
  uint32_t* r[4];
};

// The planes of lane blockIdx.y, `cells` words a lane.
__device__ __forceinline__ PlanePtrs lane_planes(PlanePtrs p, size_t cells) {
  const size_t off = (size_t)blockIdx.y * cells;
  return PlanePtrs{{p.r[0] + off, p.r[1] + off, p.r[2] + off, p.r[3] + off}};
}

__global__ void inject_kernel(const int32_t* __restrict__ round_of,
                              const int32_t* __restrict__ actor,
                              const uint8_t* __restrict__ alive,
                              uint32_t* __restrict__ have, PlanePtrs planes,
                              uint32_t* __restrict__ injected, int n, int w,
                              int p, int t, int value) {
  int q = blockIdx.x * blockDim.x + threadIdx.x;
  if (q >= p || round_of[q] != t) return;
  // the lane's slices (lane 0 on the solo entry)
  const size_t lane = blockIdx.y;
  alive += lane * n;
  have += lane * n * w;
  injected += lane * w;
  planes = lane_planes(planes, (size_t)n * w);
  int row = actor[q];
  if (row < 0 || row >= n || alive[row] != 0) return;
  int k = q >> 5;
  uint32_t bit = 1u << (q & 31);
  atomicOr(&injected[k], bit);
  size_t i = (size_t)row * w + k;
  uint32_t old = atomicOr(&have[i], bit);
  if (old & bit) return;
  for (int j = 0; j < 4; ++j) {
    if ((value >> j) & 1) {
      atomicOr(&planes.r[j][i], bit);
    } else {
      atomicAnd(&planes.r[j][i], ~bit);
    }
  }
}

__global__ void spend_kernel(const uint32_t* __restrict__ have,
                             PlanePtrs planes,
                             const uint32_t* __restrict__ injected,
                             const int32_t* __restrict__ targets,
                             const uint8_t* __restrict__ alive,
                             uint32_t* __restrict__ sending, int n, int w,
                             int fanout, int mode) {
  size_t i = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= (size_t)n * w) return;
  const size_t lane = blockIdx.y;
  have += lane * n * w;
  sending += lane * n * w;
  injected += lane * w;
  targets += lane * n * fanout;
  alive += lane * n;
  planes = lane_planes(planes, (size_t)n * w);
  int node = (int)(i / w);
  int k = (int)(i % w);
  uint32_t r0 = planes.r[0][i], r1 = planes.r[1][i];
  uint32_t r2 = planes.r[2][i], r3 = planes.r[3][i];
  uint32_t s;
  if (mode == 2) {
    s = sending[i];
  } else {
    s = have[i] & (r0 | r1 | r2 | r3) & injected[k];
    sending[i] = s;
  }
  if (mode == 1 || s == 0u || alive[node] != 0) return;
  bool attempted = false;
  for (int j = 0; j < fanout; ++j) {
    int32_t tg = targets[(size_t)node * fanout + j];
    attempted |= tg >= 0 && tg != node;
  }
  if (!attempted) return;
  uint32_t borrow = s;
  planes.r[0][i] = r0 ^ borrow;
  borrow &= ~r0;
  planes.r[1][i] = r1 ^ borrow;
  borrow &= ~r1;
  planes.r[2][i] = r2 ^ borrow;
  borrow &= ~r2;
  planes.r[3][i] = r3 ^ borrow;
}

__global__ void deliver_kernel(uint32_t* __restrict__ inflight,
                               uint32_t* __restrict__ sync_buf,
                               uint32_t* __restrict__ have, PlanePtrs planes,
                               int n, int w, int d_slots, int slot,
                               int value) {
  size_t i = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= (size_t)n * w) return;
  const size_t lane = blockIdx.y;
  inflight += lane * d_slots * n * w;
  sync_buf += lane * d_slots * n * w;
  have += lane * n * w;
  planes = lane_planes(planes, (size_t)n * w);
  size_t s = (size_t)slot * n * w + i;
  uint32_t arriving = inflight[s];
  uint32_t pending = sync_buf[s];
  if ((arriving | pending) == 0u) return;
  uint32_t h = have[i];
  uint32_t newly = arriving & ~h;
  have[i] = h | arriving | pending;
  if (arriving) inflight[s] = 0u;
  if (pending) sync_buf[s] = 0u;
  if (newly == 0u) return;
  for (int j = 0; j < 4; ++j) {
    uint32_t r = planes.r[j][i] & ~newly;
    planes.r[j][i] = ((value >> j) & 1) ? (r | newly) : r;
  }
}

// The complete-version word j of a row: each aligned c-bit group of
// have word j all set, smeared over the group.
__device__ __forceinline__ uint32_t comp_word(const uint32_t* row, int j,
                                              int c, uint32_t low_mask) {
  uint32_t v = row[j];
  for (int step = 1; step < c; step <<= 1) v &= v >> step;
  v &= low_mask;
  for (int step = 1; step < c; step <<= 1) v |= v << step;
  return v;
}

// Bits [b0, b0 + 32) of the row's complete-version bitstring, where a
// negative position (before version 1) reads as set.
__device__ __forceinline__ uint32_t comp_bits(const uint32_t* row, int b0,
                                              int c, uint32_t low_mask) {
  if (b0 <= -32) return 0xFFFFFFFFu;
  if (b0 < 0) {
    int sh = -b0;
    return (comp_word(row, 0, c, low_mask) << sh) | ((1u << sh) - 1u);
  }
  int j = b0 >> 5, sh = b0 & 31;
  uint32_t lo = comp_word(row, j, c, low_mask) >> sh;
  if (sh) lo |= comp_word(row, j + 1, c, low_mask) << (32 - sh);
  return lo;
}

__global__ void deliver_fifo_kernel(uint32_t* __restrict__ inflight,
                                    uint32_t* __restrict__ sync_buf,
                                    uint32_t* __restrict__ have,
                                    PlanePtrs planes, int n, int w,
                                    int d_slots, int slot, int value, int c,
                                    int wave, uint32_t low_mask) {
  extern __shared__ uint32_t rows[];
  {
    // the lane's slices (lane 0 on the solo entry)
    const size_t lane = blockIdx.y;
    inflight += lane * d_slots * n * w;
    sync_buf += lane * d_slots * n * w;
    have += lane * n * w;
    planes = lane_planes(planes, (size_t)n * w);
  }
  int warp = threadIdx.x / 32, lane = threadIdx.x & 31;
  int node = blockIdx.x * (blockDim.x / 32) + warp;
  if (node >= n) return;  // whole warps leave together
  uint32_t* row = rows + (size_t)warp * w;
  size_t base = (size_t)node * w;
  for (int k = lane; k < w; k += 32) row[k] = have[base + k];
  __syncwarp();
  for (int k = lane; k < w; k += 32) {
    size_t i = base + k;
    size_t s = (size_t)slot * n * w + i;
    uint32_t arriving = inflight[s];
    uint32_t pending = sync_buf[s];
    if ((arriving | pending) == 0u) continue;
    if (arriving) inflight[s] = 0u;
    if (pending) sync_buf[s] = 0u;
    uint32_t admit = comp_bits(row, 32 * k - wave, c, low_mask);
    arriving &= admit;
    pending &= admit;
    uint32_t h = row[k];
    uint32_t newly = arriving & ~h;
    have[i] = h | arriving | pending;
    if (newly == 0u) continue;
    for (int j = 0; j < 4; ++j) {
      uint32_t r = planes.r[j][i] & ~newly;
      planes.r[j][i] = ((value >> j) & 1) ? (r | newly) : r;
    }
  }
}

PlanePtrs plane_ptrs(void* r0, void* r1, void* r2, void* r3) {
  return PlanePtrs{{(uint32_t*)r0, (uint32_t*)r1, (uint32_t*)r2,
                    (uint32_t*)r3}};
}

unsigned blocks_for(size_t total, int threads) {
  return (unsigned)((total + threads - 1) / threads);
}

}  // namespace

extern "C" int corro_word_inject(const void* round_of, const void* actor,
                                 const void* alive, void* have, void* r0,
                                 void* r1, void* r2, void* r3, void* injected,
                                 int n, int w, int p, int t, int value,
                                 void* stream) {
  if (n <= 0 || w <= 0 || p != w * 32 || value < 0 || value > 15)
    return (int)cudaErrorInvalidValue;
  inject_kernel<<<blocks_for(p, 256), 256, 0, (cudaStream_t)stream>>>(
      (const int32_t*)round_of, (const int32_t*)actor, (const uint8_t*)alive,
      (uint32_t*)have, plane_ptrs(r0, r1, r2, r3), (uint32_t*)injected, n, w,
      p, t, value);
  return (int)cudaGetLastError();
}

extern "C" int corro_word_spend(const void* have, void* r0, void* r1, void* r2,
                                void* r3, const void* injected,
                                const void* targets, const void* alive,
                                void* sending, int n, int w, int fanout,
                                int mode, void* stream) {
  // mode 0: unmetered spend; 1: eligible words only; 2: spend `sending`
  if (n <= 0 || w <= 0 || fanout <= 0 || mode < 0 || mode > 2)
    return (int)cudaErrorInvalidValue;
  spend_kernel<<<blocks_for((size_t)n * w, 256), 256, 0,
                 (cudaStream_t)stream>>>(
      (const uint32_t*)have, plane_ptrs(r0, r1, r2, r3),
      (const uint32_t*)injected, (const int32_t*)targets,
      (const uint8_t*)alive, (uint32_t*)sending, n, w, fanout, mode);
  return (int)cudaGetLastError();
}

extern "C" int corro_word_deliver(void* inflight, void* sync_buf, void* have,
                                  void* r0, void* r1, void* r2, void* r3,
                                  int n, int w, int d_slots, int slot,
                                  int value, void* stream) {
  if (n <= 0 || w <= 0 || slot < 0 || slot >= d_slots || value < 0 ||
      value > 15)
    return (int)cudaErrorInvalidValue;
  deliver_kernel<<<blocks_for((size_t)n * w, 256), 256, 0,
                   (cudaStream_t)stream>>>(
      (uint32_t*)inflight, (uint32_t*)sync_buf, (uint32_t*)have,
      plane_ptrs(r0, r1, r2, r3), n, w, d_slots, slot, value);
  return (int)cudaGetLastError();
}

// K8f: deliver behind the FIFO admit gate; `c` is chunks_per_version (a
// power of two up to 32) and `wave` = n_writers * c bits.
extern "C" int corro_word_deliver_fifo(void* inflight, void* sync_buf,
                                       void* have, void* r0, void* r1,
                                       void* r2, void* r3, int n, int w,
                                       int d_slots, int slot, int value,
                                       int c, int wave, void* stream) {
  if (n <= 0 || w <= 0 || slot < 0 || slot >= d_slots || value < 0 ||
      value > 15 || c <= 0 || c > 32 || (c & (c - 1)) || wave < c ||
      wave % c || (32 * w) % wave || w > 1024)
    return (int)cudaErrorInvalidValue;
  uint32_t low = 0u;
  for (int b = 0; b < 32; b += c) low |= 1u << b;
  const int threads = 256, rows = threads / 32;
  deliver_fifo_kernel<<<blocks_for((size_t)n * 32, threads), threads,
                        (size_t)rows * w * sizeof(uint32_t),
                        (cudaStream_t)stream>>>(
      (uint32_t*)inflight, (uint32_t*)sync_buf, (uint32_t*)have,
      plane_ptrs(r0, r1, r2, r3), n, w, d_slots, slot, value, c, wave, low);
  return (int)cudaGetLastError();
}

// The lane entries: the solo entries' arguments with every per-node
// tensor [lanes, ...] and injected_p [lanes, W], then `lanes`.
extern "C" int corro_word_inject_lanes(const void* round_of, const void* actor,
                                       const void* alive, void* have, void* r0,
                                       void* r1, void* r2, void* r3,
                                       void* injected, int n, int w, int p,
                                       int t, int value, int lanes,
                                       void* stream) {
  if (n <= 0 || w <= 0 || p != w * 32 || value < 0 || value > 15 ||
      lanes <= 0 || lanes > 65535)
    return (int)cudaErrorInvalidValue;
  inject_kernel<<<dim3(blocks_for(p, 256), lanes), 256, 0,
                  (cudaStream_t)stream>>>(
      (const int32_t*)round_of, (const int32_t*)actor, (const uint8_t*)alive,
      (uint32_t*)have, plane_ptrs(r0, r1, r2, r3), (uint32_t*)injected, n, w,
      p, t, value);
  return (int)cudaGetLastError();
}

extern "C" int corro_word_spend_lanes(const void* have, void* r0, void* r1,
                                      void* r2, void* r3, const void* injected,
                                      const void* targets, const void* alive,
                                      void* sending, int n, int w, int fanout,
                                      int mode, int lanes, void* stream) {
  if (n <= 0 || w <= 0 || fanout <= 0 || mode < 0 || mode > 2 ||
      lanes <= 0 || lanes > 65535)
    return (int)cudaErrorInvalidValue;
  spend_kernel<<<dim3(blocks_for((size_t)n * w, 256), lanes), 256, 0,
                 (cudaStream_t)stream>>>(
      (const uint32_t*)have, plane_ptrs(r0, r1, r2, r3),
      (const uint32_t*)injected, (const int32_t*)targets,
      (const uint8_t*)alive, (uint32_t*)sending, n, w, fanout, mode);
  return (int)cudaGetLastError();
}

extern "C" int corro_word_deliver_lanes(void* inflight, void* sync_buf,
                                        void* have, void* r0, void* r1,
                                        void* r2, void* r3, int n, int w,
                                        int d_slots, int slot, int value,
                                        int lanes, void* stream) {
  if (n <= 0 || w <= 0 || slot < 0 || slot >= d_slots || value < 0 ||
      value > 15 || lanes <= 0 || lanes > 65535)
    return (int)cudaErrorInvalidValue;
  deliver_kernel<<<dim3(blocks_for((size_t)n * w, 256), lanes), 256, 0,
                   (cudaStream_t)stream>>>(
      (uint32_t*)inflight, (uint32_t*)sync_buf, (uint32_t*)have,
      plane_ptrs(r0, r1, r2, r3), n, w, d_slots, slot, value);
  return (int)cudaGetLastError();
}

// K8f's lane entry: the solo FIFO deliver's arguments with inflight and
// sync_buf [lanes, D, N, W], have and the planes [lanes, N, W], then
// `lanes`; c, wave and the low mask are shared.
extern "C" int corro_word_deliver_fifo_lanes(void* inflight, void* sync_buf,
                                             void* have, void* r0, void* r1,
                                             void* r2, void* r3, int n, int w,
                                             int d_slots, int slot, int value,
                                             int c, int wave, int lanes,
                                             void* stream) {
  if (n <= 0 || w <= 0 || slot < 0 || slot >= d_slots || value < 0 ||
      value > 15 || c <= 0 || c > 32 || (c & (c - 1)) || wave < c ||
      wave % c || (32 * w) % wave || w > 1024 || lanes <= 0 ||
      lanes > 65535)
    return (int)cudaErrorInvalidValue;
  uint32_t low = 0u;
  for (int b = 0; b < 32; b += c) low |= 1u << b;
  const int threads = 256, rows = threads / 32;
  deliver_fifo_kernel<<<dim3(blocks_for((size_t)n * 32, threads), lanes),
                        threads, (size_t)rows * w * sizeof(uint32_t),
                        (cudaStream_t)stream>>>(
      (uint32_t*)inflight, (uint32_t*)sync_buf, (uint32_t*)have,
      plane_ptrs(r0, r1, r2, r3), n, w, d_slots, slot, value, c, wave, low);
  return (int)cudaGetLastError();
}
