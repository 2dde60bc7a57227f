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
//            counter wraps).
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

#include <cstdint>
#include <cuda_runtime.h>

namespace {

struct PlanePtrs {
  uint32_t* r[4];
};

__global__ void inject_kernel(const int32_t* __restrict__ round_of,
                              const int32_t* __restrict__ actor,
                              const uint8_t* __restrict__ alive,
                              uint32_t* __restrict__ have, PlanePtrs planes,
                              uint32_t* __restrict__ injected, int n, int w,
                              int p, int t, int value) {
  int q = blockIdx.x * blockDim.x + threadIdx.x;
  if (q >= p || round_of[q] != t) return;
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
                             int fanout) {
  size_t i = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= (size_t)n * w) return;
  int node = (int)(i / w);
  int k = (int)(i % w);
  uint32_t r0 = planes.r[0][i], r1 = planes.r[1][i];
  uint32_t r2 = planes.r[2][i], r3 = planes.r[3][i];
  uint32_t s = have[i] & (r0 | r1 | r2 | r3) & injected[k];
  sending[i] = s;
  if (s == 0u || alive[node] != 0) return;
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
                               int n, int w, int slot, int value) {
  size_t i = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= (size_t)n * w) return;
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
                                void* stream) {
  if (n <= 0 || w <= 0 || fanout <= 0) return (int)cudaErrorInvalidValue;
  spend_kernel<<<blocks_for((size_t)n * w, 256), 256, 0,
                 (cudaStream_t)stream>>>(
      (const uint32_t*)have, plane_ptrs(r0, r1, r2, r3),
      (const uint32_t*)injected, (const int32_t*)targets,
      (const uint8_t*)alive, (uint32_t*)sending, n, w, fanout);
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
      plane_ptrs(r0, r1, r2, r3), n, w, slot, value);
  return (int)cudaGetLastError();
}
