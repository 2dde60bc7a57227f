// K20: a topology's per-edge classes — delay slots, degree caps and the
// tiered probe loss.
//
// Replaces corrosion_tpu/sim/topology.py:157 edge_delay (its AZ branch
// :170-180 and its region_delay_matrix gather :166-168, with :120 azs),
// :142 apply_degree_caps (with :133 node_degrees) and the tiered branch
// of corrosion_tpu/sim/swim.py:125 _reachable (:142-157: :240
// tiered_edge_drop over :223/:315 edge_loss_thresholds(_raw)).  The
// plain versions are corrosion_tpu_torch/sim/topology.py
// edge_slot_plain, apply_degree_caps_plain and tiered_reach_plain.  Every
// entry reads the topology's int32 table (topo_tiers.cuh): block sizes,
// tier thresholds and delays, the delay matrix, the degree classes.
//
// Three entry points:
//   corro_edge_slots    one thread per edge e: slot[e] = (t + delay(src,
//                       dst) + fdelay[e]) % D, the delay the matrix's
//                       entry for the two regions or the tier's delay;
//                       fdelay (a fault plan's fixed delay, K9) may be
//                       null.  The broadcast rings' slot (packed.py:441
//                       and :511, broadcast.py:100 and :182).
//   corro_degree_caps   one thread per (node, slot) cell of the i32[N, F]
//                       targets: slot s of node i becomes -1 where s >=
//                       degree_classes[i % len], in place (the -1 every
//                       consumer already treats as an unfilled slot).
//   corro_edge_reach    one thread per edge, in place on bool ok[e]:
//                       ok &= !(byte e of aligned_u8_bits(fold_in(key,
//                       104), [E]) < min(raw, 255) || raw >= 256), raw the
//                       edge's tier threshold.  Byte e is byte e % 4 (little
//                       endian) of u32 word e / 4 of the draw, the hash of
//                       counter (0, e / 4): under the partitionable threefry
//                       word i never depends on the draw's padded length, so
//                       E = 100 000 (padded to 100 096 bytes) needs no pad.
//                       An edge of threshold 0 hashes nothing (no byte is
//                       below 0); raw >= 256 drops without a hash, which is
//                       JAX's certainty pin (it applies only when some tier
//                       reaches 256, and then exactly to those edges).
//
// K20's schedule instantiation (corro_degree_caps_sched, counted as
// degree_caps_sched) is corrosion_tpu/proto/schedule.py:27
// scheduled_fanout_targets composed after the caps, as broadcast_packed
// (corrosion_tpu/sim/packed.py:429-434) and broadcast_step apply them:
// slot s of node i becomes -1 where s >= min(cap(i), active), `active`
// this round's live slot count (schedule.py:18 active_fanout, computed on
// the host: the round counter is a host int), the cap F without degree
// classes (a null table).
//
// Its lane form (corro_degree_caps_sched_lanes, counted as
// degree_caps_sched_lanes: B16v, corrosion_tpu/campaign/ensemble.py:114
// vmaps broadcast.py:98-106) takes the targets [K, N, F] with the lane as
// blockIdx.y, offset in 64 bits; the table and the live slot count are
// shared (every lane is at the same round).  Bound: K times the solo
// bound.
//
// The lane entries (corro_edge_slots_lanes, corro_degree_caps_lanes,
// corro_edge_reach_lanes) run the slots, the caps and the tiered reach
// over a seed ensemble's lanes on the dense round (B16t: corrosion_tpu/
// campaign/ensemble.py:114 vmaps topology.py:157, :142 and swim.py:125)
// as a grid dimension: blockIdx.y is the lane, whose per-edge and
// per-node tensors are its slices of the [K, ...] ones, offset in 64
// bits; node ids and the reach's draw counter e stay lane-local, so lane
// k is the solo entry on lane k's inputs.  The slots' src [E] is shared
// (the sender of edge e is e / F in every lane), dst, fdelay and slot
// are [K, E]; the reach takes src and dst [K, E] (its relay legs start
// or end at each lane's own relays) and each lane's key [K, 2], folded
// once a block; the caps take the targets [K, N, F].  The topology's
// table is shared.  Bound: K times the solo bound.
//
// Bound on the H100: bytes (launch latency at these sizes).  An edge
// reads two ids (8 bytes) and writes a slot (4) or reads and writes ok
// (2); the caps read and write 4 bytes a cell; the reach hashes at most
// one word per edge of a lossy tier (~72 u32 operations, E / 4 words a
// round at most — a few µs of integer time at E = 300 000).  Design: one
// thread per element, the table in L1 (at most 16 + R² + len ints), the
// folded key once per block in shared memory.

#include <cstdint>
#include <cuda_runtime.h>

#include "threefry.cuh"
#include "topo_tiers.cuh"

namespace {

constexpr int kThreads = 256;

__global__ void edge_slots_kernel(const int32_t* __restrict__ tb,
                                  const int32_t* __restrict__ src,
                                  const int32_t* __restrict__ dst,
                                  const int32_t* __restrict__ fdelay,
                                  int32_t* __restrict__ slot, int e, int t,
                                  int d_slots) {
  // the lane's slices (lane 0 on the solo entry; src is shared)
  const size_t lane = blockIdx.y;
  dst += lane * e;
  slot += lane * e;
  if (fdelay != nullptr) fdelay += lane * e;
  int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= e) return;
  int d = corro::topo_delay(tb, src[i], dst[i]);
  if (fdelay != nullptr) d += fdelay[i];
  slot[i] = (int32_t)((unsigned)(t + d) % (unsigned)d_slots);
}

__global__ void degree_caps_kernel(const int32_t* __restrict__ tb,
                                   int32_t* __restrict__ targets, int n,
                                   int f) {
  // the lane's targets (lane 0 on the solo entry)
  targets += (size_t)blockIdx.y * n * f;
  size_t i = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= (size_t)n * f) return;
  int node = (int)(i / f);
  int s = (int)(i % f);
  if (s >= corro::topo_degree(tb, node)) targets[i] = -1;
}

__global__ void degree_caps_sched_kernel(const int32_t* __restrict__ tb,
                                         int32_t* __restrict__ targets, int n,
                                         int f, int active) {
  // the lane's targets (lane 0 on the solo entry)
  targets += (size_t)blockIdx.y * n * f;
  size_t i = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= (size_t)n * f) return;
  int node = (int)(i / f);
  int s = (int)(i % f);
  int cap = tb != nullptr ? corro::topo_degree(tb, node) : f;
  if (s >= (cap < active ? cap : active)) targets[i] = -1;
}

__global__ void edge_reach_kernel(const int32_t* __restrict__ tb,
                                  const int32_t* __restrict__ src,
                                  const int32_t* __restrict__ dst,
                                  const int64_t* __restrict__ key,
                                  bool* __restrict__ ok, int e,
                                  uint32_t tag) {
  // the lane's slices (lane 0 on the solo entry)
  const size_t lane = blockIdx.y;
  src += lane * e;
  dst += lane * e;
  ok += lane * e;
  key += lane * 2;
  __shared__ uint32_t folded[2];
  if (threadIdx.x == 0) {
    corro::Pair f = corro::fold_in(
        corro::Pair{(uint32_t)key[0], (uint32_t)key[1]}, tag);
    folded[0] = f.a;
    folded[1] = f.b;
  }
  __syncthreads();
  int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= e || !ok[i]) return;
  int raw = corro::topo_loss_raw(tb, src[i], dst[i]);
  if (raw <= 0) return;
  bool drop = raw >= 256;
  if (!drop) {
    corro::Pair h =
        corro::threefry2x32(folded[0], folded[1], 0u, (uint32_t)i >> 2);
    uint32_t byte = ((h.a ^ h.b) >> (8u * ((uint32_t)i & 3u))) & 0xFFu;
    drop = byte < (uint32_t)raw;
  }
  if (drop) ok[i] = false;
}

unsigned blocks_for(size_t n) {
  return (unsigned)((n + kThreads - 1) / kThreads);
}

bool bad_lanes(int lanes) { return lanes <= 0 || lanes > 65535; }

}  // namespace

extern "C" int corro_edge_slots(const void* table, const void* src,
                                const void* dst, const void* fdelay,
                                void* slot, int e, int t, int d_slots,
                                void* stream) {
  if (e < 0 || t < 0 || d_slots <= 0) return (int)cudaErrorInvalidValue;
  if (e == 0) return (int)cudaSuccess;
  edge_slots_kernel<<<blocks_for(e), kThreads, 0, (cudaStream_t)stream>>>(
      (const int32_t*)table, (const int32_t*)src, (const int32_t*)dst,
      (const int32_t*)fdelay, (int32_t*)slot, e, t, d_slots);
  return (int)cudaGetLastError();
}

extern "C" int corro_degree_caps(const void* table, void* targets, int n,
                                 int f, void* stream) {
  if (n <= 0 || f <= 0) return (int)cudaErrorInvalidValue;
  degree_caps_kernel<<<blocks_for((size_t)n * f), kThreads, 0,
                       (cudaStream_t)stream>>>((const int32_t*)table,
                                               (int32_t*)targets, n, f);
  return (int)cudaGetLastError();
}

extern "C" int corro_edge_reach(const void* table, const void* src,
                                const void* dst, const void* key, void* ok,
                                int e, int tag, void* stream) {
  if (e < 0) return (int)cudaErrorInvalidValue;
  if (e == 0) return (int)cudaSuccess;
  edge_reach_kernel<<<blocks_for(e), kThreads, 0, (cudaStream_t)stream>>>(
      (const int32_t*)table, (const int32_t*)src, (const int32_t*)dst,
      (const int64_t*)key, (bool*)ok, e, (uint32_t)tag);
  return (int)cudaGetLastError();
}

// The schedule instantiation: `table` null without degree classes.
extern "C" int corro_degree_caps_sched(const void* table, void* targets,
                                       int n, int f, int active,
                                       void* stream) {
  if (n <= 0 || f <= 0 || active < 1) return (int)cudaErrorInvalidValue;
  degree_caps_sched_kernel<<<blocks_for((size_t)n * f), kThreads, 0,
                             (cudaStream_t)stream>>>(
      (const int32_t*)table, (int32_t*)targets, n, f, active);
  return (int)cudaGetLastError();
}

// The lane entries: the solo entries' arguments with the per-lane
// tensors [lanes, ...] (see the header), then `lanes`.
extern "C" int corro_edge_slots_lanes(const void* table, const void* src,
                                      const void* dst, const void* fdelay,
                                      void* slot, int e, int t, int d_slots,
                                      int lanes, void* stream) {
  if (e < 0 || t < 0 || d_slots <= 0 || bad_lanes(lanes))
    return (int)cudaErrorInvalidValue;
  if (e == 0) return (int)cudaSuccess;
  edge_slots_kernel<<<dim3(blocks_for(e), lanes), kThreads, 0,
                      (cudaStream_t)stream>>>(
      (const int32_t*)table, (const int32_t*)src, (const int32_t*)dst,
      (const int32_t*)fdelay, (int32_t*)slot, e, t, d_slots);
  return (int)cudaGetLastError();
}

extern "C" int corro_degree_caps_lanes(const void* table, void* targets,
                                       int n, int f, int lanes,
                                       void* stream) {
  if (n <= 0 || f <= 0 || bad_lanes(lanes)) return (int)cudaErrorInvalidValue;
  degree_caps_kernel<<<dim3(blocks_for((size_t)n * f), lanes), kThreads, 0,
                       (cudaStream_t)stream>>>((const int32_t*)table,
                                               (int32_t*)targets, n, f);
  return (int)cudaGetLastError();
}

extern "C" int corro_edge_reach_lanes(const void* table, const void* src,
                                      const void* dst, const void* keys,
                                      void* ok, int e, int tag, int lanes,
                                      void* stream) {
  if (e < 0 || bad_lanes(lanes)) return (int)cudaErrorInvalidValue;
  if (e == 0) return (int)cudaSuccess;
  edge_reach_kernel<<<dim3(blocks_for(e), lanes), kThreads, 0,
                      (cudaStream_t)stream>>>(
      (const int32_t*)table, (const int32_t*)src, (const int32_t*)dst,
      (const int64_t*)keys, (bool*)ok, e, (uint32_t)tag);
  return (int)cudaGetLastError();
}

// The schedule instantiation's lane form: the targets [lanes, N, F], the
// shared table (null without degree classes) and the round's live slot
// count, shared by every lane (the round counter is).
extern "C" int corro_degree_caps_sched_lanes(const void* table, void* targets,
                                             int n, int f, int active,
                                             int lanes, void* stream) {
  if (n <= 0 || f <= 0 || active < 1 || bad_lanes(lanes))
    return (int)cudaErrorInvalidValue;
  degree_caps_sched_kernel<<<dim3(blocks_for((size_t)n * f), lanes),
                             kThreads, 0, (cudaStream_t)stream>>>(
      (const int32_t*)table, (int32_t*)targets, n, f, active);
  return (int)cudaGetLastError();
}
