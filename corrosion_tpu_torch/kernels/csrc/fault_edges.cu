// K9: the per-edge fault queries of a factored fault plan.
//
// Replaces corrosion_tpu/sim/faults.py:182 _factored_hits and what the
// round builds on it: faults.py:195 fault_edge_block, :207
// fault_edge_loss, :226 fault_edge_delay, :243 fault_edge_jitter, :303
// fault_session_refused, :312 fault_session_delay, the per-edge half of
// :260 fault_wire_effects (cuts, thresholds, the fixed delay, the
// jitter bound), and the fault branch of corrosion_tpu/sim/swim.py:125
// _reachable (swim.py:161-181).  The plain versions are in
// corrosion_tpu_torch/sim/faults.py.
//
// A factor k hits edge (s, d) this round when on[k] & src_mask[k, s] &
// dst_mask[k, d] and s != d: self-edges never fault (the probe relay
// legs do evaluate (x, x) edges).  An edge is cut when any block factor
// hits it; its extra loss threshold is the max of the hitting loss
// factors' thresholds (0 when none hits); its fault delay is the SUM of
// the hitting delay factors' rounds (overlapping delays add); its
// jitter bound the MAX of the hitting jitter factors' rounds (0 when
// none hits); its session delay the max of its own delay and the
// reversed edge's (the slower direction bounds the bidirectional sync
// stream).  `on` is a column of the plan's [K, R+1] active matrix, read
// with its stride.
//
// Two C functions, one thread per edge:
//   corro_fault_edges  writes the cut (optionally OR the reversed edge's
//                      cut: a sync session dies on a cut in either
//                      direction) and/or the threshold, and/or clears
//                      ok[e] on a cut, and/or the three i32 latency
//                      outputs (fault delay, jitter bound, session
//                      delay) — the query, session and wire calls, each
//                      one pass over the factors;
//   corro_fault_reach  _reachable's whole fault branch in place:
//                      ok[e] &= !cut & !(u8 bits[e] < thr[e]), the bits
//                      being aligned_u8_bits(fold_in(fold_in(key, seed),
//                      tag), [E]): byte e%4 (little-endian) of u32 word
//                      e/4 of a bits draw, whose word i is the hash of
//                      counter (0, i) whatever the draw's padded length.
//                      Each block derives the folded key once; an edge
//                      with no threshold draws nothing (no u8 is below 0).
// corro_fault_reach_lanes is the reach entry over the seed ensemble's
// lanes (B16, corrosion_tpu/campaign/ensemble.py:114): blockIdx.y is the
// lane, whose edges, ok mask and loss key are its slices of [K, ...]
// tensors and whose plan seed is `seeds[lane]` (ensemble.py:58
// lane_plan_seeds: only the seed is batched, the factors are the
// shared plan's); the draw index e stays lane-local, so lane k's probe
// loss is the solo run's under seed k.  The edge queries need no lane
// entry: they draw nothing, so the lanes fold into their edge axis.
// The wrappers launch corro_fault_edges through two counters: the
// latency entry (`FAULT_EDGES_DELAY`) whenever a call asks for a latency
// output, the plain entry (`FAULT_EDGES`) otherwise.
//
// With the flight recorder on, corro_fault_edges also counts into an
// int64 accumulator the ok edges its cut clears (`count`, which needs
// `ok`): the broadcast's cut edges (corrosion_tpu/sim/packed.py:471-477,
// sum(ok_pre & ~ok)) and the sync's refused sessions (packed.py:1194-1196,
// sum(ok & refused)).  Each warp ballots its hits and the block adds
// once.  A null `count` (telemetry off) counts nothing.
//
// K9m, the matrix entry (corro_fault_edges_matrix, corro_fault_reach_matrix):
// the same outputs for a matrix plan's round slice (faults.py:88
// SimFaultPlan, :108 RoundFaults, the matrix branches of :195-256
// fault_edge_block/loss/delay/jitter, :303 fault_session_refused, :312
// fault_session_delay, swim.py:161-181 on a RoundFaults).  One thread
// per edge gathers the round's row-major [N, N] slabs at s·N + d (and
// d·N + s for the session outputs), with 64-bit offsets: a forced
// matrix plan at 4096 nodes holds 16.8 M cells a slab.  A class absent
// from the plan is a null slab and reads as 0: no load.  The slabs
// carry the merged values already (the compiler folded overlapping
// events), so there is no factor loop; the diagonal is clear by
// construction.
//
// Bound on the H100: launch latency.  An edge reads two int32 ids and
// K mask bytes at each of them, and writes at most 14 bytes; at the
// storm's E <= 300000 and K <= 2 per class that is under 8 MB (the
// latency outputs add 3.6 MB), a few microseconds of memory time at
// most, near the cost of a launch.  Design: the simplest one-pass form;
// the masks of a half-split partition or a first-sixth delay are byte
// arrays the caches hold whole.

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

// The summed rounds of the hitting factors (fault delay) or their max
// (jitter bound), 0 on a self-edge.
__device__ __forceinline__ int32_t delay_sum(const Factors& f,
                                            const int32_t* val, int n, int s,
                                            int d) {
  int32_t sum = 0;
  if (s == d) return sum;
  for (int kk = 0; kk < f.k; ++kk)
    if (hits(f, kk, n, s, d)) sum += val[kk];
  return sum;
}

__device__ __forceinline__ int32_t jitter_max(const Factors& f,
                                             const int32_t* val, int n,
                                             int s, int d) {
  int32_t m = 0;
  if (s == d) return m;
  for (int kk = 0; kk < f.k; ++kk)
    if (hits(f, kk, n, s, d) && val[kk] > m) m = val[kk];
  return m;
}

struct Latency {
  Factors delay;
  const int32_t* delay_rounds;  // [kd]
  Factors jitter;
  const int32_t* jitter_rounds;  // [kj]
  int32_t* delay_out;            // [e] or null
  int32_t* jit_out;              // [e] or null
  int32_t* sdelay_out;           // [e] or null
};

__device__ __forceinline__ bool in_range(int s, int d, int n) {
  return s >= 0 && s < n && d >= 0 && d < n;
}

__global__ void fault_edges_kernel(Factors b, Factors l, Latency lat,
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
    if (lat.delay_out || lat.sdelay_out) {
      int32_t fwd = valid ? delay_sum(lat.delay, lat.delay_rounds, n, s, d)
                          : 0;
      if (lat.delay_out) lat.delay_out[i] = fwd;
      if (lat.sdelay_out) {
        int32_t rev =
            valid ? delay_sum(lat.delay, lat.delay_rounds, n, d, s) : 0;
        lat.sdelay_out[i] = fwd > rev ? fwd : rev;
      }
    }
    if (lat.jit_out)
      lat.jit_out[i] =
          valid ? jitter_max(lat.jitter, lat.jitter_rounds, n, s, d) : 0;
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
                                   uint8_t* __restrict__ ok,
                                   const int32_t* __restrict__ seeds, int n,
                                   int e, uint32_t seed, uint32_t tag) {
  __shared__ uint32_t folded[2];
  // the lane's edges, key and plan seed (lane 0 and `seed` on the solo
  // entry); the draw index i stays lane-local
  {
    const size_t lane = blockIdx.y;
    src += lane * e;
    dst += lane * e;
    ok += lane * e;
    key += 2 * lane;
    if (seeds) seed = (uint32_t)seeds[lane];
  }
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

// The matrix entry's cell reader: slab[s·n + d], or 0 for an absent
// class (a null slab).
__device__ __forceinline__ uint8_t cell(const uint8_t* __restrict__ slab,
                                        int n, int s, int d) {
  return slab ? slab[(size_t)s * (size_t)n + (size_t)d] : (uint8_t)0;
}

__global__ void fault_edges_matrix_kernel(
    const uint8_t* __restrict__ blk, const uint8_t* __restrict__ loss,
    const uint8_t* __restrict__ delay, const uint8_t* __restrict__ jitter,
    const int32_t* __restrict__ src, const int32_t* __restrict__ dst,
    uint8_t* __restrict__ cut_out, uint8_t* __restrict__ thr_out,
    uint8_t* __restrict__ ok, unsigned long long* __restrict__ count,
    int32_t* __restrict__ delay_out, int32_t* __restrict__ jit_out,
    int32_t* __restrict__ sdelay_out, int n, int e, int sym) {
  int i = blockIdx.x * blockDim.x + threadIdx.x;
  bool cleared = false;
  if (i < e) {
    int s = src[i], d = dst[i];
    bool valid = in_range(s, d, n);
    bool c = false;
    if (valid && (cut_out || ok))
      c = cell(blk, n, s, d) || (sym && cell(blk, n, d, s));
    if (cut_out) cut_out[i] = c;
    if (thr_out) thr_out[i] = valid ? cell(loss, n, s, d) : 0;
    if (delay_out || sdelay_out) {
      int32_t fwd = valid ? cell(delay, n, s, d) : 0;
      if (delay_out) delay_out[i] = fwd;
      if (sdelay_out) {
        int32_t rev = valid ? cell(delay, n, d, s) : 0;
        sdelay_out[i] = fwd > rev ? fwd : rev;
      }
    }
    if (jit_out) jit_out[i] = valid ? cell(jitter, n, s, d) : 0;
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

__global__ void fault_reach_matrix_kernel(
    const uint8_t* __restrict__ blk, const uint8_t* __restrict__ loss,
    const int32_t* __restrict__ src, const int32_t* __restrict__ dst,
    const int64_t* __restrict__ key, uint8_t* __restrict__ ok, int n, int e,
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
  if (cell(blk, n, s, d)) {
    ok[i] = 0;
    return;
  }
  uint8_t t = cell(loss, n, s, d);
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

// The latency outputs need their class: `delay_out` and `sdelay_out`
// read the delay factors (kd of them), `jit_out` the jitter factors.
extern "C" int corro_fault_edges(
    const void* b_on, const void* b_src, const void* b_dst, const void* l_on,
    const void* l_src, const void* l_dst, const void* l_thr,
    const void* d_on, const void* d_src, const void* d_dst,
    const void* d_val, const void* j_on, const void* j_src,
    const void* j_dst, const void* j_val, const void* src, const void* dst,
    void* cut_out, void* thr_out, void* ok, void* count, void* delay_out,
    void* jit_out, void* sdelay_out, int kb, int b_stride, int kl,
    int l_stride, int kd, int d_stride, int kj, int j_stride, int n, int e,
    int sym, void* stream) {
  if (!shapes_ok(kb, kl, n, e) || kd < 0 || kj < 0 ||
      (count != nullptr && ok == nullptr))
    return (int)cudaErrorInvalidValue;
  if (e == 0) return (int)cudaSuccess;
  Factors b{(const uint8_t*)b_on, (const uint8_t*)b_src,
            (const uint8_t*)b_dst, kb, b_stride};
  Factors l{(const uint8_t*)l_on, (const uint8_t*)l_src,
            (const uint8_t*)l_dst, kl, l_stride};
  Latency lat{Factors{(const uint8_t*)d_on, (const uint8_t*)d_src,
                      (const uint8_t*)d_dst, kd, d_stride},
              (const int32_t*)d_val,
              Factors{(const uint8_t*)j_on, (const uint8_t*)j_src,
                      (const uint8_t*)j_dst, kj, j_stride},
              (const int32_t*)j_val, (int32_t*)delay_out, (int32_t*)jit_out,
              (int32_t*)sdelay_out};
  unsigned blocks = (unsigned)((e + kThreads - 1) / kThreads);
  fault_edges_kernel<<<blocks, kThreads, 0, (cudaStream_t)stream>>>(
      b, l, lat, (const uint8_t*)l_thr, (const int32_t*)src,
      (const int32_t*)dst, (uint8_t*)cut_out, (uint8_t*)thr_out,
      (uint8_t*)ok, (unsigned long long*)count, n, e, sym);
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
      (const int64_t*)key, (uint8_t*)ok, nullptr, n, e, (uint32_t)seed,
      (uint32_t)tag);
  return (int)cudaGetLastError();
}

// The reach entry's lane form: src, dst and ok [lanes, e] (lane-local
// ids), `key` the lanes' loss keys [lanes, 2], `seeds` their plan seeds
// [lanes] (i32); the factors are the shared plan's.
extern "C" int corro_fault_reach_lanes(
    const void* b_on, const void* b_src, const void* b_dst, const void* l_on,
    const void* l_src, const void* l_dst, const void* l_thr, const void* src,
    const void* dst, const void* key, void* ok, const void* seeds, int kb,
    int b_stride, int kl, int l_stride, int n, int e, int tag, int lanes,
    void* stream) {
  if (!shapes_ok(kb, kl, n, e) || seeds == nullptr || lanes <= 0 ||
      lanes > 65535)
    return (int)cudaErrorInvalidValue;
  if (e == 0) return (int)cudaSuccess;
  Factors b{(const uint8_t*)b_on, (const uint8_t*)b_src,
            (const uint8_t*)b_dst, kb, b_stride};
  Factors l{(const uint8_t*)l_on, (const uint8_t*)l_src,
            (const uint8_t*)l_dst, kl, l_stride};
  unsigned blocks = (unsigned)((e + kThreads - 1) / kThreads);
  fault_reach_kernel<<<dim3(blocks, lanes), kThreads, 0,
                       (cudaStream_t)stream>>>(
      b, l, (const uint8_t*)l_thr, (const int32_t*)src, (const int32_t*)dst,
      (const int64_t*)key, (uint8_t*)ok, (const int32_t*)seeds, n, e, 0u,
      (uint32_t)tag);
  return (int)cudaGetLastError();
}

// K9m: the matrix slabs of one round (each [n, n] row-major, null when
// the class is absent or not asked for), the same outputs as
// corro_fault_edges.
extern "C" int corro_fault_edges_matrix(
    const void* blk, const void* loss, const void* delay, const void* jitter,
    const void* src, const void* dst, void* cut_out, void* thr_out, void* ok,
    void* count, void* delay_out, void* jit_out, void* sdelay_out, int n,
    int e, int sym, void* stream) {
  if (n <= 0 || e < 0 || (count != nullptr && ok == nullptr))
    return (int)cudaErrorInvalidValue;
  if (e == 0) return (int)cudaSuccess;
  unsigned blocks = (unsigned)((e + kThreads - 1) / kThreads);
  fault_edges_matrix_kernel<<<blocks, kThreads, 0, (cudaStream_t)stream>>>(
      (const uint8_t*)blk, (const uint8_t*)loss, (const uint8_t*)delay,
      (const uint8_t*)jitter, (const int32_t*)src, (const int32_t*)dst,
      (uint8_t*)cut_out, (uint8_t*)thr_out, (uint8_t*)ok,
      (unsigned long long*)count, (int32_t*)delay_out, (int32_t*)jit_out,
      (int32_t*)sdelay_out, n, e, sym);
  return (int)cudaGetLastError();
}

extern "C" int corro_fault_reach_matrix(const void* blk, const void* loss,
                                        const void* src, const void* dst,
                                        const void* key, void* ok, int n,
                                        int e, int seed, int tag,
                                        void* stream) {
  if (n <= 0 || e < 0) return (int)cudaErrorInvalidValue;
  if (e == 0) return (int)cudaSuccess;
  unsigned blocks = (unsigned)((e + kThreads - 1) / kThreads);
  fault_reach_matrix_kernel<<<blocks, kThreads, 0, (cudaStream_t)stream>>>(
      (const uint8_t*)blk, (const uint8_t*)loss, (const int32_t*)src,
      (const int32_t*)dst, (const int64_t*)key, (uint8_t*)ok, n, e,
      (uint32_t)seed, (uint32_t)tag);
  return (int)cudaGetLastError();
}
