// K19: the flight recorder's row write.
//
// Replaces corrosion_tpu/sim/telemetry.py:202 record_round (every
// channel's indexed update at the row of _trace_row, the trace_every
// scratch row included), with telemetry.py:183 swim_belief_counts,
// telemetry.py:244 record_node_faults and the fold of corrosion_tpu/sim/
// fused.py:207 grant_fold.  The plain version is sim/telemetry.py
// record_row_plain.
//
// The round's other kernels leave their parts in two buffers of the
// trace: int64 accumulators `acc` (broadcast frames and bytes from K18,
// dropped frames from K10 or K12, cut edges and refused sessions from
// K9) and i32 count rows `counts` [3, P] (coverage and delivered from
// K17, per-payload sync grants from K17 or K13).  This kernel
//   1. reduces what is left, in a grid-stride pass with one atomic add a
//      block a total: up nodes (alive == ALIVE), the SWIM belief totals
//      over the member table (partial view: valid pid and pkey & 3 ==
//      SUSPECT or DOWN; full view: the [N, N] beliefs), the nodes the
//      fault schedule holds DOWN and the wipes it fires, and the
//      established sync sessions (the sync edges' ok mask);
//   2. in the last block to finish (a ticket after a fence), folds the
//      grants — frames = sum of counts, bytes = sum of counts * nbytes,
//      exact in int64 — rounds both byte totals once to f32
//      (__ll2float_rn: JAX sums f32 terms, the port rounds the exact
//      total, within m * 2^-24 of each other), writes every channel of
//      the row, and zeroes acc and counts for the next round.
// Nothing is read back to the host: the row index comes in as an int.
//
// Bound on the H100: bytes — at the storm the member table (pid and
// pkey, 100000 x 64 x 2 x 4 = 51 MB) dominates, about 15 us.  Design:
// coalesced grid-stride loads, registers for the six totals, a warp
// shuffle and a shared-memory sum per block, one global add per total
// per block.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarp = 32;
// accumulator slots; sim/telemetry.py ACC names them in this order
enum Slot {
  kBcastFrames, kBcastBytes, kBcastDropped, kBcastCut, kSyncRefused,
  kUp, kSuspect, kDown, kCrashes, kWipes, kSessions, kTicket, kSlots
};
constexpr int kTotals = 6;  // kUp .. kSessions
constexpr int kSuspectState = 1, kDownState = 2;

struct Channels {
  int32_t* coverage;  // [R, P]
  int32_t* delivered;  // [R, P]
  int32_t* up_nodes;
  float* bcast_bytes;
  int32_t* bcast_frames;
  int32_t* bcast_dropped;
  int32_t* bcast_cut;
  float* sync_bytes;
  int32_t* sync_frames;
  int32_t* sync_sessions;
  int32_t* sync_refused;
  int32_t* swim_suspect;
  int32_t* swim_down;
  int32_t* crashes;
  int32_t* wipes;
  int32_t* gap_overflow;
};

struct Inputs {
  const uint8_t* alive;     // [N]
  const int32_t* pid;       // [N, M] (partial view)
  const int32_t* pkey;      // [N, M]
  const int8_t* view;       // [N, N] (full view)
  const int8_t* rf_alive;   // [N] or null (no fault plan)
  const bool* rf_wipe;      // [N] or null
  const bool* sync_ok;      // [Es]
  const int32_t* n_overflow;  // scalar
  const int32_t* nbytes;    // [P]
  unsigned long long* acc;  // [kSlots]
  int32_t* counts;          // [3, P]
};

__device__ __forceinline__ long long warp_sum(long long v) {
#pragma unroll
  for (int d = kWarp / 2; d > 0; d >>= 1) v += __shfl_xor_sync(0xFFFFFFFFu, v, d);
  return v;
}

__global__ void trace_row_kernel(Inputs in, Channels out, int n, int cells,
                                 int swim, int es, int p, int row) {
  __shared__ unsigned long long part[kTotals];
  __shared__ bool last;
  if (threadIdx.x < kTotals) part[threadIdx.x] = 0ull;
  __syncthreads();
  long long t[kTotals] = {0, 0, 0, 0, 0, 0};
  size_t first = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  size_t stride = (size_t)gridDim.x * blockDim.x;
  for (size_t i = first; i < (size_t)n; i += stride) {
    t[0] += in.alive[i] == 0;
    if (in.rf_alive) t[3] += in.rf_alive[i] == kDownState;
    if (in.rf_wipe) t[4] += in.rf_wipe[i] ? 1 : 0;
  }
  if (swim == 1) {
    for (size_t i = first; i < (size_t)cells; i += stride) {
      if (in.pid[i] < 0) continue;
      int st = in.pkey[i] & 3;
      t[1] += st == kSuspectState;
      t[2] += st == kDownState;
    }
  } else if (swim == 2) {
    for (size_t i = first; i < (size_t)cells; i += stride) {
      int8_t b = in.view[i];
      t[1] += b == kSuspectState;
      t[2] += b == kDownState;
    }
  }
  for (size_t i = first; i < (size_t)es; i += stride)
    t[5] += in.sync_ok[i] ? 1 : 0;
#pragma unroll
  for (int j = 0; j < kTotals; ++j) {
    long long s = warp_sum(t[j]);
    if ((threadIdx.x & (kWarp - 1)) == 0 && s)
      atomicAdd(&part[j], (unsigned long long)s);
  }
  __syncthreads();
  if (threadIdx.x < kTotals && part[threadIdx.x])
    atomicAdd(&in.acc[kUp + threadIdx.x], part[threadIdx.x]);
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0)
    last = atomicAdd(&in.acc[kTicket], 1ull) == (unsigned long long)(gridDim.x - 1);
  __syncthreads();
  if (!last) return;
  __threadfence();

  // the last block: the grant fold, the row, the reset
  __shared__ unsigned long long fold[2];
  if (threadIdx.x < 2) fold[threadIdx.x] = 0ull;
  __syncthreads();
  long long frames = 0, bytes = 0;
  size_t base = (size_t)row * p;
  for (int q = threadIdx.x; q < p; q += blockDim.x) {
    long long g = in.counts[2 * (size_t)p + q];
    frames += g;
    bytes += g * (long long)in.nbytes[q];
    out.coverage[base + q] = in.counts[q];
    out.delivered[base + q] = in.counts[(size_t)p + q];
  }
  frames = warp_sum(frames);
  bytes = warp_sum(bytes);
  if ((threadIdx.x & (kWarp - 1)) == 0) {
    if (frames) atomicAdd(&fold[0], (unsigned long long)frames);
    if (bytes) atomicAdd(&fold[1], (unsigned long long)bytes);
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    volatile unsigned long long* acc = in.acc;
    out.up_nodes[row] = (int32_t)acc[kUp];
    out.bcast_bytes[row] = __ll2float_rn((long long)acc[kBcastBytes]);
    out.bcast_frames[row] = (int32_t)acc[kBcastFrames];
    out.bcast_dropped[row] = (int32_t)acc[kBcastDropped];
    out.bcast_cut[row] = (int32_t)acc[kBcastCut];
    out.sync_bytes[row] = __ll2float_rn((long long)fold[1]);
    out.sync_frames[row] = (int32_t)fold[0];
    out.sync_sessions[row] = (int32_t)acc[kSessions];
    out.sync_refused[row] = (int32_t)acc[kSyncRefused];
    out.swim_suspect[row] = (int32_t)acc[kSuspect];
    out.swim_down[row] = (int32_t)acc[kDown];
    out.crashes[row] = (int32_t)acc[kCrashes];
    out.wipes[row] = (int32_t)acc[kWipes];
    out.gap_overflow[row] = *in.n_overflow;
    for (int j = 0; j < kSlots; ++j) acc[j] = 0ull;
  }
  for (size_t i = threadIdx.x; i < 3 * (size_t)p; i += blockDim.x)
    in.counts[i] = 0;
}

}  // namespace

extern "C" int corro_trace_row(
    const void* alive, const void* pid, const void* pkey, const void* view,
    const void* rf_alive, const void* rf_wipe, const void* sync_ok,
    const void* n_overflow, const void* nbytes, void* acc, void* counts,
    void* coverage, void* delivered, void* up_nodes, void* bcast_bytes,
    void* bcast_frames, void* bcast_dropped, void* bcast_cut,
    void* sync_bytes, void* sync_frames, void* sync_sessions,
    void* sync_refused, void* swim_suspect, void* swim_down, void* crashes,
    void* wipes, void* gap_overflow, int n, int cells, int swim, int es,
    int p, int row, void* stream) {
  if (n <= 0 || p <= 0 || es < 0 || cells < 0 || row < 0 || swim < 0 ||
      swim > 2 || (swim == 1 && (pid == nullptr || pkey == nullptr)) ||
      (swim == 2 && view == nullptr) || (rf_alive == nullptr) != (rf_wipe == nullptr))
    return (int)cudaErrorInvalidValue;
  Inputs in{(const uint8_t*)alive, (const int32_t*)pid, (const int32_t*)pkey,
            (const int8_t*)view, (const int8_t*)rf_alive, (const bool*)rf_wipe,
            (const bool*)sync_ok, (const int32_t*)n_overflow,
            (const int32_t*)nbytes, (unsigned long long*)acc,
            (int32_t*)counts};
  Channels out{(int32_t*)coverage, (int32_t*)delivered, (int32_t*)up_nodes,
               (float*)bcast_bytes, (int32_t*)bcast_frames,
               (int32_t*)bcast_dropped, (int32_t*)bcast_cut,
               (float*)sync_bytes, (int32_t*)sync_frames,
               (int32_t*)sync_sessions, (int32_t*)sync_refused,
               (int32_t*)swim_suspect, (int32_t*)swim_down,
               (int32_t*)crashes, (int32_t*)wipes, (int32_t*)gap_overflow};
  long long work = n;
  if (swim && cells > work) work = cells;
  if (es > work) work = es;
  // about eight elements a thread, at most four blocks an SM
  long long blocks = (work + 8LL * kThreads - 1) / (8LL * kThreads);
  if (blocks > 528) blocks = 528;
  if (blocks < 1) blocks = 1;
  trace_row_kernel<<<(unsigned)blocks, kThreads, 0, (cudaStream_t)stream>>>(
      in, out, n, swim ? cells : 0, swim, es, p, row);
  return (int)cudaGetLastError();
}
