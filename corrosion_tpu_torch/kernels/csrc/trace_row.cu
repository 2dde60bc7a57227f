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
// The lane form (corro_trace_row_lanes) writes row `row` of every lane
// of a seed ensemble in one launch (corrosion_tpu/campaign/ensemble.py:
// 114 vmaps record_round): blockIdx.y is the lane, whose alive, beliefs
// (pid and pkey [N, M], or view [N, N]), sync edges, overflow count,
// accumulators acc [kSlots] (its own ticket among them), count rows
// [3, P] and channels ([R, P] and [R]) are its slices of [K, ...]
// tensors, offset in 64 bits; the fault slice's crashes and wipes
// (rf_alive, rf_wipe) and the payload sizes are shared, as the plan's
// schedule is.  Each lane's blocks take their own ticket, so the last
// block of lane k writes lane k's row and zeroes lane k's accumulators
// only; lane k is the solo entry on lane k's inputs.  Bound: bytes, K
// times the solo entry's — 8 x 51 MB of member tables at the 8-lane
// dense fault storm, about 0.122 ms.
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
                                 int swim, int es, int p, int row,
                                 int rows) {
  {
    // the lane's slices (lane 0 on the solo entry)
    const size_t lane = blockIdx.y;
    in.alive += lane * n;
    if (in.pid != nullptr) {
      in.pid += lane * (size_t)cells;
      in.pkey += lane * (size_t)cells;
    }
    if (in.view != nullptr) in.view += lane * (size_t)cells;
    in.sync_ok += lane * (size_t)es;
    in.n_overflow += lane;
    in.acc += lane * kSlots;
    in.counts += lane * 3 * (size_t)p;
    const size_t wide = lane * (size_t)rows * p, narrow = lane * rows;
    out.coverage += wide;
    out.delivered += wide;
    out.up_nodes += narrow;
    out.bcast_bytes += narrow;
    out.bcast_frames += narrow;
    out.bcast_dropped += narrow;
    out.bcast_cut += narrow;
    out.sync_bytes += narrow;
    out.sync_frames += narrow;
    out.sync_sessions += narrow;
    out.sync_refused += narrow;
    out.swim_suspect += narrow;
    out.swim_down += narrow;
    out.crashes += narrow;
    out.wipes += narrow;
    out.gap_overflow += narrow;
  }
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

namespace {

int launch_row(const void* alive, const void* pid, const void* pkey,
               const void* view, const void* rf_alive, const void* rf_wipe,
               const void* sync_ok, const void* n_overflow,
               const void* nbytes, void* acc, void* counts, void* coverage,
               void* delivered, void* up_nodes, void* bcast_bytes,
               void* bcast_frames, void* bcast_dropped, void* bcast_cut,
               void* sync_bytes, void* sync_frames, void* sync_sessions,
               void* sync_refused, void* swim_suspect, void* swim_down,
               void* crashes, void* wipes, void* gap_overflow, int n,
               int cells, int swim, int es, int p, int row, int rows,
               int lanes, void* stream) {
  if (n <= 0 || p <= 0 || es < 0 || cells < 0 || row < 0 || swim < 0 ||
      swim > 2 || (swim == 1 && (pid == nullptr || pkey == nullptr)) ||
      (swim == 2 && view == nullptr) ||
      (rf_alive == nullptr) != (rf_wipe == nullptr) || lanes <= 0 ||
      lanes > 65535 || (lanes > 1 && row >= rows))
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
  // about eight elements a thread, at most four blocks an SM (a lane)
  long long blocks = (work + 8LL * kThreads - 1) / (8LL * kThreads);
  if (blocks > 528) blocks = 528;
  if (blocks < 1) blocks = 1;
  trace_row_kernel<<<dim3((unsigned)blocks, (unsigned)lanes), kThreads, 0,
                     (cudaStream_t)stream>>>(
      in, out, n, swim ? cells : 0, swim, es, p, row, rows);
  return (int)cudaGetLastError();
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
  return launch_row(alive, pid, pkey, view, rf_alive, rf_wipe, sync_ok,
                    n_overflow, nbytes, acc, counts, coverage, delivered,
                    up_nodes, bcast_bytes, bcast_frames, bcast_dropped,
                    bcast_cut, sync_bytes, sync_frames, sync_sessions,
                    sync_refused, swim_suspect, swim_down, crashes, wipes,
                    gap_overflow, n, cells, swim, es, p, row, 0, 1, stream);
}

// The lane form: the solo entry's pointers with every per-lane tensor
// [lanes, ...] (alive [lanes, N], pid/pkey [lanes, N, M] or view
// [lanes, N, N], sync_ok [lanes, Es], n_overflow [lanes], acc
// [lanes, kSlots], counts [lanes, 3, P], the channels [lanes, R, P] and
// [lanes, R]) and the shared rf_alive, rf_wipe [N] and nbytes [P]; `n`,
// `cells` and `es` are one lane's, `rows` is R.
extern "C" int corro_trace_row_lanes(
    const void* alive, const void* pid, const void* pkey, const void* view,
    const void* rf_alive, const void* rf_wipe, const void* sync_ok,
    const void* n_overflow, const void* nbytes, void* acc, void* counts,
    void* coverage, void* delivered, void* up_nodes, void* bcast_bytes,
    void* bcast_frames, void* bcast_dropped, void* bcast_cut,
    void* sync_bytes, void* sync_frames, void* sync_sessions,
    void* sync_refused, void* swim_suspect, void* swim_down, void* crashes,
    void* wipes, void* gap_overflow, int n, int cells, int swim, int es,
    int p, int row, int rows, int lanes, void* stream) {
  return launch_row(alive, pid, pkey, view, rf_alive, rf_wipe, sync_ok,
                    n_overflow, nbytes, acc, counts, coverage, delivered,
                    up_nodes, bcast_bytes, bcast_frames, bcast_dropped,
                    bcast_cut, sync_bytes, sync_frames, sync_sessions,
                    sync_refused, swim_suspect, swim_down, crashes, wipes,
                    gap_overflow, n, cells, swim, es, p, row, rows, lanes,
                    stream);
}
