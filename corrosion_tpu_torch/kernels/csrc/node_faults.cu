// K11: a round's node faults, on the packed loop's slim state and carry
// (the word entry) and on the dense state (the dense entry).
//
// Replaces corrosion_tpu/sim/faults.py:703 apply_node_faults and
// corrosion_tpu/sim/packed.py:989 apply_carry_faults, which
// run_packed_faults (packed.py:1027) applies one after the other before
// every round, and which the dense fault loop (faults.py:797-842)
// applies alone on the dense state.  The plain versions are
// sim.faults.apply_node_faults_plain and sim.packed.apply_carry_faults.
//
// In place, for every node n:
//   - the alive override: alive[n] = ovr[n] where ovr[n] >= 0 (i8, -1
//     leaves the scenario's value);
//   - a wipe (crash-with-wipe restart) zeroes the node's payload rows —
//     the word entry its have words, its four relay planes and its row
//     in every slot of both word rings; the dense entry its u8 have and
//     relay rows and its row in every slot of both u8 rings [D, N, P] —
//     its heads and gap intervals, empties its member table (pid, pkey,
//     psince = -1), puts its full-view row back to the optimistic init
//     (view = 0, vinc = 0, suspect_since = -1; faults.py:729-734) and
//     empties its PeerSwap view row (pview = -1; faults.py:742-745), so
//     the rejoiner refills it through incoming swaps.
//     Rows without a wipe are not touched; jax selects every tensor
//     every round, with the same result.  The sync countdown and
//     backoff, the incarnation and the sticky convergence stamps survive
//     a wipe, as in jax, and so do other nodes' beliefs about the node.
//
// Bound on the H100: launch latency.  The override reads and writes 4
// bytes a node (400 KB at N = 100000, ~0.1 us of memory time); a wiped
// node's rows are ~2.4 KB at the packed storm's shapes, ~5 KB at the
// dense storm's (P = 512, D = 2), ~36 KB with a 4096-node full view and
// 64 B more for a PeerSwap view of 16 slots.
// Design: a block of 256 threads takes 256 nodes, applies their
// overrides and lists its wiped nodes in shared memory; then the whole
// block zeroes each listed node's rows, the threads on consecutive
// addresses, so a wide full-view row is not left to one thread.
//
// corro_node_faults_lanes is the word entry over the seed ensemble's
// lanes (B16, corrosion_tpu/campaign/ensemble.py:114, whose lanes share
// the plan's schedule unbatched — ensemble.py:147-158): blockIdx.y is
// the lane, whose alive row, carry and tables are its slices of the
// [K, ...] tensors; the round's overrides and wipes are read by every
// lane.  corro_node_faults_dense_lanes is the dense entry's lane form
// (the dense fault loop of faults.py:797-842 under the same vmap): the
// lanes' u8 have and relay rows, both u8 rings, heads, gaps, member
// tables, full views and PeerSwap views, the round's slice shared.
// Bound: launch latency, as the solo entries'.
//
// At the 1M tier (config_fault_storm_1m: N = 1 000 000, W = 16, D = 2)
// a wiped row's offsets (size_t)node * row < 1.6e7 and the rings'
// ((size_t)s * N + node) * W < 3.2e7 are size_t.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;

template <typename T>
__device__ __forceinline__ void fill_row(T* __restrict__ row, size_t len,
                                         T value) {
  for (size_t i = threadIdx.x; i < len; i += blockDim.x) row[i] = value;
}

// The tables every entry wipes: heads, gaps, the member table, the full
// view's row, the PeerSwap view's row (v slots; 0 without the sampler).
struct Tables {
  int32_t* heads;
  int32_t* gap_lo;
  int32_t* gap_hi;
  int32_t* pid;
  int32_t* pkey;
  int32_t* psince;
  int8_t* view;
  int32_t* vinc;
  int32_t* since;
  int32_t* pview;
  int a, ak, m, fv, v;
};

__device__ __forceinline__ void wipe_tables(const Tables& tb, int node) {
  fill_row(tb.heads + (size_t)node * tb.a, (size_t)tb.a, 0);
  fill_row(tb.gap_lo + (size_t)node * tb.ak, (size_t)tb.ak, 0);
  fill_row(tb.gap_hi + (size_t)node * tb.ak, (size_t)tb.ak, 0);
  fill_row(tb.pid + (size_t)node * tb.m, (size_t)tb.m, -1);
  fill_row(tb.pkey + (size_t)node * tb.m, (size_t)tb.m, -1);
  fill_row(tb.psince + (size_t)node * tb.m, (size_t)tb.m, -1);
  if (tb.fv > 0) {
    fill_row(tb.view + (size_t)node * tb.fv, (size_t)tb.fv, (int8_t)0);
    fill_row(tb.vinc + (size_t)node * tb.fv, (size_t)tb.fv, 0);
    fill_row(tb.since + (size_t)node * tb.fv, (size_t)tb.fv, -1);
  }
  if (tb.v > 0) fill_row(tb.pview + (size_t)node * tb.v, (size_t)tb.v, -1);
}

// The overrides of the block's nodes; returns how many of them are
// wiped, listed in `wiped` (shared).
__device__ __forceinline__ int override_and_list(
    const int8_t* __restrict__ ovr, const uint8_t* __restrict__ wipe,
    uint8_t* __restrict__ alive, int n, int* wiped, int* count) {
  if (threadIdx.x == 0) *count = 0;
  __syncthreads();
  int node = blockIdx.x * blockDim.x + threadIdx.x;
  if (node < n) {
    int8_t o = ovr[node];
    if (o >= 0) alive[node] = (uint8_t)o;
    if (wipe[node]) wiped[atomicAdd(count, 1)] = node;
  }
  __syncthreads();
  return *count;
}

// Payload rows of type T, `row` elements a node: `rows` [N, row] tensors
// and `rings` [D, N, row] tensors.
template <typename T, int kRows, int kRings>
struct Payload {
  T* rows[kRows];
  T* rings[kRings];
  size_t row;
  int d_slots, n;
};

template <typename T, int kRows, int kRings>
__device__ __forceinline__ void wipe_payload(
    const Payload<T, kRows, kRings>& pl, int node) {
#pragma unroll
  for (int r = 0; r < kRows; ++r)
    fill_row(pl.rows[r] + (size_t)node * pl.row, pl.row, (T)0);
  for (int s = 0; s < pl.d_slots; ++s) {
    size_t at = ((size_t)s * pl.n + node) * pl.row;
#pragma unroll
    for (int r = 0; r < kRings; ++r) fill_row(pl.rings[r] + at, pl.row, (T)0);
  }
}

template <typename T, int kRows, int kRings>
__global__ void node_faults_kernel(const int8_t* __restrict__ ovr,
                                   const uint8_t* __restrict__ wipe,
                                   uint8_t* __restrict__ alive,
                                   Payload<T, kRows, kRings> pl, Tables tb,
                                   int n) {
  __shared__ int wiped[kThreads];
  __shared__ int count;
  // the lane's rows (lane 0 on the solo entries); ovr and wipe are the
  // round's shared slice
  {
    const size_t lane = blockIdx.y;
    const size_t nn = (size_t)n;
    alive += lane * nn;
#pragma unroll
    for (int r = 0; r < kRows; ++r) pl.rows[r] += lane * nn * pl.row;
#pragma unroll
    for (int r = 0; r < kRings; ++r)
      pl.rings[r] += lane * pl.d_slots * nn * pl.row;
    tb.heads += lane * nn * tb.a;
    tb.gap_lo += lane * nn * tb.ak;
    tb.gap_hi += lane * nn * tb.ak;
    tb.pid += lane * nn * tb.m;
    tb.pkey += lane * nn * tb.m;
    tb.psince += lane * nn * tb.m;
    if (tb.fv > 0) {
      tb.view += lane * nn * tb.fv;
      tb.vinc += lane * nn * tb.fv;
      tb.since += lane * nn * tb.fv;
    }
    if (tb.v > 0) tb.pview += lane * nn * tb.v;
  }
  int k = override_and_list(ovr, wipe, alive, n, wiped, &count);
  for (int i = 0; i < k; ++i) {
    wipe_payload(pl, wiped[i]);
    wipe_tables(tb, wiped[i]);
  }
}

bool tables_ok(int a, int ak, int m, int fv, int v, const void* pview) {
  return a >= 0 && ak >= 0 && m >= 0 && fv >= 0 && v >= 0 &&
         (v == 0 || pview != nullptr);
}

unsigned blocks_for(int n) { return (unsigned)((n + kThreads - 1) / kThreads); }

}  // namespace

// The word entry: have and the four relay planes [N, W], both word
// rings [D, N, W].  `fv` is 0 without a full view (view, vinc and
// suspect_since may then be null), `v` 0 without a PeerSwap view (pview
// may then be null).
namespace {

int launch_words(const void* ovr, const void* wipe, void* alive, void* have,
                 void* r0, void* r1, void* r2, void* r3, void* inflight,
                 void* sync_buf, void* heads, void* gap_lo, void* gap_hi,
                 void* pid, void* pkey, void* psince, void* view, void* vinc,
                 void* since, void* pview, int n, int w, int d_slots, int a,
                 int ak, int m, int fv, int v, int lanes, void* stream) {
  if (n <= 0 || w < 0 || d_slots < 0 || !tables_ok(a, ak, m, fv, v, pview) ||
      (fv > 0 && fv != n) || lanes <= 0 || lanes > 65535)
    return (int)cudaErrorInvalidValue;
  Payload<uint32_t, 5, 2> pl{
      {(uint32_t*)have, (uint32_t*)r0, (uint32_t*)r1, (uint32_t*)r2,
       (uint32_t*)r3},
      {(uint32_t*)inflight, (uint32_t*)sync_buf},
      (size_t)w, d_slots, n};
  Tables tb{(int32_t*)heads, (int32_t*)gap_lo, (int32_t*)gap_hi,
            (int32_t*)pid,   (int32_t*)pkey,   (int32_t*)psince,
            (int8_t*)view,   (int32_t*)vinc,   (int32_t*)since,
            (int32_t*)pview, a,                ak,
            m,               fv,               v};
  node_faults_kernel<uint32_t, 5, 2>
      <<<dim3(blocks_for(n), lanes), kThreads, 0, (cudaStream_t)stream>>>(
          (const int8_t*)ovr, (const uint8_t*)wipe, (uint8_t*)alive, pl, tb,
          n);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int corro_node_faults(
    const void* ovr, const void* wipe, void* alive, void* have, void* r0,
    void* r1, void* r2, void* r3, void* inflight, void* sync_buf,
    void* heads, void* gap_lo, void* gap_hi, void* pid, void* pkey,
    void* psince, void* view, void* vinc, void* since, void* pview, int n,
    int w, int d_slots, int a, int ak, int m, int fv, int v, void* stream) {
  return launch_words(ovr, wipe, alive, have, r0, r1, r2, r3, inflight,
                      sync_buf, heads, gap_lo, gap_hi, pid, pkey, psince,
                      view, vinc, since, pview, n, w, d_slots, a, ak, m, fv,
                      v, 1, stream);
}

// The word entry's lane form: every per-node tensor [lanes, ...] (the
// rings [lanes, D, N, W]); `ovr` and `wipe` [N] are the shared round
// slice, applied to every lane.
extern "C" int corro_node_faults_lanes(
    const void* ovr, const void* wipe, void* alive, void* have, void* r0,
    void* r1, void* r2, void* r3, void* inflight, void* sync_buf,
    void* heads, void* gap_lo, void* gap_hi, void* pid, void* pkey,
    void* psince, void* view, void* vinc, void* since, void* pview, int n,
    int w, int d_slots, int a, int ak, int m, int fv, int v, int lanes,
    void* stream) {
  return launch_words(ovr, wipe, alive, have, r0, r1, r2, r3, inflight,
                      sync_buf, heads, gap_lo, gap_hi, pid, pkey, psince,
                      view, vinc, since, pview, n, w, d_slots, a, ak, m, fv,
                      v, lanes, stream);
}

namespace {

int launch_dense(const void* ovr, const void* wipe, void* alive, void* have,
                 void* relay, void* inflight, void* sync_inflight,
                 void* heads, void* gap_lo, void* gap_hi, void* pid,
                 void* pkey, void* psince, void* view, void* vinc,
                 void* since, void* pview, int n, int p, int d_slots, int a,
                 int ak, int m, int fv, int v, int lanes, void* stream) {
  if (n <= 0 || p < 0 || d_slots < 0 || !tables_ok(a, ak, m, fv, v, pview) ||
      (fv > 0 && fv != n) || lanes <= 0 || lanes > 65535)
    return (int)cudaErrorInvalidValue;
  Payload<uint8_t, 2, 2> pl{{(uint8_t*)have, (uint8_t*)relay},
                            {(uint8_t*)inflight, (uint8_t*)sync_inflight},
                            (size_t)p,
                            d_slots,
                            n};
  Tables tb{(int32_t*)heads, (int32_t*)gap_lo, (int32_t*)gap_hi,
            (int32_t*)pid,   (int32_t*)pkey,   (int32_t*)psince,
            (int8_t*)view,   (int32_t*)vinc,   (int32_t*)since,
            (int32_t*)pview, a,                ak,
            m,               fv,               v};
  node_faults_kernel<uint8_t, 2, 2>
      <<<dim3(blocks_for(n), lanes), kThreads, 0, (cudaStream_t)stream>>>(
          (const int8_t*)ovr, (const uint8_t*)wipe, (uint8_t*)alive, pl, tb,
          n);
  return (int)cudaGetLastError();
}

}  // namespace

// The dense entry: u8 have and relay rows [N, P], both u8 rings
// [D, N, P].
extern "C" int corro_node_faults_dense(
    const void* ovr, const void* wipe, void* alive, void* have, void* relay,
    void* inflight, void* sync_inflight, void* heads, void* gap_lo,
    void* gap_hi, void* pid, void* pkey, void* psince, void* view,
    void* vinc, void* since, void* pview, int n, int p, int d_slots, int a,
    int ak, int m, int fv, int v, void* stream) {
  return launch_dense(ovr, wipe, alive, have, relay, inflight, sync_inflight,
                      heads, gap_lo, gap_hi, pid, pkey, psince, view, vinc,
                      since, pview, n, p, d_slots, a, ak, m, fv, v, 1,
                      stream);
}

// The dense entry's lane form: every per-node tensor [lanes, ...] (the
// u8 rings [lanes, D, N, P], the full view [lanes, N, N] when fv > 0);
// `ovr` and `wipe` [N] are the shared round slice, applied to every
// lane.
extern "C" int corro_node_faults_dense_lanes(
    const void* ovr, const void* wipe, void* alive, void* have, void* relay,
    void* inflight, void* sync_inflight, void* heads, void* gap_lo,
    void* gap_hi, void* pid, void* pkey, void* psince, void* view,
    void* vinc, void* since, void* pview, int n, int p, int d_slots, int a,
    int ak, int m, int fv, int v, int lanes, void* stream) {
  return launch_dense(ovr, wipe, alive, have, relay, inflight, sync_inflight,
                      heads, gap_lo, gap_hi, pid, pkey, psince, view, vinc,
                      since, pview, n, p, d_slots, a, ak, m, fv, v, lanes,
                      stream);
}
