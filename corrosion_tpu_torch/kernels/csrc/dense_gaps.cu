// K14: the dense round's bookkeeping refresh and convergence record —
// heads, the K gap slots and their overflow, the convergence stamps and
// the run's exit flag, straight from the u8 have rows.
//
// Replaces corrosion_tpu/sim/gaps.py:64 _extract_gaps_dense (and, for
// V <= 32, gaps.py:137 _extract_gaps_words: the same slots) with what
// round.py:88 round_step feeds it and does after it (round.py:162-197:
// state.touched_versions, version_heads, complete_versions,
// version_active, the coverage and convergence stamps) and round.py:313
// _done, the dense loop's exit predicate (round.py:313-317).  The plain
// version is sim/round.py dense_record_plain, the JAX composition.
//
// Payload q is chunk c of version v (1-based) of actor a,
// q = ((v-1) * A + a) * C + c.  Two launches:
//   rows    one warp per node (a block's 8 warps take 64 nodes in turn),
//           a lane per actor (a = lane, lane + 32, ...).  The lane walks
//           v = 1..V once: touched = any of the C chunk bytes, comp = all
//           of them.  A run of untouched versions closed by a touched one
//           is a gap (missing = untouched below the head, and the head is
//           the last touched version); runs 1..K fill the slots, later
//           ones only count, and with more than K runs slot K-1's end
//           becomes the last missing version (the overflow clamp).  The
//           lane writes heads and its K lo/hi slots, counts overflowed
//           rows (ballot, one atomicAdd per warp; the wrapper divides in
//           f32 as the plain version does), and ANDs its comp bits of up
//           nodes into the block's shared version_done words (one per 32
//           versions of an actor).  node_done = up and every (a, v) is
//           complete or inactive (act = some chunk injected), a warp
//           vote; converged_at is stamped with t when unset, node_done
//           holds and every payload was injected by t.  The block's
//           partial row is its version_done words and a last entry
//           ANDing "settled" (converged or not up) over its nodes.
//   finish  one block: ANDs the partial rows, stamps coverage_at[q] with
//           t where unset and its version is complete on every up node
//           and active, and writes the done flag: every payload
//           injected by t + 1 and every node settled.
// AND and add are order-free, so the atomics leave the result
// deterministic.
//
// The fault loop's exit mode (corrosion_tpu/sim/faults.py:748 _all_have
// with :801 _done, the dense loop of :797-842): a node is settled when
// it is down or holds every active version FRESH from its have row —
// the same warp vote as node_done without the up gate, not the sticky
// converged_at, so a wipe after convergence un-settles the node — and
// the flag also needs t + 1 >= the plan's horizon (horizon < 0: the
// plain mode).  The stamps are the same in both modes.
//
// Bound on the H100: bytes — the have rows once (N*P), heads and lo/hi
// out (N*A*(1 + 2K)*4), converged_at in and out, coverage_at in and out.
// Design: a lane's C chunk bytes of version v are contiguous and the
// warp's lanes read adjacent groups, so a node's row streams through L1
// once; a slot is written when its run closes (runs past K only count),
// the unfilled slots are zeroed at the end, and only slot K-1's overflow
// end waits for the walk to finish — so no register array caps K.

// The lane entries (corro_dense_gaps_rows_lanes, _finish_lanes) run
// both passes over a seed ensemble's lanes (B16, dense half:
// corrosion_tpu/campaign/ensemble.py:114 and :187 vmap the dense round,
// whose while_loop keeps a done flag a lane) as a grid dimension:
// blockIdx.y is the lane, whose have, injected, alive, stamps, heads,
// gap slots, overflow count, partial rows and done flag are its slots of
// the [K, ...] tensors, offset in 64 bits; the finish is one block a
// lane.  The payload rounds are shared.  In the exit mode (the dense
// fault loop on lanes, corrosion_tpu/sim/faults.py:797-842 under the
// same vmap; counted as dense_gaps_exit_lanes) each lane's flag is its
// own fresh completeness over its up nodes and t + 1 >= horizon, so a
// lane's wipe after its convergence un-settles that lane alone.  Bound:
// K times the solo bound.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kWarp = 32;
constexpr int kWarps = 8;
constexpr uint32_t kOnes = 0xFFFFFFFFu;

__device__ __forceinline__ bool version_act(const uint8_t* __restrict__ inj,
                                            int v, int a, int a_writers,
                                            int c_chunks) {
  const uint8_t* grp = inj + ((size_t)(v - 1) * a_writers + a) * c_chunks;
  bool any = false;
  for (int c = 0; c < c_chunks; ++c) any |= grp[c] > 0;
  return any;
}

__global__ void dense_gaps_rows_kernel(
    const uint8_t* __restrict__ have, const uint8_t* __restrict__ injected,
    const uint8_t* __restrict__ alive, const int32_t* __restrict__ round_of,
    const int32_t* __restrict__ converged_in, int32_t* __restrict__ heads,
    int32_t* __restrict__ gap_lo, int32_t* __restrict__ gap_hi,
    int32_t* __restrict__ overflow_count,
    int32_t* __restrict__ converged_out, uint32_t* __restrict__ partial,
    int n, int p, int a_writers, int v_versions, int c_chunks, int k_slots,
    int t, int rows_per_block, int exit_mode) {
  extern __shared__ uint32_t col[];  // [A * VW + 1]
  int vw = (v_versions + 31) / 32;
  int width = a_writers * vw;
  {
    // the lane's slices (lane 0 on the solo entry)
    const size_t lane = blockIdx.y;
    const size_t adverts = (size_t)n * a_writers;
    have += lane * (size_t)n * p;
    injected += lane * p;
    alive += lane * n;
    converged_in += lane * n;
    converged_out += lane * n;
    heads += lane * adverts;
    gap_lo += lane * adverts * k_slots;
    gap_hi += lane * adverts * k_slots;
    overflow_count += lane;
    partial += lane * gridDim.x * (size_t)(width + 1);
  }
  for (int i = threadIdx.x; i <= width; i += blockDim.x) col[i] = kOnes;
  bool injected_by_t = true;
  for (int q = threadIdx.x; q < p; q += blockDim.x) {
    injected_by_t &= round_of[q] <= t;
  }
  int all_injected = __syncthreads_and(injected_by_t);

  int warp = threadIdx.x / kWarp;
  int lane = threadIdx.x & (kWarp - 1);
  bool settled_all = true;
  int overflowed = 0;
  for (int r = warp; r < rows_per_block; r += kWarps) {
    int node = blockIdx.x * rows_per_block + r;
    if (node >= n) break;  // whole warps leave together
    bool up = alive[node] == 0;
    const uint8_t* row = have + (size_t)node * p;
    bool node_ok = true;
    for (int a = lane; a < a_writers; a += kWarp) {
      size_t na = (size_t)node * a_writers + a;
      int32_t* lo = gap_lo + na * k_slots;
      int32_t* hi = gap_hi + na * k_slots;
      int head = 0, pending = 0, runs = 0, last_missing = 0;
      uint32_t done_word = kOnes;
      for (int v = 1; v <= v_versions; ++v) {
        const uint8_t* grp =
            row + ((size_t)(v - 1) * a_writers + a) * c_chunks;
        bool touched = false, comp = true;
        for (int c = 0; c < c_chunks; ++c) {
          bool held = grp[c] > 0;
          touched |= held;
          comp &= held;
        }
        if (touched) {
          if (pending > 0) {  // the untouched run [pending, v-1] is a gap
            if (runs < k_slots) {
              lo[runs] = pending;
              hi[runs] = v - 1;
            }
            ++runs;
            last_missing = v - 1;
            pending = 0;
          }
          head = v;
        } else if (pending == 0) {
          pending = v;
        }
        bool act = version_act(injected, v, a, a_writers, c_chunks);
        node_ok &= comp || !act;
        if (!comp) done_word &= ~(1u << ((v - 1) & 31));
        if ((v & 31) == 0 || v == v_versions) {
          if (up && done_word != kOnes) {
            atomicAnd(&col[a * vw + (v - 1) / 32], done_word);
          }
          done_word = kOnes;
        }
      }
      for (int k = runs; k < k_slots; ++k) lo[k] = hi[k] = 0;
      bool overflow = runs > k_slots;
      if (overflow) hi[k_slots - 1] = last_missing;
      overflowed += overflow;
      heads[na] = head;
    }
    bool node_all = __all_sync(0xFFFFFFFFu, node_ok);
    bool node_done = node_all && up;
    if (lane == 0) {
      int32_t conv = converged_in[node];
      if (conv < 0 && node_done && all_injected) conv = t;
      converged_out[node] = conv;
      // the exit mode settles on the fresh completeness, not the stamp
      settled_all &= (exit_mode ? node_all : conv >= 0) || !up;
    }
  }
  for (int d = 16; d > 0; d >>= 1) {
    overflowed += __shfl_down_sync(0xFFFFFFFFu, overflowed, d);
  }
  if (lane == 0 && overflowed) atomicAdd(overflow_count, overflowed);
  int block_settled = __syncthreads_and(settled_all);
  uint32_t* out = partial + (size_t)blockIdx.x * (width + 1);
  for (int i = threadIdx.x; i < width; i += blockDim.x) out[i] = col[i];
  if (threadIdx.x == 0) out[width] = block_settled ? kOnes : 0u;
}

__global__ void dense_gaps_finish_kernel(
    const uint32_t* __restrict__ partial, const uint8_t* __restrict__ injected,
    const int32_t* __restrict__ round_of,
    const int32_t* __restrict__ coverage_in,
    int32_t* __restrict__ coverage_out, bool* __restrict__ done,
    int n_blocks, int p, int a_writers, int v_versions, int c_chunks, int t,
    int horizon) {
  extern __shared__ uint32_t col[];  // [A * VW + 1]
  int vw = (v_versions + 31) / 32;
  int width = a_writers * vw;
  {
    // the lane's slices (lane 0 on the solo entry)
    const size_t lane = blockIdx.y;
    partial += lane * (size_t)n_blocks * (width + 1);
    injected += lane * p;
    coverage_in += lane * p;
    coverage_out += lane * p;
    done += lane;
  }
  for (int i = threadIdx.x; i <= width; i += blockDim.x) col[i] = kOnes;
  __syncthreads();
  size_t total = (size_t)n_blocks * (width + 1);
  for (size_t i = threadIdx.x; i < total; i += blockDim.x) {
    uint32_t x = partial[i];
    if (x != kOnes) atomicAnd(&col[i % (width + 1)], x);
  }
  bool injected_next = true;
  for (int q = threadIdx.x; q < p; q += blockDim.x) {
    injected_next &= round_of[q] <= t + 1;
  }
  int all_injected_next = __syncthreads_and(injected_next);
  int per_version = a_writers * c_chunks;
  for (int q = threadIdx.x; q < p; q += blockDim.x) {
    int v = q / per_version + 1;
    int a = (q / c_chunks) % a_writers;
    bool version_done =
        ((col[a * vw + (v - 1) / 32] >> ((v - 1) & 31)) & 1u) &&
        version_act(injected, v, a, a_writers, c_chunks);
    int32_t cov = coverage_in[q];
    coverage_out[q] = (cov < 0 && version_done) ? t : cov;
  }
  if (threadIdx.x == 0)
    done[0] = all_injected_next && col[width] == kOnes &&
              (horizon < 0 || t + 1 >= horizon);
}

bool geometry_ok(int p, int a_writers, int v_versions, int c_chunks,
                 int k_slots) {
  return p > 0 && a_writers > 0 && v_versions > 0 && c_chunks > 0 &&
         k_slots > 0 &&
         (size_t)a_writers * v_versions * c_chunks == (size_t)p &&
         // the shared version_done words must fit in 48 KiB
         ((size_t)a_writers * ((v_versions + 31) / 32) + 1) * 4 <= 48 * 1024;
}

}  // namespace

extern "C" int corro_dense_gaps_rows(
    const void* have, const void* injected, const void* alive,
    const void* round_of, const void* converged_in, void* heads, void* gap_lo,
    void* gap_hi, void* overflow_count, void* converged_out, void* partial,
    int n, int p, int a_writers, int v_versions, int c_chunks, int k_slots,
    int t, int rows_per_block, int exit_mode, void* stream) {
  if (n <= 0 || rows_per_block <= 0 ||
      !geometry_ok(p, a_writers, v_versions, c_chunks, k_slots))
    return (int)cudaErrorInvalidValue;
  unsigned blocks = (unsigned)((n + rows_per_block - 1) / rows_per_block);
  size_t smem =
      ((size_t)a_writers * ((v_versions + 31) / 32) + 1) * sizeof(uint32_t);
  dense_gaps_rows_kernel<<<blocks, kWarps * kWarp, smem,
                           (cudaStream_t)stream>>>(
      (const uint8_t*)have, (const uint8_t*)injected, (const uint8_t*)alive,
      (const int32_t*)round_of, (const int32_t*)converged_in,
      (int32_t*)heads, (int32_t*)gap_lo, (int32_t*)gap_hi,
      (int32_t*)overflow_count, (int32_t*)converged_out, (uint32_t*)partial,
      n, p, a_writers, v_versions, c_chunks, k_slots, t, rows_per_block,
      exit_mode);
  return (int)cudaGetLastError();
}

extern "C" int corro_dense_gaps_finish(const void* partial,
                                       const void* injected,
                                       const void* round_of,
                                       const void* coverage_in,
                                       void* coverage_out, void* done,
                                       int n_blocks, int p, int a_writers,
                                       int v_versions, int c_chunks, int t,
                                       int horizon, void* stream) {
  if (n_blocks <= 0 || !geometry_ok(p, a_writers, v_versions, c_chunks, 1))
    return (int)cudaErrorInvalidValue;
  size_t smem =
      ((size_t)a_writers * ((v_versions + 31) / 32) + 1) * sizeof(uint32_t);
  dense_gaps_finish_kernel<<<1, 256, smem, (cudaStream_t)stream>>>(
      (const uint32_t*)partial, (const uint8_t*)injected,
      (const int32_t*)round_of, (const int32_t*)coverage_in,
      (int32_t*)coverage_out, (bool*)done, n_blocks, p, a_writers,
      v_versions, c_chunks, t, horizon);
  return (int)cudaGetLastError();
}

// The lane entries: the solo entries' arguments with every per-node
// tensor [lanes, ...], `injected` and the coverage stamps [lanes, P], the
// overflow counts and done flags [lanes], the partial rows [lanes,
// blocks, A * VW + 1], then `lanes`.
extern "C" int corro_dense_gaps_rows_lanes(
    const void* have, const void* injected, const void* alive,
    const void* round_of, const void* converged_in, void* heads, void* gap_lo,
    void* gap_hi, void* overflow_count, void* converged_out, void* partial,
    int n, int p, int a_writers, int v_versions, int c_chunks, int k_slots,
    int t, int rows_per_block, int exit_mode, int lanes, void* stream) {
  if (n <= 0 || rows_per_block <= 0 || lanes <= 0 || lanes > 65535 ||
      !geometry_ok(p, a_writers, v_versions, c_chunks, k_slots))
    return (int)cudaErrorInvalidValue;
  unsigned blocks = (unsigned)((n + rows_per_block - 1) / rows_per_block);
  size_t smem =
      ((size_t)a_writers * ((v_versions + 31) / 32) + 1) * sizeof(uint32_t);
  dense_gaps_rows_kernel<<<dim3(blocks, lanes), kWarps * kWarp, smem,
                           (cudaStream_t)stream>>>(
      (const uint8_t*)have, (const uint8_t*)injected, (const uint8_t*)alive,
      (const int32_t*)round_of, (const int32_t*)converged_in,
      (int32_t*)heads, (int32_t*)gap_lo, (int32_t*)gap_hi,
      (int32_t*)overflow_count, (int32_t*)converged_out, (uint32_t*)partial,
      n, p, a_writers, v_versions, c_chunks, k_slots, t, rows_per_block,
      exit_mode);
  return (int)cudaGetLastError();
}

extern "C" int corro_dense_gaps_finish_lanes(
    const void* partial, const void* injected, const void* round_of,
    const void* coverage_in, void* coverage_out, void* done, int n_blocks,
    int p, int a_writers, int v_versions, int c_chunks, int t, int horizon,
    int lanes, void* stream) {
  if (n_blocks <= 0 || lanes <= 0 || lanes > 65535 ||
      !geometry_ok(p, a_writers, v_versions, c_chunks, 1))
    return (int)cudaErrorInvalidValue;
  size_t smem =
      ((size_t)a_writers * ((v_versions + 31) / 32) + 1) * sizeof(uint32_t);
  dense_gaps_finish_kernel<<<dim3(1, lanes), 256, smem,
                             (cudaStream_t)stream>>>(
      (const uint32_t*)partial, (const uint8_t*)injected,
      (const int32_t*)round_of, (const int32_t*)coverage_in,
      (int32_t*)coverage_out, (bool*)done, n_blocks, p, a_writers,
      v_versions, c_chunks, t, horizon);
  return (int)cudaGetLastError();
}
