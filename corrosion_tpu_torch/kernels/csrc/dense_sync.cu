// K13: the dense sync pull — per-edge needs, the sync byte budget, and
// the OR into the sync ring's slot t + 1.
//
// Replaces the per-edge half of corrosion_tpu/sim/sync.py:122 sync_step:
// sync.py:71 edge_needs with sync.py:50 node_sync_masks (the three need
// classes, sync.py:50-119), the budget of :193-204
// (state.budget_prefix_mask per edge row), the fold into the ring slot
// (:232-237) and the fruitful flag (:251).  The plain version is
// sim/sync.py sync_pull_dense_plain, which composes the JAX functions.
// The peer draw, the edge mask `ok`, the backoff and the re-arm stay
// outside.
//
// One warp per puller n, the payloads 32 at a time (payload q is chunk
// c of version v of actor a, q = ((v-1) * A + a) * C + c).  For a row r
// and payload q the lane derives what the row advertises:
//   miss(r)    v lies in one of r's K gap slots [lo, hi] (lo > 0);
//   below(r)   v <= heads[r, a];
//   comp(r)    every chunk of (a, v) is held by r;
//   haves(r)   below & !miss & comp;  partial(r)  below & !miss & !comp.
// For each of the puller's S edges (server d, ok):
//   wanted = miss(n) & haves(d) | partial(n) & (haves(d) | partial(d))
//            | v > heads[n, a] & v <= heads[d, a]
//   need   = wanted & have[d, q] & !have[n, q]
// then the edge's oldest-first budget: a warp inclusive scan of the
// needed sizes with an int64 running sum per edge (exact, as JAX's i32
// and two-lane cumsums are for sizes <= 64 KiB), granted = need & prefix
// <= budget (budget < 0: unmetered).  The lane ORs its edges' grants,
// stores 1 into slot[n, q] where any edge granted (the slot holds 0/1,
// so JAX's max is that store) and the warp ballots the fruitful flag.
//
// With the flight recorder on, the kernel also adds each payload's
// grant count (edges that granted it, corrosion_tpu/sim/sync.py:286
// `jnp.sum(granted, axis=0)`) into the i32 [P] row `counts`: every lane
// knows how many of its row's S edges granted its payload, the block
// sums its rows' counts in shared memory (P ints) and adds once per
// payload — per-cell global atomics would serialize.  A null `counts`
// (telemetry off) skips it.
//
// Bound on the H100: bytes — have rows of the puller and its S servers
// (S + 1 rows of P bytes), their heads and gap rows, nbytes, the slot row
// written where granted, the flag.  Design: the puller's side is derived
// once per chunk and reused for all S edges; a row's comp bit reads its C
// chunk bytes, which L1 serves after the first lane; the K gap slots
// are scanned from the (cached) gap rows.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kWarp = 32;
constexpr int MAX_S = 16;

struct Advert {
  bool miss, comp, below;
};

__device__ __forceinline__ Advert advert(
    const uint8_t* __restrict__ have, const int32_t* __restrict__ heads,
    const int32_t* __restrict__ gap_lo, const int32_t* __restrict__ gap_hi,
    int row, int p, int a_writers, int c_chunks, int k_slots, int v, int a) {
  Advert r;
  size_t ra = (size_t)row * a_writers + a;
  r.below = v <= heads[ra];
  r.miss = false;
  for (int k = 0; k < k_slots; ++k) {
    int lo = gap_lo[ra * k_slots + k];
    int hi = gap_hi[ra * k_slots + k];
    r.miss |= lo > 0 && lo <= v && v <= hi;
  }
  const uint8_t* grp =
      have + (size_t)row * p + ((size_t)(v - 1) * a_writers + a) * c_chunks;
  r.comp = true;
  for (int c = 0; c < c_chunks; ++c) r.comp &= grp[c] > 0;
  return r;
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

// One puller's row: the warp's whole pass (whole warps take a row or
// none, so the shuffles see every lane).
__device__ __forceinline__ void pull_row(
    const uint8_t* __restrict__ have, const int32_t* __restrict__ heads,
    const int32_t* __restrict__ gap_lo, const int32_t* __restrict__ gap_hi,
    const int32_t* __restrict__ peers, const bool* __restrict__ ok,
    const int32_t* __restrict__ nbytes, uint8_t* __restrict__ slot_ring,
    bool* __restrict__ fruitful, int* block_counts, int row, int lane, int n,
    int p, int s_peers, int a_writers, int c_chunks, int k_slots,
    int budget) {
  long long running[MAX_S];
  for (int j = 0; j < MAX_S; ++j) running[j] = 0;
  bool any_grant = false;
  int per_version = a_writers * c_chunks;
  for (int base = 0; base < p; base += kWarp) {
    int q = base + lane;
    bool live = q < p;
    int v = live ? q / per_version + 1 : 1;
    int a = live ? (q / c_chunks) % a_writers : 0;
    Advert me = {false, false, false};
    bool have_me = true;
    if (live) {
      me = advert(have, heads, gap_lo, gap_hi, row, p, a_writers, c_chunks,
                  k_slots, v, a);
      have_me = have[(size_t)row * p + q] > 0;
    }
    bool partial_me = me.below && !me.miss && !me.comp;
    int head_me = live ? heads[(size_t)row * a_writers + a] : 0;
    bool pulled = false;
    int grants = 0;
    for (int j = 0; j < s_peers; ++j) {
      bool edge_ok = ok[(size_t)row * s_peers + j];
      int d = peers[(size_t)row * s_peers + j];
      bool need = false;
      if (edge_ok && live && !have_me && d >= 0 && d < n &&
          have[(size_t)d * p + q] > 0) {
        Advert srv = advert(have, heads, gap_lo, gap_hi, d, p, a_writers,
                            c_chunks, k_slots, v, a);
        bool haves_d = srv.below && !srv.miss && srv.comp;
        bool partial_d = srv.below && !srv.miss && !srv.comp;
        int head_d = heads[(size_t)d * a_writers + a];
        need = (me.miss && haves_d) || (partial_me && (haves_d || partial_d)) ||
               (v > head_me && v <= head_d);
      }
      bool granted = need;
      if (budget >= 0) {
        long long size = need ? (long long)nbytes[q] : 0;
        long long cum = running[j] + warp_inclusive_scan(size, lane);
        granted = need && cum <= (long long)budget;
        running[j] = __shfl_sync(0xFFFFFFFFu, cum, kWarp - 1);
      }
      pulled |= granted;
      grants += granted;
    }
    if (block_counts != nullptr && grants) atomicAdd(&block_counts[q], grants);
    if (pulled) slot_ring[(size_t)row * p + q] = 1;
    any_grant |= pulled;
  }
  bool f = __any_sync(0xFFFFFFFFu, any_grant);
  if (lane == 0) fruitful[row] = f;
}

__global__ void dense_sync_kernel(
    const uint8_t* __restrict__ have, const int32_t* __restrict__ heads,
    const int32_t* __restrict__ gap_lo, const int32_t* __restrict__ gap_hi,
    const int32_t* __restrict__ peers, const bool* __restrict__ ok,
    const int32_t* __restrict__ nbytes, uint8_t* __restrict__ slot_ring,
    bool* __restrict__ fruitful, int32_t* __restrict__ counts, int n, int p,
    int s_peers, int a_writers, int c_chunks, int k_slots, int budget) {
  extern __shared__ int block_counts[];  // [P] when counts is given
  int row = (int)(((size_t)blockIdx.x * blockDim.x + threadIdx.x) / kWarp);
  int lane = threadIdx.x & (kWarp - 1);
  if (counts != nullptr) {
    for (int q = threadIdx.x; q < p; q += blockDim.x) block_counts[q] = 0;
    __syncthreads();
  }
  if (row < n) pull_row(have, heads, gap_lo, gap_hi, peers, ok, nbytes,
                        slot_ring, fruitful,
                        counts != nullptr ? block_counts : nullptr, row, lane,
                        n, p, s_peers, a_writers, c_chunks, k_slots, budget);
  if (counts == nullptr) return;
  __syncthreads();
  for (int q = threadIdx.x; q < p; q += blockDim.x)
    if (block_counts[q]) atomicAdd(&counts[q], block_counts[q]);
}

}  // namespace

extern "C" int corro_dense_sync(const void* have, const void* heads,
                                const void* gap_lo, const void* gap_hi,
                                const void* peers, const void* ok,
                                const void* nbytes, void* slot_ring,
                                void* fruitful, void* counts, int n, int p,
                                int s_peers, int a_writers, int c_chunks,
                                int k_slots, int budget, void* stream) {
  if (n <= 0 || p <= 0 || s_peers <= 0 || s_peers > MAX_S || a_writers <= 0 ||
      c_chunks <= 0 || k_slots <= 0 || p % (a_writers * c_chunks))
    return (int)cudaErrorInvalidValue;
  int threads = 256;
  unsigned blocks = (unsigned)(((size_t)n * kWarp + threads - 1) / threads);
  size_t smem = counts != nullptr ? (size_t)p * sizeof(int) : 0;
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        dense_sync_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  dense_sync_kernel<<<blocks, threads, smem, (cudaStream_t)stream>>>(
      (const uint8_t*)have, (const int32_t*)heads, (const int32_t*)gap_lo,
      (const int32_t*)gap_hi, (const int32_t*)peers, (const bool*)ok,
      (const int32_t*)nbytes, (uint8_t*)slot_ring, (bool*)fruitful,
      (int32_t*)counts, n, p, s_peers, a_writers, c_chunks, k_slots, budget);
  return (int)cudaGetLastError();
}
