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
// The delay entry (the same launcher with session delays) takes the
// fault branch of sync.py:165-243: under a plan with delay factors edge
// e's grants land in ring slot (t + 1 + sdelay[e]) % D (sync.py:238-243,
// JAX's per-edge scatter-max; sdelay is K9's session delay, the slower
// direction's fault delay; refused sessions are already out of `ok`).
// The lane keeps one bit per ring slot its edges' grants reach and
// stores 1 into each — K3's delay-entry design on u8 rows; zero-delay
// edges land at t + 1 as in the plain entry, and `fruitful` covers every
// edge.
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

// The lane entry (corro_dense_sync_lanes) runs the pull over a seed
// ensemble's lanes (B16, dense half: corrosion_tpu/campaign/ensemble.py:114
// and :187 vmap the dense round) as a grid dimension: blockIdx.y is the
// lane, whose have, heads, gap rows, peers, ok, sync ring [D, N, P] and
// fruitful slices are its slots of the [K, ...] tensors, offset in 64
// bits; the peers are lane-local node ids and each edge's budget scan is
// the lane's own.  No session delays or grant counts on lanes.  Bound: K
// times the solo bound.

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
    const int32_t* __restrict__ nbytes, uint8_t* __restrict__ ring,
    bool* __restrict__ fruitful, int* block_counts,
    const int32_t* __restrict__ sdelay, int row, int lane, int n, int p,
    int s_peers, int a_writers, int c_chunks, int k_slots, int budget,
    int d_slots, int slot) {
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
    uint32_t slots = 0u;  // bit x: some edge's grant lands in ring slot x
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
      if (granted) {
        uint32_t sd = sdelay != nullptr
                          ? (uint32_t)sdelay[(size_t)row * s_peers + j]
                          : 0u;
        slots |= 1u << (((uint32_t)slot + sd) % (uint32_t)d_slots);
      }
      grants += granted;
    }
    if (block_counts != nullptr && grants) atomicAdd(&block_counts[q], grants);
    // the ring holds 0/1 and this (row, q) is the lane's own in every
    // slot: a store of 1 is JAX's max, without atomics
    for (uint32_t left = slots; left != 0u; left &= left - 1u) {
      int x = __ffs((int)left) - 1;
      ring[((size_t)x * n + row) * p + q] = 1;
    }
    any_grant |= slots != 0u;
  }
  bool f = __any_sync(0xFFFFFFFFu, any_grant);
  if (lane == 0) fruitful[row] = f;
}

__global__ void dense_sync_kernel(
    const uint8_t* __restrict__ have, const int32_t* __restrict__ heads,
    const int32_t* __restrict__ gap_lo, const int32_t* __restrict__ gap_hi,
    const int32_t* __restrict__ peers, const bool* __restrict__ ok,
    const int32_t* __restrict__ nbytes, uint8_t* __restrict__ ring,
    bool* __restrict__ fruitful, int32_t* __restrict__ counts,
    const int32_t* __restrict__ sdelay, int n, int p, int s_peers,
    int a_writers, int c_chunks, int k_slots, int budget, int d_slots,
    int slot) {
  extern __shared__ int block_counts[];  // [P] when counts is given
  {
    // the lane's slices (lane 0 on the solo entry; the lane entry takes
    // neither counts nor session delays)
    const size_t lane = blockIdx.y;
    const size_t cells = (size_t)n * p;
    const size_t adverts = (size_t)n * a_writers;
    have += lane * cells;
    heads += lane * adverts;
    gap_lo += lane * adverts * k_slots;
    gap_hi += lane * adverts * k_slots;
    peers += lane * (size_t)n * s_peers;
    ok += lane * (size_t)n * s_peers;
    ring += lane * (size_t)d_slots * cells;
    fruitful += lane * n;
  }
  int row = (int)(((size_t)blockIdx.x * blockDim.x + threadIdx.x) / kWarp);
  int lane = threadIdx.x & (kWarp - 1);
  if (counts != nullptr) {
    for (int q = threadIdx.x; q < p; q += blockDim.x) block_counts[q] = 0;
    __syncthreads();
  }
  if (row < n) pull_row(have, heads, gap_lo, gap_hi, peers, ok, nbytes, ring,
                        fruitful, counts != nullptr ? block_counts : nullptr,
                        sdelay, row, lane, n, p, s_peers, a_writers, c_chunks,
                        k_slots, budget, d_slots, slot);
  if (counts == nullptr) return;
  __syncthreads();
  for (int q = threadIdx.x; q < p; q += blockDim.x)
    if (block_counts[q]) atomicAdd(&counts[q], block_counts[q]);
}

}  // namespace

// `ring` is the sync ring [D, N, P] with the pull's slot t + 1 given as
// `slot`; without session delays (null `sdelay`) the caller may pass the
// slot's own [N, P] row with D = 1 and slot 0.
extern "C" int corro_dense_sync(const void* have, const void* heads,
                                const void* gap_lo, const void* gap_hi,
                                const void* peers, const void* ok,
                                const void* nbytes, void* ring,
                                void* fruitful, void* counts,
                                const void* sdelay, int n, int p,
                                int s_peers, int a_writers, int c_chunks,
                                int k_slots, int budget, int d_slots,
                                int slot, void* stream) {
  if (n <= 0 || p <= 0 || s_peers <= 0 || s_peers > MAX_S || a_writers <= 0 ||
      c_chunks <= 0 || k_slots <= 0 || p % (a_writers * c_chunks) ||
      d_slots <= 0 || d_slots > 32 || slot < 0 || slot >= d_slots)
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
      (const int32_t*)nbytes, (uint8_t*)ring, (bool*)fruitful,
      (int32_t*)counts, (const int32_t*)sdelay, n, p, s_peers, a_writers,
      c_chunks, k_slots, budget, d_slots, slot);
  return (int)cudaGetLastError();
}

// The lane entry: the solo entry's arguments with every per-node tensor
// [lanes, ...], the whole sync ring [lanes, D, N, P] and its slot t + 1,
// then `lanes`; no counts, no session delays.
extern "C" int corro_dense_sync_lanes(const void* have, const void* heads,
                                      const void* gap_lo, const void* gap_hi,
                                      const void* peers, const void* ok,
                                      const void* nbytes, void* ring,
                                      void* fruitful, int n, int p,
                                      int s_peers, int a_writers,
                                      int c_chunks, int k_slots, int budget,
                                      int d_slots, int slot, int lanes,
                                      void* stream) {
  if (n <= 0 || p <= 0 || s_peers <= 0 || s_peers > MAX_S || a_writers <= 0 ||
      c_chunks <= 0 || k_slots <= 0 || p % (a_writers * c_chunks) ||
      d_slots <= 0 || d_slots > 32 || slot < 0 || slot >= d_slots ||
      lanes <= 0 || lanes > 65535)
    return (int)cudaErrorInvalidValue;
  int threads = 256;
  unsigned blocks = (unsigned)(((size_t)n * kWarp + threads - 1) / threads);
  dense_sync_kernel<<<dim3(blocks, lanes), threads, 0,
                      (cudaStream_t)stream>>>(
      (const uint8_t*)have, (const int32_t*)heads, (const int32_t*)gap_lo,
      (const int32_t*)gap_hi, (const int32_t*)peers, (const bool*)ok,
      (const int32_t*)nbytes, (uint8_t*)ring, (bool*)fruitful, nullptr,
      nullptr, n, p, s_peers, a_writers, c_chunks, k_slots, budget, d_slots,
      slot);
  return (int)cudaGetLastError();
}
