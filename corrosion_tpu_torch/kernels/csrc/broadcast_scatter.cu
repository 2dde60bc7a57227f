// K2: broadcast fan-out scatter into the word delay ring, and the edge
// pass that builds the edge lists the packed round's scatters and pulls
// read.
//
// Replaces the ring scatter of corrosion_tpu/sim/packed.py:369
// broadcast_packed (packed.py:507-512: `inflight.at[flat_idx].max(sent)`
// on a dense u8 [D, N, P] ring, after unpacking the sending words).
//
// Edge e = (src = e / fanout, dst[e]).  For every word k of an ok edge
// the kernel ORs sending[src, k] into ring[slot[e], dst[e], k], with
// slot[e] = (t + delay[e]) % D.  JAX keeps the ring dense u8 only
// because XLA has no OR scatter (packed.py:285-293); the sent values
// are 0/1, so a u8 max per payload and a u32 OR per word set the same
// bits.  OR is order-independent, so the atomics keep the result
// deterministic whatever order the edges land in.
//
// Bound on the H100: bytes — the sending rows once (N*W*4), the edge
// arrays, the touched ring rows in and out.  Design (broadcast_rows_kernel):
// one thread per (node, word).  The thread loads sending[node, k] once
// and skips a zero word; then, for each of the node's F consecutive
// edges, it reads ok/dst/slot (the node's other threads read the same
// addresses: one transaction) and issues one atomicOr (a RED: the result
// is unused).  The sending rows are read once, not F times, and a warp's
// RED for one edge covers the destination row's words contiguously, one
// L2 request a row.  A thread per (node, run of 4 words) with one 128-bit
// load took twice as long on an H100 80GB HBM3 (0.0309 ms at the storm's
// shapes against 0.0143): its REDs split each destination row into four
// requests.
//
// The edge pass (edge_list_kernel; corro_edge_list, counted as edge_list
// and edge_list_lanes) turns a target table into those edge lists: the
// glue of corrosion_tpu/sim/packed.py:435-441 (with topology.py:183
// edge_alive and the flat branch of :157 edge_delay) and :1178-1184 (the
// sync's, with due[src]).  One thread per edge: dst = max(target, 0), ok
// = a real target, both ends in one partition group and up, not the
// sender and, given `due`, the sender due; given the flat delay (region,
// intra, inter), slot = (t + (region[src] == region[dst] ? intra :
// inter)) % D.  The group, alive and region tables (0.5 MB at the storm)
// stay in L2; no int64 index is formed.  Bound: bytes — the targets in,
// dst, ok and slot out, the tables once.  The lanes are folded into the
// rows: row r = lane * N + src, edge e = r * F + j, and a lane's targets
// index its own rows of group, alive and due (no edge crosses a lane).
//
// K10, the second entry point, runs broadcast_scatter_kernel — one thread
// per (edge, word), K2's body before its redesign, kept for the streams —
// with the wire's per-(edge, payload) loss drawn in the kernel, from up to two streams
// whose drops OR (a bit survives only if both draws keep it):
//   topology  the flat Topology.loss of corrosion_tpu/sim/topology.py:267
//             edge_payload_drop (called at packed.py:451): byte e*P + q
//             of aligned_u8_bits(k_drop, [E, P]) below one threshold
//             topo_thr = round(loss * 256); k_drop is the broadcast key's
//             second split, used as it is; topo_thr 0 draws nothing and
//             256 or more drops every payload without a draw;
//   fault     the fault plan's loss of corrosion_tpu/sim/faults.py:260
//             fault_wire_effects (faults.py:274-284): byte e*P + q of
//             aligned_u8_bits(fold_in(fold_in(key, seed), 101), [E, P])
//             below the edge's threshold thr[e] (from K9).
// A thread's 32 payloads are bytes e*P + 32k .. +31, the eight u32 words
// from e*P/4 + 8k, each the hash of counter (0, word) — word i of a bits
// draw does not depend on the draw's length.  The counter e*8W + 8k + j
// is a u32: at gapstress (E = 76 800, W = 256) it stays below 1.6e8.
// The thread ANDs sending[src, k] with each live stream's 32-bit keep
// mask (byte >= threshold) before the atomicOr.  A stream is hashed only
// where it can drop: an edge with fault thr 0 skips the fault stream, a
// zero word skips both; jax draws the whole [E, P] every round, with the
// same result.  Bound in a lossy round: operations — up to E*P/4 hashes
// of ~72 u32 operations each per stream; outside it, K2's bytes.
//
// K10's third stream, the fault plan's jitter (corrosion_tpu/sim/
// faults.py:285-299 and the per-(edge, payload) ring scatter of
// corrosion_tpu/sim/packed.py:492-506), reorders messages within a
// flush: payload q of edge e lands in slot (slot[e] + j) % D with
//   j = randint(fold_in(fold_in(key, seed), 102), [E, P], 0, 2^31 - 1)
//       [e, q] % (jit[e] + 1)      where jit[e] > 0, else 0
// (slot[e] already holds t + the topology's and the plan's fixed delay;
// jit[e] is K9's jitter bound).  randint splits its key in two and
// hashes element e*P + q under each half (u32 draws `higher` and
// `lower`, one hash each), then offset = ((higher % span) * mult +
// lower % span) % span in u32, span = 2^31 - 1 and mult = (2^16 % span)^2
// % span computed in u32, where 2^32 wraps to 0: the multiplier is 0
// and `higher` drops out, so the kernel skips its hash when the
// wrapper's mult is 0 (exact; it hashes it for any other mult).  The
// element index e*P + q is the i32 draw's (one hash per element per
// key), not the loss streams' u8 index; it must stay below 2^32.
// Each thread draws only the bits that survive the loss streams on an
// edge with jit[e] > 0, keeps one 32-bit mask per slot offset in
// registers (offsets 0..3; a bound of 4 or more ORs bit by bit) and
// issues one atomicOr per nonzero mask.  An edge without jitter sends
// its word to slot[e] in one atomicOr, as K2.  JAX draws the whole
// [E, P] whenever the plan has a jitter factor; threefry is
// counter-based, so skipping the draws no bit needs changes nothing.
// Bound in a jittered round: operations — one hash (~72 u32
// operations) per sent bit of a jittered edge.
//
// With the flight recorder on, K10 also counts the frames the wire ate
// (corrosion_tpu/sim/packed.py:573-581: popcount of drop & sending on ok
// edges, both streams): each thread counts the bits its keep masks
// cleared, the block sums them in shared memory and adds once to the
// int64 `dropped` accumulator.  A null `dropped` (telemetry off) skips
// the count; the scatter is the same either way.
//
// K10's tiered instantiation (corro_broadcast_scatter_tiered, counted as
// broadcast_scatter_tiered) is the topology stream of a geo-tiered
// topology: corrosion_tpu/sim/topology.py:240 tiered_edge_drop, which
// :267 edge_payload_drop takes in place of the flat branch when the
// tiers differ (called at packed.py:451 with src/dst/region).  It draws
// the SAME bytes e*P + q of aligned_u8_bits(k_drop, [E, P]) as the flat
// stream, but compares each against its edge's raw tier threshold
// (topo_tiers.cuh: same AZ, cross-AZ, cross-region, from the two node
// ids of the edge — its sender e / fanout and dst[e]) instead of one
// scalar; an edge whose tier is at certainty (raw >= 256, JAX's pin)
// drops every payload without a draw, and one of threshold 0 draws
// nothing.  The fault and jitter streams are K10's, unchanged.  Bound:
// operations, as K10's topology stream — one hash per sending (edge,
// word of 4 payloads) on an edge of a lossy tier.

// K10p, the pull instantiation (corro_broadcast_pull; counted as
// broadcast_pull, broadcast_pull_lossy and broadcast_pull_tiered), is the
// response leg of push-pull dissemination: corrosion_tpu/proto/
// dissemination.py:43 pull_session_ok and :58 pull_wire_drop with the
// response scatter of corrosion_tpu/sim/packed.py:514-538.  Edge e =
// (src = e / fanout, dst[e]) carries the responder's sending words
// sending[dst[e], k] back to the puller: the kernel ORs what survives into
// ring[slot[e], src, k] where ok_pull[e] (the push's ok minus the sessions
// a cut refuses in either direction, K9's session entry).  The slot is the
// push's per-edge slot (t + the topology's and the plan's fixed delay,
// never jitter).  The streams are K10's with the pull's keys and the
// endpoints swapped:
//   topology  k_pull = fold_in(k_drop, 1) in place of k_drop (folded once
//             a block): byte e*P + q of aligned_u8_bits(k_pull, [E, P])
//             below the flat threshold, or below the tier threshold of
//             (dst[e], src) in the tiered form (topology.py:267
//             edge_payload_drop with src and dst swapped; the draw index
//             is still e);
//   fault     byte e*P + q of aligned_u8_bits(fold_in(fold_in(k_pull,
//             seed), 101), [E, P]) below thr[e], the REVERSE edge's fault
//             threshold (K9's wire query on the swapped edge arrays).
// No jitter: a response is request-paced.  With no stream it is the
// loss-free form, K2's body reading dst's row and writing src's.  Under
// a recording run it adds the frames the streams ate to `dropped`, as K10
// does for the push.  Bound: as K2 (bytes) outside loss, as K10
// (operations, one hash per sending (edge, word of 4 payloads) under a
// threshold) inside it; dst's rows are a random gather, served from L2
// when the sending words fit (6.4 MB at the storm).
//
// K2's lane entry (corro_broadcast_scatter with lanes > 1, counted as
// broadcast_scatter_lanes) folds the lanes into its rows: row r = lane * N + node reads sending row r and edges r * F +
// j, and ORs into lane r / N's ring.  K10's lane entry
// (corro_broadcast_scatter_lossy_lanes) runs the scatter over the seed
// ensemble's lanes (B16, corrosion_tpu/campaign/ensemble.py:114
// run_ensemble) as a grid dimension: blockIdx.y is the lane, whose
// ring [D, N, W], sending words, edges (lane-local dst) and thresholds
// are its slices of the [K, ...] tensors.  K10's lane entry reads the
// lane's phase key and its plan seed (`seeds`, the per-lane
// derive_seed(s, "sim") & 0x7FFFFFFF of ensemble.py:58 lane_plan_seeds)
// and keeps the draw counters lane-local: edge e of lane k hashes e*8W
// + 8k + j as its solo run does.  The flattened K * E * P index would
// pass 2^31 at 16 lanes of the storm (16 * 300000 * 512); no index here
// is flattened across lanes (lane offsets are 64-bit).  Bound: K times
// the solo bound.
//
// K10j's lane entry (B16l: the jitter instantiation of the same lane
// launcher, counted as broadcast_scatter_jitter_lanes) adds the third
// stream on the lanes: each lane draws randint(fold_in(fold_in(keys[k],
// seeds[k]), 102), [E, P], 0, 2^31 - 1) at its own element counters
// e*32W + 32k + b, e lane-local (153.6 M elements a lane at the storm,
// below 2^32; the [K, E, P] offset is not, and is never formed), and a
// surviving payload of a jittered edge lands in slot (slot[k, e] + draw %
// (jit[k, e] + 1)) % D of its lane's ring.  The loss stream may be absent
// in a jitter round (thr null).  The recording forms (B16r's packed half)
// add each lane's lost frames to its own int64 slot, `dropped` + k *
// dropped_stride (the [K, 12] trace accumulators, stride 12), as K12's
// recording lane forms do.  Bound: K times the solo bound (operations in a
// jittered round).
//
// The topology streams on the lanes (B16m: corrosion_tpu/sim/topology.py
// :267 edge_payload_drop, called at packed.py:451, and :240
// tiered_edge_drop under the vmap of ensemble.py:114).  The flat stream
// is K10's lane entry with `topo_thr` and each lane's `topo_key`, its
// k_drop (the second split of the lane's broadcast key, used as it is):
// lane k hashes its own counters e*8W + 8k + j, e lane-local, under its
// own k_drop, so a lane drops what its solo run drops.  The lossy lane
// entry now also runs with the topology stream alone (no fault stream:
// `key`, `seeds` and `thr` null).  The tiered lane instantiation (the
// same launcher given `tiers`, counted as broadcast_scatter_tiered_lanes
// and, with `dropped`, broadcast_scatter_tiered_lanes_trace) compares the
// same per-lane bytes against each edge's
// tier threshold from the one shared topology table (the tiers of an edge
// depend on its two node ids, which are lane-local, so every lane reads
// the same table); a tier at certainty (raw >= 256) drops without a draw.
// Both come with and without the fault loss and the jitter stream, and
// with the recording form.  No block spans two lanes (the lane is
// blockIdx.y), so a block's threads share one lane's keys and seed.
// Bound: operations — K times the solo topology stream's hashes (eight
// u32 draws of ~72 operations per sending (edge, word) under a threshold
// between 1 and 255).
//
// K10p's lane entry (corro_broadcast_pull_lanes, B16m's rest: the pull leg
// of corrosion_tpu/sim/packed.py:514-538 with corrosion_tpu/proto/
// dissemination.py:43 pull_session_ok and :58 pull_wire_drop under the
// vmap of corrosion_tpu/campaign/ensemble.py:114) is the solo pull body
// with a lane grid dimension, as K12p's lane entry is K12p's: blockIdx.y
// is the lane, whose ring [D, N, W], sending words, edges (lane-local dst,
// the push's slots), ok_pull and reverse thresholds are its slices of the
// [K, ...] tensors (64-bit lane offsets).  Each lane folds its own pull key
// fold_in(k_drop[k], 1) once a block, and its fault key fold_in(fold_in(
// k_pull, seeds[k]), 101); the draw counters e*8W + 8k + j stay
// lane-local, so E*8*W < 2^32 is the solo guard, held for each lane.
// Counted by its streams as broadcast_pull_lanes (none),
// broadcast_pull_lossy_lanes (the flat or the fault stream, or a severed
// flat channel) and broadcast_pull_tiered_lanes (the shared tier table);
// the recording forms add each lane's lost frames to its own slot,
// `dropped` + k * dropped_stride, counted as _lossy_lanes_trace and
// _tiered_lanes_trace.  No block spans two lanes, so a block's threads
// share one lane's keys.  Bound: K times the solo bound — bytes outside
// loss, operations (one hash per sending (edge, word of 4 payloads) under
// a threshold) inside it.
//
// At the 1M tier (config_fault_storm_1m: N = 1 000 000, W = 16, P = 512,
// F = 3, E = 3 000 000, D = 2): the edge pass's edge e < 3e6 and K2's
// thread (node, word) < N * W = 1.6e7 are u32 (their guards: < 2^32);
// K2's ring offset ((size_t)s * N + d) * W < 3.2e7 and K10's thread
// (edge, word) < E * W = 4.8e7 are size_t; K10's loss counter e*8W + 8k
// + j < 3.84e8 is a u32 (the launcher's refusal at E*8*W >= 2^32 stands
// far off); the byte index e*P + q < 1.54e9 is never formed (word e*8W
// + 8k + j holds it).

#include <cuda_runtime.h>

#include "threefry.cuh"
#include "topo_tiers.cuh"

namespace {

// The keep mask of one thread's 32 payloads under one stream: bit 4j + b
// set where byte b of draw word base + j is at least the threshold.
__device__ __forceinline__ uint32_t keep_mask(uint32_t k1, uint32_t k2,
                                              uint32_t base, uint32_t t) {
  uint32_t keep = 0u;
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    corro::Pair h = corro::threefry2x32(k1, k2, 0u, base + j);
    uint32_t word = h.a ^ h.b;
#pragma unroll
    for (int b = 0; b < 4; ++b) {
      if (((word >> (8 * b)) & 0xFFu) >= t) keep |= 1u << (4 * j + b);
    }
  }
  return keep;
}

// The jitter stream's keys and randint constants, per block.
struct Jitter {
  const int32_t* jit;  // [E] jitter bound, or null: no jitter stream
  uint32_t sub[4];     // randint's two subkeys of the folded key
  uint32_t span, mult;
};

constexpr int kFastOffsets = 4;

// OR the surviving bits `v` of edge e's word k into the ring, each bit
// at slot (s + j) % D for its jitter draw j in [0, jb].
__device__ __forceinline__ void jitter_or(uint32_t* __restrict__ ring,
                                          const Jitter& jt, uint32_t v,
                                          int e, int k, int row, int s,
                                          int jb, int n, int d_slots, int w) {
  const uint32_t idx0 = (uint32_t)e * (32u * (uint32_t)w) + 32u * (uint32_t)k;
  const bool fast = jb < kFastOffsets;
  uint32_t m[kFastOffsets] = {0u, 0u, 0u, 0u};
  while (v) {
    int b = __ffs(v) - 1;
    v &= v - 1u;
    // the draw, in [0, 2^31 - 1)
    uint32_t off = corro::randint_at(jt.sub, jt.span, jt.mult, idx0 + b);
    uint32_t j = off % (uint32_t)(jb + 1);
    uint32_t bit = 1u << b;
    if (fast) {
#pragma unroll
      for (int o = 0; o < kFastOffsets; ++o)
        if (j == (uint32_t)o) m[o] |= bit;
    } else {
      uint32_t slot_b = ((uint32_t)s + j) % (uint32_t)d_slots;
      atomicOr(&ring[((size_t)slot_b * n + row) * w + k], bit);
    }
  }
  if (!fast) return;
#pragma unroll
  for (int o = 0; o < kFastOffsets; ++o) {
    if (m[o]) {
      uint32_t slot_o = ((uint32_t)s + (uint32_t)o) % (uint32_t)d_slots;
      atomicOr(&ring[((size_t)slot_o * n + row) * w + k], m[o]);
    }
  }
}

// One edge word: OR what survives the live streams into the ring and
// return how many of the word's sent bits the streams dropped.  The
// jitter path is compiled only into the jitter instantiation, so K2's
// and K10's loss-only launches keep their registers (and occupancy).
// kPull is K10p: the responder dst[e]'s words go to the puller's row
// e / fanout, the tier is the reverse edge's and the topology stream's key
// is the block's pull key `pk` (fold_in(k_drop, 1)).
template <bool kJitter, bool kTiered, bool kPull = false>
__device__ __forceinline__ uint32_t scatter_word(
    uint32_t* __restrict__ ring, const uint32_t* __restrict__ sending,
    const int32_t* __restrict__ dst, const int32_t* __restrict__ slot,
    const bool* __restrict__ ok, const uint8_t* __restrict__ thr,
    const int64_t* __restrict__ topo_key, const uint32_t* folded,
    const Jitter& jt, const int32_t* __restrict__ tiers, size_t i, int n,
    int d_slots, int w, int fanout, int topo_thr,
    const uint32_t* pk = nullptr) {
  int e = (int)(i / w);
  int k = (int)(i % w);
  if (!ok[e]) return 0u;
  int from = kPull ? dst[e] : e / fanout;
  uint32_t sent = sending[(size_t)from * w + k];
  if (sent == 0u) return 0u;
  // the edge's tier threshold replaces the scalar one
  if (kTiered)
    topo_thr = kPull ? corro::topo_loss_raw(tiers, dst[e], e / fanout)
                     : corro::topo_loss_raw(tiers, e / fanout, dst[e]);
  if (topo_thr >= 256) return __popc(sent);  // a severed channel
  uint32_t v = sent;
  uint32_t base = (uint32_t)e * (8u * (uint32_t)w) + 8u * (uint32_t)k;
  if (topo_thr > 0) {
    if (kPull)
      v &= keep_mask(pk[0], pk[1], base, (uint32_t)topo_thr);
    else
      v &= keep_mask((uint32_t)topo_key[0], (uint32_t)topo_key[1], base,
                     (uint32_t)topo_thr);
  }
  uint32_t t = thr != nullptr ? thr[e] : 0u;
  if (t != 0u && v != 0u) v &= keep_mask(folded[0], folded[1], base, t);
  if (v != 0u) {
    int row = kPull ? e / fanout : dst[e];
    int s = slot[e];
    // jnp scatters drop out-of-range updates; so does this one
    if (row >= 0 && row < n && s >= 0 && s < d_slots) {
      int jb = kJitter ? jt.jit[e] : 0;
      if (jb > 0)
        jitter_or(ring, jt, v, e, k, row, s, jb, n, d_slots, w);
      else
        atomicOr(&ring[((size_t)s * n + row) * w + k], v);
    }
  }
  return __popc(sent & ~v);
}

// One body for both entry points: K2 passes null `thr`, `key`,
// `topo_key`, `dropped` and `jit` and draws nothing; K10 passes the
// streams it has, and `dropped` when the flight recorder counts.
template <bool kJitter, bool kTiered>
__global__ void broadcast_scatter_kernel(
    uint32_t* __restrict__ ring, const uint32_t* __restrict__ sending,
    const int32_t* __restrict__ dst, const int32_t* __restrict__ slot,
    const bool* __restrict__ ok, const uint8_t* __restrict__ thr,
    const int64_t* __restrict__ key, const int64_t* __restrict__ topo_key,
    unsigned long long* __restrict__ dropped,
    const int32_t* __restrict__ jit, const int32_t* __restrict__ tiers,
    const int32_t* __restrict__ seeds,
    int n, int d_slots, int w, int fanout,
    int n_edges, uint32_t seed, uint32_t tag, int topo_thr, uint32_t jit_tag,
    uint32_t span, uint32_t mult, int dropped_stride) {
  __shared__ uint32_t folded[2];
  __shared__ uint32_t jsub[4];
  __shared__ unsigned long long lost_block;
  // the lane's slices, keys and plan seed (lane 0 and `seed` on the solo
  // entries); edge e and its draw counters stay lane-local
  {
    const size_t lane = blockIdx.y;
    const size_t words = (size_t)n * w;
    ring += lane * d_slots * words;
    sending += lane * words;
    dst += lane * n_edges;
    slot += lane * n_edges;
    ok += lane * n_edges;
    if (thr) thr += lane * n_edges;
    if (jit) jit += lane * n_edges;
    if (key) key += 2 * lane;
    if (topo_key) topo_key += 2 * lane;
    if (seeds) seed = (uint32_t)seeds[lane];
    if (dropped) dropped += lane * dropped_stride;
  }
  if (thr != nullptr || kJitter) {
    if (threadIdx.x == 0) {
      corro::Pair f = corro::fold_in(
          corro::Pair{(uint32_t)key[0], (uint32_t)key[1]}, seed);
      corro::Pair g = corro::fold_in(f, tag);
      folded[0] = g.a;
      folded[1] = g.b;
      // randint(fold_in(fold_in(key, seed), jit_tag)): split(., 2)
      if (kJitter) corro::randint_subkeys(corro::fold_in(f, jit_tag), jsub);
    }
    __syncthreads();
  }
  Jitter jt{jit, {0u, 0u, 0u, 0u}, span, mult};
  if (kJitter) {
#pragma unroll
    for (int q = 0; q < 4; ++q) jt.sub[q] = jsub[q];
  }
  size_t i = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  uint32_t lost = 0u;
  if (i < (size_t)n_edges * w)
    lost = scatter_word<kJitter, kTiered>(ring, sending, dst, slot, ok, thr,
                                          topo_key, folded, jt, tiers, i, n,
                                          d_slots, w, fanout, topo_thr);
  if (dropped == nullptr) return;
  if (threadIdx.x == 0) lost_block = 0ull;
  __syncthreads();
#pragma unroll
  for (int d = 16; d > 0; d >>= 1) lost += __shfl_xor_sync(0xFFFFFFFFu, lost, d);
  if ((threadIdx.x & 31) == 0 && lost)
    atomicAdd(&lost_block, (unsigned long long)lost);
  __syncthreads();
  if (threadIdx.x == 0 && lost_block) atomicAdd(dropped, lost_block);
}

// K10p: the pull leg.  `k_drop` is the broadcast key's second split;
// the block folds the pull key and, under fault loss, its fault key once.
// The lane entry runs it with blockIdx.y the lane: the lane's slices,
// k_drop and plan seed (lane 0 and `seed` on the solo entry).
template <bool kTiered>
__global__ void broadcast_pull_kernel(
    uint32_t* __restrict__ ring, const uint32_t* __restrict__ sending,
    const int32_t* __restrict__ dst, const int32_t* __restrict__ slot,
    const bool* __restrict__ ok_pull, const uint8_t* __restrict__ thr,
    const int64_t* __restrict__ k_drop,
    unsigned long long* __restrict__ dropped,
    const int32_t* __restrict__ tiers, const int32_t* __restrict__ seeds,
    int n, int d_slots, int w, int fanout, int n_edges, uint32_t seed,
    uint32_t tag, int topo_thr, int dropped_stride) {
  __shared__ uint32_t pk[2];
  __shared__ uint32_t folded[2];
  __shared__ unsigned long long lost_block;
  {
    const size_t lane = blockIdx.y;
    const size_t words = (size_t)n * w;
    ring += lane * d_slots * words;
    sending += lane * words;
    dst += lane * n_edges;
    slot += lane * n_edges;
    ok_pull += lane * n_edges;
    if (thr) thr += lane * n_edges;
    if (k_drop) k_drop += 2 * lane;
    if (seeds) seed = (uint32_t)seeds[lane];
    if (dropped) dropped += lane * dropped_stride;
  }
  if (k_drop != nullptr) {
    if (threadIdx.x == 0) {
      corro::Pair p = corro::fold_in(
          corro::Pair{(uint32_t)k_drop[0], (uint32_t)k_drop[1]}, 1u);
      pk[0] = p.a;
      pk[1] = p.b;
      if (thr != nullptr) {
        corro::Pair g = corro::fold_in(corro::fold_in(p, seed), tag);
        folded[0] = g.a;
        folded[1] = g.b;
      }
    }
    __syncthreads();
  }
  Jitter jt{nullptr, {0u, 0u, 0u, 0u}, 0u, 0u};
  size_t i = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  uint32_t lost = 0u;
  if (i < (size_t)n_edges * w)
    lost = scatter_word<false, kTiered, true>(
        ring, sending, dst, slot, ok_pull, thr, nullptr, folded, jt, tiers,
        i, n, d_slots, w, fanout, topo_thr, pk);
  if (dropped == nullptr) return;
  if (threadIdx.x == 0) lost_block = 0ull;
  __syncthreads();
#pragma unroll
  for (int d = 16; d > 0; d >>= 1) lost += __shfl_xor_sync(0xFFFFFFFFu, lost, d);
  if ((threadIdx.x & 31) == 0 && lost)
    atomicAdd(&lost_block, (unsigned long long)lost);
  __syncthreads();
  if (threadIdx.x == 0 && lost_block) atomicAdd(dropped, lost_block);
}

// -- K2 and the edge pass ---------------------------------------------------

// Edge e of folded row r (r = lane * N + src, e = r * F + j) from
// targets [rows * F] (rows = lanes * N): JAX's packed.py:435-441 (and
// :1178-1184 with due[src]) and, given `region` [N] (shared by the
// lanes), the flat edge_delay's slot.  group and alive are [rows], due
// [rows] or null.  A target past N is no node: never ok.
__global__ void edge_list_kernel(
    const int32_t* __restrict__ targets, const int32_t* __restrict__ group,
    const uint8_t* __restrict__ alive, const bool* __restrict__ due,
    const int32_t* __restrict__ region, int32_t* __restrict__ dst,
    bool* __restrict__ ok, int32_t* __restrict__ slot, int n, int fanout,
    int t, int d_slots, int intra, int inter, uint32_t total) {
  const uint32_t e = blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= total) return;
  const uint32_t r = e / (uint32_t)fanout;
  const uint32_t lane = r / (uint32_t)n;
  const int src = (int)(r - lane * (uint32_t)n);
  const int tgt = targets[e];
  const int d = tgt > 0 ? tgt : 0;
  const size_t peer = (size_t)lane * n + d;
  dst[e] = d;
  ok[e] = tgt >= 0 && tgt < n && d != src && alive[r] == 0 &&
          alive[peer] == 0 && group[r] == group[peer] &&
          (due == nullptr || due[r]);
  if (region != nullptr) {
    const int delay = d < n && region[src] == region[d] ? intra : inter;
    slot[e] = (t + delay) % d_slots;
  }
}

// K2: thread i = (row r, word k) of the folded rows (r = lane * N + node).
__global__ void __launch_bounds__(256) broadcast_rows_kernel(
    uint32_t* __restrict__ ring, const uint32_t* __restrict__ sending,
    const int32_t* __restrict__ dst, const int32_t* __restrict__ slot,
    const bool* __restrict__ ok, int n, int d_slots, int w, int fanout,
    uint32_t total) {
  const uint32_t i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= total) return;
  const uint32_t r = i / (uint32_t)w;
  const int k = (int)(i - r * (uint32_t)w);
  const uint32_t x = sending[i];
  if (x == 0u) return;
  const uint32_t lane = r / (uint32_t)n;
  uint32_t* lring = ring + (size_t)lane * d_slots * n * w + k;
  for (int j = 0; j < fanout; ++j) {
    const uint32_t e = r * (uint32_t)fanout + j;
    if (!ok[e]) continue;
    const int d = dst[e];
    const int s = slot[e];
    // jnp scatters drop out-of-range updates; so does this one
    if (d < 0 || d >= n || s < 0 || s >= d_slots) continue;
    atomicOr(lring + ((size_t)s * n + d) * w, x);
  }
}

}  // namespace

// K2, solo (lanes 1) and on the lanes folded into the rows: ring [lanes,
// D, N, W], sending [lanes, N, W], dst, slot and ok [lanes, N * F]
// (lane-local dst).
extern "C" int corro_broadcast_scatter(void* ring, const void* sending,
                                       const void* dst, const void* slot,
                                       const void* ok, int n, int d_slots,
                                       int w, int fanout, int lanes,
                                       void* stream) {
  if (n <= 0 || w <= 0 || fanout <= 0 || d_slots <= 0 || lanes <= 0 ||
      lanes > 65535)
    return (int)cudaErrorInvalidValue;
  const unsigned long long rows = (unsigned long long)lanes * n;
  const unsigned long long total = rows * w;
  // edge and thread indices are u32
  if (rows * fanout >= (1ull << 32) || total >= (1ull << 32))
    return (int)cudaErrorInvalidValue;
  const int threads = 256;
  const unsigned blocks = (unsigned)((total + threads - 1) / threads);
  broadcast_rows_kernel<<<blocks, threads, 0, (cudaStream_t)stream>>>(
      (uint32_t*)ring, (const uint32_t*)sending, (const int32_t*)dst,
      (const int32_t*)slot, (const bool*)ok, n, d_slots, w, fanout,
      (uint32_t)total);
  return (int)cudaGetLastError();
}

// The edge pass: targets [lanes, N, F] into dst, ok and (given `region`)
// slot [lanes, N * F]; `due` [lanes, N] or null; `group`, `alive`
// [lanes, N]; `region` [N] with the flat delay's intra and inter classes,
// t and D, or null (then `slot` is not written and may be null).
extern "C" int corro_edge_list(const void* targets, const void* group,
                               const void* alive, const void* due,
                               const void* region, void* dst, void* ok,
                               void* slot, int n, int fanout, int lanes,
                               int t, int d_slots, int intra, int inter,
                               void* stream) {
  const unsigned long long total =
      (unsigned long long)lanes * (unsigned long long)n * fanout;
  if (n <= 0 || fanout <= 0 || lanes <= 0 || total >= (1ull << 32) ||
      (region != nullptr &&
       (slot == nullptr || d_slots <= 0 || t < 0 || intra < 0 || inter < 0)))
    return (int)cudaErrorInvalidValue;
  const int threads = 256;
  const unsigned blocks = (unsigned)((total + threads - 1) / threads);
  edge_list_kernel<<<blocks, threads, 0, (cudaStream_t)stream>>>(
      (const int32_t*)targets, (const int32_t*)group, (const uint8_t*)alive,
      (const bool*)due, (const int32_t*)region, (int32_t*)dst, (bool*)ok,
      (int32_t*)slot, n, fanout, t, d_slots, intra, inter, (uint32_t)total);
  return (int)cudaGetLastError();
}

namespace {

int launch_lossy(const void* ring, const void* sending, const void* dst,
                 const void* slot, const void* ok, const void* thr,
                 const void* key, const void* topo_key, void* dropped,
                 const void* jit, const void* tiers, int n, int d_slots,
                 int w, int fanout, int seed, int tag, int topo_thr,
                 int jit_tag, int span, int mult, void* stream,
                 const void* seeds = nullptr, int lanes = 1,
                 int dropped_stride = 0) {
  bool tiered = tiers != nullptr;
  if (lanes <= 0 || lanes > 65535 ||
      (lanes > 1 && dropped != nullptr && dropped_stride < 1) ||
      n <= 0 || w <= 0 || fanout <= 0 || topo_thr < 0 || d_slots <= 0 ||
      ((thr != nullptr || jit != nullptr) != (key != nullptr)) ||
      (jit != nullptr && span == 0) ||
      (tiered && (topo_thr != 0 || topo_key == nullptr)) ||
      (topo_thr > 0 && topo_thr < 256 && topo_key == nullptr))
    return (int)cudaErrorInvalidValue;
  int n_edges = n * fanout;
  // the loss draws' word index e*8w + 8k + j and the jitter draw's
  // element index e*32w + 32k + b are u32 counters
  unsigned long long per_word = jit != nullptr ? 32ull : 8ull;
  if ((unsigned long long)n_edges * per_word * (unsigned long long)w >=
      (1ull << 32))
    return (int)cudaErrorInvalidValue;
  size_t total = (size_t)n_edges * w;
  int threads = 256;
  unsigned blocks = (unsigned)((total + threads - 1) / threads);
  auto kernel = jit != nullptr
                    ? (tiered ? broadcast_scatter_kernel<true, true>
                              : broadcast_scatter_kernel<true, false>)
                    : (tiered ? broadcast_scatter_kernel<false, true>
                              : broadcast_scatter_kernel<false, false>);
  kernel<<<dim3(blocks, lanes), threads, 0, (cudaStream_t)stream>>>(
      (uint32_t*)ring, (const uint32_t*)sending, (const int32_t*)dst,
      (const int32_t*)slot, (const bool*)ok, (const uint8_t*)thr,
      (const int64_t*)key, (const int64_t*)topo_key,
      (unsigned long long*)dropped, (const int32_t*)jit,
      (const int32_t*)tiers, (const int32_t*)seeds, n, d_slots, w, fanout,
      n_edges, (uint32_t)seed,
      (uint32_t)tag, topo_thr, (uint32_t)jit_tag, (uint32_t)span,
      (uint32_t)mult, dropped_stride);
  return (int)cudaGetLastError();
}

}  // namespace

// `thr` is null without fault loss and `jit` without jitter; `key` (the
// broadcast phase key both fault streams fold) is null when both are;
// `topo_key` is null when topo_thr is 0 (no topology loss), `dropped` is
// null when nothing counts the lost frames.  `span` and `mult` are
// randint's for the jitter draw's bounds.
extern "C" int corro_broadcast_scatter_lossy(
    void* ring, const void* sending, const void* dst, const void* slot,
    const void* ok, const void* thr, const void* key, const void* topo_key,
    void* dropped, const void* jit, int n, int d_slots, int w, int fanout,
    int seed, int tag, int topo_thr, int jit_tag, int span, int mult,
    void* stream) {
  return launch_lossy(ring, sending, dst, slot, ok, thr, key, topo_key,
                      dropped, jit, nullptr, n, d_slots, w, fanout, seed, tag,
                      topo_thr, jit_tag, span, mult, stream);
}

// The tiered instantiation: K10's arguments with topo_thr 0, `topo_key`
// the broadcast key's k_drop (required) and `tiers` the topology's table.
extern "C" int corro_broadcast_scatter_tiered(
    void* ring, const void* sending, const void* dst, const void* slot,
    const void* ok, const void* thr, const void* key, const void* topo_key,
    void* dropped, const void* jit, const void* tiers, int n, int d_slots,
    int w, int fanout, int seed, int tag, int topo_thr, int jit_tag,
    int span, int mult, void* stream) {
  if (tiers == nullptr) return (int)cudaErrorInvalidValue;
  return launch_lossy(ring, sending, dst, slot, ok, thr, key, topo_key,
                      dropped, jit, tiers, n, d_slots, w, fanout, seed, tag,
                      topo_thr, jit_tag, span, mult, stream);
}

// K10's lane entry: ring [lanes, D, N, W], sending [lanes, N, W], dst,
// slot and ok [lanes, E], `thr` the fault thresholds [lanes, E] (null
// without fault loss this round), `jit` the jitter bounds [lanes, E] (null
// without jitter this round: K10j's lane entry when given), `key` the
// lanes' broadcast phase keys [lanes, 2] and `seeds` their plan seeds
// [lanes] (i32; both null when neither fault stream runs).  Each lane folds
// its own key with its own seed (keys 101 and 102) and hashes its own
// counters — e*8W + 8k + j for the loss, the element e*32W + 32k + b for
// the jitter, e lane-local: lane k's drops and slots are the solo run's
// under seed k.  The topology stream takes `topo_key`, the lanes' k_drop
// [lanes, 2] used as they are, and either the shared flat `topo_thr`
// (`topo_key` null when it is 0 or 256 or more) or, with `tiers` (the
// topology's table, shared by every lane; topo_thr 0, `topo_key`
// required), each edge's tier threshold: the tiered lane instantiation.
// The recording forms pass `dropped`, lane 0's int64 slot, each lane's
// `dropped_stride` slots after the one before (null: nothing counts).
extern "C" int corro_broadcast_scatter_lossy_lanes(
    void* ring, const void* sending, const void* dst, const void* slot,
    const void* ok, const void* thr, const void* key, const void* seeds,
    const void* topo_key, void* dropped, const void* jit, const void* tiers,
    int n, int d_slots, int w, int fanout, int tag, int topo_thr,
    int jit_tag, int span, int mult, int dropped_stride, int lanes,
    void* stream) {
  bool fault = thr != nullptr || jit != nullptr;
  if ((!fault && topo_thr == 0 && tiers == nullptr) ||
      (fault && (key == nullptr || seeds == nullptr)))
    return (int)cudaErrorInvalidValue;
  return launch_lossy(ring, sending, dst, slot, ok, thr, key, topo_key,
                      dropped, jit, tiers, n, d_slots, w, fanout, 0, tag,
                      topo_thr, jit_tag, span, mult, stream, seeds, lanes,
                      dropped_stride);
}

namespace {

int launch_pull(void* ring, const void* sending, const void* dst,
                const void* slot, const void* ok, const void* thr,
                const void* k_drop, void* dropped, const void* tiers,
                const void* seeds, int n, int d_slots, int w, int fanout,
                int seed, int tag, int topo_thr, int dropped_stride,
                int lanes, void* stream) {
  bool tiered = tiers != nullptr;
  bool draws = thr != nullptr || tiered || (topo_thr > 0 && topo_thr < 256);
  if (n <= 0 || w <= 0 || fanout <= 0 || topo_thr < 0 || d_slots <= 0 ||
      lanes <= 0 || lanes > 65535 ||
      (lanes > 1 && dropped != nullptr && dropped_stride < 1) ||
      (draws && k_drop == nullptr) || (tiered && topo_thr != 0))
    return (int)cudaErrorInvalidValue;
  int n_edges = n * fanout;
  // the draws' word index e*8w + 8k + j is a u32 counter, lane-local
  if ((unsigned long long)n_edges * 8ull * (unsigned long long)w >=
      (1ull << 32))
    return (int)cudaErrorInvalidValue;
  size_t total = (size_t)n_edges * w;
  int threads = 256;
  unsigned blocks = (unsigned)((total + threads - 1) / threads);
  auto kernel = tiered ? broadcast_pull_kernel<true>
                       : broadcast_pull_kernel<false>;
  kernel<<<dim3(blocks, lanes), threads, 0, (cudaStream_t)stream>>>(
      (uint32_t*)ring, (const uint32_t*)sending, (const int32_t*)dst,
      (const int32_t*)slot, (const bool*)ok, (const uint8_t*)thr,
      draws ? (const int64_t*)k_drop : nullptr, (unsigned long long*)dropped,
      (const int32_t*)tiers, (const int32_t*)seeds, n, d_slots, w, fanout,
      n_edges, (uint32_t)seed, (uint32_t)tag, topo_thr, dropped_stride);
  return (int)cudaGetLastError();
}

}  // namespace

// K10p, the pull leg: `ok` is ok_pull, `thr` the reverse edges' fault
// thresholds (null without fault loss), `k_drop` the broadcast key's
// k_drop (null when no stream draws: thr null, topo_thr 0 or 256 and no
// tiers), `tiers` the topology's table under tiered loss (topo_thr 0),
// `dropped` null when nothing counts the lost frames.
extern "C" int corro_broadcast_pull(
    void* ring, const void* sending, const void* dst, const void* slot,
    const void* ok, const void* thr, const void* k_drop, void* dropped,
    const void* tiers, int n, int d_slots, int w, int fanout, int seed,
    int tag, int topo_thr, void* stream) {
  return launch_pull(ring, sending, dst, slot, ok, thr, k_drop, dropped,
                     tiers, nullptr, n, d_slots, w, fanout, seed, tag,
                     topo_thr, 0, 1, stream);
}

// K10p's lane entry: ring [lanes, D, N, W], sending [lanes, N, W], dst,
// slot and ok_pull [lanes, E] (lane-local ids), `thr` the reverse edges'
// fault thresholds [lanes, E] (null without fault loss this round),
// `k_drop` the lanes' k_drop [lanes, 2] (null when no stream draws),
// `seeds` their plan seeds i32[lanes] (required with `thr`), `tiers` the
// shared topology table; `dropped` lane 0's int64 slot, each lane's
// `dropped_stride` slots after the one before (null: nothing counts).
extern "C" int corro_broadcast_pull_lanes(
    void* ring, const void* sending, const void* dst, const void* slot,
    const void* ok, const void* thr, const void* k_drop, const void* seeds,
    void* dropped, const void* tiers, int n, int d_slots, int w, int fanout,
    int tag, int topo_thr, int dropped_stride, int lanes, void* stream) {
  if (thr != nullptr && seeds == nullptr) return (int)cudaErrorInvalidValue;
  return launch_pull(ring, sending, dst, slot, ok, thr, k_drop, dropped,
                     tiers, seeds, n, d_slots, w, fanout, 0, tag, topo_thr,
                     dropped_stride, lanes, stream);
}
