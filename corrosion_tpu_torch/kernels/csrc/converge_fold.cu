// K7: the convergence record on words, the overflow fold and the run's
// exit flag, in one launch.
//
// Replaces the converge block of corrosion_tpu/sim/packed.py:681
// packed_round_step (packed.py:789-819), the overflow fold before it
// (packed.py:779-781: max(overflow_frac, overflow.mean(f32))) and
// packed.py:871 _converged_done, the exit predicate run_packed evaluates
// after every round.  The plain version is packed.converge_record_plain.
//
// One thread per (node, run of V words): V = 4 (one 128-bit load) when
// W % 4 == 0, else V = 1.  A node's W / V runs take qw threads, the power
// of two at or above it (the spare ones hold ones), in blocks of 1024
// threads that walk their rows in passes.  For each word k: comp =
// all_chunks_words(have[n, k]) (every chunk of the version held, smeared
// over its group), act = the group-smeared any-fold of injected_p[k].
// node_done = up && every word has (comp | ~act) == ~0, an AND across the
// node's qw threads: shuffles while qw <= 32, else a warp vote and a
// flag in shared memory tagged with the pass.  converged_at[n] is stamped
// with t when it was unset, node_done holds and every payload was
// injected by t.  The up rows' comp words are AND-folded per word in
// registers over the block's passes, then across the warp's nodes by
// shuffles, then into shared memory, then into one of the lane's eight
// accumulator rows in global memory (block b into row b % 8, each row on
// L2 lines of its own: same-line atomics serialise, so the blocks'
// atomics spread over eight lines); the block's last entry ANDs "settled"
// (converged or not up) over its nodes.
//
// The finish runs in the same launch: each block takes a ticket after
// its fold (__threadfence, then atomicAdd on the lane's counter); the
// last block of the lane ANDs the eight rows, stamps coverage_at[q] with
// t where unset and the version of payload q is complete on every up
// node and active, writes the done flag (every payload injected by t + 1
// — the incremented round counter _converged_done reads — and every node
// settled) and the overflow fraction max(old, f32(n_overflow) * recip),
// recip = f32(1) / f32(N * A) from the wrapper, XLA's overflow.mean
// (round.overflow_fraction; a plain multiply, never an FMA).  It then
// puts the rows back to ones and the ticket to 0: the scratch clears
// itself for the next launch, with no fill.  "Every payload injected by
// t" is max(meta.round) <= t, and meta.round is fixed for a run, so the
// wrapper passes max(meta.round) (`last_round`, one host read a run)
// instead of a scan of P entries.  AND is order-free, so the atomics
// leave the result deterministic; a block skips its atomicAnd on a word
// of ones, and issues the others without reading the row first (a read
// before each would add a round trip to every block's path).
//
// The fault loop's exit mode (corrosion_tpu/sim/packed.py:1027
// run_packed_faults, its _fault_done over packed.py:1007
// all_have_words): `fresh` = 1 and the block's last entry ANDs "done
// now" (node_ok || !up, the fresh all-have predicate a crash-with-wipe
// can undo) instead of the sticky stamps; the flag also needs t + 1 >=
// horizon.  The stamps themselves are the same in both modes.  horizon
// < 0 and fresh = 0 are the faultless loop's flag.
//
// Bound on the H100: bytes — the have words once (N*W*4), alive, the
// converged_at stamps in and out, coverage_at in and out: 7.6 MB at the
// storm, 2.3 us.  Design: neighbouring threads load neighbouring 16-byte
// runs of a row, so a warp's loads are whole lines; the grid is two
// blocks of 1024 an SM (shared by the lanes), enough loads in flight for
// the card's rate and few blocks for the ticket and the rows' atomics;
// the finish costs no second launch.
//
// The lane entry (the same extern with lanes > 1; counted as
// converge_record_lanes) is the fold per lane of the seed ensemble (B16,
// corrosion_tpu/campaign/ensemble.py:114 run_ensemble; the vmapped
// while_loop's per-lane cond over packed.py:871 _converged_done or the
// fault loop's exit): blockIdx.y is the lane, with its own accumulator
// row and ticket.  A lane's fold never sees another lane's rows; the
// last block of each lane writes its coverage stamps, done[lane] and
// overflow_frac[lane].  Bound: K times the solo bound.

#include <cstdint>
#include <cstring>
#include <cuda_runtime.h>

namespace {

constexpr uint32_t kOnes = 0xFFFFFFFFu;
constexpr unsigned kFull = 0xFFFFFFFFu;
constexpr int kThreads = 1024;

__device__ __forceinline__ uint32_t group_low_bits(int c) {
  uint32_t m = 0u;
  for (int i = 0; i < 32; i += c) m |= 1u << i;
  return m;
}

__device__ __forceinline__ uint32_t smear(uint32_t w, int c) {
  for (int s = 1; s < c; s <<= 1) w |= w << s;
  return w;
}

__device__ __forceinline__ uint32_t all_chunks(uint32_t w, int c,
                                               uint32_t low) {
  uint32_t f = w;
  for (int s = 1; s < c; s <<= 1) f &= f >> s;
  return smear(f & low, c);
}

__device__ __forceinline__ uint32_t any_chunk(uint32_t w, int c,
                                              uint32_t low) {
  uint32_t f = w;
  for (int s = 1; s < c; s <<= 1) f |= f >> s;
  return smear(f & low, c);
}

template <int V>
__device__ __forceinline__ void load_run(const uint32_t* p, uint32_t (&x)[V]) {
  if constexpr (V == 4) {
    uint4 u = *reinterpret_cast<const uint4*>(p);
    x[0] = u.x;
    x[1] = u.y;
    x[2] = u.z;
    x[3] = u.w;
  } else {
    x[0] = *p;
  }
}

// scratch, a lane's row: kReplicas accumulator rows of `stride` words
// (the column AND [w], settled at [w]; each row on lines of its own), then
// the ticket on a line of its own; ones and 0 between launches.  Block b
// folds into row b % kReplicas, so the same-line atomics of the blocks
// spread over kReplicas L2 lines.
constexpr int kReplicas = 8;

__host__ __device__ __forceinline__ int row_stride(int w) {
  return (w + 1 + 31) & ~31;
}

template <int V>
__global__ void __launch_bounds__(kThreads) converge_record_kernel(
    const uint32_t* __restrict__ have, const uint32_t* __restrict__ injected,
    const uint8_t* __restrict__ alive,
    const int32_t* __restrict__ converged_in,
    int32_t* __restrict__ converged_out,
    const int32_t* __restrict__ coverage_in,
    int32_t* __restrict__ coverage_out,
    const int32_t* __restrict__ n_overflow,
    const float* __restrict__ overflow_in, float* __restrict__ overflow_out,
    uint8_t* __restrict__ done, uint32_t* __restrict__ scratch, int n, int w,
    int c, int p, int t, int last_round, int horizon, int fresh, int qw_log,
    float recip) {
  extern __shared__ uint32_t col[];  // [w]
  __shared__ int is_last;
  __shared__ uint32_t settled;
  // wide rows (qw > 32): a node's warps mark it not ok, tagged with the
  // pass, in the buffer of the pass's parity (no reset, one barrier)
  __shared__ int bad[2][kThreads / 32];
  const int stride = row_stride(w);
  {
    const size_t lane = blockIdx.y;
    have += lane * n * (size_t)w;
    injected += lane * w;
    alive += lane * n;
    converged_in += lane * n;
    converged_out += lane * n;
    coverage_in += lane * p;
    coverage_out += lane * p;
    n_overflow += lane;
    overflow_in += lane;
    overflow_out += lane;
    done += lane;
    scratch += lane * (size_t)(kReplicas + 1) * stride;
  }
  for (int k = threadIdx.x; k < w; k += blockDim.x) col[k] = kOnes;
  if (threadIdx.x < 2 * (kThreads / 32)) (&bad[0][0])[threadIdx.x] = -1;
  __syncthreads();

  const int qw = 1 << qw_log;
  const int q = threadIdx.x & (qw - 1);
  const int k0 = q * V;
  const int per_pass = blockDim.x >> qw_log;
  const int slot = threadIdx.x >> qw_log;
  const uint32_t low = group_low_bits(c);
  const bool all_injected = last_round <= t;
  uint32_t act[V], fold[V];
#pragma unroll
  for (int v = 0; v < V; ++v) {
    act[v] = k0 + v < w ? any_chunk(injected[k0 + v], c, low) : 0u;
    fold[v] = kOnes;
  }
  bool settled_all = true;
  // passes are uniform across the block (they depend on blockIdx only),
  // so every thread reaches the barriers below
  int pass = 0;
  for (int first = blockIdx.x * per_pass; first < n;
       first += gridDim.x * per_pass, ++pass) {
    const int node = first + slot;
    const bool in_range = node < n;
    const bool up = in_range && alive[node] == 0;
    bool ok = true;
    if (in_range && k0 < w) {
      uint32_t x[V];
      load_run<V>(have + (size_t)node * w + k0, x);
#pragma unroll
      for (int v = 0; v < V; ++v) {
        uint32_t comp = all_chunks(x[v], c, low);
        ok &= (comp | ~act[v]) == kOnes;
        if (up) fold[v] &= comp;
      }
    }
    if (qw <= 32) {
      for (int off = 1; off < qw; off <<= 1)
        ok &= __shfl_xor_sync(kFull, ok, off) != 0;
    } else {
      const bool warp_ok = __all_sync(kFull, ok);
      if ((threadIdx.x & 31) == 0 && !warp_ok) bad[pass & 1][slot] = pass;
      __syncthreads();
      ok = bad[pass & 1][slot] != pass;
    }
    if (q == 0 && in_range) {
      int32_t conv = converged_in[node];
      if (conv < 0 && ok && up && all_injected) conv = t;
      converged_out[node] = conv;
      settled_all &= fresh ? (ok || !up) : (conv >= 0 || !up);
    }
  }
  // the warp's nodes' columns, then the block's in shared memory
  if (qw < 32) {
#pragma unroll
    for (int v = 0; v < V; ++v)
      for (int off = qw; off < 32; off <<= 1)
        fold[v] &= __shfl_xor_sync(kFull, fold[v], off);
  }
  if ((threadIdx.x & 31) < qw) {
#pragma unroll
    for (int v = 0; v < V; ++v)
      if (k0 + v < w && fold[v] != kOnes) atomicAnd(&col[k0 + v], fold[v]);
  }
  const bool block_settled = __syncthreads_and(settled_all) != 0;
  // into the block's accumulator row
  uint32_t* acc = scratch + (size_t)(blockIdx.x % kReplicas) * stride;
  for (int k = threadIdx.x; k <= w; k += blockDim.x) {
    uint32_t v = k < w ? col[k] : (block_settled ? kOnes : 0u);
    if (v != kOnes) atomicAnd(acc + k, v);
  }
  uint32_t* ticket = scratch + (size_t)kReplicas * stride;
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0)
    is_last = atomicAdd(ticket, 1u) == gridDim.x - 1;
  __syncthreads();
  if (!is_last) return;

  // the finish, in the lane's last block: fold the accumulator rows and
  // put them back to ones
  __threadfence();
  for (int k = threadIdx.x; k <= w; k += blockDim.x) {
    uint32_t v = kOnes;
    for (int r = 0; r < kReplicas; ++r) {
      uint32_t* a = scratch + (size_t)r * stride + k;
      v &= *reinterpret_cast<volatile uint32_t*>(a);
      *a = kOnes;
    }
    if (k < w)
      col[k] = v;
    else
      settled = v;
  }
  __syncthreads();
  for (int i = threadIdx.x; i < p; i += blockDim.x) {
    int k = i >> 5;
    uint32_t a = any_chunk(injected[k], c, low);
    bool payload_done = ((col[k] & a) >> (i & 31)) & 1u;
    int32_t cov = coverage_in[i];
    coverage_out[i] = (cov < 0 && payload_done) ? t : cov;
  }
  if (threadIdx.x == 0) {
    *ticket = 0u;
    done[0] = last_round <= t + 1 && settled == kOnes &&
              (horizon < 0 || t + 1 >= horizon);
    float frac = __fmul_rn(__int2float_rn(n_overflow[0]), recip);
    overflow_out[0] = fmaxf(overflow_in[0], frac);
  }
}

int sm_count() {
  static int sms = 0;
  if (sms == 0) {
    int dev = 0;
    if (cudaGetDevice(&dev) != cudaSuccess ||
        cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) !=
            cudaSuccess)
      sms = 132;
  }
  return sms;
}

}  // namespace

// have [lanes, N, W], injected_p [lanes, W], alive and the stamps
// [lanes, N], coverage [lanes, P], n_overflow i32[lanes], the overflow
// fractions f32[lanes] in and out, done [lanes], scratch [lanes, 9 * S]
// with S = W + 1 rounded up to 32 words (eight accumulator rows of ones,
// then the ticket's row of 0, at its first use; it clears itself).
// `recip_bits` is the f32 reciprocal of the cell count N * A, bit for
// bit; `last_round` is max(meta.round); horizon < 0 and fresh 0 are the
// faultless loop's flag.
extern "C" int corro_converge_record(
    const void* have, const void* injected, const void* alive,
    const void* converged_in, void* converged_out, const void* coverage_in,
    void* coverage_out, const void* n_overflow, const void* overflow_in,
    void* overflow_out, void* done, void* scratch, int n, int w, int c, int p,
    int t, int last_round, int horizon, int fresh, int recip_bits, int lanes,
    void* stream) {
  if (n <= 0 || w <= 0 || c <= 0 || c > 32 || (c & (c - 1)) || p != w * 32 ||
      lanes <= 0 || lanes > 65535)
    return (int)cudaErrorInvalidValue;
  const int vec = w % 4 == 0 ? 4 : 1;
  const int runs = w / vec;
  int qw_log = 0;
  while ((1 << qw_log) < runs) ++qw_log;
  if ((1 << qw_log) > kThreads) return (int)cudaErrorInvalidValue;
  const int per_block = kThreads >> qw_log;
  const long long needed = (n + per_block - 1) / per_block;
  // two blocks of 1024 an SM: the card's threads, once
  long long cap = (long long)sm_count() * 2 / lanes;
  if (cap < 1) cap = 1;
  const unsigned blocks = (unsigned)(needed < cap ? needed : cap);
  const size_t smem = (size_t)w * sizeof(uint32_t);
  float recip;
  static_assert(sizeof(recip) == sizeof(recip_bits), "f32 bits");
  std::memcpy(&recip, &recip_bits, sizeof(recip));
  auto kernel = vec == 4 ? converge_record_kernel<4>
                         : converge_record_kernel<1>;
  kernel<<<dim3(blocks, lanes), kThreads, smem, (cudaStream_t)stream>>>(
      (const uint32_t*)have, (const uint32_t*)injected, (const uint8_t*)alive,
      (const int32_t*)converged_in, (int32_t*)converged_out,
      (const int32_t*)coverage_in, (int32_t*)coverage_out,
      (const int32_t*)n_overflow, (const float*)overflow_in,
      (float*)overflow_out, (uint8_t*)done, (uint32_t*)scratch, n, w, c, p, t,
      last_round, horizon, fresh, qw_log, recip);
  return (int)cudaGetLastError();
}
