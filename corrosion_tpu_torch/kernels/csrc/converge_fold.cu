// K7: the convergence record on words and the run's exit flag.
//
// Replaces the converge block of corrosion_tpu/sim/packed.py:681
// packed_round_step (packed.py:789-819) and packed.py:871
// _converged_done, the exit predicate run_packed evaluates after every
// round.  The plain version is packed.converge_record_plain.
//
// Two launches:
//   rows    one thread per node n.  For each word k: comp =
//           all_chunks_words(have[n, k]) (every chunk of the version
//           held, smeared over its group), act = the group-smeared any-fold
//           of injected_p[k].  node_done = up && every word has
//           (comp | ~act) == ~0; converged_at[n] is stamped with t when
//           it was unset, node_done holds and every payload was injected
//           by t.  The up rows' comp words are AND-folded per word: warp
//           __reduce_and_sync, then atomicAnd into shared memory, then one
//           partial row per block; the block's last entry ANDs "settled"
//           (converged or not up) over its nodes.
//   finish  one block.  ANDs the blocks' partial rows, stamps
//           coverage_at[q] with t where unset and the version of payload
//           q is complete on every up node and active, and writes the done
//           flag: every payload injected by t + 1 (the incremented round
//           counter _converged_done reads) and every node settled.
// AND is order-free, so the atomics leave the result deterministic.
//
// The fault loop's exit mode (corrosion_tpu/sim/packed.py:1027
// run_packed_faults, its _fault_done over packed.py:1007
// all_have_words): rows takes `fresh` = 1 and the block's last entry
// ANDs "done now" (node_ok || !up, the fresh all-have predicate a
// crash-with-wipe can undo) instead of the sticky stamps; finish takes
// the plan's horizon and the flag also needs t + 1 >= horizon.  The
// stamps themselves are the same in both modes.  horizon < 0 and
// fresh = 0 are the faultless loop's flag.
//
// Bound on the H100: bytes — the have words once (N*W*4), alive, the
// converged_at stamps in and out, coverage_at in and out: 7.6 MB at the
// storm.  Design: a thread walks its node's W words (L1 serves the row
// after the first word), so node_done needs no cross-thread step; the
// column fold costs one warp reduction per word and no global atomics.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr uint32_t kOnes = 0xFFFFFFFFu;

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

__global__ void converge_rows_kernel(
    const uint32_t* __restrict__ have, const uint32_t* __restrict__ injected,
    const uint8_t* __restrict__ alive, const int32_t* __restrict__ round_of,
    const int32_t* __restrict__ converged_in,
    int32_t* __restrict__ converged_out, uint32_t* __restrict__ partial,
    int n, int w, int c, int p, int t, int fresh) {
  extern __shared__ uint32_t col[];  // [w + 1]
  for (int k = threadIdx.x; k <= w; k += blockDim.x) col[k] = kOnes;
  bool injected_by_t = true;
  for (int q = threadIdx.x; q < p; q += blockDim.x) {
    injected_by_t &= round_of[q] <= t;
  }
  int all_injected = __syncthreads_and(injected_by_t);

  int node = blockIdx.x * blockDim.x + threadIdx.x;
  bool valid = node < n;
  bool up = valid && alive[node] == 0;
  uint32_t low = group_low_bits(c);
  bool node_ok = true;
  for (int k = 0; k < w; ++k) {
    uint32_t comp = valid ? all_chunks(have[(size_t)node * w + k], c, low)
                          : kOnes;
    uint32_t act = any_chunk(injected[k], c, low);
    node_ok &= (comp | ~act) == kOnes;
    uint32_t folded = __reduce_and_sync(kOnes, up ? comp : kOnes);
    if ((threadIdx.x & 31) == 0 && folded != kOnes) atomicAnd(&col[k], folded);
  }
  bool settled = true;
  if (valid) {
    int32_t conv = converged_in[node];
    if (conv < 0 && node_ok && up && all_injected) conv = t;
    converged_out[node] = conv;
    settled = fresh ? (node_ok || !up) : (conv >= 0 || !up);
  }
  int block_settled = __syncthreads_and(settled);
  uint32_t* row = partial + (size_t)blockIdx.x * (w + 1);
  for (int k = threadIdx.x; k < w; k += blockDim.x) row[k] = col[k];
  if (threadIdx.x == 0) row[w] = block_settled ? kOnes : 0u;
}

__global__ void converge_finish_kernel(
    const uint32_t* __restrict__ partial, const uint32_t* __restrict__ injected,
    const int32_t* __restrict__ round_of,
    const int32_t* __restrict__ coverage_in,
    int32_t* __restrict__ coverage_out, uint8_t* __restrict__ done,
    int n_blocks, int w, int c, int p, int t, int horizon) {
  extern __shared__ uint32_t col[];  // [w + 1]
  for (int k = threadIdx.x; k <= w; k += blockDim.x) col[k] = kOnes;
  __syncthreads();
  size_t total = (size_t)n_blocks * (w + 1);
  for (size_t i = threadIdx.x; i < total; i += blockDim.x) {
    uint32_t v = partial[i];
    if (v != kOnes) atomicAnd(&col[i % (w + 1)], v);
  }
  bool injected_next = true;
  for (int q = threadIdx.x; q < p; q += blockDim.x) {
    injected_next &= round_of[q] <= t + 1;
  }
  int all_injected_next = __syncthreads_and(injected_next);
  uint32_t low = group_low_bits(c);
  for (int q = threadIdx.x; q < p; q += blockDim.x) {
    int k = q >> 5;
    uint32_t act = any_chunk(injected[k], c, low);
    bool payload_done = ((col[k] & act) >> (q & 31)) & 1u;
    int32_t cov = coverage_in[q];
    coverage_out[q] = (cov < 0 && payload_done) ? t : cov;
  }
  if (threadIdx.x == 0) {
    done[0] = all_injected_next && col[w] == kOnes &&
              (horizon < 0 || t + 1 >= horizon);
  }
}

bool geometry_ok(int w, int c, int p) {
  return w > 0 && c > 0 && c <= 32 && !(c & (c - 1)) && p == w * 32;
}

}  // namespace

extern "C" int corro_converge_rows(const void* have, const void* injected,
                                   const void* alive, const void* round_of,
                                   const void* converged_in,
                                   void* converged_out, void* partial, int n,
                                   int w, int c, int p, int t,
                                   int rows_per_block, int fresh,
                                   void* stream) {
  if (n <= 0 || !geometry_ok(w, c, p) || rows_per_block <= 0 ||
      rows_per_block > 1024 || rows_per_block % 32)
    return (int)cudaErrorInvalidValue;
  unsigned blocks = (unsigned)((n + rows_per_block - 1) / rows_per_block);
  size_t smem = (size_t)(w + 1) * sizeof(uint32_t);
  converge_rows_kernel<<<blocks, rows_per_block, smem,
                         (cudaStream_t)stream>>>(
      (const uint32_t*)have, (const uint32_t*)injected, (const uint8_t*)alive,
      (const int32_t*)round_of, (const int32_t*)converged_in,
      (int32_t*)converged_out, (uint32_t*)partial, n, w, c, p, t, fresh);
  return (int)cudaGetLastError();
}

extern "C" int corro_converge_finish(const void* partial, const void* injected,
                                     const void* round_of,
                                     const void* coverage_in,
                                     void* coverage_out, void* done,
                                     int n_blocks, int w, int c, int p, int t,
                                     int horizon, void* stream) {
  if (n_blocks <= 0 || !geometry_ok(w, c, p))
    return (int)cudaErrorInvalidValue;
  size_t smem = (size_t)(w + 1) * sizeof(uint32_t);
  converge_finish_kernel<<<1, 256, smem, (cudaStream_t)stream>>>(
      (const uint32_t*)partial, (const uint32_t*)injected,
      (const int32_t*)round_of, (const int32_t*)coverage_in,
      (int32_t*)coverage_out, (uint8_t*)done, n_blocks, w, c, p, t,
      horizon);
  return (int)cudaGetLastError();
}
