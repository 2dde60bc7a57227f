// K5: jax.random's threefry2x32 draws — split, fold_in, bits, randint.
//
// Replaces jax.random as the JAX package calls it on the write storm's
// path, first in corrosion_tpu/sim/state.py:420 init_pview (its randint
// at state.py:427; the splits at :442-445, the countdown draw at :460),
// then in packed.py:723 (split 4), :384 (split 3), :1161 (split 3),
// :1292 (the rearm randint, per-element maxval) and pswim.py:193 (split
// 11), :263, :308, :345, :352.  The member sampler's [4c, N] slots
// (pswim.py:92) K1 draws itself, with this file's hash (threefry.cuh).
// The plain versions are corrosion_tpu_torch/sim/rng.py.
//
// Counters are jax's partitionable iota_2x32_shape: the high word 0, the
// low word `base + i` for flat index i.  Two entry points:
//   corro_threefry  mode 0 (bits):    out[i] = a ^ b          (int64)
//                   mode 1 (split):   out[2i] = a, out[2i+1] = b (int64)
//                   fold_in is mode 1 with size 1 and base = data.
//   corro_randint   jax's _randint: the two subkeys of split(key, 2) once
//                   per block, then per element the higher and lower bits
//                   hashes and the span/multiplier/offset arithmetic of
//                   rng.py randint, all in uint32_t — (2^16 % span)^2
//                   wraps mod 2^32 before its `% span`, as jax's does.
//                   The span and multiplier come from the wrapper for a
//                   scalar maxval, or per element from an int32/int64
//                   maxval array (the rearm's backoff + 1), with jax's
//                   hi <= minval and out-of-range branches.
// The key is read through its pointer (int64 [2] holding u32 halves), so
// it never leaves the card.
//
// The lane entries (corro_threefry_lanes, corro_randint_lanes) are
// jax.vmap of the same draws over a [K, 2] key batch (B16, the seed
// ensembles of corrosion_tpu/campaign/ensemble.py:114): blockIdx.y is
// the lane, which reads its own key row, its own maxval row and writes
// its own output row.  The counters stay lane-local (0 .. size - 1 in
// every lane), so lane k's draw is the solo draw under key k — a kernel
// hashing the flattened [K * size] index would give other draws that
// still look random.  The solo entries launch one lane.
//
// Bound on the H100: operations.  A draw is two 20-round hashes (about
// 72 u32 adds, xors and funnel shifts each) plus three u32 modulos, and
// writes 4 bytes: ~150 integer instructions per 4 bytes written, far
// past the card's ops-per-byte balance.  Design: one thread per draw,
// keys and span in registers, the hash fully unrolled from the shared
// header; the block's subkeys are two hashes for 256 draws.
//
// At the 1M tier (corrosion_tpu/sim/runner.py:753 config_fault_storm_1m:
// N = 1 000 000, P = 512, ground-truth membership) the largest draw is
// the uniform sampler's [12, N] randint: element index i < 1.2e7, a u32;
// the rearm's per-element maxval row is [N]; lane offsets are size_t.

#include <cstdint>
#include <cuda_runtime.h>

#include "threefry.cuh"

namespace {

constexpr int kThreads = 256;

__global__ void threefry_kernel(const int64_t* __restrict__ key,
                                int64_t* __restrict__ out, uint32_t size,
                                uint32_t base, int mode) {
  key += 2 * (size_t)blockIdx.y;
  out += (size_t)blockIdx.y * size * (mode == 0 ? 1 : 2);
  uint32_t i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= size) return;
  corro::Pair h = corro::threefry2x32((uint32_t)key[0], (uint32_t)key[1], 0u,
                                      base + i);
  if (mode == 0) {
    out[i] = (int64_t)(h.a ^ h.b);
  } else {
    out[2 * (size_t)i] = (int64_t)h.a;
    out[2 * (size_t)i + 1] = (int64_t)h.b;
  }
}

template <typename MaxT>
__device__ __forceinline__ void element_span(const MaxT* maxval, uint32_t i,
                                             int32_t minval, uint32_t* span,
                                             uint32_t* mult) {
  int64_t m = (int64_t)maxval[i];
  bool out_of_range = m > (int64_t)INT32_MAX;
  int64_t hi = m < (int64_t)INT32_MIN ? (int64_t)INT32_MIN
               : out_of_range         ? (int64_t)INT32_MAX
                                      : m;
  uint32_t s = (uint32_t)(hi - (int64_t)minval);
  if (hi <= (int64_t)minval) {
    s = 1u;
  } else if (out_of_range) {
    s += 1u;
  }
  uint32_t m16 = 65536u % s;
  *span = s;
  *mult = (m16 * m16) % s;
}

// per_element: 0 = scalar span/mult, 1 = int32 maxval, 2 = int64 maxval
__global__ void randint_kernel(const int64_t* __restrict__ key,
                               const void* __restrict__ maxval,
                               int32_t* __restrict__ out, uint32_t size,
                               int32_t minval, uint32_t span_s,
                               uint32_t mult_s, int per_element) {
  __shared__ uint32_t sub[4];
  // the lane's key, maxval row and output row
  const size_t lane = blockIdx.y;
  key += 2 * lane;
  out += lane * size;
  if (per_element == 1) maxval = (const int32_t*)maxval + lane * size;
  if (per_element == 2) maxval = (const int64_t*)maxval + lane * size;
  if (threadIdx.x < 2) {
    corro::Pair k = corro::threefry2x32((uint32_t)key[0], (uint32_t)key[1],
                                        0u, threadIdx.x);
    sub[2 * threadIdx.x] = k.a;
    sub[2 * threadIdx.x + 1] = k.b;
  }
  __syncthreads();
  uint32_t i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= size) return;
  corro::Pair h = corro::threefry2x32(sub[0], sub[1], 0u, i);
  corro::Pair l = corro::threefry2x32(sub[2], sub[3], 0u, i);
  uint32_t higher = h.a ^ h.b;
  uint32_t lower = l.a ^ l.b;
  uint32_t span = span_s, mult = mult_s;
  if (per_element == 1) {
    element_span((const int32_t*)maxval, i, minval, &span, &mult);
  } else if (per_element == 2) {
    element_span((const int64_t*)maxval, i, minval, &span, &mult);
  }
  uint32_t offset = ((higher % span) * mult + lower % span) % span;
  out[i] = (int32_t)((uint32_t)minval + offset);
}

unsigned blocks_for(uint32_t size) {
  return (unsigned)((size + kThreads - 1) / kThreads);
}

}  // namespace

namespace {

int launch_threefry(const void* key, void* out, int size, int base, int mode,
                    int lanes, void* stream) {
  if (size <= 0 || (mode != 0 && mode != 1) || lanes <= 0 || lanes > 65535)
    return (int)cudaErrorInvalidValue;
  threefry_kernel<<<dim3(blocks_for((uint32_t)size), (unsigned)lanes),
                    kThreads, 0, (cudaStream_t)stream>>>(
      (const int64_t*)key, (int64_t*)out, (uint32_t)size, (uint32_t)base, mode);
  return (int)cudaGetLastError();
}

int launch_randint(const void* key, const void* maxval, void* out, int size,
                   int minval, int span, int mult, int per_element, int lanes,
                   void* stream) {
  if (size <= 0 || per_element < 0 || per_element > 2 ||
      (per_element == 0 && span == 0) || (per_element != 0 && !maxval) ||
      lanes <= 0 || lanes > 65535)
    return (int)cudaErrorInvalidValue;
  randint_kernel<<<dim3(blocks_for((uint32_t)size), (unsigned)lanes),
                   kThreads, 0, (cudaStream_t)stream>>>(
      (const int64_t*)key, maxval, (int32_t*)out, (uint32_t)size,
      (int32_t)minval, (uint32_t)span, (uint32_t)mult, per_element);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int corro_threefry(const void* key, void* out, int size, int base,
                              int mode, void* stream) {
  return launch_threefry(key, out, size, base, mode, 1, stream);
}

extern "C" int corro_randint(const void* key, const void* maxval, void* out,
                             int size, int minval, int span, int mult,
                             int per_element, void* stream) {
  return launch_randint(key, maxval, out, size, minval, span, mult,
                        per_element, 1, stream);
}

// The lane entries: `key` [lanes, 2], `out` [lanes, size(, 2)], a
// per-element `maxval` [lanes, size].
extern "C" int corro_threefry_lanes(const void* key, void* out, int size,
                                    int base, int mode, int lanes,
                                    void* stream) {
  return launch_threefry(key, out, size, base, mode, lanes, stream);
}

extern "C" int corro_randint_lanes(const void* key, const void* maxval,
                                   void* out, int size, int minval, int span,
                                   int mult, int per_element, int lanes,
                                   void* stream) {
  return launch_randint(key, maxval, out, size, minval, span, mult,
                        per_element, lanes, stream);
}
