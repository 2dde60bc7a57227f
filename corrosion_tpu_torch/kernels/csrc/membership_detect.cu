// K23: the membership detect predicates, one launch a round each.
//
// Replaces the two on-device predicates of corrosion_tpu/sim/telemetry.py:320 run_membership_detect
// (telemetry.py:344-355) and its loop's update of detect_round
// (:385-387): after every round, detect_round becomes t when it is still
// < 0 and the predicate holds, and is left as it is otherwise.  The plain
// versions are sim/telemetry.py detect_full_plain and
// detect_partial_plain.
//
//   full     view i8[N, N], up bool[N]: true iff every cell (i, j) with
//            up[i] and !up[j] holds DOWN (2).  Rows of dead watchers and
//            columns of up members do not count.
//   partial  pid, pkey i32[N, M], up bool[N]: entry (i, s) is watched iff
//            up[i], pid >= 0 and !up[max(pid, 0)]; true iff every watched
//            entry has pkey mod 4 == DOWN.  The state is pkey & 3, which
//            is JAX's floor-mod by 4 for every i32 (an empty entry's -1
//            gives 3, as jnp's % does; C's % would give -1).
//
// `detect` is i32[3]: detect_round, then two scratch words the kernel
// keeps at 0 between launches — a "some block saw an undetected cell"
// flag and the blocks' ticket.  Each block scans its share of the cells
// (a grid-stride loop over the flat table), votes with
// __syncthreads_or, ORs a miss into the flag, and takes a ticket after a
// fence; the last block to finish reads the flag, writes detect_round
// when it is < 0 and nothing was missed, and zeroes both scratch words
// for the next launch.  OR is order-free, so the answer is
// deterministic.  The loop reads detect_round once a round; nothing else
// goes to the host.
//
// Bound on the H100: bytes.  The cells the data needs are the up
// watchers' rows — full: n_up * N bytes of view, partial: n_up * M * 8
// bytes of pid and pkey — plus up (N bytes): 0.010 ms at the partial
// tier's N = 100000, M = 64 with a third of the nodes dead, 0.003 ms at
// N = 4096 full view.  Design: a warp reads consecutive cells (the full
// view four bytes a lane when N % 4 == 0, so every row starts on a
// word), a dead watcher's cells are skipped without a load, up[] of the
// column (or of pid) comes from L2 (N bytes), and a block votes once.

// The lane entries (corro_detect_full_lanes, _partial_lanes) vote over a
// seed ensemble's lanes (B16, dense half:
// corrosion_tpu/campaign/ensemble.py:187 run_detect_ensemble vmaps the
// detect loop) as a grid dimension: blockIdx.y is the lane, whose view [N, N] (or pid and pkey
// [N, M]), up row and detect word i32[3] are its slots of the [K, ...]
// tensors, offset in 64 bits.  Each lane's blocks take tickets in their
// own word and its last block resets its own scratch words, so a lane's
// detect_round is the solo entry's on its inputs.  Bound: K times the
// solo bound.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kDown = 2;
// at most this many blocks: about eight an SM on 132 SMs
constexpr long long kMaxBlocks = 1056;

// The last block's step: read the flag, maybe write detect_round, reset.
__device__ __forceinline__ void finish(int32_t* detect, bool missed, int t) {
  __shared__ bool last;
  int block_missed = __syncthreads_or(missed);
  if (threadIdx.x == 0) {
    if (block_missed) atomicOr(&detect[1], 1);
    __threadfence();
    last = atomicAdd(&detect[2], 1) == (int)gridDim.x - 1;
  }
  __syncthreads();
  if (!last || threadIdx.x != 0) return;
  __threadfence();
  volatile int32_t* d = detect;
  if (d[1] == 0 && d[0] < 0) d[0] = t;
  d[1] = 0;
  d[2] = 0;
}

__global__ void detect_full_kernel(const int8_t* __restrict__ view,
                                   const bool* __restrict__ up,
                                   int32_t* __restrict__ detect, int n,
                                   int t) {
  {
    // the lane's slices (lane 0 on the solo entry)
    const size_t lane = blockIdx.y;
    view += lane * (size_t)n * n;
    up += lane * n;
    detect += lane * 3;
  }
  bool missed = false;
  size_t first = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  size_t stride = (size_t)gridDim.x * blockDim.x;
  if ((n & 3) == 0) {
    // four cells a lane: a row of N % 4 == 0 bytes starts on a word
    const uint32_t* words = (const uint32_t*)view;
    size_t n_words = (size_t)n * n / 4;
    for (size_t k = first; k < n_words; k += stride) {
      size_t cell = 4 * k;
      size_t i = cell / n;
      if (!up[i]) continue;
      int j = (int)(cell - i * n);
      uint32_t w = words[k];
#pragma unroll
      for (int b = 0; b < 4; ++b) {
        int v = (int)(int8_t)(w >> (8 * b));
        missed |= !up[j + b] && v != kDown;
      }
    }
  } else {
    size_t cells = (size_t)n * n;
    for (size_t c = first; c < cells; c += stride) {
      size_t i = c / n;
      if (!up[i]) continue;
      int j = (int)(c - i * n);
      missed |= !up[j] && view[c] != kDown;
    }
  }
  finish(detect, missed, t);
}

__global__ void detect_partial_kernel(const int32_t* __restrict__ pid,
                                      const int32_t* __restrict__ pkey,
                                      const bool* __restrict__ up,
                                      int32_t* __restrict__ detect, int n,
                                      int m, int t) {
  {
    // the lane's slices (lane 0 on the solo entry)
    const size_t lane = blockIdx.y;
    pid += lane * (size_t)n * m;
    pkey += lane * (size_t)n * m;
    up += lane * n;
    detect += lane * 3;
  }
  bool missed = false;
  size_t first = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  size_t stride = (size_t)gridDim.x * blockDim.x;
  size_t cells = (size_t)n * m;
  for (size_t c = first; c < cells; c += stride) {
    if (!up[c / m]) continue;
    int32_t id = pid[c];
    if (id < 0 || up[id]) continue;
    missed |= (pkey[c] & 3) != kDown;
  }
  finish(detect, missed, t);
}

unsigned blocks_for(long long work) {
  long long blocks = (work + 8LL * kThreads - 1) / (8LL * kThreads);
  if (blocks > kMaxBlocks) blocks = kMaxBlocks;
  return (unsigned)(blocks < 1 ? 1 : blocks);
}

}  // namespace

// detect: i32[3] (detect_round, then two words at 0).
extern "C" int corro_detect_full(const void* view, const void* up,
                                 void* detect, int n, int t, void* stream) {
  if (n <= 0) return (int)cudaErrorInvalidValue;
  long long work = (long long)n * n / ((n & 3) == 0 ? 4 : 1);
  detect_full_kernel<<<blocks_for(work), kThreads, 0,
                       (cudaStream_t)stream>>>(
      (const int8_t*)view, (const bool*)up, (int32_t*)detect, n, t);
  return (int)cudaGetLastError();
}

// detect: i32[3] as above; pid values lie in [-1, N).
extern "C" int corro_detect_partial(const void* pid, const void* pkey,
                                    const void* up, void* detect, int n,
                                    int m, int t, void* stream) {
  if (n <= 0 || m <= 0) return (int)cudaErrorInvalidValue;
  detect_partial_kernel<<<blocks_for((long long)n * m), kThreads, 0,
                          (cudaStream_t)stream>>>(
      (const int32_t*)pid, (const int32_t*)pkey, (const bool*)up,
      (int32_t*)detect, n, m, t);
  return (int)cudaGetLastError();
}

// The lane entries: detect i32[lanes, 3], up [lanes, N], the view
// [lanes, N, N] or the tables [lanes, N, M], then `lanes`.
extern "C" int corro_detect_full_lanes(const void* view, const void* up,
                                       void* detect, int n, int t,
                                       int lanes, void* stream) {
  if (n <= 0 || lanes <= 0 || lanes > 65535)
    return (int)cudaErrorInvalidValue;
  long long work = (long long)n * n / ((n & 3) == 0 ? 4 : 1);
  detect_full_kernel<<<dim3(blocks_for(work), lanes), kThreads, 0,
                       (cudaStream_t)stream>>>(
      (const int8_t*)view, (const bool*)up, (int32_t*)detect, n, t);
  return (int)cudaGetLastError();
}

extern "C" int corro_detect_partial_lanes(const void* pid, const void* pkey,
                                          const void* up, void* detect, int n,
                                          int m, int t, int lanes,
                                          void* stream) {
  if (n <= 0 || m <= 0 || lanes <= 0 || lanes > 65535)
    return (int)cudaErrorInvalidValue;
  detect_partial_kernel<<<dim3(blocks_for((long long)n * m), lanes),
                          kThreads, 0, (cudaStream_t)stream>>>(
      (const int32_t*)pid, (const int32_t*)pkey, (const bool*)up,
      (int32_t*)detect, n, m, t);
  return (int)cudaGetLastError();
}
