// K18: the broadcast wire's transmitted frames and bytes.
//
// Replaces corrosion_tpu/sim/fused.py:192 word_send_stats (per-node
// frames by popcount and bytes by the selected payload sizes of the
// governor's sending words) and fused.py:225 dense_send_stats, with the
// fold of those per-node totals over the live edges at
// corrosion_tpu/sim/packed.py:565-580 and broadcast.py:254-281:
// frames = sum over ok edges e of frames[e / F], bytes likewise.  The
// plain versions are sim/fused.py word_send_stats, dense_send_stats and
// fold_over_edges.
//
// Two entry points, each ADDING into the round's int64 accumulators
// acc[0] (frames) and acc[1] (bytes):
//   words  sending [N, W] words and the sizes nbytes [P]: one warp per
//          node sums __popc of its words and the sizes of their set bits
//          (__ffs over each word), counts its F ok edges and adds
//          frames * edges and bytes * edges;
//   rows   per-node frames and bytes i32 [N] already made by the dense
//          broadcast (K12): one thread per node.
// JAX folds the bytes in f32 over [N, F]; the port keeps the exact
// integer total (int64: a node's bytes fit i32, the cluster's do not —
// gapstress sends 76 800 edges x up to 5 MiB) and K19 rounds it once to
// f32, so the plain version, this kernel and both rounds agree bit for
// bit.
//
// Bound on the H100: bytes — the sending words (6.4 MB at the storm,
// 26 MB at gapstress) and the ok bytes, read once.  Design: each warp
// reads its node's row as one coalesced run; nbytes is 32 KB at most,
// served by L1; per-warp totals meet in shared memory and the block adds
// once to each accumulator.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarp = 32;

__device__ __forceinline__ long long warp_sum(long long v) {
#pragma unroll
  for (int d = kWarp / 2; d > 0; d >>= 1) v += __shfl_xor_sync(0xFFFFFFFFu, v, d);
  return v;
}

__device__ __forceinline__ void block_add(long long frames, long long bytes,
                                          unsigned long long* acc) {
  __shared__ unsigned long long part[2];
  if (threadIdx.x == 0) part[0] = part[1] = 0ull;
  __syncthreads();
  frames = warp_sum(frames);
  bytes = warp_sum(bytes);
  if ((threadIdx.x & (kWarp - 1)) == 0) {
    if (frames) atomicAdd(&part[0], (unsigned long long)frames);
    if (bytes) atomicAdd(&part[1], (unsigned long long)bytes);
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    if (part[0]) atomicAdd(&acc[0], part[0]);
    if (part[1]) atomicAdd(&acc[1], part[1]);
  }
}

__global__ void trace_wire_words_kernel(const uint32_t* __restrict__ sending,
                                        const int32_t* __restrict__ nbytes,
                                        const bool* __restrict__ ok,
                                        unsigned long long* __restrict__ acc,
                                        int n, int w, int fanout) {
  int lane = threadIdx.x & (kWarp - 1);
  int warps = gridDim.x * (blockDim.x / kWarp);
  long long frames = 0, bytes = 0;  // lane 0's running totals
  for (int node = (blockIdx.x * blockDim.x + threadIdx.x) / kWarp; node < n;
       node += warps) {
    long long edges = 0;
    for (int j = lane; j < fanout; j += kWarp)
      edges += ok[(size_t)node * fanout + j] ? 1 : 0;
    edges = warp_sum(edges);
    if (edges == 0) continue;  // the whole warp agrees
    long long f = 0, b = 0;
    for (int k = lane; k < w; k += kWarp) {
      uint32_t v = sending[(size_t)node * w + k];
      f += __popc(v);
      while (v) {
        int bit = __ffs(v) - 1;
        b += nbytes[(size_t)k * 32 + bit];
        v &= v - 1u;
      }
    }
    f = warp_sum(f);
    b = warp_sum(b);
    if (lane == 0) {
      frames += f * edges;
      bytes += b * edges;
    }
  }
  block_add(frames, bytes, acc);
}

__global__ void trace_wire_rows_kernel(const int32_t* __restrict__ row_frames,
                                       const int32_t* __restrict__ row_bytes,
                                       const bool* __restrict__ ok,
                                       unsigned long long* __restrict__ acc,
                                       int n, int fanout) {
  long long frames = 0, bytes = 0;
  for (int node = blockIdx.x * blockDim.x + threadIdx.x; node < n;
       node += gridDim.x * blockDim.x) {
    long long edges = 0;
    for (int j = 0; j < fanout; ++j)
      edges += ok[(size_t)node * fanout + j] ? 1 : 0;
    frames += (long long)row_frames[node] * edges;
    bytes += (long long)row_bytes[node] * edges;
  }
  block_add(frames, bytes, acc);
}

unsigned grid_for(long long threads) {
  long long blocks = (threads + kThreads - 1) / kThreads;
  if (blocks > 528) blocks = 528;  // four blocks an SM, then grid-stride
  return (unsigned)(blocks > 0 ? blocks : 1);
}

}  // namespace

extern "C" int corro_trace_wire_words(const void* sending, const void* nbytes,
                                      const void* ok, void* acc, int n, int w,
                                      int fanout, void* stream) {
  if (n <= 0 || w <= 0 || fanout <= 0) return (int)cudaErrorInvalidValue;
  trace_wire_words_kernel<<<grid_for((long long)n * kWarp), kThreads, 0,
                            (cudaStream_t)stream>>>(
      (const uint32_t*)sending, (const int32_t*)nbytes, (const bool*)ok,
      (unsigned long long*)acc, n, w, fanout);
  return (int)cudaGetLastError();
}

extern "C" int corro_trace_wire_rows(const void* row_frames,
                                     const void* row_bytes, const void* ok,
                                     void* acc, int n, int fanout,
                                     void* stream) {
  if (n <= 0 || fanout <= 0) return (int)cudaErrorInvalidValue;
  trace_wire_rows_kernel<<<grid_for(n), kThreads, 0, (cudaStream_t)stream>>>(
      (const int32_t*)row_frames, (const int32_t*)row_bytes, (const bool*)ok,
      (unsigned long long*)acc, n, fanout);
  return (int)cudaGetLastError();
}
