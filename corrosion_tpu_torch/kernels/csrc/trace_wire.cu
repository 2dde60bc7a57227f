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
// Under push-pull (corrosion_tpu/sim/packed.py:584-607,
// broadcast.py:285-305) two pull entries add the response direction: over
// the ok_pull edges e, the RESPONDER dst[e]'s frames and bytes —
//   words_pull  one warp per edge: popcount and sizes of sending[dst[e]];
//   rows_pull   one thread per edge: row_frames[dst[e]], row_bytes[dst[e]].
// JAX adds the pull's f32 sum to the push's; the port adds the exact
// integers to the same int64 accumulators, rounded once by K19.  Bound:
// bytes — a random row of sending words per ok edge (from L2 at the
// storm's 6.4 MB) or two ints.
//
// The rows entry's lane form (corro_trace_wire_rows_lanes) folds a seed
// ensemble's lanes in one launch (corrosion_tpu/campaign/ensemble.py:114
// vmaps broadcast.py:254-281): blockIdx.y is the lane, whose row frames
// and bytes [N] and ok edges [N * F] are its slices of [K, ...] tensors
// and whose accumulators are acc + k * acc_stride (its slots of the
// [K, ...] trace accumulators); lane k is the solo entry on lane k's
// inputs.  Bound: bytes, K times the solo entry's — 8 x (100000 x 8 +
// 300000) bytes = 8.8 MB at the 8-lane dense fault storm, ~0.003 ms.
//
// The rows pull entry's lane form (corro_trace_wire_rows_pull_lanes:
// B16v, ensemble.py:114 vmaps broadcast.py:285-305) takes each lane's
// row frames and bytes [N], ok_pull edges and responders [E] as its slices
// of [K, ...] tensors, adding into acc + k * acc_stride; a responder id
// dst[e] is lane-local.  Bound: bytes, K times the solo entry's.
//
// The words entry's lane form (corro_trace_wire_words_lanes: B16r's
// packed half, ensemble.py:114 vmaps packed.py:565-580) folds a seed
// ensemble's lanes of the packed round in one launch: blockIdx.y is the
// lane, whose sending words [N, W] and ok edges [N * F] are its slices of
// [K, ...] tensors (64-bit offsets) and whose accumulators are acc + k *
// acc_stride; the sizes nbytes [P] are shared.  Bound: bytes, K times the
// solo entry's — 8 x (6.4 + 0.3) MB at the 8-lane storm, ~0.016 ms.
//
// The words pull entry's lane form (corro_trace_wire_words_pull_lanes:
// B16m's rest, ensemble.py:114 vmaps packed.py:584-607) takes each lane's
// sending words [N, W], ok_pull edges and responders [E] as its slices of
// [K, ...] tensors (64-bit offsets; a responder id dst[e] is lane-local),
// adding into acc + k * acc_stride; the sizes nbytes [P] are shared.  The
// bytes channel stays an exact int64 integer sum, rounded once to f32 by
// K19, as the solo entry's.  Bound: bytes, K times the solo entry's — a
// random row of sending words per ok_pull edge of each lane (from L2: 8 x
// 6.4 MB at the 8-lane storm is past the 50 MB L2, so a row's 64 B may
// come from HBM) and the edges' ok and dst.
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
                                        int n, int w, int fanout,
                                        int acc_stride) {
  {
    // the lane's slices (lane 0 on the solo entry)
    const size_t k = blockIdx.y;
    sending += k * (size_t)n * w;
    ok += k * (size_t)n * fanout;
    acc += k * (size_t)acc_stride;
  }
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
                                       int n, int fanout, int acc_stride) {
  {
    // the lane's slices (lane 0 on the solo entry)
    const size_t lane = blockIdx.y;
    row_frames += lane * n;
    row_bytes += lane * n;
    ok += lane * (size_t)n * fanout;
    acc += lane * (size_t)acc_stride;
  }
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

__global__ void trace_wire_words_pull_kernel(
    const uint32_t* __restrict__ sending, const int32_t* __restrict__ nbytes,
    const bool* __restrict__ ok_pull, const int32_t* __restrict__ dst,
    unsigned long long* __restrict__ acc, int n_edges, int w, int n,
    int acc_stride) {
  {
    // the seed-ensemble lane's slices (lane 0 on the solo entry)
    const size_t k = blockIdx.y;
    sending += k * (size_t)n * w;
    ok_pull += k * (size_t)n_edges;
    dst += k * (size_t)n_edges;
    acc += k * (size_t)acc_stride;
  }
  int lane = threadIdx.x & (kWarp - 1);
  int warps = gridDim.x * (blockDim.x / kWarp);
  long long frames = 0, bytes = 0;  // lane 0's running totals
  for (int e = (blockIdx.x * blockDim.x + threadIdx.x) / kWarp; e < n_edges;
       e += warps) {
    if (!ok_pull[e]) continue;  // the whole warp agrees
    const uint32_t* row = sending + (size_t)dst[e] * w;
    long long f = 0, b = 0;
    for (int k = lane; k < w; k += kWarp) {
      uint32_t v = row[k];
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
      frames += f;
      bytes += b;
    }
  }
  block_add(frames, bytes, acc);
}

__global__ void trace_wire_rows_pull_kernel(
    const int32_t* __restrict__ row_frames,
    const int32_t* __restrict__ row_bytes, const bool* __restrict__ ok_pull,
    const int32_t* __restrict__ dst, unsigned long long* __restrict__ acc,
    int n_edges, int n, int acc_stride) {
  {
    // the lane's slices (lane 0 on the solo entry)
    const size_t lane = blockIdx.y;
    row_frames += lane * n;
    row_bytes += lane * n;
    ok_pull += lane * (size_t)n_edges;
    dst += lane * (size_t)n_edges;
    acc += lane * (size_t)acc_stride;
  }
  long long frames = 0, bytes = 0;
  for (int e = blockIdx.x * blockDim.x + threadIdx.x; e < n_edges;
       e += gridDim.x * blockDim.x) {
    if (!ok_pull[e]) continue;
    frames += row_frames[dst[e]];
    bytes += row_bytes[dst[e]];
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
      (unsigned long long*)acc, n, w, fanout, 0);
  return (int)cudaGetLastError();
}

// The words entry's lane form: sending [lanes, N, W], ok [lanes, N * F],
// the shared sizes nbytes [P]; lane 0's accumulators, each lane's
// `acc_stride` int64 slots after the one before.
extern "C" int corro_trace_wire_words_lanes(const void* sending,
                                            const void* nbytes,
                                            const void* ok, void* acc, int n,
                                            int w, int fanout, int acc_stride,
                                            int lanes, void* stream) {
  if (n <= 0 || w <= 0 || fanout <= 0 || lanes <= 0 || lanes > 65535 ||
      (lanes > 1 && acc_stride < 2))
    return (int)cudaErrorInvalidValue;
  trace_wire_words_kernel<<<dim3(grid_for((long long)n * kWarp), lanes),
                            kThreads, 0, (cudaStream_t)stream>>>(
      (const uint32_t*)sending, (const int32_t*)nbytes, (const bool*)ok,
      (unsigned long long*)acc, n, w, fanout, acc_stride);
  return (int)cudaGetLastError();
}

extern "C" int corro_trace_wire_rows(const void* row_frames,
                                     const void* row_bytes, const void* ok,
                                     void* acc, int n, int fanout,
                                     void* stream) {
  if (n <= 0 || fanout <= 0) return (int)cudaErrorInvalidValue;
  trace_wire_rows_kernel<<<grid_for(n), kThreads, 0, (cudaStream_t)stream>>>(
      (const int32_t*)row_frames, (const int32_t*)row_bytes, (const bool*)ok,
      (unsigned long long*)acc, n, fanout, 0);
  return (int)cudaGetLastError();
}

// The rows entry's lane form: row_frames, row_bytes [lanes, N], ok
// [lanes, N * F]; lane 0's accumulators, each lane's `acc_stride` int64
// slots after the one before.
extern "C" int corro_trace_wire_rows_lanes(const void* row_frames,
                                           const void* row_bytes,
                                           const void* ok, void* acc, int n,
                                           int fanout, int acc_stride,
                                           int lanes, void* stream) {
  if (n <= 0 || fanout <= 0 || lanes <= 0 || lanes > 65535 ||
      (lanes > 1 && acc_stride < 2))
    return (int)cudaErrorInvalidValue;
  trace_wire_rows_kernel<<<dim3(grid_for(n), lanes), kThreads, 0,
                           (cudaStream_t)stream>>>(
      (const int32_t*)row_frames, (const int32_t*)row_bytes, (const bool*)ok,
      (unsigned long long*)acc, n, fanout, acc_stride);
  return (int)cudaGetLastError();
}

// The pull entries: `ok` is ok_pull [E], `dst` the edges' responders.
extern "C" int corro_trace_wire_words_pull(const void* sending,
                                           const void* nbytes, const void* ok,
                                           const void* dst, void* acc,
                                           int n_edges, int w, void* stream) {
  if (n_edges <= 0 || w <= 0) return (int)cudaErrorInvalidValue;
  trace_wire_words_pull_kernel<<<grid_for((long long)n_edges * kWarp),
                                 kThreads, 0, (cudaStream_t)stream>>>(
      (const uint32_t*)sending, (const int32_t*)nbytes, (const bool*)ok,
      (const int32_t*)dst, (unsigned long long*)acc, n_edges, w, 0, 0);
  return (int)cudaGetLastError();
}

// The words pull entry's lane form: sending [lanes, N, W], ok_pull and
// dst [lanes, E] (lane-local responders), the shared sizes nbytes [P];
// lane 0's accumulators, each lane's `acc_stride` int64 slots after the
// one before.
extern "C" int corro_trace_wire_words_pull_lanes(const void* sending,
                                                 const void* nbytes,
                                                 const void* ok,
                                                 const void* dst, void* acc,
                                                 int n, int n_edges, int w,
                                                 int acc_stride, int lanes,
                                                 void* stream) {
  if (n <= 0 || n_edges <= 0 || w <= 0 || lanes <= 0 || lanes > 65535 ||
      (lanes > 1 && acc_stride < 2))
    return (int)cudaErrorInvalidValue;
  trace_wire_words_pull_kernel<<<dim3(grid_for((long long)n_edges * kWarp),
                                      lanes),
                                 kThreads, 0, (cudaStream_t)stream>>>(
      (const uint32_t*)sending, (const int32_t*)nbytes, (const bool*)ok,
      (const int32_t*)dst, (unsigned long long*)acc, n_edges, w, n,
      acc_stride);
  return (int)cudaGetLastError();
}

extern "C" int corro_trace_wire_rows_pull(const void* row_frames,
                                          const void* row_bytes,
                                          const void* ok, const void* dst,
                                          void* acc, int n_edges,
                                          void* stream) {
  if (n_edges <= 0) return (int)cudaErrorInvalidValue;
  trace_wire_rows_pull_kernel<<<grid_for(n_edges), kThreads, 0,
                                (cudaStream_t)stream>>>(
      (const int32_t*)row_frames, (const int32_t*)row_bytes, (const bool*)ok,
      (const int32_t*)dst, (unsigned long long*)acc, n_edges, 0, 0);
  return (int)cudaGetLastError();
}

// The rows pull entry's lane form: row_frames, row_bytes [lanes, N],
// ok_pull and dst [lanes, E]; lane 0's accumulators, each lane's
// `acc_stride` int64 slots after the one before.
extern "C" int corro_trace_wire_rows_pull_lanes(const void* row_frames,
                                                const void* row_bytes,
                                                const void* ok,
                                                const void* dst, void* acc,
                                                int n, int n_edges,
                                                int acc_stride, int lanes,
                                                void* stream) {
  if (n <= 0 || n_edges <= 0 || lanes <= 0 || lanes > 65535 ||
      (lanes > 1 && acc_stride < 2))
    return (int)cudaErrorInvalidValue;
  trace_wire_rows_pull_kernel<<<dim3(grid_for(n_edges), lanes), kThreads, 0,
                                (cudaStream_t)stream>>>(
      (const int32_t*)row_frames, (const int32_t*)row_bytes, (const bool*)ok,
      (const int32_t*)dst, (unsigned long long*)acc, n_edges, n, acc_stride);
  return (int)cudaGetLastError();
}
