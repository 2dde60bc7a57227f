// K17: the flight recorder's per-payload column counts.
//
// Replaces corrosion_tpu/sim/fused.py:109 word_bit_counts (per-bit-
// position set counts over the leading axis of u32 payload words) and
// corrosion_tpu/sim/telemetry.py:290 word_coverage_delivered (coverage =
// bits held by up nodes, delivered = bits held now and not at round
// start), with the dense round's bool branch of corrosion_tpu/sim/
// round.py:218-246.  The plain versions are sim/fused.py word_bit_counts
// and sim/telemetry.py coverage_delivered_plain.
//
// Three entry points, each ADDING its counts into i32[P] rows (the
// trace's per-round count rows, which K19 copies into the trace and
// zeroes):
//   words     one array [R, W]: out0[32k + b] += rows with bit b of
//             word k set — the sync grant counts over [E, W] granted
//             words (K3's telemetry output);
//   coverage  have, have0 [N, W] and alive [N]: out0 counts have of up
//             rows (alive == ALIVE), out1 counts have & ~have0;
//   dense     the same two counts from u8 have, have0 [N, P].
//
// Bound on the H100: bytes — at the storm the coverage entry reads have
// and have0 (2 x 6.4 MB) once, about 3.8 us; the grant entry reads
// [300000, 16] words.  Design, against the trap of per-bit global
// atomics (300k rows x 512 payloads would serialize on 512 addresses):
// a block covers up to 128 word columns and 256/cols rows a step, so
// consecutive threads read consecutive words; each thread keeps its
// column's 32 counters in registers, filled by SWAR nibble
// accumulators (four masked adds a word; a 4-bit lane holds at most 15
// rows, so they flush every 15 rows); the block sums its threads'
// counters in shared memory and issues one global add per payload.
// The dense entry gives each thread one column and a chunk of rows, so
// a warp reads 32 consecutive bytes of a row, and adds once per chunk.
//
// The dense entry's lane form (corro_trace_coverage_dense_lanes) counts
// a seed ensemble's lanes in one launch (corrosion_tpu/campaign/
// ensemble.py:114 vmaps round.py:218-246): blockIdx.z is the lane, whose
// have, have0 [N, P] and alive [N] are its slices of [K, ...] tensors
// (64-bit offsets) and whose two count rows are cov + k * out_stride and
// del + k * out_stride (the [K, 3, P] trace counts, 3 * P apart); lane k
// is the solo entry on lane k's inputs.  Bound: bytes, K times the solo
// entry's — 8 x 100000 x 512 x 2 bytes = 819 MB at the 8-lane dense
// fault storm, about 0.245 ms.
//
// The word entries' lane forms (corro_trace_counts_lanes,
// corro_trace_coverage_lanes: B16r's packed half, ensemble.py:114 vmaps
// packed.py:1302-1322 and telemetry.py:290) count a seed ensemble's lanes
// of the packed round in one launch: blockIdx.z is the lane, whose words
// (granted [E, W], or have and have0 [N, W] with alive [N]) are its
// slices of [K, ...] tensors (64-bit offsets: 8 x 300000 x 16 words pass
// 2^25 a lane, 2^31 bytes at 16 lanes) and whose count rows are out +
// k * out_stride; lane k is the solo entry on lane k's inputs.  Bound:
// bytes, K times the solo entry's — 8 x 19.2 MB of grants (0.046 ms) and
// 8 x 12.8 MB of have words (0.031 ms) at the 8-lane storm.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxCols = 128;
constexpr int kDenseRows = 64;

__device__ __forceinline__ void nib_add(uint32_t (&nib)[4], uint32_t v) {
#pragma unroll
  for (int j = 0; j < 4; ++j) nib[j] += (v >> j) & 0x11111111u;
}

// nibble q of nib[j] counts bit 4q + j
__device__ __forceinline__ void nib_flush(uint32_t (&nib)[4], int (&cnt)[32]) {
#pragma unroll
  for (int j = 0; j < 4; ++j) {
#pragma unroll
    for (int q = 0; q < 8; ++q) cnt[4 * q + j] += (int)((nib[j] >> (4 * q)) & 0xFu);
    nib[j] = 0u;
  }
}

__global__ void trace_counts_words_kernel(
    const uint32_t* __restrict__ words, const uint32_t* __restrict__ have0,
    const uint8_t* __restrict__ alive, int32_t* __restrict__ out0,
    int32_t* __restrict__ out1, int rows, int w, int cols, int step,
    int out_stride) {
  __shared__ int sums[2][kMaxCols * 32];
  const bool two = have0 != nullptr;
  {
    // the lane's slices (lane 0 on the solo entries)
    const size_t lane = blockIdx.z;
    words += lane * (size_t)rows * w;
    if (two) {
      have0 += lane * (size_t)rows * w;
      alive += lane * (size_t)rows;
      out1 += lane * (size_t)out_stride;
    }
    out0 += lane * (size_t)out_stride;
  }
  for (int i = threadIdx.x; i < 2 * kMaxCols * 32; i += blockDim.x)
    (&sums[0][0])[i] = 0;
  __syncthreads();
  int col = threadIdx.x % cols;
  int sub = threadIdx.x / cols;
  int k = blockIdx.y * cols + col;
  if (sub < step && k < w) {
    int c0[32], c1[32];
#pragma unroll
    for (int b = 0; b < 32; ++b) c0[b] = c1[b] = 0;
    uint32_t n0[4] = {0u, 0u, 0u, 0u}, n1[4] = {0u, 0u, 0u, 0u};
    int held = 0;
    for (int r = blockIdx.x * step + sub; r < rows; r += gridDim.x * step) {
      size_t at = (size_t)r * w + k;
      uint32_t v = words[at];
      if (two) {
        nib_add(n0, alive[r] == 0 ? v : 0u);
        nib_add(n1, v & ~have0[at]);
      } else {
        nib_add(n0, v);
      }
      if (++held == 15) {
        nib_flush(n0, c0);
        if (two) nib_flush(n1, c1);
        held = 0;
      }
    }
    nib_flush(n0, c0);
    if (two) nib_flush(n1, c1);
#pragma unroll
    for (int b = 0; b < 32; ++b) {
      if (c0[b]) atomicAdd(&sums[0][col * 32 + b], c0[b]);
      if (two && c1[b]) atomicAdd(&sums[1][col * 32 + b], c1[b]);
    }
  }
  __syncthreads();
  for (int i = threadIdx.x; i < cols * 32; i += blockDim.x) {
    int kk = blockIdx.y * cols + i / 32;
    if (kk >= w) continue;
    size_t q = (size_t)kk * 32 + (i % 32);
    if (sums[0][i]) atomicAdd(&out0[q], sums[0][i]);
    if (two && sums[1][i]) atomicAdd(&out1[q], sums[1][i]);
  }
}

__global__ void trace_counts_dense_kernel(const uint8_t* __restrict__ have,
                                          const uint8_t* __restrict__ have0,
                                          const uint8_t* __restrict__ alive,
                                          int32_t* __restrict__ cov,
                                          int32_t* __restrict__ del, int n,
                                          int p, int out_stride) {
  {
    // the lane's slices (lane 0 on the solo entry)
    const size_t lane = blockIdx.z;
    have += lane * (size_t)n * p;
    have0 += lane * (size_t)n * p;
    alive += lane * n;
    cov += lane * (size_t)out_stride;
    del += lane * (size_t)out_stride;
  }
  int q = blockIdx.x * blockDim.x + threadIdx.x;
  if (q >= p) return;
  int r0 = blockIdx.y * kDenseRows;
  int r1 = r0 + kDenseRows < n ? r0 + kDenseRows : n;
  int c = 0, d = 0;
  for (int r = r0; r < r1; ++r) {
    size_t at = (size_t)r * p + q;
    bool h = have[at] > 0;
    c += h && alive[r] == 0;
    d += h && have0[at] == 0;
  }
  if (c) atomicAdd(&cov[q], c);
  if (d) atomicAdd(&del[q], d);
}

int launch_words(const void* words, const void* have0, const void* alive,
                 void* out0, void* out1, int rows, int w, void* stream,
                 int out_stride = 0, int lanes = 1) {
  if (rows < 0 || w <= 0 || lanes <= 0 || lanes > 65535 ||
      (lanes > 1 && out_stride < w * 32))
    return (int)cudaErrorInvalidValue;
  if (rows == 0) return (int)cudaSuccess;
  int cols = w < kMaxCols ? w : kMaxCols;
  int tiles = (w + cols - 1) / cols;
  int step = kThreads / cols;
  // about 16 rows a thread, at most four blocks an SM over all tiles
  long long want = ((long long)rows + 16LL * step - 1) / (16LL * step);
  long long cap = 528 / tiles > 0 ? 528 / tiles : 1;
  unsigned bx = (unsigned)(want < cap ? (want > 0 ? want : 1) : cap);
  dim3 grid(bx, (unsigned)tiles, (unsigned)lanes);
  trace_counts_words_kernel<<<grid, kThreads, 0, (cudaStream_t)stream>>>(
      (const uint32_t*)words, (const uint32_t*)have0, (const uint8_t*)alive,
      (int32_t*)out0, (int32_t*)out1, rows, w, cols, step, out_stride);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int corro_trace_counts(const void* words, void* out, int rows,
                                  int w, void* stream) {
  return launch_words(words, nullptr, nullptr, out, nullptr, rows, w, stream);
}

extern "C" int corro_trace_coverage(const void* have, const void* have0,
                                    const void* alive, void* cov, void* del,
                                    int n, int w, void* stream) {
  if (have0 == nullptr || alive == nullptr || del == nullptr)
    return (int)cudaErrorInvalidValue;
  return launch_words(have, have0, alive, cov, del, n, w, stream);
}

extern "C" int corro_trace_coverage_dense(const void* have, const void* have0,
                                          const void* alive, void* cov,
                                          void* del, int n, int p,
                                          void* stream) {
  if (n < 0 || p <= 0) return (int)cudaErrorInvalidValue;
  if (n == 0) return (int)cudaSuccess;
  dim3 grid((unsigned)((p + kThreads - 1) / kThreads),
            (unsigned)((n + kDenseRows - 1) / kDenseRows));
  trace_counts_dense_kernel<<<grid, kThreads, 0, (cudaStream_t)stream>>>(
      (const uint8_t*)have, (const uint8_t*)have0, (const uint8_t*)alive,
      (int32_t*)cov, (int32_t*)del, n, p, 0);
  return (int)cudaGetLastError();
}

// The dense entry's lane form: have, have0 [lanes, N, P], alive
// [lanes, N]; lane 0's coverage and delivered rows, each lane's
// `out_stride` ints after the one before.
extern "C" int corro_trace_coverage_dense_lanes(
    const void* have, const void* have0, const void* alive, void* cov,
    void* del, int n, int p, int out_stride, int lanes, void* stream) {
  if (n < 0 || p <= 0 || lanes <= 0 || lanes > 65535 ||
      (lanes > 1 && out_stride < p))
    return (int)cudaErrorInvalidValue;
  if (n == 0) return (int)cudaSuccess;
  dim3 grid((unsigned)((p + kThreads - 1) / kThreads),
            (unsigned)((n + kDenseRows - 1) / kDenseRows), (unsigned)lanes);
  trace_counts_dense_kernel<<<grid, kThreads, 0, (cudaStream_t)stream>>>(
      (const uint8_t*)have, (const uint8_t*)have0, (const uint8_t*)alive,
      (int32_t*)cov, (int32_t*)del, n, p, out_stride);
  return (int)cudaGetLastError();
}

// The word entries' lane forms (B16r's packed half): the grant counts of
// words [lanes, R, W], and coverage and delivered from have, have0
// [lanes, N, W] and alive [lanes, N]; lane 0's count rows, each lane's
// `out_stride` ints after the one before.
extern "C" int corro_trace_counts_lanes(const void* words, void* out,
                                        int rows, int w, int out_stride,
                                        int lanes, void* stream) {
  return launch_words(words, nullptr, nullptr, out, nullptr, rows, w, stream,
                      out_stride, lanes);
}

extern "C" int corro_trace_coverage_lanes(const void* have, const void* have0,
                                          const void* alive, void* cov,
                                          void* del, int n, int w,
                                          int out_stride, int lanes,
                                          void* stream) {
  if (have0 == nullptr || alive == nullptr || del == nullptr)
    return (int)cudaErrorInvalidValue;
  return launch_words(have, have0, alive, cov, del, n, w, stream, out_stride,
                      lanes);
}
