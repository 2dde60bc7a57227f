// K15: the full-view SWIM belief update on [N, N] matrices — suspicion
// timeout, gossip and announce merge, apply and refute.
//
// Replaces corrosion_tpu/sim/swim.py:185 swim_step's matrix work
// (swim.py:239-313): the timeout (:239-242), the belief keys and the
// gossip rows' scatter-max (:259-263), the announce claims' scatter-max
// (:284), the apply (:289-293) and the diagonal refute (:299-313).  The
// plain versions are sim/swim.py swim_timeout_plain, swim_merge_plain and
// swim_apply_plain.  The probe (a one-cell-per-node write), the gossip
// edge list with its receiver filter, the announce draws and the
// feedback reads stay outside: they read the view BETWEEN the passes.
//
// A belief is the key vinc * 4 + view (i32), whose max is SWIM's
// precedence (higher incarnation, then DOWN > SUSPECT > ALIVE).  Three
// entry points, in round order:
//   timeout  one thread per cell: SUSPECT with since >= 0 and t - since
//            >= timeout turns DOWN (in place); key = vinc * 4 + view into
//            a buffer of its own.
//   merge    one thread per (gossip edge e, column c), and one per node
//            for its announce claim: merged[gdst[e], c] = max(...,
//            key[e / F, c]) where g_ok[e], merged[ann_target[i], i] =
//            max(..., claim[i]) where claim >= 0.  merged starts as a
//            copy of key; contributions are read from `key`, never from
//            `merged`, so no edge sees another's push (JAX's scatter reads
//            the pre-merge keys too).  atomicMax on i32 is order-free; a
//            contribution not above the receiver's own key is skipped
//            without an atomic, since merged never drops below key.
//   apply    one thread per cell: where merged > key the cell takes the
//            merged belief (view = merged % 4, vinc = merged / 4; a new
//            SUSPECT is stamped with t).  The diagonal thread of node i
//            then refutes when i is up and believes itself not ALIVE or
//            heard it is DOWN: its incarnation becomes max(incarnation,
//            fed-back incarnation, its own cell's vinc) + 1 and its cell
//            ALIVE at that incarnation — the same thread wrote the cell,
//            so it reads its own post-apply values.
//
// Bound on the H100: bytes.  timeout reads view, since and vinc and
// writes view and key (10 B a cell, 168 MB at N = 4096); merge reads the
// senders' and receivers' key rows (E * N * 8 B, 403 MB at 4096 nodes
// and F = 3) and atomics only where a push wins; apply reads view, vinc,
// since, key and merged and writes where changed.  Design: cell and
// (edge, column) threads run along the rows, so every row read is
// coalesced; the skip test keeps the atomics to the pushes that change a
// belief, which fall to a few per row once the views agree.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int ALIVE = 0;
constexpr int SUSPECT = 1;
constexpr int DOWN = 2;

__global__ void swim_timeout_kernel(int8_t* __restrict__ view,
                                    const int32_t* __restrict__ vinc,
                                    const int32_t* __restrict__ since,
                                    int32_t* __restrict__ key, size_t cells,
                                    int t, int timeout) {
  size_t i = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= cells) return;
  int v = view[i];
  if (v == SUSPECT) {
    int s = since[i];
    if (s >= 0 && t - s >= timeout) {
      v = DOWN;
      view[i] = (int8_t)DOWN;
    }
  }
  key[i] = vinc[i] * 4 + v;
}

__global__ void swim_merge_kernel(const int32_t* __restrict__ key,
                                  const int32_t* __restrict__ gdst,
                                  const bool* __restrict__ g_ok,
                                  const int32_t* __restrict__ ann_target,
                                  const int32_t* __restrict__ ann_claim,
                                  int32_t* __restrict__ merged, int n,
                                  int fanout) {
  size_t i = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  size_t gossip = (size_t)n * fanout * n;
  if (i < gossip) {
    size_t e = i / n;
    int c = (int)(i % n);
    if (!g_ok[e]) return;
    int d = gdst[e];
    // jnp scatters drop out-of-range updates; so does this one
    if (d < 0 || d >= n) return;
    int32_t x = key[(e / fanout) * n + c];
    size_t at = (size_t)d * n + c;
    if (x > key[at]) atomicMax(&merged[at], x);
  } else if (i < gossip + n) {
    int me = (int)(i - gossip);
    int32_t claim = ann_claim[me];
    int d = ann_target[me];
    if (claim < 0 || d < 0 || d >= n) return;
    size_t at = (size_t)d * n + me;
    if (claim > key[at]) atomicMax(&merged[at], claim);
  }
}

__global__ void swim_apply_kernel(int8_t* __restrict__ view,
                                  int32_t* __restrict__ vinc,
                                  int32_t* __restrict__ since,
                                  const int32_t* __restrict__ key,
                                  const int32_t* __restrict__ merged,
                                  const bool* __restrict__ up,
                                  const bool* __restrict__ heard_down,
                                  const int32_t* __restrict__ fb_inc,
                                  int32_t* __restrict__ incarnation, int n,
                                  int t) {
  size_t i = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= (size_t)n * n) return;
  int32_t m = merged[i];
  int v = view[i];
  int32_t inc = vinc[i];
  if (m > key[i]) {  // key >= 0, so m > 0 and % 4, / 4 are & 3, >> 2
    v = m & 3;
    inc = m >> 2;
    view[i] = (int8_t)v;
    vinc[i] = inc;
    if (v == SUSPECT) since[i] = t;
  }
  int row = (int)(i / n);
  if (row != (int)(i % n)) return;
  if (up[row] && (v != ALIVE || heard_down[row])) {
    int32_t bumped = incarnation[row];
    bumped = bumped > fb_inc[row] ? bumped : fb_inc[row];
    bumped = (bumped > inc ? bumped : inc) + 1;
    incarnation[row] = bumped;
    view[i] = (int8_t)ALIVE;
    vinc[i] = bumped;
  }
}

unsigned blocks_for(size_t threads_needed, int threads) {
  return (unsigned)((threads_needed + threads - 1) / threads);
}

}  // namespace

extern "C" int corro_swim_timeout(void* view, const void* vinc,
                                  const void* since, void* key, int n, int t,
                                  int timeout, void* stream) {
  if (n <= 0) return (int)cudaErrorInvalidValue;
  size_t cells = (size_t)n * n;
  swim_timeout_kernel<<<blocks_for(cells, 256), 256, 0,
                        (cudaStream_t)stream>>>(
      (int8_t*)view, (const int32_t*)vinc, (const int32_t*)since,
      (int32_t*)key, cells, t, timeout);
  return (int)cudaGetLastError();
}

extern "C" int corro_swim_merge(const void* key, const void* gdst,
                                const void* g_ok, const void* ann_target,
                                const void* ann_claim, void* merged, int n,
                                int fanout, void* stream) {
  if (n <= 0 || fanout <= 0) return (int)cudaErrorInvalidValue;
  size_t total = (size_t)n * fanout * n + n;
  swim_merge_kernel<<<blocks_for(total, 256), 256, 0,
                      (cudaStream_t)stream>>>(
      (const int32_t*)key, (const int32_t*)gdst, (const bool*)g_ok,
      (const int32_t*)ann_target, (const int32_t*)ann_claim,
      (int32_t*)merged, n, fanout);
  return (int)cudaGetLastError();
}

extern "C" int corro_swim_apply(void* view, void* vinc, void* since,
                                const void* key, const void* merged,
                                const void* up, const void* heard_down,
                                const void* fb_inc, void* incarnation, int n,
                                int t, void* stream) {
  if (n <= 0) return (int)cudaErrorInvalidValue;
  swim_apply_kernel<<<blocks_for((size_t)n * n, 256), 256, 0,
                      (cudaStream_t)stream>>>(
      (int8_t*)view, (int32_t*)vinc, (int32_t*)since, (const int32_t*)key,
      (const int32_t*)merged, (const bool*)up, (const bool*)heard_down,
      (const int32_t*)fb_inc, (int32_t*)incarnation, n, t);
  return (int)cudaGetLastError();
}
