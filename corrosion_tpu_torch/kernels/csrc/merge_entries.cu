// K4: partial-view SWIM table merge.
//
// Replaces corrosion_tpu/sim/pswim.py:103 _merge_entries: the fused
// gather of the receiver's bucket (pid, pkey, psince), the precedence
// scatter-max on pkey, the replacement scatter-max of pkey*2^18 + id,
// the post-merge recheck and the psince stamp.
//
// Pass 1, one thread per entry (N*F*(k+1) + N of them, 2.8M at the 100k
// storm): read the bucket from the PRE-merge tables (inputs, never
// written), then either atomicMax the entry's key into pkey_out (a
// matching id: belief precedence) or, for an ALIVE claim on an empty or
// aged-DOWN bucket, atomicMax key*2^18 + id into winner.  Entries with
// ok == 0 contribute jnp's -1, which cannot raise either maximum, so
// they return at once.  Pass 2, one thread per bucket: a winner claims
// a bucket that is STILL empty or DOWN in the merged pkey, and a changed
// key stamps psince (t for SUSPECT/DOWN, -1 for ALIVE).  i32 atomicMax
// is signed, like jnp's i32 max.
//
// Floor semantics: C's `%` and `/` truncate toward zero where jnp
// floors, and pkey carries -1 sentinels.  Every such operation here has
// a power-of-two divisor, so it is written as a mask or an arithmetic
// shift, which IS floor division on two's complement: key % 4 ->
// key & 3 (-1 -> 3, as jnp), winner // 2^18 -> winner >> 18, winner %
// 2^18 -> winner & (2^18 - 1).  The one non-power-of-two modulus, the
// bucket id % M, only runs on ids >= 0 (jnp's where(e_id >= 0, ..., 0)).
//
// Bound on the H100: bytes.  Pass 1 streams the four entry arrays and
// does one random 12-byte bucket read plus at most one random atomic per
// entry; pass 2 streams the three N*M tables in and out.  Design: the
// tables' pre-merge copies stay read-only inputs, so pass 1 needs no
// ordering between its reads and the atomics of other entries, and the
// wrapper's clone of pkey is the atomicMax target.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int ALIVE = 0;
constexpr int DOWN = 2;
constexpr int ID_BITS = 18;
constexpr int ID_CAP = 1 << ID_BITS;

__global__ void merge_scatter_kernel(
    const int32_t* __restrict__ pid, const int32_t* __restrict__ pkey,
    const int32_t* __restrict__ psince, int32_t* __restrict__ pkey_out,
    int32_t* __restrict__ winner, const int32_t* __restrict__ e_dst,
    const int32_t* __restrict__ e_id, const int32_t* __restrict__ e_key,
    const bool* __restrict__ e_ok, int n_entries, int n, int m, int t,
    int down_gc) {
  int e = blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= n_entries || !e_ok[e]) return;
  int id = e_id[e];
  int dst = e_dst[e];
  int bucket = id >= 0 ? id % m : 0;
  if (dst < 0 || dst >= n) return;
  size_t cell = (size_t)dst * m + bucket;
  int cur_id = pid[cell];
  int key = e_key[e];
  if (cur_id == id) {
    atomicMax(&pkey_out[cell], key);
    return;
  }
  int cur_key = pkey[cell];
  int cur_since = psince[cell];
  bool aged_down = (cur_key & 3) == DOWN &&
                   (cur_since < 0 || t - cur_since >= down_gc);
  if ((key & 3) == ALIVE && (cur_id < 0 || aged_down)) {
    atomicMax(&winner[cell], key * ID_CAP + id);
  }
}

__global__ void merge_apply_kernel(const int32_t* __restrict__ pid,
                                   const int32_t* __restrict__ pkey,
                                   const int32_t* __restrict__ psince,
                                   const int32_t* __restrict__ winner,
                                   int32_t* __restrict__ pid_out,
                                   int32_t* __restrict__ pkey_out,
                                   int32_t* __restrict__ psince_out,
                                   int cells, int t) {
  int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= cells) return;
  int id = pid[i];
  int key = pkey_out[i];
  int since = psince[i];
  int win = winner[i];
  bool still_free = id < 0 || (key & 3) == DOWN;
  if (win >= 0 && still_free) {
    id = win & (ID_CAP - 1);
    key = win >> ID_BITS;
    since = -1;
  }
  if (key != pkey[i]) since = (key & 3) != ALIVE ? t : -1;
  pid_out[i] = id;
  pkey_out[i] = key;
  psince_out[i] = since;
}

}  // namespace

extern "C" int corro_merge_entries(const void* pid, const void* pkey,
                                   const void* psince, void* pid_out,
                                   void* pkey_out, void* psince_out,
                                   void* winner, const void* e_dst,
                                   const void* e_id, const void* e_key,
                                   const void* e_ok, int n_entries, int n,
                                   int m, int t, int down_gc, void* stream) {
  if (n <= 0 || m <= 0 || n_entries < 0) return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  int threads = 256;
  if (n_entries > 0) {
    merge_scatter_kernel<<<(n_entries + threads - 1) / threads, threads, 0,
                           st>>>(
        (const int32_t*)pid, (const int32_t*)pkey, (const int32_t*)psince,
        (int32_t*)pkey_out, (int32_t*)winner, (const int32_t*)e_dst,
        (const int32_t*)e_id, (const int32_t*)e_key, (const bool*)e_ok,
        n_entries, n, m, t, down_gc);
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  int cells = n * m;
  merge_apply_kernel<<<(cells + threads - 1) / threads, threads, 0, st>>>(
      (const int32_t*)pid, (const int32_t*)pkey, (const int32_t*)psince,
      (const int32_t*)winner, (int32_t*)pid_out, (int32_t*)pkey_out,
      (int32_t*)psince_out, cells, t);
  return (int)cudaGetLastError();
}
