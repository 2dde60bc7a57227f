// K4: partial-view SWIM table merge.
//
// Replaces corrosion_tpu/sim/pswim.py:103 _merge_entries: the fused
// gather of the receiver's bucket (pid, pkey, psince), the precedence
// scatter-max on pkey, the replacement scatter-max of pkey*2^18 + id,
// the post-merge recheck and the psince stamp.
//
// What held the first design back (0.2705 ms against a 0.0567 ms bound
// at the 100k storm's shapes, 21 %, H100 80GB HBM3 at 700.00 W): four
// device operations a call (a clone of pkey as the atomicMax target, a
// fill of the winner table, the two passes), and three random 4-byte
// reads an entry from three separate 25.6 MB tables (pid, pkey, psince;
// together more than the 50 MB L2), made whether or not the entry needed
// them — about 282 MB of streams plus three missed sectors per live
// entry against 190 MB of work.
//
// The design now:
// - One random read an entry.  The caller passes the packed pre-merge
//   table ptbl, (pkey+1) << 19 | (pid+1) as u32 (pswim._pack_tables,
//   which the step has already built for its sender checks; JAX's merge
//   packs the same word), so an entry reads one word for the bucket's id
//   and key.  The reads are lazy: a non-ALIVE claim that does not match
//   stops after that word, and psince is read only when an ALIVE claim
//   meets a DOWN bucket.  A matching claim that cannot raise the
//   bucket's key takes no atomic.
// - No clone, no fill.  Both maxima of a cell live in one interleaved
//   uint2 scratch cell, so an entry's atomic touches one sector:
//     .x  the precedence maximum, key ^ 2^31 (signed order as unsigned
//         order; every i32 key maps above 0 but INT_MIN, whose max is a
//         no-op anyway), 0 = no matching entry;
//     .y  the replacement winner, key*2^18 + id + 1 for a non-negative
//         packed value (jnp keeps -1 there, which never wins), 0 = none.
//   The scratch is the wrapper's, one per device and cell count, zeroed
//   once when allocated; the apply pass clears exactly the cells it finds
//   set, so the next call starts from zeros with no fill.
// - A vectorised apply pass: four cells a thread, 16-byte loads and
//   stores of pid, pkey, psince and the scratch (a scalar form when a
//   pointer is not 16-byte aligned, and for the tail when cells is not a
//   multiple of 4).  The recheck and the stamps are the first design's.
//
// Pass 1, one thread per entry (N*F*(k+1) + N of them, 2.8M at the 100k
// storm), reads only PRE-merge tables (inputs, never written), so it
// needs no ordering between its reads and other entries' atomics.
// Pass 2, one thread per four cells: a winner claims a bucket that is
// STILL empty or DOWN after the precedence maximum, and a changed key
// stamps psince (t for SUSPECT/DOWN, -1 for ALIVE).
//
// Floor semantics: C's `%` and `/` truncate toward zero where jnp
// floors, and pkey carries -1 sentinels.  Every such operation here has
// a power-of-two divisor, so it is written as a mask or an arithmetic
// shift, which IS floor division on two's complement: key % 4 ->
// key & 3 (-1 -> 3, as jnp), winner // 2^18 -> winner >> 18, winner %
// 2^18 -> winner & (2^18 - 1).  The one non-power-of-two modulus, the
// bucket id % M, only runs on ids >= 0 (jnp's where(e_id >= 0, ..., 0)).
// i32 maxima stay signed: the precedence field maps signed order onto
// unsigned order before its unsigned atomicMax, and the winner field
// only ever holds values >= 1.
//
// Bound on the H100: bytes, counted as the entry arrays once and the
// three N*M tables in and out (chip_smoke.py, e*13 + 3*N*M*4*2: 0.0567
// ms at the storm).  The scratch's 8 bytes a cell are read by the apply
// pass on top of that.
//
// Measured (H100 80GB HBM3 at 700.00 W, kernel_ab.py: the first design
// against this one in one call, medians of three): at the storm's shapes
// 0.1878 ms against 0.2728 (phase 3's draws: uniform receivers, 80 %
// live, half matching, so every entry is its own random sector and
// atomic); its 8-lane entry 1.4551 ms against 2.1902, bound 0.4537.  In
// storm-100k's first 3 rounds 0.1000 device ms a round (scatter 0.0355,
// apply 0.0645 — the apply pass streams 32 bytes a cell at ~3.2 TB/s)
// against the first design's 0.1363 and its clone and fill; 0.7712 a
// round on 8 lanes against 1.0335 and five more operations.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int ALIVE = 0;
constexpr int DOWN = 2;
constexpr int ID_BITS = 18;
constexpr int ID_CAP = 1 << ID_BITS;
constexpr int PACK_SHIFT = ID_BITS + 1;
constexpr uint32_t PACK_MASK = (1u << PACK_SHIFT) - 1u;
constexpr uint32_t SIGN = 0x80000000u;

__global__ void merge_scatter_kernel(
    const int32_t* __restrict__ psince, const uint32_t* __restrict__ ptbl,
    uint2* __restrict__ scratch, const int32_t* __restrict__ e_dst,
    const int32_t* __restrict__ e_id, const int32_t* __restrict__ e_key,
    const bool* __restrict__ e_ok, int n_entries, int n, int m, int t,
    int down_gc, int lane_entries) {
  int e = blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= n_entries || !e_ok[e]) return;
  int id = e_id[e];
  int dst = e_dst[e];
  if (dst < 0 || dst >= n) return;
  int bucket = id >= 0 ? id % m : 0;
  // the lane entry folds lane k's receivers into rows k * n + dst
  size_t row = (size_t)(lane_entries > 0 ? e / lane_entries : 0) * n + dst;
  size_t cell = row * m + bucket;
  int key = e_key[e];
  uint32_t word = __ldg(&ptbl[cell]);
  int cur_id = (int)(word & PACK_MASK) - 1;
  int cur_key = (int)(word >> PACK_SHIFT) - 1;
  if (cur_id == id) {  // belief precedence
    // a claim that cannot raise the bucket's key leaves the maximum as
    // it is, and takes no atomic
    if (key > cur_key) atomicMax(&scratch[cell].x, (uint32_t)key ^ SIGN);
    return;
  }
  if ((key & 3) != ALIVE) return;
  if (cur_id >= 0) {  // only an aged-DOWN bucket is free
    if ((cur_key & 3) != DOWN) return;
    int cur_since = __ldg(&psince[cell]);
    if (cur_since >= 0 && t - cur_since < down_gc) return;
  }
  // jnp's i32 product wraps; a negative packed value never wins
  int packed = (int)((uint32_t)key * (uint32_t)ID_CAP + (uint32_t)id);
  if (packed >= 0) atomicMax(&scratch[cell].y, (uint32_t)packed + 1u);
}

struct Cell {
  int id, key, since;
};

// One cell of the apply pass: the precedence maximum, the recheck and
// the replacement, the stamp.  Clears the scratch cell if it was set.
__device__ __forceinline__ Cell apply_cell(int id, int key0, int since,
                                           uint2 s, int t) {
  int key = key0;
  if (s.x != 0u) key = max(key, (int)(s.x ^ SIGN));
  bool still_free = id < 0 || (key & 3) == DOWN;
  if (s.y != 0u && still_free) {
    int win = (int)(s.y - 1u);
    id = win & (ID_CAP - 1);
    key = win >> ID_BITS;
    since = -1;
  }
  if (key != key0) since = (key & 3) != ALIVE ? t : -1;
  return Cell{id, key, since};
}

template <bool VEC>
__global__ void merge_apply_kernel(const int32_t* __restrict__ pid,
                                   const int32_t* __restrict__ pkey,
                                   const int32_t* __restrict__ psince,
                                   uint2* __restrict__ scratch,
                                   int32_t* __restrict__ pid_out,
                                   int32_t* __restrict__ pkey_out,
                                   int32_t* __restrict__ psince_out,
                                   long long cells, int t) {
  long long base = ((long long)blockIdx.x * blockDim.x + threadIdx.x) * 4;
  if (base >= cells) return;
  if (VEC && base + 4 <= cells) {
    int4 id = *reinterpret_cast<const int4*>(pid + base);
    int4 key = *reinterpret_cast<const int4*>(pkey + base);
    int4 since = *reinterpret_cast<const int4*>(psince + base);
    uint4* s4 = reinterpret_cast<uint4*>(scratch + base);
    uint4 s01 = s4[0], s23 = s4[1];
    Cell c0 = apply_cell(id.x, key.x, since.x, make_uint2(s01.x, s01.y), t);
    Cell c1 = apply_cell(id.y, key.y, since.y, make_uint2(s01.z, s01.w), t);
    Cell c2 = apply_cell(id.z, key.z, since.z, make_uint2(s23.x, s23.y), t);
    Cell c3 = apply_cell(id.w, key.w, since.w, make_uint2(s23.z, s23.w), t);
    *reinterpret_cast<int4*>(pid_out + base) =
        make_int4(c0.id, c1.id, c2.id, c3.id);
    *reinterpret_cast<int4*>(pkey_out + base) =
        make_int4(c0.key, c1.key, c2.key, c3.key);
    *reinterpret_cast<int4*>(psince_out + base) =
        make_int4(c0.since, c1.since, c2.since, c3.since);
    // clear exactly the cells found set
    const uint2 zero = make_uint2(0u, 0u);
    if (s01.x | s01.y) scratch[base] = zero;
    if (s01.z | s01.w) scratch[base + 1] = zero;
    if (s23.x | s23.y) scratch[base + 2] = zero;
    if (s23.z | s23.w) scratch[base + 3] = zero;
    return;
  }
  long long end = min(base + 4, cells);
  for (long long i = base; i < end; ++i) {
    uint2 s = scratch[i];
    Cell c = apply_cell(pid[i], pkey[i], psince[i], s, t);
    pid_out[i] = c.id;
    pkey_out[i] = c.key;
    psince_out[i] = c.since;
    if (s.x | s.y) scratch[i] = make_uint2(0u, 0u);
  }
}

bool aligned16(const void* p) { return ((uintptr_t)p & 15u) == 0u; }

}  // namespace

// ptbl is the packed pre-merge table; scratch is the wrapper's zeroed
// uint2[lanes * n * m], left zeroed again.  The tables
// are [lanes * n, m]; the entries, n_entries / lanes a lane, address
// their lane's n rows (lanes = 1: the solo entry).
extern "C" int corro_merge_entries(const void* pid, const void* pkey,
                                   const void* psince, const void* ptbl,
                                   void* pid_out, void* pkey_out,
                                   void* psince_out, void* scratch,
                                   const void* e_dst, const void* e_id,
                                   const void* e_key, const void* e_ok,
                                   int n_entries, int n, int m, int t,
                                   int down_gc, int lanes, void* stream) {
  if (ptbl == nullptr || n <= 0 || m <= 0 || n_entries < 0 || lanes <= 0 ||
      n_entries % lanes != 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  int threads = 256;
  if (n_entries > 0) {
    merge_scatter_kernel<<<(n_entries + threads - 1) / threads, threads, 0,
                           st>>>(
        (const int32_t*)psince, (const uint32_t*)ptbl, (uint2*)scratch,
        (const int32_t*)e_dst, (const int32_t*)e_id, (const int32_t*)e_key,
        (const bool*)e_ok, n_entries, n, m, t, down_gc,
        lanes > 1 ? n_entries / lanes : 0);
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  long long cells = (long long)lanes * n * m;
  long long quads = (cells + 3) / 4;
  unsigned blocks = (unsigned)((quads + threads - 1) / threads);
  bool vec = aligned16(pid) && aligned16(pkey) && aligned16(psince) &&
             aligned16(scratch) && aligned16(pid_out) &&
             aligned16(pkey_out) && aligned16(psince_out);
  auto apply = vec ? merge_apply_kernel<true> : merge_apply_kernel<false>;
  apply<<<blocks, threads, 0, st>>>(
      (const int32_t*)pid, (const int32_t*)pkey, (const int32_t*)psince,
      (uint2*)scratch, (int32_t*)pid_out, (int32_t*)pkey_out,
      (int32_t*)psince_out, cells, t);
  return (int)cudaGetLastError();
}
