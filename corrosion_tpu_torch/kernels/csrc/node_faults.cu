// K11: a round's node faults on the slim state and the packed carry.
//
// Replaces corrosion_tpu/sim/faults.py:703 apply_node_faults (on the
// packed loop's slim state) and corrosion_tpu/sim/packed.py:989
// apply_carry_faults, which run_packed_faults (packed.py:1027) applies
// one after the other before every round.  The plain versions are
// sim.faults.apply_node_faults and sim.packed.apply_carry_faults.
//
// One thread per node n, in place:
//   - the alive override: alive[n] = ovr[n] where ovr[n] >= 0 (i8, -1
//     leaves the scenario's value);
//   - a wipe (crash-with-wipe restart) zeroes the node's have words, its
//     four relay planes, its row in every slot of both word rings, its
//     heads and gap intervals, and empties its member table (pid, pkey,
//     psince = -1).  Rows without a wipe are not touched; jax selects
//     every tensor every round, with the same result.  The sync
//     countdown and backoff, the incarnation and the sticky convergence
//     stamps survive a wipe, as in jax.
//
// Bound on the H100: launch latency.  The override reads and writes 4
// bytes a node (400 KB at N = 100000, ~0.1 µs of memory time); a wiped
// row is ~2.4 KB at the storm's shapes.  Design: the plain per-node pass;
// the rare wiped thread walks its own rows.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

__global__ void node_faults_kernel(
    const int8_t* __restrict__ ovr, const uint8_t* __restrict__ wipe,
    uint8_t* __restrict__ alive, uint32_t* __restrict__ have,
    uint32_t* __restrict__ r0, uint32_t* __restrict__ r1,
    uint32_t* __restrict__ r2, uint32_t* __restrict__ r3,
    uint32_t* __restrict__ inflight, uint32_t* __restrict__ sync_buf,
    int32_t* __restrict__ heads, int32_t* __restrict__ gap_lo,
    int32_t* __restrict__ gap_hi, int32_t* __restrict__ pid,
    int32_t* __restrict__ pkey, int32_t* __restrict__ psince, int n, int w,
    int d_slots, int a, int ak, int m) {
  int node = blockIdx.x * blockDim.x + threadIdx.x;
  if (node >= n) return;
  int8_t o = ovr[node];
  if (o >= 0) alive[node] = (uint8_t)o;
  if (!wipe[node]) return;
  size_t row = (size_t)node * w;
  for (int k = 0; k < w; ++k) {
    have[row + k] = 0u;
    r0[row + k] = 0u;
    r1[row + k] = 0u;
    r2[row + k] = 0u;
    r3[row + k] = 0u;
  }
  for (int s = 0; s < d_slots; ++s) {
    size_t slot_row = ((size_t)s * n + node) * w;
    for (int k = 0; k < w; ++k) {
      inflight[slot_row + k] = 0u;
      sync_buf[slot_row + k] = 0u;
    }
  }
  for (int j = 0; j < a; ++j) heads[(size_t)node * a + j] = 0;
  for (int j = 0; j < ak; ++j) {
    gap_lo[(size_t)node * ak + j] = 0;
    gap_hi[(size_t)node * ak + j] = 0;
  }
  for (int j = 0; j < m; ++j) {
    pid[(size_t)node * m + j] = -1;
    pkey[(size_t)node * m + j] = -1;
    psince[(size_t)node * m + j] = -1;
  }
}

}  // namespace

extern "C" int corro_node_faults(
    const void* ovr, const void* wipe, void* alive, void* have, void* r0,
    void* r1, void* r2, void* r3, void* inflight, void* sync_buf,
    void* heads, void* gap_lo, void* gap_hi, void* pid, void* pkey,
    void* psince, int n, int w, int d_slots, int a, int ak, int m,
    void* stream) {
  if (n <= 0 || w < 0 || d_slots < 0 || a < 0 || ak < 0 || m < 0)
    return (int)cudaErrorInvalidValue;
  int threads = 256;
  unsigned blocks = (unsigned)((n + threads - 1) / threads);
  node_faults_kernel<<<blocks, threads, 0, (cudaStream_t)stream>>>(
      (const int8_t*)ovr, (const uint8_t*)wipe, (uint8_t*)alive,
      (uint32_t*)have, (uint32_t*)r0, (uint32_t*)r1, (uint32_t*)r2,
      (uint32_t*)r3, (uint32_t*)inflight, (uint32_t*)sync_buf,
      (int32_t*)heads, (int32_t*)gap_lo, (int32_t*)gap_hi, (int32_t*)pid,
      (int32_t*)pkey, (int32_t*)psince, n, w, d_slots, a, ak, m);
  return (int)cudaGetLastError();
}
