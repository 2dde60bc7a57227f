// K21: the PeerSwap view swap tick.
//
// Replaces corrosion_tpu/topo/sampler.py:81 peerswap_step (:96-131): each
// node's partner from its view slot c, the take of the partner's rotating
// slot t % V into slot g = (c + 1) % V, the offers of slot g landing in
// the partners' slot t % V by scatter-max, and the announce-staggered
// refill of an empty slot.  The plain versions are corrosion_tpu_torch/
// topo/sampler.py peerswap_partner_plain and peerswap_apply_plain.  The
// draws (c, rb, rid: K5's randint) and the swap message's reachability
// (swim._reachable: group, alive, the topology's loss via K20, a fault
// plan's cuts via K9) stay outside, between the passes.
//
// Three passes, one thread per node i each:
//   partner  pc[i] = max(pview[i, c[i]], 0), and winner[i] = -1 (the
//            offer buffer, so it needs no fill launch of its own);
//   swap     from the OLD view only: ok = the partner slot holds a peer
//            (>= 0) other than i, i is up and the message reached; node i
//            copies its row into the new view and, where ok and the
//            partner's slot t % V holds a peer other than i, writes it
//            into its slot g; where ok and its old slot g holds a peer
//            other than the partner, it offers that peer to the partner
//            with atomicMax on winner[pc] — JAX's `.at[pc].max` with -1
//            for no offer, so the result is the same deterministic max
//            whatever order the atomics land in;
//   land     where winner[i] >= 0 it replaces slot t % V of i's new row
//            (after the take: g == t % V happens, and then the offer
//            wins, as in JAX); then, on i's announce stagger (t + i) %
//            interval == 0, if i is up, its slot rb[i] is empty and
//            rid[i] != i, slot rb[i] takes rid[i].
// The partner's slot t % V can be overwritten in the same tick, so every
// read of the swap pass is of the old view and the new view is a second
// buffer (the out-of-place write the order of JAX's gathers needs); the
// land pass reads only the new view, after the swap pass has finished.
//
// Bound on the H100: bytes.  A tick reads the view once (N·V·4 bytes,
// plus one gathered partner slot a node) and writes the new view once;
// the per-node vectors are 4-5 ints a node.  At the 25.6k storm (V = 16)
// that is ~3.7 MB, ~1.1 µs at 3.35 TB/s — launch latency dominates.
// Design: one thread per node over its own 64-byte row, no shared memory.
//
// The lane entries (corro_peerswap_{partner,swap,land}_lanes) run the
// tick over a seed ensemble's lanes on the dense round (B16s:
// corrosion_tpu/campaign/ensemble.py:114 vmaps sampler.py:81) as a grid
// dimension: blockIdx.y is the lane, whose views [N, V], per-node
// vectors and offer buffer are its slices of the [K, ...] tensors,
// offset in 64 bits.  Peer ids stay lane-local, so a partner and its
// offer buffer are the lane's own: the scatter-max resolves inside each
// lane and a winner never crosses lanes.  Lane k is the solo entry on
// lane k's inputs.  Bound: K times the solo bound.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;

__device__ __forceinline__ int clamp_slot(int s, int v) {
  // jnp gathers clamp out-of-range indices; so do these
  return s < 0 ? 0 : (s >= v ? v - 1 : s);
}

__global__ void peerswap_partner_kernel(const int32_t* __restrict__ pview,
                                        const int32_t* __restrict__ c,
                                        int32_t* __restrict__ pc,
                                        int32_t* __restrict__ winner, int n, int v) {
  // the lane's slices (lane 0 on the solo entry)
  const size_t lane = blockIdx.y;
  pview += lane * n * v;
  c += lane * n;
  pc += lane * n;
  winner += lane * n;
  int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  int partner = pview[(size_t)i * v + clamp_slot(c[i], v)];
  pc[i] = partner > 0 ? partner : 0;
  winner[i] = -1;
}

__global__ void peerswap_swap_kernel(const int32_t* __restrict__ pview,
                                     const int32_t* __restrict__ c,
                                     const bool* __restrict__ reach,
                                     const uint8_t* __restrict__ alive,
                                     int32_t* __restrict__ out,
                                     int32_t* __restrict__ winner, int n, int v,
                                     int t) {
  // the lane's slices (lane 0 on the solo entry)
  const size_t lane = blockIdx.y;
  pview += lane * n * v;
  c += lane * n;
  reach += lane * n;
  alive += lane * n;
  out += lane * n * v;
  winner += lane * n;
  int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const int32_t* row = pview + (size_t)i * v;
  int32_t* dst = out + (size_t)i * v;
  int ci = clamp_slot(c[i], v);
  int g = (ci + 1) % v;
  int partner = row[ci];
  int pc = partner > 0 ? partner : 0;
  bool ok = partner >= 0 && pc != i && alive[i] == 0 && reach[i];
  int take = pview[(size_t)pc * v + t % v];
  bool take_ok = ok && take >= 0 && take != i;
  for (int s = 0; s < v; ++s) dst[s] = row[s];
  if (take_ok) dst[g] = take;
  int offer = row[g];
  if (ok && offer >= 0 && offer != pc) atomicMax(&winner[pc], offer);
}

__global__ void peerswap_land_kernel(int32_t* __restrict__ out,
                                     const int32_t* __restrict__ winner,
                                     const int32_t* __restrict__ rb,
                                     const int32_t* __restrict__ rid,
                                     const uint8_t* __restrict__ alive, int n, int v,
                                     int t, int interval) {
  // the lane's slices (lane 0 on the solo entry)
  const size_t lane = blockIdx.y;
  out += lane * n * v;
  winner += lane * n;
  rb += lane * n;
  rid += lane * n;
  alive += lane * n;
  int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  int32_t* row = out + (size_t)i * v;
  int win = winner[i];
  if (win >= 0) row[t % v] = win;
  int r = clamp_slot(rb[i], v);
  bool stagger = (t + i) % interval == 0;
  if (stagger && alive[i] == 0 && row[r] < 0 && rid[i] != i) row[r] = rid[i];
}

unsigned blocks_for(int n) { return (unsigned)((n + kThreads - 1) / kThreads); }

bool bad_lanes(int lanes) { return lanes <= 0 || lanes > 65535; }

}  // namespace

extern "C" int corro_peerswap_partner(const void* pview, const void* c,
                                      void* pc, void* winner, int n, int v,
                                      void* stream) {
  if (n <= 0 || v <= 0) return (int)cudaErrorInvalidValue;
  peerswap_partner_kernel<<<blocks_for(n), kThreads, 0,
                            (cudaStream_t)stream>>>(
      (const int32_t*)pview, (const int32_t*)c, (int32_t*)pc,
      (int32_t*)winner, n, v);
  return (int)cudaGetLastError();
}

extern "C" int corro_peerswap_swap(const void* pview, const void* c,
                                   const void* reach, const void* alive,
                                   void* out, void* winner, int n, int v,
                                   int t, void* stream) {
  if (n <= 0 || v <= 0 || t < 0) return (int)cudaErrorInvalidValue;
  peerswap_swap_kernel<<<blocks_for(n), kThreads, 0,
                         (cudaStream_t)stream>>>(
      (const int32_t*)pview, (const int32_t*)c, (const bool*)reach,
      (const uint8_t*)alive, (int32_t*)out, (int32_t*)winner, n, v, t);
  return (int)cudaGetLastError();
}

extern "C" int corro_peerswap_land(void* out, const void* winner,
                                   const void* rb, const void* rid,
                                   const void* alive, int n, int v, int t,
                                   int interval, void* stream) {
  if (n <= 0 || v <= 0 || t < 0 || interval <= 0)
    return (int)cudaErrorInvalidValue;
  peerswap_land_kernel<<<blocks_for(n), kThreads, 0,
                         (cudaStream_t)stream>>>(
      (int32_t*)out, (const int32_t*)winner, (const int32_t*)rb,
      (const int32_t*)rid, (const uint8_t*)alive, n, v, t, interval);
  return (int)cudaGetLastError();
}

// The lane entries: the solo entries' arguments with every view [lanes,
// N, V] and every per-node vector [lanes, N], then `lanes`.
extern "C" int corro_peerswap_partner_lanes(const void* pview, const void* c,
                                            void* pc, void* winner, int n,
                                            int v, int lanes, void* stream) {
  if (n <= 0 || v <= 0 || bad_lanes(lanes)) return (int)cudaErrorInvalidValue;
  peerswap_partner_kernel<<<dim3(blocks_for(n), lanes), kThreads, 0,
                            (cudaStream_t)stream>>>(
      (const int32_t*)pview, (const int32_t*)c, (int32_t*)pc,
      (int32_t*)winner, n, v);
  return (int)cudaGetLastError();
}

extern "C" int corro_peerswap_swap_lanes(const void* pview, const void* c,
                                         const void* reach, const void* alive,
                                         void* out, void* winner, int n, int v,
                                         int t, int lanes, void* stream) {
  if (n <= 0 || v <= 0 || t < 0 || bad_lanes(lanes))
    return (int)cudaErrorInvalidValue;
  peerswap_swap_kernel<<<dim3(blocks_for(n), lanes), kThreads, 0,
                         (cudaStream_t)stream>>>(
      (const int32_t*)pview, (const int32_t*)c, (const bool*)reach,
      (const uint8_t*)alive, (int32_t*)out, (int32_t*)winner, n, v, t);
  return (int)cudaGetLastError();
}

extern "C" int corro_peerswap_land_lanes(void* out, const void* winner,
                                         const void* rb, const void* rid,
                                         const void* alive, int n, int v,
                                         int t, int interval, int lanes,
                                         void* stream) {
  if (n <= 0 || v <= 0 || t < 0 || interval <= 0 || bad_lanes(lanes))
    return (int)cudaErrorInvalidValue;
  peerswap_land_kernel<<<dim3(blocks_for(n), lanes), kThreads, 0,
                         (cudaStream_t)stream>>>(
      (int32_t*)out, (const int32_t*)winner, (const int32_t*)rb,
      (const int32_t*)rid, (const uint8_t*)alive, n, v, t, interval);
  return (int)cudaGetLastError();
}
