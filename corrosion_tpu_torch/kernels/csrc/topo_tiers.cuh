// A topology's per-edge classes on the card, read from its int32 table
// (corrosion_tpu_torch/sim/topology.py topo_table): shared by K20 and the
// tiered instantiations of K10 and K12, so the tier of an edge has one
// device expression, as corrosion_tpu/sim/topology.py:315
// edge_loss_thresholds_raw is JAX's one tier-selection expression.
//
// Regions and AZs are contiguous blocks of node ids (topology.py:113
// regions, :120 azs): region(i) = min(i / per, R - 1) with per =
// max(1, N / R); the local AZ is min((i - region·per) / per_az, A - 1)
// with per_az = max(1, per / A), so the last region's and the last AZ's
// remainders clamp into them.  An edge's tier is 0 inside one AZ, 1
// across AZs of one region, 2 across regions (with one AZ a region is
// its own AZ, so tier 1 never occurs).

#pragma once

#include <cstdint>

namespace corro {

// the table's header slots (topology.py _T_*)
constexpr int kTopoPer = 1, kTopoRegions = 2, kTopoPerAz = 3, kTopoAzs = 4;
constexpr int kTopoThr = 5, kTopoDelay = 8, kTopoMatrix = 11;
constexpr int kTopoClasses = 12, kTopoClassesOff = 13, kTopoHeader = 16;

__device__ __forceinline__ int topo_region(const int32_t* tb, int i) {
  int r = i / tb[kTopoPer];
  int last = tb[kTopoRegions] - 1;
  return r < last ? r : last;
}

__device__ __forceinline__ int topo_az(const int32_t* tb, int i, int r) {
  int a = (i - r * tb[kTopoPer]) / tb[kTopoPerAz];
  int last = tb[kTopoAzs] - 1;
  return r * tb[kTopoAzs] + (a < last ? a : last);
}

// 0 same AZ, 1 cross-AZ inside a region, 2 cross-region
__device__ __forceinline__ int topo_tier(const int32_t* tb, int s, int d) {
  int rs = topo_region(tb, s), rd = topo_region(tb, d);
  if (rs != rd) return 2;
  return topo_az(tb, s, rs) == topo_az(tb, d, rd) ? 0 : 1;
}

// the edge's raw u8 loss threshold (p·256, unclamped: 256 or more is a
// certainty tier)
__device__ __forceinline__ int topo_loss_raw(const int32_t* tb, int s, int d) {
  return tb[kTopoThr + topo_tier(tb, s, d)];
}

// the edge's delay class in rounds: the measured matrix's entry for the
// two regions, else the tier's delay
__device__ __forceinline__ int topo_delay(const int32_t* tb, int s, int d) {
  if (tb[kTopoMatrix]) {
    int r = tb[kTopoRegions];
    return tb[kTopoHeader + topo_region(tb, s) * r + topo_region(tb, d)];
  }
  return tb[kTopoDelay + topo_tier(tb, s, d)];
}

// node i's fan-out cap, degree_classes[i % len] (topology.py:133
// node_degrees)
__device__ __forceinline__ int topo_degree(const int32_t* tb, int i) {
  return tb[tb[kTopoClassesOff] + i % tb[kTopoClasses]];
}

}  // namespace corro
