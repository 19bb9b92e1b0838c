// A sorted top-k list (k <= 64) of one query, kept in shared memory and
// updated by one warp: entries in (score desc, id asc) order. Shared by the
// exact scan (block_scan.cu, kernel B8) and the IVF probe scan
// (probe_scan.cu, kernel B12).
#pragma once

#include "common.cuh"

namespace vqt {

constexpr int LIST_KMAX = 64;  // most entries a list holds (two per lane)

// (v1, r1) ranks before (v2, r2): higher score, then lower id
__device__ __forceinline__ bool better(float v1, int r1, float v2, int r2) {
  return v1 > v2 || (v1 == v2 && r1 < r2);
}

// Insert (v, r) into the sorted list (lv, li)[0..k) of one query; the
// caller has checked that it beats the last entry. All 32 lanes call.
__device__ __forceinline__ void insert_sorted(float* lv, int* li, int k,
                                              float v, int r, int lane) {
  const unsigned full = 0xffffffffu;
  const int i0 = lane, i1 = lane + 32;
  const float a0 = i0 < k ? lv[i0] : -INFINITY;
  const int b0 = i0 < k ? li[i0] : INT_MAX;
  const float a1 = i1 < k ? lv[i1] : -INFINITY;
  const int b1 = i1 < k ? li[i1] : INT_MAX;
  const int pos =
      __popc(__ballot_sync(full, i0 < k && better(a0, b0, v, r))) +
      __popc(__ballot_sync(full, i1 < k && better(a1, b1, v, r)));
  // entry i - 1 for each of the lane's entries i
  const float p0 = __shfl_up_sync(full, a0, 1);
  const int q0 = __shfl_up_sync(full, b0, 1);
  float p1 = __shfl_up_sync(full, a1, 1);
  int q1 = __shfl_up_sync(full, b1, 1);
  const float x = __shfl_sync(full, a0, 31);
  const int y = __shfl_sync(full, b0, 31);
  if (lane == 0) {
    p1 = x;
    q1 = y;
  }
  __syncwarp();
  if (i0 < k && i0 >= pos) {
    lv[i0] = i0 == pos ? v : p0;
    li[i0] = i0 == pos ? r : q0;
  }
  if (i1 < k && i1 >= pos) {
    lv[i1] = i1 == pos ? v : p1;
    li[i1] = i1 == pos ? r : q1;
  }
  __syncwarp();
}

// Fold 32 candidates, one per lane (``here`` false for lanes without
// one), into the list: a ballot finds those that beat the last entry, and
// each is inserted in turn by the whole warp.
__device__ __forceinline__ void fold_warp(float* lv, int* li, int k, bool here,
                                          float v, int r, int lane) {
  unsigned mask = __ballot_sync(0xffffffffu,
                                here && better(v, r, lv[k - 1], li[k - 1]));
  while (mask) {
    const int src = __ffs(mask) - 1;
    mask &= mask - 1;
    const float cv = __shfl_sync(0xffffffffu, v, src);
    const int cr = __shfl_sync(0xffffffffu, r, src);
    if (better(cv, cr, lv[k - 1], li[k - 1]))
      insert_sorted(lv, li, k, cv, cr, lane);
  }
}

// The same list for k <= 16 held in registers while a warp folds two
// queries at once, one a half-warp: lane l of a half holds entry l (lanes
// >= k hold (-inf, INT_MAX) and are never written), and (tv, tr) the last
// entry, k - 1. The same order, ties and pads as fold_warp; an insert is a
// ballot and a shift by one lane, and the two halves' inserts run side by
// side.
struct HalfList {
  float v, tv;
  int r, tr;
};

constexpr int HALF_KMAX = 16;

__device__ __forceinline__ HalfList load_half_list(const float* lv,
                                                  const int* li, int k,
                                                  int hl) {
  HalfList l;
  l.v = hl < k ? lv[hl] : -INFINITY;
  l.r = hl < k ? li[hl] : INT_MAX;
  l.tv = __shfl_sync(0xffffffffu, l.v, k - 1, 16);
  l.tr = __shfl_sync(0xffffffffu, l.r, k - 1, 16);
  return l;
}

__device__ __forceinline__ void store_half_list(const HalfList& l, float* lv,
                                                int* li, int k, int hl) {
  if (hl < k) {
    lv[hl] = l.v;
    li[hl] = l.r;
  }
}

// Fold 16 candidates a half-warp, one a lane (``here`` false for lanes
// without one), into the half's list; hl = lane % 16, all 32 lanes call
__device__ __forceinline__ void fold_half(HalfList& l, int k, bool here,
                                          float v, int r, int hl, int half) {
  const unsigned full = 0xffffffffu;
  unsigned mask = (__ballot_sync(full, here && better(v, r, l.tv, l.tr)) >>
                   (16 * half)) & 0xffffu;
  while (__any_sync(full, mask != 0)) {
    const bool active = mask != 0;
    const int src = active ? __ffs(mask) - 1 : 0;
    mask &= mask - 1;
    const float cv = __shfl_sync(full, v, src, 16);
    const int cr = __shfl_sync(full, r, src, 16);
    const bool ins = active && better(cv, cr, l.tv, l.tr);  // per half
    const int pos = __popc((__ballot_sync(full, hl < k && better(l.v, l.r, cv,
                                                                 cr)) >>
                            (16 * half)) & 0xffffu);
    const float pv = __shfl_up_sync(full, l.v, 1, 16);
    const int pr = __shfl_up_sync(full, l.r, 1, 16);
    if (ins && hl >= pos && hl < k) {
      l.v = hl == pos ? cv : pv;
      l.r = hl == pos ? cr : pr;
    }
    l.tv = __shfl_sync(full, l.v, k - 1, 16);
    l.tr = __shfl_sync(full, l.r, k - 1, 16);
  }
}

}  // namespace vqt
