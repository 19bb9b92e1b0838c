// Bucket-winner selection shared by the candidate scans (kernels B1, B4,
// B7, B10, B11): the TPU kernels' "packb" selection
// (video_quierer_tpu/ops/topk.py: _bucket_select_cols /
// _bucket_select_rows) as running lists.
//
// For every `bucket`-row range of the mirror and every query a scan keeps
// the top `rounds` rows by the packed int32 key
//     key = (bits(score + 2.0) & ~lowmask) + (lowmask - pos)
// (dead rows, position >= valid: bits term 0), lowmask = 2^ceil_log2(bucket)
// - 1, pos = row position inside the bucket, so the lowest position wins
// among scores equal at the packing resolution. Keys are unique inside a
// bucket, so the top `rounds` keys are well defined and can be kept as a
// running list while the rows stream past (the TPU kernel's second round,
// which knocks the first winner out with INT32_MIN, selects the same key).
// Output is the block-major layout [n_blocks, w, B], w = rounds *
// block_rows / bucket, entry r * nb + j for bucket j of a block: the
// winner's score (key floor unpacked, minus 2.0; -inf for an all-dead
// bucket) and its mirror position.
#pragma once

#include "common.cuh"

namespace vqt {

constexpr int MAXR = 4;    // most rounds a launch takes

// The R-key list top[0..R) of the tensor-core scans (R a compile-time
// count, so the list stays in registers) stays sorted descending; keys are
// unique, and INT_MIN pads sort last
template <int R>
__device__ __forceinline__ void insert(int (&top)[R], int key) {
#pragma unroll
  for (int r = 0; r < R; ++r) {
    const int hi = max(top[r], key);
    key = min(top[r], key);
    top[r] = hi;
  }
}

// The packed key of the row at bucket position `pos`. The bias add is
// rounded on its own (no contraction into a preceding multiply), as XLA
// computes it.
__device__ __forceinline__ int row_key(float score, bool live, int pos,
                                       int lowmask) {
  const int bits = live ? __float_as_int(__fadd_rn(score, 2.0f)) : 0;
  return (bits & ~lowmask) + (lowmask - pos);
}

// lowmask of a bucket: 2^max(ceil_log2(bucket), 1) - 1
inline int bucket_lowmask(int bucket) {
  int pbits = 1;
  while ((1 << pbits) < bucket) ++pbits;
  return (1 << pbits) - 1;
}

}  // namespace vqt
