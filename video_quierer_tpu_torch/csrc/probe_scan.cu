// Kernel B12: the IVF probe scan.
//
// Replaces the TPU kernel video_quierer_tpu/index/ivf.py: _pallas_probe_scan
// (kernel body _ivf_scan_kernel, selection ops/topk.py: _block_topk_body).
// The IVF tier packs its rows cluster by cluster into TILE_ROWS-row tiles
// [T, TILE_ROWS, D] f32 with global row ids [T, TILE_ROWS] (-1 for padding).
// A search hands over a flat list of (tile, query) pairs; for pair p this
// kernel scores every row of tile tile_list[p] whose id is >= 0 against
// query qidx[p], exactly in f32 on the CUDA cores (FMA; no TF32, no bf16
// splits: the reference scores at Precision.HIGHEST), and writes the pair's
// top k <= 64 by (score desc, global id asc) to vals[p, :], idxs[p, :].
// Rows whose id is -1 are never read. A pair with fewer than k live rows
// pads with (-inf, -1), as _block_topk_body does when it selects among
// masked rows whose id is -1; the host merge keeps only ids >= 0.
//
// Queries are row-major [B, D] f32: the TPU kernel's transposed queries and
// one-hot column select were a lane-tiling workaround (ivf.py:72-84).
//
// Design (the simple one): one CTA per pair. The pair's query and the
// tile's ids go to shared memory. Each of the 8 warps streams 128 of the
// tile's rows, four rows in flight, each lane reading 16-byte vectors
// (neighbouring lanes on neighbouring addresses), and reduces each row by
// shuffles; every 32 rows the warp folds their scores into its own sorted
// list (topk_list.cuh, a ballot and a parallel insert). Then warp 0 folds
// the other seven lists into its own. Tile offsets are 64-bit: at 2M rows
// the tiles take ~4.3 GB, and t * TILE_ROWS * D passes 2^31 at tile 4,096.
//
// Bound on the H100: bytes. Each live pair reads one tile (1,024 x 512 x
// 4 B = 2 MiB) for 2 x 512 FLOP per row: 0.5 FLOP per byte against the
// card's ~20 at 67 TFLOP/s f32 and 3.35 TB/s. At B = 64 and 8 probes about
// 1,000 pairs are live (~2.1 GB). A tile probed by several queries is read
// once per pair here; reading it once for all of them is the next step.
#include "common.cuh"
#include "topk_list.cuh"

namespace {

constexpr int TILE_ROWS = 1024;
constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int WARP_ROWS = TILE_ROWS / WARPS;
constexpr int UNROLL = 4;   // rows in flight per warp

__global__ void __launch_bounds__(THREADS)
probe_scan_kernel(const float* __restrict__ tiles,
                  const int* __restrict__ ids,
                  const int* __restrict__ tile_list,
                  const int* __restrict__ qidx,
                  const float* __restrict__ queries,
                  float* __restrict__ vals, int* __restrict__ idxs, int d,
                  int b, int k) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int d4 = d / 4;
  float4* qs = reinterpret_cast<float4*>(smem_raw);         // [d4]
  int* sid = reinterpret_cast<int*>(qs + d4);                // [TILE_ROWS]
  float* lv = reinterpret_cast<float*>(sid + TILE_ROWS);     // [WARPS][k]
  int* li = reinterpret_cast<int*>(lv + WARPS * k);          // [WARPS][k]

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const size_t p = blockIdx.x;
  const int t = tile_list[p];
  const int q = qidx[p];
  // a pair naming no query or no tile yields pads only
  const bool ok = q >= 0 && q < b && t >= 0;
  if (ok) {
    const float4* qg = reinterpret_cast<const float4*>(queries +
                                                       (size_t)q * d);
    for (int i = tid; i < d4; i += THREADS) qs[i] = qg[i];
    const int* ig = ids + (size_t)t * TILE_ROWS;
    for (int i = tid; i < TILE_ROWS; i += THREADS) sid[i] = ig[i];
  }
  for (int i = tid; i < WARPS * k; i += THREADS) {
    lv[i] = -INFINITY;
    li[i] = INT_MAX;
  }
  __syncthreads();

  if (ok) {
    float* mv = lv + warp * k;
    int* mi = li + warp * k;
    const float4* tile =
        reinterpret_cast<const float4*>(tiles + (size_t)t * TILE_ROWS * d);
    for (int r0 = warp * WARP_ROWS; r0 < (warp + 1) * WARP_ROWS; r0 += 32) {
      float mine = -INFINITY;   // the score of row r0 + lane
      for (int r1 = 0; r1 < 32; r1 += UNROLL) {
        float acc[UNROLL];
        bool live[UNROLL];
#pragma unroll
        for (int u = 0; u < UNROLL; ++u) {
          live[u] = sid[r0 + r1 + u] >= 0;   // the same for every lane
          acc[u] = 0.f;
        }
#pragma unroll 4
        for (int c = lane; c < d4; c += 32) {
          const float4 w = qs[c];
#pragma unroll
          for (int u = 0; u < UNROLL; ++u) {
            if (live[u]) {
              const float4 x = __ldg(tile + (size_t)(r0 + r1 + u) * d4 + c);
              acc[u] = fmaf(x.x, w.x, acc[u]);
              acc[u] = fmaf(x.y, w.y, acc[u]);
              acc[u] = fmaf(x.z, w.z, acc[u]);
              acc[u] = fmaf(x.w, w.w, acc[u]);
            }
          }
        }
#pragma unroll
        for (int u = 0; u < UNROLL; ++u) {
          const float s = vqt::warp_sum(acc[u]);
          if (lane == r1 + u && live[u]) mine = s;
        }
      }
      const int id = sid[r0 + lane];
      vqt::fold_warp(mv, mi, k, id >= 0, mine, id, lane);
    }
  }
  __syncthreads();
  if (warp != 0) return;
  if (ok) {
    // warp 0 folds the other warps' lists (their live entries) into its own
    for (int w = 1; w < WARPS; ++w)
      for (int j0 = 0; j0 < k; j0 += 32) {
        const int j = j0 + lane;
        const bool here = j < k && lv[w * k + j] > -INFINITY;
        vqt::fold_warp(lv, li, k, here, here ? lv[w * k + j] : 0.f,
                       here ? li[w * k + j] : 0, lane);
      }
  }
  for (int j = lane; j < k; j += 32) {
    const bool live = lv[j] > -INFINITY;
    vals[p * k + j] = live ? lv[j] : -INFINITY;
    idxs[p * k + j] = live ? li[j] : -1;
  }
}

}  // namespace

extern "C" int vqt_probe_scan(const void* tiles, const void* ids,
                              const void* tile_list, const void* qidx,
                              const void* queries, void* vals, void* idxs,
                              int n_pairs, int d, int b, int k,
                              void* stream) {
  // whole 16-byte vectors per row; 16-byte aligned tiles and queries
  if (n_pairs < 0 || d <= 0 || d % 4 || b <= 0 || k < 1 ||
      k > vqt::LIST_KMAX || ((uintptr_t)tiles & 15) ||
      ((uintptr_t)queries & 15))
    return (int)cudaErrorInvalidValue;
  if (n_pairs == 0) return 0;
  const size_t smem = (size_t)d * sizeof(float) + TILE_ROWS * sizeof(int) +
                      (size_t)WARPS * k * (sizeof(float) + sizeof(int));
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        probe_scan_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  probe_scan_kernel<<<n_pairs, THREADS, smem, (cudaStream_t)stream>>>(
      (const float*)tiles, (const int*)ids, (const int*)tile_list,
      (const int*)qidx, (const float*)queries, (float*)vals, (int*)idxs, d,
      b, k);
  return (int)cudaGetLastError();
}
