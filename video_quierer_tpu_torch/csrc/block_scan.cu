// Kernels B8 and B9: the exact scans with per-tile top-k.
//
// Replace the TPU kernels video_quierer_tpu/ops/topk.py: _pallas_block_scan
// (B8, kernel body _scan_kernel with the deferred macro-block selection)
// over an f32 or a bf16 matrix, and _pallas_block_scan_int8 (B9, kernel
// body _scan_kernel_int8) over int8 codes with per-row f32 scales. For
// every `tile_rows`-row tile of the [N, D] matrix and every query it writes
// the tile's top k rows (k <= 64) by (score desc, row asc): scores E @ q in
// f32 (B9: times the row's scale, rounded on its own), rows >= valid scored
// -inf (they still rank, lowest row first, below every live row), rows >= N
// absent. Tiles shorter than k fill up with (-inf, INT32_MAX). Output
// [n_tiles, B, k] in ascending tile order, so a stable descending merge
// (ops/topk.py: merge_topk) gives the global top k with the lowest row
// first on ties, as the TPU kernels and their merge do.
//
// The queries come in as f32, already rounded where the reference rounds
// them (ops/topk.py: to bf16 for a bf16 matrix; for B9 to bf16 when B > 1,
// exact f32 when B = 1). The matrix elements are widened to f32 when they
// are staged (exact for bf16 and int8), so every product is the reference's
// product and only the summation order differs.
//
// Scores are f32 on the CUDA cores (FMA), no TF32 and no bf16 splits: the
// reference scans f32 at Precision.HIGHEST. The sum runs over D in order,
// one FMA at a time, so it rounds differently from cuBLAS and XLA (scores
// agree to ~1e-7 relative; rows differ only on ties within that).
//
// Design: one CTA per (tile, chunk of QB queries). Rows stream through in
// sub-tiles of SR rows; each sub-tile is a small SGEMM (row and query
// panels staged in shared memory 32 deep, RPT x QPT outputs per thread)
// whose scores are parked in shared memory. Then each warp folds the
// sub-tile into the running top-k lists of its queries, kept sorted in
// shared memory: a ballot finds the rows that beat the list's last entry,
// and each is inserted in parallel across the warp (lane l holds entries
// l and l + 32). On random data few rows qualify once a list is full.
//
// Bound on the H100: one read of the matrix (2M x 512 x 4 B = 4.1 GB,
// 1.23 ms at 3.35 TB/s; bf16 half, int8 a quarter plus the scales), or
// 2 N D B FLOP at 67 TFLOP/s f32 (2.0 ms at B = 64): the f32 FMA tile is
// operations-bound from B ~ 40 (bf16 ~ 20, int8 ~ 10). The bf16 and int8
// products are exact in f32, so the tensor cores (bf16 MMA, f32 sums)
// could take them; that is a later kernel's work.
#include "common.cuh"
#include "topk_list.cuh"

namespace {

constexpr int THREADS = 256;
constexpr int KC = 32;       // depth of one staging step
constexpr int KMAX = vqt::LIST_KMAX;  // most k a launch takes

// four consecutive matrix elements widened to f32 (16, 8 or 4 bytes)
__device__ __forceinline__ float4 load4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}
__device__ __forceinline__ float4 load4(const vqt::bf16* p) {
  const uint2 raw = *reinterpret_cast<const uint2*>(p);
  const float2 lo = __bfloat1622float2(
      *reinterpret_cast<const __nv_bfloat162*>(&raw.x));
  const float2 hi = __bfloat1622float2(
      *reinterpret_cast<const __nv_bfloat162*>(&raw.y));
  return make_float4(lo.x, lo.y, hi.x, hi.y);
}
__device__ __forceinline__ float4 load4(const int8_t* p) {
  const char4 c = *reinterpret_cast<const char4*>(p);
  return make_float4(c.x, c.y, c.z, c.w);
}

// E: matrix element type; scales (B9) multiply each row's f32 sum, or are
// null. QB queries per CTA, QPT x RPT outputs per thread
template <typename E, int QB, int QPT, int RPT>
__global__ void __launch_bounds__(THREADS)
block_scan_kernel(const E* __restrict__ emb,
                  const float* __restrict__ scales,
                  const float* __restrict__ q, float* __restrict__ vals,
                  int* __restrict__ idxs, int n, int d, int b, int valid,
                  int k, int tile_rows) {
  constexpr int TQ = QB / QPT;          // threads along queries
  constexpr int TR = THREADS / TQ;      // threads along rows
  constexpr int SR = TR * RPT;          // rows per sub-tile
  constexpr int LDK = KC + 1;
  constexpr int LDC = QB + 1;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* es = reinterpret_cast<float*>(smem_raw);   // [SR][LDK]
  float* qsm = es + SR * LDK;                         // [QB][LDK]
  float* sc = qsm + QB * LDK;                         // [SR][LDC]
  float* lv = sc + SR * LDC;                          // [QB][k]
  int* li = reinterpret_cast<int*>(lv + QB * k);      // [QB][k]

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int tq = tid % TQ, tr = tid / TQ;
  const int tile = blockIdx.x;
  const int q0 = blockIdx.y * QB;
  const int r_begin = tile * tile_rows;
  const int r_end = min(n, r_begin + tile_rows);

  for (int i = tid; i < QB * k; i += THREADS) {
    lv[i] = -INFINITY;
    li[i] = INT_MAX;
  }

  for (int s0 = r_begin; s0 < r_end; s0 += SR) {
    float acc[RPT][QPT];
#pragma unroll
    for (int i = 0; i < RPT; ++i)
#pragma unroll
      for (int j = 0; j < QPT; ++j) acc[i][j] = 0.f;
    for (int kc = 0; kc < d; kc += KC) {
      __syncthreads();
      for (int i = tid; i < SR * (KC / 4); i += THREADS) {
        const int r = i / (KC / 4), c = 4 * (i % (KC / 4));
        float4 x = make_float4(0.f, 0.f, 0.f, 0.f);
        if (s0 + r < r_end) x = load4(emb + (size_t)(s0 + r) * d + kc + c);
        float* e = es + r * LDK + c;
        e[0] = x.x;
        e[1] = x.y;
        e[2] = x.z;
        e[3] = x.w;
      }
      for (int i = tid; i < QB * (KC / 4); i += THREADS) {
        const int c4 = i / (KC / 4), c = 4 * (i % (KC / 4));
        float4 x = make_float4(0.f, 0.f, 0.f, 0.f);
        if (q0 + c4 < b)
          x = *reinterpret_cast<const float4*>(q + (size_t)(q0 + c4) * d +
                                               kc + c);
        float* e = qsm + c4 * LDK + c;
        e[0] = x.x;
        e[1] = x.y;
        e[2] = x.z;
        e[3] = x.w;
      }
      __syncthreads();
#pragma unroll 8
      for (int kk = 0; kk < KC; ++kk) {
        float a[RPT], w[QPT];
#pragma unroll
        for (int i = 0; i < RPT; ++i) a[i] = es[(tr + i * TR) * LDK + kk];
#pragma unroll
        for (int j = 0; j < QPT; ++j) w[j] = qsm[(tq + j * TQ) * LDK + kk];
#pragma unroll
        for (int i = 0; i < RPT; ++i)
#pragma unroll
          for (int j = 0; j < QPT; ++j) acc[i][j] = fmaf(a[i], w[j], acc[i][j]);
      }
    }
    // the previous sub-tile's fold is done (every warp passed the
    // barriers of this sub-tile's staging loop)
#pragma unroll
    for (int i = 0; i < RPT; ++i) {
      const int row = s0 + tr + i * TR;
      const float scale =
          scales != nullptr && row < r_end ? __ldg(scales + row) : 1.f;
#pragma unroll
      for (int j = 0; j < QPT; ++j)
        sc[(tr + i * TR) * LDC + tq + j * TQ] =
            scales != nullptr ? __fmul_rn(acc[i][j], scale) : acc[i][j];
    }
    __syncthreads();
    for (int c = warp; c < QB && q0 + c < b; c += THREADS / 32) {
      float* qv = lv + c * k;
      int* qi = li + c * k;
      for (int r0 = 0; r0 < SR && s0 + r0 < r_end; r0 += 32) {
        const int row = s0 + r0 + lane;
        const bool here = row < r_end;
        const float v = !here ? 0.f
                        : row < valid ? sc[(r0 + lane) * LDC + c]
                                      : -INFINITY;
        vqt::fold_warp(qv, qi, k, here, v, row, lane);
      }
    }
  }
  __syncthreads();
  for (int i = tid; i < QB * k; i += THREADS) {
    const int c = i / k, j = i % k;
    if (q0 + c < b) {
      const size_t o = ((size_t)tile * b + q0 + c) * k + j;
      vals[o] = lv[i];
      idxs[o] = li[i];
    }
  }
}

template <typename E, int QB, int QPT, int RPT>
int launch(const E* emb, const float* scales, const float* q, float* vals,
           int* idxs, int n, int d, int b, int valid, int k, int tile_rows,
           cudaStream_t stream) {
  constexpr int SR = THREADS / (QB / QPT) * RPT;
  const size_t smem = ((size_t)(SR + QB) * (KC + 1) +
                       (size_t)SR * (QB + 1) + (size_t)QB * k) *
                          sizeof(float) +
                      (size_t)QB * k * sizeof(int);
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        block_scan_kernel<E, QB, QPT, RPT>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  dim3 grid((n + tile_rows - 1) / tile_rows, (b + QB - 1) / QB);
  block_scan_kernel<E, QB, QPT, RPT><<<grid, THREADS, smem, stream>>>(
      emb, scales, q, vals, idxs, n, d, b, valid, k, tile_rows);
  return (int)cudaGetLastError();
}

template <typename E>
int scan(const void* emb, const void* scales, const void* queries,
         void* vals, void* idxs, int n, int d, int b, int valid, int k,
         int tile_rows, cudaStream_t s) {
  if (b <= 8)  // single queries and small batches: 8-query chunks
    return launch<E, 8, 4, 2>((const E*)emb, (const float*)scales,
                              (const float*)queries, (float*)vals,
                              (int*)idxs, n, d, b, valid, k, tile_rows, s);
  return launch<E, 64, 4, 4>((const E*)emb, (const float*)scales,
                             (const float*)queries, (float*)vals, (int*)idxs,
                             n, d, b, valid, k, tile_rows, s);
}

}  // namespace

// dtype: vqt::DT_F32 or DT_BF16 (B8, scales null), DT_I8 (B9, scales
// [n] f32)
extern "C" int vqt_block_scan(const void* emb, const void* scales,
                              const void* queries, void* vals, void* idxs,
                              int n, int d, int b, int valid, int k,
                              int tile_rows, int dtype, void* stream) {
  // whole 4-element vectors of KC-deep steps; 16-byte aligned operands
  if (n <= 0 || b <= 0 || d % KC || k < 1 || k > KMAX || tile_rows < 1 ||
      ((uintptr_t)emb & 15) || ((uintptr_t)queries & 15) ||
      (dtype == vqt::DT_I8) != (scales != nullptr))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  switch (dtype) {
    case vqt::DT_F32:
      return scan<float>(emb, scales, queries, vals, idxs, n, d, b, valid, k,
                         tile_rows, s);
    case vqt::DT_BF16:
      return scan<vqt::bf16>(emb, scales, queries, vals, idxs, n, d, b,
                             valid, k, tile_rows, s);
    case vqt::DT_I8:
      return scan<int8_t>(emb, scales, queries, vals, idxs, n, d, b, valid,
                          k, tile_rows, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}
