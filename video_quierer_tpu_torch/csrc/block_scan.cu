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
// Two tiles, chosen by row type and batch:
//
// * f32 rows and B > 8: a tensor-core tile (scan_tf32_kernel). The
//   reference scans f32 at Precision.HIGHEST, so each operand is split
//   into two TF32 parts, big = tf32(x) and small = tf32(x - big) (rounded
//   as cvt.rna rounds: to nearest, ties away from zero), and each 8-deep
//   step sums three products in f32: small.big, big.small, big.big.
//   |x - big - small| <= 2^-22 |x|, and the dropped small.small term is
//   below 2^-22 |a b|, so each product is good to about 2^-21 relative:
//   ~1e-8 absolute on a 512-wide dot of unit rows, the class of an FMA
//   chain's reordering error (~1e-7). The tensor core sums the products of
//   one instruction and its accumulator in its own order and rounding, and
//   its rounding is coarse: summed over all of D in one accumulator, the
//   scores of unit rows were off by up to 1.0e-6 against f64 (NVIDIA H100
//   80GB HBM3, 700 W). So each 32-deep ring stage sums into a fresh
//   partial, which is added to the score with one round-to-nearest f32
//   add: 9.1e-8 at most, against cuBLAS's 2.9e-7 on the same rows.
//   Exact inputs (multiples of 1/256, as in the tests) have small = 0 and
//   exact sums, and score bit for bit as the plain version.
// * bf16 and int8 rows, and f32 rows at B <= 8: the FMA tile
//   (block_scan_kernel), f32 on the CUDA cores, the sum over D in order,
//   one FMA at a time (scores agree with cuBLAS to ~1e-7 relative; rows
//   differ only on ties within that). At B = 1 the f32 scan reads ~80% of
//   its byte bound on this tile.
//
// Bound on the H100 (NVIDIA H100 80GB HBM3, 700 W): one read of the matrix,
// 2M x 512 x 4 B = 4.1 GB, 1.22 ms at 3.35 TB/s (bf16 half, int8 a quarter
// plus the scales). The f32 products on the CUDA cores would take 2 N D B
// FLOP at 67 TFLOP/s, 1.96 ms at B = 64 (operations-bound from B ~ 40);
// as 3xTF32 they are 3 x 131 GFLOP at 495 TFLOP/s, 0.79 ms, under the byte
// bound, so the f32 scan is bytes-bound at every B.
//
// What the TF32 tile does about it: a CTA owns one tile and 64 queries and
// walks the tile 128 rows at a time, streaming the rows 32 deep through a
// 3-stage cp.async ring (16-byte copies, issued two stages ahead) and
// taking the queries' 32 columns of each stage into registers one stage
// ahead. Each stage is split once for the CTA: the rows' big parts in
// place, their small parts and the queries' two parts into panels laid out
// as wgmma's 128-byte swizzle reads them. Then each of the two warpgroups
// issues, per 8-deep step, three wgmma m64n64k8 TF32 products of its 64
// rows against the 64 queries, both operands from shared memory. A pass
// stages 128 rows and reads its 64 queries (from L2): 1.5 global bytes per
// row byte (the FMA tile at 64 queries: 2). A 256-row pass (1.25) does not
// fit two CTAs an SM: its accumulators and partials take all 128
// registers, and its ring and score park exceed 113 KB; as one CTA an SM
// of four warpgroups it read 3.23-3.30 ms at B = 64 against this tile's
// 3.02-3.04 (NVIDIA H100 80GB HBM3, 700 W). The 128 x 64 scores of a pass
// are parked in the split panels' place and folded into each query's
// sorted list: for k <= 16 one query a half-warp, its list in registers
// (vqt::fold_half), else vqt::fold_warp. Two CTAs share an SM (88 KB of
// shared memory at k = 10, 128 registers), so one CTA's splits and fold
// run under the other's products. On the same card, an mma.sync m16n8k8
// version of this tile (the split in registers, 32 x 32 outputs a warp)
// read 3.2-3.3 ms at B = 64: its splits and fragment loads did not overlap
// the ring's copies. The bf16 and int8 products are exact in a bf16 MMA,
// so the tensor cores could take them too; that is a later kernel's work.
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

// -- f32 rows, B > 8: the 3xTF32 tensor-core tile -------------------------

constexpr int T_ROWS = 128;   // rows of one pass over D: two warpgroups x 64
constexpr int T_QB = 64;      // queries of one CTA: wgmma's N
constexpr int T_KC = 32;      // depth of one ring stage: one 128-byte row
constexpr int T_STAGES = 3;   // stages of the cp.async ring
constexpr int T_ROW_FL = T_ROWS * T_KC;   // floats of a stage of rows
constexpr int T_Q_FL = T_QB * T_KC;       // floats of a query panel
// the split panels (rows' small parts, queries' big and small parts) of
// one stage; the score park [T_QB][T_ROWS] takes their place at a pass end
constexpr int T_SPLIT_FL = T_ROW_FL + 2 * T_Q_FL;
static_assert(T_SPLIT_FL == T_QB * T_ROWS, "the park fills the split panels");

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared, asynchronously; zeros when !full
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src,
                                           bool full) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
               "l"(src), "r"(full ? 16 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// x rounded to TF32 as cvt.rna.tf32.f32 rounds it (to nearest, ties away
// from zero; the same bits for every finite x), in two integer operations
__device__ __forceinline__ uint32_t tf32_rna(float x) {
  return (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
}

// x = big + small + (at most 2^-22 |x|), both TF32, four at a time
__device__ __forceinline__ void split4(float4 x, uint4& big, uint4& small) {
  big = make_uint4(tf32_rna(x.x), tf32_rna(x.y), tf32_rna(x.z), tf32_rna(x.w));
  small = make_uint4(tf32_rna(x.x - __uint_as_float(big.x)),
                     tf32_rna(x.y - __uint_as_float(big.y)),
                     tf32_rna(x.z - __uint_as_float(big.z)),
                     tf32_rna(x.w - __uint_as_float(big.w)));
}

// float offset of 16-byte chunk j of row r in a [rows][T_KC] panel, laid
// out as wgmma's 128-byte swizzle reads it: 128-byte rows, the chunk
// index XOR (r mod 8) within each 1,024-byte group of 8 rows
__device__ __forceinline__ int swz(int r, int j) {
  return r * T_KC + ((j ^ (r & 7)) << 2);
}

// the park's row order for query c: a permutation within aligned 32-row
// blocks, so that the accumulator stores and the fold's loads hit 32
// distinct banks
__device__ __forceinline__ int park_key(int c) {
  return ((c & 7) << 2) ^ ((c & 8) << 1);
}

// wgmma shared-memory descriptor of a K-major panel, 128-byte swizzle:
// start address, stride of 1,024 bytes between 8-row groups
__device__ __forceinline__ uint64_t panel_desc(const float* p) {
  return (uint64_t)((smem_addr(p) & 0x3FFFF) >> 4) | (1ull << 16) |
         ((uint64_t)(1024 >> 4) << 32) | (1ull << 62);
}

// d (+)= A B^T: m64 n64 k8, TF32 operands from shared memory, f32 sums;
// scale_d = 0 starts d from zero
__device__ __forceinline__ void wgmma_tf32(float (&d)[32], uint64_t da,
                                           uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, %32, %33, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(scale_d));
}

// Fold the parked scores of rows s0 .. s0 + T_ROWS into the lists of
// queries c0 and c1 (those that exist), by one warp: for k <= 16 each
// half-warp folds one of them, else the whole warp one after the other
__device__ __forceinline__ void fold_pair(const float* sc, float* lv,
                                          int* li, int c0, int c1, int q0,
                                          int b, int s0, int r_end, int valid,
                                          int k, int lane) {
  if (k <= vqt::HALF_KMAX) {
    const int half = lane / 16, hl = lane % 16, c = half ? c1 : c0;
    const bool live = q0 + c < b;
    const float* qs = sc + c * T_ROWS;
    vqt::HalfList l = vqt::load_half_list(lv + c * k, li + c * k, k, hl);
    for (int r0 = 0; r0 < T_ROWS && s0 + r0 < r_end; r0 += 16) {
      const int row = s0 + r0 + hl;
      const bool here = live && row < r_end;
      const float v = !here        ? 0.f
                      : row < valid ? qs[(r0 + hl) ^ park_key(c)]
                                    : -INFINITY;
      vqt::fold_half(l, k, here, v, row, hl, half);
    }
    if (live) vqt::store_half_list(l, lv + c * k, li + c * k, k, hl);
    return;
  }
  for (int e = 0; e < 2; ++e) {
    const int c = e ? c1 : c0;
    if (q0 + c >= b) continue;
    const float* qs = sc + c * T_ROWS;
    for (int r0 = 0; r0 < T_ROWS && s0 + r0 < r_end; r0 += 32) {
      const int row = s0 + r0 + lane;
      const bool here = row < r_end;
      const float v = !here        ? 0.f
                      : row < valid ? qs[(r0 + lane) ^ park_key(c)]
                                    : -INFINITY;
      vqt::fold_warp(lv + c * k, li + c * k, k, here, v, row, lane);
    }
  }
}

// One CTA per (tile, chunk of T_QB queries); see the note at the top.
// Warpgroup wg computes rows 64 wg .. + 64 of each pass against all 64
// queries; warp w of it holds rows 16 w + g and 16 w + g + 8, queries
// 8 j + 2 t and 8 j + 2 t + 1 (j = 0..7) of them.
__global__ void __launch_bounds__(THREADS, 2)
scan_tf32_kernel(const float* __restrict__ emb, const float* __restrict__ q,
                 float* __restrict__ vals, int* __restrict__ idxs, int n,
                 int d, int b, int valid, int k, int tile_rows) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  // 128-byte swizzle atoms sit on 1,024-byte boundaries
  float* ring = reinterpret_cast<float*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  float* split = ring + T_STAGES * T_ROW_FL;   // [rows' small][q big][q small]
  float* rs = split;
  float* qb = split + T_ROW_FL;
  float* qsm = qb + T_Q_FL;
  float* sc = split;                           // the park: [T_QB][T_ROWS]
  float* lv = split + T_SPLIT_FL;              // [T_QB][k]
  int* li = reinterpret_cast<int*>(lv + T_QB * k);  // [T_QB][k]

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, t = lane % 4;
  const int wg = warp / 4, row0 = wg * 64 + warp % 4 * 16 + g;
  const int tile = blockIdx.x;
  const int q0 = blockIdx.y * T_QB;
  const int r_begin = tile * tile_rows;
  const int r_end = min(n, r_begin + tile_rows);
  const int steps = d / T_KC;                 // ring stages of one pass
  const int total = (r_end - r_begin + T_ROWS - 1) / T_ROWS * steps;

  for (int i = tid; i < T_QB * k; i += THREADS) {
    lv[i] = -INFINITY;
    li[i] = INT_MAX;
  }

  // stage s: columns (s % steps) T_KC .. + T_KC of the rows of pass
  // s / steps (rows past the tile read zeros)
  auto stage_in = [&](int s) {
    const int s0 = r_begin + s / steps * T_ROWS, kc = s % steps * T_KC;
    float* er = ring + s % T_STAGES * T_ROW_FL;
#pragma unroll
    for (int it = 0; it < T_ROW_FL / 4 / THREADS; ++it) {
      const int i = tid + it * THREADS, r = i / (T_KC / 4),
                j = i % (T_KC / 4);
      const bool in = s0 + r < r_end;
      cp_async16(smem_addr(er + swz(r, j)),
                 in ? emb + (size_t)(s0 + r) * d + kc + 4 * j : emb, in);
    }
  };
  // the queries of stage s into registers (queries past b are zeros)
  constexpr int QIT = T_Q_FL / 4 / THREADS;
  float4 qn[QIT];
  auto queries_in = [&](int s) {
    const int kc = s % steps * T_KC;
#pragma unroll
    for (int it = 0; it < QIT; ++it) {
      const int i = tid + it * THREADS, c = i / (T_KC / 4),
                j = i % (T_KC / 4);
      qn[it] = q0 + c < b ? __ldg(reinterpret_cast<const float4*>(
                                q + (size_t)(q0 + c) * d + kc + 4 * j))
                          : make_float4(0.f, 0.f, 0.f, 0.f);
    }
  };

  queries_in(0);
#pragma unroll
  for (int s = 0; s < T_STAGES - 1; ++s) {
    if (s < total) stage_in(s);
    cp_async_commit();
  }
  float acc[32], part[32];
#pragma unroll
  for (int e = 0; e < 32; ++e) acc[e] = part[e] = 0.f;

  for (int s = 0; s < total; ++s) {
    // stage s has landed; every warpgroup is done with the split panels
    // (its products of stage s - 1, and the fold, precede this barrier)
    cp_async_wait<T_STAGES - 2>();
    __syncthreads();
    if (s + T_STAGES - 1 < total) stage_in(s + T_STAGES - 1);
    cp_async_commit();
    // split stage s once for the CTA: the rows' big parts in place, their
    // small parts and the queries' parts into the split panels
    float* er = ring + s % T_STAGES * T_ROW_FL;
#pragma unroll
    for (int it = 0; it < T_ROW_FL / 4 / THREADS; ++it) {
      const int i = tid + it * THREADS;
      const int off = swz(i / (T_KC / 4), i % (T_KC / 4));
      uint4 big, small;
      split4(*reinterpret_cast<const float4*>(er + off), big, small);
      *reinterpret_cast<uint4*>(er + off) = big;
      *reinterpret_cast<uint4*>(rs + off) = small;
    }
#pragma unroll
    for (int it = 0; it < QIT; ++it) {
      const int i = tid + it * THREADS;
      const int off = swz(i / (T_KC / 4), i % (T_KC / 4));
      uint4 big, small;
      split4(qn[it], big, small);
      *reinterpret_cast<uint4*>(qb + off) = big;
      *reinterpret_cast<uint4*>(qsm + off) = small;
    }
    if (s + 1 < total) queries_in(s + 1);
    // the panels are written by the threads, read by wgmma (async proxy)
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    __syncthreads();
    // the stage's 32-deep partial sum, from zero: small.big, big.small,
    // big.big for each 8-deep step
    asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
    const float* ab = er + wg * 64 * T_KC;
    const float* as = rs + wg * 64 * T_KC;
#pragma unroll
    for (int ks = 0; ks < T_KC / 8; ++ks) {
      wgmma_tf32(part, panel_desc(as + ks * 8), panel_desc(qb + ks * 8),
                 ks);
      wgmma_tf32(part, panel_desc(ab + ks * 8), panel_desc(qsm + ks * 8), 1);
      wgmma_tf32(part, panel_desc(ab + ks * 8), panel_desc(qb + ks * 8), 1);
    }
    asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
    asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
#pragma unroll
    for (int e = 0; e < 32; ++e) acc[e] = __fadd_rn(acc[e], part[e]);
    if ((s + 1) % steps) continue;
    // the pass's scores are whole: once every warpgroup's products are
    // done, park them in the split panels' place as [query][row], then
    // fold
    __syncthreads();
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int c = 8 * j + 2 * t + (e & 1), r = row0 + 8 * (e >> 1);
        sc[c * T_ROWS + (r ^ park_key(c))] = acc[4 * j + e];
        acc[4 * j + e] = 0.f;
      }
    __syncthreads();
    const int s0 = r_begin + s / steps * T_ROWS;
    for (int m = 0; m < T_QB / 8; m += 2)
      fold_pair(sc, lv, li, warp + 8 * m, warp + 8 * m + 8, q0, b, s0, r_end,
                valid, k, lane);
  }
  cp_async_wait<0>();
  __syncthreads();
  for (int i = tid; i < T_QB * k; i += THREADS) {
    const int c = i / k, j = i % k;
    if (q0 + c < b) {
      const size_t o = ((size_t)tile * b + q0 + c) * k + j;
      vals[o] = lv[i];
      idxs[o] = li[i];
    }
  }
}

int launch_tf32(const float* emb, const float* q, float* vals, int* idxs,
                int n, int d, int b, int valid, int k, int tile_rows,
                cudaStream_t stream) {
  const size_t smem = 1024 +   // room to align the ring to 1,024 bytes
                      ((size_t)T_STAGES * T_ROW_FL + T_SPLIT_FL) *
                          sizeof(float) +
                      (size_t)T_QB * k * (sizeof(float) + sizeof(int));
  cudaError_t e = cudaFuncSetAttribute(
      scan_tf32_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  // the whole of the SM's shared memory, so that two CTAs fit
  if (e == cudaSuccess)
    e = cudaFuncSetAttribute(scan_tf32_kernel,
                             cudaFuncAttributePreferredSharedMemoryCarveout,
                             (int)cudaSharedmemCarveoutMaxShared);
  if (e != cudaSuccess) return (int)e;
  dim3 grid((n + tile_rows - 1) / tile_rows, (b + T_QB - 1) / T_QB);
  scan_tf32_kernel<<<grid, THREADS, smem, stream>>>(emb, q, vals, idxs, n, d,
                                                    b, valid, k, tile_rows);
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
      if (b > 8)  // coalesced batches: the 3xTF32 tensor-core tile
        return launch_tf32((const float*)emb, (const float*)queries,
                           (float*)vals, (int*)idxs, n, d, b, valid, k,
                           tile_rows, s);
      return launch<float, 8, 4, 2>((const float*)emb, nullptr,
                                    (const float*)queries, (float*)vals,
                                    (int*)idxs, n, d, b, valid, k, tile_rows,
                                    s);
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
