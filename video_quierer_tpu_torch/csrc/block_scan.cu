// Kernels B8 and B9: the exact scans with per-tile or per-span top-k.
//
// Replace the TPU kernels video_quierer_tpu/ops/topk.py: _pallas_block_scan
// (B8, kernel body _scan_kernel with the deferred macro-block selection)
// over an f32 or a bf16 matrix, and _pallas_block_scan_int8 (B9, kernel
// body _scan_kernel_int8) over int8 codes with per-row f32 scales. For
// every `tile_rows`-row tile (f32 rows: 1,024 rows) or span (bf16 rows and
// int8 codes: the reference's macro of 8 x 1,024 = 8,192 rows) of the
// [N, D] matrix and every query it writes the top k rows (k <= 64) by
// (score desc, row asc): scores E @ q in f32 (B9: times the row's scale,
// rounded on its own), rows >= valid scored -inf (they still rank, lowest
// row first, below every live row), rows >= N absent. Lists shorter than k
// fill up with (-inf, INT32_MAX). Output [n_lists, B, k] in ascending row
// order, so a stable descending merge (ops/topk.py: merge_topk) gives the
// global top k with the lowest row first on ties, as the TPU kernels and
// their merge do: each list holds its rows' top k, and only the last one
// can be shorter than k, so the span does not change the merged result.
//
// The queries come in as f32, already rounded where the reference rounds
// them (ops/topk.py: to bf16 for a bf16 matrix; for B9 to bf16 when B > 1,
// exact f32 when B = 1 over whole 1,024-row blocks). Every product is the
// reference's product and only the summation order differs.
//
// Three tiles, chosen by row type and batch:
//
// * bf16 rows and int8 codes, every B: the span tile (span_kernel), on the
//   tensor cores. A bf16 row times a bf16 query is exact in f32, and so is
//   an int8 code times a bf16 query, so one bf16 wgmma product serves both
//   contracts with B > 1; B = 1 splits the f32 query into three bf16
//   parts, hi = bf16(q), mid = bf16(q - hi), lo = bf16(q - hi - mid),
//   whose sum is q to f32 precision (|q - hi - mid - lo| <= 2^-27 |q|):
//   three panel columns, each int8 x part product exact in f32, the score
//   (s_hi + s_mid) + s_lo (tests/test_torch_bf16_split.py holds the
//   emulated split to 1e-6 of f64).
// * f32 rows and B > 8: the 3xTF32 tensor-core tile (scan_tf32_kernel).
//   The reference scans f32 at Precision.HIGHEST, so each operand is split
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
// * f32 rows at B <= 8: the FMA tile (block_scan_kernel), f32 on the CUDA
//   cores, the sum over D in order, one FMA at a time (scores agree with
//   cuBLAS to ~1e-7 relative; rows differ only on ties within that). At
//   B = 1 the f32 scan reads ~80% of its byte bound on this tile.
//
// Bound on the H100 (NVIDIA H100 80GB HBM3, 700 W): one read of the matrix,
// 2M x 512 x 4 B = 4.1 GB, 1.22 ms at 3.35 TB/s (bf16 0.61 ms, int8 0.31
// plus the scales). The f32 products on the CUDA cores would take 2 N D B
// FLOP at 67 TFLOP/s, 1.96 ms at B = 64 (operations-bound from B ~ 40);
// as 3xTF32 they are 3 x 131 GFLOP at 495 TFLOP/s, 0.79 ms, under the byte
// bound, so the f32 scan is bytes-bound at every B. The span tile's bf16
// products are 131 GFLOP at 989 TFLOP/s, 0.14 ms at B = 64 (B = 1: three
// parts in a 16-wide panel), so bf16 and int8 are bytes-bound too; the
// span lists add 245 x B x k x 8 bytes (5 MB at B = 64, k = 40).
//
// The span tile (Hopper): a persistent grid of one CTA an SM, two
// warpgroups a CTA, each owning whole spans (245 spans at 2M rows over 264
// warpgroups; a warpgroup loops where there are more):
// - the warpgroup's spans stream as [64 rows, 128 bytes] boxes (64 bf16
//   or 128 codes) by TMA (128-byte swizzle) into its own ring of 8 KB
//   stages, guarded by full/empty mbarriers; thread 0 of the warpgroup
//   refills a stage once all four warps have retired it (no producer warp:
//   ptxas would budget three warpgroups); `stages` is chosen at launch
//   from k and the panel width, as many as fit beside the panel, parks and
//   lists (at most 12); spans wholly past `valid` are not read: their
//   lists are (-inf, the span's first rows), then pads;
// - the query panel (QN = 64 queries, or 16 for B <= 16, zero queries
//   padding a short chunk) is loaded once per CTA, swizzled as wgmma's B;
//   B > 64 runs ceil(B / 64) chunks as the grid's second dimension;
// - the products are wgmma m64nQNk16 bf16 with f32 accumulators over each
//   64-row tile; each ring stage sums into a fresh partial, added to the
//   score with one f32 add (the tensor core's accumulation over all of D
//   is coarse, as on the TF32 tile). bf16 rows are wgmma's A from shared
//   memory; int8 codes are widened to bf16 in registers into wgmma's A
//   fragment (widen4: two prmt and one f32 subtract a code pair and a half,
//   no I2F), each thread taking its 8 steps' fragments of a row with two
//   16-byte loads: the panel holds its columns in the same permuted order
//   (i8_column);
// - at the tile's end each thread scales its scores (B9's row scale,
//   __fmul_rn), sets rows past `valid` to -inf, and marks those that beat
//   their query's threshold; only a warp with a marked score parks it
//   ([query][row], bank-conflict-free by park_key) and sets its row's bit
//   in the query's mask (shared atomics), so once the span's top-k fill up
//   most tiles park nothing. Each query's top-k is a 4-ary heap in shared
//   memory, its root the worst entry, kept by one thread of the warpgroup
//   (every second one at QN = 64): after the next tile's products, that
//   thread sifts its query's marked rows in (a row beats the root only
//   with a higher score, rows being newer) and publishes the root's score
//   as the threshold (NaN while the root is a pad: any row beats it). The
//   span's end sorts each heap in place into list order. Two named
//   barriers a tile order the thresholds, the park and the masks. At
//   k = 40 a span takes about 40 (1 + ln 205) ~ 253 rows a query, 8x fewer
//   a row than 1,024-row tiles, and the merge sorts 245 lists.
//
// What the design went through (NVIDIA H100 80GB HBM3, 700 W; 2M x 512,
// ms at B = 64, k = 40, int8 / bf16; chip_smoke.py --exact-scans): with
// the ring and the products alone the tile streams near the byte rate,
// and the fold sets the rest. A warp-wide sorted-list fold (fold_half /
// fold_warp, one insert a warp at a time) read 2.15 / 2.21, a rank merge
// of each query's candidates 2.71 / 2.83; per-query heaps kept by one
// thread each 1.24 / 1.27; addressing shared memory through a pointer
// rounded as an integer had made every access a generic one (LD.E,
// GPU-scope ATOM), and an offset from smem_raw brought 1.02 / 1.02; the
// 4-ary heap 0.90 / 0.85 (8-ary: no faster). Inserting during the next
// tile's products, a two-partial pipeline of the 16-wide panel, one span a
// CTA, and two 32-query warpgroups a span (4 a CTA) were each no faster.
// Measured (same card, chip_smoke.py --ab against the FMA tile it
// replaces, ms, parent / this tile, 2M x 512): B9 at B = 64, k = 40 7.25 /
// 0.88 (bound 0.311: 35%), k = 10 5.86 / 0.70; at B = 1, k = 40 1.33 /
// 0.53 (58%), k = 10 1.20 / 0.44; B8 on bf16 rows at B = 64, k = 40 7.34 /
// 0.84 (bound 0.615: 73%), k = 10 5.91 / 0.74; at B = 1, k = 40 1.43 /
// 0.73 (84%), k = 10 1.31 / 0.69. B9 at B = 64 stays fold-bound: each
// warpgroup's threshold test and heap inserts run between its own tiles.
// The TF32 tile: a CTA owns one tile and 64 queries and walks the tile 128
// rows at a time, streaming the rows 32 deep through a 3-stage cp.async
// ring (16-byte copies, issued two stages ahead) and taking the queries'
// 32 columns of each stage into registers one stage ahead. Each stage is
// split once for the CTA: the rows' big parts in place, their small parts
// and the queries' two parts into panels laid out as wgmma's 128-byte
// swizzle reads them. Then each of the two warpgroups issues, per 8-deep
// step, three wgmma m64n64k8 TF32 products of its 64 rows against the 64
// queries, both operands from shared memory. A pass stages 128 rows and
// reads its 64 queries (from L2): 1.5 global bytes per row byte (the FMA
// tile at 64 queries: 2). A 256-row pass (1.25) does not fit two CTAs an
// SM: its accumulators and partials take all 128 registers, and its ring
// and score park exceed 113 KB; as one CTA an SM of four warpgroups it
// read 3.23-3.30 ms at B = 64 against this tile's 3.02-3.04 (NVIDIA H100
// 80GB HBM3, 700 W). The 128 x 64 scores of a pass are parked in the split
// panels' place and folded into each query's sorted list (fold_pair). Two
// CTAs share an SM (88 KB of shared memory at k = 10, 128 registers), so
// one CTA's splits and fold run under the other's products. On the same
// card, an mma.sync m16n8k8 version of this tile (the split in registers,
// 32 x 32 outputs a warp) read 3.2-3.3 ms at B = 64: its splits and
// fragment loads did not overlap the ring's copies.
#include "common.cuh"
#include "tma.cuh"
#include "topk_list.cuh"

#include <algorithm>

namespace {

using vqt::gmma_desc;
using vqt::mbar_arrive;
using vqt::mbar_expect;
using vqt::mbar_init;
using vqt::mbar_wait;
using vqt::smem_u32;
using vqt::tma_load;
using vqt::tma_load_1d;

constexpr int THREADS = 256;
constexpr int KC = 32;       // depth of one staging step
constexpr int KMAX = vqt::LIST_KMAX;  // most k a launch takes

// four consecutive matrix elements widened to f32
__device__ __forceinline__ float4 load4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}
// E: matrix element type (f32: only f32 rows at B <= 8 take this tile);
// scales multiply each row's f32 sum, or are null (always, now). Kept as
// the bf16 and int8 rows left it: compiled without the scales parameter,
// the B = 1 scan read 1.61 ms against 1.49 (NVIDIA H100 80GB HBM3, 700 W;
// chip_smoke.py --ab). QB queries per CTA, QPT x RPT outputs per thread
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

// -- bf16 rows and int8 codes, every B: the span tile --------------------

constexpr int S_TILE = 64;                  // rows of one wgmma tile
constexpr int S_STAGE = S_TILE * 128;       // one ring stage: 64 x 128 B
constexpr int S_WG = 2;                     // warpgroups of a CTA
constexpr int S_WARPS = 4;                  // warps of a warpgroup
constexpr int S_MAX_STAGES = 12;            // ring stages of a warpgroup
constexpr int MAX_DEVICES = 64;             // per-device host caches

// d (+)= A B^T, m64 nN k16 (N = 2 x the accumulators), bf16 operands, f32
// sums; A from shared memory (descriptor da) or from registers (a), B from
// shared memory; scale_d = 0 starts d from zero
__device__ __forceinline__ void mma(float (&d)[32], uint64_t da, uint64_t db,
                                    int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, %32, %33, p, 1, 1, 0, 0;\n}\n"
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

__device__ __forceinline__ void mma(float (&d)[8], uint64_t da, uint64_t db,
                                    int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %10, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7"
      "}, %8, %9, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7])
      : "l"(da), "l"(db), "r"(scale_d));
}

__device__ __forceinline__ void mma(float (&d)[32], const uint32_t (&a)[4],
                                    uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, {%32, %33, %34, %35}, %36, p, 1, 1, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(scale_d));
}

__device__ __forceinline__ void mma(float (&d)[8], const uint32_t (&a)[4],
                                    uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %13, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7"
      "}, {%8, %9, %10, %11}, %12, p, 1, 1, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(scale_d));
}

// Four int8 codes (one 32-bit word, bytes 0..3) as two bf16 pairs, exactly
// and without I2F: each byte, made offset-binary (x + 128), goes into the
// low byte of the f32 2^23 (one prmt), whose ulp is 1, so one f32
// subtract of 2^23 + 128 leaves x; |x| <= 128 has at most 8 significant
// bits, so the f32's high half is x in bf16 (one prmt a pair). lo holds
// bytes 0, 1 and hi bytes 2, 3, the lower byte in the low half.
__device__ __forceinline__ void widen4(uint32_t w, uint32_t& lo,
                                       uint32_t& hi) {
  const uint32_t u = w ^ 0x80808080u;
  const uint32_t m = 0x4B000000u;           // 2^23
  const float bias = 8388736.0f;            // 2^23 + 128
  const float x0 = __fsub_rn(__uint_as_float(__byte_perm(u, m, 0x7540)), bias);
  const float x1 = __fsub_rn(__uint_as_float(__byte_perm(u, m, 0x7541)), bias);
  const float x2 = __fsub_rn(__uint_as_float(__byte_perm(u, m, 0x7542)), bias);
  const float x3 = __fsub_rn(__uint_as_float(__byte_perm(u, m, 0x7543)), bias);
  lo = __byte_perm(__float_as_uint(x0), __float_as_uint(x1), 0x7632);
  hi = __byte_perm(__float_as_uint(x2), __float_as_uint(x3), 0x7632);
}

// The physical column of int8 panel column L. A k16 step kk of a 128-column
// box takes, in each row, the 4 bytes 32 t + 4 kk .. + 3 for the thread t
// (= lane % 4) of the A fragment's slots 2t, 2t + 1, 2t + 8, 2t + 9, so that
// a thread loads its fragments of 8 steps with two 16-byte loads a row; the
// query panel holds its columns in the same order (a dot product does not
// care about the order of its terms).
__device__ __forceinline__ int i8_column(int L) {
  const int c = L % 16, kk = L % 128 / 16;
  return L / 128 * 128 + 32 * (c % 8 / 2) + 4 * kk + 2 * (c / 8) + c % 2;
}

// a threshold no score is at or below: the root of the query's heap is a
// pad, so any row, even one scored -inf, beats it
#define NO_THRESHOLD __int_as_float(0x7fffffff)

// (v1, r1) ranks after (v2, r2): lower score, then higher row; pads
// (-inf, INT32_MAX) rank after every row and tie among themselves
__device__ __forceinline__ bool worse(float v1, int r1, float v2, int r2) {
  return v1 < v2 || (v1 == v2 && r1 > r2);
}

// Sift (v, r) down from slot i of the 4-ary heap (hv, hr)[0..n) whose root
// is its worst entry (children 4 i + 1 .. 4 i + 4 rank at or before their
// parent): half the depth of a binary heap, and a level's four children
// load together
__device__ __forceinline__ void sift_down(float* hv, int* hr, int n, int i,
                                          float v, int r) {
  for (int c = 4 * i + 1; c < n; c = 4 * i + 1) {
    int w = c;
    float wv = hv[c];
    int wr = hr[c];
#pragma unroll
    for (int o = 1; o < 4; ++o) {
      // past the heap's end: +inf, which is never the worse
      const float ov = c + o < n ? hv[c + o] : INFINITY;
      const int orr = c + o < n ? hr[c + o] : 0;
      if (worse(ov, orr, wv, wr)) {
        w = c + o;
        wv = ov;
        wr = orr;
      }
    }
    if (!worse(wv, wr, v, r)) break;
    hv[i] = wv;
    hr[i] = wr;
    i = w;
  }
  hv[i] = v;
  hr[i] = r;
}

// The heap (hv, hr)[0..k) sorted in place into list order, (score desc,
// row asc): the worst entry goes to the back, k - 1 times
__device__ __forceinline__ void heap_sort(float* hv, int* hr, int k) {
  for (int n = k - 1; n > 0; --n) {
    const float v = hv[n];
    const int r = hr[n];
    hv[n] = hv[0];
    hr[n] = hr[0];
    sift_down(hv, hr, n, 0, v, r);
  }
}

// Shared memory: the query panel [kb_n][QN][128 B] (128-byte swizzled, kb_n
// blocks of 64 panel columns), the warpgroups' rings [S_WG][stages][8 KB]
// and, beside each ring slot, the row scales of the tile whose first box it
// holds (B9) [S_WG][stages][S_TILE] f32, score parks [S_WG][QN][S_TILE]
// f32, the span's top-k of each query [S_WG][QN][ks] (f32 scores, then i32
// rows; a heap whose root is its worst entry while the span streams, sorted
// at its end; ks = k | 1 spreads the queries over the banks), the tile's
// rows that beat each query's root [S_WG][QN][2] (bit masks), the root's
// score [S_WG][QN] (NO_THRESHOLD while the root is a pad), the full and
// empty mbarriers [S_WG][stages] each.
// Warpgroup h = warp / 4 of CTA x owns spans 2 x + h, + 2 gridDim.x, ...;
// its warp wl holds rows 16 wl + g and 16 wl + g + 8 of each 64-row tile,
// queries 8 j + 2 t and 8 j + 2 t + 1 (g = lane / 4, t = lane % 4); thread
// ct = 128 / QN x c of the warpgroup keeps query c's heap. B = 1 (QN = 16)
// splits the f32 query into three bf16 parts, hi, mid and lo, panel
// columns 0, 1 and 8 (all held by the threads t = 0).
template <bool I8, int QN>
__global__ void __launch_bounds__(THREADS, 1)
span_kernel(const __grid_constant__ CUtensorMap emap,
            const __grid_constant__ CUtensorMap smap,
            const float* __restrict__ q, float* __restrict__ vals,
            int* __restrict__ idxs, int n, int d, int b, int valid, int k,
            int span, int stages) {
  constexpr int NACC = QN / 2;              // accumulators of a thread
  constexpr int KBOX = I8 ? 128 : 64;       // columns of one ring stage
  constexpr int OWN = S_WARPS * 32 / QN;    // threads a query's heap
  extern __shared__ uint8_t smem_raw[];
  // swizzle atoms sit on 1,024-byte boundaries; an offset from smem_raw
  // (not an address rounded as an integer) keeps every access below a
  // shared-memory one (LDS/STS/ATOMS, not generic loads)
  uint8_t* panel = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  const int kc_n = (d + KBOX - 1) / KBOX;   // ring stages of a tile
  const int kb_n = kc_n * KBOX / 64;        // panel blocks
  uint8_t* ring = panel + (size_t)kb_n * QN * 128;
  float* sbuf = reinterpret_cast<float*>(ring + (size_t)S_WG * stages *
                                                    S_STAGE);
  float* park = sbuf + S_WG * stages * S_TILE;
  const int ks = k | 1;                     // heap stride
  float* lvs = park + S_WG * QN * S_TILE;
  int* lis = reinterpret_cast<int*>(lvs + S_WG * QN * ks);
  unsigned* masks = reinterpret_cast<unsigned*>(lis + S_WG * QN * ks);
  float* thrs = reinterpret_cast<float*>(masks + S_WG * QN * 2);
  uint64_t* full = reinterpret_cast<uint64_t*>(thrs + S_WG * QN);
  uint64_t* empty = full + S_WG * stages;

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int h = warp / S_WARPS, wl = warp % S_WARPS;
  const int ct = tid % (S_WARPS * 32);
  const int g8 = lane / 4, t4 = lane % 4;
  const int q0 = blockIdx.y * QN;
  const bool split = b == 1;
  const int n_spans = (n + span - 1) / span;
  // spans from n_live on hold no live row: not read
  const int live = min(max(valid, 0), n);
  const int n_live = (live + span - 1) / span;
  const int gw = blockIdx.x * S_WG + h, gstep = gridDim.x * S_WG;
  const int tps = span / S_TILE;            // tiles of a whole span
  int total = 0;                            // ring stages of the warpgroup
  for (int sp = gw; sp < n_live; sp += gstep)
    total += (min(n, sp * span + span) - sp * span + S_TILE - 1) / S_TILE *
             kc_n;

  if (tid == 0) {
    for (int s = 0; s < S_WG * stages; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], S_WARPS);        // one arrival per warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  // the query panel: column L of query c (8 columns a 16-byte piece p) at
  // chunk p % 8 ^ (c % 8) of row c of block p / 8; zeros past b and d
  for (int i = tid; i < QN * kb_n * 8; i += THREADS) {
    const int c = i / (kb_n * 8), p = i % (kb_n * 8);
    uint32_t w[4];
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      float v[2];
#pragma unroll
      for (int f = 0; f < 2; ++f) {
        const int L = 8 * p + 2 * e + f;
        const int col = I8 ? i8_column(L) : L;
        float x = 0.f;
        if (col < d) {
          if (split) {
            // q = hi + mid + lo to f32 precision (each difference exact)
            const float qv = __ldg(q + col);
            const float hi = __bfloat162float(__float2bfloat16_rn(qv));
            const float r1 = __fsub_rn(qv, hi);
            const float mid = __bfloat162float(__float2bfloat16_rn(r1));
            const float lo =
                __bfloat162float(__float2bfloat16_rn(__fsub_rn(r1, mid)));
            x = c == 0 ? hi : c == 1 ? mid : c == 8 ? lo : 0.f;
          } else if (q0 + c < b) {
            x = __ldg(q + (size_t)(q0 + c) * d + col);
          }
        }
        v[f] = x;
      }
      const __nv_bfloat162 pair = __floats2bfloat162_rn(v[0], v[1]);
      w[e] = *reinterpret_cast<const uint32_t*>(&pair);
    }
    *reinterpret_cast<uint4*>(panel + (size_t)(p / 8) * QN * 128 + c * 128 +
                              (((p % 8) ^ (c % 8)) << 4)) =
        make_uint4(w[0], w[1], w[2], w[3]);
  }
  for (int i = tid; i < S_WG * QN * ks; i += THREADS) {
    lvs[i] = -INFINITY;
    lis[i] = INT_MAX;
  }
  for (int i = tid; i < S_WG * QN * 2; i += THREADS) masks[i] = 0u;
  for (int i = tid; i < S_WG * QN; i += THREADS) thrs[i] = NO_THRESHOLD;
  // the panel is written by the threads, read by wgmma (the async proxy)
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  __syncthreads();

  // The warpgroup's thread 0 issues its stages in order (the next one:
  // box i_kc of tile i_t of its live span i_sp, ring slot i_slot on its
  // use i_use) with the tile's row scales beside its first box (B9); a
  // refill first waits until all 4 warps are done with the slot. Running
  // counters, not divisions by the run-time ring depth.
  int issued = 0, i_slot = 0, i_use = 0, i_sp = gw, i_t = 0, i_kc = 0;
  auto issue = [&]() {
    const int slot = h * stages + i_slot;
    if (i_use > 0) mbar_wait(&empty[slot], (i_use - 1) & 1);
    const int row = i_sp * span + i_t * S_TILE;
    const bool scaled = I8 && i_kc == 0;
    mbar_expect(&full[slot], S_STAGE + (scaled ? S_TILE * 4 : 0));
    tma_load(ring + slot * S_STAGE, &emap, i_kc * KBOX, row, &full[slot]);
    if (scaled) tma_load_1d(sbuf + slot * S_TILE, &smap, row, &full[slot]);
    ++issued;
    if (++i_kc == kc_n) {
      i_kc = 0;
      if (++i_t == tps) {
        i_t = 0;
        i_sp += gstep;
      }
    }
    if (++i_slot == stages) {
      i_slot = 0;
      ++i_use;
    }
  };
  if (ct == 0)
    while (issued < stages && issued < total) issue();
  // the consumers' ring slot and its phase
  int c_slot = 0, c_phase = 0;
  // the stage in c_slot is done (its products retired): hand the slot
  // back, refill it, step to the next
  auto release = [&]() {
    if (lane == 0) mbar_arrive(&empty[h * stages + c_slot]);
    if (ct == 0 && issued < total) issue();
    if (++c_slot == stages) {
      c_slot = 0;
      c_phase ^= 1;
    }
  };

  float* sc = park + h * QN * S_TILE;
  float* lv = lvs + h * QN * ks;
  int* li = lis + h * QN * ks;
  unsigned* msk = masks + h * QN * 2;
  float* thr = thrs + h * QN;
  const uint32_t bq = smem_u32(panel);
  // this thread keeps query c's heap (if it exists); rows of tile p0 that
  // beat its root and still wait for their insert (bit masks pa, pb)
  const bool owner = ct % OWN == 0 && q0 + ct / OWN < b;
  const int c_own = ct / OWN, key_own = park_key(c_own);
  float* hv = lv + c_own * ks;
  int* hr = li + c_own * ks;
  unsigned pa = 0u, pb = 0u;
  int p0 = 0;
  // one waiting row into the heap (it may no longer beat the root)
  auto insert_one = [&]() {
    int r;
    if (pa) {
      r = __ffs(pa) - 1;
      pa &= pa - 1;
    } else {
      r = 32 + __ffs(pb) - 1;
      pb &= pb - 1;
    }
    const float v = sc[c_own * S_TILE + (r ^ key_own)];
    if (worse(hv[0], hr[0], v, p0 + r)) sift_down(hv, hr, k, 0, v, p0 + r);
  };
  for (int sp = gw; sp < n_spans; sp += gstep) {
    const int r_begin = sp * span, r_end = min(n, r_begin + span);
    if (sp >= n_live) {
      // every row dead: (-inf, the span's first rows), then pads, as the
      // plain version's stable order gives
      for (int i = ct; i < QN * k; i += S_WARPS * 32) {
        const int c = i / k, j = i % k;
        if (q0 + c < b) {
          const size_t o = ((size_t)sp * b + q0 + c) * k + j;
          vals[o] = -INFINITY;
          idxs[o] = r_begin + j < r_end ? r_begin + j : INT_MAX;
        }
      }
      continue;
    }
    for (int s0 = r_begin; s0 < r_end; s0 += S_TILE) {
      float acc[NACC], part[NACC];
#pragma unroll
      for (int e = 0; e < NACC; ++e) acc[e] = part[e] = 0.f;
      float scale_a = 1.f, scale_b = 1.f;   // rows 16 wl + g and + 8
      for (int kc = 0; kc < kc_n; ++kc) {
        const int slot = h * stages + c_slot;
        mbar_wait(&full[slot], c_phase);
        const uint8_t* box = ring + slot * S_STAGE;
        if (I8) {
          if (kc == 0) {
            scale_a = sbuf[slot * S_TILE + 16 * wl + g8];
            scale_b = sbuf[slot * S_TILE + 16 * wl + g8 + 8];
          }
          // this thread's 32 bytes of rows 16 wl + g (x) and + 8 (y): the
          // 16-byte chunks 2 t and 2 t + 1, swizzled by the row (g)
          const uint8_t* x = box + (16 * wl + g8) * 128;
          const uint4 x0 = *reinterpret_cast<const uint4*>(
              x + (((2 * t4) ^ g8) << 4));
          const uint4 x1 = *reinterpret_cast<const uint4*>(
              x + (((2 * t4 + 1) ^ g8) << 4));
          const uint4 y0 = *reinterpret_cast<const uint4*>(
              x + 8 * 128 + (((2 * t4) ^ g8) << 4));
          const uint4 y1 = *reinterpret_cast<const uint4*>(
              x + 8 * 128 + (((2 * t4 + 1) ^ g8) << 4));
          const uint32_t wx[8] = {x0.x, x0.y, x0.z, x0.w,
                                  x1.x, x1.y, x1.z, x1.w};
          const uint32_t wy[8] = {y0.x, y0.y, y0.z, y0.w,
                                  y1.x, y1.y, y1.z, y1.w};
          uint32_t a[8][4];
#pragma unroll
          for (int kk = 0; kk < 8; ++kk) {
            widen4(wx[kk], a[kk][0], a[kk][2]);
            widen4(wy[kk], a[kk][1], a[kk][3]);
          }
          asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
#pragma unroll
          for (int kk = 0; kk < 8; ++kk)
            // panel block 2 kc + kk / 4, 32 bytes a step along its rows
            mma(part, a[kk],
                gmma_desc(bq + (2 * kc + kk / 4) * QN * 128 + kk % 4 * 32,
                          16, 1024),
                kk);
        } else {
          const uint32_t ab = smem_u32(box);
          asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
#pragma unroll
          for (int kk = 0; kk < 4; ++kk)
            mma(part, gmma_desc(ab + kk * 32, 16, 1024),
                gmma_desc(bq + kc * QN * 128 + kk * 32, 16, 1024), kk);
        }
        asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
        asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
        release();
        // each stage's sum from zero, then one f32 add: the tensor core's
        // own accumulation over all of D is coarse
#pragma unroll
        for (int e = 0; e < NACC; ++e) acc[e] = __fadd_rn(acc[e], part[e]);
      }
      // the previous tile's marked rows into the heap; then its root is
      // the query's threshold
      if (owner) {
        while (pa | pb) insert_one();
        thr[c_own] = hr[0] == INT_MAX ? NO_THRESHOLD : hv[0];
      }
      if (split) {
        // the threads t = 0 hold column 0's score: (hi + mid) + lo
        acc[0] = __fadd_rn(__fadd_rn(acc[0], acc[1]), acc[4]);
        acc[2] = __fadd_rn(__fadd_rn(acc[2], acc[3]), acc[6]);
      }
      // once every heap holds the previous tile: the scores (times B9's
      // row scale, -inf past valid), and which of them beat their query's
      // root (bit 4 j + 2 e + hh)
      asm volatile("bar.sync %0, %1;\n" ::"r"(1 + h), "r"(S_WARPS * 32)
                   : "memory");
      unsigned marked = 0u;
#pragma unroll
      for (int j = 0; j < QN / 8; ++j) {
        const float2 th =
            *reinterpret_cast<const float2*>(thr + 8 * j + 2 * t4);
#pragma unroll
        for (int e = 0; e < 2; ++e)
#pragma unroll
          for (int hh = 0; hh < 2; ++hh) {
            const int c = 8 * j + 2 * t4 + e;
            const int r = 16 * wl + g8 + 8 * hh;
            float& v = acc[4 * j + 2 * hh + e];
            if (I8) v = __fmul_rn(v, hh ? scale_b : scale_a);
            if (s0 + r >= valid) v = -INFINITY;
            // rows are newer than the root's, so only a higher score beats
            // it, or any row a pad (a NaN threshold)
            if (q0 + c < b && s0 + r < r_end && !(v <= (e ? th.y : th.x)))
              marked |= 1u << (4 * j + 2 * e + hh);
          }
      }
      // park the marked scores as [query][row] and mark their rows in
      // their query's mask (for most tiles once the heaps fill, nothing in
      // the whole warp)
      if (__any_sync(0xffffffffu, marked != 0u)) {
#pragma unroll
        for (int j = 0; j < QN / 8; ++j)
#pragma unroll
          for (int e = 0; e < 2; ++e)
#pragma unroll
            for (int hh = 0; hh < 2; ++hh)
              if (marked >> (4 * j + 2 * e + hh) & 1u) {
                const int c = 8 * j + 2 * t4 + e;
                const int r = 16 * wl + g8 + 8 * hh;
                sc[c * S_TILE + (r ^ park_key(c))] = acc[4 * j + 2 * hh + e];
                atomicOr(&msk[2 * c + (r >> 5)], 1u << (r & 31));
              }
      }
      asm volatile("bar.sync %0, %1;\n" ::"r"(1 + h), "r"(S_WARPS * 32)
                   : "memory");
      // each heap's thread takes its query's marked rows, to insert once
      // the next tile's products are done
      if (owner) {
        pa = msk[2 * c_own];
        pb = msk[2 * c_own + 1];
        msk[2 * c_own] = msk[2 * c_own + 1] = 0u;
        p0 = s0;
      }
    }
    // the span's heaps are whole once the last tile's rows are in: sort
    // them into lists, write them, reset them for the next span
    if (owner) {
      while (pa | pb) insert_one();
      heap_sort(hv, hr, k);
    }
    asm volatile("bar.sync %0, %1;\n" ::"r"(1 + h), "r"(S_WARPS * 32)
                 : "memory");
    for (int i = ct; i < QN * k; i += S_WARPS * 32) {
      const int c = i / k, j = i % k;
      if (q0 + c < b) {
        const size_t o = ((size_t)sp * b + q0 + c) * k + j;
        vals[o] = lv[c * ks + j];
        idxs[o] = li[c * ks + j];
      }
      lv[c * ks + j] = -INFINITY;
      li[c * ks + j] = INT_MAX;
    }
    if (ct < QN) thr[ct] = NO_THRESHOLD;
  }
}

// the ring stages a span launch takes: as many as fit beside the panel, the
// parks, the heaps, the masks and thresholds, at most S_MAX_STAGES (< 2:
// the launch is refused)
int span_stages(bool i8, int d, int b, int k, int* smem) {
  int dev = 0;
  if (cudaGetDevice(&dev) != cudaSuccess || dev >= MAX_DEVICES) return -1;
  static int smem_optin[MAX_DEVICES];
  if (smem_optin[dev] == 0)
    cudaDeviceGetAttribute(&smem_optin[dev],
                           cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  const int qn = b <= 16 ? 16 : 64, kbox = i8 ? 128 : 64;
  const int kb_n = (d + kbox - 1) / kbox * kbox / 64;
  const long long fixed = 1024 + (long long)kb_n * qn * 128 +
                          (long long)S_WG * qn * S_TILE * 4 +
                          (long long)S_WG * qn * (k | 1) * 8 +
                          (long long)S_WG * qn * (2 * 4 + 4);
  // a slot: the box, its row scales, its full and empty mbarriers
  const long long per_stage =
      S_WG * (S_STAGE + S_TILE * 4 + 2 * sizeof(uint64_t));
  const int stages = (int)std::min<long long>(
      S_MAX_STAGES, std::max<long long>(0, (smem_optin[dev] - fixed) /
                                               per_stage));
  if (smem != nullptr) *smem = (int)(fixed + stages * per_stage);
  return stages;
}

template <bool I8, int QN>
int launch_span(const void* emb, const float* scales, const float* q,
                float* vals, int* idxs, int n, int d, int b, int valid, int k,
                int span, cudaStream_t stream) {
  int dev = 0;
  if (cudaGetDevice(&dev) != cudaSuccess || dev >= MAX_DEVICES)
    return (int)cudaErrorInvalidDevice;
  static int sm_count[MAX_DEVICES];
  if (sm_count[dev] == 0)
    cudaDeviceGetAttribute(&sm_count[dev], cudaDevAttrMultiProcessorCount,
                           dev);
  int smem = 0;
  const int stages = span_stages(I8, d, b, k, &smem);
  if (stages < 2) return (int)cudaErrorInvalidValue;   // D too wide
  CUtensorMap map, smap = {};
  if (!vqt::tensor_map(&map, emb, n, d, S_TILE,
                       I8 ? CU_TENSOR_MAP_DATA_TYPE_UINT8
                          : CU_TENSOR_MAP_DATA_TYPE_BFLOAT16) ||
      (I8 && !vqt::tensor_map_1d(&smap, scales, n, S_TILE)))
    return (int)cudaErrorInvalidValue;
  cudaError_t e = cudaFuncSetAttribute(
      span_kernel<I8, QN>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return (int)e;
  const int n_spans = (n + span - 1) / span;
  const int chunks = (b + QN - 1) / QN;
  const int ctas = std::max(
      1, std::min((n_spans + S_WG - 1) / S_WG, sm_count[dev] / chunks));
  span_kernel<I8, QN><<<dim3(ctas, chunks), THREADS, smem, stream>>>(
      map, smap, q, vals, idxs, n, d, b, valid, k, span, stages);
  return (int)cudaGetLastError();
}

template <bool I8>
int span_scan(const void* emb, const void* scales, const void* queries,
              void* vals, void* idxs, int n, int d, int b, int valid, int k,
              int span, cudaStream_t s) {
  // whole 64-row tiles a span; 16-byte aligned scales (B9's TMA)
  if (span % S_TILE || ((uintptr_t)scales & 15))
    return (int)cudaErrorInvalidValue;
  if (b <= 16)  // single queries and small batches: a 16-wide panel
    return launch_span<I8, 16>(emb, (const float*)scales,
                               (const float*)queries, (float*)vals,
                               (int*)idxs, n, d, b, valid, k, span, s);
  return launch_span<I8, 64>(emb, (const float*)scales, (const float*)queries,
                             (float*)vals, (int*)idxs, n, d, b, valid, k,
                             span, s);
}

}  // namespace

// dtype: vqt::DT_F32 or DT_BF16 (B8, scales null), DT_I8 (B9, scales
// [n] f32); tile_rows: the rows of one list (f32: a tile; bf16, int8: a
// span, a multiple of 64)
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
      return span_scan<false>(emb, nullptr, queries, vals, idxs, n, d, b,
                              valid, k, tile_rows, s);
    case vqt::DT_I8:
      return span_scan<true>(emb, scales, queries, vals, idxs, n, d, b, valid,
                             k, tile_rows, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

// the ring stages of each warpgroup that vqt_block_scan's span tile takes
// for bf16 rows or int8 codes (dtype) of width d, b queries and k
extern "C" int vqt_block_scan_stages(int d, int b, int k, int dtype) {
  if ((dtype != vqt::DT_BF16 && dtype != vqt::DT_I8) || d <= 0 || b <= 0 ||
      k < 1 || k > KMAX)
    return -1;
  return span_stages(dtype == vqt::DT_I8, d, b, k, nullptr);
}
