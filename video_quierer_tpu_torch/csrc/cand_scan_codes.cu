// Kernels B4, B7 and B11: candidate scans over the quantized mirrors (int8
// codes, and int4 codes packed two to a byte), one kernel template.
//
// Replace the TPU kernels video_quierer_tpu/ops/topk.py:
// _pallas_cand_scan_int8_prefix (B4, kernel body _cand_kernel_int8_prefix)
// and _pallas_cand_scan_int4_prefix (B7, _cand_kernel_int4_prefix) over the
// live-prefix mirrors of one card (row `pos` live when pos < valid), and
// _pallas_cand_scan_int8 (B11, _cand_kernel_int8) over the perm-layout int8
// mirror of a corpus shard (row `pos` live when perm[pos] < valid, the
// GLOBAL live count), all in their native form (int8 query codes,
// s8 x s8 -> s32 products). A row's score is
//     float(raw) * row_scale * query_scale
// rounded after each multiply, in that order, as the TPU kernels compute
// it; raw, the integer dot product, is exact (|raw| <= 127^2 D < 2^24), so
// the winners, their values and their positions are bit-identical to the
// plain version's. The selection and the output layout are those of
// cand_select.cuh (B1's); the caller merges the winners in the reference's
// row-orient candidate order.
//
// Bound on the H100: bytes. One read of the codes (2M x 512 B = 1.03 GB,
// ~0.31 ms at 3.35 TB/s; int4 half of that) plus the scales (and B11's
// perm); the s8 products need 2 N D B operations (0.27 ms at 1,979 TOP/s
// at B = 256).
//
// One tile serves all three (Hopper: B1's design, cand_scan.cu, on s8). A
// persistent grid of one CTA an SM, each CTA two independent halves over a
// contiguous range of buckets (half h takes every second bucket of it),
// each half one warpgroup:
// - the half's buckets stream as [64 rows, 128 bytes] boxes by TMA
//   (UINT8 tensor map, 128-byte swizzle) into the half's ring of 8 KB
//   stages behind full/empty mbarriers: 128 int8 codes a row (four k32
//   steps; a 64-row tile at D = 512 is four boxes), or 128 packed int4
//   bytes, 256 features (a tile at D = 512 is two boxes); each tile's 64
//   row scales (and, for B11, its 64 perm entries) ride with its first
//   box as 1-D TMA copies. Thread 0 of the warpgroup issues each refill
//   once all four warps are done with the stage (no producer warp: ptxas
//   budgets registers by whole warpgroups). Buckets of the live prefix
//   wholly past `valid` are not read;
// - the int8 query panel (QN = 64 queries, or 16 for B <= 16, zero codes
//   padding a short chunk) is loaded once per CTA in the swizzled K-major
//   layout wgmma reads as B; the query scales of a thread's columns stay
//   in registers;
// - wgmma.mma_async m64nQNk32 s32.s8.s8 sums each 64-row tile exactly,
//   then the tile's scores are folded straight from the accumulator
//   registers (the s32 fragment is owned as the f32 one: a thread holds 2
//   rows x QN/4 query columns): each element becomes its f32 score, then
//   its packed key, into the thread's running top-`rounds` list of its
//   column; at the bucket's end the lists merge across the 8 lanes of a
//   column (xor shuffles 4, 8, 16), then across the 4 warps through a few
//   KB of shared memory (double-buffered by bucket, one named barrier a
//   bucket), and one thread a query writes the winners. No score strip
//   goes through shared memory.
// B > 64 runs ceil(B / 64) query chunks as the grid's second dimension,
// each chunk reading the mirror. Buckets are whole 64-row tiles.
//
// int8 codes (B4, B11): wgmma reads A, the box, from shared memory.
// int4 (B7; wgmma has no s4 type): the split-halves pack (byte j: feature
// j in the low nibble, feature j + D/2 in the high nibble) reaches wgmma
// as A from registers. Each thread of a warp loads its rows' packed bytes
// from the swizzled stage (rows 16 w + g8 and + 8, 16-byte chunks 2 t4
// and 2 t4 + 1: conflict-free) and hands the stage back at once; per
// 32-bit word, w & 0xF0F0F0F0 is 16 x the high nibbles and
// (w << 4) & 0xF0F0F0F0 16 x the low ones, as s8 bytes, so the s32 sum is
// 16 x raw, exactly (|16 raw| <= 16 * 8 * 127 * D < 2^31), and raw is
// acc >> 4. A 16-byte chunk widens into four k32 fragments (low words 0-1,
// 2-3, high words 0-1, 2-3); a box's eight go out as one wgmma group,
// which runs while the warpgroup waits for and loads the next box, and
// the fragments are rewritten once it has retired (one group a box beat
// two groups a box with two fragment sets). The query panel holds its
// feature columns in that order (a chunk's four steps are one 128-column
// panel block; a dot product does not care about the order of its
// terms), with zeros past the packed row (TMA fills a box past D/2 with
// zero bytes, which widen to zero).
#include "cand_select.cuh"
#include "tma.cuh"

#include <algorithm>

namespace {

using vqt::gmma_desc;
using vqt::insert;
using vqt::mbar_arrive;
using vqt::mbar_expect;
using vqt::mbar_init;
using vqt::mbar_wait;
using vqt::MAXR;
using vqt::row_key;
using vqt::smem_u32;
using vqt::tma_load;
using vqt::tma_load_1d;

constexpr int TILE = 64;                    // mirror rows of one wgmma tile
constexpr int KBOX = 128;                   // bytes of a row in one TMA box
constexpr int STAGE_BYTES = TILE * KBOX;    // one ring stage: 8 KB
constexpr int HALVES = 2;                   // warpgroups of a CTA
constexpr int CWARPS = 4;                   // warps of a warpgroup
constexpr int THREADS = HALVES * CWARPS * 32;
constexpr int MAX_STAGES = 12;              // ring stages of a half
constexpr int MAX_DEVICES = 64;             // per-device host caches

// d (+)= A B^T: m64 nN k32, s8 A and B K-major in shared memory, exact s32
// sums; scale_d = 0 starts d from zero
__device__ __forceinline__ void wgmma_s8(int (&d)[32], uint64_t da,
                                         uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k32.s32.s8.s8 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, %32, %33, p;\n}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]),
        "+r"(d[4]), "+r"(d[5]), "+r"(d[6]), "+r"(d[7]),
        "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]),
        "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15]),
        "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]),
        "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]),
        "+r"(d[24]), "+r"(d[25]), "+r"(d[26]), "+r"(d[27]),
        "+r"(d[28]), "+r"(d[29]), "+r"(d[30]), "+r"(d[31])
      : "l"(da), "l"(db), "r"(scale_d));
}

__device__ __forceinline__ void wgmma_s8(int (&d)[8], uint64_t da,
                                         uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %10, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k32.s32.s8.s8 {"
      "%0, %1, %2, %3, %4, %5, %6, %7"
      "}, %8, %9, p;\n}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]),
        "+r"(d[4]), "+r"(d[5]), "+r"(d[6]), "+r"(d[7])
      : "l"(da), "l"(db), "r"(scale_d));
}

// The same with A from registers (the int4 rows): a[0] row g, k-slots
// 4 t .. 4 t + 3; a[1] row g + 8, the same slots; a[2], a[3] slots 16 on
// (g = lane / 4 + 16 x the warp of the warpgroup, t = lane % 4)
__device__ __forceinline__ void wgmma_s8(int (&d)[32], const uint32_t (&a)[4],
                                         uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k32.s32.s8.s8 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, {%32, %33, %34, %35}, %36, p;\n}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]),
        "+r"(d[4]), "+r"(d[5]), "+r"(d[6]), "+r"(d[7]),
        "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]),
        "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15]),
        "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]),
        "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]),
        "+r"(d[24]), "+r"(d[25]), "+r"(d[26]), "+r"(d[27]),
        "+r"(d[28]), "+r"(d[29]), "+r"(d[30]), "+r"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db),
        "r"(scale_d));
}

__device__ __forceinline__ void wgmma_s8(int (&d)[8], const uint32_t (&a)[4],
                                         uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %13, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k32.s32.s8.s8 {"
      "%0, %1, %2, %3, %4, %5, %6, %7"
      "}, {%8, %9, %10, %11}, %12, p;\n}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]),
        "+r"(d[4]), "+r"(d[5]), "+r"(d[6]), "+r"(d[7])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db),
        "r"(scale_d));
}

// 16 x the low and the high nibbles of four packed bytes, as s8 bytes
__device__ __forceinline__ uint32_t low16(uint32_t w) {
  return (w << 4) & 0xF0F0F0F0u;
}
__device__ __forceinline__ uint32_t high16(uint32_t w) {
  return w & 0xF0F0F0F0u;
}

// One box of packed int4 rows into the tile's sum, as one wgmma group:
// x0, x1 this thread's 16-byte chunks of row g, y0, y1 the same bytes of
// row g + 8. Each chunk widens into four k32 steps (the low nibbles of
// words 0-1 and 2-3, then the high ones), which read the four 32-column
// steps of its panel block (chunk 0's at bq, chunk 1's at bq + block).
// The fragments `a` must not be rewritten before the group has retired.
template <int NA>
__device__ __forceinline__ void box_products(int (&acc)[NA],
                                             uint32_t (&a)[8][4], uint4 x0,
                                             uint4 y0, uint4 x1, uint4 y1,
                                             uint32_t bq, uint32_t block,
                                             int first) {
  const uint32_t xw[8] = {x0.x, x0.y, x0.z, x0.w, x1.x, x1.y, x1.z, x1.w};
  const uint32_t yw[8] = {y0.x, y0.y, y0.z, y0.w, y1.x, y1.y, y1.z, y1.w};
#pragma unroll
  for (int v = 0; v < 8; ++v) {
    const int u = v % 4, m = 4 * (v / 4) + 2 * (u % 2);
    a[v][0] = u < 2 ? low16(xw[m]) : high16(xw[m]);
    a[v][1] = u < 2 ? low16(yw[m]) : high16(yw[m]);
    a[v][2] = u < 2 ? low16(xw[m + 1]) : high16(xw[m + 1]);
    a[v][3] = u < 2 ? low16(yw[m + 1]) : high16(yw[m + 1]);
  }
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
#pragma unroll
  for (int v = 0; v < 8; ++v)
    wgmma_s8(acc, a[v],
             gmma_desc(bq + (v / 4) * block + (v % 4) * 32, 16, 1024),
             first | v);
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

// Shared memory: the query panel [pblocks][QN][128 B] (128-byte swizzled;
// a block a box for int8 codes, two for int4), the halves' rings
// [HALVES][stages][8 KB], beside each slot the row
// scales [HALVES][stages][TILE] f32 and (B11) the perm entries
// [HALVES][stages][TILE] i32 of the tile whose first box it holds, the
// cross-warp lists [HALVES][2][CWARPS][QN][R], the full and empty
// mbarriers [HALVES][stages] each. Warps 0-3 and 4-7 are the halves'
// warpgroups; warp wl of a warpgroup holds rows 16 wl + g8 and + 8 of each
// tile, query columns 8 j + 2 t4 (+ 1), j < QN / 8 (g8 = lane / 4, t4 =
// lane % 4). I4: the rows are packed int4 (d features, d / 2 bytes).
template <int QN, int R, bool PERM, bool I4>
__global__ void __launch_bounds__(THREADS, 1)
cand_kernel_i8(const __grid_constant__ CUtensorMap cmap,
               const __grid_constant__ CUtensorMap smap,
               const __grid_constant__ CUtensorMap pmap,
               const int8_t* __restrict__ q,
               const float* __restrict__ qscale, float* __restrict__ vals,
               int* __restrict__ idxs, int d, int b, int valid, int bucket,
               int nb, int lowmask, int n_buckets, int stages) {
  constexpr int NC = QN / 4;                // query columns a thread owns
  constexpr int SIDE = TILE * 4 * (PERM ? 2 : 1);   // 1-D bytes a tile
  extern __shared__ uint8_t smem_raw[];
  // swizzle atoms sit on 1,024-byte boundaries; an offset from smem_raw
  // (not an address rounded as an integer) keeps every access a
  // shared-memory one
  uint8_t* panel = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  const int kc_n = ((I4 ? d / 2 : d) + KBOX - 1) / KBOX;  // boxes a tile
  uint8_t* ring = panel + (size_t)(I4 ? 2 * kc_n : kc_n) * QN * 128;
  float* sbuf = reinterpret_cast<float*>(ring + (size_t)HALVES * stages *
                                                    STAGE_BYTES);
  int* pbuf = reinterpret_cast<int*>(sbuf + HALVES * stages * TILE);
  int* red = pbuf + (PERM ? HALVES * stages * TILE : 0);
  uint64_t* full =
      reinterpret_cast<uint64_t*>(red + HALVES * 2 * CWARPS * QN * R);
  uint64_t* empty = full + HALVES * stages;

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int h = warp / CWARPS, wl = warp % CWARPS, ct = tid % (CWARPS * 32);
  const int g8 = lane / 4, t4 = lane % 4;
  const int q0 = blockIdx.y * QN;
  const int tpb = bucket / TILE;            // tiles of a bucket
  // the CTA's bucket range; half h takes g_begin + h, + h + 2, ...
  const int g_begin = (int)((long long)n_buckets * blockIdx.x / gridDim.x);
  const int g_end =
      (int)((long long)n_buckets * (blockIdx.x + 1) / gridDim.x);
  // live-prefix buckets from g_live on are wholly past valid: not read
  long long n_live = ((long long)valid + bucket - 1) / bucket;
  n_live = n_live < 0 ? 0 : n_live;
  const int g_live = PERM || n_live >= g_end ? g_end : (int)n_live;
  const int total =                         // ring stages of the half
      g_live > g_begin + h ? (g_live - g_begin - h + 1) / 2 * tpb * kc_n
                           : 0;

  if (tid == 0) {
    for (int s = 0; s < HALVES * stages; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], CWARPS);         // one arrival per warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  if constexpr (I4) {
    // the query panel: block 2 kc + r holds the features of chunk r of box
    // kc, in the order box_products feeds them: its 16-byte piece p (of
    // query c, at chunk p ^ (c % 8) of row c) is step p / 2's k-slots
    // 16 (p % 2) .., four bytes for each t = 0..3, i.e. packed bytes j =
    // 128 kc + 32 t + 16 r + 8 (p / 2 % 2) + 4 (p % 2) .. + 3: features j
    // (steps 0, 1) or j + d / 2 (steps 2, 3); zeros past b and the row
    const int half = d / 2, pieces = kc_n * 16;
    for (int i = tid; i < QN * pieces; i += THREADS) {
      const int c = i / pieces, blk = i % pieces / 8, p = i % 8;
      const int base = 128 * (blk / 2) + 16 * (blk % 2) + 8 * (p / 2 % 2) +
                       4 * (p % 2);
      uint32_t w[4] = {0u, 0u, 0u, 0u};
#pragma unroll
      for (int t = 0; t < 4; ++t)
        if (q0 + c < b && base + 32 * t < half)
          w[t] = __ldg(reinterpret_cast<const uint32_t*>(
              q + (size_t)(q0 + c) * d + base + 32 * t +
              (p >= 4 ? half : 0)));
      *reinterpret_cast<uint4*>(panel + (size_t)blk * QN * 128 + c * 128 +
                                ((p ^ (c % 8)) << 4)) =
          make_uint4(w[0], w[1], w[2], w[3]);
    }
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  } else {
    // the query panel: query c's 16-byte piece p (codes 16 p ..) at chunk
    // p % 8 ^ (c % 8) of row c of column block p / 8; zeros past b and d
    const int pieces = kc_n * 8, d16 = d / 16;
    for (int i = tid; i < QN * pieces; i += THREADS) {
      const int c = i / pieces, p = i % pieces;
      uint4 v = make_uint4(0u, 0u, 0u, 0u);
      if (q0 + c < b && p < d16)
        v = __ldg(reinterpret_cast<const uint4*>(q + (size_t)(q0 + c) * d +
                                                 16 * p));
      *reinterpret_cast<uint4*>(panel + (size_t)(p / 8) * QN * 128 +
                                c * 128 + (((p % 8) ^ (c % 8)) << 4)) = v;
    }
    // written by the threads, read by wgmma (the async proxy)
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  }
  // the query scales of this thread's columns (0 past b)
  float qsc[NC];
#pragma unroll
  for (int j = 0; j < QN / 8; ++j)
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int c = q0 + 8 * j + 2 * t4 + e;
      qsc[2 * j + e] = c < b ? __ldg(qscale + c) : 0.f;
    }
  __syncthreads();

  // The warpgroup's thread 0 issues its stages in order (the next one: box
  // i_kc of tile i_t of bucket i_g, ring slot i_slot on its use i_use),
  // the tile's scales (and perm entries) beside its first box; a refill
  // first waits until all 4 warps are done with the slot. Running
  // counters, not divisions by the run-time ring depth.
  int issued = 0, i_slot = 0, i_use = 0, i_g = g_begin + h, i_t = 0;
  int i_kc = 0;
  auto issue = [&]() {
    const int slot = h * stages + i_slot;
    if (i_use > 0) mbar_wait(&empty[slot], (i_use - 1) & 1);
    const int row = i_g * bucket + i_t * TILE;
    const bool first = i_kc == 0;
    mbar_expect(&full[slot], STAGE_BYTES + (first ? SIDE : 0));
    tma_load(ring + (size_t)slot * STAGE_BYTES, &cmap, i_kc * KBOX, row,
             &full[slot]);
    if (first) {
      tma_load_1d(sbuf + slot * TILE, &smap, row, &full[slot]);
      if (PERM) tma_load_1d(pbuf + slot * TILE, &pmap, row, &full[slot]);
    }
    ++issued;
    if (++i_kc == kc_n) {
      i_kc = 0;
      if (++i_t == tpb) {
        i_t = 0;
        i_g += HALVES;
      }
    }
    if (++i_slot == stages) {
      i_slot = 0;
      ++i_use;
    }
  };
  if (ct == 0)
    while (issued < stages && issued < total) issue();
  // the stage in slot s is done (its products retired, or, for int4 rows,
  // its bytes in registers): hand it back, and refill the ring
  auto release = [&](int s) {
    if (lane == 0) mbar_arrive(&empty[h * stages + s]);
    if (ct == 0 && issued < total) issue();
  };

  int acc[QN / 2] = {};
  uint32_t frag[8][4];                      // int4: a box's A fragments
  int top[NC][R];
  int c_slot = 0, c_phase = 0;              // the consumers' next stage
  int lists = 0;                            // buckets merged
  for (int g = g_begin + h; g < g_end; g += HALVES) {
    const long long row0 = (long long)g * bucket;
    const int blk = g / nb, jb = g % nb;
    const size_t wout = (size_t)R * nb;
    if (g >= g_live) {
      // every row dead: keys lowmask - pos, so positions 0 .. R - 1 win
      // with score bits 0 (-inf), as the plain version gives
      if (ct < QN && q0 + ct < b)
#pragma unroll
        for (int r = 0; r < R; ++r) {
          const size_t o = ((size_t)blk * wout + (size_t)r * nb + jb) * b +
                           q0 + ct;
          vals[o] = -INFINITY;
          idxs[o] = (int)(row0 + r);
        }
      continue;
    }
#pragma unroll
    for (int c = 0; c < NC; ++c)
#pragma unroll
      for (int r = 0; r < R; ++r) top[c][r] = INT_MIN;
    for (int t = 0; t < tpb; ++t) {
      const int pos = t * TILE + wl * 16 + g8;   // and pos + 8
      float scale0 = 0.f, scale1 = 0.f;
      bool live0 = false, live1 = false;
      int prev = 0;
      for (int kc = 0; kc < kc_n; ++kc) {
        const int slot = h * stages + c_slot;
        mbar_wait(&full[slot], c_phase);
        if (kc == 0) {
          const int r = slot * TILE + wl * 16 + g8;
          scale0 = sbuf[r];
          scale1 = sbuf[r + 8];
          if (PERM) {
            live0 = pbuf[r] < valid;
            live1 = pbuf[r + 8] < valid;
          } else {
            live0 = row0 + pos < valid;
            live1 = row0 + pos + 8 < valid;
          }
        }
        if constexpr (I4) {
          // this thread's packed bytes of rows pos and pos + 8: 16-byte
          // chunks 2 t4 and 2 t4 + 1, swizzled by the row (g8)
          const uint8_t* x =
              ring + (size_t)slot * STAGE_BYTES + (wl * 16 + g8) * 128;
          const int k0 = ((2 * t4) ^ g8) << 4, k1 = ((2 * t4 + 1) ^ g8) << 4;
          const uint4 x0 = *reinterpret_cast<const uint4*>(x + k0);
          const uint4 x1 = *reinterpret_cast<const uint4*>(x + k1);
          const uint4 y0 = *reinterpret_cast<const uint4*>(x + 1024 + k0);
          const uint4 y1 = *reinterpret_cast<const uint4*>(x + 1024 + k1);
          // every lane's loads are done: the stage goes back
          __syncwarp();
          release(c_slot);
          // the previous box's group, the fragments' last reader, has run
          // meanwhile; once it retires, this box's group follows
          asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
          box_products(acc, frag, x0, y0, x1, y1,
                       smem_u32(panel + (size_t)2 * kc * QN * 128), QN * 128,
                       kc);
        } else {
          const uint32_t a = smem_u32(ring + (size_t)slot * STAGE_BYTES);
          const uint32_t bq = smem_u32(panel + (size_t)kc * QN * 128);
          asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
#pragma unroll
          for (int kk = 0; kk < KBOX / 32; ++kk)
            // 32 codes = 32 bytes along the swizzled rows of A and B
            wgmma_s8(acc, gmma_desc(a + kk * 32, 16, 1024),
                     gmma_desc(bq + kk * 32, 16, 1024), kc | kk);
          asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
          // the previous stage's products are done
          asm volatile("wgmma.wait_group.sync.aligned 1;\n" ::: "memory");
          if (kc > 0) release(prev);
          prev = c_slot;
        }
        if (++c_slot == stages) {
          c_slot = 0;
          c_phase ^= 1;
        }
      }
      asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
      if constexpr (!I4) release(prev);
      // fold the tile: acc[4 j + e] is (row pos, column 8 j + 2 t4 + e),
      // acc[4 j + 2 + e] the same column at row pos + 8 (16 x raw for
      // int4 rows); the score is float(raw) * row_scale * query_scale,
      // each multiply rounded
#pragma unroll
      for (int j = 0; j < QN / 8; ++j)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const float qs = qsc[2 * j + e];
          const int raw0 = I4 ? acc[4 * j + e] >> 4 : acc[4 * j + e];
          const int raw1 = I4 ? acc[4 * j + 2 + e] >> 4 : acc[4 * j + 2 + e];
          const float s0 = __fmul_rn(__fmul_rn((float)raw0, scale0), qs);
          const float s1 = __fmul_rn(__fmul_rn((float)raw1, scale1), qs);
          insert<R>(top[2 * j + e], row_key(s0, live0, pos, lowmask));
          insert<R>(top[2 * j + e], row_key(s1, live1, pos + 8, lowmask));
        }
    }
    // merge the lists of the 8 lanes that share a column (same t4) ...
#pragma unroll
    for (int o = 4; o < 32; o <<= 1)
#pragma unroll
      for (int c = 0; c < NC; ++c) {
        int other[R];
#pragma unroll
        for (int r = 0; r < R; ++r)
          other[r] = __shfl_xor_sync(0xffffffffu, top[c][r], o);
#pragma unroll
        for (int r = 0; r < R; ++r) insert<R>(top[c], other[r]);
      }
    // ... then across the warpgroup's 4 warps
    int* lb = red + ((size_t)(h * 2 + (lists & 1)) * CWARPS) * QN * R;
    ++lists;
    if (g8 == 0)
#pragma unroll
      for (int j = 0; j < QN / 8; ++j)
#pragma unroll
        for (int e = 0; e < 2; ++e)
#pragma unroll
          for (int r = 0; r < R; ++r)
            lb[((size_t)wl * QN + 8 * j + 2 * t4 + e) * R + r] =
                top[2 * j + e][r];
    asm volatile("bar.sync %0, %1;\n" ::"r"(1 + h), "r"(CWARPS * 32)
                 : "memory");
    if (ct < QN && q0 + ct < b) {
      int best[R];
#pragma unroll
      for (int r = 0; r < R; ++r) best[r] = INT_MIN;
#pragma unroll
      for (int w = 0; w < CWARPS; ++w)
#pragma unroll
        for (int r = 0; r < R; ++r)
          insert<R>(best, lb[((size_t)w * QN + ct) * R + r]);
#pragma unroll
      for (int r = 0; r < R; ++r) {
        const int wk = best[r];
        const int vb = wk & ~lowmask;
        const size_t o =
            ((size_t)blk * wout + (size_t)r * nb + jb) * b + q0 + ct;
        vals[o] = vb == 0 ? -INFINITY : __int_as_float(vb) - 2.0f;
        idxs[o] = (int)(row0 + (lowmask - (wk & lowmask)));
      }
    }
  }
}

// The ring stages of each half (at most MAX_STAGES; below 2, D is too
// wide) for rows of d features (int8 codes, or packed int4), a panel of qn
// queries and r rounds, in smem_optin bytes of shared memory; *smem, when
// given, the bytes the launch asks for
int codes_stages(bool perm, bool i4, int d, int qn, int r, int smem_optin,
                 size_t* smem) {
  const int kc_n = ((i4 ? d / 2 : d) + KBOX - 1) / KBOX;
  const size_t fixed = 1024 + (size_t)(i4 ? 2 * kc_n : kc_n) * qn * 128 +
                       (size_t)HALVES * 2 * CWARPS * qn * r * sizeof(int);
  // a slot: the box, its tile's scales (and perm entries), two mbarriers
  const size_t per_stage =
      HALVES * (STAGE_BYTES + TILE * 4 * (perm ? 2 : 1) +
                2 * sizeof(uint64_t));
  const long long room = (long long)smem_optin - (long long)fixed;
  const int stages = (int)std::min<long long>(MAX_STAGES, room / per_stage);
  if (smem != nullptr) *smem = fixed + (size_t)stages * per_stage;
  return stages;
}

// the card's SM count and shared memory a block may opt in to (cached)
bool device_limits(int* sms, int* smem_optin) {
  int dev = 0;
  if (cudaGetDevice(&dev) != cudaSuccess || dev >= MAX_DEVICES) return false;
  static int sm_count[MAX_DEVICES], optin[MAX_DEVICES];
  if (sm_count[dev] == 0) {
    cudaDeviceGetAttribute(&optin[dev],
                           cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
    cudaDeviceGetAttribute(&sm_count[dev], cudaDevAttrMultiProcessorCount,
                           dev);
  }
  *sms = sm_count[dev];
  *smem_optin = optin[dev];
  return true;
}

template <int QN, int R, bool PERM, bool I4>
int launch_codes(const void* codes, const void* scales, const void* perm,
                 const void* q, const void* qscale, float* vals, int* idxs,
                 int n_pad, int d, int b, int valid, int bucket, int nb,
                 int lowmask, cudaStream_t stream) {
  int sms = 0, smem_optin = 0;
  if (!device_limits(&sms, &smem_optin)) return (int)cudaErrorInvalidDevice;
  CUtensorMap cmap, smap, pmap = {};
  if (!vqt::tensor_map(&cmap, codes, n_pad, I4 ? d / 2 : d, TILE,
                       CU_TENSOR_MAP_DATA_TYPE_UINT8) ||
      !vqt::tensor_map_1d(&smap, scales, n_pad, TILE) ||
      (PERM && !vqt::tensor_map_1d(&pmap, perm, n_pad, TILE,
                                   CU_TENSOR_MAP_DATA_TYPE_INT32)))
    return (int)cudaErrorInvalidValue;
  size_t smem = 0;
  const int stages = codes_stages(PERM, I4, d, QN, R, smem_optin, &smem);
  if (stages < 2) return (int)cudaErrorInvalidValue;   // D too wide
  cudaError_t e = cudaFuncSetAttribute(
      cand_kernel_i8<QN, R, PERM, I4>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  const int n_buckets = n_pad / bucket;
  const int chunks = (b + QN - 1) / QN;
  const int ctas = std::max(1, std::min(n_buckets, sms / chunks));
  cand_kernel_i8<QN, R, PERM, I4>
      <<<dim3(ctas, chunks), THREADS, smem, stream>>>(
          cmap, smap, pmap, (const int8_t*)q, (const float*)qscale, vals,
          idxs, d, b, valid, bucket, nb, lowmask, n_buckets, stages);
  return (int)cudaGetLastError();
}

template <int QN, bool PERM, bool I4>
int codes_by_rounds(const void* codes, const void* scales, const void* perm,
                    const void* q, const void* qscale, float* vals,
                    int* idxs, int n_pad, int d, int b, int valid,
                    int bucket, int rounds, int nb, int lowmask,
                    cudaStream_t s) {
  switch (rounds) {
    case 1: return launch_codes<QN, 1, PERM, I4>(
        codes, scales, perm, q, qscale, vals, idxs, n_pad, d, b, valid,
        bucket, nb, lowmask, s);
    case 2: return launch_codes<QN, 2, PERM, I4>(
        codes, scales, perm, q, qscale, vals, idxs, n_pad, d, b, valid,
        bucket, nb, lowmask, s);
    case 3: return launch_codes<QN, 3, PERM, I4>(
        codes, scales, perm, q, qscale, vals, idxs, n_pad, d, b, valid,
        bucket, nb, lowmask, s);
    default: return launch_codes<QN, 4, PERM, I4>(
        codes, scales, perm, q, qscale, vals, idxs, n_pad, d, b, valid,
        bucket, nb, lowmask, s);
  }
}

// int8 codes [n_pad, d], or (I4) packed int4 rows [n_pad, d / 2]
template <bool PERM, bool I4>
int scan_codes(const void* codes, const void* scales, const void* perm,
               const void* q, const void* qscale, void* vals, void* idxs,
               int n_pad, int d, int b, int valid, int bucket, int rounds,
               int block_rows, void* stream) {
  // TMA: a 16-byte aligned mirror with 16-byte rows (int4: rows of whole
  // 64-byte chunks), 16-byte aligned scales (and perm); 16-byte query
  // loads; buckets of whole 64-row tiles
  if (n_pad <= 0 || b <= 0 || d <= 0 || d % 16 || (I4 && (d / 2) % 64) ||
      bucket <= 0 || bucket % TILE ||
      block_rows % bucket || n_pad % block_rows || rounds < 1 ||
      rounds > MAXR ||
      (((uintptr_t)codes | (uintptr_t)scales | (uintptr_t)perm |
        (uintptr_t)q) & 15))
    return (int)cudaErrorInvalidValue;
  const int lowmask = vqt::bucket_lowmask(bucket);
  const int nb = block_rows / bucket;
  cudaStream_t s = (cudaStream_t)stream;
  if (b <= 16)  // single queries and small batches: a 16-wide panel
    return codes_by_rounds<16, PERM, I4>(
        codes, scales, perm, q, qscale, (float*)vals, (int*)idxs, n_pad, d,
        b, valid, bucket, rounds, nb, lowmask, s);
  return codes_by_rounds<64, PERM, I4>(
      codes, scales, perm, q, qscale, (float*)vals, (int*)idxs, n_pad, d, b,
      valid, bucket, rounds, nb, lowmask, s);
}

}  // namespace

extern "C" int vqt_cand_scan_int8_prefix(const void* codes,
                                         const void* scales,
                                         const void* q_codes,
                                         const void* qscale, void* vals,
                                         void* idxs, int n_pad, int d, int b,
                                         int valid, int bucket, int rounds,
                                         int block_rows, void* stream) {
  return scan_codes<false, false>(codes, scales, nullptr, q_codes, qscale,
                                  vals, idxs, n_pad, d, b, valid, bucket,
                                  rounds, block_rows, stream);
}

extern "C" int vqt_cand_scan_int4_prefix(const void* packed,
                                         const void* scales,
                                         const void* q_codes,
                                         const void* qscale, void* vals,
                                         void* idxs, int n_pad, int d, int b,
                                         int valid, int bucket, int rounds,
                                         int block_rows, void* stream) {
  return scan_codes<false, true>(packed, scales, nullptr, q_codes, qscale,
                                 vals, idxs, n_pad, d, b, valid, bucket,
                                 rounds, block_rows, stream);
}

extern "C" int vqt_cand_scan_int8(const void* codes, const void* scales,
                                  const void* perm, const void* q_codes,
                                  const void* qscale, void* vals, void* idxs,
                                  int n_pad, int d, int b, int valid,
                                  int bucket, int rounds, int block_rows,
                                  void* stream) {
  if (perm == nullptr) return (int)cudaErrorInvalidValue;
  return scan_codes<true, false>(codes, scales, perm, q_codes, qscale, vals,
                                 idxs, n_pad, d, b, valid, bucket, rounds,
                                 block_rows, stream);
}

// the ring stages of each half that the live-prefix scan of b queries and
// `rounds` takes over int8 codes (int4 0) or packed int4 rows (int4 1) of
// d features; -1 for operands it refuses
extern "C" int vqt_cand_scan_codes_stages(int d, int b, int rounds,
                                          int int4) {
  int sms = 0, smem_optin = 0;
  if (d <= 0 || b <= 0 || rounds < 1 || rounds > MAXR ||
      !device_limits(&sms, &smem_optin))
    return -1;
  return codes_stages(false, int4 != 0, d, b <= 16 ? 16 : 64, rounds,
                      smem_optin, nullptr);
}
