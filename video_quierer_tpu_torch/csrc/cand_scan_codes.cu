// Kernels B4, B7 and B11: candidate scans over the quantized mirrors (int8
// codes, and int4 codes packed two to a byte).
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
// B4 and B11, int8 codes (Hopper: B1's design, cand_scan.cu, on s8). A
// persistent grid of one CTA an SM, each CTA two independent halves over a
// contiguous range of buckets (half h takes every second bucket of it),
// each half one warpgroup:
// - the half's buckets stream as [64 rows, 128 codes] int8 boxes by TMA
//   (128-byte swizzle; one box is four k32 steps, a 64-row tile at D = 512
//   four boxes) into the half's ring of 8 KB stages behind full/empty
//   mbarriers; each tile's 64 row scales (and, for B11, its 64 perm
//   entries) ride with its first box as 1-D TMA copies. Thread 0 of the
//   warpgroup issues each refill once all four warps have retired the
//   stage's products (no producer warp: ptxas budgets registers by whole
//   warpgroups). Buckets of the live prefix wholly past `valid` are not
//   read;
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
// B7, int4 rows (the first tile, kept: wgmma has no s4 type). The
// split-halves pack (byte j: feature j in the low nibble, feature j + D/2
// in the high nibble) is unpacked in registers into two int8 vectors with
// sign extension (per byte: nibble x -> (x ^ 8) - 8, the same values as
// the TPU kernel's (x << 28) >> 28 and x >> 4 on int32), and the score is
// two half-depth s8 dots, low nibbles with q[:, :D/2] and high nibbles
// with q[:, D/2:], into one accumulator. One CTA per (bucket, chunk of
// queries), 8 warps scoring 16-row strips with mma.sync m16n8k32 s8; A
// fragments come straight from the mirror in global memory as 16-byte
// vectors, B fragments from the query panel in shared memory. The depth
// index inside each 64-byte chunk is permuted the same way for both
// operands (thread t of a quad holds bytes 16t..16t+15 of the chunk, half
// for each of two mma), which keeps every load a 16-byte vector and leaves
// the integer sum unchanged. Each warp parks its 16 x QB raw sums in
// shared memory; its lanes apply the scales and fold the keys into their
// queries' lists.
#include "cand_select.cuh"
#include "tma.cuh"

#include <algorithm>

namespace {

using vqt::emit;
using vqt::gmma_desc;
using vqt::insert;
using vqt::insert_key;
using vqt::mbar_arrive;
using vqt::mbar_expect;
using vqt::mbar_init;
using vqt::mbar_wait;
using vqt::MAXR;
using vqt::row_key;
using vqt::smem_u32;
using vqt::tma_load;
using vqt::tma_load_1d;

// -- B7: the int4 tile ------------------------------------------------------

constexpr int WARPS = 8;
constexpr int QPAD = 64;   // query panel row padding (bytes): spreads the
                           // 16-byte shared loads of 8 queries over banks

__device__ __forceinline__ void mma_s8(int (&c)[4], int a0, int a1, int a2,
                                       int a3, int b0, int b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
      "{%0, %1, %2, %3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
}

// a_lo: 16 bytes of row g, a_hi: the same bytes of row g + 8, bq: the same
// bytes of query n; two mma cover the 16 bytes
__device__ __forceinline__ void mma_chunk(int (&acc)[4], int4 a_lo,
                                          int4 a_hi, int4 bq) {
  mma_s8(acc, a_lo.x, a_hi.x, a_lo.y, a_hi.y, bq.x, bq.y);
  mma_s8(acc, a_lo.z, a_hi.z, a_lo.w, a_hi.w, bq.z, bq.w);
}

__device__ __forceinline__ int sext_nibbles(unsigned x) {
  // four nibbles in the low half of each byte -> four sign-extended int8
  return (int)__vsub4((x & 0x0F0F0F0Fu) ^ 0x08080808u, 0x08080808u);
}

__device__ __forceinline__ int4 low_nibbles(int4 p) {
  return make_int4(sext_nibbles(p.x), sext_nibbles(p.y), sext_nibbles(p.z),
                   sext_nibbles(p.w));
}

__device__ __forceinline__ int4 high_nibbles(int4 p) {
  return make_int4(sext_nibbles((unsigned)p.x >> 4),
                   sext_nibbles((unsigned)p.y >> 4),
                   sext_nibbles((unsigned)p.z >> 4),
                   sext_nibbles((unsigned)p.w >> 4));
}

// QB queries per CTA (NT = QB / 8 n-tiles of the mma); packed rows of d / 2
// bytes. `perm` is always null: the tile keeps the parameter list it had
// when it also served int8 codes, so that it compiles as it did (dropping
// an unused parameter from a kept tile has moved its time before: B8's FMA
// tile lost 8% at B = 1)
template <int QB>
__global__ void __launch_bounds__(WARPS * 32)
cand_kernel_int4(const int8_t* __restrict__ codes,
                 const float* __restrict__ scales,
                 const int* __restrict__ perm,
                 const int8_t* __restrict__ q,
                 const float* __restrict__ qscale, float* __restrict__ vals,
                 int* __restrict__ idxs, int d, int b, int valid,
                 int bucket, int rounds, int nb, int lowmask) {
  constexpr int NT = QB / 8;
  constexpr int QT = (QB + 31) / 32;       // queries per lane
  constexpr int LDS = QB + 4;              // raw-sum strip row stride
  extern __shared__ __align__(128) unsigned char smem_raw[];
  const int ldq = d + QPAD;
  int8_t* qs = reinterpret_cast<int8_t*>(smem_raw);          // [QB][ldq]
  int* sw = reinterpret_cast<int*>(smem_raw + (size_t)QB * ldq);
  int* red = sw + WARPS * 16 * LDS;                          // [W][QB][R]
  float* qsc = reinterpret_cast<float*>(red + WARPS * QB * MAXR);  // [QB]

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g = blockIdx.x;
  const int q0 = blockIdx.y * QB;
  const size_t row0 = (size_t)g * bucket;

  // query panel, zero-padded to QB queries; 16-byte vectors
  const int vecs = d / 16;
  for (int i = tid; i < QB * vecs; i += blockDim.x) {
    const int c = i / vecs, v = i % vecs;
    int4 x = make_int4(0, 0, 0, 0);
    if (q0 + c < b)
      x = reinterpret_cast<const int4*>(q + (size_t)(q0 + c) * d)[v];
    *reinterpret_cast<int4*>(qs + (size_t)c * ldq + 16 * v) = x;
  }
  for (int i = tid; i < QB; i += blockDim.x)
    qsc[i] = q0 + i < b ? qscale[q0 + i] : 0.f;
  __syncthreads();

  int top[QT][MAXR];
#pragma unroll
  for (int t = 0; t < QT; ++t)
#pragma unroll
    for (int r = 0; r < MAXR; ++r) top[t][r] = INT_MIN;

  const int gid = lane >> 2, tig = lane & 3;
  const int row_bytes = d / 2;
  int* strip = sw + warp * 16 * LDS;
  for (int t0 = warp * 16; t0 < bucket; t0 += WARPS * 16) {
    int acc[NT][4];
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[j][e] = 0;
    const int8_t* ra = codes + (row0 + t0 + gid) * row_bytes + 16 * tig;
    const int8_t* rb = ra + 8 * (size_t)row_bytes;
    const int8_t* qa = qs + (size_t)gid * ldq + 16 * tig;
    for (int kc = 0; kc < row_bytes; kc += 64) {
      const int4 pa = *reinterpret_cast<const int4*>(ra + kc);
      const int4 pb = *reinterpret_cast<const int4*>(rb + kc);
      const int4 la = low_nibbles(pa), lb = low_nibbles(pb);
      const int4 ha = high_nibbles(pa), hb = high_nibbles(pb);
#pragma unroll
      for (int j = 0; j < NT; ++j) {
        const int8_t* qj = qa + (size_t)j * 8 * ldq + kc;
        mma_chunk(acc[j], la, lb, *reinterpret_cast<const int4*>(qj));
        mma_chunk(acc[j], ha, hb,
                  *reinterpret_cast<const int4*>(qj + d / 2));
      }
    }
    // C fragment: rows gid / gid + 8, queries 8j + 2 tig + {0, 1}
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      const int c = 8 * j + 2 * tig;
      strip[gid * LDS + c] = acc[j][0];
      strip[gid * LDS + c + 1] = acc[j][1];
      strip[(gid + 8) * LDS + c] = acc[j][2];
      strip[(gid + 8) * LDS + c + 1] = acc[j][3];
    }
    __syncwarp();
#pragma unroll
    for (int t = 0; t < QT; ++t) {
      const int c = lane + 32 * t;
      if (c < QB) {
        const float qsv = qsc[c];
        for (int r = 0; r < 16; ++r) {
          const int pos = t0 + r;
          const size_t row = row0 + pos;
          const float sc = __fmul_rn(
              __fmul_rn((float)strip[r * LDS + c], __ldg(scales + row)),
              qsv);
          insert_key(top[t], row_key(sc, row < (size_t)valid, pos, lowmask),
                     rounds);
        }
      }
    }
    __syncwarp();
  }

#pragma unroll
  for (int t = 0; t < QT; ++t) {
    const int c = lane + 32 * t;
    if (c < QB)
#pragma unroll
      for (int r = 0; r < MAXR; ++r)
        red[((size_t)warp * QB + c) * MAXR + r] = top[t][r];
  }
  __syncthreads();
  if (tid < QB && q0 + tid < b)
    emit(red, WARPS, QB, tid, q0, b, row0, g, nb, rounds, lowmask, vals,
         idxs);
}

template <int QB>
int launch_int4(const void* packed, const void* scales, const void* q,
                const void* qscale, void* vals, void* idxs, int n_pad, int d,
                int b, int valid, int bucket, int rounds, int block_rows,
                cudaStream_t stream) {
  const size_t smem = (size_t)QB * (d + QPAD) +
                      (size_t)WARPS * 16 * (QB + 4) * sizeof(int) +
                      (size_t)WARPS * QB * MAXR * sizeof(int) +
                      (size_t)QB * sizeof(float);
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        cand_kernel_int4<QB>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  dim3 grid(n_pad / bucket, (b + QB - 1) / QB);
  cand_kernel_int4<QB><<<grid, WARPS * 32, smem, stream>>>(
      (const int8_t*)packed, (const float*)scales, nullptr,
      (const int8_t*)q, (const float*)qscale, (float*)vals, (int*)idxs, d,
      b, valid, bucket, rounds, block_rows / bucket,
      vqt::bucket_lowmask(bucket));
  return (int)cudaGetLastError();
}

// -- B4 and B11: the int8 tensor-core tile ----------------------------------

constexpr int TILE = 64;                    // mirror rows of one wgmma tile
constexpr int KBOX = 128;                   // codes (bytes) of one TMA box
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

// Shared memory: the query panel [kc_n][QN][128 B] (128-byte swizzled),
// the halves' rings [HALVES][stages][8 KB], beside each slot the row
// scales [HALVES][stages][TILE] f32 and (B11) the perm entries
// [HALVES][stages][TILE] i32 of the tile whose first box it holds, the
// cross-warp lists [HALVES][2][CWARPS][QN][R], the full and empty
// mbarriers [HALVES][stages] each. Warps 0-3 and 4-7 are the halves'
// warpgroups; warp wl of a warpgroup holds rows 16 wl + g8 and + 8 of each
// tile, query columns 8 j + 2 t4 (+ 1), j < QN / 8 (g8 = lane / 4, t4 =
// lane % 4).
template <int QN, int R, bool PERM>
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
  const int kc_n = (d + KBOX - 1) / KBOX;   // ring stages of a tile
  uint8_t* ring = panel + (size_t)kc_n * QN * 128;
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
  // the query panel: query c's 16-byte piece p (codes 16 p ..) at chunk
  // p % 8 ^ (c % 8) of row c of column block p / 8; zeros past b and d
  {
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
  // the stage in slot s is done (its products retired): hand it back, and
  // refill the ring
  auto release = [&](int s) {
    if (lane == 0) mbar_arrive(&empty[h * stages + s]);
    if (ct == 0 && issued < total) issue();
  };

  int acc[QN / 2] = {};
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
        if (++c_slot == stages) {
          c_slot = 0;
          c_phase ^= 1;
        }
      }
      asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
      release(prev);
      // fold the tile: acc[4 j + e] is (row pos, column 8 j + 2 t4 + e),
      // acc[4 j + 2 + e] the same column at row pos + 8; the score is
      // float(raw) * row_scale * query_scale, each multiply rounded
#pragma unroll
      for (int j = 0; j < QN / 8; ++j)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const float qs = qsc[2 * j + e];
          const float s0 =
              __fmul_rn(__fmul_rn((float)acc[4 * j + e], scale0), qs);
          const float s1 =
              __fmul_rn(__fmul_rn((float)acc[4 * j + 2 + e], scale1), qs);
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

template <int QN, int R, bool PERM>
int launch_i8(const void* codes, const void* scales, const void* perm,
              const void* q, const void* qscale, float* vals, int* idxs,
              int n_pad, int d, int b, int valid, int bucket, int nb,
              int lowmask, cudaStream_t stream) {
  int dev = 0;
  if (cudaGetDevice(&dev) != cudaSuccess || dev >= MAX_DEVICES)
    return (int)cudaErrorInvalidDevice;
  static int sm_count[MAX_DEVICES], smem_optin[MAX_DEVICES];
  if (sm_count[dev] == 0) {
    cudaDeviceGetAttribute(&smem_optin[dev],
                           cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
    cudaDeviceGetAttribute(&sm_count[dev], cudaDevAttrMultiProcessorCount,
                           dev);
  }
  CUtensorMap cmap, smap, pmap = {};
  if (!vqt::tensor_map(&cmap, codes, n_pad, d, TILE,
                       CU_TENSOR_MAP_DATA_TYPE_UINT8) ||
      !vqt::tensor_map_1d(&smap, scales, n_pad, TILE) ||
      (PERM && !vqt::tensor_map_1d(&pmap, perm, n_pad, TILE,
                                   CU_TENSOR_MAP_DATA_TYPE_INT32)))
    return (int)cudaErrorInvalidValue;
  const int kc_n = (d + KBOX - 1) / KBOX;
  const size_t fixed = 1024 + (size_t)kc_n * QN * 128 +
                       (size_t)HALVES * 2 * CWARPS * QN * R * sizeof(int);
  // a slot: the box, its tile's scales (and perm entries), two mbarriers
  const size_t per_stage =
      HALVES * (STAGE_BYTES + TILE * 4 * (PERM ? 2 : 1) +
                2 * sizeof(uint64_t));
  const long long room = (long long)smem_optin[dev] - (long long)fixed;
  const int stages = (int)std::min<long long>(MAX_STAGES, room / per_stage);
  if (stages < 2) return (int)cudaErrorInvalidValue;   // D too wide
  const size_t smem = fixed + (size_t)stages * per_stage;
  cudaError_t e = cudaFuncSetAttribute(
      cand_kernel_i8<QN, R, PERM>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  const int n_buckets = n_pad / bucket;
  const int chunks = (b + QN - 1) / QN;
  const int ctas =
      std::max(1, std::min(n_buckets, sm_count[dev] / chunks));
  cand_kernel_i8<QN, R, PERM><<<dim3(ctas, chunks), THREADS, smem, stream>>>(
      cmap, smap, pmap, (const int8_t*)q, (const float*)qscale, vals, idxs,
      d, b, valid, bucket, nb, lowmask, n_buckets, stages);
  return (int)cudaGetLastError();
}

template <int QN, bool PERM>
int i8_by_rounds(const void* codes, const void* scales, const void* perm,
                 const void* q, const void* qscale, float* vals, int* idxs,
                 int n_pad, int d, int b, int valid, int bucket, int rounds,
                 int nb, int lowmask, cudaStream_t s) {
  switch (rounds) {
    case 1: return launch_i8<QN, 1, PERM>(codes, scales, perm, q, qscale,
                                          vals, idxs, n_pad, d, b, valid,
                                          bucket, nb, lowmask, s);
    case 2: return launch_i8<QN, 2, PERM>(codes, scales, perm, q, qscale,
                                          vals, idxs, n_pad, d, b, valid,
                                          bucket, nb, lowmask, s);
    case 3: return launch_i8<QN, 3, PERM>(codes, scales, perm, q, qscale,
                                          vals, idxs, n_pad, d, b, valid,
                                          bucket, nb, lowmask, s);
    default: return launch_i8<QN, 4, PERM>(codes, scales, perm, q, qscale,
                                           vals, idxs, n_pad, d, b, valid,
                                           bucket, nb, lowmask, s);
  }
}

template <bool PERM>
int scan_int8(const void* codes, const void* scales, const void* perm,
              const void* q, const void* qscale, void* vals, void* idxs,
              int n_pad, int d, int b, int valid, int bucket, int rounds,
              int block_rows, void* stream) {
  // TMA: a 16-byte aligned mirror with 16-byte rows, 16-byte aligned
  // scales (and perm); 16-byte query loads; buckets of whole 64-row tiles
  if (n_pad <= 0 || b <= 0 || d <= 0 || d % 16 || bucket <= 0 ||
      bucket % TILE ||
      block_rows % bucket || n_pad % block_rows || rounds < 1 ||
      rounds > MAXR ||
      (((uintptr_t)codes | (uintptr_t)scales | (uintptr_t)perm |
        (uintptr_t)q) & 15))
    return (int)cudaErrorInvalidValue;
  const int lowmask = vqt::bucket_lowmask(bucket);
  const int nb = block_rows / bucket;
  cudaStream_t s = (cudaStream_t)stream;
  if (b <= 16)  // single queries and small batches: a 16-wide panel
    return i8_by_rounds<16, PERM>(codes, scales, perm, q, qscale,
                                  (float*)vals, (int*)idxs, n_pad, d, b,
                                  valid, bucket, rounds, nb, lowmask, s);
  return i8_by_rounds<64, PERM>(codes, scales, perm, q, qscale, (float*)vals,
                                (int*)idxs, n_pad, d, b, valid, bucket,
                                rounds, nb, lowmask, s);
}

}  // namespace

extern "C" int vqt_cand_scan_int8_prefix(const void* codes,
                                         const void* scales,
                                         const void* q_codes,
                                         const void* qscale, void* vals,
                                         void* idxs, int n_pad, int d, int b,
                                         int valid, int bucket, int rounds,
                                         int block_rows, void* stream) {
  return scan_int8<false>(codes, scales, nullptr, q_codes, qscale, vals,
                          idxs, n_pad, d, b, valid, bucket, rounds,
                          block_rows, stream);
}

extern "C" int vqt_cand_scan_int4_prefix(const void* packed,
                                         const void* scales,
                                         const void* q_codes,
                                         const void* qscale, void* vals,
                                         void* idxs, int n_pad, int d, int b,
                                         int valid, int bucket, int rounds,
                                         int block_rows, void* stream) {
  // 16-byte vectors of whole 64-byte chunks of each packed row and query;
  // 16-row strips
  if (n_pad <= 0 || b <= 0 || (d / 2) % 64 || d % 16 || bucket <= 0 ||
      bucket % 16 ||
      block_rows % bucket || n_pad % block_rows || rounds < 1 ||
      rounds > MAXR || bucket < rounds || ((uintptr_t)packed & 15) ||
      ((uintptr_t)q_codes & 15))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  if (b <= 16)  // single queries and small batches: 16-query chunks
    return launch_int4<16>(packed, scales, q_codes, qscale, vals, idxs,
                           n_pad, d, b, valid, bucket, rounds, block_rows,
                           s);
  return launch_int4<64>(packed, scales, q_codes, qscale, vals, idxs, n_pad,
                         d, b, valid, bucket, rounds, block_rows, s);
}

extern "C" int vqt_cand_scan_int8(const void* codes, const void* scales,
                                  const void* perm, const void* q_codes,
                                  const void* qscale, void* vals, void* idxs,
                                  int n_pad, int d, int b, int valid,
                                  int bucket, int rounds, int block_rows,
                                  void* stream) {
  if (perm == nullptr) return (int)cudaErrorInvalidValue;
  return scan_int8<true>(codes, scales, perm, q_codes, qscale, vals, idxs,
                         n_pad, d, b, valid, bucket, rounds, block_rows,
                         stream);
}
