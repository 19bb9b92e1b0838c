// Kernels B1 and B10: bf16 candidate scans.
//
// Replace the TPU kernels video_quierer_tpu/ops/topk.py:
// _pallas_cand_scan_prefix (B1, kernel body _cand_kernel_prefix with the
// "packb" selection of _bucket_select_cols: the live-prefix mirror of one
// card, row `pos` live when pos < valid) and _pallas_cand_scan (B10,
// _cand_kernel with _bucket_select_rows: the perm-layout mirror of a corpus
// shard, row `pos` live when perm[pos] < valid, valid being the GLOBAL live
// count). One kernel template serves both (PERM false and `perm` null for
// B1, so its instantiations carry no perm code). For every bucket and query
// it keeps the top `rounds` rows by the packed key of cand_select.cuh over
// the f32 sums of bf16 mirror . bf16 query; the output layout is
// cand_select.cuh's. The merge and the perm translation run outside the
// kernel, as in JAX (B1's winners in the col-orient order, B10's in the
// row-orient one: ops/topk.py).
//
// Bound on the H100: bytes. One read of the mirror per scan (2M x 512 x 2 B
// = 2.05 GB, 0.61 ms at 3.35 TB/s; B10 also reads 4 B of perm per row); the
// products are 2 x 64 flops per mirror byte at B = 64, a fifth of the
// tensor cores' rate at that byte rate.
//
// Design (Hopper): a persistent grid of one CTA an SM, each CTA two
// independent halves over a contiguous range of buckets (half h takes every
// second bucket of it), each half one warpgroup:
// - the half's buckets stream as [64 rows, 64 columns] bf16 boxes by TMA
//   (cp.async.bulk.tensor, 128-byte swizzle) into the half's ring of 8 KB
//   stages, guarded by full/empty mbarriers; thread 0 of the warpgroup
//   issues each refill as soon as all four warps have retired the stage's
//   products, so `stages` boxes stay in flight through the fold (no
//   producer warp: ptxas budgets registers by whole warpgroups, and a
//   third one would cap the consumers at 168 registers); buckets of the
//   live prefix wholly past `valid` are not read;
// - the query panel (QN = 64 queries, or 16 for B <= 16, zero queries
//   padding a short chunk) is loaded once per CTA into shared memory in the
//   swizzled K-major layout wgmma reads as B, and stays for the CTA's life;
// - the warpgroup issues wgmma.mma_async m64nQNk16 bf16 with f32
//   accumulators over each 64-row tile (4 products a stage), then folds the
//   tile's scores straight from the accumulator registers: a thread owns 2
//   rows x QN/4 query columns of the tile and keeps a running top-`rounds`
//   key list per column (`rounds` a template parameter, so the lists cost
//   `rounds` registers a column); at the bucket's end the lists merge
//   across the 8 lanes that share a column (xor shuffles 4, 8, 16), then
//   across the 4 warps through a few KB of shared memory (double-buffered
//   by bucket, one named barrier a bucket), and one thread a query writes
//   its winners. No score strip goes through shared memory. While one half
//   folds, the other half's products and both rings' copies run.
// B > 64 runs ceil(B / 64) query chunks as the grid's second dimension,
// SMs / chunks CTAs each, every chunk reading the mirror (at B = 256 on
// the H100 the four reads take about four times B = 64's time: the chunks'
// CTAs drift too far apart for L2 to serve the re-reads; a cluster that
// multicasts each box to the chunks' CTAs would read it once).
// Buckets are multiples of the 64-row tile; the mirror is bf16 only (f32
// mirrors take the exact scan, block_scan.cu; int8/int4 mirrors
// cand_scan_codes.cu).
#include "cand_select.cuh"
#include "tma.cuh"

#include <algorithm>

namespace {

using vqt::bf16;
using vqt::gmma_desc;
using vqt::insert;
using vqt::mbar_arrive;
using vqt::mbar_expect;
using vqt::mbar_init;
using vqt::mbar_wait;
using vqt::row_key;
using vqt::smem_u32;
using vqt::tma_load;

constexpr int TILE = 64;                    // mirror rows of one wgmma tile
constexpr int KBOX = 64;                    // columns of one TMA box
constexpr int STAGE_BYTES = TILE * KBOX * 2;   // one ring stage: 8 KB
constexpr int HALVES = 2;                   // warpgroups of a CTA
constexpr int CWARPS = 4;                   // warps of a warpgroup
constexpr int THREADS = HALVES * CWARPS * 32;
constexpr int MAX_STAGES = 12;              // ring stages of a half
constexpr int MAX_DEVICES = 64;             // per-device host caches

// d (+)= A B^T: m64 nN k16, bf16 A and B K-major in shared memory, f32
// sums; scale_d = 0 starts d from zero
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

// Shared memory: the query panel [kc_n][QN][128 B] (128-byte swizzled),
// the halves' rings [HALVES][stages][8 KB], the cross-warp lists
// [HALVES][2][CWARPS][QN][R], the full and empty mbarriers
// [HALVES][stages] each. Warps 0-3 and 4-7 are the halves' warpgroups.
template <int QN, int R, bool PERM>
__global__ void __launch_bounds__(THREADS, 1)
cand_kernel(const __grid_constant__ CUtensorMap emap,
            const int* __restrict__ perm, const bf16* __restrict__ q,
            float* __restrict__ vals, int* __restrict__ idxs, int d, int b,
            int valid, int bucket, int nb, int lowmask, int n_buckets,
            int stages) {
  constexpr int NC = QN / 4;                // query columns a thread owns
  extern __shared__ uint8_t smem_raw[];
  // swizzle atoms sit on 1,024-byte boundaries
  uint8_t* panel = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  const int kc_n = (d + KBOX - 1) / KBOX;
  uint8_t* ring = panel + (size_t)kc_n * QN * 128;
  int* red = reinterpret_cast<int*>(ring + (size_t)HALVES * stages *
                                               STAGE_BYTES);
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
  const int per_bucket = tpb * kc_n;        // ring stages of a bucket
  const int total =                         // ring stages of the half
      g_live > g_begin + h ? (g_live - g_begin - h + 1) / 2 * per_bucket : 0;

  if (tid == 0) {
    for (int s = 0; s < HALVES * stages; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], CWARPS);         // one arrival per warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  // the query panel: query c's 16-byte piece p (columns 8p ..) at chunk
  // p % 8 ^ (c % 8) of row c of column block p / 8; zeros past b and d
  {
    const int pieces = kc_n * 8, d8 = d / 8;
    for (int i = tid; i < QN * pieces; i += THREADS) {
      const int c = i / pieces, p = i % pieces;
      uint4 v = make_uint4(0u, 0u, 0u, 0u);
      if (q0 + c < b && p < d8)
        v = __ldg(reinterpret_cast<const uint4*>(q + (size_t)(q0 + c) * d +
                                                 8 * p));
      *reinterpret_cast<uint4*>(panel + (size_t)(p / 8) * QN * 128 +
                                c * 128 + (((p % 8) ^ (c % 8)) << 4)) = v;
    }
    // written by the threads, read by wgmma (the async proxy)
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  }
  __syncthreads();

  // stage m of the half (bucket m / per_bucket of its live ones, tile,
  // 64-column box) into ring slot m % stages, by the warpgroup's thread 0;
  // a refill first waits until all 4 warps are done with the slot
  auto issue = [&](int m) {
    const int slot = h * stages + m % stages, u = m / stages;
    if (u > 0) mbar_wait(&empty[slot], (u - 1) & 1);
    const int i = m / per_bucket, rem = m % per_bucket;
    const long long row = (long long)(g_begin + h + HALVES * i) * bucket +
                          rem / kc_n * TILE;
    mbar_expect(&full[slot], STAGE_BYTES);
    tma_load(ring + (size_t)slot * STAGE_BYTES, &emap, rem % kc_n * KBOX,
             (int)row, &full[slot]);
  };
  // stage n is done (its products retired): hand its slot back, refill it
  auto release = [&](int n) {
    if (lane == 0) mbar_arrive(&empty[h * stages + n % stages]);
    if (ct == 0 && n + stages < total) issue(n + stages);
  };
  if (ct == 0)
    for (int m = 0; m < stages && m < total; ++m) issue(m);

  // warp wl of the warpgroup holds rows 16 wl + g8 and 16 wl + g8 + 8 of
  // each tile, columns 8 j + 2 t4 (+ 1), j < QN / 8
  float acc[QN / 2] = {};
  int top[NC][R];
  int n = 0, lists = 0;                     // stages consumed, buckets merged
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
      bool live0, live1;
      if (PERM) {
        live0 = __ldg(perm + row0 + pos) < valid;
        live1 = __ldg(perm + row0 + pos + 8) < valid;
      } else {
        live0 = row0 + pos < valid;
        live1 = row0 + pos + 8 < valid;
      }
      for (int kc = 0; kc < kc_n; ++kc, ++n) {
        const int s = n % stages;
        mbar_wait(&full[h * stages + s], (n / stages) & 1);
        const uint32_t a =
            smem_u32(ring + (size_t)(h * stages + s) * STAGE_BYTES);
        const uint32_t bq = smem_u32(panel + (size_t)kc * QN * 128);
        asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
#pragma unroll
        for (int kk = 0; kk < KBOX / 16; ++kk)
          // 16 columns = 32 bytes along the swizzled rows of A and B
          mma(acc, gmma_desc(a + kk * 32, 16, 1024),
              gmma_desc(bq + kk * 32, 16, 1024), kc | kk);
        asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
        // the previous stage's products are done
        asm volatile("wgmma.wait_group.sync.aligned 1;\n" ::: "memory");
        if (kc > 0) release(n - 1);
      }
      asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
      release(n - 1);
      // fold the tile: acc[4 j + e] is (row pos, column 8 j + 2 t4 + e),
      // acc[4 j + 2 + e] the same column at row pos + 8
#pragma unroll
      for (int j = 0; j < QN / 8; ++j)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          insert<R>(top[2 * j + e],
                    row_key(acc[4 * j + e], live0, pos, lowmask));
          insert<R>(top[2 * j + e],
                    row_key(acc[4 * j + 2 + e], live1, pos + 8, lowmask));
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

// Shared memory a CTA takes besides its ring (the query panel of kc_n
// 64-column boxes and both halves' key lists), and the ring stages of a
// half that the opt-in leaves (at most MAX_STAGES; < 2: D too wide).
size_t fixed_smem(int d, int qn, int rounds) {
  const int kc_n = (d + KBOX - 1) / KBOX;
  return 1024 + (size_t)kc_n * qn * 128 +
         (size_t)HALVES * 2 * CWARPS * qn * rounds * sizeof(int);
}

constexpr size_t PER_STAGE = HALVES * (STAGE_BYTES + 2 * sizeof(uint64_t));

int ring_stages(int d, int qn, int rounds, int smem_optin) {
  const long long room =
      (long long)smem_optin - (long long)fixed_smem(d, qn, rounds);
  return (int)std::min<long long>(MAX_STAGES, room / (long long)PER_STAGE);
}

template <int QN, int R, bool PERM>
int launch(const void* emb, const int* perm, const void* q, float* vals,
           int* idxs, int n_pad, int d, int b, int valid, int bucket,
           int nb, int lowmask, cudaStream_t stream) {
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
  CUtensorMap map;
  if (!vqt::tensor_map(&map, emb, n_pad, d, TILE))
    return (int)cudaErrorInvalidValue;
  const int stages = ring_stages(d, QN, R, smem_optin[dev]);
  if (stages < 2) return (int)cudaErrorInvalidValue;   // D too wide
  const size_t smem = fixed_smem(d, QN, R) + (size_t)stages * PER_STAGE;
  cudaError_t e = cudaFuncSetAttribute(
      cand_kernel<QN, R, PERM>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (e != cudaSuccess) return (int)e;
  const int n_buckets = n_pad / bucket;
  const int chunks = (b + QN - 1) / QN;
  const int ctas =
      std::max(1, std::min(n_buckets, sm_count[dev] / chunks));
  cand_kernel<QN, R, PERM><<<dim3(ctas, chunks), THREADS, smem, stream>>>(
      map, perm, (const bf16*)q, vals, idxs, d, b, valid, bucket, nb,
      lowmask, n_buckets, stages);
  return (int)cudaGetLastError();
}

template <int QN, bool PERM>
int by_rounds(const void* emb, const int* perm, const void* q, float* vals,
              int* idxs, int n_pad, int d, int b, int valid, int bucket,
              int rounds, int nb, int lowmask, cudaStream_t s) {
  switch (rounds) {
    case 1: return launch<QN, 1, PERM>(emb, perm, q, vals, idxs, n_pad, d,
                                       b, valid, bucket, nb, lowmask, s);
    case 2: return launch<QN, 2, PERM>(emb, perm, q, vals, idxs, n_pad, d,
                                       b, valid, bucket, nb, lowmask, s);
    case 3: return launch<QN, 3, PERM>(emb, perm, q, vals, idxs, n_pad, d,
                                       b, valid, bucket, nb, lowmask, s);
    default: return launch<QN, 4, PERM>(emb, perm, q, vals, idxs, n_pad, d,
                                        b, valid, bucket, nb, lowmask, s);
  }
}

template <bool PERM>
int cand_scan(const void* emb, const int* perm, const void* queries,
              void* vals, void* idxs, int n_pad, int d, int b, int valid,
              int bucket, int rounds, int block_rows, void* stream) {
  // TMA: a 16-byte aligned mirror with 16-byte rows; 16-byte query
  // loads; buckets of whole 64-row tiles
  if (n_pad <= 0 || b <= 0 || d <= 0 || d % 16 || bucket % TILE ||
      block_rows % bucket || n_pad % block_rows || rounds < 1 ||
      rounds > vqt::MAXR || (((uintptr_t)emb | (uintptr_t)queries) & 15))
    return (int)cudaErrorInvalidValue;
  const int lowmask = vqt::bucket_lowmask(bucket);
  const int nb = block_rows / bucket;
  cudaStream_t s = (cudaStream_t)stream;
  if (b <= 16)  // single queries and small batches: a 16-wide panel
    return by_rounds<16, PERM>(emb, perm, queries, (float*)vals, (int*)idxs,
                               n_pad, d, b, valid, bucket, rounds, nb,
                               lowmask, s);
  return by_rounds<64, PERM>(emb, perm, queries, (float*)vals, (int*)idxs,
                             n_pad, d, b, valid, bucket, rounds, nb, lowmask,
                             s);
}

}  // namespace

extern "C" int vqt_cand_scan_prefix(const void* emb, const void* queries,
                                    void* vals, void* idxs, int n_pad, int d,
                                    int b, int valid, int bucket, int rounds,
                                    int block_rows, void* stream) {
  return cand_scan<false>(emb, nullptr, queries, vals, idxs, n_pad, d, b,
                          valid, bucket, rounds, block_rows, stream);
}

// The ring stages a warpgroup of B1/B10 takes for b queries of d features
// and `rounds` on the current device; -1 for operands it refuses
extern "C" int vqt_cand_scan_stages(int d, int b, int rounds) {
  int dev = 0, smem_optin = 0;
  if (d <= 0 || d % 16 || b <= 0 || rounds < 1 || rounds > vqt::MAXR ||
      cudaGetDevice(&dev) != cudaSuccess ||
      cudaDeviceGetAttribute(&smem_optin,
                             cudaDevAttrMaxSharedMemoryPerBlockOptin,
                             dev) != cudaSuccess)
    return -1;
  return ring_stages(d, b <= 16 ? 16 : 64, rounds, smem_optin);
}

extern "C" int vqt_cand_scan(const void* emb, const void* perm,
                             const void* queries, void* vals, void* idxs,
                             int n_pad, int d, int b, int valid, int bucket,
                             int rounds, int block_rows, void* stream) {
  if (perm == nullptr) return (int)cudaErrorInvalidValue;
  return cand_scan<true>(emb, (const int*)perm, queries, vals, idxs, n_pad,
                         d, b, valid, bucket, rounds, block_rows, stream);
}
