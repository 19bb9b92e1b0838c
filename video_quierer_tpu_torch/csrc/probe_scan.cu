// Kernel B12: the IVF probe scan.
//
// Replaces the TPU kernel video_quierer_tpu/index/ivf.py: _pallas_probe_scan
// (kernel body _ivf_scan_kernel, selection ops/topk.py: _block_topk_body).
// The IVF tier packs its rows cluster by cluster into TILE_ROWS-row tiles
// [T, TILE_ROWS, D] f32 with global row ids [T, TILE_ROWS] (-1 for padding).
// A search hands over a flat list of (tile, query) pairs; for pair p this
// computes the f32 scores of tile tile_list[p]'s rows whose id is >= 0
// against query qidx[p], exactly on the CUDA cores (fmaf; no TF32, no bf16
// split: the reference scores at Precision.HIGHEST), and writes the pair's
// top k <= 64 by (score desc, global id asc) to vals[p, :], idxs[p, :]. A
// pair with fewer than k live rows pads with (-inf, -1), as
// _block_topk_body does among masked rows; a pair whose query is out of
// range or whose tile is negative gets pads only. Queries are row-major
// [B, D] f32 (the TPU kernel's transposed queries and one-hot column
// select were a lane-tiling workaround).
//
// Bound on the H100: bytes. A live row costs 2 D FLOP for 4 D bytes: 0.5
// FLOP a byte against the card's ~20 (67 TFLOP/s f32, 3.35 TB/s); at B =
// 64, ~1.2 GFLOP is ~0.02 ms of the f32 rate against ~0.47 ms of bytes, so
// no tensor cores (3xTF32 would only change the rounding). The least bytes
// are the distinct probed tiles' live rows once, plus their ids, the pair
// list, the queries and the output lists.
//
// The one-CTA-a-pair tile this replaces had three faults, each answered:
// (1) a single query probes ~18 live tiles, so 18 of 132 SMs did all the
// work, each at the rate its own loads in flight allowed: here a tile is
// cut into chunks (the wrapper picks 2-16 from P; 16 chunks of 64 rows at
// B = 1) and every SM pulls (group, chunk) work items; (2) a tile probed
// by several queries was read once a pair (23% of the bytes at B = 64):
// here a work item scores its chunk against up to GROUP pairs of that tile
// at once; (3) every pair on the all-padding tile (946 of 2,048 at B = 64)
// took a CTA: here the plan drops them. Three launches, each of the later
// two launched while the one before runs (programmatic dependent launch)
// and waiting for it in its prologue:
//
// 1. probe_plan_kernel, one CTA of 1,024 threads a WINDOW of pairs:
//    flags the pairs without a query or a tile, and those on a tile whose
//    ids are all -1 (a tile whose first row is live is live; any other is
//    read whole); sorts the rest stably by tile (an LSD radix sort, 8 bits
//    a pass, warp ranks by __match_any_sync; a warp's bitonic network for
//    up to 32 pairs); cuts each tile's run into groups of up to GROUP
//    pairs (tile, count, pairs, queries). Work item i is group i / chunks,
//    chunk i % chunks. Nothing returns to the host.
// 2. probe_scan_kernel, a persistent grid of one CTA an SM, warps by role:
//    a fetcher pulls items through an atomic counter, reads a chunk's ids
//    into a double-buffered header, marks the 16-row stages that hold a
//    live row and has the group's queries copied beside them (the round
//    trips of three items overlap); a producer streams the live stages by
//    TMA bulk copies (cp.async.bulk) into a ring of up to MAX_STAGES x 16
//    rows guarded by mbarriers, across item boundaries; four consumer
//    warps each score 4 rows of every stage against all of the item's
//    queries (a chunk leaves HBM once for all its pairs), each row summed
//    as the one-CTA tile did (lane-strided float4s, four fmaf in x, y, z, w
//    order, then the warp's xor-tree sum, taken for four rows at once:
//    reduce4), so scores and ties are bit-identical to it, and keep each
//    query's running top 32 in registers (fold_regs: a bitonic sort and
//    merge a 32-row batch; shared-memory lists past k = 32); a merger warp
//    merges the four warps' lists into each (pair, chunk) list and stores
//    it. Only the fetcher waits on global memory in the loop (the merger
//    only stores): a load or atomic queues behind the SM's copies in
//    flight.
// 3. probe_merge_kernel, a warp a pair: a live pair's chunk lists merged
//    into its k entries, pads for the rest.
//
// Tile offsets are 64-bit: at 2M rows the tiles take ~4.3 GB, and t *
// TILE_ROWS * D passes 2^31 at tile 4,096.
#include "common.cuh"
#include "tma.cuh"
#include "topk_list.cuh"

#include <algorithm>

namespace {

constexpr int TILE_ROWS = 1024;
constexpr int GROUP = 8;             // pairs an item (ivf.py PROBE_GROUP)
constexpr int WINDOW = 8192;         // pairs a plan CTA sorts (PROBE_WINDOW)
// a group: tile, pair count, its pairs, their queries
constexpr int GROUP_INTS = 2 + 2 * GROUP;
constexpr int PLAN_THREADS = 1024;
constexpr int PLAN_PER_THREAD = WINDOW / PLAN_THREADS;
// keys, the sort's second buffer, its digit counts, dead-run flags
constexpr int PLAN_SMEM = WINDOW * (8 + 8 + 4 + 1);
constexpr int CONSUMERS = 4;         // consumer warps of a scan CTA
constexpr int PRODUCER = CONSUMERS;  // then the producer warp,
constexpr int MERGER = CONSUMERS + 1;    // the merger warp
constexpr int FETCHER = CONSUMERS + 2;   // and the fetcher warp
constexpr int THREADS = 32 * (CONSUMERS + 3);
constexpr int EPILOGUES = 2;         // items' lists awaiting the merger
constexpr int STAGE_ROWS = 16;       // rows a ring stage
constexpr int WARP_ROWS = STAGE_ROWS / CONSUMERS;
constexpr int MAX_STAGES = 4;
constexpr int HEADERS = 2;
constexpr int MAX_CHUNKS = TILE_ROWS / 64;      // chunks of >= 64 rows
constexpr int SMEM_MAX = 232448;     // 227 KB of dynamic shared memory
constexpr unsigned FULL = 0xffffffffu;
constexpr unsigned long long DEAD = ~0ull;      // sort key of a dead pair

static_assert(PLAN_THREADS == TILE_ROWS, "the plan reads a tile's ids in "
                                         "one pass");
static_assert(STAGE_ROWS == 16, "the producer marks two stages a ballot");

__host__ __device__ inline size_t up16(size_t x) {
  return (x + 15) & ~(size_t)15;
}

// The wrapper's one scratch buffer, carved in this order.
struct Scratch {
  int* next;      // the scan's next work item
  int* ngroups;   // [windows] groups of each plan window
  int* groups;    // [P][GROUP_INTS]; window w's from w * WINDOW
  int* grouped;   // [P] 1 for a pair in a group (else the merge pads it)
  float* lv;      // [P][chunks][k] each (pair, chunk) list
  int* li;
  size_t bytes;
};

inline Scratch scratch_layout(uintptr_t base, int n_pairs, int k,
                              int chunks) {
  Scratch s;
  const size_t p = (size_t)n_pairs, lists = p * chunks * k * 4;
  size_t off = 0;
  s.next = reinterpret_cast<int*>(base + off);
  off += 16;
  s.ngroups = reinterpret_cast<int*>(base + off);
  off += up16((p + WINDOW - 1) / WINDOW * 4);
  s.groups = reinterpret_cast<int*>(base + off);
  off += up16(p * GROUP_INTS * 4);
  s.grouped = reinterpret_cast<int*>(base + off);
  off += up16(p * 4);
  s.lv = reinterpret_cast<float*>(base + off);
  off += up16(lists);
  s.li = reinterpret_cast<int*>(base + off);
  off += up16(lists);
  s.bytes = off;
  return s;
}

// Exclusive scan over the plan CTA's threads of one non-negative int each
// (MAX: running maximum, else sum; 0 is the identity of both); *total gets
// the whole CTA's result.
template <bool MAX>
__device__ int plan_scan(int v, int* tot, int* total) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  int x = v;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const int y = __shfl_up_sync(FULL, x, o);
    if (lane >= o) x = MAX ? max(x, y) : x + y;
  }
  int before = __shfl_up_sync(FULL, x, 1);
  if (lane == 0) before = 0;
  if (lane == 31) tot[warp] = x;
  __syncthreads();
  if (warp == 0) {
    int t = tot[lane];
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const int y = __shfl_up_sync(FULL, t, o);
      if (lane >= o) t = MAX ? max(t, y) : t + y;
    }
    tot[lane] = t;
    if (lane == 31) *total = t;
  }
  __syncthreads();
  if (warp > 0)
    before = MAX ? max(before, tot[warp - 1]) : before + tot[warp - 1];
  __syncthreads();
  return before;
}

// At most 32 keys (tile, position; DEAD for a pair without a query or a
// tile) sorted ascending into key[0, npow) by warp 0's bitonic network.
__device__ __forceinline__ void sort_window(const int* tile_list,
                                            const int* qidx, int n, int npow,
                                            int b, unsigned long long* key) {
  const int lane = threadIdx.x;
  if (lane >= 32) return;
  unsigned long long kk = DEAD;
  if (lane < n) {
    const int t = tile_list[lane], q = qidx[lane];
    if (t >= 0 && q >= 0 && q < b)
      kk = (unsigned long long)t << 32 | (unsigned)lane;
  }
  for (int size = 2; size <= npow; size <<= 1)
    for (int stride = size >> 1; stride; stride >>= 1) {
      const unsigned long long o = __shfl_xor_sync(FULL, kk, stride);
      // the lower position keeps the smaller key where the block ascends,
      // the larger where it descends
      const bool low = !(lane & stride), up = !(lane & size);
      if ((low == up) ? o < kk : o > kk) kk = o;
    }
  if (lane < npow) key[lane] = kk;
}

// The window's pairs sorted stably by tile, 8 bits a pass over the bits
// `n_tiles` needs (a pair without a query or a tile takes the largest
// key), as an LSD radix sort: thread (w, lane) holds buffer positions w *
// 32 * E + e * 32 + lane (e < E), so a warp's keys in (e, lane) order are
// in buffer order; each digit's count a warp (__match_any_sync, e by e)
// and one scan over (digit, warp) give every key its place, ties kept in
// buffer order. Leaves (tile << 32 | position) in key[0, E *
// PLAN_THREADS), DEAD past the live pairs; `other` is a second buffer of
// the same size, `hist` [256][32].
template <int E>
__device__ void radix_window(const int* tile_list, const int* qidx, int n,
                             int b, int n_tiles, unsigned long long* key,
                             unsigned* other, int* hist, int* tot,
                             int* total) {
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int bits = 32 - __clz(n_tiles);
  const unsigned last = bits >= 32 ? 0xffffffffu : (1u << bits) - 1;
  unsigned* buf[2] = {other, reinterpret_cast<unsigned*>(key)};
  unsigned kk[E];
  int vv[E];
#pragma unroll
  for (int e = 0; e < E; ++e) {
    const int i = warp * 32 * E + e * 32 + lane;
    kk[e] = last;
    vv[e] = i;
    if (i < n) {
      const int t = tile_list[i], q = qidx[i];
      if (t >= 0 && q >= 0 && q < b) kk[e] = (unsigned)t;
    }
  }
  for (int shift = 0, pass = 0; shift < bits; shift += 8, ++pass) {
    unsigned* nk = buf[pass & 1];
    int* nv = reinterpret_cast<int*>(nk + WINDOW);
    for (int j = tid; j < 256 * 32; j += PLAN_THREADS) hist[j] = 0;
    __syncthreads();
    unsigned dg[E];
    int rank[E];
#pragma unroll
    for (int e = 0; e < E; ++e) {
      dg[e] = (kk[e] >> shift) & 255u;
      const unsigned peers = __match_any_sync(FULL, dg[e]);
      const int leader = __ffs(peers) - 1;
      int before = 0;
      if (lane == leader) {
        before = hist[dg[e] * 32 + warp];
        hist[dg[e] * 32 + warp] = before + __popc(peers);
      }
      before = __shfl_sync(FULL, before, leader);
      rank[e] = before + __popc(peers & ((1u << lane) - 1));
      __syncwarp();
    }
    __syncthreads();
    int loc[8], sum = 0;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      loc[j] = hist[8 * tid + j];
      sum += loc[j];
    }
    int at = plan_scan<false>(sum, tot, total);
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      hist[8 * tid + j] = at;
      at += loc[j];
    }
    __syncthreads();
#pragma unroll
    for (int e = 0; e < E; ++e) {
      const int dst = hist[dg[e] * 32 + warp] + rank[e];
      nk[dst] = kk[e];
      nv[dst] = vv[e];
    }
    __syncthreads();
#pragma unroll
    for (int e = 0; e < E; ++e) {
      const int i = warp * 32 * E + e * 32 + lane;
      kk[e] = nk[i];
      vv[e] = nv[i];
    }
  }
  __syncthreads();
#pragma unroll
  for (int e = 0; e < E; ++e)
    key[warp * 32 * E + e * 32 + lane] =
        kk[e] == last ? DEAD : (unsigned long long)kk[e] << 32 | (unsigned)vv[e];
}

// The plan of one window of WINDOW pairs: pads of the dead pairs, the
// window's groups and their count, the pairs' chunk counters zeroed.
__global__ void __launch_bounds__(PLAN_THREADS)
probe_plan_kernel(const int* __restrict__ tile_list,
                  const int* __restrict__ qidx, const int* __restrict__ ids,
                  int n_pairs, int n_tiles, int b, int k, Scratch s,
                  float* __restrict__ vals, int* __restrict__ idxs) {
  // the scan may launch now; it waits for this grid before reading
  asm volatile("griddepcontrol.launch_dependents;" ::: "memory");
  extern __shared__ __align__(16) unsigned char smem_raw[];
  // keys; the sort's second buffer, later the suspects; the sort's digit
  // counts, later each position's query; dead-run flags
  unsigned long long* key =
      reinterpret_cast<unsigned long long*>(smem_raw);         // [WINDOW]
  unsigned* other = reinterpret_cast<unsigned*>(key + WINDOW); // [2 WINDOW]
  int* suspect = reinterpret_cast<int*>(other);
  int* hist = reinterpret_cast<int*>(other + 2 * WINDOW);      // [WINDOW]
  int* qv = hist;
  unsigned char* dead =
      reinterpret_cast<unsigned char*>(hist + WINDOW);         // [WINDOW]
  __shared__ int tot[32];
  __shared__ int n_suspect, total;

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int base = blockIdx.x * WINDOW;
  const int n = min(WINDOW, n_pairs - base);
  int npow = 1;
  while (npow < n) npow <<= 1;
  if (blockIdx.x == 0 && tid == 0) *s.next = 0;
  if (tid == 0) n_suspect = 0;
  // each pair's flag: 1 once a group takes it
  for (int i = tid; i < n; i += PLAN_THREADS) s.grouped[base + i] = 0;
  // key = (tile, position in the window): sorting it sorts stably by tile
  // (32 keys or fewer: a warp's bitonic network; else the radix sort)
  const int per = npow > PLAN_THREADS ? npow / PLAN_THREADS : 1;
  const int* tl = tile_list + base;
  const int* ql = qidx + base;
  if (npow <= 32) {
    sort_window(tl, ql, n, npow, b, key);
  } else {
    switch (per) {
      case 1: radix_window<1>(tl, ql, n, b, n_tiles, key, other, hist, tot,
                              &total); break;
      case 2: radix_window<2>(tl, ql, n, b, n_tiles, key, other, hist, tot,
                              &total); break;
      case 4: radix_window<4>(tl, ql, n, b, n_tiles, key, other, hist, tot,
                              &total); break;
      default: radix_window<8>(tl, ql, n, b, n_tiles, key, other, hist,
                               tot, &total);
    }
  }
  __syncthreads();
  // this thread's positions [i0, i0 + per)
  const int i0 = tid * per;
  int run[PLAN_PER_THREAD];     // each position's run start (-1: dead pair)
  int last = 0;
#pragma unroll
  for (int e = 0; e < PLAN_PER_THREAD; ++e) {
    const int i = i0 + e;
    run[e] = -1;
    if (e < per && i < npow && key[i] != DEAD) {
      const unsigned t = (unsigned)(key[i] >> 32);
      qv[i] = qidx[base + (int)(key[i] & 0xffffffffu)];
      if (i == 0 || (unsigned)(key[i - 1] >> 32) != t) {
        last = i;
        dead[i] = 0;
        // a tile whose first row is live is live; any other is checked
        // whole below
        if (ids[(size_t)t * TILE_ROWS] < 0)
          suspect[atomicAdd(&n_suspect, 1)] = i;
      }
      run[e] = last;
    }
  }
  const int before = plan_scan<true>(last, tot, &total);
  // tiles whose ids are all -1: a warp a suspect
  for (int j = warp; j < n_suspect; j += PLAN_THREADS / 32) {
    const int i = suspect[j];
    const int* tile_ids = ids + (size_t)(key[i] >> 32) * TILE_ROWS;
    int v[TILE_ROWS / 32];
#pragma unroll
    for (int u = 0; u < TILE_ROWS / 32; ++u) v[u] = tile_ids[u * 32 + lane];
    bool any = false;
#pragma unroll
    for (int u = 0; u < TILE_ROWS / 32; ++u) any |= v[u] >= 0;
    any = __any_sync(FULL, any);
    if (lane == 0) dead[i] = !any;
  }
  __syncthreads();
  // groups: runs on live tiles cut every GROUP pairs
  int starts = 0;
#pragma unroll
  for (int e = 0; e < PLAN_PER_THREAD; ++e) {
    if (run[e] < 0) continue;
    // a position before this thread's first run start belongs to the run
    // of an earlier thread
    const int rs = max(run[e], before);
    run[e] = rs;
    const int i = i0 + e;
    if (dead[rs]) {
      run[e] = -1;          // pads only: the merge kernel writes them
    } else if ((i - rs) % GROUP == 0) {
      ++starts;
    }
  }
  int g = plan_scan<false>(starts, tot, &total);
#pragma unroll
  for (int e = 0; e < PLAN_PER_THREAD; ++e) {
    const int i = i0 + e;
    if (run[e] < 0 || (i - run[e]) % GROUP) continue;
    int* out = s.groups + ((size_t)blockIdx.x * WINDOW + g++) * GROUP_INTS;
    const unsigned long long t = key[i] >> 32;
    int cnt = 0;
    for (int j = i; j < min(i + GROUP, npow) && key[j] != DEAD &&
                    (key[j] >> 32) == t;
         ++j) {
      const int p = base + (int)(key[j] & 0xffffffffu);
      s.grouped[p] = 1;
      out[2 + GROUP + cnt] = qv[j];
      out[2 + cnt++] = p;
    }
    out[0] = (int)t;
    out[1] = cnt;
  }
  if (tid == 0) s.ngroups[blockIdx.x] = total;
}

// An item's header, written by the fetcher warp, read by the producer and
// the consumers.
struct Header {
  unsigned long long live;   // bit j: stage j of the chunk has a live row
  int tile, n, chunk, end;
  int pair[GROUP];
};

// What the merger warp needs of an item once the consumers are done.
struct Done {
  int n, chunk, end;
  int pair[GROUP];
};

// The sum over the warp of each lane's partials of 4 rows: lane l gets
// row (l >> 3) & 3's. The same addition tree as vqt::warp_sum (xor 16, 8,
// 4, 2, 1; a + b == b + a bit for bit), so the same sums, in 6 shuffles
// instead of 20: steps 16 and 8 halve the rows a lane carries.
__device__ __forceinline__ float reduce4(float v0, float v1, float v2,
                                         float v3, int lane) {
  const bool h16 = lane & 16, h8 = lane & 8;
  const float a0 = h16 ? v2 : v0, a1 = h16 ? v3 : v1;   // kept
  const float b0 = h16 ? v0 : v2, b1 = h16 ? v1 : v3;   // sent
  const float r0 = a0 + __shfl_xor_sync(FULL, b0, 16);
  const float r1 = a1 + __shfl_xor_sync(FULL, b1, 16);
  float x = (h8 ? r1 : r0) + __shfl_xor_sync(FULL, h8 ? r0 : r1, 8);
  x += __shfl_xor_sync(FULL, x, 4);
  x += __shfl_xor_sync(FULL, x, 2);
  x += __shfl_xor_sync(FULL, x, 1);
  return x;
}

// Scores of a warp's 4 rows of a stage against NG queries, each row summed
// as the one-CTA-a-pair tile did: lane-strided float4s, fmaf in x, y, z,
// w order, then the warp's sum; sc[g]: row (lane >> 3) & 3's.
template <int NG>
__device__ __forceinline__ void score_stage(const float4* rows4,
                                            const float4* q4, int d4,
                                            int lane, float (&sc)[GROUP]) {
  float acc[WARP_ROWS][NG];
#pragma unroll
  for (int j = 0; j < WARP_ROWS; ++j)
#pragma unroll
    for (int g = 0; g < NG; ++g) acc[j][g] = 0.f;
#pragma unroll 2
  for (int c = lane; c < d4; c += 32) {
    float4 x[WARP_ROWS];
#pragma unroll
    for (int j = 0; j < WARP_ROWS; ++j) x[j] = rows4[j * d4 + c];
#pragma unroll
    for (int g = 0; g < NG; ++g) {
      const float4 w = q4[g * d4 + c];
#pragma unroll
      for (int j = 0; j < WARP_ROWS; ++j) {
        acc[j][g] = fmaf(x[j].x, w.x, acc[j][g]);
        acc[j][g] = fmaf(x[j].y, w.y, acc[j][g]);
        acc[j][g] = fmaf(x[j].z, w.z, acc[j][g]);
        acc[j][g] = fmaf(x[j].w, w.w, acc[j][g]);
      }
    }
  }
  static_assert(WARP_ROWS == 4, "reduce4 sums four rows");
#pragma unroll
  for (int g = 0; g < NG; ++g)
    sc[g] = reduce4(acc[0][g], acc[1][g], acc[2][g], acc[3][g], lane);
}

// One compare-exchange of a warp bitonic network: the lane whose bit
// `stride` is clear keeps the better entry when `desc`, else the worse.
__device__ __forceinline__ void exchange(float& v, int& r, int stride,
                                         bool desc, int lane) {
  const float ov = __shfl_xor_sync(FULL, v, stride);
  const int orr = __shfl_xor_sync(FULL, r, stride);
  const bool keep_better = ((lane & stride) == 0) == desc;
  if (keep_better == vqt::better(ov, orr, v, r)) {
    v = ov;
    r = orr;
  }
}

// A query's running top 32 in registers, lane j holding entry j in (score
// desc, id asc) order: fold in one candidate a lane (``here`` false for
// none). Sort the batch (a bitonic network), then merge: the better of
// entry j and the batch's entry 31 - j is the top 32 of the union as a
// bitonic sequence, which five more steps sort. Skipped when no candidate
// beats entry k - 1.
__device__ __forceinline__ void fold_regs(float& tv, int& tr, int k,
                                          bool here, float v, int r,
                                          int lane) {
  const float kv = __shfl_sync(FULL, tv, k - 1);
  const int kr = __shfl_sync(FULL, tr, k - 1);
  here = here && vqt::better(v, r, kv, kr);
  if (!__any_sync(FULL, here)) return;
  if (!here) {
    v = -INFINITY;
    r = INT_MAX;
  }
#pragma unroll
  for (int size = 2; size <= 32; size <<= 1)
#pragma unroll
    for (int stride = size >> 1; stride; stride >>= 1)
      exchange(v, r, stride, (lane & size) == 0 || size == 32, lane);
  const float bv = __shfl_sync(FULL, v, 31 - lane);
  const int br = __shfl_sync(FULL, r, 31 - lane);
  if (vqt::better(bv, br, tv, tr)) {
    tv = bv;
    tr = br;
  }
#pragma unroll
  for (int stride = 16; stride; stride >>= 1)
    exchange(tv, tr, stride, true, lane);
}

// atomicAdd(p, 1) with acquire-release order at GPU scope
__device__ __forceinline__ int add_acq_rel(int* p) {
  int old;
  asm volatile("atom.add.acq_rel.gpu.s32 %0, [%1], 1;"
               : "=r"(old)
               : "l"(p)
               : "memory");
  return old;
}

// Merge m sorted lists (list a at (lv, li) + a * stride, k entries each,
// pads (-inf, INT_MAX)) into their top k at (ov, oi): every live entry
// folded, 32 at a time, into a register list (fold_regs), or for k > 32
// into the shared list (ov, oi) itself (fold_warp)
__device__ __forceinline__ void merge_any(const float* lv, const int* li,
                                          int m, int stride, int k,
                                          float* ov, int* oi, int lane) {
  if (k > 32) {
    for (int j = lane; j < k; j += 32) {
      ov[j] = -INFINITY;
      oi[j] = INT_MAX;
    }
    __syncwarp();
    for (int t0 = 0; t0 < m * k; t0 += 32) {
      const int t = t0 + lane, a = t / k;
      const float v = t < m * k ? lv[a * stride + t - a * k] : -INFINITY;
      const int r = t < m * k ? li[a * stride + t - a * k] : INT_MAX;
      vqt::fold_warp(ov, oi, k, v > -INFINITY, v, r, lane);
    }
    return;
  }
  float tv = -INFINITY;
  int tr = INT_MAX;
  for (int t0 = 0; t0 < m * k; t0 += 32) {
    const int t = t0 + lane, a = t / k;
    float v = -INFINITY;
    int r = INT_MAX;
    if (t < m * k) {
      v = lv[a * stride + t - a * k];
      r = li[a * stride + t - a * k];
    }
    fold_regs(tv, tr, k, v > -INFINITY, v, r, lane);
  }
  if (lane < k) {
    ov[lane] = tv;
    oi[lane] = tr;
  }
  __syncwarp();
}

__global__ void __launch_bounds__(THREADS, 1)
probe_scan_kernel(const float* __restrict__ tiles,
                  const int* __restrict__ ids, const int* __restrict__ qidx,
                  const float* __restrict__ queries, float* __restrict__ vals,
                  int* __restrict__ idxs, Scratch s, int n_windows, int d,
                  int k, int chunks, int stages) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int d4 = d / 4;
  const int chunk_rows = TILE_ROWS / chunks;
  const uint32_t stage_bytes = STAGE_ROWS * d * 4;
  const int slot_entries = CONSUMERS * GROUP * k;   // lists of one item
  // shared memory, by offsets from smem_raw (all multiples of 16)
  size_t off = 0;
  float* ring = reinterpret_cast<float*>(smem_raw + off);
  off += (size_t)stages * stage_bytes;
  float* hq = reinterpret_cast<float*>(smem_raw + off);   // [HEADERS][G][d]
  off += (size_t)HEADERS * GROUP * d * 4;
  int* hid = reinterpret_cast<int*>(smem_raw + off);     // [HEADERS][rows]
  off += (size_t)HEADERS * chunk_rows * 4;
  Header* hdr = reinterpret_cast<Header*>(smem_raw + off);
  off += up16(HEADERS * sizeof(Header));
  Done* done = reinterpret_cast<Done*>(smem_raw + off);   // [EPILOGUES]
  off += up16(EPILOGUES * sizeof(Done));
  // [EPILOGUES][CONSUMERS][GROUP][k]: each consumer warp's list per query
  float* lv = reinterpret_cast<float*>(smem_raw + off);
  off += up16((size_t)EPILOGUES * slot_entries * 4);
  int* li = reinterpret_cast<int*>(smem_raw + off);
  off += up16((size_t)EPILOGUES * slot_entries * 4);
  // the merger's output list
  float* mo_v = reinterpret_cast<float*>(smem_raw + off);
  off += up16((size_t)k * 4);
  int* mo_i = reinterpret_cast<int*>(smem_raw + off);
  off += up16((size_t)k * 4);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem_raw + off);
  uint64_t* empty = full + stages;
  uint64_t* hfull = empty + stages;
  uint64_t* hempty = hfull + HEADERS;
  uint64_t* hinfo = hempty + HEADERS;
  uint64_t* efull = hinfo + HEADERS;
  uint64_t* eempty = efull + EPILOGUES;
  if (tid == 0) {
    for (int i = 0; i < stages; ++i) {
      vqt::mbar_init(&full[i], 1);
      vqt::mbar_init(&empty[i], CONSUMERS);
    }
    for (int i = 0; i < HEADERS; ++i) {
      vqt::mbar_init(&hfull[i], 32);
      vqt::mbar_init(&hinfo[i], 32);
      vqt::mbar_init(&hempty[i], CONSUMERS + 1);
    }
    for (int i = 0; i < EPILOGUES; ++i) {
      vqt::mbar_init(&efull[i], CONSUMERS);
      vqt::mbar_init(&eempty[i], 1);
    }
  }
  __syncthreads();
  // the plan's groups, counters and pads (launched as its dependent);
  // the merge kernel may launch now and waits for this grid
  asm volatile("griddepcontrol.wait;" ::: "memory");
  asm volatile("griddepcontrol.launch_dependents;" ::: "memory");

  if (warp == FETCHER) {
    // items and headers: each item's group, its chunk's ids and live
    // stages, its queries, one item ahead of the producer. The round trips
    // of three items overlap: this item's ids, the next one's group, and
    // the index of the one after it.
    int total = 0;
    for (int w = lane; w < n_windows; w += 32) total += s.ngroups[w];
#pragma unroll
    for (int o = 16; o; o >>= 1) total += __shfl_xor_sync(FULL, total, o);
    const int n_items = total * chunks;
    // the window of the latest group read: its first group, its count
    int wcur = 0, wbase = 0, wcount = s.ngroups[0];
    // lane j < GROUP_INTS: word j of an item's group (0 past the items)
    auto group_word = [&](int item) {
      if (item >= n_items) return 0;
      const int gi = item / chunks;
      while (gi >= wbase + wcount) {
        wbase += wcount;
        wcount = s.ngroups[++wcur];
      }
      return lane < GROUP_INTS
                 ? s.groups[((size_t)wcur * WINDOW + (gi - wbase)) *
                                GROUP_INTS + lane]
                 : 0;
    };
    // lane 0 holds the index of the item after the next, in flight
    int pending = lane == 0 ? atomicAdd(s.next, 1) : 0;
    int item = __shfl_sync(FULL, pending, 0);
    int word = group_word(item);
    pending = lane == 0 ? atomicAdd(s.next, 1) : 0;
    for (int h = 0, hp = 0;;) {
      Header& H = hdr[h];
      if (item >= n_items) {
        vqt::mbar_wait(&hempty[h], hp ^ 1);
        if (lane == 0) H.end = 1;
        vqt::mbar_arrive(&hinfo[h]);
        vqt::mbar_arrive(&hfull[h]);
        return;
      }
      const int tile = __shfl_sync(FULL, word, 0);
      const int n = __shfl_sync(FULL, word, 1);
      const int c = item % chunks;
      const int* src =
          ids + (size_t)tile * TILE_ROWS + (size_t)c * chunk_rows;
      int v[TILE_ROWS / 32];
#pragma unroll
      for (int u = 0; u < TILE_ROWS / 32; ++u)
        if (u * 32 < chunk_rows) v[u] = src[u * 32 + lane];
      // the next item's group and the index after it, in flight meanwhile
      const int item_next = __shfl_sync(FULL, pending, 0);
      const int word_next = group_word(item_next);
      pending = lane == 0 && item_next < n_items ? atomicAdd(s.next, 1)
                                                 : n_items;
      vqt::mbar_wait(&hempty[h], hp ^ 1);
      int* dst = hid + h * chunk_rows;
      unsigned long long live = 0;
#pragma unroll
      for (int u = 0; u < TILE_ROWS / 32; ++u)
        if (u * 32 < chunk_rows) {
          dst[u * 32 + lane] = v[u];
          const unsigned m = __ballot_sync(FULL, v[u] >= 0);
          if (m & 0xffffu) live |= 1ull << (2 * u);
          if (m >> 16) live |= 1ull << (2 * u + 1);
        }
      const int pw = __shfl_sync(FULL, word, 2 + (lane & (GROUP - 1)));
      const int q = __shfl_sync(FULL, word, 2 + GROUP + (lane & (GROUP - 1)));
      if (lane < n) H.pair[lane] = pw;
      if (lane == 0) {
        H.live = live;
        H.tile = tile;
        H.n = n;
        H.chunk = c;
        H.end = 0;
      }
      __syncwarp();
      vqt::mbar_arrive(&hinfo[h]);
      if (live) {
        if (lane == 0) vqt::mbar_expect(&hfull[h], (uint32_t)n * d * 4);
        __syncwarp();
        if (lane < n)
          vqt::bulk_load(hq + ((size_t)h * GROUP + lane) * d,
                         queries + (size_t)q * d, d * 4, &hfull[h]);
        if (lane != 0) vqt::mbar_arrive(&hfull[h]);
      } else {
        vqt::mbar_arrive(&hfull[h]);
      }
      item = item_next;
      word = word_next;
      if (++h == HEADERS) {
        h = 0;
        hp ^= 1;
      }
    }
  }

  if (warp == PRODUCER) {
    // the live stages of each header's chunk, in order, into the ring
    int slot = 0;
    uint32_t phase = 0;
    for (int h = 0, hp = 0;;) {
      vqt::mbar_wait(&hinfo[h], hp);
      const Header& H = hdr[h];
      if (H.end) return;
      if (lane == 0) {
        const float* rows =
            tiles +
            ((size_t)H.tile * TILE_ROWS + (size_t)H.chunk * chunk_rows) * d;
        for (unsigned long long m = H.live; m; m &= m - 1) {
          const int st = __ffsll((long long)m) - 1;
          vqt::mbar_wait(&empty[slot], phase ^ 1);
          vqt::mbar_expect(&full[slot], stage_bytes);
          vqt::bulk_load(ring + (size_t)slot * STAGE_ROWS * d,
                         rows + (size_t)st * STAGE_ROWS * d, stage_bytes,
                         &full[slot]);
          if (++slot == stages) {
            slot = 0;
            phase ^= 1;
          }
        }
        vqt::mbar_arrive(&hempty[h]);
      }
      __syncwarp();
      if (++h == HEADERS) {
        h = 0;
        hp ^= 1;
      }
    }
  }

  if (warp == MERGER) {
    // each finished item: its consumers' lists merged per query into the
    // (pair, chunk) list, stored for the merge kernel
    for (int e = 0, ep = 0;;) {
      vqt::mbar_wait(&efull[e], ep);
      const Done& F = done[e];
      if (F.end) return;
      const int c = F.chunk;
      for (int g = 0; g < F.n; ++g) {
        const size_t p = F.pair[g];
        merge_any(lv + (size_t)e * slot_entries + g * k,
                  li + (size_t)e * slot_entries + g * k, CONSUMERS,
                  GROUP * k, k, mo_v, mo_i, lane);
        for (int j = lane; j < k; j += 32) {
          s.lv[(p * chunks + c) * k + j] = mo_v[j];
          s.li[(p * chunks + c) * k + j] = mo_i[j];
        }
        __syncwarp();
      }
      __syncwarp();
      if (lane == 0) vqt::mbar_arrive(&eempty[e]);
      if (++e == EPILOGUES) {
        e = 0;
        ep ^= 1;
      }
    }
  }

  // the consumers
  int slot = 0;
  uint32_t phase = 0;
  const bool regs = k <= 32;     // lists in registers, else in shared memory
  for (int h = 0, hp = 0, e = 0, ep = 0;;) {
    vqt::mbar_wait(&hfull[h], hp);
    const Header& H = hdr[h];
    vqt::mbar_wait(&eempty[e], ep ^ 1);
    if (H.end) {
      if (warp == 0 && lane == 0) done[e].end = 1;
      __syncwarp();
      if (lane == 0) vqt::mbar_arrive(&efull[e]);
      return;
    }
    const int n = H.n;
    float* mv = lv + (size_t)e * slot_entries + warp * GROUP * k;
    int* mi = li + (size_t)e * slot_entries + warp * GROUP * k;
    if (!regs) {
      for (int i = lane; i < n * k; i += 32) {
        mv[i] = -INFINITY;
        mi[i] = INT_MAX;
      }
      __syncwarp();
    }
    const float4* q4 =
        reinterpret_cast<const float4*>(hq + (size_t)h * GROUP * d);
    const int* rid = hid + h * chunk_rows;
    // lane j: the j-th candidate of the batch (score per query, id), and
    // entry j of each query's running top 32
    float mine[GROUP], tv[GROUP];
    int tr[GROUP];
    int mid = -1;
#pragma unroll
    for (int g = 0; g < GROUP; ++g) {
      mine[g] = tv[g] = -INFINITY;
      tr[g] = INT_MAX;
    }
    int cnt = 0;
    for (unsigned long long m = H.live; m; m &= m - 1) {
      const int st = __ffsll((long long)m) - 1;
      vqt::mbar_wait(&full[slot], phase);
      const float4* rows4 = reinterpret_cast<const float4*>(
                                ring + (size_t)slot * STAGE_ROWS * d) +
                            warp * WARP_ROWS * d4;
      float sc[GROUP];   // lane: row (lane >> 3) & 3's score per query
      switch (n) {
        case 1: score_stage<1>(rows4, q4, d4, lane, sc); break;
        case 2: score_stage<2>(rows4, q4, d4, lane, sc); break;
        case 3: score_stage<3>(rows4, q4, d4, lane, sc); break;
        case 4: score_stage<4>(rows4, q4, d4, lane, sc); break;
        case 5: score_stage<5>(rows4, q4, d4, lane, sc); break;
        case 6: score_stage<6>(rows4, q4, d4, lane, sc); break;
        case 7: score_stage<7>(rows4, q4, d4, lane, sc); break;
        default: score_stage<8>(rows4, q4, d4, lane, sc); break;
      }
      __syncwarp();
      if (lane == 0) vqt::mbar_arrive(&empty[slot]);
      if (++slot == stages) {
        slot = 0;
        phase ^= 1;
      }
      // the stage's 4 rows become candidates cnt .. cnt + 3
      const bool mine_now = lane >= cnt && lane < cnt + WARP_ROWS;
      const int src = ((lane - cnt) & (WARP_ROWS - 1)) << 3;
#pragma unroll
      for (int g = 0; g < GROUP; ++g)
        if (g < n) {
          const float v = __shfl_sync(FULL, sc[g], src);
          if (mine_now) mine[g] = v;
        }
      if (mine_now)
        mid = rid[st * STAGE_ROWS + warp * WARP_ROWS + (lane - cnt)];
      cnt += WARP_ROWS;
      if (cnt == 32) {
#pragma unroll
        for (int g = 0; g < GROUP; ++g)
          if (g < n) {
            if (regs)
              fold_regs(tv[g], tr[g], k, mid >= 0, mine[g], mid, lane);
            else
              vqt::fold_warp(mv + g * k, mi + g * k, k, mid >= 0, mine[g],
                             mid, lane);
          }
        cnt = 0;
        mid = -1;
      }
    }
    if (cnt) {
#pragma unroll
      for (int g = 0; g < GROUP; ++g)
        if (g < n) {
          if (regs)
            fold_regs(tv[g], tr[g], k, mid >= 0 && lane < cnt, mine[g], mid,
                      lane);
          else
            vqt::fold_warp(mv + g * k, mi + g * k, k,
                           mid >= 0 && lane < cnt, mine[g], mid, lane);
        }
    }
    if (regs) {
#pragma unroll
      for (int g = 0; g < GROUP; ++g)
        if (g < n && lane < k) {
          mv[g * k + lane] = tv[g];
          mi[g * k + lane] = tr[g];
        }
    }
    // hand the lists to the merger, the header back to the producer
    if (warp == 0 && lane == 0) {
      Done& F = done[e];
      F.n = n;
      F.chunk = H.chunk;
      F.end = 0;
      for (int i = 0; i < n; ++i) F.pair[i] = H.pair[i];
    }
    __syncwarp();
    if (lane == 0) {
      vqt::mbar_arrive(&efull[e]);
      vqt::mbar_arrive(&hempty[h]);
    }
    if (++h == HEADERS) {
      h = 0;
      hp ^= 1;
    }
    if (++e == EPILOGUES) {
      e = 0;
      ep ^= 1;
    }
  }
}

// Each live pair's chunk lists merged into its k entries (a warp a pair);
// a pair in no group gets pads only.
constexpr int MERGE_THREADS = 64;

__global__ void __launch_bounds__(MERGE_THREADS)
probe_merge_kernel(Scratch s, float* __restrict__ vals,
                   int* __restrict__ idxs, int n_pairs, int k, int chunks) {
  __shared__ float sv[MERGE_THREADS / 32][vqt::LIST_KMAX];
  __shared__ int si[MERGE_THREADS / 32][vqt::LIST_KMAX];
  asm volatile("griddepcontrol.wait;" ::: "memory");
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const size_t p = (size_t)blockIdx.x * (MERGE_THREADS / 32) + warp;
  if (p >= (size_t)n_pairs) return;
  if (!s.grouped[p]) {
    for (int j = lane; j < k; j += 32) {
      vals[p * k + j] = -INFINITY;
      idxs[p * k + j] = -1;
    }
    return;
  }
  const float* pv = s.lv + p * chunks * k;
  const int* pi = s.li + p * chunks * k;
  constexpr int U = MAX_CHUNKS * vqt::LIST_KMAX / 32;
  float xv[U];               // every chunk list, all loads in flight
  int xi[U];
#pragma unroll
  for (int u = 0; u < U; ++u) {
    const int t = u * 32 + lane;
    xv[u] = -INFINITY;
    xi[u] = INT_MAX;
    if (t < chunks * k) {
      xv[u] = pv[t];
      xi[u] = pi[t];
    }
  }
  float* fv = sv[warp];
  int* fi = si[warp];
  if (k <= 32) {
    float tv = -INFINITY;
    int tr = INT_MAX;
#pragma unroll
    for (int u = 0; u < U; ++u)
      if (u * 32 < chunks * k)
        fold_regs(tv, tr, k, xv[u] > -INFINITY, xv[u], xi[u], lane);
    if (lane < k) {
      fv[lane] = tv;
      fi[lane] = tr;
    }
  } else {
    for (int j = lane; j < k; j += 32) {
      fv[j] = -INFINITY;
      fi[j] = INT_MAX;
    }
    __syncwarp();
#pragma unroll
    for (int u = 0; u < U; ++u)
      if (u * 32 < chunks * k)
        vqt::fold_warp(fv, fi, k, xv[u] > -INFINITY, xv[u], xi[u], lane);
  }
  __syncwarp();
  for (int j = lane; j < k; j += 32) {
    const bool live = fv[j] > -INFINITY;
    vals[p * k + j] = live ? fv[j] : -INFINITY;
    idxs[p * k + j] = live ? fi[j] : -1;
  }
}

// per device: the SM count, and whether the kernels' shared-memory limits
// are raised
int sm_count(int dev) {
  static int count[64];
  if (dev < 0 || dev >= 64) return 0;
  if (count[dev] == 0) {
    int n = 0;
    if (cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev) !=
        cudaSuccess)
      return 0;
    if (cudaFuncSetAttribute(probe_plan_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             PLAN_SMEM) != cudaSuccess ||
        cudaFuncSetAttribute(probe_scan_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             SMEM_MAX) != cudaSuccess)
      return 0;
    count[dev] = n;
  }
  return count[dev];
}

}  // namespace

extern "C" size_t vqt_probe_scan_scratch(int n_pairs, int k, int chunks) {
  return scratch_layout(0, n_pairs, k, chunks).bytes;
}

extern "C" int vqt_probe_scan(const void* tiles, const void* ids,
                              const void* tile_list, const void* qidx,
                              const void* queries, void* vals, void* idxs,
                              void* scratch, int n_pairs, int n_tiles, int d,
                              int b, int k, int chunks, void* stream) {
  // whole 16-byte vectors per row; 16-byte aligned tiles, queries and
  // scratch; chunks a power of two of at least 64 rows
  if (n_pairs < 0 || n_tiles < 1 || d <= 0 || d % 4 || b <= 0 || k < 1 ||
      k > vqt::LIST_KMAX || chunks < 1 || chunks > MAX_CHUNKS ||
      (chunks & (chunks - 1)) || ((uintptr_t)tiles & 15) ||
      ((uintptr_t)queries & 15) || ((uintptr_t)scratch & 15))
    return (int)cudaErrorInvalidValue;
  if (n_pairs == 0) return 0;
  const int chunk_rows = TILE_ROWS / chunks;
  const size_t stage_bytes = (size_t)STAGE_ROWS * d * 4;
  const size_t fixed =
      (size_t)HEADERS * GROUP * d * 4 + (size_t)HEADERS * chunk_rows * 4 +
      up16(HEADERS * sizeof(Header)) + up16(EPILOGUES * sizeof(Done)) +
      2 * up16((size_t)EPILOGUES * CONSUMERS * GROUP * k * 4) +
      2 * up16((size_t)k * 4) +
      (2 * MAX_STAGES + 3 * HEADERS + 2 * EPILOGUES) * 8;
  const long long room = (long long)SMEM_MAX - (long long)fixed;
  const int stages = room > 0 ? (int)std::min<long long>(
                                    MAX_STAGES, room / (long long)stage_bytes)
                              : 0;
  if (stages < 2) return (int)cudaErrorInvalidValue;    // D too wide
  const size_t smem = fixed + stages * stage_bytes;
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return (int)e;
  const int sms = sm_count(dev);
  if (sms == 0) return (int)cudaErrorInvalidValue;
  const Scratch s =
      scratch_layout((uintptr_t)scratch, n_pairs, k, chunks);
  const int windows = (n_pairs + WINDOW - 1) / WINDOW;
  cudaStream_t st = (cudaStream_t)stream;
  probe_plan_kernel<<<windows, PLAN_THREADS, PLAN_SMEM, st>>>(
      (const int*)tile_list, (const int*)qidx, (const int*)ids, n_pairs,
      n_tiles, b, k,
      s, (float*)vals, (int*)idxs);
  e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  // the scan launches while the plan runs (programmatic dependent launch)
  // and waits for it in its prologue
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)std::min<long long>(
      sms, (long long)n_pairs * chunks));
  cfg.blockDim = dim3(THREADS);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = st;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr[0].val.programmaticStreamSerializationAllowed = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  e = cudaLaunchKernelEx(&cfg, probe_scan_kernel,
      (const float*)tiles, (const int*)ids, (const int*)qidx,
      (const float*)queries, (float*)vals, (int*)idxs, s, windows, d, k,
      chunks, stages);
  if (e != cudaSuccess) return (int)e;
  cfg.gridDim = dim3((unsigned)((n_pairs + MERGE_THREADS / 32 - 1) /
                                (MERGE_THREADS / 32)));
  cfg.blockDim = dim3(MERGE_THREADS);
  cfg.dynamicSmemBytes = 0;
  e = cudaLaunchKernelEx(&cfg, probe_merge_kernel, s, (float*)vals,
                         (int*)idxs, n_pairs, k, chunks);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}
