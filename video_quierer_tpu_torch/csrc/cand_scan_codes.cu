// Kernels B4, B7 and B11: candidate scans over the quantized mirrors (int8
// codes, and int4 codes packed two to a byte).
//
// Replace the TPU kernels video_quierer_tpu/ops/topk.py:
// _pallas_cand_scan_int8_prefix (B4, kernel body _cand_kernel_int8_prefix)
// and _pallas_cand_scan_int4_prefix (B7, _cand_kernel_int4_prefix) over the
// live-prefix mirrors of one card (row `pos` live when pos < valid), and
// _pallas_cand_scan_int8 (B11, _cand_kernel_int8) over the perm-layout int8
// mirror of a corpus shard (row `pos` live when perm[pos] < valid, the
// GLOBAL live count; PERM false and `perm` null for B4 and B7, so their
// instantiations carry no perm code), all in their native form (int8 query
// codes, s8 x s8 -> s32 products). A row's score is
//     float(raw) * row_scale * query_scale
// rounded after each multiply, in that order, as the TPU kernels compute
// it; raw, the integer dot product, is exact, so the winners, their values
// and their positions are bit-identical to the plain version's. The
// selection and the output layout are those of cand_select.cuh (B1's); the
// caller merges the winners in the reference's row-orient candidate order.
//
// int4 rows use the split-halves pack (byte j: feature j in the low nibble,
// feature j + D/2 in the high nibble). Hopper's tensor cores have no
// s4 x s8 product, so each 16-byte vector of packed codes is unpacked in
// registers into two int8 vectors with sign extension (per byte: nibble
// x -> (x ^ 8) - 8, the same values as the TPU kernel's (x << 28) >> 28 and
// x >> 4 on int32), and the score is two half-depth s8 dots, low nibbles
// with q[:, :D/2] and high nibbles with q[:, D/2:], into one accumulator.
//
// Design (B1's): one CTA per (bucket, chunk of queries), 8 warps scoring
// 16-row strips with mma.sync m16n8k32 s8 (int32 accumulate). A fragments
// come straight from the mirror in global memory as 16-byte vectors, B
// fragments from the query panel in shared memory. The depth index inside
// each 64-byte chunk is permuted the same way for both operands (thread
// t of a quad holds bytes 16t..16t+15 of the chunk, half for each of two
// mma), which keeps every load a 16-byte vector and leaves the integer sum
// unchanged. Each warp parks its 16 x QB raw sums in shared memory; its
// lanes apply the scales and fold the keys into their queries' lists.
//
// Bound on the H100: one read of the codes (2M x 512 B = 1.03 GB, ~0.31 ms
// at 3.35 TB/s; int4 half of that) plus the scales; the s8 products need
// 2 N D B operations (0.27 ms at 1,979 TOP/s at B = 256).
#include "cand_select.cuh"

namespace {

using vqt::emit;
using vqt::insert_key;
using vqt::MAXR;
using vqt::row_key;

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

// QB queries per CTA (NT = QB / 8 n-tiles of the mma); INT4 packed rows of
// d / 2 bytes, else int8 rows of d bytes
template <int QB, bool INT4, bool PERM>
__global__ void __launch_bounds__(WARPS * 32)
cand_kernel_codes(const int8_t* __restrict__ codes,
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
  const int row_bytes = INT4 ? d / 2 : d;
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
      if (INT4) {
        const int4 la = low_nibbles(pa), lb = low_nibbles(pb);
        const int4 ha = high_nibbles(pa), hb = high_nibbles(pb);
#pragma unroll
        for (int j = 0; j < NT; ++j) {
          const int8_t* qj = qa + (size_t)j * 8 * ldq + kc;
          mma_chunk(acc[j], la, lb, *reinterpret_cast<const int4*>(qj));
          mma_chunk(acc[j], ha, hb,
                    *reinterpret_cast<const int4*>(qj + d / 2));
        }
      } else {
#pragma unroll
        for (int j = 0; j < NT; ++j)
          mma_chunk(acc[j], pa, pb,
                    *reinterpret_cast<const int4*>(
                        qa + (size_t)j * 8 * ldq + kc));
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
          const bool live = PERM ? __ldg(perm + row) < valid
                                 : row < (size_t)valid;
          insert_key(top[t], row_key(sc, live, pos, lowmask), rounds);
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

template <int QB, bool INT4, bool PERM>
int launch_codes(const void* codes, const void* scales, const int* perm,
                 const void* q, const void* qscale, void* vals, void* idxs,
                 int n_pad, int d, int b, int valid, int bucket, int rounds,
                 int block_rows, cudaStream_t stream) {
  const size_t smem = (size_t)QB * (d + QPAD) +
                      (size_t)WARPS * 16 * (QB + 4) * sizeof(int) +
                      (size_t)WARPS * QB * MAXR * sizeof(int) +
                      (size_t)QB * sizeof(float);
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        cand_kernel_codes<QB, INT4, PERM>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  dim3 grid(n_pad / bucket, (b + QB - 1) / QB);
  cand_kernel_codes<QB, INT4, PERM><<<grid, WARPS * 32, smem, stream>>>(
      (const int8_t*)codes, (const float*)scales, perm, (const int8_t*)q,
      (const float*)qscale, (float*)vals, (int*)idxs, d, b, valid, bucket,
      rounds, block_rows / bucket, vqt::bucket_lowmask(bucket));
  return (int)cudaGetLastError();
}

template <bool INT4, bool PERM>
int scan_codes(const void* codes, const void* scales, const int* perm,
               const void* q, const void* qscale, void* vals, void* idxs,
               int n_pad, int d, int b, int valid, int bucket, int rounds,
               int block_rows, void* stream) {
  // 16-byte vectors of whole 64-byte chunks of each mirror row and query;
  // 16-row strips
  const int row_bytes = INT4 ? d / 2 : d;
  if (n_pad <= 0 || b <= 0 || row_bytes % 64 || d % 16 || bucket % 16 ||
      block_rows % bucket || n_pad % block_rows || rounds < 1 ||
      rounds > MAXR || bucket < rounds || ((uintptr_t)codes & 15) ||
      ((uintptr_t)q & 15))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  if (b <= 16)  // single queries and small batches: 16-query chunks
    return launch_codes<16, INT4, PERM>(codes, scales, perm, q, qscale, vals,
                                        idxs, n_pad, d, b, valid, bucket,
                                        rounds, block_rows, s);
  return launch_codes<64, INT4, PERM>(codes, scales, perm, q, qscale, vals,
                                      idxs, n_pad, d, b, valid, bucket,
                                      rounds, block_rows, s);
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
  return scan_codes<true, false>(packed, scales, nullptr, q_codes, qscale,
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
  return scan_codes<false, true>(codes, scales, (const int*)perm, q_codes,
                                 qscale, vals, idxs, n_pad, d, b, valid,
                                 bucket, rounds, block_rows, stream);
}
