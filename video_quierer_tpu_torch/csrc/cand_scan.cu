// Kernels B1 and B10: bf16 candidate scans.
//
// Replace the TPU kernels video_quierer_tpu/ops/topk.py:
// _pallas_cand_scan_prefix (B1, kernel body _cand_kernel_prefix with the
// "packb" selection of _bucket_select_cols: the live-prefix mirror of one
// card, row `pos` live when pos < valid) and _pallas_cand_scan (B10,
// _cand_kernel with _bucket_select_rows: the perm-layout mirror of a corpus
// shard, row `pos` live when perm[pos] < valid, valid being the GLOBAL live
// count). One kernel template serves both (PERM false and `perm` null for
// B1, so its instantiations carry no perm code). The selection and
// the output layout are those of cand_select.cuh; the merge and the perm
// translation run outside the kernel, as in JAX (B1's winners in the
// col-orient order, B10's in the row-orient one: ops/topk.py).
//
// Design: one CTA per (bucket, chunk of queries); the query chunk sits in
// shared memory for the whole bucket, and every row's keys fold into
// running top-`rounds` lists kept in registers; a final shared-memory pass
// merges the lists of each query. 8 warps score 16-row strips of the bf16
// mirror on the tensor cores (WMMA bf16 16x16x16, f32 accumulate), A
// fragments loaded straight from the mirror in global memory (each 32-byte
// row segment is one full sector), B fragments from the query panel in
// shared memory; each warp parks its 16 x QB scores in shared memory and
// its lanes fold them into their queries' lists. A batch narrower than the
// query chunk (B=1 and small B; the chunk is 16 queries) is padded to it
// with zero queries in the shared-memory panel, so the host allocates and
// copies nothing for it. The mirror is bf16 only: f32 mirrors take the
// exact scan (block_scan.cu), int8/int4 mirrors cand_scan_codes.cu.
//
// Bound on the H100: one read of the mirror per scan (2M x 512 x 2 B =
// 2.05 GB, ~0.6 ms at 3.35 TB/s; B10 also reads 4 B of perm per row) when
// the query chunk is wide; at small B the per-row key folding and the load
// latency set the time.
#include "cand_select.cuh"

#include <mma.h>

namespace {

using namespace nvcuda;
using vqt::bf16;
using vqt::emit;
using vqt::insert_key;
using vqt::MAXR;
using vqt::row_key;

constexpr int TC_WARPS = 8;

// bf16 mirror on the tensor cores; QB = 16 * NF queries per CTA
template <int NF, bool PERM>
__global__ void __launch_bounds__(TC_WARPS * 32)
cand_kernel_tc(const bf16* __restrict__ emb, const int* __restrict__ perm,
               const bf16* __restrict__ q, float* __restrict__ vals,
               int* __restrict__ idxs, int d, int b, int valid, int bucket,
               int rounds, int nb, int lowmask) {
  constexpr int QB = 16 * NF;
  constexpr int QT = (QB + 31) / 32;       // queries per lane
  constexpr int LDS = QB + 4;              // score strip row stride
  extern __shared__ __align__(128) unsigned char smem_raw[];
  const int ldq = d + 8;                   // padded query row stride
  bf16* qs = reinterpret_cast<bf16*>(smem_raw);                // [QB][ldq]
  float* sw = reinterpret_cast<float*>(
      smem_raw + (size_t)QB * ldq * sizeof(bf16));             // [W][16][LDS]
  int* red = reinterpret_cast<int*>(sw + TC_WARPS * 16 * LDS); // [W][QB][R]

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g = blockIdx.x;
  const int q0 = blockIdx.y * QB;
  const size_t row0 = (size_t)g * bucket;

  for (int i = tid; i < QB * d; i += blockDim.x) {
    const int c = i / d, kk = i % d;
    const int bq = q0 + c;
    qs[c * ldq + kk] =
        bq < b ? q[(size_t)bq * d + kk] : __float2bfloat16_rn(0.f);
  }
  __syncthreads();

  int top[QT][MAXR];
#pragma unroll
  for (int t = 0; t < QT; ++t)
#pragma unroll
    for (int r = 0; r < MAXR; ++r) top[t][r] = INT_MIN;

  float* strip = sw + warp * 16 * LDS;
  for (int t0 = warp * 16; t0 < bucket; t0 += TC_WARPS * 16) {
    wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[NF];
#pragma unroll
    for (int j = 0; j < NF; ++j) wmma::fill_fragment(acc[j], 0.f);
    const bf16* arow = emb + (row0 + t0) * d;
#pragma unroll 4
    for (int k = 0; k < d; k += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> a;
      wmma::load_matrix_sync(a, arow + k, d);
#pragma unroll
      for (int j = 0; j < NF; ++j) {
        wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::col_major> qf;
        wmma::load_matrix_sync(qf, qs + j * 16 * ldq + k, ldq);
        wmma::mma_sync(acc[j], a, qf, acc[j]);
      }
    }
#pragma unroll
    for (int j = 0; j < NF; ++j)
      wmma::store_matrix_sync(strip + j * 16, acc[j], LDS,
                              wmma::mem_row_major);
    __syncwarp();
#pragma unroll
    for (int t = 0; t < QT; ++t) {
      const int c = lane + 32 * t;
      if (c < QB) {
        for (int r = 0; r < 16; ++r) {
          const int pos = t0 + r;
          const bool live = PERM ? __ldg(perm + row0 + pos) < valid
                                 : row0 + pos < (size_t)valid;
          insert_key(top[t], row_key(strip[r * LDS + c], live, pos, lowmask),
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
    emit(red, TC_WARPS, QB, tid, q0, b, row0, g, nb, rounds, lowmask, vals,
         idxs);
}

template <int NF, bool PERM>
int launch_tc(const void* emb, const int* perm, const void* q, float* vals,
              int* idxs, int n_pad, int d, int b, int valid, int bucket,
              int rounds, int nb, int lowmask, cudaStream_t stream) {
  constexpr int QB = 16 * NF;
  const size_t smem = (size_t)QB * (d + 8) * sizeof(bf16) +
                      (size_t)TC_WARPS * 16 * (QB + 4) * sizeof(float) +
                      (size_t)TC_WARPS * QB * MAXR * sizeof(int);
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        cand_kernel_tc<NF, PERM>,
        cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  dim3 grid(n_pad / bucket, (b + QB - 1) / QB);
  cand_kernel_tc<NF, PERM><<<grid, TC_WARPS * 32, smem, stream>>>(
      (const bf16*)emb, perm, (const bf16*)q, vals, idxs, d, b, valid,
      bucket, rounds, nb, lowmask);
  return (int)cudaGetLastError();
}

template <bool PERM>
int cand_scan(const void* emb, const int* perm, const void* queries,
              void* vals, void* idxs, int n_pad, int d, int b, int valid,
              int bucket, int rounds, int block_rows, void* stream) {
  // WMMA fragments: 32-byte aligned mirror rows of a multiple of 16
  // elements, 16-row strips
  if (n_pad <= 0 || b <= 0 || d % 16 || bucket % 16 || block_rows % bucket ||
      n_pad % block_rows || rounds < 1 || rounds > MAXR || bucket < rounds ||
      ((uintptr_t)emb & 31))
    return (int)cudaErrorInvalidValue;
  const int lowmask = vqt::bucket_lowmask(bucket);
  const int nb = block_rows / bucket;
  cudaStream_t s = (cudaStream_t)stream;
  if (b <= 16)  // single queries and small batches: 16-query chunks
    return launch_tc<1, PERM>(emb, perm, queries, (float*)vals, (int*)idxs,
                              n_pad, d, b, valid, bucket, rounds, nb,
                              lowmask, s);
  return launch_tc<4, PERM>(emb, perm, queries, (float*)vals, (int*)idxs,
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

extern "C" int vqt_cand_scan(const void* emb, const void* perm,
                             const void* queries, void* vals, void* idxs,
                             int n_pad, int d, int b, int valid, int bucket,
                             int rounds, int block_rows, void* stream) {
  if (perm == nullptr) return (int)cudaErrorInvalidValue;
  return cand_scan<true>(emb, (const int*)perm, queries, vals, idxs, n_pad,
                         d, b, valid, bucket, rounds, block_rows, stream);
}
