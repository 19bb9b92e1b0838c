// Kernels B2, B5 and B6: pre-LN CLIP encoder blocks.
//
// Replace the TPU kernels of video_quierer_tpu/ops/fused_layer.py:
// - B5 _attn_half_call (kernel _attn_half_kernel = _attn_math): LN1 (f32
//   stats) -> QKV + bias -> per-item attention (causal for text,
//   non-causal for the ViT-B/32 vision tower at S=50) -> out-proj + bias ->
//   residual;
// - B6 _mlp_half_call (kernel _mlp_half_kernel = _mlp_math): LN2 -> fc1 +
//   bias -> quick-GELU -> fc2 + bias -> residual;
// - B2 _fused_layer_call (kernel _layer_kernel = both): the causal text
//   block, here B5 followed by B6 in one C call (vqt_text_layer);
// all on the flat [B*S, D] token matrix.
//
// The TPU kernels keep a layer's (or a half's) weights resident in VMEM for
// one pallas_call. One SM's 227 KB of shared memory cannot hold them, so
// here a block is five launches on the host side of the C calls:
//   B5 1. GEMM with LayerNorm-1 fused as its prologue, bias epilogue -> qkv
//      2. per-item attention on the q/k/v column blocks of qkv
//         (attention.cu; the TPU kernel's cross-item mask over a shared
//         tile is TPU redundancy, not semantics)                     -> attn
//      3. GEMM, bias + residual epilogue                             -> x3
//   B6 4. GEMM with LayerNorm-2 prologue, bias + quick-GELU epilogue -> h
//      5. GEMM, bias + residual epilogue                             -> out
// The weights keep _layer_operands' layout: [in, out] row-major with q/k/v
// concatenated along out (wqkv [D, 3D]). Item boundaries (S = 50 for the
// vision tower) fall anywhere inside a 64-row GEMM tile: the GEMMs are
// per token, only the attention step sees items.
//
// The GEMM keeps the reference's bf16 rounding points in its prologue
// (LN output rounded to T) and epilogue (T(acc), + bias in T, quick-GELU
// in T, + residual in T) around an f32 accumulate:
// - bf16 (the serving tower): WMMA bf16 16x16x16 tiles on the tensor
//   cores, 64x64 output tile per CTA, 4 warps of 32x32, operands staged in
//   shared memory as 16-byte vectors with the next step's loads in flight
//   (the LN prologue is applied while staging A);
// - f32: a shared-memory tiled FMA loop on the CUDA cores (64x64 tile,
//   4x4 outputs per thread).
// Bound on the H100: at text serving batches (1,024 tokens x 512 wide) the
// GEMMs are small (0.5-2 GFLOP each), so the 60 launches per 12-layer
// encode and the per-CTA staging, not the tensor-core peak, set the time.
// At the vision tower's ingest batch (12,800 tokens x 768 wide, 62 + 121
// GFLOP a layer) the tensor-core peak bounds both halves; the 64x64 WMMA
// tile with its per-step shared-memory staging sits far below it (wgmma
// and TMA staging are the next step).
#include "common.cuh"

#include <mma.h>

namespace {

using namespace nvcuda;
using vqt::bf16;
using vqt::from_f;
using vqt::rnd;
using vqt::to_f;

constexpr int BM = 64, BN = 64;

// Per-row LayerNorm statistics of A rows [m0, m0 + BM) (f32, two-pass),
// into mu/rs; rows past M get zeros. All threads of the CTA take part.
template <typename T>
__device__ void ln_stats(const T* __restrict__ A, int M, int K, int m0,
                         float eps, float* mu, float* rs) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  for (int r = warp; r < BM; r += blockDim.x / 32) {
    const int m = m0 + r;
    float mean = 0.f, rstd = 0.f;
    if (m < M) {
      const T* row = A + (size_t)m * K;
      float s = 0.f;
      for (int c = lane; c < K; c += 32) s += to_f(row[c]);
      mean = vqt::warp_sum(s) / K;
      float v = 0.f;
      for (int c = lane; c < K; c += 32) {
        const float x = to_f(row[c]) - mean;
        v += x * x;
      }
      rstd = 1.f / sqrtf(vqt::warp_sum(v) / K + eps);
    }
    if (lane == 0) {
      mu[r] = mean;
      rs[r] = rstd;
    }
  }
  __syncthreads();
}

// Prologue: A[m, kk] (LayerNorm-ed and rounded to T when gamma is given)
template <typename T>
__device__ __forceinline__ float a_elem(const T* __restrict__ A, int M, int K,
                                        int m0, int r, int kk,
                                        const float* gamma, const float* beta,
                                        const float* mu, const float* rs) {
  const int m = m0 + r;
  if (m >= M) return 0.f;
  const float a = to_f(A[(size_t)m * K + kk]);
  return gamma != nullptr ? rnd<T>((a - mu[r]) * rs[r] * gamma[kk] + beta[kk])
                          : a;
}

// Epilogue of output (m, n) from its f32 accumulator. quick-GELU is
// x / (1 + exp(c x)) with c the reference's weakly typed -1.702 rounded to T.
template <typename T>
__device__ __forceinline__ void store_out(float acc, int m, int n, int N,
                                          const T* __restrict__ bias,
                                          const T* __restrict__ res,
                                          int gelu, T* __restrict__ C) {
  float t = rnd<T>(acc);
  t = rnd<T>(t + to_f(bias[n]));
  if (gelu) {
    const float e = rnd<T>(expf(rnd<T>(rnd<T>(-1.702f) * t)));
    t = rnd<T>(t * rnd<T>(1.f / rnd<T>(1.f + e)));
  }
  if (res != nullptr) t = rnd<T>(to_f(res[(size_t)m * N + n]) + t);
  C[(size_t)m * N + n] = from_f<T>(t);
}

// f32: C[M, N] = epilogue(prologue(A)[M, K] @ W[K, N]) on the CUDA cores
constexpr int F_BK = 16, F_TM = 4, F_TN = 4, F_THREADS = 256;

__global__ void __launch_bounds__(F_THREADS)
gemm_f32(const float* __restrict__ A, const float* __restrict__ W,
         const float* __restrict__ bias, const float* __restrict__ gamma,
         const float* __restrict__ beta, const float* __restrict__ res,
         float* __restrict__ C, int M, int N, int K, float eps, int gelu) {
  __shared__ float As[F_BK][BM + 4];
  __shared__ float Ws[F_BK][BN];
  __shared__ float mu[BM], rs[BM];
  const int tid = threadIdx.x;
  const int tx = tid % 16, ty = tid / 16;
  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * BN;
  if (gamma != nullptr) ln_stats(A, M, K, m0, eps, mu, rs);

  float acc[F_TM][F_TN];
#pragma unroll
  for (int i = 0; i < F_TM; ++i)
#pragma unroll
    for (int j = 0; j < F_TN; ++j) acc[i][j] = 0.f;

  for (int k0 = 0; k0 < K; k0 += F_BK) {
    for (int i = tid; i < BM * F_BK; i += F_THREADS) {
      const int r = i / F_BK, c = i % F_BK;
      As[c][r] = a_elem(A, M, K, m0, r, k0 + c, gamma, beta, mu, rs);
    }
    for (int i = tid; i < F_BK * BN; i += F_THREADS) {
      const int r = i / BN, c = i % BN;
      Ws[r][c] = W[(size_t)(k0 + r) * N + n0 + c];
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < F_BK; ++kk) {
      float a[F_TM], w[F_TN];
#pragma unroll
      for (int i = 0; i < F_TM; ++i) a[i] = As[kk][ty + 16 * i];
#pragma unroll
      for (int j = 0; j < F_TN; ++j) w[j] = Ws[kk][tx + 16 * j];
#pragma unroll
      for (int i = 0; i < F_TM; ++i)
#pragma unroll
        for (int j = 0; j < F_TN; ++j) acc[i][j] = fmaf(a[i], w[j], acc[i][j]);
    }
    __syncthreads();
  }
#pragma unroll
  for (int i = 0; i < F_TM; ++i) {
    const int m = m0 + ty + 16 * i;
    if (m >= M) continue;
#pragma unroll
    for (int j = 0; j < F_TN; ++j)
      store_out(acc[i][j], m, n0 + tx + 16 * j, N, bias, res, gelu, C);
  }
}

// bf16: the same on the tensor cores. 4 warps, warp (wm, wn) owns the
// 32x32 quarter (wm, wn) of the 64x64 tile as 2x2 WMMA accumulators.
// Operands move as 16-byte vectors (8 elements; each thread moves 2 of A
// and 2 of W per 32-deep step), and the next step's vectors are loaded
// into registers while the tensor cores work on the current step.
constexpr int T_BK = 32, T_THREADS = 128;
constexpr int LDA = T_BK + 8, LDW = BN + 8, LDC = BN + 4;  // padded strides

__global__ void __launch_bounds__(T_THREADS)
gemm_bf16(const bf16* __restrict__ A, const bf16* __restrict__ W,
          const bf16* __restrict__ bias, const float* __restrict__ gamma,
          const float* __restrict__ beta, const bf16* __restrict__ res,
          bf16* __restrict__ C, int M, int N, int K, float eps, int gelu) {
  __shared__ __align__(32) bf16 As[BM * LDA];
  __shared__ __align__(32) bf16 Ws[T_BK * LDW];
  __shared__ __align__(32) float Cs[BM * LDC];
  __shared__ float mu[BM], rs[BM];
  const int tid = threadIdx.x, warp = tid / 32;
  const int wm = warp / 2, wn = warp % 2;
  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * BN;
  if (gamma != nullptr) ln_stats(A, M, K, m0, eps, mu, rs);

  // vector v of a step: A row v / 4, columns (v % 4) * 8 ..;
  // W row v / 8, columns (v % 8) * 8 ..
  uint4 ra[2], rw[2];
  auto load = [&](int k0) {
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int v = tid + i * T_THREADS;
      const int m = m0 + v / 4;
      ra[i] = m < M ? *reinterpret_cast<const uint4*>(
                          A + (size_t)m * K + k0 + (v % 4) * 8)
                    : make_uint4(0, 0, 0, 0);
      rw[i] = *reinterpret_cast<const uint4*>(
          W + (size_t)(k0 + v / 8) * N + n0 + (v % 8) * 8);
    }
  };
  auto stash = [&](int k0) {
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int v = tid + i * T_THREADS;
      const int r = v / 4, c = (v % 4) * 8;
      uint4 a = ra[i];
      if (gamma != nullptr && m0 + r < M) {
        bf16* e = reinterpret_cast<bf16*>(&a);
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          const int kk = k0 + c + j;
          e[j] = __float2bfloat16_rn((to_f(e[j]) - mu[r]) * rs[r] * gamma[kk] +
                                     beta[kk]);
        }
      }
      *reinterpret_cast<uint4*>(As + r * LDA + c) = a;
      *reinterpret_cast<uint4*>(Ws + (v / 8) * LDW + (v % 8) * 8) = rw[i];
    }
  };

  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[2][2];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j) wmma::fill_fragment(acc[i][j], 0.f);

  load(0);
  for (int k0 = 0; k0 < K; k0 += T_BK) {
    stash(k0);
    __syncthreads();
    if (k0 + T_BK < K) load(k0 + T_BK);
#pragma unroll
    for (int kk = 0; kk < T_BK; kk += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> a[2];
      wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> w[2];
#pragma unroll
      for (int i = 0; i < 2; ++i)
        wmma::load_matrix_sync(a[i], As + (wm * 32 + i * 16) * LDA + kk, LDA);
#pragma unroll
      for (int j = 0; j < 2; ++j)
        wmma::load_matrix_sync(w[j], Ws + kk * LDW + wn * 32 + j * 16, LDW);
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int j = 0; j < 2; ++j)
          wmma::mma_sync(acc[i][j], a[i], w[j], acc[i][j]);
    }
    __syncthreads();
  }
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j)
      wmma::store_matrix_sync(Cs + (wm * 32 + i * 16) * LDC + wn * 32 + j * 16,
                              acc[i][j], LDC, wmma::mem_row_major);
  __syncthreads();
  for (int i = tid; i < BM * BN; i += T_THREADS) {
    const int r = i / BN, c = i % BN;
    if (m0 + r < M)
      store_out(Cs[r * LDC + c], m0 + r, n0 + c, N, bias, res, gelu, C);
  }
}

template <typename T>
int gemm(const void* a, const void* w, const void* bias, const float* gamma,
         const float* beta, const void* res, void* c, int m, int n, int k,
         float eps, int gelu, cudaStream_t stream) {
  if (n % BN || k % T_BK) return (int)cudaErrorInvalidValue;
  // the bf16 kernel moves A and W rows as 16-byte vectors
  if (sizeof(T) == 2 && (((uintptr_t)a | (uintptr_t)w) & 15))
    return (int)cudaErrorInvalidValue;
  dim3 grid(n / BN, (m + BM - 1) / BM);
  if (sizeof(T) == 2)
    gemm_bf16<<<grid, T_THREADS, 0, stream>>>(
        (const bf16*)a, (const bf16*)w, (const bf16*)bias, gamma, beta,
        (const bf16*)res, (bf16*)c, m, n, k, eps, gelu);
  else
    gemm_f32<<<grid, F_THREADS, 0, stream>>>(
        (const float*)a, (const float*)w, (const float*)bias, gamma, beta,
        (const float*)res, (float*)c, m, n, k, eps, gelu);
  return (int)cudaGetLastError();
}

// B5: LN1 -> QKV -> per-item attention -> out-proj + residual (launches 1-3)
template <typename T>
int attn_half(const void* x, void* out, void* qkv, void* attn,
              const float* ln, const void* wqkv, const void* bqkv,
              const void* wout, const void* bout, int tokens, int seq, int d,
              int heads, float eps, int causal, int dtype, cudaStream_t s) {
  int e;
  // 1. LN1 -> QKV
  if ((e = gemm<T>(x, wqkv, bqkv, ln, ln + d, nullptr, qkv, tokens, 3 * d, d,
                   eps, 0, s)))
    return e;
  // 2. per-item attention over the q/k/v column blocks (row stride 3D);
  //    q is not pre-scaled: the f32 logits take hd^-0.5 (_attn_math)
  const char* base = (const char*)qkv;
  const size_t col = (size_t)d * sizeof(T);
  if ((e = vqt_attention(base, base + col, base + 2 * col, attn,
                         tokens / seq, seq, heads, d / heads, 3 * d, d, seq,
                         causal, 1.f / sqrtf((float)(d / heads)), dtype, s)))
    return e;
  // 3. out-proj + residual
  return gemm<T>(attn, wout, bout, nullptr, nullptr, x, out, tokens, d, d,
                 eps, 0, s);
}

// B6: LN2 (ln rows 2-3) -> fc1 -> quick-GELU -> fc2 + residual (launches 4-5)
template <typename T>
int mlp_half(const void* x3, void* out, void* h, const float* ln,
             const void* wfc1, const void* bfc1, const void* wfc2,
             const void* bfc2, int tokens, int d, int f, float eps,
             cudaStream_t s) {
  int e;
  // 4. LN2 -> fc1 -> quick-GELU
  if ((e = gemm<T>(x3, wfc1, bfc1, ln + 2 * d, ln + 3 * d, nullptr, h,
                   tokens, f, d, eps, 1, s)))
    return e;
  // 5. fc2 + residual
  return gemm<T>(h, wfc2, bfc2, nullptr, nullptr, x3, out, tokens, d, f,
                 eps, 0, s);
}

bool bad_shape(int tokens, int seq, int d, int heads) {
  return tokens <= 0 || seq <= 0 || tokens % seq || heads <= 0 || d % heads;
}

}  // namespace

extern "C" int vqt_attn_half(const void* x, void* out, void* qkv, void* attn,
                             const void* ln, const void* wqkv,
                             const void* bqkv, const void* wout,
                             const void* bout, int tokens, int seq, int d,
                             int heads, float eps, int causal, int dtype,
                             void* stream) {
  if (bad_shape(tokens, seq, d, heads)) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  const float* lnf = (const float*)ln;
  if (dtype == vqt::DT_BF16)
    return attn_half<bf16>(x, out, qkv, attn, lnf, wqkv, bqkv, wout, bout,
                           tokens, seq, d, heads, eps, causal, dtype, s);
  if (dtype == vqt::DT_F32)
    return attn_half<float>(x, out, qkv, attn, lnf, wqkv, bqkv, wout, bout,
                            tokens, seq, d, heads, eps, causal, dtype, s);
  return (int)cudaErrorInvalidValue;
}

extern "C" int vqt_mlp_half(const void* x3, void* out, void* h,
                            const void* ln, const void* wfc1,
                            const void* bfc1, const void* wfc2,
                            const void* bfc2, int tokens, int d, int f,
                            float eps, int dtype, void* stream) {
  if (tokens <= 0) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  const float* lnf = (const float*)ln;
  if (dtype == vqt::DT_BF16)
    return mlp_half<bf16>(x3, out, h, lnf, wfc1, bfc1, wfc2, bfc2, tokens, d,
                          f, eps, s);
  if (dtype == vqt::DT_F32)
    return mlp_half<float>(x3, out, h, lnf, wfc1, bfc1, wfc2, bfc2, tokens,
                           d, f, eps, s);
  return (int)cudaErrorInvalidValue;
}

// B2: the whole causal text block = B5 (causal) then B6
extern "C" int vqt_text_layer(const void* x, void* out, void* qkv,
                              void* attn, void* x3, void* h, const void* ln,
                              const void* wqkv, const void* bqkv,
                              const void* wout, const void* bout,
                              const void* wfc1, const void* bfc1,
                              const void* wfc2, const void* bfc2, int tokens,
                              int seq, int d, int heads, int f, float eps,
                              int dtype, void* stream) {
  int e;
  if ((e = vqt_attn_half(x, x3, qkv, attn, ln, wqkv, bqkv, wout, bout,
                         tokens, seq, d, heads, eps, 1, dtype, stream)))
    return e;
  return vqt_mlp_half(x3, out, h, ln, wfc1, bfc1, wfc2, bfc2, tokens, d, f,
                      eps, dtype, stream);
}
