// Kernels B2, B5 and B6: pre-norm encoder blocks (CLIP, SigLIP, AIMv2).
//
// Replace the TPU kernels of video_quierer_tpu/ops/fused_layer.py:
// - B5 _attn_half_call (kernel _attn_half_kernel = _attn_math): LN1 (f32
//   stats) -> QKV + bias -> per-item attention (causal for text,
//   non-causal for the ViT-B/32 vision tower at S=50) -> out-proj + bias ->
//   residual;
// - B6 _mlp_half_call (kernel _mlp_half_kernel = _mlp_math): LN2 -> fc1 +
//   bias -> quick-GELU (CLIP) or tanh-GELU (SigLIP) -> fc2 + bias ->
//   residual;
// - B2 _fused_layer_call (kernel _layer_kernel = both): the causal text
//   block, here B5 followed by B6 in one C call (vqt_text_layer);
// all on the flat [B*S, D] token matrix.
//
// The TPU kernels keep a layer's (or a half's) weights resident in VMEM for
// one pallas_call. One SM's 227 KB of shared memory cannot hold them, so
// here a block is five GEMM/attention launches on the host side of the C
// calls (bf16: plus one LayerNorm launch before each LN GEMM):
//   B5 1. GEMM with LayerNorm-1 as its prologue, bias epilogue       -> qkv
//      2. per-item attention on the q/k/v column blocks of qkv
//         (attention.cu; the TPU kernel's cross-item mask over a shared
//         tile is TPU redundancy, not semantics)                     -> attn
//      3. GEMM, bias + residual epilogue                             -> x3
//   B6 4. GEMM with LayerNorm-2 prologue, bias + GELU epilogue       -> h
//      5. GEMM, bias + residual epilogue                             -> out
// The weights keep _layer_operands' layout: [in, out] row-major with q/k/v
// concatenated along out (wqkv [D, 3D]). Item boundaries (S = 50 for the
// vision tower) fall anywhere inside a GEMM tile: the GEMMs are
// per token, only the attention step sees items.
//
// The GEMM keeps the reference's bf16 rounding points in its prologue
// (LN output rounded to T) and epilogue (T(acc), + bias in T, the GELU
// in T, + residual in T) around an f32 accumulate. The activation is a
// template parameter (ACT_NONE, ACT_QUICK_GELU, ACT_GELU_TANH) of both
// GEMMs, picked once per C call, so no tile carries a runtime branch:
// - bf16 (the serving towers): LayerNorm runs first as its own small kernel
//   (ln_bf16, one warp a row, f32 statistics) into a scratch [T, D] bf16
//   buffer, so the GEMM's A operand is a plain TMA copy; then gemm_wgmma: a
//   ring of 3 shared-memory stages of 64-deep A and W tiles, filled by TMA
//   (128-byte swizzle, mbarrier-guarded) from one producer warp, consumed by
//   one or two warpgroups issuing wgmma.mma_async m64nNk16 bf16 with f32
//   accumulators in registers, and the epilogue applied to the accumulator
//   fragment in registers. W stays [in, out] row-major: it is wgmma's B
//   operand in MN-major form (the transpose bit, 64-wide swizzle atoms).
//   The tile is picked by shape: 128x128 where that gives at least one CTA
//   per SM, else 128x64, else 64x64 (the text tower's N = 512 GEMMs), and
//   two CTAs share an SM, so one's epilogue overlaps the other's loads.
// - f32: a shared-memory tiled FMA loop on the CUDA cores (64x64 tile,
//   4x4 outputs per thread) with the LayerNorm fused as its prologue.
//
// AIMv2's blocks (models/aimv2) take the same halves with two compile-time
// choices each: RMSNorm in place of LayerNorm (no mean, no shift: rms_bf16,
// or ln_stats<RMS> in the f32 prologue) and bias-free projections
// (EPI_NO_BIAS: T(acc), then the residual); their MLP half is SiLU-gated
// (vqt_gated_mlp_half): the gate and up matrices are interleaved by 8
// columns at load (W' [D, 2F]: columns 16 i .. 16 i + 7 gate features
// 8 i .. 8 i + 7, the next 8 the same up features), so each accumulator
// fragment of one wgmma tile holds a gate and its up value for the same
// features, and the epilogue (EPI_SILU_GATE) writes T(silu(T(g)) T(u))
// into the [T, F] hidden buffer, half the tile's width; then the down
// GEMM adds the residual.
// Bound on the H100: at the vision tower's ingest batch (12,800 tokens x
// 768 wide, 62 + 121 GFLOP a layer) the tensor-core peak bounds both
// halves; what keeps the kernel from it is the non-persistent grid (the
// prologue of each tile's pipeline, 2.3-4.5 waves of 128x128 tiles), the
// scalar 4-byte epilogue stores and the LN pass (2 x T x D x 2 bytes). At
// text serving batches (1,024 tokens x 512 wide) the GEMMs are small (0.5-2
// GFLOP each), so the launches per 12-layer encode and the small grids,
// not the peak, set the time.
#include "tma.cuh"

namespace {

using vqt::bf16;
using vqt::from_f;
using vqt::gmma_desc;
using vqt::mbar_arrive;
using vqt::mbar_expect;
using vqt::mbar_init;
using vqt::mbar_wait;
using vqt::rnd;
using vqt::smem_u32;
using vqt::tensor_map;
using vqt::tma_load;
using vqt::to_f;

constexpr int BM = 64, BN = 64;

// Per-row LayerNorm statistics of A rows [m0, m0 + BM) (f32, two-pass),
// into mu/rs; rows past M get zeros. RMS: mean 0 (RMSNorm's statistics).
// All threads of the CTA take part.
template <typename T, bool RMS>
__device__ void ln_stats(const T* __restrict__ A, int M, int K, int m0,
                         float eps, float* mu, float* rs) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  for (int r = warp; r < BM; r += blockDim.x / 32) {
    const int m = m0 + r;
    float mean = 0.f, rstd = 0.f;
    if (m < M) {
      const T* row = A + (size_t)m * K;
      if constexpr (!RMS) {
        float s = 0.f;
        for (int c = lane; c < K; c += 32) s += to_f(row[c]);
        mean = vqt::warp_sum(s) / K;
      }
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

// Prologue: A[m, kk] (LayerNorm-ed, or RMSNorm-ed, and rounded to T when
// gamma is given)
template <typename T, bool RMS>
__device__ __forceinline__ float a_elem(const T* __restrict__ A, int M, int K,
                                        int m0, int r, int kk,
                                        const float* gamma, const float* beta,
                                        const float* mu, const float* rs) {
  const int m = m0 + r;
  if (m >= M) return 0.f;
  const float a = to_f(A[(size_t)m * K + kk]);
  if (gamma == nullptr) return a;
  if constexpr (RMS) return rnd<T>(a * rs[r] * gamma[kk]);
  return rnd<T>((a - mu[r]) * rs[r] * gamma[kk] + beta[kk]);
}

// the epilogue's activation (ops/fused_layer.py:ACT_CODES), and the
// bias-free epilogues of AIMv2's blocks: EPI_NO_BIAS (T(acc)) and
// EPI_SILU_GATE (the gated pair, gated() below)
constexpr int ACT_NONE = 0, ACT_QUICK_GELU = 1, ACT_GELU_TANH = 2;
constexpr int EPI_NO_BIAS = 3, EPI_SILU_GATE = 4;

// Epilogue of one output from its f32 accumulator, before the residual:
// T(acc) + bias in T, then the activation in T, every step rounded to T
// with the reference's weakly typed constants rounded to T (_mlp_math):
// - quick-GELU: x / (1 + exp(-1.702 x));
// - tanh-GELU: u = c1 (x + c2 ((x x) x)), then x (1 / (1 + exp(-2 u))),
//   c1 = sqrt(2 / pi), c2 = 0.044715 (bf16: 0.796875, 0.044677734375).
//   For large negative x, exp gives inf and the output is -0.
template <typename T, int ACT>
__device__ __forceinline__ float epilogue(float acc, float bias) {
  float t = rnd<T>(acc);
  if constexpr (ACT == EPI_NO_BIAS) return t;
  t = rnd<T>(t + bias);
  if constexpr (ACT == ACT_QUICK_GELU) {
    const float e = rnd<T>(expf(rnd<T>(rnd<T>(-1.702f) * t)));
    t = rnd<T>(t * rnd<T>(1.f / rnd<T>(1.f + e)));
  } else if constexpr (ACT == ACT_GELU_TANH) {
    const float cube = rnd<T>(rnd<T>(t * t) * t);
    const float inner = rnd<T>(t + rnd<T>(rnd<T>(0.044715f) * cube));
    const float u = rnd<T>(rnd<T>(0.7978845608028654f) * inner);
    const float e = rnd<T>(expf(rnd<T>(-2.f * u)));
    t = rnd<T>(t * rnd<T>(1.f / rnd<T>(1.f + e)));
  }
  return t;
}

// The SiLU-gated pair from its gate and up accumulators, every step
// rounded to T: g = T(acc_g), u = T(acc_u), T(T(g (1 / (1 + exp(-g)))) u)
// (models/aimv2, ops/fused_layer.py:gated_mlp_half_ref)
template <typename T>
__device__ __forceinline__ float gated(float acc_g, float acc_u) {
  const float g = rnd<T>(acc_g), u = rnd<T>(acc_u);
  const float e = rnd<T>(expf(-g));
  return rnd<T>(rnd<T>(g * rnd<T>(1.f / rnd<T>(1.f + e))) * u);
}

// ... then + residual in T, stored
template <typename T, int ACT>
__device__ __forceinline__ void store_out(float acc, int m, int n, int N,
                                          const T* __restrict__ bias,
                                          const T* __restrict__ res,
                                          T* __restrict__ C) {
  float t = epilogue<T, ACT>(acc, ACT == EPI_NO_BIAS ? 0.f : to_f(bias[n]));
  if (res != nullptr) t = rnd<T>(to_f(res[(size_t)m * N + n]) + t);
  C[(size_t)m * N + n] = from_f<T>(t);
}

// f32: C[M, N] = epilogue(prologue(A)[M, K] @ W[K, N]) on the CUDA cores
constexpr int F_BK = 16, F_TM = 4, F_TN = 4, F_THREADS = 256;

template <int ACT, bool RMS>
__global__ void __launch_bounds__(F_THREADS)
gemm_f32(const float* __restrict__ A, const float* __restrict__ W,
         const float* __restrict__ bias, const float* __restrict__ gamma,
         const float* __restrict__ beta, const float* __restrict__ res,
         float* __restrict__ C, int M, int N, int K, float eps) {
  __shared__ float As[F_BK][BM + 4];
  __shared__ float Ws[F_BK][BN];
  __shared__ float mu[BM], rs[BM];
  const int tid = threadIdx.x;
  const int tx = tid % 16, ty = tid / 16;
  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * BN;
  if (gamma != nullptr) ln_stats<float, RMS>(A, M, K, m0, eps, mu, rs);

  float acc[F_TM][F_TN];
#pragma unroll
  for (int i = 0; i < F_TM; ++i)
#pragma unroll
    for (int j = 0; j < F_TN; ++j) acc[i][j] = 0.f;

  for (int k0 = 0; k0 < K; k0 += F_BK) {
    for (int i = tid; i < BM * F_BK; i += F_THREADS) {
      const int r = i / F_BK, c = i % F_BK;
      As[c][r] = a_elem<float, RMS>(A, M, K, m0, r, k0 + c, gamma, beta,
                                    mu, rs);
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
  if constexpr (ACT == EPI_SILU_GATE) {
    // a thread's columns are all gate or all up (tx + 16 j): the tile
    // goes through shared memory, then each output of the tile's 32
    // features is formed from its gate and up columns (N / 2 wide)
    __shared__ float Cs[BM][BN + 1];
#pragma unroll
    for (int i = 0; i < F_TM; ++i)
#pragma unroll
      for (int j = 0; j < F_TN; ++j) Cs[ty + 16 * i][tx + 16 * j] = acc[i][j];
    __syncthreads();
    for (int idx = tid; idx < BM * BN / 2; idx += F_THREADS) {
      const int r = idx / (BN / 2), o = idx % (BN / 2), m = m0 + r;
      if (m >= M) continue;
      const int c = 16 * (o / 8) + o % 8;
      C[(size_t)m * (N / 2) + n0 / 2 + o] = gated<float>(Cs[r][c],
                                                         Cs[r][c + 8]);
    }
    return;
  }
#pragma unroll
  for (int i = 0; i < F_TM; ++i) {
    const int m = m0 + ty + 16 * i;
    if (m >= M) continue;
#pragma unroll
    for (int j = 0; j < F_TN; ++j)
      store_out<float, ACT>(acc[i][j], m, n0 + tx + 16 * j, N, bias, res,
                            C);
  }
}

// f32: launch gemm_f32 (LayerNorm, or RMSNorm, fused when gamma is given)
template <int ACT, bool RMS>
int gemm_f32_launch(const float* a, const float* w, const float* bias,
                    const float* gamma, const float* beta, const float* res,
                    float* c, int m, int n, int k, float eps,
                    cudaStream_t stream) {
  if (n % BN || k % F_BK) return (int)cudaErrorInvalidValue;
  dim3 grid(n / BN, (m + BM - 1) / BM);
  gemm_f32<ACT, RMS><<<grid, F_THREADS, 0, stream>>>(
      a, w, bias, gamma, beta, res, c, m, n, k, eps);
  return (int)cudaGetLastError();
}

// -- bf16: LayerNorm pass -----------------------------------------------------

constexpr int LN_ROWS = 8;  // one warp a row
constexpr int LN_MAX_K = 1024;  // 4 x 16-byte vectors a lane

// y = bf16(LN(x)) with f32 statistics (two-pass, as ln_stats): one warp a
// row, held in registers as V 16-byte vectors a lane (K <= 256 V, K % 8 ==
// 0), so x is read once.
template <int V>
__global__ void __launch_bounds__(LN_ROWS * 32)
ln_bf16(const bf16* __restrict__ x, const float* __restrict__ gamma,
        const float* __restrict__ beta, bf16* __restrict__ y, int M, int K,
        float eps) {
  const int row = blockIdx.x * LN_ROWS + threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  if (row >= M) return;
  const bf16* xr = x + (size_t)row * K;
  uint4 v[V];
  float s = 0.f;
#pragma unroll
  for (int i = 0; i < V; ++i) {
    const int c = (lane + 32 * i) * 8;
    v[i] = c < K ? *reinterpret_cast<const uint4*>(xr + c)
                 : make_uint4(0, 0, 0, 0);
    const bf16* e = reinterpret_cast<const bf16*>(&v[i]);
#pragma unroll
    for (int j = 0; j < 8; ++j) s += to_f(e[j]);
  }
  const float mean = vqt::warp_sum(s) / K;
  float var = 0.f;
#pragma unroll
  for (int i = 0; i < V; ++i) {
    if ((lane + 32 * i) * 8 >= K) continue;
    const bf16* e = reinterpret_cast<const bf16*>(&v[i]);
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const float d = to_f(e[j]) - mean;
      var += d * d;
    }
  }
  const float rstd = 1.f / sqrtf(vqt::warp_sum(var) / K + eps);
#pragma unroll
  for (int i = 0; i < V; ++i) {
    const int c = (lane + 32 * i) * 8;
    if (c >= K) continue;
    // gamma and beta as 16-byte vectors too
    const float4* g4 = reinterpret_cast<const float4*>(gamma + c);
    const float4* b4 = reinterpret_cast<const float4*>(beta + c);
    const float4 g0 = g4[0], g1 = g4[1], b0 = b4[0], b1 = b4[1];
    const float ga[8] = {g0.x, g0.y, g0.z, g0.w, g1.x, g1.y, g1.z, g1.w};
    const float be[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
    bf16* e = reinterpret_cast<bf16*>(&v[i]);
#pragma unroll
    for (int j = 0; j < 8; ++j)
      e[j] = from_f<bf16>((to_f(e[j]) - mean) * rstd * ga[j] + be[j]);
    *reinterpret_cast<uint4*>(y + (size_t)row * K + c) = v[i];
  }
}

// y = bf16(x rstd gamma), rstd = 1 / sqrt(mean(x^2) + eps) in f32: RMSNorm
// (AIMv2), ln_bf16's layout without the mean and the shift
template <int V>
__global__ void __launch_bounds__(LN_ROWS * 32)
rms_bf16(const bf16* __restrict__ x, const float* __restrict__ gamma,
         bf16* __restrict__ y, int M, int K, float eps) {
  const int row = blockIdx.x * LN_ROWS + threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  if (row >= M) return;
  const bf16* xr = x + (size_t)row * K;
  uint4 v[V];
  float ss = 0.f;
#pragma unroll
  for (int i = 0; i < V; ++i) {
    const int c = (lane + 32 * i) * 8;
    v[i] = c < K ? *reinterpret_cast<const uint4*>(xr + c)
                 : make_uint4(0, 0, 0, 0);
    const bf16* e = reinterpret_cast<const bf16*>(&v[i]);
#pragma unroll
    for (int j = 0; j < 8; ++j) ss += to_f(e[j]) * to_f(e[j]);
  }
  const float rstd = 1.f / sqrtf(vqt::warp_sum(ss) / K + eps);
#pragma unroll
  for (int i = 0; i < V; ++i) {
    const int c = (lane + 32 * i) * 8;
    if (c >= K) continue;
    const float4* g4 = reinterpret_cast<const float4*>(gamma + c);
    const float4 g0 = g4[0], g1 = g4[1];
    const float ga[8] = {g0.x, g0.y, g0.z, g0.w, g1.x, g1.y, g1.z, g1.w};
    bf16* e = reinterpret_cast<bf16*>(&v[i]);
#pragma unroll
    for (int j = 0; j < 8; ++j)
      e[j] = from_f<bf16>(to_f(e[j]) * rstd * ga[j]);
    *reinterpret_cast<uint4*>(y + (size_t)row * K + c) = v[i];
  }
}

int rms_launch(const bf16* x, const float* gamma, bf16* y, int m, int k,
               float eps, cudaStream_t stream) {
  if (k % 8 || k > LN_MAX_K ||
      (((uintptr_t)x | (uintptr_t)y | (uintptr_t)gamma) & 15))
    return (int)cudaErrorInvalidValue;
  const dim3 grid((m + LN_ROWS - 1) / LN_ROWS), block(LN_ROWS * 32);
  switch ((k + 255) / 256) {
    case 1: rms_bf16<1><<<grid, block, 0, stream>>>(x, gamma, y, m, k, eps);
      break;
    case 2: rms_bf16<2><<<grid, block, 0, stream>>>(x, gamma, y, m, k, eps);
      break;
    case 3: rms_bf16<3><<<grid, block, 0, stream>>>(x, gamma, y, m, k, eps);
      break;
    default: rms_bf16<4><<<grid, block, 0, stream>>>(x, gamma, y, m, k,
                                                     eps); break;
  }
  return (int)cudaGetLastError();
}

int ln_launch(const bf16* x, const float* gamma, const float* beta, bf16* y,
              int m, int k, float eps, cudaStream_t stream) {
  if (k % 8 || k > LN_MAX_K ||
      (((uintptr_t)x | (uintptr_t)y | (uintptr_t)gamma | (uintptr_t)beta) &
       15))
    return (int)cudaErrorInvalidValue;
  const dim3 grid((m + LN_ROWS - 1) / LN_ROWS), block(LN_ROWS * 32);
  switch ((k + 255) / 256) {
    case 1: ln_bf16<1><<<grid, block, 0, stream>>>(x, gamma, beta, y, m, k,
                                                   eps); break;
    case 2: ln_bf16<2><<<grid, block, 0, stream>>>(x, gamma, beta, y, m, k,
                                                   eps); break;
    case 3: ln_bf16<3><<<grid, block, 0, stream>>>(x, gamma, beta, y, m, k,
                                                   eps); break;
    default: ln_bf16<4><<<grid, block, 0, stream>>>(x, gamma, beta, y, m, k,
                                                    eps); break;
  }
  return (int)cudaGetLastError();
}

// -- bf16: TMA + wgmma GEMM ---------------------------------------------------

constexpr int G_BK = 64;     // K depth of a stage: one 128-byte swizzle row
constexpr int G_ST = 3;      // pipeline stages (96 KB at 128x128: two CTAs
                             // an SM, so one's epilogue overlaps the other)
constexpr int ATOM = 64 * G_BK * 2;  // a 64 x 64 bf16 tile: 8 KB
constexpr int MAX_DEVICES = 64;      // per-device host caches

// d += A (K-major, shared) @ B (MN-major, shared): m64 n64/n128 k16
__device__ __forceinline__ void wgmma(float (&d)[32], uint64_t da,
                                      uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, %32, %33, p, 1, 1, 0, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(1));
}

__device__ __forceinline__ void wgmma(float (&d)[64], uint64_t da,
                                      uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63"
      "}, %64, %65, p, 1, 1, 0, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(1));
}

template <int BM, int BN>
constexpr size_t wgmma_smem() {
  return G_ST * ((size_t)(BM + BN) * G_BK * 2 + 16) + 1024;
}

// C[M, N] = epilogue(A[M, K] @ W[K, N]). Warps 0 .. BM/16 - 1 are the
// consumer warpgroups (rows 64 wg .. of the tile), the last warp the
// producer. Stage s holds A [BM][64] (K-major) and W as BN/64 atoms of
// [64 K][64 N] (MN-major), each 128-byte swizzled by TMA.
template <int BM, int BN, int ACT>
__global__ void __launch_bounds__(BM * 2 + 32, 2)
gemm_wgmma(const __grid_constant__ CUtensorMap amap,
           const __grid_constant__ CUtensorMap wmap,
           const bf16* __restrict__ bias, const bf16* __restrict__ res,
           bf16* __restrict__ C, int M, int N, int K) {
  constexpr int CONS = BM / 64, A_BYTES = BM * G_BK * 2,
                STAGE = (BM + BN) * G_BK * 2;
  extern __shared__ uint8_t smem_raw[];
  // swizzle atoms must sit on 1,024-byte boundaries
  uint8_t* smem = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + G_ST * STAGE);
  uint64_t* empty = full + G_ST;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * BN;
  const int kt_n = (K + G_BK - 1) / G_BK;
  if (threadIdx.x == 0) {
    for (int s = 0; s < G_ST; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], CONS * 4);  // one arrival per consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (warp == CONS * 4) {  // producer
    if (lane == 0) {
      for (int kt = 0; kt < kt_n; ++kt) {
        const int s = kt % G_ST;
        if (kt >= G_ST) mbar_wait(&empty[s], ((kt / G_ST) & 1) ^ 1);
        uint8_t* st = smem + s * STAGE;
        mbar_expect(&full[s], STAGE);
        tma_load(st, &amap, kt * G_BK, m0, &full[s]);
#pragma unroll
        for (int j = 0; j < BN / 64; ++j)
          tma_load(st + A_BYTES + j * ATOM, &wmap, n0 + 64 * j, kt * G_BK,
                   &full[s]);
      }
    }
    return;
  }

  const int wg = warp / 4;
  float acc[BN / 2];
#pragma unroll
  for (int i = 0; i < BN / 2; ++i) acc[i] = 0.f;
  for (int kt = 0; kt < kt_n; ++kt) {
    const int s = kt % G_ST;
    mbar_wait(&full[s], (kt / G_ST) & 1);
    const uint32_t a = smem_u32(smem + s * STAGE) + wg * 64 * 128;
    const uint32_t b = smem_u32(smem + s * STAGE + A_BYTES);
    asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
#pragma unroll
    for (int kk = 0; kk < G_BK / 16; ++kk)
      // A: 16 columns = 32 bytes along the swizzled row; W: 16 rows = two
      // 8-row groups of 1,024 bytes
      wgmma(acc, gmma_desc(a + kk * 32, 16, 1024),
            gmma_desc(b + kk * 2048, ATOM, 1024));
    asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
    // the previous stage's products are done: hand its buffers back
    asm volatile("wgmma.wait_group.sync.aligned 1;\n" ::: "memory");
    if (kt > 0 && lane == 0) mbar_arrive(&empty[(kt - 1) % G_ST]);
  }
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");

  // fragment: rows g and g + 8 of the warp's 16, columns 8 j + 2 t, + 1
  const int g = lane / 4, t = lane % 4;
  const int r0 = m0 + wg * 64 + (warp % 4) * 16 + g;
  if constexpr (ACT == EPI_SILU_GATE) {
    // n-tiles 2 i (gate) and 2 i + 1 (up) hold the same 8 features of the
    // N / 2 wide output
#pragma unroll
    for (int j = 0; j < BN / 8; j += 2) {
      const int c = n0 / 2 + 4 * j + 2 * t;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int r = r0 + 8 * h;
        if (r >= M) continue;
        const float v0 = gated<bf16>(acc[4 * j + 2 * h],
                                     acc[4 * j + 4 + 2 * h]);
        const float v1 = gated<bf16>(acc[4 * j + 2 * h + 1],
                                     acc[4 * j + 4 + 2 * h + 1]);
        *reinterpret_cast<__nv_bfloat162*>(C + (size_t)r * (N / 2) + c) =
            __floats2bfloat162_rn(v0, v1);
      }
    }
    return;
  }
#pragma unroll
  for (int j = 0; j < BN / 8; ++j) {
    const int c = n0 + 8 * j + 2 * t;
    __nv_bfloat162 bb{};
    if constexpr (ACT != EPI_NO_BIAS)
      bb = *reinterpret_cast<const __nv_bfloat162*>(bias + c);
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int r = r0 + 8 * h;
      if (r >= M) continue;
      float v0 = epilogue<bf16, ACT>(acc[4 * j + 2 * h], __low2float(bb));
      float v1 =
          epilogue<bf16, ACT>(acc[4 * j + 2 * h + 1], __high2float(bb));
      const size_t o = (size_t)r * N + c;
      if (res != nullptr) {
        const __nv_bfloat162 rr =
            *reinterpret_cast<const __nv_bfloat162*>(res + o);
        v0 = rnd<bf16>(__low2float(rr) + v0);
        v1 = rnd<bf16>(__high2float(rr) + v1);
      }
      *reinterpret_cast<__nv_bfloat162*>(C + o) =
          __floats2bfloat162_rn(v0, v1);
    }
  }
}

template <int BM, int BN, int ACT>
int launch_wgmma(const bf16* a, const bf16* w, const bf16* bias,
                 const bf16* res, bf16* c, int m, int n, int k, int dev,
                 cudaStream_t stream) {
  CUtensorMap amap, wmap;
  if (!tensor_map(&amap, a, m, k, BM) || !tensor_map(&wmap, w, k, n, 64))
    return (int)cudaErrorInvalidValue;
  constexpr size_t smem = wgmma_smem<BM, BN>();
  // the shared-memory opt-in, once per device
  static bool opted[MAX_DEVICES];
  if (!opted[dev]) {
    cudaError_t e = cudaFuncSetAttribute(
        gemm_wgmma<BM, BN, ACT>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (e != cudaSuccess) return (int)e;
    opted[dev] = true;
  }
  dim3 grid(n / BN, (m + BM - 1) / BM);
  gemm_wgmma<BM, BN, ACT><<<grid, BM * 2 + 32, smem, stream>>>(
      amap, wmap, bias, res, c, m, n, k);
  return (int)cudaGetLastError();
}

// the tile: the largest of 128x128, 128x64, 64x64 whose grid gives every
// SM at least one CTA (N % 128 for the first). 128x256 with 4 stages, one
// CTA an SM, read 0.60 ms for B6 at 256 frames against 0.42 for 128x128:
// its epilogue idles the tensor cores.
template <int ACT>
int gemm_bf16(const bf16* a, const bf16* w, const bf16* bias, const bf16* res,
              bf16* c, int m, int n, int k, cudaStream_t stream) {
  // TMA: 16-byte aligned bases and row strides; whole 64-wide W atoms
  if (n % 64 || k % 8 || (((uintptr_t)a | (uintptr_t)w) & 15))
    return (int)cudaErrorInvalidValue;
  int dev = 0;
  if (cudaGetDevice(&dev) != cudaSuccess || dev >= MAX_DEVICES)
    return (int)cudaErrorInvalidDevice;
  static int sm_count[MAX_DEVICES];
  if (sm_count[dev] == 0)
    cudaDeviceGetAttribute(&sm_count[dev], cudaDevAttrMultiProcessorCount,
                           dev);
  const long rows128 = (m + 127) / 128, sms = sm_count[dev];
  if (n % 128 == 0 && rows128 * (n / 128) >= sms)
    return launch_wgmma<128, 128, ACT>(a, w, bias, res, c, m, n, k, dev,
                                       stream);
  if (rows128 * (n / 64) >= sms)
    return launch_wgmma<128, 64, ACT>(a, w, bias, res, c, m, n, k, dev,
                                      stream);
  return launch_wgmma<64, 64, ACT>(a, w, bias, res, c, m, n, k, dev, stream);
}

// One GEMM of a block: C = epilogue(norm?(A) @ W), norm LayerNorm or (RMS)
// RMSNorm. f32: gemm_f32 with the norm fused; bf16: ln_bf16 or rms_bf16
// into `lnbuf` ([m, k], when gamma is given), then gemm_wgmma.
template <typename T, int ACT, bool RMS = false>
int layer_gemm(const void* a, const void* w, const void* bias,
               const float* gamma, const float* beta, void* lnbuf,
               const void* res, void* c, int m, int n, int k, float eps,
               cudaStream_t stream) {
  if (sizeof(T) == 4)
    return gemm_f32_launch<ACT, RMS>((const float*)a, (const float*)w,
                                     (const float*)bias, gamma, beta,
                                     (const float*)res, (float*)c, m, n, k,
                                     eps, stream);
  if (gamma != nullptr) {
    const int e = RMS ? rms_launch((const bf16*)a, gamma, (bf16*)lnbuf, m, k,
                                   eps, stream)
                      : ln_launch((const bf16*)a, gamma, beta, (bf16*)lnbuf,
                                  m, k, eps, stream);
    if (e) return e;
    a = lnbuf;
  }
  return gemm_bf16<ACT>((const bf16*)a, (const bf16*)w, (const bf16*)bias,
                        (const bf16*)res, (bf16*)c, m, n, k, stream);
}

// B5: LN1 -> QKV -> per-item attention -> out-proj + residual (launches
// 1-3). AIMv2 (RMS, no BIAS): RMSNorm-1 (ln holds its scale alone) and
// bias-free QKV and out-proj.
template <typename T, bool RMS = false, bool BIAS = true>
int attn_half(const void* x, void* out, void* qkv, void* attn,
              const float* ln, const void* wqkv, const void* bqkv,
              const void* wout, const void* bout, int tokens, int seq, int d,
              int heads, float eps, int causal, int dtype, cudaStream_t s) {
  constexpr int EPI = BIAS ? ACT_NONE : EPI_NO_BIAS;
  int e;
  // 1. LN1 -> QKV (bf16: LN1 into attn, free until step 2)
  if ((e = layer_gemm<T, EPI, RMS>(x, wqkv, bqkv, ln, RMS ? nullptr : ln + d,
                                   attn, nullptr, qkv, tokens, 3 * d, d, eps,
                                   s)))
    return e;
  // 2. per-item attention over the q/k/v column blocks (row stride 3D);
  //    q is not pre-scaled: the f32 logits take hd^-0.5 (_attn_math)
  const char* base = (const char*)qkv;
  const size_t col = (size_t)d * sizeof(T);
  if ((e = vqt_attention(base, base + col, base + 2 * col, attn,
                         tokens / seq, seq, heads, d / heads, 3 * d, d, seq,
                         causal, 1.f, 1.f / sqrtf((float)(d / heads)), dtype,
                         s)))
    return e;
  // 3. out-proj + residual
  return layer_gemm<T, EPI>(attn, wout, bout, nullptr, nullptr, nullptr, x,
                            out, tokens, d, d, eps, s);
}

// AIMv2's B6: RMSNorm-2 -> x W' (W' [d, 2f], gate and up interleaved by 8
// columns) -> T(silu(g) u) [tokens, f] -> down + residual, no biases
template <typename T>
int gated_mlp_half(const void* x3, void* out, void* h, const float* rms2,
                   const void* wgu, const void* wdown, int tokens, int d,
                   int f, float eps, cudaStream_t s) {
  int e;
  // 4. RMSNorm-2 -> gate and up -> the gated pair (bf16: the norm into
  //    out, free until step 5)
  if ((e = layer_gemm<T, EPI_SILU_GATE, true>(x3, wgu, nullptr, rms2,
                                              nullptr, out, nullptr, h,
                                              tokens, 2 * f, d, eps, s)))
    return e;
  // 5. down + residual
  return layer_gemm<T, EPI_NO_BIAS>(h, wdown, nullptr, nullptr, nullptr,
                                    nullptr, x3, out, tokens, d, f, eps, s);
}

// B6: LN2 (ln rows 2-3) -> fc1 -> GELU -> fc2 + residual (launches 4-5)
template <typename T, int ACT>
int mlp_half(const void* x3, void* out, void* h, const float* ln,
             const void* wfc1, const void* bfc1, const void* wfc2,
             const void* bfc2, int tokens, int d, int f, float eps,
             cudaStream_t s) {
  int e;
  // 4. LN2 -> fc1 -> GELU (bf16: LN2 into out, free until step 5)
  if ((e = layer_gemm<T, ACT>(x3, wfc1, bfc1, ln + 2 * d, ln + 3 * d, out,
                              nullptr, h, tokens, f, d, eps, s)))
    return e;
  // 5. fc2 + residual
  return layer_gemm<T, ACT_NONE>(h, wfc2, bfc2, nullptr, nullptr, nullptr,
                                 x3, out, tokens, d, f, eps, s);
}

// B6 with its activation picked once, for the whole call
template <typename T>
int mlp_half_act(const void* x3, void* out, void* h, const float* ln,
                 const void* wfc1, const void* bfc1, const void* wfc2,
                 const void* bfc2, int tokens, int d, int f, float eps,
                 int act, cudaStream_t s) {
  if (act == ACT_QUICK_GELU)
    return mlp_half<T, ACT_QUICK_GELU>(x3, out, h, ln, wfc1, bfc1, wfc2,
                                       bfc2, tokens, d, f, eps, s);
  if (act == ACT_GELU_TANH)
    return mlp_half<T, ACT_GELU_TANH>(x3, out, h, ln, wfc1, bfc1, wfc2,
                                      bfc2, tokens, d, f, eps, s);
  return (int)cudaErrorInvalidValue;
}

bool bad_shape(int tokens, int seq, int d, int heads) {
  return tokens <= 0 || seq <= 0 || tokens % seq || heads <= 0 || d % heads;
}

}  // namespace

// AIMv2's B5: rms holds RMSNorm-1's scale [d] (f32); no biases
extern "C" int vqt_rms_attn_half(const void* x, void* out, void* qkv,
                                 void* attn, const void* rms,
                                 const void* wqkv, const void* wout,
                                 int tokens, int seq, int d, int heads,
                                 float eps, int causal, int dtype,
                                 void* stream) {
  if (bad_shape(tokens, seq, d, heads)) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  const float* r = (const float*)rms;
  if (dtype == vqt::DT_BF16)
    return attn_half<bf16, true, false>(x, out, qkv, attn, r, wqkv, nullptr,
                                        wout, nullptr, tokens, seq, d, heads,
                                        eps, causal, dtype, s);
  if (dtype == vqt::DT_F32)
    return attn_half<float, true, false>(x, out, qkv, attn, r, wqkv, nullptr,
                                         wout, nullptr, tokens, seq, d,
                                         heads, eps, causal, dtype, s);
  return (int)cudaErrorInvalidValue;
}

// AIMv2's B6: rms holds RMSNorm-2's scale [d] (f32); wgu [d, 2f] the
// interleaved gate and up matrices, wdown [f, d]; h [tokens, f]
extern "C" int vqt_gated_mlp_half(const void* x3, void* out, void* h,
                                  const void* rms, const void* wgu,
                                  const void* wdown, int tokens, int d,
                                  int f, float eps, int dtype,
                                  void* stream) {
  if (tokens <= 0 || f % 32) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  const float* r = (const float*)rms;
  if (dtype == vqt::DT_BF16)
    return gated_mlp_half<bf16>(x3, out, h, r, wgu, wdown, tokens, d, f, eps,
                                s);
  if (dtype == vqt::DT_F32)
    return gated_mlp_half<float>(x3, out, h, r, wgu, wdown, tokens, d, f,
                                 eps, s);
  return (int)cudaErrorInvalidValue;
}

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

// B6; act: ACT_QUICK_GELU (CLIP) or ACT_GELU_TANH (SigLIP)
extern "C" int vqt_mlp_half(const void* x3, void* out, void* h,
                            const void* ln, const void* wfc1,
                            const void* bfc1, const void* wfc2,
                            const void* bfc2, int tokens, int d, int f,
                            float eps, int act, int dtype, void* stream) {
  if (tokens <= 0) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  const float* lnf = (const float*)ln;
  if (dtype == vqt::DT_BF16)
    return mlp_half_act<bf16>(x3, out, h, lnf, wfc1, bfc1, wfc2, bfc2,
                              tokens, d, f, eps, act, s);
  if (dtype == vqt::DT_F32)
    return mlp_half_act<float>(x3, out, h, lnf, wfc1, bfc1, wfc2, bfc2,
                               tokens, d, f, eps, act, s);
  return (int)cudaErrorInvalidValue;
}

// B2: the whole causal text block = B5 (causal) then B6 with `act`
extern "C" int vqt_text_layer(const void* x, void* out, void* qkv,
                              void* attn, void* x3, void* h, const void* ln,
                              const void* wqkv, const void* bqkv,
                              const void* wout, const void* bout,
                              const void* wfc1, const void* bfc1,
                              const void* wfc2, const void* bfc2, int tokens,
                              int seq, int d, int heads, int f, float eps,
                              int act, int dtype, void* stream) {
  if (act != ACT_QUICK_GELU && act != ACT_GELU_TANH)
    return (int)cudaErrorInvalidValue;
  int e;
  if ((e = vqt_attn_half(x, x3, qkv, attn, ln, wqkv, bqkv, wout, bout,
                         tokens, seq, d, heads, eps, 1, dtype, stream)))
    return e;
  return vqt_mlp_half(x3, out, h, ln, wfc1, bfc1, wfc2, bfc2, tokens, d, f,
                      eps, act, dtype, stream);
}
