// Kernel B3: multi-head attention for the CLIP, SigLIP and AIMv2 towers.
//
// Replaces the TPU kernel video_quierer_tpu/ops/attention.py:_fused_attention
// (kernel body _attn_kernel). Same contract: q, k, v are the h-minor
// projections [B, S, H*hd] at any row stride, hd 64 or 128 (a compile-time
// instance each); logits accumulate in f32;
// keys at position >= valid are masked (and keys after the query for causal
// text); the bf16 tower uses the clamped unstabilised softmax with its bf16
// rounding chain (e = bf16(exp(bf16(min(l, 60)))), den = bf16(sum e), w =
// bf16(e * bf16(1 / den))), the f32 tower the stabilised softmax. Rows at
// s >= valid are garbage by contract.
//
// bf16 design (attn_bf16): a CTA stages Q and K, then V, of one or more
// (item, head) pairs in shared memory as bf16 with 16-byte cp.async vectors
// in two groups (S padded to a multiple of 16 with zero rows; 144-byte rows,
// so the fragment loads hit distinct banks), so V lands while the logits
// are formed. Each warp owns a 16-row query block: q's pre-scale (when the
// caller asks for it) is applied to its rows in place, Q K^T runs on the
// tensor cores (mma.sync m16n8k16 bf16, f32 accumulators; every product is
// exact, only the order of the sum differs from the plain version), the
// masks and the bf16 softmax chain run on the accumulator fragment (quad
// shuffles for the row sums; e kept as packed bf16 pairs), and the rounded
// weights feed the w @ V mma.sync straight from registers as its A operand
// (V through ldmatrix.trans). The softmax has no max subtraction, so the
// row sum is the only cross-key state: keys go in chunks of 80, a first pass
// sums e over every chunk, a second forms the weights and w @ V (one pass
// when S <= 80, the exps kept in registers). The block's output leaves
// through its own Q rows as 16-byte stores. Where S is short a CTA takes
// several pairs, so each CTA keeps four warps busy; at most 85 registers a
// thread, so the 512 CTAs of a 64-query S = 77 batch fit in one wave.
//
// Bound on the H100: HBM (q, k, v read and the output written once,
// ~4*B*S*H*64*2 bytes) at serving sizes; the products are a small share of
// the bf16 peak's time. What sets the time is latency: one staging round
// trip per CTA and the dependent mma chain of a 16-row block. The f32 branch
// (attn_f32) keeps the CUDA-core kernel: one CTA per (item, head), K and V
// in shared memory as f32, one query row per warp at a time. The fused
// text and vision layers (fused_layer.cu) launch the same kernels on the
// strided q/k/v column blocks of their QKV buffer, with the hd^-0.5 scale
// on the f32 logits instead of on q.
//
// Head width 128 (AIMv2's towers) is the same code at twice the width:
// 272-byte shared rows, twice the k16 steps of Q K^T and the output
// n-tiles of w @ V, so 64 f32 accumulators a thread; one CTA an SM (at S =
// 256, Q, K and V of one pair take 204 KB), up to 255 registers a thread.
// Its f32 branch keeps K in shared memory and reads V rows from global
// memory (one coalesced 512-byte row a key), so S <= 400 still fits.
#include "common.cuh"

namespace {

using vqt::bf16;
using vqt::rnd;

// head widths: CLIP and SigLIP towers 64, AIMv2 towers 128
constexpr int HD64 = 64, HD128 = 128;

// -- f32: CUDA cores ----------------------------------------------------------

constexpr int WARPS = 4;

// V rows in shared memory (hd 64), or read from global memory (hd 128, so
// that K alone fills shared memory)
template <int HD>
__host__ __device__ constexpr bool v_shared() { return HD == HD64; }

template <int HD>
constexpr size_t f32_smem(int seq) {
  return (size_t)((v_shared<HD>() ? 2 : 1) * seq * (HD + 1) + WARPS * HD +
                  WARPS * seq) * sizeof(float);
}

template <int HD>
__global__ void __launch_bounds__(WARPS * 32)
attn_f32(const float* __restrict__ q, const float* __restrict__ k,
         const float* __restrict__ v, float* __restrict__ out, int seq,
         int in_stride, int out_stride, int valid, int causal, float q_scale,
         float scale) {
  constexpr int KS = HD + 1;       // padded shared-memory row stride
  constexpr bool VS = v_shared<HD>();
  extern __shared__ float smem[];
  float* ks = smem;                // [seq][KS]
  float* vs = ks + seq * KS;       // [seq][KS] when VS
  float* qs = vs + (VS ? seq * KS : 0);  // [WARPS][HD]
  float* ps = qs + WARPS * HD;     // [WARPS][seq]
  const size_t row0 = (size_t)blockIdx.x * seq;
  const int col0 = blockIdx.y * HD;

  for (int i = threadIdx.x; i < seq * HD; i += blockDim.x) {
    const int s = i / HD, d = i % HD;
    const size_t g = (row0 + s) * (size_t)in_stride + col0 + d;
    ks[s * KS + d] = k[g];
    if constexpr (VS) vs[s * KS + d] = v[g];
  }
  __syncthreads();

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  float* qw = qs + warp * HD;
  float* pw = ps + warp * seq;
  for (int i = warp; i < seq; i += WARPS) {
    const size_t gq = (row0 + i) * (size_t)in_stride + col0;
#pragma unroll
    for (int u = 0; u < HD / 32; ++u)
      qw[lane + 32 * u] = q[gq + lane + 32 * u] * q_scale;
    __syncwarp();
    // keys [0, jn) are live for this row; the rest contribute e = 0
    int jn = valid < seq ? valid : seq;
    if (causal && i + 1 < jn) jn = i + 1;
    float mx = -INFINITY;
    for (int j = lane; j < jn; j += 32) {
      float acc = 0.f;
#pragma unroll 16
      for (int d = 0; d < HD; ++d) acc = fmaf(qw[d], ks[j * KS + d], acc);
      const float l = acc * scale;
      pw[j] = l;
      mx = fmaxf(mx, l);
    }
    mx = vqt::warp_max(mx);
    float sum = 0.f;
    for (int j = lane; j < jn; j += 32) {
      const float e = expf(pw[j] - mx);
      pw[j] = e;
      sum += e;
    }
    sum = vqt::warp_sum(sum);
    __syncwarp();
    float o[HD / 32];
#pragma unroll
    for (int u = 0; u < HD / 32; ++u) o[u] = 0.f;
    for (int j = 0; j < jn; ++j) {
      const float w = pw[j] / sum;
#pragma unroll
      for (int u = 0; u < HD / 32; ++u)
        o[u] = fmaf(w,
                    VS ? vs[j * KS + lane + 32 * u]
                       : v[(row0 + j) * (size_t)in_stride + col0 + lane +
                           32 * u],
                    o[u]);
    }
    const size_t go = (row0 + i) * (size_t)out_stride + col0;
#pragma unroll
    for (int u = 0; u < HD / 32; ++u) out[go + lane + 32 * u] = o[u];
    __syncwarp();
  }
}

template <int HD>
int launch_f32(const void* q, const void* k, const void* v, void* out,
               int batch, int seq, int heads, int in_stride, int out_stride,
               int valid, int causal, float q_scale, float scale,
               cudaStream_t stream) {
  const size_t smem = f32_smem<HD>(seq);
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        attn_f32<HD>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  dim3 grid(batch, heads);
  attn_f32<HD><<<grid, WARPS * 32, smem, stream>>>(
      (const float*)q, (const float*)k, (const float*)v, (float*)out, seq,
      in_stride, out_stride, valid, causal, q_scale, scale);
  return (int)cudaGetLastError();
}

// -- bf16: tensor cores -------------------------------------------------------

constexpr int MAX_WARPS = 8;
constexpr int KC = 80;             // keys per chunk (10 n-tiles of 8)

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

__device__ __forceinline__ uint32_t ld32(const bf16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

// two f32 values rounded to bf16, the first in the low half
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// a packed pair of bf16 values times f32 `inv`, rounded back to bf16 (the
// softmax weights bf16(e * inv); q times its pre-scale)
__device__ __forceinline__ uint32_t weights(uint32_t e, float inv) {
  const float2 f =
      __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&e));
  return pack_bf16(f.x * inv, f.y * inv);
}

// c += a @ b on one m16n8k16 tile (bf16 in, f32 accumulate)
__device__ __forceinline__ void mma16816(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// bf16 row stride in shared memory (144 B at hd 64, 272 B at hd 128)
template <int HD>
__host__ __device__ constexpr int lds() { return HD + 8; }

// hd 64: min 3 CTAs of 8 warps an SM, at most 85 registers a thread; hd
// 128: one CTA an SM (shared memory bounds it anyway)
template <int HD>
__host__ __device__ constexpr int min_ctas() { return HD == HD64 ? 3 : 1; }

template <int HD>
__global__ void __launch_bounds__(MAX_WARPS * 32, min_ctas<HD>())
attn_bf16(const bf16* __restrict__ q, const bf16* __restrict__ k,
          const bf16* __restrict__ v, bf16* __restrict__ out, int pairs,
          int heads, int seq, int spad, int per_cta, int in_stride,
          int out_stride, int valid, int causal, float q_scale,
          float scale) {
  constexpr int LDS = lds<HD>();
  constexpr int VPR = HD / 8;      // 16-byte vectors a row
  extern __shared__ __align__(16) bf16 sm[];
  const int tile = spad * LDS;     // one operand of one pair
  const int p0 = blockIdx.x * per_cta;
  const int np = min(per_cta, pairs - p0);

  // stage Q, K (group 0) and V (group 1) of the CTA's pairs: VPR x 16 B a
  // row, pad rows zero
  const int c8 = threadIdx.x % VPR;
  auto stage = [&](int which) {
    const bf16* src0 = which == 0 ? q : which == 1 ? k : v;
    for (int j = 0; j < np; ++j) {
      const int p = p0 + j;
      const bf16* src = src0 + (size_t)(p / heads) * seq * in_stride +
                        (p % heads) * HD + c8 * 8;
      bf16* dst = sm + (3 * j + which) * tile + c8 * 8;
      for (int r = threadIdx.x / VPR; r < spad; r += blockDim.x / VPR) {
        if (r < seq)
          asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(
                           smem_addr(dst + r * LDS)),
                       "l"(src + (size_t)r * in_stride));
        else
          *reinterpret_cast<uint4*>(dst + r * LDS) = make_uint4(0, 0, 0, 0);
      }
    }
  };
  stage(0);
  stage(1);
  asm volatile("cp.async.commit_group;\n" ::: "memory");
  stage(2);
  asm volatile("cp.async.commit_group;\n" ::: "memory");

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, t = lane % 4;
  const int qblocks = spad / 16, nw = blockDim.x / 32;
  const int ntasks = np * qblocks, iters = (ntasks + nw - 1) / nw;
  for (int it = 0; it < iters; ++it) {
    const int task = it * nw + warp;
    const bool active = task < ntasks;
    const int j = active ? task / qblocks : 0, qb = task % qblocks;
    bf16* qs = sm + 3 * j * tile;
    const bf16* ks = qs + tile;
    const bf16* vs = ks + tile;
    const int r0 = qb * 16 + g, r1 = r0 + 8;
    // keys [0, kend) can be live for some row of the block
    int kend = min(valid, seq);
    if (causal) kend = min(kend, qb * 16 + 16);
    const int nch = (kend + KC - 1) / KC;
    if (it == 0) {  // Q and K have landed
      asm volatile("cp.async.wait_group 1;\n" ::: "memory");
      __syncthreads();
    }
    // e of keys [kc, kc + KC), rounded to bf16 and packed in pairs: ep[n][0]
    // row r0, ep[n][1] row r1; s0, s1 the rows' running sums
    uint32_t ep[KC / 8][2];
    float s0 = 0.f, s1 = 0.f;
    auto exps = [&](int kc, bool sum) {
#pragma unroll
      for (int n = 0; n < KC / 8; ++n) {
        const int n0 = kc + 8 * n;
        float c[4] = {0.f, 0.f, 0.f, 0.f};
        if (n0 < kend) {
#pragma unroll
          for (int kk = 0; kk < HD / 16; ++kk) {
            const bf16* qk = qs + kk * 16 + 2 * t;
            const uint32_t a[4] = {ld32(qk + r0 * LDS), ld32(qk + r1 * LDS),
                                   ld32(qk + r0 * LDS + 8),
                                   ld32(qk + r1 * LDS + 8)};
            const bf16* kr = ks + (n0 + g) * LDS + kk * 16 + 2 * t;
            mma16816(c, a, ld32(kr), ld32(kr + 8));
          }
        }
        float e[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int key = n0 + 2 * t + (i & 1), row = i < 2 ? r0 : r1;
          const bool live = key < kend && (!causal || key <= row);
          e[i] = live ? rnd<bf16>(expf(rnd<bf16>(fminf(c[i] * scale, 60.f))))
                      : 0.f;
        }
        ep[n][0] = pack_bf16(e[0], e[1]);  // exact: already bf16
        ep[n][1] = pack_bf16(e[2], e[3]);
        if (sum) {
          s0 += e[0] + e[1];
          s1 += e[2] + e[3];
        }
      }
    };

    if (active) {
      // the block's Q rows times q_scale, rounded to bf16 (the wrapper's
      // pre-scale), in place: only this warp reads them
      if (q_scale != 1.f) {
#pragma unroll
        for (int i = 0; i < HD / 16; ++i) {
          const int idx = lane + 32 * i;
          uint4* vec =
              reinterpret_cast<uint4*>(qs + (qb * 16 + idx / VPR) * LDS) +
              idx % VPR;
          uint4 w = *vec;
          uint32_t* h = reinterpret_cast<uint32_t*>(&w);
#pragma unroll
          for (int u = 0; u < 4; ++u) h[u] = weights(h[u], q_scale);
          *vec = w;
        }
        __syncwarp();
      }
      for (int ch = 0; ch < nch; ++ch) exps(ch * KC, true);
      s0 += __shfl_xor_sync(0xffffffffu, s0, 1);
      s0 += __shfl_xor_sync(0xffffffffu, s0, 2);
      s1 += __shfl_xor_sync(0xffffffffu, s1, 1);
      s1 += __shfl_xor_sync(0xffffffffu, s1, 2);
    }
    if (it == 0) {  // V has landed
      asm volatile("cp.async.wait_group 0;\n" ::: "memory");
      __syncthreads();
    }
    if (!active) continue;
    const float inv0 = rnd<bf16>(1.f / rnd<bf16>(s0));
    const float inv1 = rnd<bf16>(1.f / rnd<bf16>(s1));

    float o[HD / 8][4];
#pragma unroll
    for (int n = 0; n < HD / 8; ++n)
      o[n][0] = o[n][1] = o[n][2] = o[n][3] = 0.f;
    for (int ch = 0; ch < nch; ++ch) {
      if (nch > 1) exps(ch * KC, false);
#pragma unroll
      for (int ks16 = 0; ks16 < KC / 16; ++ks16) {
        const int kb = ch * KC + ks16 * 16;
        if (kb < kend) {
          // the weights of 16 keys: the A fragment of w @ V
          const uint32_t a[4] = {weights(ep[2 * ks16][0], inv0),
                                 weights(ep[2 * ks16][1], inv1),
                                 weights(ep[2 * ks16 + 1][0], inv0),
                                 weights(ep[2 * ks16 + 1][1], inv1)};
          const int mi = lane / 8;
          const bf16* vrow =
              vs + (kb + (mi & 1) * 8 + lane % 8) * LDS + (mi >> 1) * 8;
#pragma unroll
          for (int dp = 0; dp < HD / 16; ++dp) {
            uint32_t b0, b1, b2, b3;
            asm volatile(
                "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 "
                "{%0, %1, %2, %3}, [%4];\n"
                : "=r"(b0), "=r"(b1), "=r"(b2), "=r"(b3)
                : "r"(smem_addr(vrow + dp * 16)));
            mma16816(o[2 * dp], a, b0, b1);
            mma16816(o[2 * dp + 1], a, b2, b3);
          }
        }
      }
    }
    // the block's 16 output rows through its own (consumed) Q rows, then
    // out as 16-byte vectors
    __syncwarp();
#pragma unroll
    for (int n = 0; n < HD / 8; ++n) {
      *reinterpret_cast<uint32_t*>(qs + r0 * LDS + 8 * n + 2 * t) =
          pack_bf16(o[n][0], o[n][1]);
      *reinterpret_cast<uint32_t*>(qs + r1 * LDS + 8 * n + 2 * t) =
          pack_bf16(o[n][2], o[n][3]);
    }
    __syncwarp();
    const int p = p0 + j;
    bf16* dst = out + (size_t)(p / heads) * seq * out_stride + (p % heads) * HD;
#pragma unroll
    for (int i = 0; i < HD / 16; ++i) {
      const int idx = lane + 32 * i, r = qb * 16 + idx / VPR, c = idx % VPR;
      if (r < seq)
        *reinterpret_cast<uint4*>(dst + (size_t)r * out_stride + c * 8) =
            *reinterpret_cast<const uint4*>(qs + r * LDS + c * 8);
    }
  }
}

template <int HD>
int launch_bf16(const void* q, const void* k, const void* v, void* out,
                int batch, int seq, int heads, int in_stride, int out_stride,
                int valid, int causal, float q_scale, float scale,
                cudaStream_t stream) {
  // 16-byte cp.async rows and 16-byte output rows
  if ((((uintptr_t)q | (uintptr_t)k | (uintptr_t)v | (uintptr_t)out) & 15) ||
      in_stride % 8 || out_stride % 8)
    return (int)cudaErrorInvalidValue;
  const int spad = (seq + 15) / 16 * 16, qblocks = spad / 16;
  // short sequences: several pairs a CTA, so each keeps four warps busy
  const int per_cta = qblocks >= 4 ? 1 : 4 / qblocks;
  const int warps =
      per_cta * qblocks < MAX_WARPS ? per_cta * qblocks : MAX_WARPS;
  const int pairs = batch * heads;
  const size_t smem =
      (size_t)per_cta * 3 * spad * lds<HD>() * sizeof(bf16);
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        attn_bf16<HD>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  attn_bf16<HD><<<(pairs + per_cta - 1) / per_cta, warps * 32, smem,
                  stream>>>(
      (const bf16*)q, (const bf16*)k, (const bf16*)v, (bf16*)out, pairs, heads,
      seq, spad, per_cta, in_stride, out_stride, valid, causal, q_scale,
      scale);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int vqt_attention(const void* q, const void* k, const void* v,
                             void* out, int batch, int seq, int heads,
                             int head_dim, int in_stride, int out_stride,
                             int valid, int causal, float q_scale,
                             float scale, int dtype, void* stream) {
  if ((head_dim != HD64 && head_dim != HD128) || seq <= 0 || batch <= 0 ||
      heads <= 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  const bool wide = head_dim == HD128;
  if (dtype == vqt::DT_BF16)
    return (wide ? launch_bf16<HD128> : launch_bf16<HD64>)(
        q, k, v, out, batch, seq, heads, in_stride, out_stride, valid,
        causal, q_scale, scale, s);
  if (dtype == vqt::DT_F32)
    return (wide ? launch_f32<HD128> : launch_f32<HD64>)(
        q, k, v, out, batch, seq, heads, in_stride, out_stride, valid,
        causal, q_scale, scale, s);
  return (int)cudaErrorInvalidValue;
}

extern "C" const char* vqt_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
