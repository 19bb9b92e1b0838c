// Kernel B3: multi-head attention for the CLIP text tower.
//
// Replaces the TPU kernel video_quierer_tpu/ops/attention.py:_fused_attention
// (kernel body _attn_kernel). Same contract: q, k, v are the h-minor
// projections [B, S, H*64]; logits accumulate in f32; keys at position
// >= valid are masked (and keys after the query for causal text); the bf16
// tower uses the clamped unstabilised softmax with its bf16 rounding chain
// (e = bf16(exp(bf16(min(l, 60)))), den = bf16(sum e), w = bf16(e *
// bf16(1 / den))), the f32 tower the stabilised softmax. Rows at s >= valid
// are garbage by contract.
//
// Design: one CTA per (item, head); K and V of that head live in shared
// memory as f32 (row stride 65 so lane-parallel key reads hit distinct
// banks), each warp takes query rows in turn: the lanes own keys for the
// logits, the softmax reduces across the warp, and the lanes own output
// columns for w @ V. S <= 77 at CLIP text lengths, so the [S, S] block is
// never materialised and no online softmax is needed.
//
// Bound on the H100: neither HBM (q, k, v, out are read/written once,
// ~4*B*S*512*2 bytes) nor the tensor cores (the FMAs run on the CUDA
// cores): at serving sizes the launch and the per-row warp reductions
// dominate. The fused text layer (fused_layer.cu) launches the same kernel
// on the strided q/k/v column blocks of its QKV buffer.
#include "common.cuh"

namespace {

using vqt::bf16;
using vqt::from_f;
using vqt::rnd;
using vqt::to_f;

constexpr int HD = 64;     // head dim (every CLIP text tower)
constexpr int KS = HD + 1; // padded shared-memory row stride
constexpr int WARPS = 4;

template <typename T>
__global__ void __launch_bounds__(WARPS * 32)
attn_kernel(const T* __restrict__ q, const T* __restrict__ k,
            const T* __restrict__ v, T* __restrict__ out, int seq,
            int in_stride, int out_stride, int valid, int causal,
            float scale) {
  extern __shared__ float smem[];
  float* ks = smem;                // [seq][KS]
  float* vs = ks + seq * KS;       // [seq][KS]
  float* qs = vs + seq * KS;       // [WARPS][HD]
  float* ps = qs + WARPS * HD;     // [WARPS][seq]
  const bool fast = sizeof(T) == 2;
  const size_t row0 = (size_t)blockIdx.x * seq;
  const int col0 = blockIdx.y * HD;

  for (int i = threadIdx.x; i < seq * HD; i += blockDim.x) {
    const int s = i / HD, d = i % HD;
    const size_t g = (row0 + s) * (size_t)in_stride + col0 + d;
    ks[s * KS + d] = to_f(k[g]);
    vs[s * KS + d] = to_f(v[g]);
  }
  __syncthreads();

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  float* qw = qs + warp * HD;
  float* pw = ps + warp * seq;
  for (int i = warp; i < seq; i += WARPS) {
    const size_t gq = (row0 + i) * (size_t)in_stride + col0;
    qw[lane] = to_f(q[gq + lane]);
    qw[lane + 32] = to_f(q[gq + lane + 32]);
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
      const float l = pw[j];
      const float e = fast ? rnd<bf16>(expf(rnd<bf16>(fminf(l, 60.f))))
                           : expf(l - mx);
      pw[j] = e;
      sum += e;
    }
    sum = vqt::warp_sum(sum);
    __syncwarp();
    const float inv = rnd<T>(1.f / rnd<T>(sum));
    float o0 = 0.f, o1 = 0.f;
    for (int j = 0; j < jn; ++j) {
      const float w = fast ? rnd<bf16>(pw[j] * inv) : pw[j] / sum;
      o0 = fmaf(w, vs[j * KS + lane], o0);
      o1 = fmaf(w, vs[j * KS + lane + 32], o1);
    }
    const size_t go = (row0 + i) * (size_t)out_stride + col0;
    out[go + lane] = from_f<T>(o0);
    out[go + lane + 32] = from_f<T>(o1);
    __syncwarp();
  }
}

template <typename T>
int launch_attn(const void* q, const void* k, const void* v, void* out,
                int batch, int seq, int heads, int in_stride, int out_stride,
                int valid, int causal, float scale, cudaStream_t stream) {
  const size_t smem =
      (size_t)(2 * seq * KS + WARPS * HD + WARPS * seq) * sizeof(float);
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        attn_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  dim3 grid(batch, heads);
  attn_kernel<T><<<grid, WARPS * 32, smem, stream>>>(
      (const T*)q, (const T*)k, (const T*)v, (T*)out, seq, in_stride,
      out_stride, valid, causal, scale);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int vqt_attention(const void* q, const void* k, const void* v,
                             void* out, int batch, int seq, int heads,
                             int head_dim, int in_stride, int out_stride,
                             int valid, int causal, float scale, int dtype,
                             void* stream) {
  if (head_dim != HD || seq <= 0 || batch <= 0 || heads <= 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  if (dtype == vqt::DT_BF16)
    return launch_attn<bf16>(q, k, v, out, batch, seq, heads, in_stride,
                             out_stride, valid, causal, scale, s);
  if (dtype == vqt::DT_F32)
    return launch_attn<float>(q, k, v, out, batch, seq, heads, in_stride,
                              out_stride, valid, causal, scale, s);
  return (int)cudaErrorInvalidValue;
}

extern "C" const char* vqt_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
