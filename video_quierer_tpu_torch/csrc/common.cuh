// Shared helpers for the port's CUDA kernels (built for sm_90a into one
// shared library with a plain C interface; see ops/kernels.py).
//
// Every kernel computes in f32 and rounds to the storage type T (float or
// __nv_bfloat16) at the points where the JAX reference rounds, so the bf16
// kernels follow the same rounding chain as the TPU kernels they replace.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <climits>
#include <cmath>
#include <stdint.h>

namespace vqt {

typedef __nv_bfloat16 bf16;

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(bf16 x) { return __bfloat162float(x); }

template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) {
  return x;
}
// round to nearest even, as XLA's f32 -> bf16 convert
template <> __device__ __forceinline__ bf16 from_f<bf16>(float x) {
  return __float2bfloat16_rn(x);
}

// x rounded to T's precision, back in f32
template <typename T> __device__ __forceinline__ float rnd(float x) {
  return to_f(from_f<T>(x));
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

// dtype codes shared with ops/kernels.py
enum { DT_F32 = 0, DT_BF16 = 1, DT_I8 = 2 };

}  // namespace vqt

extern "C" int vqt_attention(const void* q, const void* k, const void* v,
                             void* out, int batch, int seq, int heads,
                             int head_dim, int in_stride, int out_stride,
                             int valid, int causal, float q_scale,
                             float scale, int dtype, void* stream);
