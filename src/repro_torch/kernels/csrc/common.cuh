// Helpers shared by the attention kernels: dtype conversion and the warp
// all-reduce. Every kernel keeps its running softmax state in fp32.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cmath>

namespace repro_torch {

// dtype codes passed across the C interface (see kernels/_build.py)
constexpr int kFloat32 = 0;
constexpr int kBFloat16 = 1;

// one warp owns a query row: lane l holds elements l, l + 32, l + 64 and
// l + 96 of the head dimension, so hd <= 128
constexpr int kMaxElems = 4;
// query heads of one GQA group that a warp carries at once; they share
// every K/V line and every mask bit, so one load serves all of them
constexpr int kRows = 4;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

template <typename T>
__device__ __forceinline__ T from_f32(float x);
template <>
__device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

// Online-softmax walk of one warp over key lines [j0, j1) of one KV head.
// q/acc/m/l hold the state of up to kRows query heads (nh live ones);
// base points at line 0 of the head, lines are `stride` elements apart.
// Lines outside [j0, j1) are never read, so dead lines (stale pool
// entries, NaN poison) cannot reach the output.
template <typename T>
__device__ __forceinline__ void walk_keys(
    const T* __restrict__ kbase, const T* __restrict__ vbase, size_t stride,
    int j0, int j1, int hd, int lane, int nh, float scale,
    float (&q)[kRows][kMaxElems], float (&acc)[kRows][kMaxElems],
    float (&m)[kRows], float (&l)[kRows]) {
  for (int j = j0; j < j1; ++j) {
    const T* kr = kbase + (size_t)j * stride;
    const T* vr = vbase + (size_t)j * stride;
    float kv[kMaxElems], vv[kMaxElems];
#pragma unroll
    for (int t = 0; t < kMaxElems; ++t) {
      const int d = lane + 32 * t;
      kv[t] = d < hd ? to_f32(kr[d]) : 0.f;
      vv[t] = d < hd ? to_f32(vr[d]) : 0.f;
    }
    float s[kRows];
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      float part = 0.f;
#pragma unroll
      for (int t = 0; t < kMaxElems; ++t) part = fmaf(q[r][t], kv[t], part);
      s[r] = warp_sum(part) * scale;
    }
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      if (r < nh) {
        const float mn = fmaxf(m[r], s[r]);
        const float alpha = __expf(m[r] - mn);   // 0 on the first line
        const float p = __expf(s[r] - mn);
        l[r] = l[r] * alpha + p;
#pragma unroll
        for (int t = 0; t < kMaxElems; ++t)
          acc[r][t] = fmaf(p, vv[t], acc[r][t] * alpha);
        m[r] = mn;
      }
    }
  }
}

}  // namespace repro_torch

// Text of a CUDA error code, for the Python wrapper's exception.
extern "C" const char* cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
