// Ragged chunked-prefill attention for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel _ragged_prefill_kernel /
// ragged_prefill_attention_bhsd (src/repro/kernels/ragged_prefill_attention.py).
//
// Layout (the public layout of the serving path, no transposes):
//   q   [G, S, H, hd]    chunk queries, row g holds take[g] valid tokens at
//                        absolute positions pos0[g] .. pos0[g] + take[g] - 1
//   k,v [G, W, KV, hd]   the row's first W pooled cache lines
//   out [G, S, H, hd]    rows past take[g] (and take[g] == 0 rows) are zeros
// Masks: causal (key <= query position) and, when window > 0, sliding
// (key > query position - window), both at per-row absolute positions.
//
// Design. One block per (q tile, KV head, g): kWarps warps, each owning one
// query position and a chunk of up to kRows query heads of the KV head's
// GQA group. Heads of one position share their key range and mask, so a
// warp loads each K/V line once for all of them and runs their dot-product
// reductions side by side. The TPU kernel's pl.when block skip becomes the
// loop bounds of walk_keys: a row reads exactly the lines
// [max(0, qpos - window + 1), qpos], so dead lines are never loaded. The
// softmax state stays in fp32 registers; lines come through L1/L2, where
// the warps of a block, which read the same KV head, share them.
//
// What bounds it on the H100: the per-line warp reduction (CUDA cores, no
// tensor cores), so it runs far above the bytes bound of the card. Moving
// the QK^T and PV products onto wgmma tiles is later work.
#include "common.cuh"

namespace repro_torch {
namespace {

constexpr int kWarps = 8;

template <typename T>
__global__ void __launch_bounds__(kWarps * 32)
ragged_prefill_kernel(const T* __restrict__ q, const T* __restrict__ k,
                      const T* __restrict__ v, const int* __restrict__ pos0,
                      const int* __restrict__ take, T* __restrict__ out,
                      int S, int H, int KV, int W, int hd, int window,
                      float scale) {
  const int g = blockIdx.z;
  const int kvh = blockIdx.y;
  const int grp = H / KV;
  const int nchunk = (grp + kRows - 1) / kRows;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int task = blockIdx.x * kWarps + warp;   // (position, head chunk)
  if (task >= S * nchunk) return;
  const int i = task / nchunk;
  const int c = task % nchunk;
  const int h0 = kvh * grp + c * kRows;
  const int nh = min(kRows, grp - c * kRows);
  const size_t row0 = ((size_t)g * S + i) * H + h0;   // (g, i, h0) row

  float acc[kRows][kMaxElems], qv[kRows][kMaxElems], m[kRows], l[kRows];
#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    m[r] = -INFINITY;
    l[r] = 0.f;
#pragma unroll
    for (int t = 0; t < kMaxElems; ++t) {
      const int d = lane + 32 * t;
      acc[r][t] = 0.f;
      qv[r][t] = (r < nh && d < hd) ? to_f32(q[(row0 + r) * hd + d]) : 0.f;
    }
  }

  if (i < take[g]) {
    const int qpos = pos0[g] + i;
    const int j0 = window > 0 ? max(0, qpos - window + 1) : 0;
    const int j1 = min(qpos + 1, W);
    const size_t base = ((size_t)g * W * KV + kvh) * hd;
    walk_keys(k + base, v + base, (size_t)KV * hd, j0, j1, hd, lane, nh,
              scale, qv, acc, m, l);
  }

#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    if (r < nh) {
      const float inv = l[r] > 0.f ? 1.f / l[r] : 0.f;   // padded rows -> 0
#pragma unroll
      for (int t = 0; t < kMaxElems; ++t) {
        const int d = lane + 32 * t;
        if (d < hd) out[(row0 + r) * hd + d] = from_f32<T>(acc[r][t] * inv);
      }
    }
  }
}

template <typename T>
cudaError_t launch(const void* q, const void* k, const void* v,
                   const int* pos0, const int* take, void* out, int G, int S,
                   int H, int KV, int W, int hd, int window, float scale,
                   cudaStream_t stream) {
  const int grp = H / KV;
  const int nchunk = (grp + kRows - 1) / kRows;
  const dim3 grid((S * nchunk + kWarps - 1) / kWarps, KV, G);
  ragged_prefill_kernel<T><<<grid, kWarps * 32, 0, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), pos0, take, static_cast<T*>(out), S, H, KV,
      W, hd, window, scale);
  return cudaGetLastError();
}

}  // namespace
}  // namespace repro_torch

// C entry point, bound with ctypes. Returns cudaGetLastError() after the
// launch (0 = cudaSuccess); shapes are validated by the Python wrapper.
extern "C" int ragged_prefill_attention(
    int dtype, const void* q, const void* k, const void* v, const void* pos0,
    const void* take, void* out, int G, int S, int H, int KV, int W, int hd,
    int window, float scale, void* stream) {
  using namespace repro_torch;
  const int* p0 = static_cast<const int*>(pos0);
  const int* tk = static_cast<const int*>(take);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (G == 0 || S == 0) return static_cast<int>(cudaSuccess);
  if (dtype == kBFloat16)
    return static_cast<int>(launch<__nv_bfloat16>(
        q, k, v, p0, tk, out, G, S, H, KV, W, hd, window, scale, st));
  if (dtype == kFloat32)
    return static_cast<int>(launch<float>(q, k, v, p0, tk, out, G, S, H, KV,
                                          W, hd, window, scale, st));
  return static_cast<int>(cudaErrorInvalidValue);
}
