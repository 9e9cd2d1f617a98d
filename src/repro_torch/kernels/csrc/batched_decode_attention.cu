// Batched decode attention for Hopper (sm_90a): one query token per serving
// slot over the slot-pooled cache, every slot and head in one launch.
//
// Replaces the Pallas TPU kernel _batched_decode_kernel /
// batched_decode_attention_bhmd (src/repro/kernels/batched_decode_attention.py).
//
// Layout (the public layout of the serving path, no transposes):
//   q   [B, 1, H, hd]    one query per slot
//   k,v [B, M, KV, hd]   the slot pool's cache lines
//   kv_len [B]           valid lines per slot; 0 gives exact zeros
//   out [B, 1, H, hd]
// Mask: key < kv_len[b] and, when window > 0, key >= kv_len[b] - window.
//
// Design. One block per (slot, KV head) covers the whole GQA group: warp w
// carries head chunk w % nchunk (up to kRows heads, which share every line)
// and walks split w / nchunk of the valid line range, so a long cache is
// read by several warps at once. The TPU kernel's pl.when block skip
// becomes the walk's bounds: lines past kv_len (and below the window) are
// never read. The splits are combined in shared memory with the usual
// max-rescaled sum; a split that saw no line carries l = 0 and drops out.
//
// What bounds it on the H100: one token per slot does 4 flops per cache
// element it reads, so the bytes of the cache bound the ideal kernel; this
// one does its dot products with warp reductions on CUDA cores and stays
// latency-bound on the serial line walk of each warp.
#include "common.cuh"

namespace repro_torch {
namespace {

constexpr int kMaxWarps = 16;

template <typename T>
__global__ void __launch_bounds__(kMaxWarps * 32)
batched_decode_kernel(const T* __restrict__ q, const T* __restrict__ k,
                      const T* __restrict__ v, const int* __restrict__ kv_len,
                      T* __restrict__ out, int H, int KV, int M, int hd,
                      int window, float scale, int nsplit) {
  __shared__ float part_acc[kMaxWarps][kRows][kMaxElems * 32];
  __shared__ float part_m[kMaxWarps][kRows];
  __shared__ float part_l[kMaxWarps][kRows];

  const int b = blockIdx.x;
  const int kvh = blockIdx.y;
  const int grp = H / KV;
  const int nchunk = (grp + kRows - 1) / kRows;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int c = warp % nchunk;
  const int split = warp / nchunk;
  const int h0 = kvh * grp + c * kRows;
  const int nh = min(kRows, grp - c * kRows);
  const size_t row0 = (size_t)b * H + h0;   // (b, h0) query row

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

  const int len = min(kv_len[b], M);
  const int lo = window > 0 ? max(0, len - window) : 0;
  const int per = (max(len - lo, 0) + nsplit - 1) / nsplit;
  const int j0 = lo + split * per;
  const int j1 = min(len, j0 + per);
  const size_t base = ((size_t)b * M * KV + kvh) * hd;
  walk_keys(k + base, v + base, (size_t)KV * hd, j0, j1, hd, lane, nh, scale,
            qv, acc, m, l);

#pragma unroll
  for (int r = 0; r < kRows; ++r) {
#pragma unroll
    for (int t = 0; t < kMaxElems; ++t)
      part_acc[warp][r][lane + 32 * t] = acc[r][t];
    if (lane == 0) {
      part_m[warp][r] = m[r];
      part_l[warp][r] = l[r];
    }
  }
  __syncthreads();
  if (split != 0) return;

  // warp c (split 0) combines the nsplit partials of its head chunk
#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    if (r >= nh) continue;
    float mx = -INFINITY;
    for (int s = 0; s < nsplit; ++s) {
      const int w = s * nchunk + c;
      if (part_l[w][r] > 0.f) mx = fmaxf(mx, part_m[w][r]);
    }
    float tot = 0.f;
    float o[kMaxElems] = {0.f, 0.f, 0.f, 0.f};
    for (int s = 0; s < nsplit; ++s) {
      const int w = s * nchunk + c;
      if (part_l[w][r] > 0.f) {
        const float f = __expf(part_m[w][r] - mx);
        tot += part_l[w][r] * f;
#pragma unroll
        for (int t = 0; t < kMaxElems; ++t)
          o[t] = fmaf(part_acc[w][r][lane + 32 * t], f, o[t]);
      }
    }
    const float inv = tot > 0.f ? 1.f / tot : 0.f;   // kv_len == 0 -> zeros
#pragma unroll
    for (int t = 0; t < kMaxElems; ++t) {
      const int d = lane + 32 * t;
      if (d < hd) out[(row0 + r) * hd + d] = from_f32<T>(o[t] * inv);
    }
  }
}

template <typename T>
cudaError_t launch(const void* q, const void* k, const void* v,
                   const int* kv_len, void* out, int B, int H, int KV, int M,
                   int hd, int window, float scale, cudaStream_t stream) {
  const int grp = H / KV;
  const int nchunk = (grp + kRows - 1) / kRows;
  if (nchunk > kMaxWarps) return cudaErrorInvalidConfiguration;
  const int nsplit = kMaxWarps / nchunk;
  const dim3 grid(B, KV);
  batched_decode_kernel<T><<<grid, nchunk * nsplit * 32, 0, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), kv_len, static_cast<T*>(out), H, KV, M, hd,
      window, scale, nsplit);
  return cudaGetLastError();
}

}  // namespace
}  // namespace repro_torch

// C entry point, bound with ctypes. Returns cudaGetLastError() after the
// launch (0 = cudaSuccess); shapes are validated by the Python wrapper.
extern "C" int batched_decode_attention(int dtype, const void* q,
                                        const void* k, const void* v,
                                        const void* kv_len, void* out, int B,
                                        int H, int KV, int M, int hd,
                                        int window, float scale,
                                        void* stream) {
  using namespace repro_torch;
  const int* kl = static_cast<const int*>(kv_len);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (B == 0) return static_cast<int>(cudaSuccess);
  if (dtype == kBFloat16)
    return static_cast<int>(launch<__nv_bfloat16>(q, k, v, kl, out, B, H, KV,
                                                  M, hd, window, scale, st));
  if (dtype == kFloat32)
    return static_cast<int>(
        launch<float>(q, k, v, kl, out, B, H, KV, M, hd, window, scale, st));
  return static_cast<int>(cudaErrorInvalidValue);
}
