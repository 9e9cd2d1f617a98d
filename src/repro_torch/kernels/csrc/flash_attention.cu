// Full-sequence attention (flash attention) for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel _flash_kernel / flash_attention_bhsd
// (src/repro/kernels/flash_attention.py).
//
// Layout (the port's public layout, no transposes):
//   q   [B, Sq, H, hd]   query position i sits at absolute position
//                        i + q_offset
//   k,v [B, Sk, KV, hd]  query head h reads KV head h / (H / KV)
//   out [B, Sq, H, hd]   a row with no admitted key is exact zeros
// Mask: key < Sk; key <= qpos when causal; key > qpos - window when
// window > 0.
//
// Design. One block per (q tile, KV head, batch). The block's 64 score
// rows are npos query positions times the GQA group's G heads (row r is
// position q0 + r / G, head r % G), so every K/V line a block stages in
// shared memory serves the whole group. The causal and window bounds of
// the tile's first and last position become the range of K tiles of 64
// lines the block walks: a K tile outside every row's mask is never
// read. Per K tile: scores, the online-softmax update in fp32 (row max
// and sum reduced across the threads that share a row), then P V. Heavy
// q tiles (late positions, most K tiles under the causal mask) are
// scheduled first. Two kernels share that tiling:
//   * bf16 (the serving path): the products on the tensor cores with
//     mma.sync m16n8k16 and fp32 accumulators, P rounded to bf16;
//   * fp32 (the reduced models the tests and the card-vs-CPU check use):
//     fp32 FMAs on the CUDA cores, every product in fp32.
//
// What bounds it on the H100: the ideal kernel at the serving shapes is
// bound by the bytes of q, k, v and out. The bf16 kernel loads each K/V
// tile synchronously and waits on it, so load latency and the serial
// walk of the late q tiles, not bytes or tensor-core rate, bound it;
// TMA loads in a pipeline with wgmma are the next step.
#include <climits>
#include <cstdint>

#include "common.cuh"

namespace repro_torch {
namespace {

constexpr int kThreads = 256;
constexpr int kRowsPerBlock = 64;   // score rows: positions x group heads
constexpr int kKeys = 64;           // K/V lines per tile
constexpr int kMaxHd = 128;
constexpr int kPsStride = kRowsPerBlock + 4;   // padded: conflict-free stores

struct Smem {
  float q[kMaxHd][kRowsPerBlock];   // q[d][row], pre-scaled
  float k[kMaxHd][kKeys];           // k[d][line]
  float v[kKeys][kMaxHd];           // v[line][d]
  float p[kKeys][kPsStride];        // p[line][row]
};

__device__ __forceinline__ void load4(const float* src, float (&x)[4]) {
#pragma unroll
  for (int c = 0; c < 4; ++c) x[c] = src[c];
}

// fp32: 256 threads each own a 4x4 patch of the 64x64 score tile (rows
// 4ty..4ty+3, keys tx + 16c) and a 4x8 patch of the 64 x hd output (the
// same rows); Q (pre-scaled, transposed), K (transposed), V and P pass
// through shared memory.
__global__ void __launch_bounds__(kThreads, 2)
flash_kernel_simt(const float* __restrict__ q, const float* __restrict__ k,
                  const float* __restrict__ v, float* __restrict__ out,
                  int Sq, int Sk, int H, int KV, int hd, int causal,
                  int window, int q_offset, float scale) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  Smem& sm = *reinterpret_cast<Smem*>(smem_raw);

  const int G = H / KV;
  const int npos = kRowsPerBlock / G;           // positions per q tile
  const int nrows = npos * G;                   // live score rows
  const int tile = gridDim.x - 1 - blockIdx.x;  // heavy tiles first
  const int kvh = blockIdx.y;
  const int b = blockIdx.z;
  const int q0 = tile * npos;
  const int q_last = min(q0 + npos, Sq) - 1;
  const int tid = threadIdx.x;
  const int ty = tid >> 4;                      // row group: rows 4ty..4ty+3
  const int tx = tid & 15;
  const int hd4 = hd / 4;

  // the K lines any row of this tile may read
  const int k_lo = window > 0 ? max(0, q0 + q_offset - window + 1) : 0;
  const int k_hi = causal ? min(Sk, q_last + q_offset + 1) : Sk;

  // stage the tile's query rows, transposed and pre-scaled
  for (int idx = tid; idx < kRowsPerBlock * hd4; idx += kThreads) {
    const int r = idx % kRowsPerBlock;
    const int d = (idx / kRowsPerBlock) * 4;
    const int pos = q0 + r / G;
    float x[4] = {0.f, 0.f, 0.f, 0.f};
    if (r < nrows && pos < Sq)
      load4(q + (((size_t)b * Sq + pos) * H + kvh * G + r % G) * hd + d, x);
#pragma unroll
    for (int c = 0; c < 4; ++c) sm.q[d + c][r] = x[c] * scale;
  }

  // absolute query position of each of this thread's 4 rows; INT_MIN
  // marks a padding row (admits no key)
  int qpos[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = ty * 4 + i;
    const int pos = q0 + r / G;
    qpos[i] = (r < nrows && pos < Sq) ? pos + q_offset : INT_MIN;
  }

  float o[4][8], m[4], l[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = -INFINITY;
    l[i] = 0.f;
#pragma unroll
    for (int j = 0; j < 8; ++j) o[i][j] = 0.f;
  }

  const size_t kv_row = (size_t)KV * hd;   // elements between lines
  const float* kb = k + (size_t)b * Sk * kv_row + (size_t)kvh * hd;
  const float* vb = v + (size_t)b * Sk * kv_row + (size_t)kvh * hd;

  for (int kt = k_lo; kt < k_hi; kt += kKeys) {
    const int n_lines = min(kKeys, k_hi - kt);
    __syncthreads();   // the previous tile's readers are done
    // K transposed (consecutive threads: consecutive lines, so the
    // shared-memory stores do not conflict); lines past the range -> 0
    for (int idx = tid; idx < kKeys * hd4; idx += kThreads) {
      const int j = idx % kKeys;
      const int d = (idx / kKeys) * 4;
      float x[4] = {0.f, 0.f, 0.f, 0.f};
      if (j < n_lines) load4(kb + (size_t)(kt + j) * kv_row + d, x);
#pragma unroll
      for (int c = 0; c < 4; ++c) sm.k[d + c][j] = x[c];
    }
    // V row-major (coalesced)
    for (int idx = tid; idx < kKeys * hd4; idx += kThreads) {
      const int j = idx / hd4;
      const int d = (idx % hd4) * 4;
      float x[4] = {0.f, 0.f, 0.f, 0.f};
      if (j < n_lines) load4(vb + (size_t)(kt + j) * kv_row + d, x);
      *reinterpret_cast<float4*>(&sm.v[j][d]) =
          make_float4(x[0], x[1], x[2], x[3]);
    }
    __syncthreads();

    // scores of rows 4ty+i against lines tx + 16c
    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int c = 0; c < 4; ++c) s[i][c] = 0.f;
#pragma unroll 4
    for (int d = 0; d < hd; ++d) {
      const float4 qv = *reinterpret_cast<const float4*>(&sm.q[d][ty * 4]);
      float kv[4];
#pragma unroll
      for (int c = 0; c < 4; ++c) kv[c] = sm.k[d][tx + 16 * c];
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        s[0][c] = fmaf(qv.x, kv[c], s[0][c]);
        s[1][c] = fmaf(qv.y, kv[c], s[1][c]);
        s[2][c] = fmaf(qv.z, kv[c], s[2][c]);
        s[3][c] = fmaf(qv.w, kv[c], s[3][c]);
      }
    }

    // mask, then the online-softmax update of each row
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      float mx = -INFINITY;
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int j = tx + 16 * c;
        const int kpos = kt + j;
        const bool ok = j < n_lines && qpos[i] != INT_MIN &&
                        (!causal || kpos <= qpos[i]) &&
                        (window <= 0 || kpos > qpos[i] - window);
        s[i][c] = ok ? s[i][c] : -INFINITY;
        mx = fmaxf(mx, s[i][c]);
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_new = fmaxf(m[i], mx);
      // a row with no admitted key so far keeps p = 0 and alpha = 0
      const float m_use = m_new == -INFINITY ? 0.f : m_new;
      const float alpha = __expf(m[i] - m_use);
      float sum = 0.f;
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        s[i][c] = __expf(s[i][c] - m_use);   // exp(-inf) = 0
        sum += s[i][c];
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        sum += __shfl_xor_sync(0xffffffffu, sum, off);
      l[i] = l[i] * alpha + sum;
      m[i] = m_new;
#pragma unroll
      for (int j = 0; j < 8; ++j) o[i][j] *= alpha;
    }
#pragma unroll
    for (int c = 0; c < 4; ++c)
      *reinterpret_cast<float4*>(&sm.p[tx + 16 * c][ty * 4]) =
          make_float4(s[0][c], s[1][c], s[2][c], s[3][c]);
    __syncthreads();

    // o[rows 4ty..4ty+3][cols 4tx..4tx+3, 64+4tx..64+4tx+3] += P V
#pragma unroll 4
    for (int j = 0; j < n_lines; ++j) {
      const float4 p = *reinterpret_cast<const float4*>(&sm.p[j][ty * 4]);
      const float4 v0 = *reinterpret_cast<const float4*>(&sm.v[j][tx * 4]);
      const float4 v1 =
          *reinterpret_cast<const float4*>(&sm.v[j][64 + tx * 4]);
      const float pr[4] = {p.x, p.y, p.z, p.w};
      const float vv[8] = {v0.x, v0.y, v0.z, v0.w, v1.x, v1.y, v1.z, v1.w};
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int c = 0; c < 8; ++c) o[i][c] = fmaf(pr[i], vv[c], o[i][c]);
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    if (qpos[i] == INT_MIN) continue;
    const int r = ty * 4 + i;
    const int pos = q0 + r / G;
    const float inv = l[i] > 0.f ? 1.f / l[i] : 0.f;   // no key -> zeros
    float* dst = out + (((size_t)b * Sq + pos) * H + kvh * G + r % G) * hd;
#pragma unroll
    for (int t = 0; t < 2; ++t) {
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int d = 64 * t + 4 * tx + c;
        if (d < hd) dst[d] = o[i][4 * t + c] * inv;
      }
    }
  }
}

// ---------------------------------------------------------------------------
// bf16: the same tiling on the tensor cores (mma.sync m16n8k16, fp32
// accumulators). Four warps own 16 score rows each; a thread holds rows
// g and g + 8 of its warp (g = lane / 4) and, per 8-key group, keys
// 2t and 2t + 1 (t = lane % 4), the mma accumulator layout. Q stays in
// registers as A fragments for the whole walk; K comes from shared memory
// as B fragments (a key's head-dim pairs are contiguous); the scores turn
// into bf16 A fragments of P in registers, and V's B fragments come from
// shared memory through ldmatrix.trans. Rows of shared memory are padded
// to 136 elements, so both reads are free of bank conflicts.
// ---------------------------------------------------------------------------

constexpr int kMmaWarps = 4;
constexpr int kMmaThreads = kMmaWarps * 32;
constexpr int kPad = kMaxHd + 8;   // bf16 elements per shared-memory row

__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

__global__ void __launch_bounds__(kMmaThreads)
flash_kernel_mma(const __nv_bfloat16* __restrict__ q,
                 const __nv_bfloat16* __restrict__ k,
                 const __nv_bfloat16* __restrict__ v,
                 __nv_bfloat16* __restrict__ out, int Sq, int Sk, int H,
                 int KV, int hd, int causal, int window, int q_offset,
                 float scale) {
  __shared__ __align__(16) __nv_bfloat16 ks[kKeys][kPad];
  __shared__ __align__(16) __nv_bfloat16 vs[kKeys][kPad];

  const int G = H / KV;
  const int npos = kRowsPerBlock / G;
  const int nrows = npos * G;
  const int tile = gridDim.x - 1 - blockIdx.x;   // heavy tiles first
  const int kvh = blockIdx.y;
  const int b = blockIdx.z;
  const int q0 = tile * npos;
  const int q_last = min(q0 + npos, Sq) - 1;
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int g = lane >> 2;
  const int t = lane & 3;
  const int k_lo = window > 0 ? max(0, q0 + q_offset - window + 1) : 0;
  const int k_hi = causal ? min(Sk, q_last + q_offset + 1) : Sk;
  // scores in log2 units: exp(x * scale) = exp2(x * scale * log2(e))
  const float sl2 = scale * 1.4426950408889634f;

  // this thread's two rows: absolute query position (INT_MIN: padding)
  // and the A fragments of their query vectors
  int qpos[2];
  uint32_t qf[kMaxHd / 16][4];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int r = warp * 16 + g + 8 * h;
    const int pos = q0 + r / G;
    const bool live = r < nrows && pos < Sq;
    qpos[h] = live ? pos + q_offset : INT_MIN;
    const __nv_bfloat16* qr =
        q + (((size_t)b * Sq + (live ? pos : 0)) * H + kvh * G + r % G) * hd;
#pragma unroll
    for (int kk = 0; kk < kMaxHd / 16; ++kk) {
      uint32_t lo = 0, hi = 0;
      if (live && kk * 16 < hd) {
        lo = *reinterpret_cast<const uint32_t*>(qr + 16 * kk + 2 * t);
        hi = *reinterpret_cast<const uint32_t*>(qr + 16 * kk + 8 + 2 * t);
      }
      qf[kk][h] = lo;        // a0 (row g), a1 (row g + 8)
      qf[kk][2 + h] = hi;    // a2, a3: head-dim columns + 8
    }
  }

  float o[kMaxHd / 8][4];
#pragma unroll
  for (int nd = 0; nd < kMaxHd / 8; ++nd)
#pragma unroll
    for (int c = 0; c < 4; ++c) o[nd][c] = 0.f;
  float m[2] = {-INFINITY, -INFINITY};   // running max, log2 units
  float l[2] = {0.f, 0.f};               // this thread's share of the sum

  const size_t kv_row = (size_t)KV * hd;
  const __nv_bfloat16* kb = k + (size_t)b * Sk * kv_row + (size_t)kvh * hd;
  const __nv_bfloat16* vb = v + (size_t)b * Sk * kv_row + (size_t)kvh * hd;
  const int chunks = hd / 8;             // 16-byte chunks per line

  for (int kt = k_lo; kt < k_hi; kt += kKeys) {
    const int n_lines = min(kKeys, k_hi - kt);
    __syncthreads();
    for (int idx = tid; idx < kKeys * chunks; idx += kMmaThreads) {
      const int j = idx / chunks;
      const int d = (idx % chunks) * 8;
      uint4 kx = make_uint4(0, 0, 0, 0), vx = make_uint4(0, 0, 0, 0);
      if (j < n_lines) {
        kx = *reinterpret_cast<const uint4*>(kb + (size_t)(kt + j) * kv_row + d);
        vx = *reinterpret_cast<const uint4*>(vb + (size_t)(kt + j) * kv_row + d);
      }
      *reinterpret_cast<uint4*>(&ks[j][d]) = kx;
      *reinterpret_cast<uint4*>(&vs[j][d]) = vx;
    }
    __syncthreads();

    // S = Q K^T for the warp's 16 rows x 64 keys
    float s[kKeys / 8][4];
#pragma unroll
    for (int nt = 0; nt < kKeys / 8; ++nt) {
#pragma unroll
      for (int c = 0; c < 4; ++c) s[nt][c] = 0.f;
#pragma unroll
      for (int kk = 0; kk < kMaxHd / 16; ++kk) {
        if (kk * 16 < hd) {
          const __nv_bfloat16* kr = &ks[nt * 8 + g][16 * kk + 2 * t];
          mma_bf16(s[nt], qf[kk], *reinterpret_cast<const uint32_t*>(kr),
                   *reinterpret_cast<const uint32_t*>(kr + 8));
        }
      }
    }

    // mask and the online-softmax update of rows g (h = 0) and g + 8
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      float mx = -INFINITY;
#pragma unroll
      for (int nt = 0; nt < kKeys / 8; ++nt) {
#pragma unroll
        for (int c = 0; c < 2; ++c) {
          const int j = nt * 8 + 2 * t + c;
          const int kpos = kt + j;
          const bool ok = j < n_lines && qpos[h] != INT_MIN &&
                          (!causal || kpos <= qpos[h]) &&
                          (window <= 0 || kpos > qpos[h] - window);
          float& x = s[nt][2 * h + c];
          x = ok ? x * sl2 : -INFINITY;
          mx = fmaxf(mx, x);
        }
      }
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      const float m_new = fmaxf(m[h], mx);
      const float m_use = m_new == -INFINITY ? 0.f : m_new;
      const float alpha = exp2f(m[h] - m_use);
      float sum = 0.f;
#pragma unroll
      for (int nt = 0; nt < kKeys / 8; ++nt) {
#pragma unroll
        for (int c = 0; c < 2; ++c) {
          float& x = s[nt][2 * h + c];
          x = exp2f(x - m_use);   // masked: exp2(-inf) = 0
          sum += x;
        }
      }
      l[h] = l[h] * alpha + sum;
      m[h] = m_new;
#pragma unroll
      for (int nd = 0; nd < kMaxHd / 8; ++nd) {
        o[nd][2 * h] *= alpha;
        o[nd][2 * h + 1] *= alpha;
      }
    }

    // O += P V, 16 keys per k-step
#pragma unroll
    for (int kq = 0; kq < kKeys / 16; ++kq) {
      if (kq * 16 >= n_lines) break;
      const uint32_t pa[4] = {pack_bf16(s[2 * kq][0], s[2 * kq][1]),
                              pack_bf16(s[2 * kq][2], s[2 * kq][3]),
                              pack_bf16(s[2 * kq + 1][0], s[2 * kq + 1][1]),
                              pack_bf16(s[2 * kq + 1][2], s[2 * kq + 1][3])};
      const __nv_bfloat16* vrow = &vs[16 * kq + (lane & 15)][8 * (lane >> 4)];
#pragma unroll
      for (int nd = 0; nd < kMaxHd / 8; nd += 2) {
        if (nd * 8 < hd) {
          uint32_t b0, b1, b2, b3;
          const uint32_t addr = static_cast<uint32_t>(
              __cvta_generic_to_shared(vrow + 8 * nd));
          asm volatile(
              "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 "
              "{%0,%1,%2,%3}, [%4];\n"
              : "=r"(b0), "=r"(b1), "=r"(b2), "=r"(b3)
              : "r"(addr));
          mma_bf16(o[nd], pa, b0, b1);
          mma_bf16(o[nd + 1], pa, b2, b3);
        }
      }
    }
  }

#pragma unroll
  for (int h = 0; h < 2; ++h) {
    float tot = l[h];
    tot += __shfl_xor_sync(0xffffffffu, tot, 1);
    tot += __shfl_xor_sync(0xffffffffu, tot, 2);
    if (qpos[h] == INT_MIN) continue;
    const int r = warp * 16 + g + 8 * h;
    const int pos = q0 + r / G;
    const float inv = tot > 0.f ? 1.f / tot : 0.f;   // no key -> zeros
    __nv_bfloat16* dst =
        out + (((size_t)b * Sq + pos) * H + kvh * G + r % G) * hd;
#pragma unroll
    for (int nd = 0; nd < kMaxHd / 8; ++nd) {
      if (nd * 8 < hd)
        *reinterpret_cast<uint32_t*>(dst + 8 * nd + 2 * t) =
            pack_bf16(o[nd][2 * h] * inv, o[nd][2 * h + 1] * inv);
    }
  }
}

cudaError_t launch_f32(const void* q, const void* k, const void* v,
                       void* out, int B, int Sq, int Sk, int H, int KV,
                       int hd, int causal, int window, int q_offset,
                       float scale, cudaStream_t stream) {
  const size_t smem = sizeof(Smem);
  static const cudaError_t attr = cudaFuncSetAttribute(
      flash_kernel_simt, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (attr != cudaSuccess) return attr;
  const int npos = kRowsPerBlock / (H / KV);
  const dim3 grid((Sq + npos - 1) / npos, KV, B);
  flash_kernel_simt<<<grid, kThreads, smem, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<float*>(out), Sq, Sk, H, KV,
      hd, causal, window, q_offset, scale);
  return cudaGetLastError();
}

cudaError_t launch_bf16(const void* q, const void* k, const void* v,
                        void* out, int B, int Sq, int Sk, int H, int KV,
                        int hd, int causal, int window, int q_offset,
                        float scale, cudaStream_t stream) {
  const int npos = kRowsPerBlock / (H / KV);
  const dim3 grid((Sq + npos - 1) / npos, KV, B);
  flash_kernel_mma<<<grid, kMmaThreads, 0, stream>>>(
      static_cast<const __nv_bfloat16*>(q),
      static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v),
      static_cast<__nv_bfloat16*>(out), Sq, Sk, H, KV, hd, causal, window,
      q_offset, scale);
  return cudaGetLastError();
}

}  // namespace
}  // namespace repro_torch

// C entry point, bound with ctypes. Returns cudaGetLastError() after the
// launch (0 = cudaSuccess); shapes are validated by the Python wrapper.
extern "C" int flash_attention(int dtype, const void* q, const void* k,
                               const void* v, void* out, int B, int Sq,
                               int Sk, int H, int KV, int hd, int causal,
                               int window, int q_offset, float scale,
                               void* stream) {
  using namespace repro_torch;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (B == 0 || Sq == 0) return static_cast<int>(cudaSuccess);
  if (H / KV > kRowsPerBlock || hd > kMaxHd || hd % 16)
    return static_cast<int>(cudaErrorInvalidValue);
  if (dtype == kBFloat16)
    return static_cast<int>(launch_bf16(q, k, v, out, B, Sq, Sk, H, KV, hd,
                                        causal, window, q_offset, scale, st));
  if (dtype == kFloat32)
    return static_cast<int>(launch_f32(q, k, v, out, B, Sq, Sk, H, KV, hd,
                                       causal, window, q_offset, scale, st));
  return static_cast<int>(cudaErrorInvalidValue);
}
