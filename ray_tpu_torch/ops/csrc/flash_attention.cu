// Flash attention for training: forward, dq and dk/dv, over the
// public (B, S, H, D) / (B, S, KVH, D) layouts read in place.
//
// Replaces the TPU kernels of ray_tpu/ops/attention.py:
//   flash_fwd_kernel  <- `_flash_kernel`     (via `_flash_forward`)
//   flash_dq_kernel   <- `_flash_dq_kernel`  (via `_flash_backward`)
//   flash_dkv_kernel  <- `_flash_dkv_kernel` (via `_flash_backward`)
// and keeps what they compute, not their blocks:
//   - scores s = scale * <q, k> in float32, bf16/f16 inputs upcast;
//     causal mask top-left aligned (row >= col, both from 0), -1e30;
//   - forward: float32 online softmax, out = acc / max(l, 1e-30),
//     lse = m + log(max(l, 1e-30)), lse laid out (B*H, Sq);
//   - backward: P = exp(s - lse) recomputed from the saved lse, never a
//     fresh softmax; dS = P * (dO . V^T - delta), delta = rowsum(dO*O)
//     given by the caller; dq = scale * dS K; dk = scale * dS^T Q;
//     dv = P^T dO;
//   - GQA: query head h reads kv head h / (H / KVH).
//
// What bounds them on an H100: operations. At Llama widths (D = 128,
// S = 2048) every tile pair does 2 * rows * keys * D flops per product
// on (rows + keys) * D loaded values, far above the ~295 flop/byte
// ridge; the bound is the tensor cores' 989 TFLOP/s (bf16), or the
// CUDA cores' 67 TFLOP/s for products that stay there.
//
// Two designs, chosen by the inputs' dtype (a rule by type, not a
// fallback: a bf16 launch that cannot build its TMA maps or launch
// returns non-zero and the wrapper raises):
//
// bf16 forward, dq and dk/dv (flash_fwd_tc_kernel, flash_dq_tc_kernel,
// flash_dkv_tc_kernel; the training path's dtype): products on the
// tensor cores with wgmma,
// tiles brought in by TMA, a producer warp and two consumer warpgroups
// (hopper_mma.cuh holds the building blocks).
//   - The float32 contract holds. Q K^T, dO V^T, K Q^T and V dO^T take
//     bf16 operands, whose products are exact in float32, into float32
//     accumulators. P V, dS K, P^T dO and dS^T Q have a float32 operand:
//     it is split into bf16 hi = bf16(x) and lo = bf16(x - hi), and two
//     RS wgmmas (hi, then lo) add into one accumulator, so the operand
//     keeps 16 significant bits (~2^-17 relative) and each partial
//     product is exact. That costs 1.5x the tensor-core work of a plain
//     bf16 flash kernel (3 products for 2 in the forward, 4 for 3 in
//     dq, 6 for 4 in dk/dv). P and dS are never rounded to one bf16.
//   - Forward: a block owns (b*h, 128 q rows), longest first; consumer
//     warpgroup c owns rows 64 c .. 64 c + 63. The producer loads the Q
//     tile once and streams (K, V) tiles of 128 keys through a 2-stage
//     ring (one "full" and one "empty" mbarrier a stage). S = Q K^T is
//     an SS wgmma (both operands K-major); the online softmax runs on
//     the accumulator fragment, where a row lives on the 4 lanes of a
//     quad (2 shuffles for its max and sum); P's fragment, packed as
//     bf16x2 hi/lo, is already the A operand of O += P V, which reads V
//     ([key][D]) MN-major through the transpose flag.
//   - dq: the forward's structure with the backward's arithmetic. A
//     block owns (b*h, 128 q rows), longest first; consumer c owns rows
//     64 c .. 64 c + 63 and its dq (64 x D float32) in registers for the
//     whole loop. The producer loads the Q and dO tiles once and streams
//     (K, V) tiles of 64 keys through the 2-stage ring up to the causal
//     diagonal; each consumer reads its rows' lse and delta once. S =
//     Q K^T and dP = dO V^T are SS wgmmas (K-major), P = exp(s scale -
//     lse) and dS = P (dP - delta) are formed on the fragments, and dq
//     += dS K is an RS wgmma pair (hi, lo) with K read MN-major; dq is
//     scaled once, in the epilogue. 64-key tiles keep S, dP (32 each),
//     dq (64 at D = 128) and dS hi/lo (32) within a consumer's 232
//     registers; 128-key tiles would spill.
//   - dk/dv: a block owns (b*kvh, 128 keys), first keys first; consumer
//     c owns keys 64 c .. 64 c + 63 as the wgmma M dimension, K and V
//     stay in shared memory, and dK, dV (64 x D float32 each) stay in
//     registers over the whole loop. The producer streams (Q, dO) tiles
//     of 64 q rows, with their 64 lse and delta values, through a
//     2-stage ring, over every (GQA head, live q tile) pair in a fixed
//     order. S^T = K Q^T and dP^T = V dO^T are SS wgmmas; P^T and dS^T
//     are formed on the fragments; dV += P^T dO and dK += dS^T Q are RS
//     wgmmas (hi, lo) with dO and Q read MN-major.
//   - What bounds them in practice: not the tensor cores but the
//     per-score work on the CUDA cores (exp, mask, the hi/lo split).
//     Phase timers (clock64, in a scratch build) put most of a forward
//     tile there with the accurate expf; the tensor-core kernels
//     therefore take exp as ex2.approx.ftz (`exp_ftz`): a multiply and
//     one MUFU instruction in place of expf's longer sequence.
//   - TMA maps are 4-D over the public layouts, read in place: (D,
//     heads, S, B), boxes 64 values (128 bytes) wide with the 128-byte
//     swizzle, so D = 128 takes two boxes a tile. Rows past Sq or Sk
//     arrive as zeros; the column and causal masks still apply.
//
// float32 and float16: the first version, products on the CUDA cores
// in float32 (the TPU kernels' f32 dots), ceiling 67 TFLOP/s. f16
// would need f16 P fragments, whose
// range and subnormals are a separate question, and only the tests and
// the tiny float32 configs use these types.
//   - 64 x 64 tiles, 256 threads; each thread owns a 4 x 4 block of
//     the score tile (rows tr + 16 i, columns tc + 16 j) and a 4-row x
//     D/16-column block of the output tile, so every value it reads
//     from shared memory feeds 4 multiply-adds (16-byte reads,
//     conflict-free: padded rows, broadcast along the other operand);
//   - a row's 16 owners are 16 lanes of one warp, so the row max and
//     sum are 4 shuffles, and the online-softmax state (m, l) stays in
//     registers;
//   - tiles past the causal diagonal are skipped, and blocks with the
//     most live tiles are scheduled first (the longest query tiles for
//     forward and dq, the first key tiles for dk/dv).
// Ownership follows the Pallas kernels and needs no atomics in either
// design: a forward or dq block owns (b*h, q tile) and loops over kv
// tiles; a dk/dv block owns (b*kvh, kv tile) and loops over every (GQA
// head, live q tile) pair, holding both accumulators in registers. Each
// block sums in a fixed order, so two launches on the same inputs give
// the same bits.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <stdint.h>

#include "hopper_mma.cuh"

namespace {

constexpr int kB = 64;            // rows of a q tile and of a kv tile
constexpr int kThreads = 256;     // 16 x 16 threads
constexpr int kLdp = kB + 4;      // row stride of a score tile in smem
constexpr float kMask = -1e30f;

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ float to_f(__half x) { return __half2float(x); }

template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}
template <> __device__ __forceinline__ __half from_f<__half>(float x) {
  return __float2half(x);
}

struct Args {
  int B, Sq, Sk, H, KVH;
  int causal;
  float scale;
};

// smem row stride (floats) of a D-wide tile: 16-byte aligned rows whose
// starts fall on different banks, so 16-byte reads of 8 neighbouring
// rows are conflict-free
template <int D> struct Tile { static constexpr int LD = D + 4; };

// rows [0, rows) of a 64-row tile from a (.., S, heads, D) tensor:
// src points at row 0, rows are `stride` elements apart. Rows past
// `rows` are zero. 16 bytes a thread per load, neighbouring threads on
// neighbouring addresses of one row.
template <typename T, int D>
__device__ __forceinline__ void load_tile(float* dst, const T* __restrict__ src,
                                          long long stride, int rows) {
  constexpr int N = 16 / sizeof(T);
  constexpr int PER_ROW = D / N;
  constexpr int LD = Tile<D>::LD;
  for (int idx = threadIdx.x; idx < kB * PER_ROW; idx += kThreads) {
    const int r = idx / PER_ROW, c = (idx - r * PER_ROW) * N;
    float x[N];
    if (r < rows) {
      const uint4 raw = *reinterpret_cast<const uint4*>(src + r * stride + c);
      const T* e = reinterpret_cast<const T*>(&raw);
#pragma unroll
      for (int i = 0; i < N; ++i) x[i] = to_f(e[i]);
    } else {
#pragma unroll
      for (int i = 0; i < N; ++i) x[i] = 0.f;
    }
    float* d = dst + r * LD + c;
#pragma unroll
    for (int i = 0; i < N; i += 4)
      *reinterpret_cast<float4*>(d + i) = make_float4(x[i], x[i + 1], x[i + 2], x[i + 3]);
  }
}

// c[i][j] = <A[tr + 16 i], B[tc + 16 j]> over D, both tiles [64][LD].
template <int D>
__device__ __forceinline__ void mm_nt(const float* A, const float* Bm, int tr,
                                      int tc, float (&c)[4][4]) {
  constexpr int LD = Tile<D>::LD;
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) c[i][j] = 0.f;
#pragma unroll 4
  for (int d = 0; d < D; d += 4) {
    float4 a[4], b[4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
      a[i] = *reinterpret_cast<const float4*>(A + (tr + 16 * i) * LD + d);
#pragma unroll
    for (int j = 0; j < 4; ++j)
      b[j] = *reinterpret_cast<const float4*>(Bm + (tc + 16 * j) * LD + d);
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        float s = c[i][j];
        s = fmaf(a[i].x, b[j].x, s);
        s = fmaf(a[i].y, b[j].y, s);
        s = fmaf(a[i].z, b[j].z, s);
        s = fmaf(a[i].w, b[j].w, s);
        c[i][j] = s;
      }
  }
}

// acc[i][4 jj + e] += sum_t P[tr + 16 i][t] * V[t][tc * 4 + 64 jj + e]
// over the 64 rows t of V; P is a [64][kLdp] score tile, V a [64][LD]
// tile. Each thread owns D/16 output columns in float4 groups.
template <int D>
__device__ __forceinline__ void mm_nn(const float* P, const float* V, int tr,
                                      int tc, float (&acc)[4][D / 16]) {
  constexpr int LD = Tile<D>::LD;
  constexpr int G = D / 64;        // float4 column groups a thread owns
#pragma unroll 2
  for (int t = 0; t < kB; t += 4) {
    float4 p[4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
      p[i] = *reinterpret_cast<const float4*>(P + (tr + 16 * i) * kLdp + t);
#pragma unroll
    for (int u = 0; u < 4; ++u) {
#pragma unroll
      for (int g = 0; g < G; ++g) {
        const float4 v = *reinterpret_cast<const float4*>(
            V + (t + u) * LD + tc * 4 + 64 * g);
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const float pv = u == 0 ? p[i].x : u == 1 ? p[i].y : u == 2 ? p[i].z : p[i].w;
          acc[i][4 * g + 0] = fmaf(pv, v.x, acc[i][4 * g + 0]);
          acc[i][4 * g + 1] = fmaf(pv, v.y, acc[i][4 * g + 1]);
          acc[i][4 * g + 2] = fmaf(pv, v.z, acc[i][4 * g + 2]);
          acc[i][4 * g + 3] = fmaf(pv, v.w, acc[i][4 * g + 3]);
        }
      }
    }
  }
}

// reductions over the 16 lanes that own one row
__device__ __forceinline__ float row_max(float x) {
#pragma unroll
  for (int o = 8; o > 0; o >>= 1) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}
__device__ __forceinline__ float row_sum(float x) {
#pragma unroll
  for (int o = 8; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

// write rows [0, rows) of a thread's output block, scaled by mul[i]
// (or divided by div[i]), into a (.., S, heads, D) tensor
template <typename T, int D>
__device__ __forceinline__ void store_rows(T* __restrict__ dst, long long stride,
                                           int rows, int tr, int tc,
                                           const float (&acc)[4][D / 16],
                                           const float (&den)[4], float mul) {
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = tr + 16 * i;
    if (r >= rows) continue;
    T* row = dst + r * stride;
#pragma unroll
    for (int g = 0; g < D / 64; ++g)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        row[tc * 4 + 64 * g + e] = from_f<T>(acc[i][4 * g + e] / den[i] * mul);
  }
}

// number of kv tiles a q tile [q0, q0 + rows) may see
__device__ __forceinline__ int live_kv_tiles(const Args& a, int q0, int rows) {
  int n = (a.Sk + kB - 1) / kB;
  if (a.causal) {
    const int last = (q0 + rows - 1) / kB + 1;   // tiles with k0 <= last row
    n = min(n, last);
  }
  return n;
}

// ------------------------------------------------------------- forward

template <typename T, int D>
__global__ void __launch_bounds__(kThreads, 1)
flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, T* __restrict__ out,
                 float* __restrict__ lse, Args a) {
  constexpr int LD = Tile<D>::LD;
  extern __shared__ float4 smem4[];
  float* Qs = reinterpret_cast<float*>(smem4);
  float* Ks = Qs + kB * LD;
  float* Vs = Ks + kB * LD;
  float* Ps = Vs + kB * LD;

  const int bh = blockIdx.x, b = bh / a.H, h = bh - b * a.H;
  const int kvh = h / (a.H / a.KVH);
  const int q0 = (gridDim.y - 1 - blockIdx.y) * kB;   // longest tiles first
  const int rows = min(kB, a.Sq - q0);
  const int tr = threadIdx.x >> 4, tc = threadIdx.x & 15;
  const long long qs = (long long)a.H * D, ks = (long long)a.KVH * D;
  const T* qb = q + ((long long)b * a.Sq + q0) * qs + (long long)h * D;
  const T* kb = k + (long long)b * a.Sk * ks + (long long)kvh * D;
  const T* vb = v + (long long)b * a.Sk * ks + (long long)kvh * D;

  load_tile<T, D>(Qs, qb, qs, rows);
  float m[4], l[4], acc[4][D / 16];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = kMask;
    l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < D / 16; ++c) acc[i][c] = 0.f;
  }
  const int n_kt = live_kv_tiles(a, q0, rows);
  for (int kt = 0; kt < n_kt; ++kt) {
    const int k0 = kt * kB;
    __syncthreads();               // the last tile's products are done
    load_tile<T, D>(Ks, kb + k0 * ks, ks, min(kB, a.Sk - k0));
    load_tile<T, D>(Vs, vb + k0 * ks, ks, min(kB, a.Sk - k0));
    __syncthreads();
    float s[4][4];
    mm_nt<D>(Qs, Ks, tr, tc, s);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int row = q0 + tr + 16 * i;
      float mt = kMask;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int col = k0 + tc + 16 * j;
        const bool live = col < a.Sk && (!a.causal || row >= col);
        s[i][j] = live ? s[i][j] * a.scale : kMask;
        mt = fmaxf(mt, s[i][j]);
      }
      const float m_new = fmaxf(m[i], row_max(mt));
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float p = s[i][j] > 0.5f * kMask ? expf(s[i][j] - m_new) : 0.f;
        Ps[(tr + 16 * i) * kLdp + tc + 16 * j] = p;
        sum += p;
      }
      const float corr = expf(m[i] - m_new);
      l[i] = l[i] * corr + row_sum(sum);
      m[i] = m_new;
#pragma unroll
      for (int c = 0; c < D / 16; ++c) acc[i][c] *= corr;
    }
    __syncthreads();
    mm_nn<D>(Ps, Vs, tr, tc, acc);
  }
  float den[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) den[i] = fmaxf(l[i], 1e-30f);
  store_rows<T, D>(out + ((long long)b * a.Sq + q0) * qs + (long long)h * D, qs,
                   rows, tr, tc, acc, den, 1.f);
  if (tc == 0) {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = tr + 16 * i;
      if (r < rows) lse[(long long)bh * a.Sq + q0 + r] = m[i] + logf(den[i]);
    }
  }
}

// ------------------------------------------------------------------ dq

template <typename T, int D>
__global__ void __launch_bounds__(kThreads, 1)
flash_dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
                const T* __restrict__ v, const T* __restrict__ dout,
                const float* __restrict__ lse, const float* __restrict__ delta,
                T* __restrict__ dq, Args a) {
  constexpr int LD = Tile<D>::LD;
  extern __shared__ float4 smem4[];
  float* Qs = reinterpret_cast<float*>(smem4);
  float* dOs = Qs + kB * LD;
  float* Ks = dOs + kB * LD;
  float* Vs = Ks + kB * LD;
  float* dSs = Vs + kB * LD;

  const int bh = blockIdx.x, b = bh / a.H, h = bh - b * a.H;
  const int kvh = h / (a.H / a.KVH);
  const int q0 = (gridDim.y - 1 - blockIdx.y) * kB;
  const int rows = min(kB, a.Sq - q0);
  const int tr = threadIdx.x >> 4, tc = threadIdx.x & 15;
  const long long qs = (long long)a.H * D, ks = (long long)a.KVH * D;
  const long long qoff = ((long long)b * a.Sq + q0) * qs + (long long)h * D;
  const T* kb = k + (long long)b * a.Sk * ks + (long long)kvh * D;
  const T* vb = v + (long long)b * a.Sk * ks + (long long)kvh * D;

  load_tile<T, D>(Qs, q + qoff, qs, rows);
  load_tile<T, D>(dOs, dout + qoff, qs, rows);
  float lse_r[4], delta_r[4], acc[4][D / 16];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = tr + 16 * i;
    lse_r[i] = r < rows ? lse[(long long)bh * a.Sq + q0 + r] : 0.f;
    delta_r[i] = r < rows ? delta[(long long)bh * a.Sq + q0 + r] : 0.f;
#pragma unroll
    for (int c = 0; c < D / 16; ++c) acc[i][c] = 0.f;
  }
  const int n_kt = live_kv_tiles(a, q0, rows);
  for (int kt = 0; kt < n_kt; ++kt) {
    const int k0 = kt * kB;
    __syncthreads();
    load_tile<T, D>(Ks, kb + k0 * ks, ks, min(kB, a.Sk - k0));
    load_tile<T, D>(Vs, vb + k0 * ks, ks, min(kB, a.Sk - k0));
    __syncthreads();
    float s[4][4], dp[4][4];
    mm_nt<D>(Qs, Ks, tr, tc, s);
    mm_nt<D>(dOs, Vs, tr, tc, dp);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int row = q0 + tr + 16 * i;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int col = k0 + tc + 16 * j;
        const bool live = row < a.Sq && col < a.Sk && (!a.causal || row >= col);
        const float p = live ? expf(s[i][j] * a.scale - lse_r[i]) : 0.f;
        dSs[(tr + 16 * i) * kLdp + tc + 16 * j] = p * (dp[i][j] - delta_r[i]);
      }
    }
    __syncthreads();
    mm_nn<D>(dSs, Ks, tr, tc, acc);
  }
  const float one[4] = {1.f, 1.f, 1.f, 1.f};
  store_rows<T, D>(dq + qoff, qs, rows, tr, tc, acc, one, a.scale);
}

// --------------------------------------------------------------- dk/dv

template <typename T, int D>
__global__ void __launch_bounds__(kThreads, 1)
flash_dkv_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, const T* __restrict__ dout,
                 const float* __restrict__ lse, const float* __restrict__ delta,
                 T* __restrict__ dk, T* __restrict__ dv, Args a) {
  constexpr int LD = Tile<D>::LD;
  extern __shared__ float4 smem4[];
  float* Ks = reinterpret_cast<float*>(smem4);
  float* Vs = Ks + kB * LD;
  float* Qs = Vs + kB * LD;
  float* dOs = Qs + kB * LD;
  float* Pt = dOs + kB * LD;       // [key][q row]
  float* dSt = Pt + kB * kLdp;
  float* lse_s = dSt + kB * kLdp;
  float* delta_s = lse_s + kB;

  const int bk = blockIdx.x, b = bk / a.KVH, kvh = bk - b * a.KVH;
  const int group = a.H / a.KVH;
  const int k0 = blockIdx.y * kB;  // first key tiles see the most q tiles
  const int krows = min(kB, a.Sk - k0);
  const int tr = threadIdx.x >> 4, tc = threadIdx.x & 15;
  const long long qs = (long long)a.H * D, ks = (long long)a.KVH * D;
  const long long koff = ((long long)b * a.Sk + k0) * ks + (long long)kvh * D;

  load_tile<T, D>(Ks, k + koff, ks, krows);
  load_tile<T, D>(Vs, v + koff, ks, krows);
  float dk_acc[4][D / 16], dv_acc[4][D / 16];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int c = 0; c < D / 16; ++c) dk_acc[i][c] = dv_acc[i][c] = 0.f;

  const int n_qt = (a.Sq + kB - 1) / kB;
  const int qt0 = a.causal ? k0 / kB : 0;   // q tiles whose last row >= k0
  for (int g = 0; g < group; ++g) {
    const int h = kvh * group + g;
    const long long bh = (long long)b * a.H + h;
    for (int qt = qt0; qt < n_qt; ++qt) {
      const int q0 = qt * kB;
      const int rows = min(kB, a.Sq - q0);
      if (a.causal && q0 + rows - 1 < k0) continue;
      const long long qoff = ((long long)b * a.Sq + q0) * qs + (long long)h * D;
      __syncthreads();             // the last pair's products are done
      load_tile<T, D>(Qs, q + qoff, qs, rows);
      load_tile<T, D>(dOs, dout + qoff, qs, rows);
      for (int r = threadIdx.x; r < kB; r += kThreads) {
        lse_s[r] = r < rows ? lse[bh * a.Sq + q0 + r] : 0.f;
        delta_s[r] = r < rows ? delta[bh * a.Sq + q0 + r] : 0.f;
      }
      __syncthreads();
      float st[4][4], dpt[4][4];   // [key tr + 16 i][q row tc + 16 j]
      mm_nt<D>(Ks, Qs, tr, tc, st);
      mm_nt<D>(Vs, dOs, tr, tc, dpt);
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int col = k0 + tr + 16 * i;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int rj = tc + 16 * j, row = q0 + rj;
          const bool live = rj < rows && col < a.Sk && (!a.causal || row >= col);
          const float p = live ? expf(st[i][j] * a.scale - lse_s[rj]) : 0.f;
          Pt[(tr + 16 * i) * kLdp + rj] = p;
          dSt[(tr + 16 * i) * kLdp + rj] = p * (dpt[i][j] - delta_s[rj]);
        }
      }
      __syncthreads();
      mm_nn<D>(Pt, dOs, tr, tc, dv_acc);
      mm_nn<D>(dSt, Qs, tr, tc, dk_acc);
    }
  }
  const float one[4] = {1.f, 1.f, 1.f, 1.f};
  store_rows<T, D>(dk + koff, ks, krows, tr, tc, dk_acc, one, a.scale);
  store_rows<T, D>(dv + koff, ks, krows, tr, tc, dv_acc, one, 1.f);
}

// ============================================== bf16: the tensor-core path
//
// Block = 3 warpgroups: warpgroup 0 is the producer (one thread issues
// the TMA loads; for dk/dv its first warp also stages lse and delta),
// warpgroups 1 and 2 are consumers that run wgmma on what has arrived.

namespace tc {

using hmma::align1024;
using hmma::desc_k_major;
using hmma::desc_mn_major;
using hmma::exp_ftz;
using hmma::fence_regs;
using hmma::quad_max;
using hmma::quad_sum;
using hmma::smem_u32;

constexpr int kWG = 128;                   // threads of a warpgroup
constexpr int kThreadsTC = 3 * kWG;
constexpr int kProducerRegs = 40;
constexpr int kConsumerRegs = 232;         // 128 x 40 + 256 x 232 <= 64 K
constexpr int kStages = 2;                 // ring depth of the streamed tiles
constexpr int kFwdM = 128;                 // forward: q rows a block (64 a consumer)
constexpr int kFwdN = 128;                 // forward: keys a kv tile
constexpr int kDkvN = 128;                 // dk/dv: keys a block (64 a consumer)
constexpr int kDkvM = 64;                  // dk/dv: q rows a streamed tile
constexpr int kDqM = 128;                  // dq: q rows a block (64 a consumer)
constexpr int kDqN = 64;                   // dq: keys a streamed kv tile
constexpr int kTmaError = -2;


// shared memory of the forward: Q [kFwdM][D], then kStages x (K, V)
// [kFwdN][D], each D / 64 swizzled regions; then the barriers
template <int D> struct FwdSmem {
  static constexpr uint32_t kQRegion = kFwdM * 128, kKVRegion = kFwdN * 128;
  static constexpr uint32_t kQ = kFwdM * D * 2, kKV = kFwdN * D * 2;
  static constexpr uint32_t kBars = kQ + kStages * 2 * kKV;
  static constexpr size_t kBytes = kBars + (1 + 2 * kStages) * 8 + 1024;
};

// One block owns (b*h, 128 q rows) and loops over the live kv tiles;
// consumer c owns q rows 64 c .. 64 c + 63 of the block.
template <int D>
__global__ void __launch_bounds__(kThreadsTC, 1)
flash_fwd_tc_kernel(const __grid_constant__ CUtensorMap tq,
                    const __grid_constant__ CUtensorMap tk,
                    const __grid_constant__ CUtensorMap tv,
                    __nv_bfloat16* __restrict__ out, float* __restrict__ lse,
                    Args a) {
  using L = FwdSmem<D>;
  constexpr int BN = kFwdN;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = align1024(smem_raw);
  uint64_t* q_full = reinterpret_cast<uint64_t*>(smem + L::kBars);
  uint64_t* full = q_full + 1;
  uint64_t* empty = full + kStages;

  const int bh = blockIdx.x, b = bh / a.H, h = bh - b * a.H;
  const int kvh = h / (a.H / a.KVH);
  const int q0 = (gridDim.y - 1 - blockIdx.y) * kFwdM;   // longest tiles first
  const int rows = min(kFwdM, a.Sq - q0);
  int n_kt = (a.Sk + BN - 1) / BN;
  if (a.causal) n_kt = min(n_kt, (q0 + rows - 1) / BN + 1);

  if (threadIdx.x == 0) {
    hmma::mbar_init(q_full, 1);
    for (int s = 0; s < kStages; ++s) {
      hmma::mbar_init(&full[s], 1);
      hmma::mbar_init(&empty[s], 2 * kWG);
    }
    hmma::mbar_fence_init();
  }
  __syncthreads();

  if (threadIdx.x < kWG) {
    // ------------------------------------------------------ producer
    hmma::reg_dealloc<kProducerRegs>();
    if (threadIdx.x == 0) {
      hmma::tma_prefetch_map(&tk);
      hmma::tma_prefetch_map(&tv);
      hmma::mbar_arrive_expect_tx(q_full, L::kQ);
#pragma unroll
      for (int c = 0; c < D / 64; ++c)
        hmma::tma_load_4d(smem + c * L::kQRegion, &tq, q_full, 64 * c, h, q0, b);
      for (int kt = 0; kt < n_kt; ++kt) {
        const int s = kt % kStages, n = kt / kStages;
        hmma::mbar_wait(&empty[s], (n & 1) ^ 1);
        uint8_t* ks = smem + L::kQ + s * 2 * L::kKV;
        hmma::mbar_arrive_expect_tx(&full[s], 2 * L::kKV);
#pragma unroll
        for (int c = 0; c < D / 64; ++c) {
          hmma::tma_load_4d(ks + c * L::kKVRegion, &tk, &full[s], 64 * c, kvh,
                            kt * BN, b);
          hmma::tma_load_4d(ks + L::kKV + c * L::kKVRegion, &tv, &full[s],
                            64 * c, kvh, kt * BN, b);
        }
      }
    }
  } else {
    // ------------------------------------------------------ consumers
    hmma::reg_alloc<kConsumerRegs>();
    const int cw = threadIdx.x / kWG - 1;
    const int t = threadIdx.x % kWG, lane = t % 32;
    const int row_lo = q0 + cw * 64;                   // this consumer's first row
    const int r0 = row_lo + (t / 32) * 16 + lane / 4;  // rows r0, r0 + 8
    const int cq = 2 * (lane % 4);
    const uint32_t q_tile = smem_u32(smem) + cw * 64 * 128;
    float o[D / 2];
#pragma unroll
    for (int i = 0; i < D / 2; ++i) o[i] = 0.f;
    float m[2] = {kMask, kMask}, l[2] = {0.f, 0.f};
    hmma::mbar_wait(q_full, 0);
    for (int kt = 0; kt < n_kt; ++kt) {
      const int s = kt % kStages, n = kt / kStages;
      const int k0 = kt * BN;
      hmma::mbar_wait(&full[s], n & 1);
      const uint32_t k_tile = smem_u32(smem) + L::kQ + s * 2 * L::kKV;
      const uint32_t v_tile = k_tile + L::kKV;

      // S = Q K^T: bf16 operands, exact products, float32 sums
      float sc[BN / 2];
#pragma unroll
      for (int i = 0; i < BN / 2; ++i) sc[i] = 0.f;
      fence_regs(sc);
      hmma::wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk)
        hmma::wgmma_ss<BN, 0>(sc, desc_k_major(q_tile, L::kQRegion, kk),
                              desc_k_major(k_tile, L::kKVRegion, kk), 1);
      hmma::wgmma_commit();
      hmma::wgmma_wait<0>();
      fence_regs(sc);

      // scale, mask, online softmax; a row lives on the 4 lanes of a quad
      const bool edge = k0 + BN > a.Sk || (a.causal && k0 + BN - 1 > row_lo);
      float mt[2] = {kMask, kMask};
#pragma unroll
      for (int j = 0; j < BN / 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          float x = sc[4 * j + e] * a.scale;
          if (edge) {
            const int col = k0 + 8 * j + cq + (e & 1);
            const int row = r0 + 8 * (e >> 1);
            x = (col < a.Sk && (!a.causal || row >= col)) ? x : kMask;
          }
          sc[4 * j + e] = x;
          mt[e >> 1] = fmaxf(mt[e >> 1], x);
        }
      float corr[2], sum[2] = {0.f, 0.f};
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const float m_new = fmaxf(m[r], quad_max(mt[r]));
        corr[r] = exp_ftz(m[r] - m_new);
        m[r] = m_new;
      }
#pragma unroll
      for (int i = 0; i < BN / 2; ++i) {
        const int r = (i >> 1) & 1;
        const float p = sc[i] > 0.5f * kMask ? exp_ftz(sc[i] - m[r]) : 0.f;
        sc[i] = p;
        sum[r] += p;
      }
#pragma unroll
      for (int r = 0; r < 2; ++r) l[r] = l[r] * corr[r] + quad_sum(sum[r]);
#pragma unroll
      for (int i = 0; i < D / 2; ++i) o[i] *= corr[(i >> 1) & 1];

      // O += P V with P as bf16 hi + lo, V read MN-major ([key][D])
      uint32_t ph[BN / 16][4], pl[BN / 16][4];
#pragma unroll
      for (int kb = 0; kb < BN / 16; ++kb)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          hmma::split_bf16x2(sc[8 * kb + 2 * e], sc[8 * kb + 2 * e + 1],
                             ph[kb][e], pl[kb][e]);
      fence_regs(o);
      hmma::wgmma_fence();
#pragma unroll
      for (int kb = 0; kb < BN / 16; ++kb) {
        const uint64_t dv = desc_mn_major(v_tile, L::kKVRegion, kb);
        hmma::wgmma_rs<D, 1>(o, ph[kb], dv, 1);
        hmma::wgmma_rs<D, 1>(o, pl[kb], dv, 1);
      }
      hmma::wgmma_commit();
      hmma::wgmma_wait<0>();
      fence_regs(o);
#pragma unroll
      for (int kb = 0; kb < BN / 16; ++kb) {
        fence_regs(ph[kb]);
        fence_regs(pl[kb]);
      }
      hmma::mbar_arrive(&empty[s]);
    }

    // out = acc / max(l, 1e-30), lse = m + log(max(l, 1e-30))
    const long long qs = (long long)a.H * D;
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int row = r0 + 8 * r;
      if (row >= a.Sq) continue;
      const float den = fmaxf(l[r], 1e-30f);
      __nv_bfloat16* dst = out + ((long long)b * a.Sq + row) * qs + (long long)h * D;
#pragma unroll
      for (int j = 0; j < D / 8; ++j)
        *reinterpret_cast<__nv_bfloat162*>(dst + 8 * j + cq) =
            __floats2bfloat162_rn(o[4 * j + 2 * r] / den,
                                  o[4 * j + 2 * r + 1] / den);
      if ((lane & 3) == 0) lse[(long long)bh * a.Sq + row] = m[r] + logf(den);
    }
  }
}

// shared memory of dq: Q, dO [kDqM][D] resident; kStages x (K, V)
// [kDqN][D] streamed; the barriers
template <int D> struct DqSmem {
  static constexpr uint32_t kQRegion = kDqM * 128, kKVRegion = kDqN * 128;
  static constexpr uint32_t kQ = kDqM * D * 2, kKV = kDqN * D * 2;
  static constexpr uint32_t kStage0 = 2 * kQ;               // Q, then dO
  static constexpr uint32_t kBars = kStage0 + kStages * 2 * kKV;
  static constexpr size_t kBytes = kBars + (1 + 2 * kStages) * 8 + 1024;
};

// One block owns (b*h, 128 q rows), longest first, and loops over the
// live 64-key tiles; consumer c owns q rows 64 c .. 64 c + 63 and their
// dq accumulator (64 x D float32, in registers for the whole loop).
template <int D>
__global__ void __launch_bounds__(kThreadsTC, 1)
flash_dq_tc_kernel(const __grid_constant__ CUtensorMap tq,
                   const __grid_constant__ CUtensorMap tk,
                   const __grid_constant__ CUtensorMap tv,
                   const __grid_constant__ CUtensorMap tdo,
                   const float* __restrict__ lse,
                   const float* __restrict__ delta,
                   __nv_bfloat16* __restrict__ dq, Args a) {
  using L = DqSmem<D>;
  constexpr int BN = kDqN;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = align1024(smem_raw);
  uint64_t* q_full = reinterpret_cast<uint64_t*>(smem + L::kBars);
  uint64_t* full = q_full + 1;
  uint64_t* empty = full + kStages;

  const int bh = blockIdx.x, b = bh / a.H, h = bh - b * a.H;
  const int kvh = h / (a.H / a.KVH);
  const int q0 = (gridDim.y - 1 - blockIdx.y) * kDqM;   // longest tiles first
  const int rows = min(kDqM, a.Sq - q0);
  int n_kt = (a.Sk + BN - 1) / BN;
  if (a.causal) n_kt = min(n_kt, (q0 + rows - 1) / BN + 1);

  if (threadIdx.x == 0) {
    hmma::mbar_init(q_full, 1);
    for (int s = 0; s < kStages; ++s) {
      hmma::mbar_init(&full[s], 1);
      hmma::mbar_init(&empty[s], 2 * kWG);
    }
    hmma::mbar_fence_init();
  }
  __syncthreads();

  if (threadIdx.x < kWG) {
    // ------------------------------------------------------ producer
    hmma::reg_dealloc<kProducerRegs>();
    if (threadIdx.x == 0) {
      hmma::tma_prefetch_map(&tk);
      hmma::tma_prefetch_map(&tv);
      hmma::mbar_arrive_expect_tx(q_full, 2 * L::kQ);
#pragma unroll
      for (int c = 0; c < D / 64; ++c) {
        hmma::tma_load_4d(smem + c * L::kQRegion, &tq, q_full, 64 * c, h, q0, b);
        hmma::tma_load_4d(smem + L::kQ + c * L::kQRegion, &tdo, q_full, 64 * c,
                          h, q0, b);
      }
      for (int kt = 0; kt < n_kt; ++kt) {
        const int s = kt % kStages, n = kt / kStages;
        hmma::mbar_wait(&empty[s], (n & 1) ^ 1);
        uint8_t* ks = smem + L::kStage0 + s * 2 * L::kKV;
        hmma::mbar_arrive_expect_tx(&full[s], 2 * L::kKV);
#pragma unroll
        for (int c = 0; c < D / 64; ++c) {
          hmma::tma_load_4d(ks + c * L::kKVRegion, &tk, &full[s], 64 * c, kvh,
                            kt * BN, b);
          hmma::tma_load_4d(ks + L::kKV + c * L::kKVRegion, &tv, &full[s],
                            64 * c, kvh, kt * BN, b);
        }
      }
    }
  } else {
    // ------------------------------------------------------ consumers
    hmma::reg_alloc<kConsumerRegs>();
    const int cw = threadIdx.x / kWG - 1;
    const int t = threadIdx.x % kWG, lane = t % 32;
    const int row_lo = q0 + cw * 64;                   // this consumer's first row
    const int r0 = row_lo + (t / 32) * 16 + lane / 4;  // rows r0, r0 + 8
    const int cq = 2 * (lane % 4);
    const uint32_t q_tile = smem_u32(smem) + cw * 64 * 128;
    const uint32_t do_tile = q_tile + L::kQ;
    float lse_r[2], dl_r[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int row = r0 + 8 * r;
      lse_r[r] = row < a.Sq ? lse[(long long)bh * a.Sq + row] : 0.f;
      dl_r[r] = row < a.Sq ? delta[(long long)bh * a.Sq + row] : 0.f;
    }
    float acc[D / 2];
#pragma unroll
    for (int i = 0; i < D / 2; ++i) acc[i] = 0.f;
    hmma::mbar_wait(q_full, 0);
    for (int kt = 0; kt < n_kt; ++kt) {
      const int s = kt % kStages, n = kt / kStages;
      const int k0 = kt * BN;
      hmma::mbar_wait(&full[s], n & 1);
      // a causal tile whose keys all follow this consumer's rows adds
      // nothing
      if (!(a.causal && k0 > row_lo + 63)) {
        const uint32_t k_tile = smem_u32(smem) + L::kStage0 + s * 2 * L::kKV;
        const uint32_t v_tile = k_tile + L::kKV;
        // S = Q K^T and dP = dO V^T: bf16 operands, exact products
        float sc[BN / 2], dp[BN / 2];
#pragma unroll
        for (int i = 0; i < BN / 2; ++i) sc[i] = dp[i] = 0.f;
        fence_regs(sc);
        fence_regs(dp);
        hmma::wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < D / 16; ++kk)
          hmma::wgmma_ss<BN, 0>(sc, desc_k_major(q_tile, L::kQRegion, kk),
                                desc_k_major(k_tile, L::kKVRegion, kk), 1);
#pragma unroll
        for (int kk = 0; kk < D / 16; ++kk)
          hmma::wgmma_ss<BN, 0>(dp, desc_k_major(do_tile, L::kQRegion, kk),
                                desc_k_major(v_tile, L::kKVRegion, kk), 1);
        hmma::wgmma_commit();
        hmma::wgmma_wait<0>();
        fence_regs(sc);
        fence_regs(dp);

        // P = exp(S scale - lse) (masked to 0), dS = P (dP - delta); the
        // mask only on tiles that cross Sk or this consumer's diagonal
        const bool edge = k0 + BN > a.Sk || (a.causal && k0 + BN - 1 > row_lo);
#pragma unroll
        for (int j = 0; j < BN / 8; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            bool live = true;
            if (edge) {
              const int col = k0 + 8 * j + cq + (e & 1);
              const int row = r0 + 8 * (e >> 1);
              live = col < a.Sk && (!a.causal || row >= col);
            }
            const float p =
                live ? exp_ftz(sc[4 * j + e] * a.scale - lse_r[e >> 1]) : 0.f;
            dp[4 * j + e] = p * (dp[4 * j + e] - dl_r[e >> 1]);
          }

        // dq += dS K with dS as bf16 hi + lo, K read MN-major ([key][D])
        uint32_t sh[BN / 16][4], sl[BN / 16][4];
#pragma unroll
        for (int kb = 0; kb < BN / 16; ++kb)
#pragma unroll
          for (int e = 0; e < 4; ++e)
            hmma::split_bf16x2(dp[8 * kb + 2 * e], dp[8 * kb + 2 * e + 1],
                               sh[kb][e], sl[kb][e]);
        fence_regs(acc);
        hmma::wgmma_fence();
#pragma unroll
        for (int kb = 0; kb < BN / 16; ++kb) {
          const uint64_t dk = desc_mn_major(k_tile, L::kKVRegion, kb);
          hmma::wgmma_rs<D, 1>(acc, sh[kb], dk, 1);
          hmma::wgmma_rs<D, 1>(acc, sl[kb], dk, 1);
        }
        hmma::wgmma_commit();
        hmma::wgmma_wait<0>();
        fence_regs(acc);
#pragma unroll
        for (int kb = 0; kb < BN / 16; ++kb) {
          fence_regs(sh[kb]);
          fence_regs(sl[kb]);
        }
      }
      hmma::mbar_arrive(&empty[s]);
    }

    // dq = scale * sum dS K, rows below Sq
    const long long qs = (long long)a.H * D;
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int row = r0 + 8 * r;
      if (row >= a.Sq) continue;
      __nv_bfloat16* dst = dq + ((long long)b * a.Sq + row) * qs + (long long)h * D;
#pragma unroll
      for (int j = 0; j < D / 8; ++j)
        *reinterpret_cast<__nv_bfloat162*>(dst + 8 * j + cq) =
            __floats2bfloat162_rn(acc[4 * j + 2 * r] * a.scale,
                                  acc[4 * j + 2 * r + 1] * a.scale);
    }
  }
}

// shared memory of dk/dv: K, V [kDkvN][D] resident; kStages x (Q, dO)
// [kDkvM][D] streamed; kStages x (lse, delta) [kDkvM]; the barriers
template <int D> struct DkvSmem {
  static constexpr uint32_t kKVRegion = kDkvN * 128, kQRegion = kDkvM * 128;
  static constexpr uint32_t kKV = kDkvN * D * 2, kQ = kDkvM * D * 2;
  static constexpr uint32_t kStage0 = 2 * kKV;              // Q, then dO
  static constexpr uint32_t kRowsOff = kStage0 + kStages * 2 * kQ;
  static constexpr uint32_t kBars = kRowsOff + kStages * 2 * kDkvM * 4;
  static constexpr size_t kBytes = kBars + (1 + 2 * kStages) * 8 + 1024;
};

// One block owns (b*kvh, 128 keys); consumer c owns keys 64 c .. 64 c +
// 63 (the wgmma M dimension) and both their accumulators, and loops
// over every (GQA head, live 64-row q tile) pair in a fixed order.
template <int D>
__global__ void __launch_bounds__(kThreadsTC, 1)
flash_dkv_tc_kernel(const __grid_constant__ CUtensorMap tq,
                    const __grid_constant__ CUtensorMap tk,
                    const __grid_constant__ CUtensorMap tv,
                    const __grid_constant__ CUtensorMap tdo,
                    const float* __restrict__ lse,
                    const float* __restrict__ delta,
                    __nv_bfloat16* __restrict__ dk,
                    __nv_bfloat16* __restrict__ dv, Args a) {
  using L = DkvSmem<D>;
  constexpr int BM = kDkvM;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = align1024(smem_raw);
  float* rows_s = reinterpret_cast<float*>(smem + L::kRowsOff);  // [stage][lse | delta][BM]
  uint64_t* kv_full = reinterpret_cast<uint64_t*>(smem + L::kBars);
  uint64_t* full = kv_full + 1;
  uint64_t* empty = full + kStages;

  const int bk = blockIdx.x, b = bk / a.KVH, kvh = bk - b * a.KVH;
  const int group = a.H / a.KVH;
  const int k0 = blockIdx.y * kDkvN;         // first key tiles see the most q tiles
  const int n_qt = (a.Sq + BM - 1) / BM;
  const int qt0 = a.causal ? k0 / BM : 0;    // q tiles whose last row >= k0

  if (threadIdx.x == 0) {
    hmma::mbar_init(kv_full, 1);
    for (int s = 0; s < kStages; ++s) {
      hmma::mbar_init(&full[s], 32);
      hmma::mbar_init(&empty[s], 2 * kWG);
    }
    hmma::mbar_fence_init();
  }
  __syncthreads();

  if (threadIdx.x < kWG) {
    // ------------------------------------------------------ producer
    hmma::reg_dealloc<kProducerRegs>();
    if (threadIdx.x < 32) {
      const int lane = threadIdx.x;
      if (lane == 0) {
        hmma::tma_prefetch_map(&tq);
        hmma::tma_prefetch_map(&tdo);
        hmma::mbar_arrive_expect_tx(kv_full, 2 * L::kKV);
#pragma unroll
        for (int c = 0; c < D / 64; ++c) {
          hmma::tma_load_4d(smem + c * L::kKVRegion, &tk, kv_full, 64 * c, kvh,
                            k0, b);
          hmma::tma_load_4d(smem + L::kKV + c * L::kKVRegion, &tv, kv_full,
                            64 * c, kvh, k0, b);
        }
      }
      int i = 0;
      for (int g = 0; g < group; ++g) {
        const int h = kvh * group + g;
        const long long row_base = ((long long)b * a.H + h) * a.Sq;
        for (int qt = qt0; qt < n_qt; ++qt, ++i) {
          const int s = i % kStages, n = i / kStages;
          const int q0 = qt * BM;
          hmma::mbar_wait(&empty[s], (n & 1) ^ 1);
          float* rs = rows_s + s * 2 * BM;
          for (int r = lane; r < BM; r += 32) {
            const bool in = q0 + r < a.Sq;
            rs[r] = in ? lse[row_base + q0 + r] : 0.f;
            rs[BM + r] = in ? delta[row_base + q0 + r] : 0.f;
          }
          if (lane == 0) {
            uint8_t* qs = smem + L::kStage0 + s * 2 * L::kQ;
            hmma::mbar_arrive_expect_tx(&full[s], 2 * L::kQ);
#pragma unroll
            for (int c = 0; c < D / 64; ++c) {
              hmma::tma_load_4d(qs + c * L::kQRegion, &tq, &full[s], 64 * c, h,
                                q0, b);
              hmma::tma_load_4d(qs + L::kQ + c * L::kQRegion, &tdo, &full[s],
                                64 * c, h, q0, b);
            }
          } else {
            hmma::mbar_arrive(&full[s]);
          }
        }
      }
    }
  } else {
    // ------------------------------------------------------ consumers
    hmma::reg_alloc<kConsumerRegs>();
    const int cw = threadIdx.x / kWG - 1;
    const int t = threadIdx.x % kWG, lane = t % 32;
    const int key_lo = k0 + cw * 64;                      // this consumer's first key
    const int key0 = key_lo + (t / 32) * 16 + lane / 4;   // keys key0, key0 + 8
    const int cq = 2 * (lane % 4);
    const uint32_t k_tile = smem_u32(smem) + cw * 64 * 128;
    const uint32_t v_tile = k_tile + L::kKV;
    float dk_acc[D / 2], dv_acc[D / 2];
#pragma unroll
    for (int i = 0; i < D / 2; ++i) dk_acc[i] = dv_acc[i] = 0.f;
    hmma::mbar_wait(kv_full, 0);
    int i = 0;
    for (int g = 0; g < group; ++g) {
      for (int qt = qt0; qt < n_qt; ++qt, ++i) {
        const int s = i % kStages, n = i / kStages;
        const int q0 = qt * BM;
        const int rows = min(BM, a.Sq - q0);
        hmma::mbar_wait(&full[s], n & 1);
        // a causal pair whose q rows all precede this consumer's keys
        // adds nothing
        if (!(a.causal && q0 + rows - 1 < key_lo)) {
          const uint32_t q_tile = smem_u32(smem) + L::kStage0 + s * 2 * L::kQ;
          const uint32_t do_tile = q_tile + L::kQ;
          // S^T = K Q^T and dP^T = V dO^T: [key][q row], exact products
          float st[BM / 2], dpt[BM / 2];
#pragma unroll
          for (int j = 0; j < BM / 2; ++j) st[j] = dpt[j] = 0.f;
          fence_regs(st);
          fence_regs(dpt);
          hmma::wgmma_fence();
#pragma unroll
          for (int kk = 0; kk < D / 16; ++kk)
            hmma::wgmma_ss<BM, 0>(st, desc_k_major(k_tile, L::kKVRegion, kk),
                                  desc_k_major(q_tile, L::kQRegion, kk), 1);
#pragma unroll
          for (int kk = 0; kk < D / 16; ++kk)
            hmma::wgmma_ss<BM, 0>(dpt, desc_k_major(v_tile, L::kKVRegion, kk),
                                  desc_k_major(do_tile, L::kQRegion, kk), 1);
          hmma::wgmma_commit();
          hmma::wgmma_wait<0>();
          fence_regs(st);
          fence_regs(dpt);

          // P^T = exp(S^T scale - lse[q]) (masked to 0), dS^T = P^T (dP^T - delta[q])
          const float* ls = rows_s + s * 2 * BM;
          const float* dl = ls + BM;
          const bool edge = rows < BM || key_lo + 64 > a.Sk ||
                            (a.causal && q0 < key_lo + 63);
#pragma unroll
          for (int j = 0; j < BM / 8; ++j)
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              const int c = 8 * j + cq + (e & 1);
              bool live = true;
              if (edge) {
                const int key = key0 + 8 * (e >> 1);
                live = c < rows && key < a.Sk && (!a.causal || q0 + c >= key);
              }
              const float p =
                  live ? exp_ftz(st[4 * j + e] * a.scale - ls[c]) : 0.f;
              st[4 * j + e] = p;
              dpt[4 * j + e] = p * (dpt[4 * j + e] - dl[c]);
            }

          // dV += P^T dO and dK += dS^T Q, each float32 operand as bf16
          // hi + lo; dO and Q read MN-major ([q row][D])
          uint32_t ph[BM / 16][4], pl[BM / 16][4], sh[BM / 16][4], sl[BM / 16][4];
#pragma unroll
          for (int kb = 0; kb < BM / 16; ++kb)
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              hmma::split_bf16x2(st[8 * kb + 2 * e], st[8 * kb + 2 * e + 1],
                                 ph[kb][e], pl[kb][e]);
              hmma::split_bf16x2(dpt[8 * kb + 2 * e], dpt[8 * kb + 2 * e + 1],
                                 sh[kb][e], sl[kb][e]);
            }
          fence_regs(dv_acc);
          fence_regs(dk_acc);
          hmma::wgmma_fence();
#pragma unroll
          for (int kb = 0; kb < BM / 16; ++kb) {
            const uint64_t dd = desc_mn_major(do_tile, L::kQRegion, kb);
            hmma::wgmma_rs<D, 1>(dv_acc, ph[kb], dd, 1);
            hmma::wgmma_rs<D, 1>(dv_acc, pl[kb], dd, 1);
          }
#pragma unroll
          for (int kb = 0; kb < BM / 16; ++kb) {
            const uint64_t dq = desc_mn_major(q_tile, L::kQRegion, kb);
            hmma::wgmma_rs<D, 1>(dk_acc, sh[kb], dq, 1);
            hmma::wgmma_rs<D, 1>(dk_acc, sl[kb], dq, 1);
          }
          hmma::wgmma_commit();
          hmma::wgmma_wait<0>();
          fence_regs(dv_acc);
          fence_regs(dk_acc);
#pragma unroll
          for (int kb = 0; kb < BM / 16; ++kb) {
            fence_regs(ph[kb]);
            fence_regs(pl[kb]);
            fence_regs(sh[kb]);
            fence_regs(sl[kb]);
          }
        }
        hmma::mbar_arrive(&empty[s]);
      }
    }

    // dk = scale * sum dS^T Q, dv = sum P^T dO, rows below Sk
    const long long ks = (long long)a.KVH * D;
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int key = key0 + 8 * r;
      if (key >= a.Sk) continue;
      const long long off = ((long long)b * a.Sk + key) * ks + (long long)kvh * D;
#pragma unroll
      for (int j = 0; j < D / 8; ++j) {
        *reinterpret_cast<__nv_bfloat162*>(dk + off + 8 * j + cq) =
            __floats2bfloat162_rn(dk_acc[4 * j + 2 * r] * a.scale,
                                  dk_acc[4 * j + 2 * r + 1] * a.scale);
        *reinterpret_cast<__nv_bfloat162*>(dv + off + 8 * j + cq) =
            __floats2bfloat162_rn(dv_acc[4 * j + 2 * r], dv_acc[4 * j + 2 * r + 1]);
      }
    }
  }
}

}  // namespace tc

// -------------------------------------------------------------- launch

template <int D> constexpr size_t fwd_smem() {
  return sizeof(float) * (3 * kB * Tile<D>::LD + kB * kLdp);
}
template <int D> constexpr size_t dq_smem() {
  return sizeof(float) * (4 * kB * Tile<D>::LD + kB * kLdp);
}
template <int D> constexpr size_t dkv_smem() {
  return sizeof(float) * (4 * kB * Tile<D>::LD + 2 * kB * kLdp + 2 * kB);
}

template <typename K>
int prepare(K kernel, size_t smem) {
  return (int)cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
}

bool args_ok(int B, int Sq, int Sk, int H, int KVH, int D) {
  return B >= 0 && Sq >= 0 && Sk >= 0 && KVH > 0 && H % KVH == 0 &&
         (D == 64 || D == 128);
}

template <typename T, int D>
int fwd(const void* q, const void* k, const void* v, void* out, void* lse,
        const Args& a, cudaStream_t st) {
  auto kern = flash_fwd_kernel<T, D>;
  int rc = prepare(kern, fwd_smem<D>());
  if (rc) return rc;
  dim3 grid(a.B * a.H, (a.Sq + kB - 1) / kB);
  kern<<<grid, kThreads, fwd_smem<D>(), st>>>(
      (const T*)q, (const T*)k, (const T*)v, (T*)out, (float*)lse, a);
  return (int)cudaGetLastError();
}

template <typename T, int D>
int dq_(const void* q, const void* k, const void* v, const void* dout,
        const void* lse, const void* delta, void* dq, const Args& a,
        cudaStream_t st) {
  auto kern = flash_dq_kernel<T, D>;
  int rc = prepare(kern, dq_smem<D>());
  if (rc) return rc;
  dim3 grid(a.B * a.H, (a.Sq + kB - 1) / kB);
  kern<<<grid, kThreads, dq_smem<D>(), st>>>(
      (const T*)q, (const T*)k, (const T*)v, (const T*)dout,
      (const float*)lse, (const float*)delta, (T*)dq, a);
  return (int)cudaGetLastError();
}

template <typename T, int D>
int dkv(const void* q, const void* k, const void* v, const void* dout,
        const void* lse, const void* delta, void* dk, void* dv, const Args& a,
        cudaStream_t st) {
  auto kern = flash_dkv_kernel<T, D>;
  int rc = prepare(kern, dkv_smem<D>());
  if (rc) return rc;
  dim3 grid(a.B * a.KVH, (a.Sk + kB - 1) / kB);
  kern<<<grid, kThreads, dkv_smem<D>(), st>>>(
      (const T*)q, (const T*)k, (const T*)v, (const T*)dout,
      (const float*)lse, (const float*)delta, (T*)dk, (T*)dv, a);
  return (int)cudaGetLastError();
}

// bf16: TMA maps over the public layouts, read in place. With no keys
// (Sk == 0) no kv tile is loaded, so the kv maps are built over q.
template <int D>
int fwd_tc(const void* q, const void* k, const void* v, void* out, void* lse,
           const Args& a, cudaStream_t st) {
  using L = tc::FwdSmem<D>;
  CUtensorMap tq, tk, tv;
  const bool kv = a.Sk > 0;
  if (hmma::make_map_bf16_4d(&tq, q, D, a.H, a.Sq, a.B, tc::kFwdM) ||
      hmma::make_map_bf16_4d(&tk, kv ? k : q, D, kv ? a.KVH : a.H,
                             kv ? a.Sk : a.Sq, a.B, tc::kFwdN) ||
      hmma::make_map_bf16_4d(&tv, kv ? v : q, D, kv ? a.KVH : a.H,
                             kv ? a.Sk : a.Sq, a.B, tc::kFwdN))
    return tc::kTmaError;
  auto kern = tc::flash_fwd_tc_kernel<D>;
  int rc = prepare(kern, L::kBytes);
  if (rc) return rc;
  dim3 grid(a.B * a.H, (a.Sq + tc::kFwdM - 1) / tc::kFwdM);
  kern<<<grid, tc::kThreadsTC, L::kBytes, st>>>(
      tq, tk, tv, (__nv_bfloat16*)out, (float*)lse, a);
  return (int)cudaGetLastError();
}

// bf16 dq. With no keys (Sk == 0) no kv tile is loaded, so the kv maps
// are built over q.
template <int D>
int dq_tc(const void* q, const void* k, const void* v, const void* dout,
          const void* lse, const void* delta, void* dq, const Args& a,
          cudaStream_t st) {
  using L = tc::DqSmem<D>;
  CUtensorMap tq, tk, tv, tdo;
  const bool kv = a.Sk > 0;
  if (hmma::make_map_bf16_4d(&tq, q, D, a.H, a.Sq, a.B, tc::kDqM) ||
      hmma::make_map_bf16_4d(&tdo, dout, D, a.H, a.Sq, a.B, tc::kDqM) ||
      hmma::make_map_bf16_4d(&tk, kv ? k : q, D, kv ? a.KVH : a.H,
                             kv ? a.Sk : a.Sq, a.B, tc::kDqN) ||
      hmma::make_map_bf16_4d(&tv, kv ? v : q, D, kv ? a.KVH : a.H,
                             kv ? a.Sk : a.Sq, a.B, tc::kDqN))
    return tc::kTmaError;
  auto kern = tc::flash_dq_tc_kernel<D>;
  int rc = prepare(kern, L::kBytes);
  if (rc) return rc;
  dim3 grid(a.B * a.H, (a.Sq + tc::kDqM - 1) / tc::kDqM);
  kern<<<grid, tc::kThreadsTC, L::kBytes, st>>>(
      tq, tk, tv, tdo, (const float*)lse, (const float*)delta,
      (__nv_bfloat16*)dq, a);
  return (int)cudaGetLastError();
}

// bf16 dk/dv. With no queries (Sq == 0) no q tile is loaded, so the q
// and dO maps are built over k.
template <int D>
int dkv_tc(const void* q, const void* k, const void* v, const void* dout,
           const void* lse, const void* delta, void* dk, void* dv,
           const Args& a, cudaStream_t st) {
  using L = tc::DkvSmem<D>;
  CUtensorMap tq, tk, tv, tdo;
  const bool qs = a.Sq > 0;
  if (hmma::make_map_bf16_4d(&tq, qs ? q : k, D, qs ? a.H : a.KVH,
                             qs ? a.Sq : a.Sk, a.B, tc::kDkvM) ||
      hmma::make_map_bf16_4d(&tdo, qs ? dout : k, D, qs ? a.H : a.KVH,
                             qs ? a.Sq : a.Sk, a.B, tc::kDkvM) ||
      hmma::make_map_bf16_4d(&tk, k, D, a.KVH, a.Sk, a.B, tc::kDkvN) ||
      hmma::make_map_bf16_4d(&tv, v, D, a.KVH, a.Sk, a.B, tc::kDkvN))
    return tc::kTmaError;
  auto kern = tc::flash_dkv_tc_kernel<D>;
  int rc = prepare(kern, L::kBytes);
  if (rc) return rc;
  dim3 grid(a.B * a.KVH, (a.Sk + tc::kDkvN - 1) / tc::kDkvN);
  kern<<<grid, tc::kThreadsTC, L::kBytes, st>>>(
      tq, tk, tv, tdo, (const float*)lse, (const float*)delta,
      (__nv_bfloat16*)dk, (__nv_bfloat16*)dv, a);
  return (int)cudaGetLastError();
}

Args make_args(int B, int Sq, int Sk, int H, int KVH, int causal, float scale) {
  Args a;
  a.B = B; a.Sq = Sq; a.Sk = Sk; a.H = H; a.KVH = KVH;
  a.causal = causal; a.scale = scale;
  return a;
}

// dispatch the CUDA-core instances on (dtype, D): dtype 0 float32,
// 2 float16 (each entry point routes bf16, dtype 1, itself)
#define FLASH_DISPATCH(FN, ...)                                            \
  switch (dtype * 1000 + D) {                                              \
    case 64: return FN<float, 64>(__VA_ARGS__);                            \
    case 128: return FN<float, 128>(__VA_ARGS__);                          \
    case 2064: return FN<__half, 64>(__VA_ARGS__);                         \
    case 2128: return FN<__half, 128>(__VA_ARGS__);                        \
  }                                                                        \
  return -1;

}  // namespace

// All tensors contiguous: q/out/dout/dq [B, Sq, H, D], k/v/dk/dv
// [B, Sk, KVH, D] in one dtype, lse/delta [B, H, Sq] float32, 16-byte
// aligned. Each returns cudaGetLastError() after its launch (0 =
// launched), -1 for arguments the kernels do not take, or -2 when a
// bf16 launch's TMA tensor map cannot be encoded.
extern "C" int flash_fwd_launch(const void* q, const void* k, const void* v,
                                void* out, void* lse, int B, int Sq, int Sk,
                                int H, int KVH, int D, int causal, float scale,
                                int dtype, void* stream) {
  if (!args_ok(B, Sq, Sk, H, KVH, D)) return -1;
  if (B == 0 || H == 0 || Sq == 0) return 0;
  const Args a = make_args(B, Sq, Sk, H, KVH, causal, scale);
  cudaStream_t st = (cudaStream_t)stream;
  if (dtype == 1)   // bf16: the tensor-core kernel (D is 64 or 128)
    return D == 64 ? fwd_tc<64>(q, k, v, out, lse, a, st)
                   : fwd_tc<128>(q, k, v, out, lse, a, st);
  FLASH_DISPATCH(fwd, q, k, v, out, lse, a, st)
}

extern "C" int flash_dq_launch(const void* q, const void* k, const void* v,
                               const void* dout, const void* lse,
                               const void* delta, void* dq, int B, int Sq,
                               int Sk, int H, int KVH, int D, int causal,
                               float scale, int dtype, void* stream) {
  if (!args_ok(B, Sq, Sk, H, KVH, D)) return -1;
  if (B == 0 || H == 0 || Sq == 0) return 0;
  const Args a = make_args(B, Sq, Sk, H, KVH, causal, scale);
  cudaStream_t st = (cudaStream_t)stream;
  if (dtype == 1)   // bf16: the tensor-core kernel (D is 64 or 128)
    return D == 64 ? dq_tc<64>(q, k, v, dout, lse, delta, dq, a, st)
                   : dq_tc<128>(q, k, v, dout, lse, delta, dq, a, st);
  FLASH_DISPATCH(dq_, q, k, v, dout, lse, delta, dq, a, st)
}

extern "C" int flash_dkv_launch(const void* q, const void* k, const void* v,
                                const void* dout, const void* lse,
                                const void* delta, void* dk, void* dv, int B,
                                int Sq, int Sk, int H, int KVH, int D,
                                int causal, float scale, int dtype,
                                void* stream) {
  if (!args_ok(B, Sq, Sk, H, KVH, D)) return -1;
  if (B == 0 || KVH == 0 || Sk == 0) return 0;
  const Args a = make_args(B, Sq, Sk, H, KVH, causal, scale);
  cudaStream_t st = (cudaStream_t)stream;
  if (dtype == 1)   // bf16: the tensor-core kernel (D is 64 or 128)
    return D == 64 ? dkv_tc<64>(q, k, v, dout, lse, delta, dk, dv, a, st)
                   : dkv_tc<128>(q, k, v, dout, lse, delta, dk, dv, a, st);
  FLASH_DISPATCH(dkv, q, k, v, dout, lse, delta, dk, dv, a, st)
}
