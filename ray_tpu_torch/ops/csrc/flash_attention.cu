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
// What bounds it on an H100: operations. At Llama widths (D = 128,
// S = 2048) every tile pair does 2 * 64 * 64 * D flops per product on
// 2 * 64 * D loaded values, far above the ~295 flop/byte ridge. This
// first version runs its products on the CUDA cores in float32 (the
// TPU kernels' f32 dots; no tensor cores yet, a later version's work),
// so its ceiling is the card's 67 TFLOP/s float32 rate, not 989 bf16.
// The design keeps those cores fed:
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
// Ownership follows the Pallas kernels and needs no atomics: a forward
// or dq block owns (b*h, q tile) and loops over kv tiles; a dk/dv block
// owns (b*kvh, kv tile) and loops over every (GQA head, live q tile)
// pair, holding both accumulators in registers. Each block sums in a
// fixed order, so two launches on the same inputs give the same bits.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <stdint.h>

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

Args make_args(int B, int Sq, int Sk, int H, int KVH, int causal, float scale) {
  Args a;
  a.B = B; a.Sq = Sq; a.Sk = Sk; a.H = H; a.KVH = KVH;
  a.causal = causal; a.scale = scale;
  return a;
}

// dispatch on (dtype, D): dtype 0 float32, 1 bfloat16, 2 float16
#define FLASH_DISPATCH(FN, ...)                                            \
  switch (dtype * 1000 + D) {                                              \
    case 64: return FN<float, 64>(__VA_ARGS__);                            \
    case 128: return FN<float, 128>(__VA_ARGS__);                          \
    case 1064: return FN<__nv_bfloat16, 64>(__VA_ARGS__);                  \
    case 1128: return FN<__nv_bfloat16, 128>(__VA_ARGS__);                 \
    case 2064: return FN<__half, 64>(__VA_ARGS__);                         \
    case 2128: return FN<__half, 128>(__VA_ARGS__);                        \
  }                                                                        \
  return -1;

}  // namespace

// All tensors contiguous: q/out/dout/dq [B, Sq, H, D], k/v/dk/dv
// [B, Sk, KVH, D] in one dtype, lse/delta [B, H, Sq] float32, 16-byte
// aligned. Each returns cudaGetLastError() after its launch (0 =
// launched), or -1 for arguments the kernels do not take.
extern "C" int flash_fwd_launch(const void* q, const void* k, const void* v,
                                void* out, void* lse, int B, int Sq, int Sk,
                                int H, int KVH, int D, int causal, float scale,
                                int dtype, void* stream) {
  if (!args_ok(B, Sq, Sk, H, KVH, D)) return -1;
  if (B == 0 || H == 0 || Sq == 0) return 0;
  const Args a = make_args(B, Sq, Sk, H, KVH, causal, scale);
  cudaStream_t st = (cudaStream_t)stream;
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
  FLASH_DISPATCH(dkv, q, k, v, dout, lse, delta, dk, dv, a, st)
}
