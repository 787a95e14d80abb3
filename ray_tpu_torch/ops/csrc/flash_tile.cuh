// Shared block-level online-softmax machinery for the paged attention
// kernels (paged_decode.cu, ragged_paged.cu).
//
// One thread block owns R query rows of ONE kv head (GQA: query head h
// reads kv head h / group, so a kv head's rows are contiguous heads)
// and sweeps key tiles of TK tokens through shared memory. Each tile:
//   1. the caller's loader fills Ks/Vs (float, zero for dead keys) with
//      16-byte global loads;
//   2. scores S[r][t] = scale * <Q[r], K[t]>, masked to -1e30;
//   3. per-row online softmax update (m, l, corr) in float32;
//   4. acc[r][d] = acc * corr + sum_t P[r][t] * V[t][d] in registers.
// Only the first R_live rows are computed (the ragged kernel's query
// block may be partly past its slot's segment). Products are float32
// on CUDA cores (no tensor cores in this version). Masked keys
// contribute exactly zero probability, so a row that never sees a live
// key ends with l == 0 and acc == 0, and the 1e-30 floor on the
// denominator turns it into exact zeros.
//
// Quantized pools (int8 or fp8 e4m3 values, one float32 scale per
// (key row, kv head)) go through load_kv_quant instead of load_kv: the
// same 16-byte loads, now 16 values each, converted to float and
// multiplied by the row's scale, exactly `float(q) * s` as the plain
// version dequantizes. The tile in shared memory is float32 either way,
// so everything after the load is shared.

#pragma once

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_fp8.h>
#include <stdint.h>
#include <type_traits>

namespace rtt {

constexpr float kMask = -1e30f;
constexpr int kTK = 64;          // keys per tile
constexpr int kMaxAcc = 32;      // accumulator slots per thread
constexpr int kMaxD = 256;       // head dims the kernels take: D % 8 == 0

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ float to_f(__half x) { return __half2float(x); }
__device__ __forceinline__ float to_f(int8_t x) { return (float)x; }
__device__ __forceinline__ float to_f(__nv_fp8_e4m3 x) { return static_cast<float>(x); }

// Page-pool element types that carry a scale pool beside them.
template <typename TP> struct IsQuant : std::false_type {};
template <> struct IsQuant<int8_t> : std::true_type {};
template <> struct IsQuant<__nv_fp8_e4m3> : std::true_type {};

template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}
template <> __device__ __forceinline__ __half from_f<__half>(float x) {
  return __float2half(x);
}

// 16 bytes of T -> floats (VEC = 16 / sizeof(T) of them).
template <typename T> struct Vec { static constexpr int N = 16 / sizeof(T); };

template <typename T>
__device__ __forceinline__ void load16(const T* __restrict__ p, float* out) {
  const uint4 raw = *reinterpret_cast<const uint4*>(p);
  const T* x = reinterpret_cast<const T*>(&raw);
#pragma unroll
  for (int i = 0; i < Vec<T>::N; ++i) out[i] = to_f(x[i]);
}

// Shared-memory carve-up for R rows, head dim D. K rows are padded to
// D + 4 floats: 16-byte aligned and conflict-free for float4 reads of
// neighbouring rows.
struct TileSmem {
  float* Q;      // [R][D]
  float* K;      // [TK][D + 4]
  float* V;      // [TK][D]
  float* S;      // [R][TK]
  float* m;      // [R]
  float* l;      // [R]
  float* corr;   // [R]
  float* ks;     // [TK] dequant scale of each key row (quantized pools)
  float* vs;     // [TK]
  long long* base;  // [TK] element offset of each key row (-1: dead)
};

__host__ __device__ inline size_t tile_smem_bytes(int R, int D) {
  return sizeof(float) * ((size_t)R * D + (size_t)kTK * (D + 4) +
                          (size_t)kTK * D + (size_t)R * kTK + 3 * (size_t)R +
                          2 * (size_t)kTK) +
         sizeof(long long) * kTK;
}

__device__ inline TileSmem carve(char* raw, int R, int D) {
  TileSmem s;
  // the int64 offsets go first so they stay 8-byte aligned; every float
  // array after them starts 16-byte aligned (R * D and TK * (D + 4) are
  // multiples of 4)
  s.base = reinterpret_cast<long long*>(raw);
  float* f = reinterpret_cast<float*>(raw + sizeof(long long) * kTK);
  s.Q = f; f += (size_t)R * D;
  s.K = f; f += (size_t)kTK * (D + 4);
  s.V = f; f += (size_t)kTK * D;
  s.S = f; f += (size_t)R * kTK;
  s.m = f; f += R;
  s.l = f; f += R;
  s.corr = f; f += R;
  s.ks = f; f += kTK;
  s.vs = f;
  return s;
}

__device__ __forceinline__ void init_state(const TileSmem& s, int R,
                                           float* acc) {
  for (int r = threadIdx.x; r < R; r += blockDim.x) {
    s.m[r] = kMask;
    s.l[r] = 0.f;
  }
#pragma unroll
  for (int i = 0; i < kMaxAcc; ++i) acc[i] = 0.f;
}

// Fill K/V rows of the tile from the element offsets in s.base (set by
// the caller, -1 for a dead key), 16 bytes per thread per load. Offsets
// and D are multiples of the vector width (the wrappers check the
// tensors' alignment).
template <typename T>
__device__ __forceinline__ void load_kv(const TileSmem& s,
                                        const T* __restrict__ k,
                                        const T* __restrict__ v, int D) {
  constexpr int N = Vec<T>::N;
  const int per_row = D / N;
  for (int idx = threadIdx.x; idx < kTK * per_row; idx += blockDim.x) {
    const int t = idx / per_row, c = (idx - t * per_row) * N;
    const long long b = s.base[t];
    float kx[N], vx[N];
    if (b >= 0) {
      load16(k + b + c, kx);
      load16(v + b + c, vx);
    } else {
#pragma unroll
      for (int i = 0; i < N; ++i) kx[i] = vx[i] = 0.f;
    }
    float* kd = s.K + (size_t)t * (D + 4) + c;
    float* vd = s.V + (size_t)t * D + c;
#pragma unroll
    for (int i = 0; i < N; i += 4) {
      *reinterpret_cast<float4*>(kd + i) =
          make_float4(kx[i], kx[i + 1], kx[i + 2], kx[i + 3]);
      *reinterpret_cast<float4*>(vd + i) =
          make_float4(vx[i], vx[i + 1], vx[i + 2], vx[i + 3]);
    }
  }
}

// Fill K/V rows of the tile from quantized pools: one-byte values
// [rows, KVH, D] (16 per 16-byte load) and float32 scales [rows, KVH].
// The key row at element offset b has its scale at b / D: one 4-byte
// load per key row, staged in s.ks/s.vs before the value loads. Dead
// keys load as 0. Contains a __syncthreads(): call it from uniform
// control flow.
template <typename TP>
__device__ __forceinline__ void load_kv_quant(const TileSmem& s,
                                              const TP* __restrict__ k,
                                              const TP* __restrict__ v,
                                              const float* __restrict__ ksc,
                                              const float* __restrict__ vsc,
                                              int D) {
  static_assert(sizeof(TP) == 1, "quantized pools hold one-byte values");
  for (int t = threadIdx.x; t < kTK; t += blockDim.x) {
    const long long b = s.base[t];
    s.ks[t] = b >= 0 ? ksc[b / D] : 0.f;
    s.vs[t] = b >= 0 ? vsc[b / D] : 0.f;
  }
  __syncthreads();
  constexpr int N = 16;
  const int per_row = D / N;
  for (int idx = threadIdx.x; idx < kTK * per_row; idx += blockDim.x) {
    const int t = idx / per_row, c = (idx - t * per_row) * N;
    const long long b = s.base[t];
    float kx[N], vx[N];
    if (b >= 0) {
      load16(k + b + c, kx);
      load16(v + b + c, vx);
      const float sk = s.ks[t], sv = s.vs[t];
#pragma unroll
      for (int i = 0; i < N; ++i) {
        kx[i] = __fmul_rn(kx[i], sk);   // no contraction into a later FMA
        vx[i] = __fmul_rn(vx[i], sv);
      }
    } else {
#pragma unroll
      for (int i = 0; i < N; ++i) kx[i] = vx[i] = 0.f;
    }
    float* kd = s.K + (size_t)t * (D + 4) + c;
    float* vd = s.V + (size_t)t * D + c;
#pragma unroll
    for (int i = 0; i < N; i += 4) {
      *reinterpret_cast<float4*>(kd + i) =
          make_float4(kx[i], kx[i + 1], kx[i + 2], kx[i + 3]);
      *reinterpret_cast<float4*>(vd + i) =
          make_float4(vx[i], vx[i + 1], vx[i + 2], vx[i + 3]);
    }
  }
}

// Page-pool loads: load_kv for pools in the query's type, load_kv_quant
// for int8/fp8 pools with their scale pools (null otherwise).
template <typename TP>
__device__ __forceinline__ void load_pages(const TileSmem& s,
                                           const TP* __restrict__ k,
                                           const TP* __restrict__ v,
                                           const float* __restrict__ ksc,
                                           const float* __restrict__ vsc,
                                           int D) {
  if constexpr (IsQuant<TP>::value) {
    load_kv_quant(s, k, v, ksc, vsc, D);
  } else {
    load_kv(s, k, v, D);
  }
}

// Scores, softmax update and PV accumulation for one loaded tile, for
// rows [0, R_live). live(r, t) says whether row r may attend key t.
template <typename Live>
__device__ __forceinline__ void attend_tile(const TileSmem& s, int R_live,
                                            int D, float scale, Live live,
                                            float* acc) {
  for (int idx = threadIdx.x; idx < R_live * kTK; idx += blockDim.x) {
    const int r = idx / kTK, t = idx - r * kTK;
    float sc = kMask;
    if (live(r, t)) {
      const float4* qr = reinterpret_cast<const float4*>(s.Q + (size_t)r * D);
      const float4* kr =
          reinterpret_cast<const float4*>(s.K + (size_t)t * (D + 4));
      float dot = 0.f;
      for (int d = 0; d < D / 4; ++d) {
        const float4 a = qr[d], b = kr[d];
        dot = fmaf(a.x, b.x, dot);
        dot = fmaf(a.y, b.y, dot);
        dot = fmaf(a.z, b.z, dot);
        dot = fmaf(a.w, b.w, dot);
      }
      sc = dot * scale;
    }
    s.S[idx] = sc;
  }
  __syncthreads();
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int nwarp = blockDim.x >> 5;
  for (int r = warp; r < R_live; r += nwarp) {
    float* row = s.S + (size_t)r * kTK;
    float mt = kMask;
    for (int t = lane; t < kTK; t += 32) mt = fmaxf(mt, row[t]);
#pragma unroll
    for (int o = 16; o > 0; o >>= 1)
      mt = fmaxf(mt, __shfl_xor_sync(0xffffffffu, mt, o));
    const float m_prev = s.m[r];
    const float m_new = fmaxf(m_prev, mt);
    float sum = 0.f;
    for (int t = lane; t < kTK; t += 32) {
      const float x = row[t];
      const float p = (x > 0.5f * kMask) ? expf(x - m_new) : 0.f;
      row[t] = p;
      sum += p;
    }
#pragma unroll
    for (int o = 16; o > 0; o >>= 1)
      sum += __shfl_xor_sync(0xffffffffu, sum, o);
    if (lane == 0) {
      const float c = expf(m_prev - m_new);
      s.corr[r] = c;
      s.l[r] = s.l[r] * c + sum;
      s.m[r] = m_new;
    }
  }
  __syncthreads();
#pragma unroll
  for (int i = 0; i < kMaxAcc; ++i) {
    const int idx = threadIdx.x + i * blockDim.x;
    if (idx < R_live * D) {
      const int r = idx / D, d = idx - r * D;
      const float* p = s.S + (size_t)r * kTK;
      float a = acc[i] * s.corr[r];
      for (int t = 0; t < kTK; ++t) a = fmaf(p[t], s.V[t * D + d], a);
      acc[i] = a;
    }
  }
  __syncthreads();
}

}  // namespace rtt
