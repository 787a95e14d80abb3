// Paged decode attention for one layer: one query token per sequence
// over that sequence's cached KV pages.
//
// Replaces the TPU kernels `_paged_decode_kernel_mp` and
// `_paged_decode_kernel` (ray_tpu/ops/paged_attention.py), reached by
// `paged_decode_attention`. On the TPU the two differ only in how many
// pages one grid step streams (16 or 1), which mattered for the TPU's
// per-grid-step overhead; here one kernel serves every table width.
//
// What bounds it on an H100: bytes. Each (sequence, kv head) reads its
// cached K and V once (2 * len * D * itemsize) for about 4 * group * D
// flops per key, far below the ~295 flop/byte ridge. So the design is
// about keeping enough loads in flight:
//   - split-K: the context of each sequence is cut into chunks of
//     `split_tokens` keys, one block per (sequence, kv head, chunk), so
//     a batch of a few long sequences still fills the card; a block
//     whose chunk starts past its sequence's length exits at once (the
//     decode tick passes the full-width table, and no work is spent
//     past each sequence's own last page);
//   - each block stages 64-key tiles of K and V through shared memory
//     with 16-byte loads, page ids read from the table in the kernel,
//     and keeps its online-softmax state in float32 (row max and
//     denominator in shared memory, accumulator in registers);
//   - a combine kernel merges the chunks' (m, l, acc) per row. Blocks
//     run in any order; nothing crosses blocks except through the
//     partials the combine reads.
// Sequences with seq_len 0 attend one key, as the multi-page TPU kernel
// does (`length = max(seq_len, 1)`).
//
// With k_new/v_new given, the current token's KV (not yet in the pages)
// is merged as one more always-live key by chunk 0:
// `paged_decode_with_new_token` in one call.
//
// Quantized pools (the `quantized=True` branch of both TPU kernels:
// int8 or fp8 e4m3 pages with per-(row, kv head) float32 scale pools):
// the kernel is templated on the pool type TP apart from the query type
// T, and the page loads dequantize as they fill the tile
// (`load_kv_quant`: 16 one-byte values a load, times the row's scale,
// one extra 4-byte load per key row). The bytes that bound the kernel
// fall from 2 * D * itemsize to 2 * (D + 4) per (key, kv head): 132
// against 256 bytes at D = 128 in bf16. The new token's KV stays in T.

#include "flash_tile.cuh"

using namespace rtt;

struct DecodeArgs {
  const float* k_scales;  // [P, page, KVH] for quantized pools, else null
  const float* v_scales;
  const int* tables;
  const int* seq_lens;
  float* m_out;        // [B, H] or null
  float* l_out;
  float* part_m;       // [B, H, S] chunk partials (S > 1)
  float* part_l;
  float* part_acc;     // [B, H, S, D]
  int H, KVH, D, page_size, max_pages, split_tokens;
  float scale;
};

__device__ __forceinline__ int seq_length(const DecodeArgs& a, int b) {
  int length = a.seq_lens[b];
  length = length < 1 ? 1 : length;
  const int cap = a.max_pages * a.page_size;
  return length < cap ? length : cap;
}

template <typename T, typename TP>
__global__ void paged_decode_kernel(const T* __restrict__ q,
                                    const TP* __restrict__ k_pages,
                                    const TP* __restrict__ v_pages,
                                    const T* __restrict__ k_new,
                                    const T* __restrict__ v_new,
                                    T* __restrict__ out, DecodeArgs a) {
  extern __shared__ __align__(16) char smem_raw[];
  const int b = blockIdx.x, kvh = blockIdx.y, split = blockIdx.z;
  const int S = gridDim.z;
  const int D = a.D;
  const int group = a.H / a.KVH;
  const int R = group;
  const int length = seq_length(a, b);
  const int k0 = split * a.split_tokens;
  if (k0 >= length) return;           // chunk past this sequence's end
  const int k1 = min(length, k0 + a.split_tokens);

  TileSmem s = carve(smem_raw, R, D);
  float acc[kMaxAcc];
  init_state(s, R, acc);
  // this kv head's query rows: heads kvh*group .. kvh*group + group - 1
  const T* qb = q + ((size_t)b * a.H + (size_t)kvh * group) * D;
  for (int idx = threadIdx.x; idx < R * D; idx += blockDim.x)
    s.Q[idx] = to_f(qb[idx]);

  const int* table = a.tables + (size_t)b * a.max_pages;
  const long long row_stride = (long long)a.KVH * D;
  const int n_tiles = (k1 - k0 + kTK - 1) / kTK;
  const bool with_new = k_new != nullptr && split == 0;
  const int total = n_tiles + (with_new ? 1 : 0);

  for (int tile = 0; tile < total; ++tile) {
    const bool new_tile = tile == n_tiles;
    const int t0 = k0 + tile * kTK;
    for (int t = threadIdx.x; t < kTK; t += blockDim.x) {
      long long off = -1;
      if (new_tile) {
        if (t == 0) off = ((long long)b * a.KVH + kvh) * D;
      } else if (t0 + t < k1) {
        const int pos = t0 + t;
        const long long page = table[pos / a.page_size];
        off = (page * a.page_size + pos % a.page_size) * row_stride +
              (long long)kvh * D;
      }
      s.base[t] = off;
    }
    __syncthreads();
    if (new_tile) {
      load_kv(s, k_new, v_new, D);
    } else {
      load_pages(s, k_pages, v_pages, a.k_scales, a.v_scales, D);
    }
    __syncthreads();
    const int n_live = new_tile ? 1 : min(kTK, k1 - t0);
    attend_tile(s, R, D, a.scale, [&](int, int t) { return t < n_live; },
                acc);
  }

  const size_t row0 = (size_t)b * a.H + (size_t)kvh * group;
  if (S == 1) {
    T* ob = out + row0 * D;
#pragma unroll
    for (int i = 0; i < kMaxAcc; ++i) {
      const int idx = threadIdx.x + i * blockDim.x;
      if (idx < R * D)
        ob[idx] = from_f<T>(acc[i] / fmaxf(s.l[idx / D], 1e-30f));
    }
    if (a.m_out != nullptr) {
      for (int r = threadIdx.x; r < R; r += blockDim.x) {
        a.m_out[row0 + r] = s.m[r];
        a.l_out[row0 + r] = s.l[r];
      }
    }
    return;
  }
#pragma unroll
  for (int i = 0; i < kMaxAcc; ++i) {
    const int idx = threadIdx.x + i * blockDim.x;
    if (idx < R * D) {
      const int r = idx / D, d = idx - r * D;
      a.part_acc[((row0 + r) * S + split) * D + d] = acc[i];
    }
  }
  for (int r = threadIdx.x; r < R; r += blockDim.x) {
    a.part_m[(row0 + r) * S + split] = s.m[r];
    a.part_l[(row0 + r) * S + split] = s.l[r];
  }
}

// Merge the live chunks of each (sequence, head) row: one block per
// (sequence, head), threads over d.
template <typename T>
__global__ void paged_decode_combine(T* __restrict__ out, DecodeArgs a,
                                     int S) {
  const int b = blockIdx.x, h = blockIdx.y;
  const int D = a.D;
  const int length = seq_length(a, b);
  const int live = (length + a.split_tokens - 1) / a.split_tokens;
  const size_t row = (size_t)b * a.H + h;
  const float* pm = a.part_m + row * S;
  const float* pl = a.part_l + row * S;
  float m = kMask;
  for (int s = 0; s < live; ++s) m = fmaxf(m, pm[s]);
  float l = 0.f;
  for (int s = 0; s < live; ++s) l = fmaf(pl[s], expf(pm[s] - m), l);
  for (int d = threadIdx.x; d < D; d += blockDim.x) {
    float acc = 0.f;
    for (int s = 0; s < live; ++s)
      acc = fmaf(a.part_acc[(row * S + s) * D + d], expf(pm[s] - m), acc);
    out[row * D + d] = from_f<T>(acc / fmaxf(l, 1e-30f));
  }
  if (threadIdx.x == 0 && a.m_out != nullptr) {
    a.m_out[row] = m;
    a.l_out[row] = l;
  }
}

static constexpr int kThreads = 128;

template <typename T, typename TP>
static int launch(const void* q, const void* k_pages, const void* v_pages,
                  const void* k_new, const void* v_new, void* out,
                  DecodeArgs a, int B, int S, cudaStream_t stream) {
  const int R = a.H / a.KVH;
  const size_t smem = tile_smem_bytes(R, a.D);
  cudaError_t err = cudaFuncSetAttribute(
      paged_decode_kernel<T, TP>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid(B, a.KVH, S);
  paged_decode_kernel<T, TP><<<grid, kThreads, smem, stream>>>(
      (const T*)q, (const TP*)k_pages, (const TP*)v_pages, (const T*)k_new,
      (const T*)v_new, (T*)out, a);
  err = cudaGetLastError();
  if (err != cudaSuccess || S == 1) return (int)err;
  paged_decode_combine<T><<<dim3(B, a.H), 128, 0, stream>>>((T*)out, a, S);
  return (int)cudaGetLastError();
}

// The pool types for one query type T: kv_kind 0 pools in T, 1 int8,
// 2 fp8 e4m3 (with scale pools).
template <typename T>
static int launch_kind(int kv_kind, const void* q, const void* k_pages,
                       const void* v_pages, const void* k_new,
                       const void* v_new, void* out, DecodeArgs a, int B,
                       int S, cudaStream_t stream) {
  switch (kv_kind) {
    case 0:
      return launch<T, T>(q, k_pages, v_pages, k_new, v_new, out, a, B, S,
                          stream);
    case 1:
      return launch<T, int8_t>(q, k_pages, v_pages, k_new, v_new, out, a, B,
                               S, stream);
    case 2:
      return launch<T, __nv_fp8_e4m3>(q, k_pages, v_pages, k_new, v_new, out,
                                      a, B, S, stream);
  }
  return -1;
}

// dtype: 0 float32, 1 bfloat16, 2 float16 (q, out, k_new, v_new).
// kv_kind: 0 pools in q's dtype (scales null), 1 int8 and 2 fp8 e4m3
// pools with float32 k_scales/v_scales [P, page, KVH] (D % 16 == 0).
// k_new/v_new and m/l may be null. With n_splits > 1 the context is cut
// into chunks of split_tokens keys (n_splits * split_tokens must cover
// max_pages * page_size) and part_m/part_l [B, H, n_splits] and
// part_acc [B, H, n_splits, D] float32 scratch must be given. Returns
// cudaGetLastError() after the launches (0 = launched); -1 for
// arguments the kernel does not take.
extern "C" int paged_decode_launch(
    const void* q, const void* k_pages, const void* v_pages,
    const void* k_scales, const void* v_scales, const void* tables,
    const void* seq_lens, const void* k_new, const void* v_new, void* out,
    void* m, void* l, void* part_m, void* part_l, void* part_acc, int B,
    int H, int KVH, int D, int page_size, int max_pages, int split_tokens,
    int n_splits, int dtype, int kv_kind, void* stream) {
  if (KVH <= 0 || H % KVH != 0 || D % 8 != 0 || D > kMaxD ||
      (H / KVH) * D > kThreads * kMaxAcc)
    return -1;
  if ((m == nullptr) != (l == nullptr)) return -1;
  if ((k_new == nullptr) != (v_new == nullptr)) return -1;
  if (kv_kind < 0 || kv_kind > 2) return -1;
  if ((kv_kind != 0) != (k_scales != nullptr) ||
      (k_scales == nullptr) != (v_scales == nullptr))
    return -1;
  if (kv_kind != 0 && D % 16 != 0) return -1;
  if (n_splits < 1 || split_tokens < 1 ||
      (long long)n_splits * split_tokens < (long long)max_pages * page_size)
    return -1;
  if (n_splits > 1 &&
      (part_m == nullptr || part_l == nullptr || part_acc == nullptr))
    return -1;
  if (B == 0) return 0;
  DecodeArgs a;
  a.k_scales = (const float*)k_scales;
  a.v_scales = (const float*)v_scales;
  a.tables = (const int*)tables;
  a.seq_lens = (const int*)seq_lens;
  a.m_out = (float*)m;
  a.l_out = (float*)l;
  a.part_m = (float*)part_m;
  a.part_l = (float*)part_l;
  a.part_acc = (float*)part_acc;
  a.H = H; a.KVH = KVH; a.D = D;
  a.page_size = page_size; a.max_pages = max_pages;
  a.split_tokens = split_tokens;
  a.scale = 1.0f / sqrtf((float)D);
  cudaStream_t st = (cudaStream_t)stream;
  switch (dtype) {
    case 0:
      return launch_kind<float>(kv_kind, q, k_pages, v_pages, k_new, v_new,
                                out, a, B, n_splits, st);
    case 1:
      return launch_kind<__nv_bfloat16>(kv_kind, q, k_pages, v_pages, k_new,
                                        v_new, out, a, B, n_splits, st);
    case 2:
      return launch_kind<__half>(kv_kind, q, k_pages, v_pages, k_new, v_new,
                                 out, a, B, n_splits, st);
  }
  return -1;
}
