// Ragged paged attention for one layer: one program for a flat batch
// mixing decode rows (1 token) and prefill chunks (C tokens).
//
// Replaces the TPU kernel `_ragged_paged_kernel`
// (ray_tpu/ops/ragged_paged_attention.py), reached by
// `ragged_paged_attention_pallas`. Token i of slot b (offset i in the
// slot's segment, absolute position start[b] + i) attends
//   - the slot's cached context, positions c < start[b], streamed from
//     the page pool through the slot's page table;
//   - the slot's in-batch keys j with j <= i and j < q_len[b].
//
// What bounds it on an H100: for decode rows and short chunks, bytes
// (every context page is read once per (slot, q block, kv head));
// for long prefill chunks over long contexts, operations, here float32
// CUDA-core products (no tensor cores in this first version).
//
// Design: instead of the TPU wrapper's per-slot repack into padded
// [B, C] staging arrays, the wrapper builds one [B, max_seg] map from
// (slot, offset) to the flat token index, once per tick; the kernel
// reads queries and new keys through it and writes outputs back
// through it. One block per (slot, q block, kv head) holds q_blk
// tokens x group heads as rows (computing only the rows of tokens the
// slot has: a decode row's block does 1/q_blk of a full block's work),
// sweeps the slot's context pages in 64-key tiles of 16-byte loads
// (stopping at the slot's own last page), then its own
// in-batch keys up to the causal diagonal of the block, with the
// online-softmax state in float32 (row max and denominator in shared
// memory, the accumulator in registers). No state crosses blocks. An
// extra column of blocks (blockIdx.x == B) writes exact zeros into the
// rows of invalid (padding) tokens, so the output needs no memset.
//
// Quantized pools (the `quantized=True` branch of the TPU kernel: int8
// or fp8 e4m3 pages with per-(row, kv head) float32 scale pools): the
// kernel is templated on the pool type TP apart from the query type T;
// the context sweep's page loads dequantize as they fill the tile
// (`load_kv_quant`, one extra 4-byte scale load per key row), so the
// context bytes fall to (D + 4) per (key, kv head). The in-batch keys
// (k_new/v_new) stay in T and are never quantized.

#include "flash_tile.cuh"

using namespace rtt;

template <typename T, typename TP>
__global__ void ragged_paged_kernel(
    const T* __restrict__ q, const TP* __restrict__ k_pages,
    const TP* __restrict__ v_pages, const float* __restrict__ k_scales,
    const float* __restrict__ v_scales, const int* __restrict__ tables,
    const int* __restrict__ start, const int* __restrict__ qlens,
    const int* __restrict__ tok_idx, const unsigned char* __restrict__ valid,
    const T* __restrict__ k_new, const T* __restrict__ v_new,
    T* __restrict__ out, int T_tokens, int B, int H, int KVH, int D,
    int page_size, int table_stride, int n_ctx_pages, int max_seg, int q_blk,
    float scale) {
  extern __shared__ __align__(16) char smem_raw[];
  const int b = blockIdx.x, qb = blockIdx.y, kvh = blockIdx.z;
  if (b == B) {
    // zero the padding rows, spread over the extra column's blocks
    const int rank = qb * gridDim.z + kvh;
    const int nblk = gridDim.y * gridDim.z;
    const int row = H * D;
    for (int t = rank; t < T_tokens; t += nblk) {
      if (valid[t]) continue;
      T* o = out + (size_t)t * row;
      for (int idx = threadIdx.x; idx < row; idx += blockDim.x)
        o[idx] = from_f<T>(0.f);
    }
    return;
  }
  int qlen = qlens[b];
  qlen = qlen < max_seg ? qlen : max_seg;
  const int i0 = qb * q_blk;
  if (i0 >= qlen) return;            // no live query in this block
  const int group = H / KVH;
  const int R = q_blk * group;       // row r: token i0 + r / group
  // rows of tokens past the segment are never computed
  const int R_live = min(q_blk, qlen - i0) * group;
  TileSmem s = carve(smem_raw, R, D);
  float acc[kMaxAcc];
  init_state(s, R, acc);
  const int* tmap = tok_idx + (size_t)b * max_seg;

  for (int idx = threadIdx.x; idx < R * D; idx += blockDim.x) {
    int r = idx / D, d = idx - r * D;
    int i = i0 + r / group;
    float x = 0.f;
    int tok = i < qlen ? tmap[i] : -1;
    if (tok >= 0) {
      int h = kvh * group + r % group;
      x = to_f(q[((size_t)tok * H + h) * D + d]);
    }
    s.Q[idx] = x;
  }

  int ctx = start[b];
  const int cap = n_ctx_pages * page_size;
  ctx = ctx < cap ? ctx : cap;
  const int* table = tables + (size_t)b * table_stride;
  const long long row_stride = (long long)KVH * D;

  // cached context: every row sees positions < start[b]
  for (int t0 = 0; t0 < ctx; t0 += kTK) {
    for (int t = threadIdx.x; t < kTK; t += blockDim.x) {
      long long off = -1;
      int pos = t0 + t;
      if (pos < ctx) {
        long long page = table[pos / page_size];
        off = (page * page_size + pos % page_size) * row_stride +
              (long long)kvh * D;
      }
      s.base[t] = off;
    }
    __syncthreads();
    load_pages(s, k_pages, v_pages, k_scales, v_scales, D);
    __syncthreads();
    const int n_live = ctx - t0 < kTK ? ctx - t0 : kTK;
    attend_tile(s, R_live, D, scale, [&](int, int t) { return t < n_live; },
                acc);
  }

  // in-batch keys: block-diagonal causal, j <= i and j < q_len
  const int i_last = (i0 + q_blk < qlen ? i0 + q_blk : qlen);  // exclusive
  for (int j0 = 0; j0 < i_last; j0 += kTK) {
    for (int t = threadIdx.x; t < kTK; t += blockDim.x) {
      int j = j0 + t;
      int tok = j < i_last ? tmap[j] : -1;
      s.base[t] = tok >= 0 ? ((long long)tok * KVH + kvh) * D : -1;
    }
    __syncthreads();
    load_kv(s, k_new, v_new, D);
    __syncthreads();
    attend_tile(s, R_live, D, scale,
                [&](int r, int t) {
                  int i = i0 + r / group, j = j0 + t;
                  return j <= i && j < qlen;
                },
                acc);
  }

#pragma unroll
  for (int a = 0; a < kMaxAcc; ++a) {
    int idx = threadIdx.x + a * blockDim.x;
    if (idx < R * D) {
      int r = idx / D, d = idx - r * D;
      int i = i0 + r / group;
      int tok = i < qlen ? tmap[i] : -1;
      if (tok >= 0) {
        int h = kvh * group + r % group;
        out[((size_t)tok * H + h) * D + d] =
            from_f<T>(acc[a] / fmaxf(s.l[r], 1e-30f));
      }
    }
  }
}

static constexpr int kThreads = 256;

template <typename T, typename TP>
static int launch(const void* q, const void* k_pages, const void* v_pages,
                  const void* k_scales, const void* v_scales,
                  const void* tables, const void* start, const void* qlens,
                  const void* tok_idx, const void* valid, const void* k_new,
                  const void* v_new, void* out, int T_tokens, int B, int H,
                  int KVH, int D, int page_size, int table_stride,
                  int n_ctx_pages, int max_seg, int q_blk,
                  cudaStream_t stream) {
  const int R = q_blk * (H / KVH);
  const size_t smem = tile_smem_bytes(R, D);
  cudaError_t err = cudaFuncSetAttribute(
      ragged_paged_kernel<T, TP>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const int nq = (max_seg + q_blk - 1) / q_blk;
  dim3 grid(B + 1, nq, KVH);
  ragged_paged_kernel<T, TP><<<grid, kThreads, smem, stream>>>(
      (const T*)q, (const TP*)k_pages, (const TP*)v_pages,
      (const float*)k_scales, (const float*)v_scales, (const int*)tables,
      (const int*)start, (const int*)qlens, (const int*)tok_idx,
      (const unsigned char*)valid, (const T*)k_new, (const T*)v_new, (T*)out,
      T_tokens, B, H, KVH, D, page_size, table_stride, n_ctx_pages, max_seg,
      q_blk, 1.0f / sqrtf((float)D));
  return (int)cudaGetLastError();
}

// The pool types for one query type T: kv_kind 0 pools in T, 1 int8,
// 2 fp8 e4m3 (with scale pools).
template <typename T>
static int launch_kind(int kv_kind, const void* q, const void* k_pages,
                       const void* v_pages, const void* k_scales,
                       const void* v_scales, const void* tables,
                       const void* start, const void* qlens,
                       const void* tok_idx, const void* valid,
                       const void* k_new, const void* v_new, void* out,
                       int T_tokens, int B, int H, int KVH, int D,
                       int page_size, int table_stride, int n_ctx_pages,
                       int max_seg, int q_blk, cudaStream_t stream) {
#define RTT_RAGGED_ARGS                                                     \
  q, k_pages, v_pages, k_scales, v_scales, tables, start, qlens, tok_idx,   \
      valid, k_new, v_new, out, T_tokens, B, H, KVH, D, page_size,          \
      table_stride, n_ctx_pages, max_seg, q_blk, stream
  switch (kv_kind) {
    case 0: return launch<T, T>(RTT_RAGGED_ARGS);
    case 1: return launch<T, int8_t>(RTT_RAGGED_ARGS);
    case 2: return launch<T, __nv_fp8_e4m3>(RTT_RAGGED_ARGS);
  }
#undef RTT_RAGGED_ARGS
  return -1;
}

// dtype: 0 float32, 1 bfloat16, 2 float16 (q, out, k_new, v_new).
// kv_kind: 0 pools in q's dtype (scales null), 1 int8 and 2 fp8 e4m3
// pools with float32 k_scales/v_scales [P, page, KVH] (D % 16 == 0).
// valid is one byte per token (torch.bool). Returns cudaGetLastError()
// after the launch (0 = launched); -1 for arguments the kernel does not
// take.
extern "C" int ragged_paged_launch(
    const void* q, const void* k_pages, const void* v_pages,
    const void* k_scales, const void* v_scales, const void* tables,
    const void* start, const void* qlens, const void* tok_idx,
    const void* valid, const void* k_new, const void* v_new, void* out,
    int T_tokens, int B, int H, int KVH, int D, int page_size,
    int table_stride, int n_ctx_pages, int max_seg, int q_blk, int dtype,
    int kv_kind, void* stream) {
  if (KVH <= 0 || H % KVH != 0 || q_blk < 1 || max_seg < 1 || D % 8 != 0 ||
      D > kMaxD)
    return -1;
  if (q_blk * (H / KVH) * D > kThreads * kMaxAcc) return -1;
  if (kv_kind < 0 || kv_kind > 2) return -1;
  if ((kv_kind != 0) != (k_scales != nullptr) ||
      (k_scales == nullptr) != (v_scales == nullptr))
    return -1;
  if (kv_kind != 0 && D % 16 != 0) return -1;
  if (T_tokens == 0) return 0;
  cudaStream_t st = (cudaStream_t)stream;
#define RTT_RAGGED_ARGS                                                     \
  kv_kind, q, k_pages, v_pages, k_scales, v_scales, tables, start, qlens,   \
      tok_idx, valid, k_new, v_new, out, T_tokens, B, H, KVH, D, page_size, \
      table_stride, n_ctx_pages, max_seg, q_blk, st
  switch (dtype) {
    case 0: return launch_kind<float>(RTT_RAGGED_ARGS);
    case 1: return launch_kind<__nv_bfloat16>(RTT_RAGGED_ARGS);
    case 2: return launch_kind<__half>(RTT_RAGGED_ARGS);
  }
#undef RTT_RAGGED_ARGS
  return -1;
}
