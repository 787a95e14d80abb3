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
// Instead of the TPU wrapper's per-slot repack into padded [B, C]
// staging arrays, the wrapper builds one [B, max_seg] map from (slot,
// offset) to the flat token index, once per tick (`ragged_plan`); the
// kernels read queries and new keys through it and write outputs back
// through it. Invalid (padding) rows come out exact zeros, so the
// output needs no memset.
//
// What bounds it on an H100: for decode rows and short chunks, bytes
// (each context page is read once per (slot, q tile, kv head)); for
// long prefill chunks over long contexts, operations. The first version
// (below, kept for float32 and float16 queries and the bf16 shapes the
// tensor-core kernel does not take) falls short of both:
// its products run in float32 on the CUDA cores, and one block sweeps a
// slot's whole context in a row, so a long decode row leaves most of
// the card idle while its few blocks walk ~63 tiles.
//
// Two designs, chosen by the query dtype and shape (a rule, not a
// fallback: a bf16 launch that cannot build its TMA maps returns -2 and
// the wrapper raises):
//
// bf16 queries (the serving path's dtype) with D 64 or 128, page_size
// 8, 16, 32 or 64 and group <= 64 (`rtc::takes`), on bf16, int8 or fp8
// pages: tensor cores and a split context sweep (namespace rtc).
//   - Work item = (slot, q tile, kv head, key chunk). A q tile is 64
//     rows = 64 / group tokens x the group's heads of one kv head (row r
//     <-> token r / group, head kvh * group + r % group; when group does
//     not divide 64 the last rows are padding, computed and never
//     written). A slot's keys are its context tiles (64 keys,
//     ceil(ctx / 64) of them) followed by its in-batch tiles (up to the
//     q tile's last token); a chunk is 8 such tiles (512 keys). The
//     grid (chunks, (slot, q tile) pairs, kv heads) is sized from T, B,
//     max_seg and ctx_pages, with no host sync; a block finds its pair
//     by walking q_len over the slots and exits at once when its pair or
//     chunk holds no work.
//   - One warpgroup a block. The item's page ids are read from the
//     slot's table once, into shared memory, one load a thread. The
//     first thread is the producer: it brings each context tile in
//     with TMA (a 4-D map over the layer's pool, (D, KVH, page row,
//     page); one box a page and 64-wide D region, 128-byte swizzle, or
//     for one-byte pools one unswizzled box of D bytes a page) one tile
//     ahead, through a 2-stage mbarrier ring; pages wholly past the
//     context are asked for at page index P, which TMA fills with
//     zeros. Q rows and the in-batch keys are gathered through tok_idx
//     by 16-byte loads of all threads straight into the swizzled layout.
//   - S = Q K^T is an SS wgmma (bf16, exact products, float32 sums);
//     the online softmax runs on the fragment in float32 with the -1e30
//     mask (only on tiles that cross the context's end, and on in-batch
//     tiles) and the 1e-30 floor; O += P V is an RS wgmma pair with P as
//     bf16 hi + lo (the float32 contract, as in the flash kernels) and V
//     read MN-major.
//   - Quantized pages keep the float32 contract without a dequantized
//     tile: int8 (|x| <= 127) and e4m3 values are exact in bf16, so the
//     raw tile is converted to bf16 in shared memory, unscaled, and the
//     per-(key row, kv head) scales fold into the float32 side: S's
//     column t times ks_t before the softmax, P's column t times vs_t
//     before the hi/lo split. Up to float32 rounding this is the plain
//     version's dequantize-then-dot.
//   - Tiles written by threads (converted pages, in-batch keys, Q, the
//     zeroed V rows past the context in a partial last tile) are made
//     visible to wgmma with fence.proxy.async and a barrier; TMA tiles
//     need neither.
//   - An item whose q tile has one chunk writes its rows directly
//     (acc / max(l, 1e-30)). Otherwise each item writes float32
//     partials (m, l, acc) to scratch [T, H, chunks(, D)] that the
//     wrapper allocates, and a combine kernel, one block a token, merges
//     the chunks in chunk order and zeroes the padding rows. Nothing
//     crosses blocks except through the partials, so two launches give
//     the same bits.
//
// float32 and float16 queries, and bf16 queries of any other shape
// (the `debug` preset's head_dim 32, pages of 4 rows): the first
// version. One block per (slot,
// q block, kv head) holds q_blk tokens x group heads as rows (computing
// only the rows of tokens the slot has), sweeps the slot's context pages
// in 64-key tiles of 16-byte loads (stopping at the slot's own last
// page), then its own in-batch keys up to the causal diagonal of the
// block, with the online-softmax state in float32 and products on the
// CUDA cores. An extra column of blocks (blockIdx.x == B) writes exact
// zeros into the padding rows.
//
// Quantized pools in the first version (the `quantized=True` branch of
// the TPU kernel: int8 or fp8 e4m3 pages with per-(row, kv head) float32
// scale pools): the page loads dequantize as they fill the tile
// (`load_kv_quant`, one extra 4-byte scale load per key row), so the
// context bytes fall to (D + 4) per (key, kv head). In both designs the
// in-batch keys (k_new/v_new) stay in the query's type and are never
// quantized.

#include "flash_tile.cuh"
#include "hopper_mma.cuh"

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

// ======================================= bf16 queries: the tensor cores

namespace rtc {

using hmma::align1024;
using hmma::desc_k_major;
using hmma::desc_mn_major;
using hmma::exp_ftz;
using hmma::fence_regs;
using hmma::quad_max;
using hmma::quad_sum;
using hmma::smem_u32;

constexpr int kWG = 128;            // one warpgroup a block
constexpr int kM = 64;              // rows of a work item
constexpr int kN = 64;              // keys a tile
constexpr int kChunkTiles = 8;      // tiles a key chunk (512 keys)
constexpr int kRegion = 64 * 128;   // bytes of one 64-wide D region of a 64-row tile
constexpr int kTmaError = -2;
constexpr int kMaxPages = kChunkTiles * kN / 8;   // an item's pages (page_size >= 8)

// The shapes this kernel takes: D in 64-wide swizzled regions, pages of
// whole 8-row swizzle atoms that tile 64 keys, a group that fits a q
// tile. bf16 queries of any other shape run the first kernel's bf16
// instance (`ragged_paged_launch`; `tc_takes` in the wrapper says the
// same).
inline bool takes(int D, int group, int page_size) {
  return (D == 64 || D == 128) && group <= kM &&
         (page_size == 8 || page_size == 16 || page_size == 32 ||
          page_size == 64);
}

struct Args {
  const int* tables;
  const int* start;
  const int* qlens;
  const int* tok_idx;
  const unsigned char* valid;
  const int* slot_ids;
  const int* positions;
  const float* k_scales;            // [P, page, KVH] for one-byte pools
  const float* v_scales;
  const __nv_bfloat16* q;
  const __nv_bfloat16* k_new;
  const __nv_bfloat16* v_new;
  __nv_bfloat16* out;
  float* part_m;                    // [T, H, n_chunks] when n_chunks > 1
  float* part_l;
  float* part_acc;                  // [T, H, n_chunks, D]
  int T, B, H, KVH, page_size, table_stride, n_ctx_pages, max_seg,
      num_pages;
  int tpt;                          // tokens of a q tile: 64 / group
  int n_chunks;                     // chunks the grid (and scratch) holds
  float scale;
};

__device__ __forceinline__ int slot_ctx(const Args& a, int b) {
  return min(a.start[b], a.n_ctx_pages * a.page_size);
}
__device__ __forceinline__ int slot_qlen(const Args& a, int b) {
  return min(a.qlens[b], a.max_seg);
}
// key tiles seen by the q tile that starts at token i0: the context's,
// then the in-batch keys' up to the tile's last token
__device__ __forceinline__ int item_tiles(const Args& a, int ctx, int qlen,
                                          int i0) {
  const int i_last = min(i0 + a.tpt, qlen);
  return (ctx + kN - 1) / kN + (i_last + kN - 1) / kN;
}

// shared memory: Q [64][D] bf16; the K, V tiles in bf16 (two stages for
// bf16 pools, written by TMA; one for one-byte pools, written by the
// conversion); for one-byte pools two stages of raw K, V [64][D] bytes
// and the tile's scales; the page ids of the item's context; the two
// "full" barriers
template <typename TP, int D> struct Smem {
  static constexpr bool kQuant = IsQuant<TP>::value;
  static constexpr uint32_t kQ = kM * D * 2, kKV = kN * D * 2, kRaw = kN * D;
  static constexpr int kKVStages = kQuant ? 1 : 2;
  static constexpr int kRawStages = kQuant ? 2 : 0;
  static constexpr uint32_t kKVOff = kQ;
  static constexpr uint32_t kRawOff = kKVOff + kKVStages * 2 * kKV;
  static constexpr uint32_t kScOff = kRawOff + kRawStages * 2 * kRaw;
  static constexpr uint32_t kPgOff = kScOff + (kQuant ? 2 * kN * 4 : 0);
  static constexpr uint32_t kBars = kPgOff + kMaxPages * 4;
  static constexpr size_t kBytes = kBars + 2 * 8 + 1024;
};

// bf16 16-byte chunk `ch` of row r of a swizzled 64-row tile
__device__ __forceinline__ uint32_t sw_off(int r, int ch) {
  return (ch / 8) * kRegion + r * 128 + (((ch % 8) ^ (r % 8)) * 16);
}

// two pool values -> a bf16 pair, exactly (int8 |x| <= 127 and e4m3
// values are bf16 values)
template <typename TP> __device__ __forceinline__ uint32_t cvt2(uint32_t two);
template <> __device__ __forceinline__ uint32_t cvt2<int8_t>(uint32_t two) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(
      (float)(int8_t)(two & 0xff), (float)(int8_t)((two >> 8) & 0xff));
  return *reinterpret_cast<const uint32_t*>(&h);
}
template <> __device__ __forceinline__ uint32_t cvt2<__nv_fp8_e4m3>(uint32_t two) {
  const __half2_raw hr = __nv_cvt_fp8x2_to_halfraw2(
      (__nv_fp8x2_storage_t)(two & 0xffff), __NV_E4M3);
  const __nv_bfloat162 h = __float22bfloat162_rn(__half22float2(__half2(hr)));
  return *reinterpret_cast<const uint32_t*>(&h);
}
// 16 pool bytes -> two 16-byte chunks of 8 bf16 values
template <typename TP>
__device__ __forceinline__ void cvt16(const uint4 raw, uint4& lo, uint4& hi) {
  lo = make_uint4(cvt2<TP>(raw.x), cvt2<TP>(raw.x >> 16), cvt2<TP>(raw.y),
                  cvt2<TP>(raw.y >> 16));
  hi = make_uint4(cvt2<TP>(raw.z), cvt2<TP>(raw.z >> 16), cvt2<TP>(raw.w),
                  cvt2<TP>(raw.w >> 16));
}

// the producer: the item's n-th tile (a context tile) into stage s, one
// TMA box a page (and 64-wide D region for bf16 pools); `pg` holds the
// item's page ids, P for pages past the context
template <typename TP, int D>
__device__ __forceinline__ void fetch_tile(uint8_t* smem, uint64_t* bar,
                                           const CUtensorMap* tk,
                                           const CUtensorMap* tv,
                                           const Args& a, const int* pg,
                                           int kvh, int n, int s) {
  using L = Smem<TP, D>;
  const int ps = a.page_size, per = kN / ps;
  if constexpr (L::kQuant) {
    uint8_t* dst = smem + L::kRawOff + s * 2 * L::kRaw;
    hmma::mbar_arrive_expect_tx(bar, 2 * L::kRaw);
    for (int g = 0; g < per; ++g) {
      const int page = pg[n * per + g];
      hmma::tma_load_4d(dst + g * ps * D, tk, bar, 0, kvh, 0, page);
      hmma::tma_load_4d(dst + L::kRaw + g * ps * D, tv, bar, 0, kvh, 0, page);
    }
  } else {
    uint8_t* dst = smem + L::kKVOff + s * 2 * L::kKV;
    hmma::mbar_arrive_expect_tx(bar, 2 * L::kKV);
    for (int g = 0; g < per; ++g) {
      const int page = pg[n * per + g];
#pragma unroll
      for (int r = 0; r < D / 64; ++r) {
        hmma::tma_load_4d(dst + r * kRegion + g * ps * 128, tk, bar, 64 * r,
                          kvh, 0, page);
        hmma::tma_load_4d(dst + L::kKV + r * kRegion + g * ps * 128, tv, bar,
                          64 * r, kvh, 0, page);
      }
    }
  }
}

// One block = one work item: (key chunk blockIdx.x, (slot, q tile) pair
// blockIdx.y, kv head blockIdx.z).
template <typename TP, int D>
__global__ void __launch_bounds__(kWG, 2)
ragged_tc_kernel(const __grid_constant__ CUtensorMap tk,
                 const __grid_constant__ CUtensorMap tv, const Args a) {
  using L = Smem<TP, D>;
  constexpr bool kQuant = L::kQuant;
  constexpr int kCh = D / 8;              // 16-byte bf16 chunks a row
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = align1024(smem_raw);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + L::kBars);

  // the pair: (slot, q tile) pairs are numbered slot by slot
  const int c = blockIdx.x, kvh = blockIdx.z;
  int p = blockIdx.y, b = 0;
  for (; b < a.B; ++b) {
    const int nq = (slot_qlen(a, b) + a.tpt - 1) / a.tpt;
    if (p < nq) break;
    p -= nq;
  }
  if (b == a.B) return;
  const int qlen = slot_qlen(a, b), ctx = slot_ctx(a, b);
  const int i0 = p * a.tpt, i_last = min(i0 + a.tpt, qlen);
  const int nct = (ctx + kN - 1) / kN;
  const int n_tiles = item_tiles(a, ctx, qlen, i0);
  const int u0 = c * kChunkTiles;
  if (u0 >= n_tiles) return;              // the chunk is past this pair's keys
  const int nt = min(kChunkTiles, n_tiles - u0);
  const int group = a.H / a.KVH;
  const int* tmap = a.tok_idx + (size_t)b * a.max_seg;
  const int* table = a.tables + (size_t)b * a.table_stride;
  const int tid = threadIdx.x, lane = tid % 32;

  // the page ids of the item's context tiles, read once, in parallel
  int* pg = reinterpret_cast<int*>(smem + L::kPgOff);
  const int n_pg = max(0, min(nt, nct - u0)) * (kN / a.page_size);
  for (int g = tid; g < n_pg; g += kWG) {
    const int pos = u0 * kN + g * a.page_size;
    pg[g] = pos < ctx ? table[pos / a.page_size] : a.num_pages;
  }
  __syncthreads();
  if (tid == 0) {
    hmma::tma_prefetch_map(&tk);
    hmma::tma_prefetch_map(&tv);
    hmma::mbar_init(&full[0], 1);
    hmma::mbar_init(&full[1], 1);
    hmma::mbar_fence_init();
    if (u0 < nct) fetch_tile<TP, D>(smem, &full[0], &tk, &tv, a, pg, kvh, 0, 0);
  }
  // Q rows through tok_idx, straight into the swizzled layout
  for (int idx = tid; idx < kM * kCh; idx += kWG) {
    const int r = idx / kCh, ch = idx % kCh;
    const int i = i0 + r / group;
    uint4 v = make_uint4(0, 0, 0, 0);
    if (r < a.tpt * group && i < qlen) {
      const int tok = tmap[i];
      if (tok >= 0)
        v = *reinterpret_cast<const uint4*>(
            a.q + ((size_t)tok * a.H + kvh * group + r % group) * D + ch * 8);
    }
    *reinterpret_cast<uint4*>(smem + sw_off(r, ch)) = v;
  }
  hmma::fence_proxy_async();
  __syncthreads();

  // this thread's fragment rows rr0, rr0 + 8 and their token offsets
  const int rr0 = (tid / 32) * 16 + lane / 4;
  const int cq = 2 * (lane % 4);
  int irow[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = rr0 + 8 * r;
    irow[r] = row < a.tpt * group ? i0 + row / group : -1;
  }
  const uint32_t q_tile = smem_u32(smem);
  float* ks = reinterpret_cast<float*>(smem + L::kScOff);   // [kN], then vs
  const float* vs = ks + kN;
  float o[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) o[i] = 0.f;
  float m[2] = {kMask, kMask}, l[2] = {0.f, 0.f};
  uint32_t phase = 0;

  for (int n = 0; n < nt; ++n) {
    const int u = u0 + n, s = n & 1;
    if (tid == 0 && n + 1 < nt && u + 1 < nct)
      fetch_tile<TP, D>(smem, &full[s ^ 1], &tk, &tv, a, pg, kvh, n + 1,
                        s ^ 1);
    const bool in_ctx = u < nct;
    // first key: a context position, or an in-batch offset
    const int k0 = (in_ctx ? u : u - nct) * kN;
    const uint32_t kv_off = L::kKVOff + (kQuant ? 0 : s * 2 * L::kKV);
    uint8_t* kvp = smem + kv_off;
    if (in_ctx) {
      float scl = 0.f;
      if constexpr (kQuant) {
        // thread t < 64: the K scale of key t; thread 64 + t: its V scale
        const int key = k0 + tid % kN;
        if (key < ctx) {
          const float* sp = tid < kN ? a.k_scales : a.v_scales;
          const size_t row =
              (size_t)pg[(key - u0 * kN) / a.page_size] * a.page_size +
              key % a.page_size;
          scl = sp[row * a.KVH + kvh];
        }
      }
      hmma::mbar_wait(&full[s], (phase >> s) & 1);
      phase ^= 1u << s;
      const int live_rows = min(kN, ctx - k0);
      if constexpr (kQuant) {
        ks[tid] = scl;
        const uint8_t* raw = smem + L::kRawOff + s * 2 * L::kRaw;
        constexpr int kRc = D / 16;       // 16-byte raw chunks a row
        for (int idx = tid; idx < 2 * kN * kRc; idx += kWG) {
          const int w = idx / (kN * kRc), rem = idx % (kN * kRc);
          const int r = rem / kRc, rc = rem % kRc;
          uint4 lo = make_uint4(0, 0, 0, 0), hi = lo;
          if (r < live_rows)
            cvt16<TP>(*reinterpret_cast<const uint4*>(raw + w * L::kRaw +
                                                      r * D + rc * 16),
                      lo, hi);
          uint8_t* dst = kvp + w * L::kKV;
          *reinterpret_cast<uint4*>(dst + sw_off(r, 2 * rc)) = lo;
          *reinterpret_cast<uint4*>(dst + sw_off(r, 2 * rc + 1)) = hi;
        }
        hmma::fence_proxy_async();
        __syncthreads();
      } else if (live_rows < kN) {
        // V rows past the context (the rest of a partial last page, or
        // zero-filled pages) must be finite: P is 0 there, not NaN-proof
        for (int idx = tid; idx < (kN - live_rows) * kCh; idx += kWG) {
          const int r = live_rows + idx / kCh, ch = idx % kCh;
          *reinterpret_cast<uint4*>(kvp + L::kKV + sw_off(r, ch)) =
              make_uint4(0, 0, 0, 0);
        }
        hmma::fence_proxy_async();
        __syncthreads();
      }
    } else {
      // in-batch keys j = k0 .. k0 + 63 through tok_idx, up to the q
      // tile's last token
      for (int idx = tid; idx < 2 * kN * kCh; idx += kWG) {
        const int w = idx / (kN * kCh), rem = idx % (kN * kCh);
        const int r = rem / kCh, ch = rem % kCh;
        const int j = k0 + r;
        uint4 v = make_uint4(0, 0, 0, 0);
        if (j < i_last) {
          const int tok = tmap[j];
          if (tok >= 0)
            v = *reinterpret_cast<const uint4*>(
                (w ? a.v_new : a.k_new) + ((size_t)tok * a.KVH + kvh) * D +
                ch * 8);
        }
        *reinterpret_cast<uint4*>(kvp + w * L::kKV + sw_off(r, ch)) = v;
      }
      hmma::fence_proxy_async();
      __syncthreads();
    }
    const uint32_t k_tile = smem_u32(kvp), v_tile = k_tile + L::kKV;

    // S = Q K^T: bf16 operands, exact products, float32 sums
    float sc[kN / 2];
#pragma unroll
    for (int i = 0; i < kN / 2; ++i) sc[i] = 0.f;
    fence_regs(sc);
    hmma::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk)
      hmma::wgmma_ss<kN, 0>(sc, desc_k_major(q_tile, kRegion, kk),
                            desc_k_major(k_tile, kRegion, kk), 1);
    hmma::wgmma_commit();
    hmma::wgmma_wait<0>();
    fence_regs(sc);

    // K scales, scale, mask, online softmax (a row lives on a quad)
    const bool scaled = kQuant && in_ctx;
    const bool edge = !in_ctx || k0 + kN > ctx;
    float mt[2] = {kMask, kMask};
#pragma unroll
    for (int j = 0; j < kN / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int col = 8 * j + cq + (e & 1);
        float x = sc[4 * j + e];
        if (scaled) x *= ks[col];
        x *= a.scale;
        if (edge) {
          const int key = k0 + col;
          const bool live = in_ctx ? key < ctx
                                   : key <= irow[e >> 1] && key < qlen;
          x = live ? x : kMask;
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
    for (int i = 0; i < kN / 2; ++i) {
      const int r = (i >> 1) & 1;
      const float pv = sc[i] > 0.5f * kMask ? exp_ftz(sc[i] - m[r]) : 0.f;
      sc[i] = pv;
      sum[r] += pv;
    }
#pragma unroll
    for (int r = 0; r < 2; ++r) l[r] = l[r] * corr[r] + quad_sum(sum[r]);
#pragma unroll
    for (int i = 0; i < D / 2; ++i) o[i] *= corr[(i >> 1) & 1];
    if (scaled) {                         // V scales, after l took P
#pragma unroll
      for (int j = 0; j < kN / 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) sc[4 * j + e] *= vs[8 * j + cq + (e & 1)];
    }

    // O += P V with P as bf16 hi + lo, V read MN-major ([key][D])
    uint32_t ph[kN / 16][4], pl[kN / 16][4];
#pragma unroll
    for (int kb = 0; kb < kN / 16; ++kb)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        hmma::split_bf16x2(sc[8 * kb + 2 * e], sc[8 * kb + 2 * e + 1],
                           ph[kb][e], pl[kb][e]);
    fence_regs(o);
    hmma::wgmma_fence();
#pragma unroll
    for (int kb = 0; kb < kN / 16; ++kb) {
      const uint64_t dv = desc_mn_major(v_tile, kRegion, kb);
      hmma::wgmma_rs<D, 1>(o, ph[kb], dv, 1);
      hmma::wgmma_rs<D, 1>(o, pl[kb], dv, 1);
    }
    hmma::wgmma_commit();
    hmma::wgmma_wait<0>();
    fence_regs(o);
#pragma unroll
    for (int kb = 0; kb < kN / 16; ++kb) {
      fence_regs(ph[kb]);
      fence_regs(pl[kb]);
    }
    __syncthreads();      // every thread is done with this tile's buffers
  }

  // rows of real tokens: the output (one chunk) or this chunk's partials
  const bool direct = n_tiles <= kChunkTiles;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = rr0 + 8 * r, i = irow[r];
    if (i < 0 || i >= i_last) continue;
    const int tok = tmap[i];
    if (tok < 0) continue;
    const size_t th = (size_t)tok * a.H + kvh * group + row % group;
    if (direct) {
      const float den = fmaxf(l[r], 1e-30f);
      __nv_bfloat16* dst = a.out + th * D;
#pragma unroll
      for (int j = 0; j < D / 8; ++j)
        *reinterpret_cast<__nv_bfloat162*>(dst + 8 * j + cq) =
            __floats2bfloat162_rn(o[4 * j + 2 * r] / den,
                                  o[4 * j + 2 * r + 1] / den);
    } else {
      const size_t base = th * a.n_chunks + c;
      float* dst = a.part_acc + base * D;
#pragma unroll
      for (int j = 0; j < D / 8; ++j)
        *reinterpret_cast<float2*>(dst + 8 * j + cq) =
            make_float2(o[4 * j + 2 * r], o[4 * j + 2 * r + 1]);
      if ((lane & 3) == 0) {
        a.part_m[base] = m[r];
        a.part_l[base] = l[r];
      }
    }
  }
}

// One block a token: a row whose q tile spans several chunks merges its
// chunks' partials in chunk order; a row that is not in the plan
// (padding) is written as exact zeros; a one-chunk row was written by
// the main kernel and is left alone.
template <int D>
__global__ void __launch_bounds__(kWG)
ragged_tc_combine(const Args a) {
  const int t = blockIdx.x;
  int n_ch = 0;                           // 0: not a row of the plan
  if (a.valid[t]) {
    const int b = a.slot_ids[t];
    if (b >= 0 && b < a.B) {
      const int qlen = slot_qlen(a, b), i = a.positions[t] - a.start[b];
      if (i >= 0 && i < qlen && a.tok_idx[(size_t)b * a.max_seg + i] == t)
        n_ch = (item_tiles(a, slot_ctx(a, b), qlen, i - i % a.tpt) +
                kChunkTiles - 1) / kChunkTiles;
    }
  }
  if (n_ch == 1) return;
  __nv_bfloat16* out = a.out + (size_t)t * a.H * D;
  for (int idx = threadIdx.x; idx < a.H * D / 4; idx += blockDim.x) {
    float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
    float den = 1.f;
    if (n_ch > 1) {
      const int h = idx / (D / 4), d = (idx % (D / 4)) * 4;
      const size_t base = ((size_t)t * a.H + h) * a.n_chunks;
      float mx = kMask;
      for (int k = 0; k < n_ch; ++k) mx = fmaxf(mx, a.part_m[base + k]);
      float ls = 0.f;
      for (int k = 0; k < n_ch; ++k) {
        const float w = expf(a.part_m[base + k] - mx);
        const float4 v =
            *reinterpret_cast<const float4*>(a.part_acc + (base + k) * D + d);
        ls += a.part_l[base + k] * w;
        acc.x += v.x * w;
        acc.y += v.y * w;
        acc.z += v.z * w;
        acc.w += v.w * w;
      }
      den = fmaxf(ls, 1e-30f);
    }
    const __nv_bfloat162 lo = __floats2bfloat162_rn(acc.x / den, acc.y / den);
    const __nv_bfloat162 hi = __floats2bfloat162_rn(acc.z / den, acc.w / den);
    uint2 pk;
    pk.x = *reinterpret_cast<const uint32_t*>(&lo);
    pk.y = *reinterpret_cast<const uint32_t*>(&hi);
    *reinterpret_cast<uint2*>(out + idx * 4) = pk;
  }
}

template <typename TP, int D>
int launch(const Args& a, const void* k_pages, const void* v_pages,
           int n_pairs, cudaStream_t st) {
  using L = Smem<TP, D>;
  CUtensorMap tk, tv;
  const int ps = a.page_size;
  int bad;
  if constexpr (L::kQuant)
    bad = hmma::make_map_u8_4d(&tk, k_pages, D, a.KVH, ps, a.num_pages, ps) ||
          hmma::make_map_u8_4d(&tv, v_pages, D, a.KVH, ps, a.num_pages, ps);
  else
    bad = hmma::make_map_bf16_4d(&tk, k_pages, D, a.KVH, ps, a.num_pages,
                                 ps) ||
          hmma::make_map_bf16_4d(&tv, v_pages, D, a.KVH, ps, a.num_pages, ps);
  if (bad) return kTmaError;
  if (n_pairs > 0) {
    auto kern = ragged_tc_kernel<TP, D>;
    cudaError_t err = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)L::kBytes);
    // all of the SM's 228 KB to shared memory, so two blocks fit an SM
    if (err == cudaSuccess)
      err = cudaFuncSetAttribute(kern,
                                 cudaFuncAttributePreferredSharedMemoryCarveout,
                                 (int)cudaSharedmemCarveoutMaxShared);
    if (err != cudaSuccess) return (int)err;
    dim3 grid(a.n_chunks, n_pairs, a.KVH);
    kern<<<grid, kWG, L::kBytes, st>>>(tk, tv, a);
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  ragged_tc_combine<D><<<a.T, kWG, 0, st>>>(a);
  return (int)cudaGetLastError();
}

}  // namespace rtc

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

// bf16 queries: the tensor-core kernel and its combine pass, on (pool
// kind, D)
static int launch_bf16(const rtc::Args& a, int kv_kind, int D,
                       const void* k_pages, const void* v_pages, int n_pairs,
                       cudaStream_t st) {
  switch (kv_kind * 1000 + D) {
    case 64: return rtc::launch<__nv_bfloat16, 64>(a, k_pages, v_pages, n_pairs, st);
    case 128: return rtc::launch<__nv_bfloat16, 128>(a, k_pages, v_pages, n_pairs, st);
    case 1064: return rtc::launch<int8_t, 64>(a, k_pages, v_pages, n_pairs, st);
    case 1128: return rtc::launch<int8_t, 128>(a, k_pages, v_pages, n_pairs, st);
    case 2064: return rtc::launch<__nv_fp8_e4m3, 64>(a, k_pages, v_pages, n_pairs, st);
    case 2128: return rtc::launch<__nv_fp8_e4m3, 128>(a, k_pages, v_pages, n_pairs, st);
  }
  return -1;
}

// dtype: 0 float32, 1 bfloat16, 2 float16 (q, out, k_new, v_new).
// kv_kind: 0 pools in q's dtype (scales null), 1 int8 and 2 fp8 e4m3
// pools with float32 k_scales/v_scales [P, page, KVH] (D % 16 == 0).
// valid is one byte per token (torch.bool). q_blk is the tokens of a
// block's q tile. bf16 queries of the shapes `rtc::takes` (the
// tensor-core kernel): slot_ids and positions [T] int32; n_pairs (slot,
// q tile) pairs and n_chunks key chunks in the grid; part_m, part_l
// [T, H, n_chunks] and part_acc [T, H, n_chunks, D] float32 scratch when
// n_chunks > 1 (else null); q_blk = 64 / (H / KVH). Other bf16 shapes
// run the first kernel, which ignores those arguments.
// Returns cudaGetLastError() after the launches (0 = launched); -1 for
// arguments the kernels do not take; -2 when a bf16 launch's TMA tensor
// map cannot be encoded.
extern "C" int ragged_paged_launch(
    const void* q, const void* k_pages, const void* v_pages,
    const void* k_scales, const void* v_scales, const void* tables,
    const void* start, const void* qlens, const void* tok_idx,
    const void* valid, const void* slot_ids, const void* positions,
    const void* k_new, const void* v_new, void* out, void* part_m,
    void* part_l, void* part_acc, int T_tokens, int B, int H, int KVH, int D,
    int page_size, int table_stride, int n_ctx_pages, int max_seg,
    int num_pages, int q_blk, int n_pairs, int n_chunks, int dtype,
    int kv_kind, void* stream) {
  if (KVH <= 0 || H % KVH != 0 || q_blk < 1 || max_seg < 1 || D % 8 != 0 ||
      D > kMaxD)
    return -1;
  if (kv_kind < 0 || kv_kind > 2) return -1;
  if ((kv_kind != 0) != (k_scales != nullptr) ||
      (k_scales == nullptr) != (v_scales == nullptr))
    return -1;
  if (kv_kind != 0 && D % 16 != 0) return -1;
  cudaStream_t st = (cudaStream_t)stream;
  if (dtype == 1 && rtc::takes(D, H / KVH, page_size)) {
    if (q_blk != rtc::kM / (H / KVH) || n_pairs < 0 || n_chunks < 1 ||
        !slot_ids || !positions ||
        (n_chunks > 1 && (!part_m || !part_l || !part_acc)))
      return -1;
    if (T_tokens == 0) return 0;
    rtc::Args a;
    a.tables = (const int*)tables;
    a.start = (const int*)start;
    a.qlens = (const int*)qlens;
    a.tok_idx = (const int*)tok_idx;
    a.valid = (const unsigned char*)valid;
    a.slot_ids = (const int*)slot_ids;
    a.positions = (const int*)positions;
    a.k_scales = (const float*)k_scales;
    a.v_scales = (const float*)v_scales;
    a.q = (const __nv_bfloat16*)q;
    a.k_new = (const __nv_bfloat16*)k_new;
    a.v_new = (const __nv_bfloat16*)v_new;
    a.out = (__nv_bfloat16*)out;
    a.part_m = (float*)part_m;
    a.part_l = (float*)part_l;
    a.part_acc = (float*)part_acc;
    a.T = T_tokens; a.B = B; a.H = H; a.KVH = KVH;
    a.page_size = page_size; a.table_stride = table_stride;
    a.n_ctx_pages = n_ctx_pages; a.max_seg = max_seg;
    a.num_pages = num_pages; a.tpt = q_blk; a.n_chunks = n_chunks;
    a.scale = 1.0f / sqrtf((float)D);
    return launch_bf16(a, kv_kind, D, k_pages, v_pages, n_pairs, st);
  }
  if (q_blk * (H / KVH) * D > kThreads * kMaxAcc) return -1;
  if (T_tokens == 0) return 0;
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
