// Paged decode attention for one layer: one query token per sequence
// over that sequence's cached KV pages.
//
// Replaces the TPU kernels `_paged_decode_kernel_mp`
// (ray_tpu/ops/paged_attention.py:225) and `_paged_decode_kernel`
// (:158), reached by `paged_decode_attention`. On the TPU the two differ
// only in how many pages one grid step streams (16 or 1), which mattered
// for the TPU's per-grid-step overhead; here one grid serves every table
// width.
//
// What bounds it on an H100: bytes. Each (sequence, kv head) reads its
// cached K and V once (2 * len * D * itemsize) for about 4 * group * D
// flops per key, far below the ~295 flop/byte ridge. So the design is
// about keeping enough loads in flight and doing little else per byte.
//
// Two kernels share the grid (B, KVH, n_splits), the split of each
// context into chunks of `split_tokens` keys (one block a chunk; a block
// whose chunk starts past its sequence's length exits at once, so the
// full-width table of the decode tick costs nothing past each sequence's
// last page) and the combine pass that merges the chunks' float32
// (m, l, acc) partials. No atomics: the same inputs give the same bits.
//
// 1. `pdk::paged_decode_pipe_kernel` (bf16 queries on bf16, int8 or fp8
//    pages, D 64 or 128, pages of 8-64 rows, group <= 8: `pdk::takes`,
//    mirrored by `decode_takes` in the wrapper). Pipelined, in the
//    pool's own type, with the products on the tensor cores:
//    - each of a block's 4 warps owns 16 consecutive keys of every
//      64-key step and streams their K and V rows through its own ring
//      of stages in shared memory with 16-byte `cp.async.cg` copies
//      (zero-filled past the chunk), kStages - 1 stages in flight; a
//      lane's page id for the next stage is read from the table one
//      stage ahead; one-byte pages bring their float32 scales in the
//      same stage (4-byte `cp.async.ca`);
//    - the stages stay bf16 / one-byte in shared memory (half or a
//      quarter of kernel 2's float32 tiles); one-byte rows are converted
//      to bf16 once a stage (exactly: int8 and e4m3 values fit bf16);
//    - scores and the value product are `mma.sync` m16n8k16 bf16 tiles
//      with float32 accumulators: the group's query rows are the A rows
//      (up to 8 of 16; the tensor cores have time to spare, the CUDA
//      cores would spend ~100 instructions a key on dots, shuffles and
//      softmax), K and V come by `ldmatrix`; P goes back as the A operand
//      in bf16 hi + lo parts, so the value product keeps float32
//      precision. The online softmax of a row runs on the 4 lanes of its
//      fragment quad;
//    - no block barrier in the key loop: a warp waits only for its own
//      copies (`cp.async.wait_group` + `__syncwarp`, which also releases
//      the ring slot). The warps' states merge once, in shared memory,
//      in a fixed order;
//    - one-byte pages: the scales fold into the scores and probabilities
//      (s = <q, k_q> * k_scale * D**-0.5, acc += (p * v_scale) v_q).
//    Bytes in flight: kStages - 1 = 2 stages of 32 rows a warp, 17 KB a
//    warp (bf16, D 128), 70 KB a block, 139 KB on an SM's 2 blocks,
//    against the ~25 KB an SM that 3.35 TB/s at ~1 us latency needs
//    across 132 SMs.
// 2. `paged_decode_kernel` (every other call: float32 and float16
//    queries, and bf16 shapes kernel 1 does not take, such as the `debug`
//    preset's head_dim 32 or pages of 4 rows): 64-key tiles converted to
//    float32 in shared memory (flash_tile.cuh), row max and denominator
//    in shared memory, the accumulator in registers.
//
// Both keep the reference's rules: the -1e30 mask and the 1e-30 floor on
// the denominator, scale D**-0.5, float32 m, l and acc; a sequence with
// seq_len 0 attends one key, as the multi-page TPU kernel does
// (`length = max(seq_len, 1)`, capped at max_pages * page_size).
//
// With k_new/v_new given, the current token's KV (not yet in the pages)
// is merged as one more always-live key by chunk 0:
// `paged_decode_with_new_token` in one call. It stays in the query's
// type for quantized pools too.
//
// Quantized pools (the `quantized=True` branch of both TPU kernels:
// int8 or fp8 e4m3 pages with per-(row, kv head) float32 scale pools):
// the kernels are templated on the pool type TP apart from the query
// type T. The bytes that bound them fall from 2 * D * itemsize to
// 2 * (D + 4) per (key, kv head): 132 against 256 bytes at D = 128 in
// bf16.

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

// ------------------------------------------------------------------------
// Kernel 1: pipelined page tiles in the pool's own type (bf16 queries).
namespace pdk {

constexpr int kWarps = 4;
constexpr int kThreads = kWarps * 32;
constexpr int kTile = 16;                   // keys a warp takes a step
constexpr int kStep = kWarps * kTile;       // keys a block takes a step

// The shapes this kernel takes for bf16 queries (`decode_takes` in the
// wrapper says the same): D 64 or 128, group <= 8 (a kv head's query
// rows fit the 8 rows of an mma tile that are kept), pages of 8, 16, 32
// or 64 rows. Every other call runs paged_decode_kernel.
inline bool takes(int D, int group, int page_size) {
  return (D == 64 || D == 128) && group >= 1 && group <= 8 &&
         (page_size == 8 || page_size == 16 || page_size == 32 ||
          page_size == 64);
}

// Shared memory of one warp for pool type TP at head dim D: a ring of
// stages, each the K rows then the V rows of the warp's 16 keys (bf16
// rows padded by 16 bytes, so the 8 rows an ldmatrix reads fall on
// distinct banks; one-byte rows as they are, then their k and v scales),
// and for one-byte pools one bf16 copy of a stage's K and V.
template <typename TP, int D>
struct Geo {
  static constexpr bool kQuant = sizeof(TP) == 1;
  static constexpr int kRowB = (D + 8) * 2;        // a bf16 row in smem
  static constexpr int kRawRow = kQuant ? D : kRowB;
  static constexpr int kChunks = D * (int)sizeof(TP) / 16;  // copies a row
  static constexpr int kKV = 2 * kTile * kRawRow;
  static constexpr int kStage = kKV + (kQuant ? 2 * kTile * 4 : 0);
  static constexpr int kConv = kQuant ? 2 * kTile * kRowB : 0;
  static constexpr int kFit = 16384 / kStage;
  static constexpr int kStages = kFit < 3 ? 3 : (kFit > 6 ? 6 : kFit);
  static constexpr int kWarpBytes = kStages * kStage + kConv;
  static constexpr int kRing = kWarps * kWarpBytes;
  // the end-of-block merge: m, l [kWarps][8] and acc [kWarps][8][D]
  static constexpr int kMerge = (2 * kWarps * 8 + kWarps * 8 * D) * 4;
  static constexpr int kSmem = kRing > kMerge ? kRing : kMerge;
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

// 16 bytes global -> shared, asynchronously; zero-filled when !live (no
// global read then).
__device__ __forceinline__ void cp16(void* dst, const void* src, bool live) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src), "r"(live ? 16 : 0)
               : "memory");
}

__device__ __forceinline__ void cp4(void* dst, const void* src, bool live) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src), "r"(live ? 4 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Four 8x8 bf16 matrices from shared memory (lanes 8i..8i+7 give the
// rows of matrix i); .trans hands each lane a column pair instead.
__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_u32(p))
      : "memory");
}

__device__ __forceinline__ void ldsm_x4_t(uint32_t (&r)[4], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_u32(p))
      : "memory");
}

// d += A (16x16 bf16, rows g and g+8 in a0/a2 and a1/a3) * B (16x8).
__device__ __forceinline__ void mma(float (&d)[4], uint32_t a0, uint32_t a1,
                                    uint32_t a2, uint32_t a3, uint32_t b0,
                                    uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
}

// Two floats as a bf16 pair, the first in the low half.
__device__ __forceinline__ uint32_t pack(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ float lo_f(uint32_t w) {
  return __uint_as_float(w << 16);
}

__device__ __forceinline__ float hi_f(uint32_t w) {
  return __uint_as_float(w & 0xffff0000u);
}

// 16 one-byte values -> float, exactly: int8 by the 2^23 magic number;
// fp8 e4m3 by moving its exponent and mantissa fields into a float's and
// scaling by 2^(127 - 7) (e4m3's subnormals land on float subnormals,
// which the scale makes exact).
template <typename TP>
__device__ __forceinline__ void cvt16(uint4 raw, float (&out)[16]) {
  const uint32_t w[4] = {raw.x, raw.y, raw.z, raw.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    if constexpr (std::is_same<TP, int8_t>::value) {
      const uint32_t u = w[i] ^ 0x80808080u;     // x + 128 in each byte
#pragma unroll
      for (int j = 0; j < 4; ++j)
        out[4 * i + j] =
            __uint_as_float(__byte_perm(u, 0x4b000000u, 0x7440 + j)) -
            8388736.f;                             // 2^23 + 128
    } else {
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const uint32_t x = (w[i] >> (8 * j)) & 0xffu;
        out[4 * i + j] =
            __uint_as_float(((x & 0x80u) << 24) | ((x & 0x7fu) << 20)) *
            0x1p120f;
      }
    }
  }
}

// A stage of one-byte K and V rows -> bf16 rows (exact: int8 and e4m3
// values fit bf16's 8-bit significand) for the ldmatrix reads. Lane l
// takes half (l & 1) of row l >> 1 of K and of V, its 16-byte chunks in
// a rotated order so that the 8 lanes of a load phase hit distinct banks.
template <typename TP, int D>
__device__ __forceinline__ void convert_stage(const char* st, char* conv,
                                              int lane) {
  using Geom = Geo<TP, D>;
  constexpr int kHalf = D / 2;            // values a lane converts a row
  constexpr int kParts = kHalf / 16;
  const int row = lane >> 1, part = lane & 1;
#pragma unroll
  for (int kv = 0; kv < 2; ++kv) {
    const char* src = st + (kv * kTile + row) * D + part * kHalf;
    char* dst = conv + (kv * kTile + row) * Geom::kRowB + part * kHalf * 2;
#pragma unroll
    for (int i = 0; i < kParts; ++i) {
      const int c = ((i + row) % kParts) * 16;
      float f[16];
      cvt16<TP>(*reinterpret_cast<const uint4*>(src + c), f);
      *reinterpret_cast<uint4*>(dst + 2 * c) = make_uint4(
          pack(f[0], f[1]), pack(f[2], f[3]), pack(f[4], f[5]),
          pack(f[6], f[7]));
      *reinterpret_cast<uint4*>(dst + 2 * c + 16) = make_uint4(
          pack(f[8], f[9]), pack(f[10], f[11]), pack(f[12], f[13]),
          pack(f[14], f[15]));
    }
  }
}

// Grid (B, KVH, n_splits), kThreads threads. Each warp owns 16
// consecutive keys of each 64-key step of the block's chunk. Scores are
// one m16n8k16 mma per (8 keys, 16 dims): A the group's query rows (row
// g of the tile is head kvh * group + g; rows past the group and 8..15
// are zero), B the K rows by ldmatrix. Row g's online softmax runs on
// the 4 lanes of quad g (its max by two shuffles; each lane keeps its
// share of the denominator). P, scaled by the keys' value scales, goes
// back as the A operand of the value product in bf16 hi + lo parts
// (float32 precision on the tensor cores), B the V rows by
// ldmatrix.trans, accumulated in float32.
template <typename TP, int D>
__global__ void __launch_bounds__(kThreads)
    paged_decode_pipe_kernel(const __nv_bfloat16* __restrict__ q,
                             const TP* __restrict__ k_pages,
                             const TP* __restrict__ v_pages,
                             const __nv_bfloat16* __restrict__ k_new,
                             const __nv_bfloat16* __restrict__ v_new,
                             __nv_bfloat16* __restrict__ out, DecodeArgs a) {
  using Geom = Geo<TP, D>;
  constexpr int S = Geom::kStages;
  constexpr bool kQuant = Geom::kQuant;
  constexpr int kN = D / 8;           // n-tiles of the output row
  constexpr int kK = D / 16;          // k-steps of a score
  extern __shared__ __align__(16) char smem[];
  const int b = blockIdx.x, kvh = blockIdx.y, split = blockIdx.z;
  const int n_splits = gridDim.z;
  const int R = a.H / a.KVH;
  const int length = seq_length(a, b);
  const int k0 = split * a.split_tokens;
  if (k0 >= length) return;           // chunk past this sequence's end
  const int k1 = min(length, k0 + a.split_tokens);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;   // fragment row, column pair
  const size_t row0 = (size_t)b * a.H + (size_t)kvh * R;

  // Q as the A operand: row g, columns 2t.. and 8 + 2t.. of each k-step
  uint32_t qa[kK][2];
  {
    const uint32_t* qr =
        reinterpret_cast<const uint32_t*>(q + (row0 + min(g, R - 1)) * D);
#pragma unroll
    for (int s = 0; s < kK; ++s) {
      qa[s][0] = g < R ? qr[8 * s + t] : 0u;
      qa[s][1] = g < R ? qr[8 * s + 4 + t] : 0u;
    }
  }
  float acc[kN][4];
#pragma unroll
  for (int n = 0; n < kN; ++n)
#pragma unroll
    for (int c = 0; c < 4; ++c) acc[n][c] = 0.f;
  float m_row = kMask, l_lane = 0.f;

  char* wbase = smem + warp * Geom::kWarpBytes;
  char* conv = wbase + S * Geom::kStage;
  const int* table = a.tables + (size_t)b * a.max_pages;
  const int n_steps = (k1 - k0 + kStep - 1) / kStep;
  // pages of 2^k rows (pdk::takes): row within a page by mask and shift
  const int pshift = __ffs(a.page_size) - 1, pmask = a.page_size - 1;
  const long long row_bytes = (long long)a.KVH * D * sizeof(TP);
  const long long head_bytes = (long long)kvh * D * sizeof(TP);
  // the pool row of key `lane & 15` in step u (0 when past the chunk):
  // lanes 0-15, and again 16-31, hold the warp's 16 keys
  auto row_of = [&](int u) -> int {
    const int pos = k0 + u * kStep + warp * kTile + (lane & 15);
    if (u >= n_steps || pos >= k1) return 0;
    return (__ldg(table + (pos >> pshift)) << pshift) | (pos & pmask);
  };
  // copy this warp's K and V rows (and scales) of step u into its slot:
  // kChunks consecutive lanes take one row, so each copy instruction
  // reads whole rows; a row's pool index comes from the lane of its key
  auto issue = [&](int u, int my_row) {
    constexpr int kRows = 32 / Geom::kChunks;       // rows a copy round
    char* st = wbase + (u % S) * Geom::kStage;
    const int pos0 = k0 + u * kStep + warp * kTile;
    const int c = lane % Geom::kChunks;
    const char* kb = reinterpret_cast<const char*>(k_pages) + head_bytes;
    const char* vb = reinterpret_cast<const char*>(v_pages) + head_bytes;
#pragma unroll
    for (int m = 0; m < Geom::kChunks; ++m) {
      const int r = lane / Geom::kChunks + m * kRows;  // 0-15 K, 16-31 V
      const int key = r & (kTile - 1);
      const int row = __shfl_sync(0xffffffffu, my_row, key);
      const bool live = pos0 + key < k1;
      const char* base = r < kTile ? kb : vb;
      cp16(st + r * Geom::kRawRow + c * 16,
           base + (live ? row * row_bytes + c * 16 : 0), live);
    }
    if constexpr (kQuant) {
      const bool live = pos0 + (lane & (kTile - 1)) < k1;
      const float* base = lane < kTile ? a.k_scales : a.v_scales;
      cp4(st + Geom::kKV + lane * 4,
          base + (live ? (long long)my_row * a.KVH + kvh : 0), live);
    }
  };

#pragma unroll 1
  for (int u = 0; u < S - 1; ++u) {
    if (u < n_steps) issue(u, row_of(u));
    cp_commit();
  }
  int next_row = row_of(S - 1);
#pragma unroll 1
  for (int it = 0; it < n_steps; ++it) {
    __syncwarp();                 // the warp is done with slot (it - 1) % S
    const int u = it + S - 1;
    if (u < n_steps) issue(u, next_row);
    cp_commit();
    next_row = row_of(u + 1);     // one stage ahead
    cp_wait<S - 1>();
    __syncwarp();                 // the warp's copies of step it landed
    const char* st = wbase + (it % S) * Geom::kStage;
    const char* kt = st;
    if constexpr (kQuant) {
      convert_stage<TP, D>(st, conv, lane);
      __syncwarp();
      kt = conv;
    }
    const char* vt = kt + kTile * Geom::kRowB;
    // scores of row g: keys 2t, 2t+1 (s0) and 8+2t, 9+2t (s1)
    float s0[4] = {0.f, 0.f, 0.f, 0.f}, s1[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
    for (int s = 0; s < kK; ++s) {
      uint32_t bk[4];
      const int key = (lane & 7) + ((lane >> 4) << 3);
      const int col = 16 * s + ((lane >> 3) & 1) * 8;
      ldsm_x4(bk, kt + key * Geom::kRowB + col * 2);
      mma(s0, qa[s][0], 0u, qa[s][1], 0u, bk[0], bk[1]);
      mma(s1, qa[s][0], 0u, qa[s][1], 0u, bk[2], bk[3]);
    }
    const int base = k0 + it * kStep + warp * kTile;
    const int kidx[4] = {2 * t, 2 * t + 1, 8 + 2 * t, 9 + 2 * t};
    float sc[4] = {s0[0], s0[1], s1[0], s1[1]}, vsc[4];
    bool live[4];
    float mt = kMask;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      float ksc = a.scale;
      vsc[i] = 1.f;
      if constexpr (kQuant) {
        const float* scl = reinterpret_cast<const float*>(st + Geom::kKV);
        ksc *= scl[kidx[i]];
        vsc[i] = scl[kTile + kidx[i]];
      }
      live[i] = base + kidx[i] < k1;
      sc[i] = live[i] ? sc[i] * ksc : kMask;
      mt = fmaxf(mt, sc[i]);
    }
    mt = fmaxf(mt, __shfl_xor_sync(0xffffffffu, mt, 1));
    mt = fmaxf(mt, __shfl_xor_sync(0xffffffffu, mt, 2));
    const float m_new = fmaxf(m_row, mt);
    const float corr = __expf(m_row - m_new);
    m_row = m_new;
    float pv[4], psum = 0.f;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float p = live[i] ? __expf(sc[i] - m_new) : 0.f;
      psum += p;
      pv[i] = p * vsc[i];
    }
    l_lane = fmaf(l_lane, corr, psum);
#pragma unroll
    for (int n = 0; n < kN; ++n) {
      acc[n][0] *= corr;
      acc[n][1] *= corr;
    }
    const uint32_t hi0 = pack(pv[0], pv[1]), hi1 = pack(pv[2], pv[3]);
    const uint32_t lo0 = pack(pv[0] - lo_f(hi0), pv[1] - hi_f(hi0));
    const uint32_t lo1 = pack(pv[2] - lo_f(hi1), pv[3] - hi_f(hi1));
#pragma unroll
    for (int p2 = 0; p2 < D / 16; ++p2) {
      uint32_t bv[4];
      const int key = (lane & 7) + ((lane >> 3) & 1) * 8;
      const int col = 16 * p2 + (lane >> 4) * 8;
      ldsm_x4_t(bv, vt + key * Geom::kRowB + col * 2);
      mma(acc[2 * p2], hi0, 0u, hi1, 0u, bv[0], bv[1]);
      mma(acc[2 * p2], lo0, 0u, lo1, 0u, bv[0], bv[1]);
      mma(acc[2 * p2 + 1], hi0, 0u, hi1, 0u, bv[2], bv[3]);
      mma(acc[2 * p2 + 1], lo0, 0u, lo1, 0u, bv[2], bv[3]);
    }
  }
  // the current token, one more always-live key of chunk 0 (warp 0):
  // each lane of quad g takes row g's whole score
  if (k_new != nullptr && split == 0 && warp == 0) {
    const size_t kv_row = ((size_t)b * a.KVH + kvh) * D;
    float s = 0.f;
    if (g < R) {
      const uint32_t* qr =
          reinterpret_cast<const uint32_t*>(q + (row0 + g) * D);
      const uint32_t* kr = reinterpret_cast<const uint32_t*>(k_new + kv_row);
#pragma unroll 8
      for (int i = 0; i < D / 2; ++i) {
        const uint32_t x = qr[i], y = kr[i];
        s = fmaf(lo_f(x), lo_f(y), s);
        s = fmaf(hi_f(x), hi_f(y), s);
      }
    }
    s *= a.scale;
    const float m_new = fmaxf(m_row, s);
    const float corr = __expf(m_row - m_new);
    const float p = __expf(s - m_new);
    m_row = m_new;
    l_lane = fmaf(l_lane, corr, t == 0 ? p : 0.f);
    const uint32_t* vr = reinterpret_cast<const uint32_t*>(v_new + kv_row);
#pragma unroll
    for (int n = 0; n < kN; ++n) {
      const uint32_t v2 = vr[4 * n + t];      // dims 8n + 2t, 8n + 2t + 1
      acc[n][0] = fmaf(p, lo_f(v2), acc[n][0] * corr);
      acc[n][1] = fmaf(p, hi_f(v2), acc[n][1] * corr);
    }
  }

  // merge the warps' states in a fixed order (same bits every run)
  float lq = l_lane + __shfl_xor_sync(0xffffffffu, l_lane, 1);
  lq += __shfl_xor_sync(0xffffffffu, lq, 2);
  cp_wait<0>();
  __syncthreads();                // every warp is done with its ring
  float* ms = reinterpret_cast<float*>(smem);   // [kWarps][8]
  float* ls = ms + kWarps * 8;                  // [kWarps][8]
  float* as = ls + kWarps * 8;                  // [kWarps][8][D]
  if (g < R) {
    if (t == 0) {
      ms[warp * 8 + g] = m_row;
      ls[warp * 8 + g] = lq;
    }
    float* dst = as + (size_t)(warp * 8 + g) * D + 2 * t;
#pragma unroll
    for (int n = 0; n < kN; ++n)
      *reinterpret_cast<float2*>(dst + 8 * n) =
          make_float2(acc[n][0], acc[n][1]);
  }
  __syncthreads();
  for (int idx = threadIdx.x; idx < R * D; idx += kThreads) {
    const int r = idx / D, d = idx - r * D;
    float mx = kMask;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) mx = fmaxf(mx, ms[w * 8 + r]);
    float lsum = 0.f, x = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      const float f = __expf(ms[w * 8 + r] - mx);
      lsum = fmaf(ls[w * 8 + r], f, lsum);
      x = fmaf(as[(size_t)(w * 8 + r) * D + d], f, x);
    }
    if (n_splits == 1) {
      out[(row0 + r) * D + d] = __float2bfloat16(x / fmaxf(lsum, 1e-30f));
      if (d == 0 && a.m_out != nullptr) {
        a.m_out[row0 + r] = mx;
        a.l_out[row0 + r] = lsum;
      }
    } else {
      a.part_acc[((row0 + r) * n_splits + split) * D + d] = x;
      if (d == 0) {
        a.part_m[(row0 + r) * n_splits + split] = mx;
        a.part_l[(row0 + r) * n_splits + split] = lsum;
      }
    }
  }
}

template <typename TP, int D>
static int launch(const void* q, const void* k_pages, const void* v_pages,
                  const void* k_new, const void* v_new, void* out,
                  DecodeArgs a, int B, int S, cudaStream_t stream) {
  constexpr int kSmem = Geo<TP, D>::kSmem;
  // the opt-in shared memory limit, raised once per instance and device
  static bool opted[64] = {};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  if (dev >= 64) return -1;
  if (!opted[dev]) {
    err = cudaFuncSetAttribute(paged_decode_pipe_kernel<TP, D>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               kSmem);
    if (err != cudaSuccess) return (int)err;
    opted[dev] = true;
  }
  paged_decode_pipe_kernel<TP, D>
      <<<dim3(B, a.KVH, S), kThreads, kSmem, stream>>>(
          (const __nv_bfloat16*)q, (const TP*)k_pages, (const TP*)v_pages,
          (const __nv_bfloat16*)k_new, (const __nv_bfloat16*)v_new,
          (__nv_bfloat16*)out, a);
  err = cudaGetLastError();
  if (err != cudaSuccess || S == 1) return (int)err;
  paged_decode_combine<__nv_bfloat16>
      <<<dim3(B, a.H), 128, 0, stream>>>((__nv_bfloat16*)out, a, S);
  return (int)cudaGetLastError();
}

template <typename TP>
static int launch_dim(const void* q, const void* k_pages, const void* v_pages,
                      const void* k_new, const void* v_new, void* out,
                      DecodeArgs a, int B, int S, cudaStream_t stream) {
  if (a.D == 64)
    return launch<TP, 64>(q, k_pages, v_pages, k_new, v_new, out, a, B, S,
                          stream);
  return launch<TP, 128>(q, k_pages, v_pages, k_new, v_new, out, a, B, S,
                         stream);
}

static int launch_kind(int kv_kind, const void* q, const void* k_pages,
                       const void* v_pages, const void* k_new,
                       const void* v_new, void* out, DecodeArgs a, int B,
                       int S, cudaStream_t stream) {
  switch (kv_kind) {
    case 0:
      return launch_dim<__nv_bfloat16>(q, k_pages, v_pages, k_new, v_new,
                                       out, a, B, S, stream);
    case 1:
      return launch_dim<int8_t>(q, k_pages, v_pages, k_new, v_new, out, a,
                                B, S, stream);
    case 2:
      return launch_dim<__nv_fp8_e4m3>(q, k_pages, v_pages, k_new, v_new,
                                       out, a, B, S, stream);
  }
  return -1;
}

}  // namespace pdk

// ------------------------------------------------------------------------
// Kernel 2's launch.
static constexpr int kThreads = 128;

template <typename T, typename TP>
static int launch(const void* q, const void* k_pages, const void* v_pages,
                  const void* k_new, const void* v_new, void* out,
                  DecodeArgs a, int B, int S, cudaStream_t stream) {
  const int R = a.H / a.KVH;
  const size_t smem = tile_smem_bytes(R, a.D);
  // the opt-in shared memory limit, raised once per instance and device
  // (and again only for a larger request), not on every launch
  static int opted[64] = {};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  if (dev >= 64) return -1;
  if ((int)smem > opted[dev]) {
    err = cudaFuncSetAttribute(paged_decode_kernel<T, TP>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)smem);
    if (err != cudaSuccess) return (int)err;
    opted[dev] = (int)smem;
  }
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
// arguments the kernels do not take. bf16 queries of the shapes
// `pdk::takes` run kernel 1 (split_tokens a multiple of pdk::kTile);
// every other call runs kernel 2. The route depends on types and shapes
// only.
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
  if (dtype == 1 && pdk::takes(D, H / KVH, page_size)) {
    // kernel 1: its chunks are whole tiles
    if (split_tokens % pdk::kTile != 0) return -1;
    return pdk::launch_kind(kv_kind, q, k_pages, v_pages, k_new, v_new, out,
                            a, B, n_splits, st);
  }
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
