// The sampler's Gumbel noise: JAX's threefry2x32 draws, bit for bit.
//
// Replaces no Pallas kernel. The JAX engine samples with
// jax.vmap(jax.random.categorical)(row_keys, filtered)
// (ray_tpu/llm/_internal/engine.py, _sample, keys from _row_sample_keys),
// and XLA lowers that threefry hash to device code of its own; this is
// the port's counterpart. Row b's key is fold_in(PRNGKey(seeds[b]),
// index[b]); column c's 32 bits are the hash of the iota counter (hi 0,
// lo c) under that key, its two words xor'ed (jax_threefry_partitionable);
// the bits become a uniform in [tiny, 1) by JAX's mantissa fill and a
// Gumbel value -log(-log(u)) (mode "low"). The plain version is
// ray_tpu_torch/ops/threefry.py:row_gumbel_plain.
//
// Bound: the B x V float32 values written (4 bytes each); per value a
// 20-round hash of its column in integer instructions and two logf, and
// per thread one more hash for the row key. Design: each thread derives
// its row's key once and then makes kColsPerThread columns, a grid
// stride apart (stores stay coalesced); no shared memory. seeds and
// index are read from device memory, so a CUDA graph replays the launch
// with new values.
// Float steps keep JAX's order with round-to-nearest intrinsics (no
// contraction into fma), and logf is the accurate one (no fast-math
// flags: at most 1 ulp off the rounded result).

#include <cuda_runtime.h>
#include <stdint.h>

namespace tfy {

// columns a thread makes: its row key (one hash) is shared by them
constexpr int kColsPerThread = 4;

__device__ __forceinline__ uint32_t rotl(uint32_t x, int r) {
  return (x << r) | (x >> (32 - r));
}

// Threefry-2x32, 20 rounds, key injected every 4 (JAX's
// _threefry2x32_lowering); (x0, x1) in: counter words, out: hash words.
__device__ __forceinline__ void threefry2x32(uint32_t k0, uint32_t k1,
                                             uint32_t& x0, uint32_t& x1) {
  const uint32_t ks[3] = {k0, k1, k0 ^ k1 ^ 0x1BD11BDAu};
  x0 += ks[0];
  x1 += ks[1];
#pragma unroll
  for (int i = 0; i < 5; ++i) {
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int r = (i & 1) ? (j == 0 ? 17 : j == 1 ? 29 : j == 2 ? 16 : 24)
                            : (j == 0 ? 13 : j == 1 ? 15 : j == 2 ? 26 : 6);
      x0 += x1;
      x1 = rotl(x1, r) ^ x0;
    }
    x0 += ks[(i + 1) % 3];
    x1 += ks[(i + 2) % 3] + (uint32_t)(i + 1);
  }
}

// stage 0: the Gumbel value; 1: the uniform; 2: the 32 bits (the two
// stages before the last, to hold them to JAX's bit-equal ones)
__global__ void row_gumbel_kernel(const int32_t* __restrict__ seeds,
                                  const int32_t* __restrict__ index,
                                  float* __restrict__ out, int V,
                                  int stage) {
  const int b = blockIdx.y;
  // PRNGKey(seed) = (0, seed); fold_in(key, i) = hash of (0, i) under key
  uint32_t k0 = 0u, k1 = (uint32_t)index[b];
  threefry2x32(0u, (uint32_t)seeds[b], k0, k1);
  const float tiny = 1.17549435e-38f;          // FLT_MIN, JAX's minval
  const float span = __fsub_rn(1.0f, tiny);    // maxval - minval
  for (int c = blockIdx.x * blockDim.x + threadIdx.x; c < V;
       c += gridDim.x * blockDim.x) {
    uint32_t x0 = 0u, x1 = (uint32_t)c;
    threefry2x32(k0, k1, x0, x1);
    const uint32_t bits = x0 ^ x1;
    const float f =
        __fsub_rn(__uint_as_float((bits >> 9) | 0x3F800000u), 1.0f);
    const float u = fmaxf(tiny, __fadd_rn(__fmul_rn(f, span), tiny));
    const size_t i = (size_t)b * V + c;
    if (stage == 0)
      out[i] = -logf(-logf(u));
    else if (stage == 1)
      out[i] = u;
    else
      out[i] = __uint_as_float(bits);
  }
}

}  // namespace tfy

// seeds, index: [B] int32; out: [B, V] float32 (int32 bits for stage 2).
// 0, -1 on arguments the kernel does not take, or the CUDA error of the
// launch.
extern "C" int row_gumbel_launch(const void* seeds, const void* index,
                                 void* out, int B, int V, int stage,
                                 void* stream) {
  if (B <= 0 || B > 65535 || V <= 0 || stage < 0 || stage > 2) return -1;
  const int threads = 256;
  const int per_block = threads * tfy::kColsPerThread;
  const int blocks = (V + per_block - 1) / per_block;
  tfy::row_gumbel_kernel<<<dim3(blocks, B), threads, 0,
                           (cudaStream_t)stream>>>(
      (const int32_t*)seeds, (const int32_t*)index, (float*)out, V, stage);
  return (int)cudaGetLastError();
}
