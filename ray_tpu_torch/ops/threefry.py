"""JAX's threefry2x32 sampling noise, in PyTorch, and its CUDA kernel.

Counterpart of what the JAX engine gets from ``jax.random`` when it
samples (``ray_tpu/llm/_internal/engine.py``: ``_row_sample_keys`` keys
each row with ``fold_in(PRNGKey(seed), index)``, and ``_sample`` draws
``jax.vmap(jax.random.categorical)(row_keys, filtered)``). The functions
follow JAX 0.9.0's ``jax/_src/prng.py`` and ``jax/_src/random.py`` as
configured by default: ``jax_default_prng_impl`` is "threefry2x32",
``jax_threefry_partitionable`` is True (random bits come from a 64-bit
iota counter split into (hi, lo) words, and 32-bit draws are
``bits1 ^ bits2``), and ``jax_high_dynamic_range_gumbel`` is False (the
Gumbel draw takes mode "low": one uniform in [tiny, 1)).

uint32 arithmetic runs in int64 tensors masked with ``& 0xFFFFFFFF``
(torch's uint32 support is partial). Keys are pairs ``(k1, k2)`` of such
tensors, batched over any leading shape. Float steps keep JAX's order.
Keys, bits and uniforms are bit-equal to JAX's; Gumbel values differ
from JAX's only where the two ``log`` implementations round apart
(``tests/test_torch_threefry.py`` states the bound).

``row_gumbel`` is the sampler's entry: the noise of the token at
absolute index ``index[b]`` of the request seeded ``seeds[b]``. CPU
tensors take the plain version (``row_noise_plain``); CUDA tensors
launch ``csrc/threefry.cu`` (a thread per row and 4 vocab columns) or
raise.
"""

from __future__ import annotations

from typing import Tuple

import torch

from . import _kernels

M32 = 0xFFFFFFFF
_PARITY = 0x1BD11BDA
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
TINY = torch.finfo(torch.float32).tiny

Key = Tuple[torch.Tensor, torch.Tensor]


def _rotl(x: torch.Tensor, r: int) -> torch.Tensor:
    return ((x << r) & M32) | (x >> (32 - r))


def threefry2x32(k1: torch.Tensor, k2: torch.Tensor, x1: torch.Tensor,
                 x2: torch.Tensor) -> Key:
    """The Threefry-2x32 hash of counter words (x1, x2) under key
    (k1, k2): 20 rounds, a key injection every 4 (prng.py
    ``_threefry2x32_lowering``). int64 tensors of uint32 values,
    broadcast together."""
    ks = (k1, k2, k1 ^ k2 ^ _PARITY)
    x1 = (x1 + ks[0]) & M32
    x2 = (x2 + ks[1]) & M32
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x1 = (x1 + x2) & M32
            x2 = _rotl(x2, r) ^ x1
        x1 = (x1 + ks[(i + 1) % 3]) & M32
        x2 = (x2 + ks[(i + 2) % 3] + (i + 1)) & M32
    return x1, x2


def prng_key(seeds: torch.Tensor) -> Key:
    """``jax.random.PRNGKey`` of 32-bit integer seeds: (0, seed as
    uint32) (prng.py ``threefry_seed``: the high word is the seed
    shifted right by 32, which is 0 for a 32-bit seed)."""
    k2 = seeds.to(torch.int64) & M32
    return torch.zeros_like(k2), k2


def fold_in(key: Key, data: torch.Tensor) -> Key:
    """``jax.random.fold_in``: the hash of the counter (0, data as
    uint32) under the key (prng.py ``threefry_fold_in``)."""
    k1, k2 = key
    d = data.to(torch.int64) & M32
    return threefry2x32(k1, k2, torch.zeros_like(d), d)


def random_bits(key: Key, n: int) -> torch.Tensor:
    """``jax.random.bits(key, (n,))``, uint32 values in int64, shape
    key's + (n,): the hash of the iota counter (hi 0, lo column), and
    its two words xor'ed (prng.py ``_threefry_random_bits_partitionable``)."""
    k1, k2 = key
    lo = torch.arange(n, dtype=torch.int64, device=k1.device)
    b1, b2 = threefry2x32(k1[..., None], k2[..., None],
                          torch.zeros_like(lo), lo)
    return b1 ^ b2


def uniform(key: Key, n: int, minval: float = 0.0,
            maxval: float = 1.0) -> torch.Tensor:
    """``jax.random.uniform(key, (n,), float32, minval, maxval)``: the 23
    high bits as the mantissa of a float in [1, 2), minus 1, scaled, then
    raised to minval (random.py ``_uniform``). Bit-equal where
    maxval - minval rounds to 1.0, as in the sampler; over a wider range
    a backend that fuses the scaling into one fma (XLA's CPU backend
    does) can round an ulp apart."""
    bits = random_bits(key, n)
    f = (((bits >> 9) | 0x3F800000).to(torch.int32).view(torch.float32)
         - 1.0)
    lo = torch.tensor(minval, dtype=torch.float32, device=f.device)
    hi = torch.tensor(maxval, dtype=torch.float32, device=f.device)
    return torch.maximum(lo, f * (hi - lo) + lo)


def gumbel(key: Key, n: int) -> torch.Tensor:
    """``jax.random.gumbel(key, (n,), float32)`` in mode "low"
    (random.py ``_gumbel``)."""
    return -torch.log(-torch.log(uniform(key, n, TINY, 1.0)))


def categorical(key: Key, logits: torch.Tensor) -> torch.Tensor:
    """``jax.random.categorical(key, logits)`` over the last axis, with
    replacement: argmax of Gumbel noise plus logits (random.py
    ``categorical``)."""
    return torch.argmax(gumbel(key, logits.shape[-1]) + logits, dim=-1)


def row_keys(seeds: torch.Tensor, index: torch.Tensor) -> Key:
    """The JAX engine's ``_row_sample_keys``: fold the absolute index of
    the token being sampled into the key of the request's seed."""
    return fold_in(prng_key(seeds), index)


STAGES = ("gumbel", "uniform", "bits")


def row_noise_plain(seeds: torch.Tensor, index: torch.Tensor, vocab: int,
                    stage: str = "gumbel") -> torch.Tensor:
    """(B, vocab) noise of row keys ``fold_in(PRNGKey(seeds[b]),
    index[b])`` at one of its stages: "gumbel" (float32, what
    ``jax.random.gumbel(key, (vocab,))`` gives), "uniform" (its float32
    uniform in [tiny, 1)) or "bits" (its 32 random bits, as int32). The
    plain version of the kernel."""
    key = row_keys(seeds, index)
    if stage == "gumbel":
        return gumbel(key, vocab)
    if stage == "uniform":
        return uniform(key, vocab, TINY, 1.0)
    if stage == "bits":
        bits = random_bits(key, vocab)
        return (bits - ((bits >> 31) << 32)).to(torch.int32)
    raise ValueError(f"stage must be one of {STAGES}, got {stage!r}")


def _check(seeds: torch.Tensor, index: torch.Tensor, vocab: int) -> None:
    if seeds.dim() != 1 or index.shape != seeds.shape:
        raise ValueError(f"seeds and index must be [B], got "
                         f"{tuple(seeds.shape)} and {tuple(index.shape)}")
    if seeds.dtype != torch.int32 or index.dtype != torch.int32:
        raise TypeError("seeds and index must be int32")
    if index.device != seeds.device:
        raise ValueError("seeds and index must be on one device")
    if not (seeds.is_contiguous() and index.is_contiguous()):
        raise ValueError("seeds and index must be contiguous")
    if not 0 < seeds.shape[0] <= 65535 or vocab <= 0:
        raise ValueError(f"B {seeds.shape[0]} (1..65535) and vocab "
                         f"{vocab} (> 0)")


def row_noise(seeds: torch.Tensor, index: torch.Tensor, vocab: int,
              stage: str = "gumbel") -> torch.Tensor:
    """``row_noise_plain`` for CPU tensors; on CUDA tensors, the noise
    kernel (``csrc/threefry.cu``), launched on the current stream. seeds
    and index: [B] int32 device tensors (a CUDA graph replays the launch
    with whatever they hold). The sampler takes stage "gumbel"; the
    other two stages exist to hold the kernel's bits and uniforms to
    JAX's, which are bit-equal."""
    _check(seeds, index, vocab)
    if stage not in STAGES:
        raise ValueError(f"stage must be one of {STAGES}, got {stage!r}")
    if seeds.device.type == "cpu":
        return row_noise_plain(seeds, index, vocab, stage)
    if seeds.device.type != "cuda":
        raise ValueError(f"row_noise: no kernel for device {seeds.device}")
    b = seeds.shape[0]
    out = torch.empty((b, vocab), device=seeds.device,
                      dtype=torch.int32 if stage == "bits"
                      else torch.float32)
    kernel = _kernels.ROW_GUMBEL
    fn = kernel.fn()
    idx = seeds.device.index
    args = (seeds.data_ptr(), index.data_ptr(), out.data_ptr(), b, vocab,
            STAGES.index(stage))
    if idx == torch.cuda.current_device():
        rc = fn(*args, torch._C._cuda_getCurrentRawStream(idx))
    else:
        with torch.cuda.device(seeds.device):
            rc = fn(*args, torch._C._cuda_getCurrentRawStream(idx))
    _kernels.check(rc, kernel.name)
    kernel.count("cuda")
    return out


def row_gumbel(seeds: torch.Tensor, index: torch.Tensor,
               vocab: int) -> torch.Tensor:
    """The sampler's (B, vocab) float32 Gumbel noise (``row_noise``,
    stage "gumbel"): row b is what ``jax.random.gumbel(fold_in(
    PRNGKey(seeds[b]), index[b]), (vocab,))`` gives, so
    ``argmax(filtered + row_gumbel)`` is the JAX engine's categorical
    draw. The plain version on CPU tensors, the kernel on CUDA
    tensors."""
    return row_noise(seeds, index, vocab)
