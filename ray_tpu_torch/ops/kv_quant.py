"""Quantized KV-page primitives: int8/fp8 storage with per-row scales.

PyTorch counterpart of ``ray_tpu/ops/kv_quant.py``, with the same
arithmetic bit for bit. A pool shaped ``[L, P, page, KVH, D]`` stores
narrow values (int8 or fp8 e4m3) and beside it a float32 scale pool
``[L, P, page, KVH]``: one scale over each token row's D values per kv
head. A per-row scale keeps the append write-only (a new row never
re-reads its neighbours to recompute a shared scale).

Symmetric absmax: ``scale = max|x| / qmax`` over D, then
``clip(round(x / scale))`` for int8 (round half to even) or a straight
cast for fp8 (the row's absmax lands at 448, the top of e4m3's range).
All-zero rows get scale 0 and dequantize to exact zeros. Dequant is
``q.float() * scale``, the one multiply the CUDA kernels fuse into
their page loads.
"""

from __future__ import annotations

from typing import Tuple

import torch

# kind -> (storage dtype, qmax, bytes per value); "f32" is the identity
# kind (pages in the model's compute dtype, no scale pools)
KV_KINDS = ("f32", "int8", "fp8")
_STORE = {
    "int8": (torch.int8, 127.0, 1),
    "fp8": (torch.float8_e4m3fn, 448.0, 1),
}
# float32 scale per (token row, kv head)
SCALE_BYTES = 4


def validate_kind(kind: str) -> str:
    if kind not in KV_KINDS:
        raise ValueError(
            f"kv_dtype must be one of {KV_KINDS}, got {kind!r}")
    return kind


def is_quantized(kind: str) -> bool:
    return validate_kind(kind) != "f32"


def storage_dtype(kind: str, compute_dtype: torch.dtype = torch.float32):
    """torch dtype a KV pool of `kind` is allocated in: the narrow type,
    or for "f32" the model's compute dtype (what the engines allocate)."""
    if validate_kind(kind) == "f32":
        return compute_dtype
    return _STORE[kind][0]


def qmax(kind: str) -> float:
    return _STORE[validate_kind(kind)][1]


def value_bytes(kind: str) -> int:
    """Bytes per stored KV value (no scale overhead); 4 for "f32", as
    the reference counts it."""
    if validate_kind(kind) == "f32":
        return 4
    return _STORE[kind][2]


def token_row_bytes(kind: str, n_kv_heads: int, head_dim: int) -> int:
    """Bytes one token row of one of k/v takes in one layer: values plus
    the per-(row, head) scales."""
    vals = n_kv_heads * head_dim * value_bytes(kind)
    if kind == "f32":
        return vals
    return vals + n_kv_heads * SCALE_BYTES


def scale_shape(pool_shape: Tuple[int, ...]) -> Tuple[int, ...]:
    """Scale-pool shape for a pool shaped [..., KVH, D]: drop D."""
    return tuple(pool_shape[:-1])


def quantize_rows(x: torch.Tensor, kind: str
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Rows [..., KVH, D] -> (q [..., KVH, D] narrow, scales [..., KVH]
    float32)."""
    if not is_quantized(kind):
        raise ValueError("quantize_rows: kind must be int8/fp8")
    dt, qm, _ = _STORE[kind]
    x = x.float()
    scales = x.abs().amax(dim=-1) / qm
    # zero rows: divide by 1 instead of 0; scale 0 zeroes the dequant
    safe = torch.where(scales > 0.0, scales, torch.ones_like(scales))
    y = x / safe[..., None]
    if kind == "int8":
        q = torch.clamp(torch.round(y), -qm, qm).to(dt)
    else:
        q = y.to(dt)
    return q, scales


def dequantize_rows(q: torch.Tensor, scales: torch.Tensor,
                    kind: str) -> torch.Tensor:
    """Inverse of quantize_rows: float32 [..., KVH, D]."""
    if not is_quantized(kind):
        raise ValueError("dequantize_rows: kind must be int8/fp8")
    return q.float() * scales.float()[..., None]


def kind_of(dtype: torch.dtype) -> str:
    """The quantized kind whose pools are stored in `dtype`."""
    for kind, (dt, _, _) in _STORE.items():
        if dt == dtype:
            return kind
    raise TypeError(f"{dtype} is not a quantized KV storage dtype "
                    f"(int8 or float8_e4m3fn)")
