"""The RTKV wire: KV sessions and prefixes as bytes between engines.

The port's own copy of the wire half of
``ray_tpu/serve/llm/kv_transport.py`` (this package imports nothing
from the JAX package). A frame made here is byte-identical to the
reference's for the same state, so sessions and prefixes cross between
the two packages in both directions:

    b"RTKV" | u16 version | u32 header_len | header JSON |
    raw array bytes (C order, concatenated) | u32 crc32

The crc32 covers every byte before it; the header records each array's
dtype name, shape and byte count, and arrays round-trip byte-exact. A
corrupted, truncated or lying payload raises `TransportError` (or its
`TransportChecksumError`), which a consumer treats as a failed ship.

Wire v2 carries `kv_dtype` and, for quantized pages, the float32 scale
arrays beside the one-byte value pages (`k_scales`/`v_scales`); v1
frames decode as f32.

Arrays are numpy, or CPU tensors for the dtypes numpy has no name for
without ml_dtypes: bf16 and fp8 pages travel as their raw bytes under
the reference's names (``bfloat16``, ``float8_e4m3fn``) and decode to
torch tensors through a same-size integer view, never upcast. int8
pages and float32 scales are plain numpy.

Host-side only: numpy, torch's CPU tensors and the standard library.
"""

from __future__ import annotations

import base64
import json
import struct
import zlib
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ...llm._internal.kv_offload import TENSOR_DTYPES

MAGIC = b"RTKV"
# v2: kv_dtype in meta + per-(row, head) scale arrays for quantized
# pages. v1 frames (implicitly f32, no scales) still decode.
WIRE_VERSION = 2
SUPPORTED_WIRE_VERSIONS = (1, 2)

# dtype name on the wire -> (numpy type of the raw bytes, torch dtype):
# the types numpy cannot name without ml_dtypes
_RAW = TENSOR_DTYPES
_NAME_OF = {tdt: name for name, (_, tdt) in _RAW.items()}
_BITS = {1: torch.uint8, 2: torch.int16, 4: torch.int32, 8: torch.int64}


class TransportError(RuntimeError):
    """A payload that cannot be decoded (bad magic, truncation, unknown
    version, malformed header): a failed ship, never a crash."""


class TransportChecksumError(TransportError):
    """The payload's crc32 does not match its content: corruption in
    flight."""


def _array_bytes(arr: Any) -> Tuple[str, List[int], bytes]:
    """(dtype name, shape, raw C-order bytes) of a numpy array or a
    tensor, under the names the reference writes."""
    if isinstance(arr, torch.Tensor):
        t = arr.detach().cpu().contiguous()
        name = _NAME_OF.get(t.dtype)
        if name is None:
            arr = t.numpy()
        else:
            raw = t.view(_BITS[t.element_size()]).numpy().tobytes()
            return name, list(t.shape), raw
    arr = np.ascontiguousarray(arr)
    return arr.dtype.name, list(arr.shape), arr.tobytes()


def _from_bytes(name: str, raw: bytes, shape: List[int]) -> Any:
    """Inverse of _array_bytes: numpy (read-only, over the frame) where
    numpy has the dtype, else a CPU tensor of the wire's type."""
    if name in _RAW:
        np_t, tdt = _RAW[name]
        bits = np.frombuffer(raw, dtype=np_t).reshape(shape).copy()
        return torch.from_numpy(bits).view(tdt)
    try:
        dt = np.dtype(name)
    except TypeError:
        raise TransportError(f"unknown array dtype {name!r}")
    return np.frombuffer(raw, dtype=dt).reshape(shape)


def _encode_frame(kind: str, meta: Dict[str, Any],
                  arrays: Sequence[Tuple[str, Any]]) -> bytes:
    """One wire frame: the JSON header (kind, meta, and each array's
    name/dtype/shape/nbytes), the arrays' raw bytes in header order, the
    crc32 of everything before it."""
    blobs: List[bytes] = []
    adesc: List[Dict[str, Any]] = []
    for name, arr in arrays:
        dtype, shape, raw = _array_bytes(arr)
        adesc.append({"name": name, "dtype": dtype, "shape": shape,
                      "nbytes": len(raw)})
        blobs.append(raw)
    header = json.dumps({"kind": kind, "meta": meta,
                         "arrays": adesc},
                        sort_keys=True).encode("utf-8")
    body = (MAGIC + struct.pack("<HI", WIRE_VERSION, len(header))
            + header + b"".join(blobs))
    return body + struct.pack("<I", zlib.crc32(body) & 0xFFFFFFFF)


def _decode_frame(blob: bytes, expect_kind: Optional[str] = None
                  ) -> Tuple[str, Dict[str, Any], Dict[str, Any]]:
    if not isinstance(blob, (bytes, bytearray, memoryview)):
        raise TransportError(
            f"payload must be bytes, got {type(blob).__name__}")
    blob = bytes(blob)
    if len(blob) < len(MAGIC) + 6 + 4:
        raise TransportError("payload truncated (shorter than the "
                             "fixed frame header)")
    if blob[:4] != MAGIC:
        raise TransportError("bad magic (not a KV transport frame)")
    body, (crc,) = blob[:-4], struct.unpack("<I", blob[-4:])
    if zlib.crc32(body) & 0xFFFFFFFF != crc:
        raise TransportChecksumError(
            "payload checksum mismatch (corrupted in flight)")
    version, hlen = struct.unpack("<HI", blob[4:10])
    if version not in SUPPORTED_WIRE_VERSIONS:
        raise TransportError(
            f"unsupported wire version {version} "
            f"(this build speaks {SUPPORTED_WIRE_VERSIONS})")
    if 10 + hlen > len(body):
        raise TransportError("payload truncated (header)")
    try:
        header = json.loads(body[10:10 + hlen].decode("utf-8"))
    except (UnicodeDecodeError, json.JSONDecodeError) as e:
        raise TransportError(f"malformed frame header: {e!r}")
    kind = header.get("kind")
    if expect_kind is not None and kind != expect_kind:
        raise TransportError(
            f"frame kind {kind!r}, expected {expect_kind!r}")
    arrays: Dict[str, Any] = {}
    off = 10 + hlen
    for d in header.get("arrays") or []:
        try:
            n = int(d["nbytes"])
            if off + n > len(body):
                raise TransportError("payload truncated (array body)")
            arrays[str(d["name"])] = _from_bytes(
                str(d["dtype"]), body[off:off + n],
                [int(x) for x in d["shape"]])
        except TransportError:
            raise
        except (ValueError, TypeError, KeyError, RuntimeError) as e:
            # a crc-valid frame whose header lies about its arrays
            # (nbytes not a dtype multiple, shape/size mismatch, missing
            # fields) is still a bad payload
            raise TransportError(f"malformed array descriptor: {e!r}")
        off += n
    if off != len(body):
        raise TransportError("payload has trailing bytes past the "
                             "declared arrays")
    return str(kind), dict(header.get("meta") or {}), arrays


# -- session payloads ---------------------------------------------------

_SESSION_META_KEYS = (
    "request_id", "prompt_tokens", "output_tokens", "params", "lora",
    "priority", "tenant", "restarts", "trace", "deadline_epoch",
    "seed", "position", "last_token", "n_pages")


def _check_quant_arrays(kind: str, arrays: Dict[str, Any],
                        what: str) -> None:
    """Frame self-consistency for quantized payloads: a quantized frame
    with pages carries both scale arrays, each shaped like its page
    array without the trailing head_dim axis; an f32 frame carries
    none."""
    have_k = arrays.get("k") is not None
    ks, vs = arrays.get("k_scales"), arrays.get("v_scales")
    if kind == "f32":
        if ks is not None or vs is not None:
            raise TransportError(
                f"f32 {what} frame carries quant scale arrays")
        return
    if not have_k:
        return                      # cold session: no pages, no scales
    if ks is None or vs is None:
        raise TransportError(
            f"quantized ({kind}) {what} frame is missing its scale "
            f"arrays")
    for name, s in (("k_scales", ks), ("v_scales", vs)):
        page = arrays["k" if name[0] == "k" else "v"]
        if tuple(s.shape) != tuple(page.shape[:-1]):
            raise TransportError(
                f"{what} frame {name} shape {tuple(s.shape)} does not "
                f"match pages {tuple(page.shape)}")


def ship_kind_compatible(frame_kind: Optional[str],
                         engine_kind: str) -> str:
    """Gate an import against the receiving engine's storage kind: a
    mismatch is a failed ship (TransportError), never a
    reinterpretation. Returns the frame's kind (v1 frames: f32)."""
    fk = str(frame_kind or "f32")
    if fk != engine_kind:
        raise TransportError(
            f"KV dtype mismatch: frame pages are {fk!r}, the "
            f"receiving engine serves {engine_kind!r} (fall back to "
            f"token replay)")
    return fk


def encode_session(state: Dict[str, Any]) -> bytes:
    """engine.export_session state -> wire bytes. The KV arrays (and the
    scale arrays of quantized pages) ride raw; the rest is JSON."""
    meta = {k: state.get(k) for k in _SESSION_META_KEYS}
    meta["kv_dtype"] = str(state.get("kv_dtype") or "f32")
    arrays: List[Tuple[str, Any]] = []
    if state.get("k") is not None:
        arrays = [("k", state["k"]), ("v", state["v"])]
        if state.get("k_scales") is not None:
            arrays += [("k_scales", state["k_scales"]),
                       ("v_scales", state["v_scales"])]
    return _encode_frame("session", meta, arrays)


def decode_session(blob: bytes) -> Dict[str, Any]:
    """Wire bytes -> the state engine.import_session takes. v1 frames
    decode as f32 with no scales."""
    _, meta, arrays = _decode_frame(blob, expect_kind="session")
    state = dict(meta)
    state["k"] = arrays.get("k")
    state["v"] = arrays.get("v")
    if (state["k"] is None) != (state["v"] is None):
        raise TransportError("session frame carries only one of k/v")
    if int(state.get("n_pages") or 0) > 0 and state["k"] is None:
        raise TransportError("warm session frame is missing its KV "
                             "page arrays")
    state["kv_dtype"] = str(meta.get("kv_dtype") or "f32")
    _check_quant_arrays(state["kv_dtype"], arrays, "session")
    state["k_scales"] = arrays.get("k_scales")
    state["v_scales"] = arrays.get("v_scales")
    return state


def encode_prefix(tokens: Sequence[int], k: Any, v: Any,
                  k_scales: Optional[Any] = None,
                  v_scales: Optional[Any] = None,
                  kv_dtype: str = "f32") -> bytes:
    """engine.export_prefix output -> wire bytes."""
    arrays: List[Tuple[str, Any]] = [("k", k), ("v", v)]
    if k_scales is not None:
        arrays += [("k_scales", k_scales), ("v_scales", v_scales)]
    return _encode_frame(
        "prefix", {"tokens": [int(t) for t in tokens],
                   "kv_dtype": str(kv_dtype or "f32")}, arrays)


def decode_prefix(blob: bytes) -> Dict[str, Any]:
    """Wire bytes -> {tokens, k, v, k_scales, v_scales, kv_dtype}
    (scales None and kv_dtype "f32" for v1 and f32 frames)."""
    _, meta, arrays = _decode_frame(blob, expect_kind="prefix")
    if "k" not in arrays or "v" not in arrays:
        raise TransportError("prefix frame is missing its KV arrays")
    kind = str(meta.get("kv_dtype") or "f32")
    _check_quant_arrays(kind, arrays, "prefix")
    return {"tokens": [int(t) for t in meta.get("tokens") or []],
            "k": arrays["k"], "v": arrays["v"],
            "k_scales": arrays.get("k_scales"),
            "v_scales": arrays.get("v_scales"),
            "kv_dtype": kind}


def to_b64(blob: bytes) -> str:
    """Payloads cross process boundaries inside JSON bodies."""
    return base64.b64encode(blob).decode("ascii")


def from_b64(payload: str) -> bytes:
    try:
        return base64.b64decode(payload, validate=True)
    except (ValueError, TypeError) as e:    # binascii.Error included
        raise TransportError(f"payload is not valid base64: {e!r}")


__all__ = ["MAGIC", "SUPPORTED_WIRE_VERSIONS", "WIRE_VERSION",
           "TransportChecksumError", "TransportError", "decode_prefix",
           "decode_session", "encode_prefix", "encode_session",
           "from_b64", "ship_kind_compatible", "to_b64"]
