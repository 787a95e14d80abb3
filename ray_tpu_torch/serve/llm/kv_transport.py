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

The fleet half (`prompt_char_len`, the replica roles,
`TransportConfig`, `FleetPrefixStore` and `transport_metrics`) is the
policy that ``fleet.py`` layers over the wire: disaggregated prefill,
drain migration, failover-by-restore and the fleet prefix store.

Host-side only: numpy, torch's CPU tensors and the standard library.
"""

from __future__ import annotations

import base64
import dataclasses
import json
import struct
import zlib
from collections import OrderedDict
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ...llm._internal.kv_offload import TENSOR_DTYPES
from ...util import metrics as metrics_api

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


def prompt_char_len(body: Dict[str, Any]) -> int:
    """Prompt length in characters — the disaggregation trigger reads
    the same canonical text prefix_fingerprint hashes (prompt string,
    or the role-tagged chat rendering)."""
    if body.get("prompt") is not None:
        return len(str(body["prompt"]))
    return sum(len(str(m.get("role", ""))) + len(str(m.get("content",
                                                           "")))
               for m in (body.get("messages") or []))


# -- fleet policy -------------------------------------------------------

ROLE_PREFILL = "prefill"
ROLE_DECODE = "decode"
ROLE_MIXED = "mixed"
REPLICA_ROLES = (ROLE_PREFILL, ROLE_DECODE, ROLE_MIXED)


@dataclasses.dataclass
class TransportConfig:
    """Fleet KV-shipping policy (FleetManager(transport=...); None =
    the transport is off: no handoff, no migration, no prefix store)."""
    # (a) disaggregated prefill/decode: prompts at least this many
    # characters long are prefilled on a `prefill`-role replica and
    # handed to a decode replica (no-op without prefill replicas)
    enable_disagg: bool = True
    disagg_prompt_chars: int = 256
    # (b) live migration: drain-before-downscale ships parked
    # sessions instead of replaying, and stream failover tries an
    # export-restore fast path before falling back to replay
    enable_migration: bool = True
    # (c) fleet prefix store: prompts whose ROUTER-DEPTH prefix is at
    # least this long are published once and seeded into every
    # replica that serves the prefix
    enable_prefix_store: bool = True
    prefix_min_chars: int = 64
    prefix_store_bytes: int = 256 << 20
    # bound on every export/import control call (a wedged replica
    # must not stall a drain or a failover decision)
    ship_timeout_s: float = 10.0


@dataclasses.dataclass
class _PrefixEntry:
    payload: str                 # b64 wire frame (encode_prefix)
    nbytes: int
    tokens: int                  # full-page token count stored
    publisher: str               # replica that exported it
    seeded: set = dataclasses.field(default_factory=set)
    hits: int = 0                # lookups that found this entry
    last_seq: int = 0            # recency stamp (store-wide counter)


class FleetPrefixStore:
    """Fleet-shared prefix tier: prefix fingerprint → serialized full
    prompt pages, byte-bounded. Lives in the ingress process (one per
    FleetManager); replicas are SEEDED lazily — the first time the
    router lands a stored prefix on a replica that has not seen it,
    the fleet imports the pages there before dispatching, so the
    replica's own prefix cache hits exactly as if it had prefilled
    the prompt itself.

    Eviction is HIT-FREQUENCY-WEIGHTED, not LRU-by-bytes: under byte
    pressure the victim is the entry with the lowest hits-per-byte
    score (ties broken least-recently-used). A hot small system
    prompt — the store's whole reason to exist — therefore outlives a
    cold large prefix that happens to have arrived later, where pure
    LRU would churn the hot entry out the moment a burst of large cold
    prefixes passed through."""

    def __init__(self, capacity_bytes: int = 256 << 20):
        self.capacity_bytes = int(capacity_bytes)
        self._entries: "OrderedDict[str, _PrefixEntry]" = OrderedDict()
        self._seq = 0
        self.bytes_used = 0
        self.publishes = 0
        self.hits = 0                # imports that seeded a replica
        self.evictions = 0

    def __contains__(self, fp: str) -> bool:
        return fp in self._entries

    def __len__(self) -> int:
        return len(self._entries)

    def get(self, fp: str) -> Optional[_PrefixEntry]:
        ent = self._entries.get(fp)
        if ent is not None:
            self._seq += 1
            ent.hits += 1
            ent.last_seq = self._seq
        return ent

    @staticmethod
    def _score(ent: _PrefixEntry) -> "Tuple[float, int]":
        """Eviction priority, LOWEST evicted first: hit frequency per
        byte (a hot small entry scores far above a cold large one),
        recency as the tie-break. New entries start at 0 hits — they
        must earn their residency."""
        return (ent.hits / max(ent.nbytes, 1), ent.last_seq)

    def put(self, fp: str, payload: str, tokens: int,
            publisher: str) -> Optional[_PrefixEntry]:
        """Store one published prefix (publisher counts as seeded).
        Oversized payloads are refused rather than thrashing the
        whole store."""
        if fp in self._entries:
            return self._entries[fp]
        nbytes = len(payload)
        if nbytes > self.capacity_bytes:
            return None
        while self.bytes_used + nbytes > self.capacity_bytes \
                and self._entries:
            victim = min(self._entries,
                         key=lambda k: self._score(self._entries[k]))
            old = self._entries.pop(victim)
            self.bytes_used -= old.nbytes
            self.evictions += 1
        self._seq += 1
        ent = _PrefixEntry(payload=payload, nbytes=nbytes,
                           tokens=tokens, publisher=publisher,
                           seeded={publisher}, last_seq=self._seq)
        self._entries[fp] = ent
        self.bytes_used += nbytes
        self.publishes += 1
        return ent

    def stats(self) -> Dict[str, Any]:
        return {
            "entries": len(self._entries),
            "bytes_used": self.bytes_used,
            "capacity_bytes": self.capacity_bytes,
            "policy": "hit-frequency-weighted",
            "publishes": self.publishes,
            "hits": self.hits,
            "evictions": self.evictions,
            "seeded_replicas": sorted(
                {r for e in self._entries.values() for r in e.seeded}),
        }


def transport_metrics() -> Dict[str, Any]:
    """The fleet transport metric families, registered idempotently
    in the ingress process registry (same pattern as the failure
    plane's fleet_metrics)."""
    C = metrics_api.Counter
    return {
        "sessions_shipped": C(
            "ray_tpu_llm_kv_sessions_shipped_total",
            "parked sessions shipped between replicas, by consumer "
            "(disagg | migration | restore)", ("model", "kind")),
        "ship_bytes": C(
            "ray_tpu_llm_kv_ship_bytes_total",
            "serialized KV transport bytes, by direction (export = "
            "off a replica, import = onto one)",
            ("model", "direction")),
        "prefix_store_hits": C(
            "ray_tpu_llm_prefix_store_hits_total",
            "fleet prefix-store entries seeded into a replica that "
            "had not prefilled the prefix itself", ("model",)),
    }


__all__ = ["FleetPrefixStore", "MAGIC", "REPLICA_ROLES", "ROLE_DECODE",
           "ROLE_MIXED", "ROLE_PREFILL", "SUPPORTED_WIRE_VERSIONS",
           "TransportChecksumError", "TransportConfig", "TransportError",
           "WIRE_VERSION", "decode_prefix", "decode_session",
           "encode_prefix", "encode_session", "from_b64",
           "prompt_char_len", "ship_kind_compatible", "to_b64",
           "transport_metrics"]
