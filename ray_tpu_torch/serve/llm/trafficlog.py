"""Traffic flight-data recorder + capture codec.

The port's own copy of ``ray_tpu/serve/llm/trafficlog.py``; a capture
made here is byte-identical to the reference's for the same events. An
always-on, bounded `TrafficRecorder` at the fleet ingress appends one
privacy-scrubbed record per request (arrival clock, tenant, lane,
token counts, prefix fingerprint, sampling params incl. per-request
seed, deadline, stream-vs-unary, and the outcome brief), and an armed
capture snapshots that stream into a versioned, checksummed JSONL
format that can be replayed deterministically.

Privacy by construction: records NEVER contain prompt or completion
text. The only content-derived field is the router's prefix-chain
fingerprint (a hash-cons key); sampling params pass through a
numeric allowlist (`sampling_brief`).

Wire discipline mirrors `kv_transport.py`, transposed to text: every
capture line is one segment `RTTC<version> <crc32:08x> <canonical
JSON>`; the first segment is the capture header (capture id + one
wall anchor for the whole capture, monotonic anchor for arrival
math), the last is an `end` segment carrying the record count.
Corruption or truncation anywhere raises a typed `CaptureError` /
`CaptureChecksumError` — never a crash, never a silently short
replay. Stopped captures optionally spool to disk through
`BlackboxSpool` (bounded count+bytes, atomic writes, traversal-safe
reads).
"""

from __future__ import annotations

import collections
import json
import threading
import time
import uuid
import zlib
from typing import Any, Dict, Iterable, List, Optional, Union

from ...llm._internal.blackbox import BlackboxSpool
from ...util import tracing
from ...util.metrics import Counter

CAPTURE_MAGIC = "RTTC"
CAPTURE_VERSION = 1

_RING_CAPACITY = 4096                    # always-on in-memory ring
_CAPTURE_MAX_RECORDS = 200_000           # per-capture record bound
_CAPTURE_MAX_BYTES = 64 * 1024 * 1024    # per-capture byte bound
_SPOOL_CAPACITY = 8                      # captures kept on disk
_SPOOL_MAX_BYTES = 256 * 1024 * 1024

# the sampling-param allowlist: scalar knobs only, never text.
# per-request seed rides here so a replay can re-run the exact
# sampling path (the failover contract, extended to captures).
_PARAM_KEYS = ("max_tokens", "temperature", "top_p", "top_k", "seed")


class CaptureError(RuntimeError):
    """A capture blob failed structural validation (bad magic,
    version skew, malformed segment, truncation)."""


class CaptureChecksumError(CaptureError):
    """A capture segment's payload does not match its crc32."""


# -- the wire format ---------------------------------------------------

def _crc(payload: bytes) -> str:
    return f"{zlib.crc32(payload) & 0xFFFFFFFF:08x}"


def encode_segment(doc: Dict[str, Any]) -> str:
    """One capture segment: magic+version token, crc32 of the
    canonical-JSON payload, then the payload itself."""
    payload = json.dumps(doc, sort_keys=True, separators=(",", ":"))
    return (f"{CAPTURE_MAGIC}{CAPTURE_VERSION} "
            f"{_crc(payload.encode('utf-8'))} {payload}")


def decode_segment(line: str, lineno: int = 0) -> Dict[str, Any]:
    """Validate and decode one segment; every malformed shape maps to
    a typed error naming the line."""
    where = f"segment {lineno}" if lineno else "segment"
    parts = line.split(" ", 2)
    if len(parts) != 3:
        raise CaptureError(f"malformed {where}: expected "
                           f"'<magic> <crc> <json>'")
    tag, crc, payload = parts
    if not tag.startswith(CAPTURE_MAGIC):
        raise CaptureError(f"bad magic in {where}: {tag[:8]!r}")
    ver = tag[len(CAPTURE_MAGIC):]
    if ver != str(CAPTURE_VERSION):
        raise CaptureError(f"unsupported capture version {ver!r} "
                           f"in {where} (have {CAPTURE_VERSION})")
    if _crc(payload.encode("utf-8")) != crc:
        raise CaptureChecksumError(f"checksum mismatch in {where}")
    try:
        doc = json.loads(payload)
    except ValueError as e:
        raise CaptureError(f"bad JSON in {where}: {e}") from None
    if not isinstance(doc, dict) or "kind" not in doc:
        raise CaptureError(f"{where} is not a tagged segment")
    return doc


def decode_capture(blob: Union[str, bytes]) -> Dict[str, Any]:
    """Parse a full capture. Returns {"header", "records", "marks",
    "end"}; raises CaptureError/CaptureChecksumError on any
    corruption or truncation (a capture with no end segment was cut
    mid-write and must not replay as if complete)."""
    if isinstance(blob, bytes):
        try:
            blob = blob.decode("utf-8")
        except UnicodeDecodeError as e:
            raise CaptureError(f"capture is not utf-8: {e}") from None
    lines = [ln for ln in blob.splitlines() if ln.strip()]
    if not lines:
        raise CaptureError("empty capture")
    docs = [decode_segment(ln, i + 1) for i, ln in enumerate(lines)]
    header = docs[0]
    if header.get("kind") != "header":
        raise CaptureError("first segment is not a capture header")
    records = [d for d in docs if d.get("kind") == "record"]
    marks = [d for d in docs if d.get("kind") == "mark"]
    end = docs[-1]
    if end.get("kind") != "end":
        raise CaptureError("truncated capture: no end segment")
    if end.get("records") != len(records):
        raise CaptureError(
            f"truncated capture: end segment says "
            f"{end.get('records')} records, found {len(records)}")
    return {"header": header, "records": records, "marks": marks,
            "end": end}


def load_capture(path: str) -> Dict[str, Any]:
    """decode_capture over a file; I/O failures become CaptureError
    so callers handle exactly one exception family."""
    try:
        with open(path, "rb") as f:
            blob = f.read()
    except OSError as e:
        raise CaptureError(f"cannot read capture {path!r}: {e}") \
            from None
    return decode_capture(blob)


# -- record construction ----------------------------------------------

def sampling_brief(body: Dict[str, Any]) -> Dict[str, Any]:
    """The ONLY reader of the request body on the capture path:
    numeric sampling knobs by allowlist. Text fields (prompt,
    messages, stop strings, ...) are structurally unreachable."""
    out: Dict[str, Any] = {}
    for k in _PARAM_KEYS:
        v = body.get(k)
        if isinstance(v, bool):
            continue
        if isinstance(v, (int, float)):
            out[k] = v
    return out


def traffic_metrics() -> Dict[str, Any]:
    """The recorder's metric families (fleet_metrics() pattern;
    idempotent via the registry)."""
    return {
        "captured": Counter(
            "ray_tpu_llm_traffic_captured_total",
            "Requests recorded by the ingress traffic recorder.",
            ("model",)),
        "capture_bytes": Counter(
            "ray_tpu_llm_traffic_capture_bytes_total",
            "Encoded capture bytes appended while a capture is "
            "armed.",
            ("model",)),
    }


class TrafficRecorder:
    """Always-on bounded request log + armed-capture snapshotter.

    `record()` is on the dispatch hot path: one dict build and a
    deque append under a lock; segment encoding happens only while a
    capture is armed. The ring is the `GET /fleet/debug/traffic`
    surface; captures are the replay artifact."""

    def __init__(self, capacity: int = _RING_CAPACITY,
                 model_id: str = "default",
                 spool_dir: Optional[str] = None,
                 spool_capacity: int = _SPOOL_CAPACITY,
                 spool_max_bytes: int = _SPOOL_MAX_BYTES,
                 max_capture_records: int = _CAPTURE_MAX_RECORDS,
                 max_capture_bytes: int = _CAPTURE_MAX_BYTES,
                 clock=time.monotonic):
        self._ring: collections.deque = collections.deque(
            maxlen=max(1, int(capacity)))
        self._lock = threading.Lock()
        self._seq = 0
        self.dropped = 0
        self.model_id = model_id
        self._clock = clock
        self._max_records = int(max_capture_records)
        self._max_bytes = int(max_capture_bytes)
        self._capture: Optional[Dict[str, Any]] = None
        self._last: Optional[Dict[str, Any]] = None
        self.spool = (BlackboxSpool(spool_dir,
                                    capacity=spool_capacity,
                                    max_bytes=spool_max_bytes)
                      if spool_dir else None)
        m = traffic_metrics()
        self._captured_total = m["captured"]
        self._capture_bytes_total = m["capture_bytes"]

    # -- hot path ------------------------------------------------------
    def record(self, **fields: Any) -> int:
        """Append one record; returns its seq."""
        line = None
        with self._lock:
            self._seq += 1
            seq = self._seq
            if len(self._ring) == self._ring.maxlen:
                self.dropped += 1
            rec = {"kind": "record", "seq": seq, **fields}
            self._ring.append(rec)
            cap = self._capture
            if cap is not None:
                if (cap["records"] >= self._max_records
                        or cap["bytes"] >= self._max_bytes):
                    cap["dropped"] += 1
                else:
                    line = encode_segment(rec)
                    cap["lines"].append(line)
                    cap["records"] += 1
                    cap["bytes"] += len(line) + 1
        # metric publication outside the lock (FlightRecorder rule)
        tags = {"model": self.model_id}
        self._captured_total.inc(1, tags)
        if line is not None:
            self._capture_bytes_total.inc(len(line) + 1, tags)
        return seq

    def observe_request(self, rec: Optional[Dict[str, Any]]) -> None:
        """Fold a FleetManager request record (the `_trace_begin`
        dict, enriched along the dispatch path) into one traffic
        record. Explicit field allowlist — nothing body-derived
        enters except `sampling_brief` scalars and the prefix
        fingerprint."""
        if rec is None:
            return
        t0 = float(rec.get("t0") or 0.0)
        now = self._clock()
        t_first = rec.get("t_first")
        out_tokens = int(rec.get("out_tokens") or 0)
        ttft_ms = None
        itl_ms = None
        if t_first is not None:
            ttft_ms = round(max(t_first - t0, 0.0) * 1e3, 3)
            if out_tokens > 1:
                itl_ms = round(max(now - t_first, 0.0) * 1e3
                               / (out_tokens - 1), 3)
        self.record(
            t_mono=round(t0, 6),
            rid=rec.get("rid") or "",
            method=rec.get("method") or "",
            stream=bool(rec.get("stream")),
            tenant=rec.get("tenant") or "",
            lane=rec.get("lane") or "interactive",
            fp=rec.get("fp") or "",
            prompt_tokens=int(rec.get("prompt_tokens") or 0),
            out_tokens=out_tokens,
            params=dict(rec.get("params") or {}),
            deadline_s=rec.get("deadline_s"),
            outcome={
                "status": rec.get("status") or "ok",
                "finish": rec.get("finish"),
                "route": rec.get("outcome"),
                "replica": rec.get("replica"),
                "failovers": int(rec.get("failovers") or 0),
                "preemptions": int(rec.get("preemptions") or 0),
                "ttft_ms": ttft_ms,
                "itl_ms": itl_ms,
                "e2e_ms": round(max(now - t0, 0.0) * 1e3, 3),
            })

    # -- capture controls ----------------------------------------------
    def start_capture(self, note: str = "") -> Dict[str, Any]:
        with self._lock:
            if self._capture is not None:
                raise CaptureError("capture already active: "
                                   + self._capture["id"])
            cid = uuid.uuid4().hex[:16]
            mono = self._clock()
            header = {
                "kind": "header",
                "object": "traffic_capture",
                "version": CAPTURE_VERSION,
                "capture_id": cid,
                "model": self.model_id,
                # one wall anchor per capture: arrivals are
                # monotonic offsets from mono_anchor; wall_anchor
                # pins them to epoch time
                "mono_anchor": round(mono, 6),
                "wall_anchor": round(tracing.mono_to_epoch(mono), 6),
                "note": str(note)[:256],
            }
            line = encode_segment(header)
            self._capture = {"id": cid, "header": header,
                             "mono_anchor": mono,
                             "lines": [line], "records": 0,
                             "bytes": len(line) + 1, "dropped": 0,
                             "marks": 0}
            return {"capture_id": cid, "active": True}

    def mark(self, label: str = "") -> Dict[str, Any]:
        """Drop a labeled mark segment into the armed capture (the
        'something happened here' flag for later diffing)."""
        with self._lock:
            cap = self._capture
            if cap is None:
                raise CaptureError("no active capture to mark")
            doc = {"kind": "mark", "label": str(label)[:256],
                   "t_mono": round(self._clock(), 6)}
            line = encode_segment(doc)
            cap["lines"].append(line)
            cap["bytes"] += len(line) + 1
            cap["marks"] += 1
            return {"capture_id": cap["id"], "marks": cap["marks"]}

    def stop_capture(self) -> Dict[str, Any]:
        """Seal the armed capture (end segment with the record count
        — the truncation sentinel), retain it as the last capture,
        spool it if a spool is configured."""
        with self._lock:
            cap = self._capture
            if cap is None:
                raise CaptureError("no active capture to stop")
            end = {"kind": "end", "capture_id": cap["id"],
                   "records": cap["records"], "marks": cap["marks"],
                   "dropped": cap["dropped"]}
            cap["lines"].append(encode_segment(end))
            text = "\n".join(cap["lines"]) + "\n"
            self._capture = None
            self._last = {"capture_id": cap["id"], "text": text,
                          "records": cap["records"],
                          "bytes": len(text),
                          "dropped": cap["dropped"],
                          "marks": cap["marks"]}
        spool_id = None
        if self.spool is not None:
            spool_id = self.spool.dump(
                "traffic-" + cap["id"],
                {"capture_id": cap["id"], "capture": text})
        return {"capture_id": cap["id"], "records": cap["records"],
                "bytes": len(text), "dropped": cap["dropped"],
                "marks": cap["marks"], "spool_id": spool_id}

    def export(self) -> str:
        """The last sealed capture's bytes (the replay artifact)."""
        with self._lock:
            if self._last is None:
                raise CaptureError("no sealed capture to export")
            return self._last["text"]

    # -- read surface --------------------------------------------------
    def tail(self, n: int = 64,
             since: Optional[int] = None) -> List[Dict[str, Any]]:
        """Most recent `n` ring records, optionally only those with
        seq > `since` (the satellite-1 cursor discipline)."""
        with self._lock:
            evs: Iterable[Dict[str, Any]] = list(self._ring)
        if since is not None:
            evs = [e for e in evs if e["seq"] > since]
        evs = list(evs)
        return evs[-max(int(n), 0):]

    def stats(self) -> Dict[str, Any]:
        with self._lock:
            cap = self._capture
            active = (None if cap is None else
                      {"capture_id": cap["id"],
                       "records": cap["records"],
                       "bytes": cap["bytes"],
                       "dropped": cap["dropped"],
                       "marks": cap["marks"]})
            last = (None if self._last is None else
                    {k: self._last[k]
                     for k in ("capture_id", "records", "bytes",
                               "dropped", "marks")})
            return {"records": len(self._ring), "total": self._seq,
                    "dropped": self.dropped, "capture": active,
                    "last_capture": last}


__all__ = ["TrafficRecorder", "CaptureError", "CaptureChecksumError",
           "CAPTURE_MAGIC", "CAPTURE_VERSION", "encode_segment",
           "decode_segment", "decode_capture", "load_capture",
           "sampling_brief", "traffic_metrics"]
