"""Spans, Chrome-trace export and context propagation.

A copy of ``ray_tpu/util/tracing/__init__.py`` with no change in
behaviour: spans are recorded in a process-local ring and exported as
Chrome trace events ("traceEvents" JSON); enable with RAY_TPU_TRACE=1
or ``enable()``. Timestamps come from the monotonic clock, rendered as
epoch time through one per-process anchor (``mono_to_epoch``), so
events of several processes align and a step of the wall clock moves
no duration. ``flush_to_kv`` publishes a worker's new events to the
controller KV of the port's runtime (``ray_tpu_torch.init``), and
``collect_cluster`` merges them into the driver's trace.
"""

from __future__ import annotations

import collections
import contextlib
import contextvars
import itertools
import json
import os
import threading
import time
from typing import Any, Dict, List, Optional

_MAX_EVENTS = 100_000


class BoundedRing:
    """Thread-safe deque(maxlen) ring with displacement accounting —
    the shared bounded-buffer primitive (this module's event ring, the
    serve.llm ingress trace buffer). A true ring: at capacity the
    OLDEST item is displaced and counted, so a long-lived process
    keeps the events that matter and a truncated buffer is legible as
    truncated (`stats()["dropped"]`)."""

    def __init__(self, capacity: int):
        self._ring: "collections.deque[Any]" = collections.deque(
            maxlen=capacity)
        self._lock = threading.Lock()
        self.total = 0               # ever appended (monotone)
        self.dropped = 0             # displaced by the capacity bound

    def append(self, *items: Any) -> int:
        """Append items; returns the new monotone total."""
        with self._lock:
            for it in items:
                if len(self._ring) == self._ring.maxlen:
                    self.dropped += 1
                self._ring.append(it)
                self.total += 1
            return self.total

    def items(self) -> List[Any]:
        with self._lock:
            return list(self._ring)

    def stats(self) -> Dict[str, int]:
        with self._lock:
            return {"capacity": self._ring.maxlen or 0,
                    "events": len(self._ring), "total": self.total,
                    "dropped": self.dropped}

    def clear(self) -> None:
        with self._lock:
            self._ring.clear()
            self.total = 0
            self.dropped = 0

    def tail_since(self, since_total: int) -> "tuple[List[Any], int]":
        """Items appended after the `since_total`-th append that are
        still resident (displaced ones are gone — counted, not
        recoverable), plus the current total. The incremental-flush
        primitive."""
        with self._lock:
            n = min(self.total - since_total, len(self._ring))
            if n <= 0:
                return [], self.total
            return (list(itertools.islice(
                self._ring, len(self._ring) - n, len(self._ring))),
                self.total)


# the process event ring (ring_stats() exposes its displaced count;
# /debug/trace surfaces it in metadata)
_ring = BoundedRing(_MAX_EVENTS)
_enabled = bool(os.environ.get("RAY_TPU_TRACE"))
_span_counter = itertools.count(1)

# One wall-clock anchor per process: durations
# and ordering must come from the MONOTONIC clock — an NTP step in
# time.time() would otherwise skew every latency histogram and
# misorder trace events — while cross-process trace alignment needs
# epoch timestamps. The anchor is sampled once at import; converting
# monotonic stamps through it yields epoch-like timestamps whose
# DIFFERENCES are NTP-immune for the life of the process.
_MONO_ANCHOR = time.time() - time.monotonic()


def wall_anchor() -> float:
    """This process's wall-clock anchor (epoch - monotonic at import)."""
    return _MONO_ANCHOR


def mono_to_epoch(mono_ts: float) -> float:
    """Monotonic timestamp -> epoch seconds via the process anchor."""
    return _MONO_ANCHOR + mono_ts
# the ambient span: {"trace_id", "span_id"} (reference: the OTel
# current-span context _DictPropagator serializes into task specs)
_current: "contextvars.ContextVar[Optional[Dict[str, str]]]" = \
    contextvars.ContextVar("ray_tpu_trace_ctx", default=None)


def current_context() -> Optional[Dict[str, str]]:
    """The ambient span context ({"trace_id","span_id"}) or None."""
    return _current.get()


def _new_span_id() -> str:
    return f"{os.getpid():x}.{next(_span_counter):x}"


def new_span_id() -> str:
    """Mint a process-unique span/trace/flow id (public: the serve.llm
    fleet ingress mints trace contexts without opening a span)."""
    return _new_span_id()


def _append(*evs: Dict[str, Any]) -> None:
    _ring.append(*evs)


def inject_context() -> Optional[Dict[str, str]]:
    """Serialize the ambient context for a task spec; emits the
    Perfetto flow-start so the consumer side can draw the arrow.
    Returns None when tracing is off or no span is open."""
    ctx = _current.get()
    if not _enabled or ctx is None:
        return None
    # one flow id PER SUBMISSION: reusing the span id would chain every
    # task submitted under one driver span into a single flow path
    flow_id = _new_span_id()
    now = mono_to_epoch(time.monotonic()) * 1e6
    _append({
        "name": "submit", "cat": "flow", "ph": "s",
        "id": flow_id, "ts": now,
        "pid": os.getpid(),
        "tid": threading.get_ident() % 100000})
    return {**ctx, "flow_id": flow_id}


def enable() -> None:
    global _enabled
    _enabled = True


def disable() -> None:
    global _enabled
    _enabled = False


def is_enabled() -> bool:
    return _enabled


@contextlib.contextmanager
def span(name: str, category: str = "task",
         parent: Optional[Dict[str, str]] = None, **attrs):
    """Record one duration span (no-op unless tracing is enabled).

    `parent` is a propagated context from inject_context() (a task spec
    crossing processes): the span joins that trace and emits the
    Perfetto flow-finish binding it to the submitter's arrow. Without
    `parent`, the span nests under the ambient span of this process.
    Yields the span context dict when tracing is ON and None when OFF —
    guard any use of the yielded value."""
    if not _enabled:
        yield
        return
    prev = _current.get()
    remote_parent = parent is not None
    parent = parent or prev
    ctx = {"trace_id": (parent or {}).get("trace_id") or _new_span_id(),
           "span_id": _new_span_id()}
    token = _current.set(ctx)
    # monotonic for the duration (NTP-step immune), rendered as epoch
    # through the per-process anchor so cross-process events align
    start = time.monotonic()
    try:
        yield ctx
    finally:
        end = time.monotonic()
        _current.reset(token)
        tid = threading.get_ident() % 100000
        start_us = mono_to_epoch(start) * 1e6
        evs = []
        if remote_parent:
            evs.append({
                "name": "submit", "cat": "flow", "ph": "f",
                "bp": "e",
                "id": parent.get("flow_id", parent["span_id"]),
                "ts": start_us, "pid": os.getpid(),
                "tid": tid})
        evs.append({
            "name": name, "cat": category, "ph": "X",
            "ts": start_us, "dur": (end - start) * 1e6,
            "pid": os.getpid(), "tid": tid,
            "args": {**attrs,
                     "trace_id": ctx["trace_id"],
                     "span_id": ctx["span_id"],
                     **({"parent_span_id": parent["span_id"]}
                        if parent else {})},
        })
        _append(*evs)


def complete_event(name: str, category: str, start_s: float,
                   dur_s: float, pid: Optional[int] = None,
                   tid: int = 0,
                   args: Optional[Dict[str, Any]] = None
                   ) -> Dict[str, Any]:
    """Build one Chrome-trace complete ("X") event dict from epoch
    SECONDS — the same schema span() emits (ts/dur in microseconds),
    for code that only knows a span's bounds after the fact (the LLM
    engine's request-lifecycle timelines render through this so the
    two event sources stay field-compatible in one viewer)."""
    return {"name": name, "cat": category, "ph": "X",
            "ts": start_s * 1e6, "dur": max(dur_s, 0.0) * 1e6,
            "pid": os.getpid() if pid is None else pid,
            "tid": tid, "args": dict(args or {})}


def instant_event(name: str, category: str, ts_s: float,
                  pid: Optional[int] = None, tid: int = 0,
                  args: Optional[Dict[str, Any]] = None
                  ) -> Dict[str, Any]:
    """Chrome-trace instant ("i") event at epoch seconds (thread
    scope) — point-in-time marks like a prefill chunk landing."""
    return {"name": name, "cat": category, "ph": "i", "s": "t",
            "ts": ts_s * 1e6,
            "pid": os.getpid() if pid is None else pid,
            "tid": tid, "args": dict(args or {})}


def get_events() -> List[Dict[str, Any]]:
    return _ring.items()


def ring_stats() -> Dict[str, int]:
    """Ring fill level + displacement: `dropped` counts events the
    capacity bound displaced (surfaced in /debug/trace metadata so a
    truncated trace is legible as truncated, not complete)."""
    return _ring.stats()


def clear() -> None:
    global _flushed_upto
    _ring.clear()
    _flushed_upto = 0


_last_flush = 0.0
_flushed_upto = 0
_flush_seq = 0


def flush_to_kv(min_interval_s: float = 1.0) -> None:
    """Publish this process's NEW events to the controller KV so the
    driver can assemble a CLUSTER trace. Incremental: each flush ships
    only the events recorded since the last one (chunked keys
    __trace__/{wid}/{seq}), so cost is O(new), not O(ring). Workers
    call this after traced executions (rate-limited), on a trailing
    timer, and at shutdown with min_interval_s=0."""
    global _last_flush, _flushed_upto, _flush_seq
    now = time.monotonic()
    if now - _last_flush < min_interval_s:
        return
    from .._private import state as _state
    client = _state.current_client_or_none()
    if client is None:
        return
    # NEW events addressed by the ring's monotone append counter —
    # events displaced before a flush are simply gone (counted in
    # ring_stats()["dropped"])
    new, total = _ring.tail_since(_flushed_upto)
    if not new:
        return
    _flushed_upto = total
    _flush_seq += 1
    seq = _flush_seq
    _last_flush = now
    wid = getattr(client, "worker_id", None) or f"pid{os.getpid()}"
    key = f"__trace__/{wid}/{seq:06d}"
    blob = json.dumps(new).encode()
    try:
        if client.loop_runner.on_loop_thread():
            # worker RPC handlers run ON the loop: fire-and-forget the
            # put (the sync kv_put would deadlock-guard and raise)
            client.loop_runner.call_soon(client._controller().call(
                "kv_put", key=key, value=blob, overwrite=True))
        else:
            client.kv_put(key, blob)
    except Exception:
        pass


def collect_cluster() -> List[Dict[str, Any]]:
    """This process's events merged with every flushed worker ring —
    the cross-process trace (flow arrows pair up across pids because
    timestamps are epoch-based)."""
    from .._private import state as _state
    events = get_events()
    client = _state.current_client_or_none()
    if client is None:
        return events
    try:
        for key in client.controller_rpc("kv_keys", prefix="__trace__/"):
            blob = client.kv_get(key)
            if blob:
                events.extend(json.loads(blob))
    except Exception:
        pass
    return events


def export_chrome_trace(path: Optional[str] = None,
                        cluster: bool = False) -> str:
    """Write (or return) the Chrome trace JSON — this process's ring,
    or (cluster=True) merged with every flushed worker's."""
    doc = json.dumps({
        "traceEvents": collect_cluster() if cluster else get_events(),
        "displayTimeUnit": "ms"})
    if path:
        with open(path, "w") as f:
            f.write(doc)
    return doc


__all__ = ["enable", "disable", "is_enabled", "span", "get_events",
           "clear", "export_chrome_trace", "inject_context",
           "current_context", "flush_to_kv", "collect_cluster",
           "complete_event", "instant_event", "ring_stats",
           "new_span_id", "wall_anchor", "mono_to_epoch",
           "BoundedRing"]
