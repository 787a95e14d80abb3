"""Fleet trace assembly: ingress span buffer + cross-replica merge.

The port's own copy of ``ray_tpu/serve/llm/tracemerge.py``. The fleet
ingress mints a trace context per request (util.tracing ids) and
records its own side of the story — admission wait, routing decision,
end-to-end span — into a bounded IngressTraceBuffer as Chrome-trace
events. Each replica's engine telemetry renders the same request's
lifecycle spans tagged with the SAME trace id (the context rides the
request body) and emits the Perfetto flow-finish bound to the
ingress's flow-start, so the merged document draws an arrow from the
routing decision into the replica's prefill/decode spans.

`merge_fleet_traces` time-aligns (every source renders monotonic
stamps through its own process wall anchor into epoch microseconds),
dedups the shared process tracing ring (in-process replicas each merge
the same ring into their doc), applies `request_id` / `trace_id`
filters, and carries per-source metadata — including each ring's
dropped-event count — so a truncated trace is legible as truncated.
"""

from __future__ import annotations

import itertools
import json
import os
import time
from typing import Any, Dict, List, Optional

from ...util import tracing

_INGRESS_RING = 4096        # ingress trace events retained


class IngressTraceBuffer:
    """Bounded ring of Chrome-trace events recorded at the fleet
    ingress (one tid per request; thread_name metadata rows included).
    Storage is the shared tracing.BoundedRing — same displacement
    accounting as the process tracing ring."""

    def __init__(self, capacity: int = _INGRESS_RING):
        self._ring = tracing.BoundedRing(capacity)
        self._tid = itertools.count(1)

    def next_tid(self) -> int:
        return next(self._tid)

    def add(self, *events: Dict[str, Any]) -> None:
        self._ring.append(*events)

    def events(self) -> List[Dict[str, Any]]:
        return self._ring.items()

    def stats(self) -> Dict[str, int]:
        return self._ring.stats()


def request_events(tid: int, rid: str, trace: Dict[str, str],
                   t_queued: float, t_admitted: Optional[float],
                   t_routed: Optional[float], t_done: float,
                   replica: Optional[str], outcome: Optional[str],
                   method: str, tenant: str, status: str
                   ) -> List[Dict[str, Any]]:
    """Build the ingress-side Chrome events for ONE completed request
    (monotonic inputs; rendered epoch-aligned via the process anchor).
    The routing-decision span carries the Perfetto flow-start whose
    matching finish the replica's telemetry emits."""
    pid = os.getpid()
    wall = tracing.mono_to_epoch
    args = {"request_id": rid, "trace_id": trace["trace_id"]}
    evs: List[Dict[str, Any]] = [
        {"ph": "M", "name": "thread_name", "pid": pid, "tid": tid,
         "args": {"name": f"ingress {rid}"}},
        tracing.complete_event(
            "fleet_request", "fleet", wall(t_queued),
            t_done - t_queued, pid=pid, tid=tid,
            args={**args, "method": method, "tenant": tenant,
                  "status": status,
                  **({"replica": replica} if replica else {})}),
    ]
    if t_admitted is not None:
        evs.append(tracing.complete_event(
            "admission_wait", "fleet", wall(t_queued),
            t_admitted - t_queued, pid=pid, tid=tid, args=dict(args)))
    if t_routed is not None and replica is not None:
        t0 = t_admitted if t_admitted is not None else t_queued
        evs.append(tracing.complete_event(
            "routing_decision", "fleet", wall(t0),
            max(t_routed - t0, 1e-6), pid=pid, tid=tid,
            args={**args, "replica": replica,
                  **({"outcome": outcome} if outcome else {})}))
        # flow-start INSIDE the routing span (same pid/tid/ts): the
        # replica's flow-finish ("f", bp="e") binds the arrow to its
        # request row
        evs.append({"name": "route", "cat": "flow", "ph": "s",
                    "id": trace["flow_id"], "ts": wall(t0) * 1e6,
                    "pid": pid, "tid": tid, "args": dict(args)})
    return evs


def filter_trace(events: List[Dict[str, Any]],
                 request_id: Optional[str] = None,
                 trace_id: Optional[str] = None
                 ) -> List[Dict[str, Any]]:
    """Keep events belonging to one request/trace. Matching is on the
    args payload (every fleet-traced event — spans, instants, flow
    endpoints — carries request_id and trace_id there); thread_name
    metadata rows are kept for exactly the (pid, tid) rows that still
    own a kept event, so the filtered doc renders with its labels."""
    if request_id is None and trace_id is None:
        return list(events)

    def match(ev: Dict[str, Any]) -> bool:
        args = ev.get("args") or {}
        if request_id is not None \
                and args.get("request_id") != request_id:
            return False
        if trace_id is not None and args.get("trace_id") != trace_id:
            return False
        return True

    kept = [ev for ev in events if ev.get("ph") != "M" and match(ev)]
    rows = {(ev.get("pid"), ev.get("tid")) for ev in kept}
    meta = [ev for ev in events if ev.get("ph") == "M"
            and (ev.get("pid"), ev.get("tid")) in rows]
    return meta + kept


def _dedup(events: List[Dict[str, Any]]) -> List[Dict[str, Any]]:
    """Drop exact-duplicate events: in-process replicas each merge the
    SAME process tracing ring into their chrome_trace doc, so a naive
    fleet concatenation repeats every ring span once per replica."""
    seen = set()
    out: List[Dict[str, Any]] = []
    for ev in events:
        key = json.dumps(ev, sort_keys=True, default=repr)
        if key not in seen:
            seen.add(key)
            out.append(ev)
    return out


def merge_fleet_traces(replica_docs: Dict[str, Any],
                       ingress: Optional[IngressTraceBuffer] = None,
                       request_id: Optional[str] = None,
                       trace_id: Optional[str] = None
                       ) -> Dict[str, Any]:
    """Assemble the fleet-wide Chrome trace (GET /fleet/debug/trace):
    every replica's lifecycle doc + the ingress span buffer, deduped,
    optionally filtered to one request or trace id. Events are
    already time-aligned — each source stamps epoch microseconds
    through its own process wall anchor — so the merge is a
    concatenation plus bookkeeping, and per-source metadata (anchors,
    ring drop counts) rides along for skew forensics."""
    events: List[Dict[str, Any]] = []
    meta: Dict[str, Any] = {}
    if ingress is not None:
        events.extend(ingress.events())
        meta["ingress"] = {
            "pid": os.getpid(),
            "wall_anchor_s": tracing.wall_anchor(),
            "buffer": ingress.stats(),
        }
    per_replica: Dict[str, Any] = {}
    source_pids: List[Any] = []
    for rid in sorted(replica_docs):
        doc = replica_docs[rid]
        if not isinstance(doc, dict):
            per_replica[rid] = {"error": repr(doc)}
            continue
        if "error" in doc and "traceEvents" not in doc:
            per_replica[rid] = {"error": doc["error"]}
            continue
        events.extend(doc.get("traceEvents") or [])
        per_replica[rid] = doc.get("metadata") or {}
        source_pids.append((doc.get("metadata") or {}).get("pid"))
    meta["replicas"] = per_replica
    # duplicates exist only when replica docs came from ONE process
    # (each merged the same tracing ring); cross-process fleets — the
    # production topology — skip the O(events) canonical-JSON pass
    if (len(source_pids) != len(set(source_pids))
            or any(p is None for p in source_pids)):
        events = _dedup(events)
    if request_id is not None or trace_id is not None:
        events = filter_trace(events, request_id=request_id,
                              trace_id=trace_id)
        meta["filter"] = {
            **({"request_id": request_id} if request_id else {}),
            **({"trace_id": trace_id} if trace_id else {}),
        }
    return {"traceEvents": events, "displayTimeUnit": "ms",
            "metadata": meta}


def merge_flight_recorders(replica_events: Dict[str, Any],
                           ingress_events: List[Dict[str, Any]],
                           request_id: Optional[str] = None
                           ) -> List[Dict[str, Any]]:
    """One time-ordered fleet event stream (GET /fleet/debug/events):
    every replica's flight-recorder ring plus the ingress's own,
    each event tagged with its source, sorted by timestamp (epoch
    via per-process anchors), optionally filtered by request id."""
    merged: List[Dict[str, Any]] = []
    for rid in sorted(replica_events):
        evs = replica_events[rid]
        if not isinstance(evs, list):
            merged.append({"ts": time.time(), "replica": rid,
                           "event": "collect_error",
                           "error": repr(evs)})
            continue
        for ev in evs:
            merged.append({**ev, "replica": rid})
    for ev in ingress_events:
        merged.append({**ev, "replica": "ingress"})
    if request_id is not None:
        merged = [ev for ev in merged
                  if ev.get("request_id") == request_id]
    merged.sort(key=lambda ev: ev.get("ts", 0.0))
    return merged


__all__ = ["IngressTraceBuffer", "request_events", "filter_trace",
           "merge_fleet_traces", "merge_flight_recorders"]
