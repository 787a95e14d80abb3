"""LLM fleet deployment: builder + OpenAI-compatible fleet ingress.

The port's copy of ``ray_tpu/serve/llm/deployment.py`` over this
package's FleetManager and ``LLMServerImpl`` replicas; a replica whose
engine runs on CUDA reserves its GPU (``build_llm_deployment``).

`build_llm_fleet_app(FleetConfig)` provisions `max_replicas`
LLMServer deployments (one engine each, distinct replica ids tagged
into their Prometheus series) behind ONE `LLMFleetIngressImpl` — the
deployment that owns the FleetManager (prefix-affine router, bounded
admission, autoscale control loop). Registering the app through
`serve.run` gives the fleet the controller's replica supervision and
the proxy's HTTP/SSE plane for free; `local_testing_mode=True` runs
the identical graph in-process (the tier-1 e2e tests do).

Ingress HTTP surface (rides the existing proxy):
    POST /v1/chat/completions      unary or SSE (stream=true)
    POST /v1/completions           unary or SSE
    POST /v1/batch                 submit a batch-lane job:
                                   priority-0, admission-exempt,
                                   preemptible bulk inference
    GET  /v1/batch                 list batch jobs (+ lane stats);
                                   /v1/batch/{id} = one job's results
    GET  /v1/models                the fleet's model (+ adapters)
    GET  /fleet                    fleet status: per-replica routing
                                   inputs, router/admission counters,
                                   autoscale decisions
    GET  /stats                    per-replica engine stats + fleet
    GET  /metrics                  ONE Prometheus exposition for the
                                   fleet (replica-tagged series)
    GET  /debug/events             per-replica flight recorders
                                   (?since=<seq> polls incrementally)
    GET  /debug/trace              merged Chrome-trace lifecycles
    GET  /fleet/debug/events       ingress+replica recorders merged
                                   (?since= returns only newer events
                                   + per-source high-water marks)
    GET  /fleet/debug/attribution  fleet-merged per-request cost
                                   receipts + tenant rollups
                                   (?k=&tenant=)
    GET  /fleet/debug/traffic      traffic recorder: ring
                                   tail + capture stats; ?capture=1
                                   downloads the last sealed capture
                                   (the replayable JSONL artifact)
    POST /fleet/debug/traffic      capture controls: {"action":
                                   "start"|"stop"|"mark", ...}
Overload returns 429 with a Retry-After header (admission.py).
"""

from __future__ import annotations

import asyncio
import dataclasses
import math
import time
from typing import Any, Dict, List, Optional, Tuple

from ...llm._internal.server import parse_since
from .admission import AdmissionConfig, AdmissionRejected
from .autoscaler import AutoscaleConfig
from .batch import BatchLaneConfig
from .failover import HealthConfig
from .fleet import (ACTIVE, DRAINING, STANDBY, FleetManager,
                    HandleReplicaClient)
from .kv_transport import REPLICA_ROLES, ROLE_PREFILL, TransportConfig
from .router import RouterConfig
from .tracemerge import merge_fleet_traces, merge_flight_recorders
from .trafficlog import CaptureError
from .watchdog import WatchdogConfig


@dataclasses.dataclass
class FleetConfig:
    """One model's replica fleet (wraps the single-replica LLMConfig)."""
    llm_config: Any                      # ray_tpu_torch.llm.LLMConfig
    min_replicas: int = 1
    max_replicas: int = 1
    router: RouterConfig = dataclasses.field(default_factory=RouterConfig)
    admission: AdmissionConfig = dataclasses.field(
        default_factory=AdmissionConfig)
    autoscale: Optional[AutoscaleConfig] = None   # min/max come from above
    # SLO burn-rate watchdog: multi-window error-budget burn
    # over the replicas' slo_totals; pages pre-emptively into the
    # autoscaler and admission brownout
    watchdog: WatchdogConfig = dataclasses.field(
        default_factory=WatchdogConfig)
    # distributed request tracing: mint a trace context per
    # request at ingress; one trace id follows it across router and
    # replica (GET /fleet/debug/trace merges the spans)
    enable_tracing: bool = True
    # failure handling: probe-failure eviction thresholds,
    # circuit-breaker cooldowns, and the mid-stream failover budget
    health: HealthConfig = dataclasses.field(
        default_factory=HealthConfig)
    # named operation timeouts (so chaos tests and operators can
    # tune them): probe = stats/metrics/debug fan-outs, dispatch =
    # control-plane unary calls, drain = scale-down engine drain
    probe_timeout_s: float = 5.0
    dispatch_timeout_s: float = 10.0
    drain_timeout_s: float = 120.0
    refresh_period_s: float = 0.5
    autoscale_period_s: float = 2.0
    # fleet KV transport: None = off (pre-transport fleet).
    # `replica_roles` aligns with r0..rN-1 ("prefill" | "decode" |
    # "mixed"; None = all mixed) — prefill replicas take long-prompt
    # handoffs only, never ring traffic. With a transport configured,
    # every replica's engine gets enable_kv_offload=True by default
    # (sessions park/restore through the host tier on both ends).
    transport: Optional[TransportConfig] = None
    replica_roles: Optional[List[str]] = None
    # preemptible batch-inference lane: None = off. With a
    # lane configured, POST /v1/batch submits priority-0 bulk jobs
    # that soak idle capacity and yield token-exact to interactive
    # traffic. Engines should run enable_kv_offload: the engine's
    # priority preemption is gated on it entirely, so WITHOUT it
    # batch work is never preempted at all — interactive requests
    # queue behind running batch jobs until they finish naturally,
    # and only the lane's soak governor (which stops LAUNCHING under
    # load) still protects interactive latency.
    batch_lane: Optional[BatchLaneConfig] = None
    # slice topology: the fleet's scaling UNIT is a slice of cards.
    # slice_shape=(1, tp) makes every provisioned replica a tp-sharded
    # engine (threaded into engine_kwargs.mesh_shape, which sizes the
    # replica's GPU reservation), so a scale-up decision provisions a
    # whole slice and /fleet rows report chips per replica. None =
    # single-card replicas. (Tensor-parallel engines wait for a
    # machine with several cards; the port's engine spans one.)
    slice_shape: Optional[Tuple[int, int]] = None
    # traffic flight-data recorder: always-on bounded
    # request log at the ingress (privacy-scrubbed — never prompt
    # text); armed captures become replayable JSONL artifacts
    # (GET/POST /fleet/debug/traffic). The spool dir, when set,
    # retains sealed captures on disk (BlackboxSpool bounds).
    enable_traffic_log: bool = True
    traffic_capacity: int = 4096
    traffic_spool_dir: Optional[str] = None

    def resolved_autoscale(self) -> AutoscaleConfig:
        auto = self.autoscale or AutoscaleConfig()
        return dataclasses.replace(auto,
                                   min_replicas=self.min_replicas,
                                   max_replicas=self.max_replicas)

    def to_wire(self) -> Dict[str, Any]:
        return {
            "model_id": self.llm_config.model_id,
            "router": dataclasses.asdict(self.router),
            "admission": dataclasses.asdict(self.admission),
            "autoscale": dataclasses.asdict(self.resolved_autoscale()),
            "watchdog": dataclasses.asdict(self.watchdog),
            "enable_tracing": self.enable_tracing,
            "health": dataclasses.asdict(self.health),
            "probe_timeout_s": self.probe_timeout_s,
            "dispatch_timeout_s": self.dispatch_timeout_s,
            "drain_timeout_s": self.drain_timeout_s,
            "refresh_period_s": self.refresh_period_s,
            "autoscale_period_s": self.autoscale_period_s,
            "transport": (None if self.transport is None
                          else dataclasses.asdict(self.transport)),
            "replica_roles": (None if self.replica_roles is None
                              else list(self.replica_roles)),
            "batch_lane": (None if self.batch_lane is None
                           else dataclasses.asdict(self.batch_lane)),
            "slice_shape": (None if self.slice_shape is None
                            else list(self.slice_shape)),
            "enable_traffic_log": self.enable_traffic_log,
            "traffic_capacity": self.traffic_capacity,
            "traffic_spool_dir": self.traffic_spool_dir,
        }


class LLMFleetIngressImpl:
    """The fleet's front door (a serve deployment class body)."""

    def __init__(self, fleet_wire: Dict[str, Any], *server_handles):
        self.model_id = fleet_wire.get("model_id", "default")
        clients = []
        # handles arrive in bind order (r0..rN-1); in local testing
        # mode they resolve to in-process replicas that share THIS
        # process's metric registry, which flips the /metrics merge
        # strategy (fleet.py metrics_text)
        from .._private import local_testing
        shared = local_testing.active()
        for i, h in enumerate(server_handles):
            clients.append(HandleReplicaClient(
                f"r{i}", h, shares_registry=shared))
        wd_wire = dict(fleet_wire.get("watchdog") or {})
        if "slos" in wd_wire:           # JSON round-trip: list -> tuple
            wd_wire["slos"] = tuple(wd_wire["slos"])
        self.fleet = FleetManager(
            clients,
            router=RouterConfig(**fleet_wire.get("router") or {}),
            admission=AdmissionConfig(
                **fleet_wire.get("admission") or {}),
            autoscale=AutoscaleConfig(
                **fleet_wire.get("autoscale") or {}),
            watchdog=WatchdogConfig(**wd_wire),
            enable_tracing=bool(fleet_wire.get("enable_tracing", True)),
            health=HealthConfig(**fleet_wire.get("health") or {}),
            model_id=self.model_id,
            # fallbacks come from the dataclass, never re-stated
            # literals
            probe_timeout_s=fleet_wire.get(
                "probe_timeout_s", FleetConfig.probe_timeout_s),
            dispatch_timeout_s=fleet_wire.get(
                "dispatch_timeout_s", FleetConfig.dispatch_timeout_s),
            drain_timeout_s=fleet_wire.get(
                "drain_timeout_s", FleetConfig.drain_timeout_s),
            refresh_period_s=fleet_wire.get("refresh_period_s", 0.5),
            autoscale_period_s=fleet_wire.get("autoscale_period_s",
                                              2.0),
            roles=fleet_wire.get("replica_roles"),
            transport=(TransportConfig(**fleet_wire["transport"])
                       if fleet_wire.get("transport") else None),
            batch_lane=(BatchLaneConfig(**fleet_wire["batch_lane"])
                        if fleet_wire.get("batch_lane") else None),
            enable_traffic_log=bool(
                fleet_wire.get("enable_traffic_log", True)),
            traffic_capacity=int(
                fleet_wire.get("traffic_capacity", 4096)),
            traffic_spool_dir=fleet_wire.get("traffic_spool_dir"))
        self._adapters: Optional[List[str]] = None
        self._adapters_ts = 0.0

    # -- helpers --------------------------------------------------------
    def _429(self, exc: AdmissionRejected):
        """Admission rejections: 429 + Retry-After for overload; a
        request shed because its own deadline expired is
        504 Gateway Timeout — retrying won't help a client whose
        budget is spent."""
        from ...serve import Response
        if exc.reason == "deadline":
            return Response(
                {"error": {"type": "deadline_exceeded",
                           "reason": exc.reason}},
                status=504, content_type="application/json")
        return Response(
            {"error": {"type": "overloaded",
                       "reason": exc.reason,
                       "retry_after_s": exc.retry_after_s}},
            status=429, content_type="application/json",
            headers={"Retry-After":
                     str(int(math.ceil(exc.retry_after_s)))})

    async def _known_model(self, name: str) -> bool:
        if not name or name == self.model_id:
            return True
        if name in (self._adapters or ()):
            return True
        # unknown name: (re)resolve — adapters can be registered live —
        # but at most once per cooldown, so an unknown-model storm
        # can't turn every request into a fleet-wide stats fan-out
        # (model_info snapshots engine stats under the step lock)
        now = time.monotonic()
        if self._adapters is None or now - self._adapters_ts >= 2.0:
            self._adapters_ts = now
            await self._resolve_adapters()
        return name in (self._adapters or ())

    async def _resolve_adapters(self) -> None:
        infos = await self._replica_infos()
        self._adapters = sorted(
            {a for info in infos.values()
             for a in info.get("adapters") or []})

    async def _replica_infos(self) -> Dict[str, Any]:
        return await self._fanout("model_info")

    async def _fanout(self, method: str, *args) -> Dict[str, Any]:
        """Call `method` on every non-standby replica concurrently,
        bounded: one wedged replica (step lock held mid-tick) degrades
        its row to an error instead of hanging the whole GET."""
        ids = [rid for rid, st in self.fleet.replicas.items()
               if st.status != STANDBY]

        async def one(rid: str):
            try:
                return rid, await asyncio.wait_for(
                    self.fleet.replicas[rid].client.call(
                        method, *args),
                    timeout=self.fleet.probe_timeout_s)
            except Exception as e:
                return rid, {"error": repr(e)}

        return dict(await asyncio.gather(*(one(rid) for rid in ids)))

    # -- GET surface ----------------------------------------------------
    async def _handle_get(self, norm: str,
                          query: Optional[Dict[str, str]] = None
                          ) -> Any:
        from ...serve import Response

        query = query or {}
        # preemptible batch lane: job listing + status
        if norm == "/v1/batch" or norm.startswith("/v1/batch/"):
            if self.fleet.batch is None:
                return Response(
                    {"error": "batch lane not configured"},
                    status=404, content_type="application/json")
            if norm == "/v1/batch":
                return {"object": "list",
                        "data": self.fleet.batch.list(),
                        "lane": self.fleet.batch.stats()}
            doc = self.fleet.batch.get(norm.rsplit("/", 1)[1])
            if doc is None:
                return Response({"error": "unknown batch job"},
                                status=404,
                                content_type="application/json")
            return doc
        if norm == "/v1/models":
            if self._adapters is None:
                await self._resolve_adapters()
            return {"object": "list",
                    "data": [{"id": self.model_id, "object": "model",
                              "owned_by": "ray_tpu"}]
                    + [{"id": a, "object": "model",
                        "owned_by": "ray_tpu",
                        "parent": self.model_id}
                       for a in self._adapters or []]}
        if norm == "/fleet":
            return await self.fleet.status()
        if norm == "/metrics":
            return Response(await self.fleet.metrics_text(),
                            status=200, content_type="text/plain")
        if norm == "/stats":
            infos = await self._replica_infos()
            return {"object": "stats", "model": self.model_id,
                    "replicas": {rid: info.get("engine", info)
                                 for rid, info in infos.items()},
                    "fleet": await self.fleet.status()}
        if norm == "/debug/events":
            # ?since=<seq>: each replica returns
            # only events newer than the cursor + its high-water mark
            since = parse_since(query.get("since"))
            rows = (await self._fanout("debug_events")
                    if since is None
                    else await self._fanout("debug_events", since))
            return {"object": "events", "replicas": rows}
        if norm == "/debug/trace":
            events: List[Any] = []
            for doc in (await self._fanout("debug_trace")).values():
                events.extend(doc.get("traceEvents") or [])
            return {"traceEvents": events, "displayTimeUnit": "ms"}
        # -- fleet-merged debug surface ------------------------
        if norm == "/fleet/debug/trace":
            # time-aligned merge of every replica's Chrome trace with
            # the ingress's own span buffer; ?request_id= / ?trace_id=
            # narrow to one request's cross-process lifecycle
            return merge_fleet_traces(
                await self._fanout("debug_trace"), self.fleet.trace,
                request_id=query.get("request_id"),
                trace_id=query.get("trace_id"))
        if norm == "/fleet/debug/events":
            # ?since=<seq> polls incrementally. Sequence numbers are
            # PER SOURCE (each recorder counts its own), so the
            # scalar cursor applies to every source and the response
            # carries per-source high-water marks for the next poll.
            since = parse_since(query.get("since"))
            rows = (await self._fanout("debug_events")
                    if since is None
                    else await self._fanout("debug_events", since))
            high: Dict[str, Any] = {}
            by_rid: Dict[str, Any] = {}
            for rid, row in rows.items():
                if isinstance(row, dict) and "events" in row:
                    by_rid[rid] = row["events"]
                    high[rid] = row.get("high_water")
                else:
                    by_rid[rid] = row    # legacy list / error row
            merged = merge_flight_recorders(
                by_rid, self.fleet.recorder.events(since),
                request_id=query.get("request_id"))
            doc: Dict[str, Any] = {
                "object": "events", "events": merged,
                "ingress": self.fleet.recorder.stats()}
            if since is not None:
                high["ingress"] = doc["ingress"]["total"]
                doc["since"] = since
                doc["high_water"] = high
            return doc
        if norm == "/fleet/debug/traffic":
            # traffic recorder: stats + ring tail;
            # ?capture=1 downloads the last sealed capture bytes
            tl = self.fleet.traffic
            if query.get("capture"):
                try:
                    text = tl.export()
                except CaptureError as e:
                    return Response({"error": str(e)}, status=404,
                                    content_type="application/json")
                return Response(text, status=200,
                                content_type="text/plain")
            try:
                n = max(int(query.get("n") or 64), 1)
            except ValueError:
                n = 64
            return {"object": "traffic", "model": self.model_id,
                    "enabled": self.fleet.enable_traffic_log,
                    "stats": tl.stats(),
                    "records": tl.tail(
                        n, since=parse_since(query.get("since")))}
        if norm == "/fleet/debug/attribution":
            # fleet-merged cost attribution — every
            # replica's top receipts re-ranked into ONE top-K and the
            # tenant rollups summed fleet-wide (?k= bounds the list;
            # ?tenant= filters the receipt rows)
            per = await self._fanout("debug_attribution")
            try:
                k = max(int(query.get("k") or 8), 1)
            except ValueError:
                k = 8
            want_tenant = query.get("tenant")
            tenants: Dict[str, Dict[str, float]] = {}
            top: List[Dict[str, Any]] = []
            for rid, doc in sorted(per.items()):
                if not isinstance(doc, dict) or "error" in doc:
                    continue
                for row in doc.get("top") or []:
                    if want_tenant and row.get("tenant") != want_tenant:
                        continue
                    top.append({**row, "replica": rid})
                for t, v in (doc.get("tenants") or {}).items():
                    agg = tenants.setdefault(t, {})
                    for key, val in v.items():
                        agg[key] = agg.get(key, 0) + val
            top.sort(key=lambda r: (-r.get("flops", 0),
                                    r.get("request_id", "")))
            return {"object": "attribution", "model": self.model_id,
                    "top": top[:k], "tenants": tenants,
                    "replicas": per}
        if norm == "/fleet/debug/bundles":
            # list every replica's black-box spool; ?replica=&id=
            # fetches one bundle
            rid, bid = query.get("replica"), query.get("id")
            if rid and bid:
                st = self.fleet.replicas.get(rid)
                if st is None:
                    return Response(
                        {"error": f"unknown replica {rid!r}"},
                        status=404, content_type="application/json")
                try:
                    # bounded like every other replica fan-out: a
                    # wedged replica (step lock held — often exactly
                    # why its bundle is wanted) degrades, not hangs
                    bundle = await asyncio.wait_for(
                        st.client.call("debug_bundle", bid),
                        timeout=self.fleet.probe_timeout_s)
                except Exception as e:
                    return Response(
                        {"error": f"bundle fetch from {rid} failed: "
                                  f"{e!r}"},
                        status=504, content_type="application/json")
                if bundle is None:
                    return Response(
                        {"error": f"no bundle {bid!r} on {rid}"},
                        status=404, content_type="application/json")
                return bundle
            return {"object": "bundles",
                    "replicas": await self._fanout("debug_bundles")}
        return Response({"error": f"no route {norm}"}, status=404,
                        content_type="application/json")

    # -- request path ---------------------------------------------------
    async def __call__(self, request) -> Any:
        from ...serve import Response, StreamingHint

        self.fleet.start()       # control loop rides the serving loop
        path = getattr(request, "path", "/")
        method = getattr(request, "method", "POST")
        norm = path.rstrip("/") or "/"
        if method == "GET":
            return await self._handle_get(
                norm, dict(getattr(request, "query_params", None)
                           or {}))
        try:
            body = request.json()
        except Exception:
            return Response({"error": "invalid JSON body"}, status=400,
                            content_type="application/json")
        if not isinstance(body, dict):
            body = {}
        if norm == "/debug/dump":
            # POST /debug/dump: black-box every replica now
            cause = str(body.get("cause") or "manual")
            return {"object": "dump",
                    "replicas": await self.fleet.debug_dump_all(cause)}
        if norm == "/fleet/debug/traffic":
            # capture controls. Control misuse (double
            # start, stop with nothing armed) is a 409 with the typed
            # error's message — never a 500.
            action = str(body.get("action") or "")
            tl = self.fleet.traffic
            try:
                if action == "start":
                    out = tl.start_capture(
                        str(body.get("note") or ""))
                elif action == "stop":
                    out = tl.stop_capture()
                elif action == "mark":
                    out = tl.mark(str(body.get("label") or ""))
                else:
                    return Response(
                        {"error": f"unknown traffic action "
                                  f"{action!r} (start|stop|mark)"},
                        status=400,
                        content_type="application/json")
            except CaptureError as e:
                return Response({"error": str(e)}, status=409,
                                content_type="application/json")
            return {"object": "traffic_control", "action": action,
                    **out}
        if norm == "/v1/batch" or (norm.startswith("/v1/batch/")
                                   and norm.endswith("/cancel")):
            # preemptible batch lane: submit a bulk job —
            # returns the job brief immediately; the lane pump soaks
            # it through idle capacity at priority 0. POST
            # /v1/batch/{id}/cancel stops its unlaunched requests.
            if self.fleet.batch is None:
                return Response(
                    {"error": "batch lane not configured"},
                    status=404, content_type="application/json")
            if norm != "/v1/batch":
                doc = self.fleet.batch.cancel(norm.split("/")[-2])
                if doc is None:
                    return Response({"error": "unknown batch job"},
                                    status=404,
                                    content_type="application/json")
                return doc
            try:
                return self.fleet.batch.submit(body)
            except ValueError as e:
                return Response({"error": str(e)}, status=400,
                                content_type="application/json")
        if not await self._known_model(body.get("model") or ""):
            return Response(
                {"error": f"model {body.get('model')!r} not found"},
                status=404, content_type="application/json")
        is_chat = norm.endswith("/chat/completions")
        is_cmpl = not is_chat and norm.endswith("/completions")
        if not (is_chat or is_cmpl):
            return Response({"error": f"no route {path}"}, status=404,
                            content_type="application/json")
        if body.get("stream"):
            # preflight the front door so a flat-out overloaded fleet
            # answers 429 instead of opening a 200 SSE stream only to
            # shed inside it (a shed after headers can only be an SSE
            # error event — see the stream_* methods)
            if self.fleet.admission.would_reject():
                return self._429(AdmissionRejected(
                    "queue_full", self.fleet.admission.retry_after()))
            return StreamingHint(
                "stream_chat" if is_chat else "stream_completions",
                body)
        try:
            return await self.fleet.dispatch(
                "chat" if is_chat else "completions", body)
        except AdmissionRejected as e:
            return self._429(e)

    async def _relay(self, method: str, body: Dict[str, Any]):
        import json
        self.fleet.start()
        try:
            async for chunk in self.fleet.dispatch_stream(method, body):
                yield chunk
        except (GeneratorExit, asyncio.CancelledError):
            raise                      # client gone: nothing to frame
        except AdmissionRejected as e:
            # headers are already on the wire: the rejection becomes
            # an SSE error event (the OpenAI streaming convention).
            # Same distinction as _429: a deadline shed is the
            # client's budget spent (no Retry-After — retrying won't
            # help), anything else is overload.
            if e.reason == "deadline":
                err = {"type": "deadline_exceeded", "reason": e.reason}
            else:
                err = {"type": "overloaded", "reason": e.reason,
                       "retry_after_s": e.retry_after_s}
            yield "data: " + json.dumps({"error": err}) + "\n\n"
            yield "data: [DONE]\n\n"
        except Exception as e:
            # failover budget exhausted / every replica down: the stream must still END per the SSE convention —
            # an error event + [DONE] — never a silent truncation a
            # client can't tell from a transport blip. The terminal
            # cause goes to the log + fleet flight recorder (the SSE
            # event only names the type; the operator needs the rest)
            import logging
            logging.getLogger(__name__).exception(
                "fleet stream %s failed terminally", method)
            self.fleet.recorder.record(
                "stream_failed", method=method, error=repr(e))
            yield "data: " + json.dumps(
                {"error": {"type": "upstream_failure",
                           "reason": type(e).__name__}}) + "\n\n"
            yield "data: [DONE]\n\n"

    async def stream_chat(self, body: Dict[str, Any]):
        async for chunk in self._relay("chat_stream", body):
            yield chunk

    async def stream_completions(self, body: Dict[str, Any]):
        async for chunk in self._relay("completions_stream", body):
            yield chunk

    async def check_health(self) -> None:
        return None

    async def health_detail(self) -> Dict[str, Any]:
        """serve.status() row for the ingress itself: fleet shape +
        front-door pressure (the per-engine rows come from each
        LLMServer replica's own health_detail)."""
        f = self.fleet
        adm = f.admission
        return {
            "model": self.model_id,
            "active": len(f._ids(ACTIVE)),
            "draining": len(f._ids(DRAINING)),
            "standby": len(f._ids(STANDBY)),
            "inflight": adm.inflight,
            "queued": adm._queue_len(),
            "queue_wait_p99_s": round(adm.queue_wait_p99_s(), 4),
        }


def build_llm_fleet_app(config: FleetConfig):
    """FleetConfig → bound serve Application (deploy via serve.run)."""
    import dataclasses as _dc

    from ... import serve
    from ...llm import build_llm_deployment

    lc = config.llm_config
    if config.min_replicas < 1 \
            or config.max_replicas < config.min_replicas:
        raise ValueError("need 1 <= min_replicas <= max_replicas")
    roles = config.replica_roles
    if roles is not None:
        if len(roles) != config.max_replicas:
            raise ValueError(
                f"replica_roles ({len(roles)}) must align with "
                f"max_replicas ({config.max_replicas})")
        bad = [r for r in roles if r not in REPLICA_ROLES]
        if bad:
            raise ValueError(f"unknown replica roles {bad}")
        if roles.count(ROLE_PREFILL) == len(roles):
            raise ValueError("a fleet needs at least one "
                             "decode-capable replica")
    servers = []
    for i in range(config.max_replicas):
        rid = f"r{i}"
        ek = dict(lc.engine_kwargs or {})
        # the replica id tags this engine's Prometheus series (and is
        # how LLMServerImpl learns its own identity)
        ek["metrics_replica_id"] = rid
        if config.slice_shape is not None:
            # every replica IS one slice: a tp-sharded engine on its
            # own named mesh (explicit unless the operator pinned a
            # per-replica mesh themselves)
            ek.setdefault("mesh_shape", tuple(config.slice_shape))
        if config.transport is not None:
            # both ends of a session ship stage through the host
            # tier (export parks via the spill path, import restores
            # via _restore_parked) — default it ON fleet-wide unless
            # the operator pinned it explicitly
            ek.setdefault("enable_kv_offload", True)
        dep_cfg = dict(lc.deployment_config or {})
        dep_cfg["name"] = f"LLMServer:{lc.model_id}:{rid}"
        servers.append(build_llm_deployment(
            _dc.replace(lc, engine_kwargs=ek,
                        deployment_config=dep_cfg)))
    ingress = serve.deployment(
        name=f"LLMFleet:{lc.model_id}",
        max_ongoing_requests=max(
            256, config.admission.max_concurrent
            + config.admission.max_queue))(LLMFleetIngressImpl)
    return ingress.bind(config.to_wire(), *servers)


__all__ = ["FleetConfig", "LLMFleetIngressImpl", "build_llm_fleet_app"]
