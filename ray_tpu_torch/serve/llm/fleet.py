"""FleetManager: N engine replicas behind one router + front door.

The port's own copy of ``ray_tpu/serve/llm/fleet.py``, over this
package's `LLMServerImpl` replicas. A fleet is a set of replicas
reached through a small client interface (the SAME manager runs over
in-process servers and over handles to remote replicas), plus the
policy objects:

- `FleetRouter` (router.py): prefix-affine, occupancy-aware pick;
- `AdmissionController` (admission.py): bounded queue + 429 shed;
- `FleetAutoscaler` (autoscaler.py): TTFT/queue-wait-driven target;
- `CircuitBreaker` (failover.py): eviction and re-admission;
- `SLOBurnWatchdog` (watchdog.py): burn-rate pages and brownout;
- the KV transport (kv_transport.py): disaggregated prefill, drain
  migration, failover-by-restore and the fleet prefix store.

Replica lifecycle: ACTIVE (in the ring) -> DRAINING (out of the ring,
finishing in-flight work) -> STANDBY (idle, instantly re-activatable);
UNHEALTHY replicas were evicted by their breaker. The fleet provisions
`max_replicas` up front and moves them between these states —
scale-down never drops a stream: the victim leaves the ring first, its
live sessions ship to the survivors, the router's in-flight count
reaches zero only when every stream it was serving has moved or
completed, and only then does the engine's own idle check
(`has_work`) retire it to standby.

Single-event-loop discipline: every mutation of fleet state happens on
the loop the ingress serves from (the manager is created there); the
blocking engine work stays inside each replica's own executor pump.
In-process replicas on one CUDA card serialise their device work
through the engine's per-device lock (llm/_internal/engine.py).
"""

from __future__ import annotations

import asyncio
import collections
import time
import uuid
from typing import Any, AsyncIterator, Deque, Dict, List, Optional, \
    Sequence

from ...llm._internal.telemetry import FlightRecorder
from ...util import tracing
from . import failover, kv_transport
from .admission import (AdmissionConfig, AdmissionController,
                        AdmissionRejected)
from .autoscaler import AutoscaleConfig, FleetAutoscaler, FleetMetrics
from .batch import (BATCH_PRIORITY, INTERACTIVE_PRIORITY, BatchLane,
                    BatchLaneConfig)
from .failover import CircuitBreaker, HealthConfig
from .kv_transport import (FleetPrefixStore, TransportConfig,
                           TransportError)
from .router import (FleetRouter, ReplicaSnapshot, RouterConfig,
                     prefix_fingerprint)
from .tracemerge import IngressTraceBuffer, request_events
from .trafficlog import TrafficRecorder, sampling_brief
from .watchdog import SLOBurnWatchdog, WatchdogConfig

# monotone SLO-total keys the watchdog accumulates fleet-wide
_WATCH_KEYS = ("ttft_n", "ttft_bad", "queue_n", "queue_bad",
               "e2e_n", "e2e_bad")

ACTIVE = "ACTIVE"
DRAINING = "DRAINING"
STANDBY = "STANDBY"
# evicted by the health state machine — out of the router
# ring, ineligible for autoscale activation; only the breaker's
# half-open probes re-admit it
UNHEALTHY = "UNHEALTHY"

# plumbing keys the fleet mints itself: client-supplied values are
# stripped at ingress (a forged `_continue_tokens` would inject raw
# token ids, a forged `_deadline_epoch` would bypass deadline_s).
# ONE canonical list, owned by the server module that pops them.
from ...llm._internal.server import \
    INTERNAL_BODY_KEYS as _INTERNAL_BODY_KEYS  # noqa: E402


class LocalReplicaClient:
    """Direct in-process LLMServerImpl (tier-1 tests, bench --fleet)."""

    shares_registry = True

    def __init__(self, replica_id: str, server: Any):
        self.replica_id = replica_id
        self.server = server

    async def call(self, method: str, *args) -> Any:
        return await getattr(self.server, method)(*args)

    def stream(self, method: str, body: Dict[str, Any]):
        return getattr(self.server, method)(body)


class HandleReplicaClient:
    """A serve DeploymentHandle to an LLMServer deployment. In
    local_testing_mode every handle resolves to an in-process replica
    sharing this process's metric registry; across real replica
    actors each process has its own registry (shares_registry drives
    the /metrics merge strategy — see metrics_text())."""

    def __init__(self, replica_id: str, handle: Any,
                 shares_registry: bool = False):
        self.replica_id = replica_id
        self.handle = handle
        self.shares_registry = shares_registry

    async def call(self, method: str, *args) -> Any:
        return await getattr(self.handle, method).remote(*args)

    def stream(self, method: str, body: Dict[str, Any]):
        return getattr(self.handle, method).options(
            stream=True).remote(body)


class _ReplicaState:
    def __init__(self, client: Any, status: str,
                 health: Optional[HealthConfig] = None,
                 role: str = kv_transport.ROLE_MIXED):
        self.client = client
        self.status = status
        # disaggregated prefill/decode: `prefill` replicas
        # never join the router ring — they only take long-prompt
        # prefill handoffs; `decode`/`mixed` take ring traffic
        self.role = role
        self.inflight = 0            # router-side, zero-lag
        self.requests_total = 0
        self.snapshot: Optional[ReplicaSnapshot] = None
        self.slo_totals: Dict[str, float] = {}
        self.drain_task: Optional[asyncio.Task] = None
        # health state machine: closed -> open (evicted) ->
        # half-open (probation probes) -> closed (re-admitted)
        self.breaker = CircuitBreaker(health)


class FleetManager:
    def __init__(self, clients: Sequence[Any],
                 router: Optional[RouterConfig] = None,
                 admission: Optional[AdmissionConfig] = None,
                 autoscale: Optional[AutoscaleConfig] = None,
                 refresh_period_s: float = 0.5,
                 autoscale_period_s: float = 2.0,
                 watchdog: Optional[WatchdogConfig] = None,
                 enable_tracing: bool = True,
                 health: Optional[HealthConfig] = None,
                 model_id: str = "default",
                 probe_timeout_s: float = 5.0,
                 dispatch_timeout_s: float = 10.0,
                 drain_timeout_s: float = 120.0,
                 roles: Optional[Sequence[str]] = None,
                 transport: Optional[TransportConfig] = None,
                 batch_lane: Optional[BatchLaneConfig] = None,
                 enable_traffic_log: bool = True,
                 traffic_capacity: int = 4096,
                 traffic_spool_dir: Optional[str] = None):
        if not clients:
            raise ValueError("a fleet needs at least one replica")
        # per-replica roles (disaggregation): aligned with
        # `clients`; default everyone `mixed` (= pre-transport fleet)
        roles = (list(roles) if roles is not None
                 else [kv_transport.ROLE_MIXED] * len(clients))
        if len(roles) != len(clients):
            raise ValueError(
                f"roles ({len(roles)}) must align with clients "
                f"({len(clients)})")
        bad = [r for r in roles if r not in kv_transport.REPLICA_ROLES]
        if bad:
            raise ValueError(
                f"unknown replica roles {bad}; valid: "
                f"{kv_transport.REPLICA_ROLES}")
        if all(r == kv_transport.ROLE_PREFILL for r in roles):
            raise ValueError(
                "a fleet needs at least one decode-capable replica "
                "(role 'decode' or 'mixed')")
        auto = autoscale or AutoscaleConfig(
            min_replicas=len(clients), max_replicas=len(clients))
        if auto.max_replicas > len(clients):
            raise ValueError(
                f"max_replicas={auto.max_replicas} but only "
                f"{len(clients)} replicas are provisioned")
        if not 1 <= auto.min_replicas <= auto.max_replicas:
            raise ValueError(
                f"need 1 <= min_replicas={auto.min_replicas} "
                f"<= max_replicas={auto.max_replicas}")
        self.router = FleetRouter(router)
        # tenant-labeled front-door series tag
        # with this fleet's model id
        self.admission = AdmissionController(
            admission, metrics_model_id=model_id)
        self.autoscaler = FleetAutoscaler(auto)
        self.refresh_period_s = refresh_period_s
        self.autoscale_period_s = autoscale_period_s
        # named operation timeouts: probe = stats/metrics/bundle fan-outs,
        # dispatch = control-plane unary calls (postmortem dumps),
        # drain = scale-down engine drain
        self.probe_timeout_s = probe_timeout_s
        self.dispatch_timeout_s = dispatch_timeout_s
        self.drain_timeout_s = drain_timeout_s
        self.model_id = model_id
        # failure-handling plane
        self.health = health or HealthConfig()
        self.metrics = failover.fleet_metrics()
        self.replicas: Dict[str, _ReplicaState] = {}
        for i, c in enumerate(clients):
            status = ACTIVE if i < auto.min_replicas else STANDBY
            self.replicas[c.replica_id] = _ReplicaState(
                c, status, self.health, role=roles[i])
            self.metrics["breaker"].set(
                0, {"model": self.model_id, "replica": c.replica_id})
        # -- fleet KV transport -----------------------------
        self.transport = transport
        self.kvt_metrics = kv_transport.transport_metrics()
        self.prefix_store: Optional[FleetPrefixStore] = None
        if transport is not None and transport.enable_prefix_store:
            self.prefix_store = FleetPrefixStore(
                transport.prefix_store_bytes)
        # live relay-driven streams by minted request id -> which
        # replica currently serves them (the migration orchestrator's
        # inventory), and exported-but-not-yet-resumed session
        # payloads a drain shipped off a replica
        self._live_streams: Dict[str, Dict[str, Any]] = {}
        self._migrations: Dict[str, str] = {}
        # fingerprints already offered to the prefix store (success
        # or not): publishing is once-per-fingerprint, never a
        # per-request tax on the response path
        self._prefix_attempted: set = set()
        # preemptible batch-inference lane: POST /v1/batch
        # jobs dispatched at BATCH_PRIORITY outside the front-door
        # queue, soaking idle capacity; None = lane off (and then no
        # interactive priority stamping either — the lane-less
        # fleet byte-for-byte)
        self.batch: Optional[BatchLane] = (
            BatchLane(self, batch_lane)
            if batch_lane is not None else None)
        self._sync_ring()
        if not self._ring_ids():
            # the INITIAL ACTIVE set (the first min_replicas clients)
            # must contain a decode-capable replica — an all-prefill
            # head would start the fleet with an empty router ring
            # and reject every request until an autoscale activation
            # happened to fix it
            raise ValueError(
                "the first min_replicas replicas are all "
                "prefill-role: order at least one decode/mixed "
                "replica inside min_replicas")
        self._prev_slo: Dict[str, Dict[str, float]] = {}
        self._prev_shed = 0
        self._scale_events: Deque[Dict[str, Any]] = \
            collections.deque(maxlen=256)
        self._loop_task: Optional[asyncio.Task] = None
        # -- observability layer ---------------------------------------
        # fleet-level flight recorder: slo_alert/slo_clear, brownout
        # transitions, postmortem dump triggers (GET /fleet/debug/events
        # merges it with every replica's ring)
        self.recorder = FlightRecorder(capacity=512)
        self.watchdog = SLOBurnWatchdog(watchdog or WatchdogConfig(),
                                        recorder=self.recorder)
        # distributed tracing: every request gets a trace context at
        # ingress; the ingress's own spans land here and merge with
        # the replicas' lifecycle traces at GET /fleet/debug/trace
        self.enable_tracing = enable_tracing
        self.trace = IngressTraceBuffer()
        # -- traffic flight-data recorder ------------------------------
        # always-on bounded request log at the ingress: one
        # privacy-scrubbed record per request (never prompt text),
        # armed captures snapshot into the replayable JSONL format
        self.enable_traffic_log = enable_traffic_log
        self.traffic = TrafficRecorder(
            capacity=traffic_capacity, model_id=model_id,
            spool_dir=traffic_spool_dir)
        # watchdog accumulation state: per-replica clamped deltas into
        # fleet-monotone totals (membership changes / engine restarts
        # must not produce negative or replayed windows)
        self._watch_prev: Dict[str, Dict[str, float]] = {}
        self._watch_accum: Dict[str, float] = \
            {k: 0.0 for k in _WATCH_KEYS}
        self._page_dump_task: Optional[asyncio.Task] = None
        self._dump_tasks: set = set()   # keep eviction dumps alive
        # per-dispatch perf accounting: fleet-level
        # utilization gauges — the decode-goodput-weighted mean of the
        # ACTIVE replicas' recent MFU/MBU (idle replicas with no
        # traffic don't drag the fleet number to zero), refreshed by
        # the same probe loop that stamps the snapshots
        from ...util import metrics as metrics_api
        self._fleet_mfu_gauge = metrics_api.Gauge(
            "ray_tpu_llm_fleet_mfu",
            "goodput-weighted mean replica MFU over active replicas",
            ("model",))
        self._fleet_mbu_gauge = metrics_api.Gauge(
            "ray_tpu_llm_fleet_mbu",
            "goodput-weighted mean replica MBU over active replicas",
            ("model",))

    # -- membership helpers --------------------------------------------
    def _ids(self, *statuses: str) -> List[str]:
        return [rid for rid, st in self.replicas.items()
                if st.status in statuses]

    def _ring_ids(self) -> List[str]:
        """ACTIVE decode-capable replicas — the router ring's
        membership. `prefill`-role replicas never join:
        they only take explicit prefill handoffs."""
        return [rid for rid, st in self.replicas.items()
                if st.status == ACTIVE
                and st.role != kv_transport.ROLE_PREFILL]

    def _sync_ring(self) -> None:
        self.router.set_replicas(self._ring_ids())

    def _inflight_map(self) -> Dict[str, int]:
        return {rid: st.inflight for rid, st in self.replicas.items()}

    def _snapshots(self) -> Dict[str, ReplicaSnapshot]:
        return {rid: st.snapshot for rid, st in self.replicas.items()
                if st.snapshot is not None}

    # -- slice topology --------------------------------------
    # Each replica is one slice: an engine built with
    # mesh_shape=(1, tp) spans tp chips and reports them in its
    # stats, which land in ReplicaSnapshot.chips. The fleet scales in
    # whole-slice units — activating a STANDBY replica provisions
    # chips_per_slice chips at once, never a fraction of a slice.
    def chips_per_slice(self) -> int:
        chips = [st.snapshot.chips for st in self.replicas.values()
                 if st.snapshot is not None]
        return max(chips) if chips else 1

    def active_chips(self) -> int:
        total = 0
        for rid in self._ids(ACTIVE):
            snap = self.replicas[rid].snapshot
            total += snap.chips if snap is not None else 1
        return total

    # -- request path ---------------------------------------------------
    def _route(self, body: Dict[str, Any],
               fp: Optional[str] = None
               ) -> "tuple[_ReplicaState, str]":
        if fp is None:
            fp = prefix_fingerprint(body,
                                    self.router.config.prefix_depth)
        rid, outcome = self.router.pick_ex(fp, self._snapshots(),
                                           self._inflight_map())
        if rid is None:
            raise AdmissionRejected("no_active_replicas",
                                    self.admission.retry_after())
        return self.replicas[rid], outcome

    @staticmethod
    def tenant_of(body: Dict[str, Any]) -> str:
        # OpenAI bodies carry the end-user id in "user"; fall back to
        # a header-injected hint if the ingress put one in the body
        return str(body.get("user") or body.get("tenant") or "default")

    # -- distributed tracing ----------------------------------
    def _trace_begin(self, method: str, body: Dict[str, Any],
                     lane: Optional[str] = None):
        """Mint the request's trace context at fleet ingress: one
        request id and one trace id that follow it across admission,
        routing, and the replica's engine lifecycle (the context rides
        the body; LLMServerImpl pops it onto the engine Request).
        Returns (body', rec) — body' is a COPY carrying the plumbing
        keys, rec the in-progress ingress span record."""
        # ALWAYS copy + strip: the plumbing keys are internal even
        # when tracing is off — never forward client-supplied values
        # to the replica (and the failover/deadline paths mutate the
        # copy, never the caller's dict)
        body = {k: v for k, v in body.items()
                if k not in _INTERNAL_BODY_KEYS}
        # mint the tenant identity at admission: the
        # replica tags the engine Request (cost receipts, per-tenant
        # counters) with it; "" = default tenant so single-tenant
        # expositions stay label-free
        tenant = self.tenant_of(body)
        body["_tenant"] = "" if tenant == "default" else tenant
        if lane == "batch":
            # the batch lane's identity: priority is
            # FORCED to the bottom tier (a job body naming its own
            # priority must not outrank interactive traffic) and the
            # engine's SLO exclusion keys off the minted _lane
            body["_lane"] = "batch"
            body["priority"] = BATCH_PRIORITY
        elif self.batch is not None:
            # with the lane on, interactive traffic rides one tier up
            # so the engine's victim order (lowest priority first)
            # can never tie batch work against a user request — and a
            # client that explicitly sends the pre-lane default
            # priority 0 is CLAMPED up, not trusted: priorities <=
            # BATCH_PRIORITY belong to the lane (relative order among
            # clients above the floor is preserved)
            try:
                p = int(body.get("priority"))
            except (TypeError, ValueError):
                p = INTERACTIVE_PRIORITY
            body["priority"] = max(p, INTERACTIVE_PRIORITY)
        if not self.enable_tracing and not self.enable_traffic_log:
            return body, None
        # ALWAYS mint — `_request_id` doubles as the engine request id
        # downstream, so honoring a client-supplied value would let a
        # replayed id collide with (and abort/starve) another tenant's
        # in-flight request
        rid = uuid.uuid4().hex[:16]
        trace = None
        if self.enable_tracing:
            trace = {"trace_id": tracing.new_span_id(),
                     "span_id": tracing.new_span_id(),
                     "flow_id": tracing.new_span_id()}
            body["_request_id"] = rid
            body["_trace"] = trace
        # traffic-record fields: everything the capture
        # format needs, gathered HERE by allowlist (sampling_brief
        # never reads text fields) and enriched along the dispatch
        # path (fp, token counts, finish reason, failovers)
        deadline_s = body.get("deadline_s")
        try:
            deadline_s = (float(deadline_s)
                          if deadline_s is not None else None)
        except (TypeError, ValueError):
            deadline_s = None
        return body, {
            "rid": rid, "trace": trace, "method": method,
            "tenant": self.tenant_of(body), "t0": time.monotonic(),
            "t_admit": None, "t_route": None, "replica": None,
            "outcome": None, "status": "ok", "done": False,
            "lane": "batch" if lane == "batch" else "interactive",
            "stream": "stream" in method,
            "params": sampling_brief(body),
            "deadline_s": deadline_s, "fp": "",
            "prompt_tokens": 0, "out_tokens": 0, "finish": None,
            "failovers": 0, "t_first": None}

    def _trace_end(self, rec: Optional[Dict[str, Any]],
                   status: Optional[str] = None) -> None:
        """Close the ingress span set and publish it to the buffer
        (idempotent: the happy path and the error paths both reach
        here exactly once through the dispatch finally)."""
        if rec is None or rec["done"]:
            return
        rec["done"] = True
        if status is not None:
            rec["status"] = status
        if rec["trace"] is not None:
            self.trace.add(*request_events(
                self.trace.next_tid(), rec["rid"], rec["trace"],
                rec["t0"], rec["t_admit"], rec["t_route"],
                time.monotonic(), rec["replica"], rec["outcome"],
                rec["method"], rec["tenant"], rec["status"]))
        # every closed request feeds the traffic recorder
        # (rejects and errors included — a capture that omitted sheds
        # would replay a rosier workload than production saw)
        if self.enable_traffic_log:
            self.traffic.observe_request(rec)

    # -- deadline propagation ---------------------------------
    def _mint_deadline(self, body: Dict[str, Any]
                       ) -> Optional[float]:
        """A client `deadline_s` (seconds from arrival) becomes an
        absolute `_deadline_epoch` on the body (wall clock, so it
        survives process hops to the replica, where the engine aborts
        past it at fold boundaries). Returns the MONOTONIC deadline
        admission compares against here at the ingress."""
        ds = body.get("deadline_s")
        if ds is None:
            return None
        ds = float(ds)
        body["_deadline_epoch"] = time.time() + ds
        return time.monotonic() + ds

    def _count_deadline_shed(self, stage: str) -> None:
        self.metrics["deadline_sheds"].inc(
            1, {"model": self.model_id, "stage": stage})

    async def dispatch(self, method: str, body: Dict[str, Any],
                       lane: Optional[str] = None) -> Any:
        """Unary request through admission + routing (trace-minted).
        A replica failure/timeout feeds the breaker and the request
        retries on another replica (bounded by health.max_failovers) —
        no tokens have reached the client, so a retry is invisible.

        lane="batch" BYPASSES the admission controller:
        the front door's queue bound and SLO/brownout sheds protect
        user-visible waits, and a bulk job's whole point is to wait
        out the rush — its backpressure is the BatchLane pump's soak
        governor plus the engine's own priority-0 queueing, so its
        depth never feeds the shed/overload signals."""
        batch = lane == "batch"
        body, rec = self._trace_begin(method, body, lane=lane)
        deadline = self._mint_deadline(body)
        if not batch:
            try:
                await self.admission.acquire(self.tenant_of(body),
                                             deadline=deadline)
            except AdmissionRejected as e:
                if e.reason == "deadline":
                    self._count_deadline_shed("admission")
                self._trace_end(rec, f"rejected:{e.reason}")
                raise
        if rec is not None:
            rec["t_admit"] = time.monotonic()
        attempts = 0
        fp = prefix_fingerprint(body, self.router.config.prefix_depth)
        if rec is not None:
            rec["fp"] = fp
        try:
            while True:
                st, outcome = self._route(body, fp)
                if rec is not None and rec["replica"] is None:
                    rec["t_route"] = time.monotonic()
                    rec["replica"] = st.client.replica_id
                    rec["outcome"] = outcome
                rid = st.client.replica_id
                # fleet prefix store: seed the target with
                # the published prefix pages BEFORE dispatching, so
                # its local match_prefix hits like it prefilled the
                # prompt itself (best-effort, once per replica)
                await self._prefix_seed(fp, body, st)
                st.inflight += 1
                st.requests_total += 1
                try:
                    # per-attempt COPY: an in-process replica pops the
                    # plumbing keys (_deadline_epoch/_trace/...) off
                    # the dict it receives — a retry must re-send the
                    # fleet's canonical body, not the mutated one.
                    # With a deadline, the await is BOUNDED (remaining
                    # budget + grace): a healthy engine finishes with
                    # finish_reason="deadline" well inside the grace,
                    # so the timeout firing means the replica HUNG —
                    # the TimeoutError feeds the breaker below and the
                    # retry lands on a healthy replica (which sheds
                    # the expired request cleanly). Deadline-less
                    # requests keep unbounded unary semantics.
                    timeout = None
                    if deadline is not None:
                        timeout = (max(deadline - time.monotonic(),
                                       0.0)
                                   + self.health.unary_deadline_grace_s)
                    out = await asyncio.wait_for(
                        st.client.call(method, dict(body)), timeout)
                except (AdmissionRejected, asyncio.CancelledError):
                    raise
                except Exception as exc:
                    if not self._should_failover(rid, "dispatch",
                                                 exc, attempts):
                        raise
                    attempts += 1
                    if rec is not None:
                        rec["failovers"] = attempts
                    self.recorder.record(
                        "failover", mode="unary", replica=rid,
                        method=method, attempt=attempts,
                        error=repr(exc))
                    continue
                finally:
                    st.inflight -= 1
                if isinstance(out, dict):
                    fr = ((out.get("choices") or [{}])[0]
                          .get("finish_reason")
                          if out.get("choices") else None)
                    if fr == "deadline":
                        self._count_deadline_shed("engine")
                    if rec is not None:
                        usage = out.get("usage") or {}
                        rec["prompt_tokens"] = int(
                            usage.get("prompt_tokens") or 0)
                        rec["out_tokens"] = int(
                            usage.get("completion_tokens") or 0)
                        rec["finish"] = fr
                # publish the (now locally-cached) prefix into the
                # fleet store so the NEXT replica serving it imports
                # instead of cold-prefilling (once per fingerprint)
                await self._prefix_publish(fp, body, st)
                return out
        except AdmissionRejected as e:
            if rec is not None:
                rec["status"] = f"rejected:{e.reason}"
            raise
        except BaseException:
            if rec is not None:
                rec["status"] = "error"
            raise
        finally:
            if not batch:
                self.admission.release()
            self._trace_end(rec)

    async def dispatch_stream(self, method: str, body: Dict[str, Any]
                              ) -> AsyncIterator[Any]:
        """Streaming request: admission + routing hold for the WHOLE
        stream (a live stream occupies a decode slot, so it must keep
        weighing in both the router's in-flight counts and the
        admission concurrency bound until it completes).

        For the OpenAI stream methods the fleet consumes the
        replica's token-structured twin and renders the SSE framing
        HERE: a replica dying mid-stream feeds the breaker,
        the transcript's token-index dedup guarantees exactly-once
        delivery, and a continuation (original prompt + delivered
        tokens, same seed) re-dispatches to a healthy replica —
        token-exact, one stable completion id, no client-visible
        restart beyond latency."""
        body, rec = self._trace_begin(method, body)
        deadline = self._mint_deadline(body)
        token_method = failover.TOKEN_STREAM_METHODS.get(method)
        try:
            await self.admission.acquire(self.tenant_of(body),
                                         deadline=deadline)
        except AdmissionRejected as e:
            if e.reason == "deadline":
                self._count_deadline_shed("admission")
            self._trace_end(rec, f"rejected:{e.reason}")
            raise
        if rec is not None:
            rec["t_admit"] = time.monotonic()
        try:
            if token_method is None:
                # non-OpenAI stream: single-attempt passthrough
                st, outcome = self._route(body)
                if rec is not None:
                    rec["t_route"] = time.monotonic()
                    rec["replica"] = st.client.replica_id
                    rec["outcome"] = outcome
                st.inflight += 1
                st.requests_total += 1
                try:
                    async for chunk in st.client.stream(method, body):
                        yield chunk
                finally:
                    st.inflight -= 1
            else:
                async for chunk in self._stream_with_failover(
                        token_method, method == "chat_stream",
                        body, rec):
                    yield chunk
        except AdmissionRejected as e:
            if rec is not None:
                rec["status"] = f"rejected:{e.reason}"
            raise
        except GeneratorExit:
            if rec is not None:
                rec["status"] = "abandoned"
            raise
        except BaseException:
            if rec is not None:
                rec["status"] = "error"
            raise
        finally:
            self.admission.release()
            self._trace_end(rec)

    async def _stream_with_failover(self, token_method: str,
                                    is_chat: bool,
                                    body: Dict[str, Any],
                                    rec: Optional[Dict[str, Any]]
                                    ) -> AsyncIterator[str]:
        """The failover-aware SSE relay: drive the replica's token
        stream through the transcript (dedup by token index), render
        OpenAI SSE chunks with ONE stable completion id, and on a
        replica failure re-dispatch a token-exact continuation.

        The KV transport layers onto the same loop: a long
        prompt may first take the disaggregated handoff (prefill on a
        `prefill` replica, session shipped here), any attempt may be
        a RESUME of a shipped session instead of a fresh dispatch
        (`resume_stream_tokens` — the first chunk catches the
        transcript up, so index dedup keeps exactly-once), a serving
        replica may end its stream with a "migrated" marker (drain
        shipped the session off it — resume where the payload says),
        and a failing replica is first asked to EXPORT the session
        (failover-by-restore) before the replay continuation
        kicks in. Every transport failure — severed ship, corrupted
        payload, import rejection — degrades to replay, which is
        token-exact by construction."""
        failover.pin_stream_identity(body)
        srid = str(body.get("_request_id") or uuid.uuid4().hex[:16])
        cid = ("chatcmpl-" if is_chat else "cmpl-") + srid
        created = int(time.time())
        transcript = failover.StreamTranscript()
        model = self.model_id
        attempts = 0
        cur = body
        session: Optional[str] = None     # shipped payload to resume
        fp = prefix_fingerprint(body, self.router.config.prefix_depth)
        if rec is not None:
            rec["fp"] = fp
        if self._disagg_applies(body):
            handoff = await self._prefill_handoff(body, is_chat)
            if handoff is not None:
                kind, val = handoff
                if kind == "final":
                    # finished during prefill (1-token generations):
                    # nothing left to disaggregate
                    folded = transcript.fold(val)
                    if folded is not None:
                        _, text, _, reason = folded
                        if rec is not None:
                            rec["t_first"] = time.monotonic()
                            rec["out_tokens"] = len(transcript.tokens)
                            rec["finish"] = reason
                            rec["prompt_tokens"] = int(
                                val.get("prompt_tokens") or 0)
                        yield failover.sse_chunk(
                            is_chat, cid,
                            val.get("model") or model, created,
                            text, True, reason, transcript.tokens)
                    yield "data: [DONE]\n\n"
                    return
                session = val
        self._live_streams[srid] = {"replica": None,
                                    "method": token_method}
        try:
            while True:
                st, outcome = self._route(cur, fp)
                if rec is not None and rec["replica"] is None:
                    rec["t_route"] = time.monotonic()
                    rec["replica"] = st.client.replica_id
                    rec["outcome"] = outcome
                rid = st.client.replica_id
                self._live_streams[srid]["replica"] = rid
                resumed = session is not None
                if not resumed:
                    await self._prefix_seed(fp, cur, st)
                st.inflight += 1
                st.requests_total += 1
                gen = None
                anext_task = None
                migrated = False
                try:
                    if resumed:
                        # resume a shipped session: import on the
                        # target and stream from the transcript head
                        # (the catch-up chunk regenerates nothing —
                        # the exporter's emitted-but-undelivered
                        # tokens ride the payload)
                        self.kvt_metrics["ship_bytes"].inc(
                            len(session) * 3 // 4,
                            {"model": self.model_id,
                             "direction": "import"})
                        gen = st.client.stream(
                            "resume_stream_tokens",
                            {"_session": session,
                             "_resume_offset": len(transcript.tokens),
                             "_request_id": body.get("_request_id"),
                             "_trace": body.get("_trace")})
                        session = None
                    else:
                        # per-attempt COPY (see dispatch): in-process
                        # replicas pop plumbing keys off the dict they
                        # receive; the continuation must inherit the
                        # CANONICAL body — deadline, trace, seed
                        gen = st.client.stream(token_method, dict(cur))
                    it = gen.__aiter__()
                    while True:
                        # stall watchdog: a HUNG replica
                        # (wedged loop, stuck device call) never
                        # raises — without this bound the stream,
                        # its admission slot, and the client would
                        # strand forever even after eviction.
                        # DELIBERATELY not wait_for: a
                        # timeout must NOT cancel into the replica's
                        # generator — that would abort the engine
                        # request (dropping any parked session)
                        # before the failover-by-restore handler
                        # below gets a chance to export it; the
                        # pending read is cancelled in the finally,
                        # after the restore decision.
                        anext_task = asyncio.ensure_future(
                            it.__anext__())
                        done, _ = await asyncio.wait(
                            {anext_task},
                            timeout=self.health.stream_stall_timeout_s)
                        if not done:
                            raise failover.StreamStalled(
                                f"no chunk from {rid} within "
                                f"{self.health.stream_stall_timeout_s}"
                                f"s")
                        t, anext_task = anext_task, None
                        try:
                            chunk = t.result()
                        except StopAsyncIteration:
                            # ended without a finish chunk: the
                            # transport died quietly — same failover
                            # path as a loud failure
                            raise failover.StreamBroken(
                                f"token stream from {rid} ended "
                                f"without finish")
                        if rec is not None and not rec["prompt_tokens"]:
                            rec["prompt_tokens"] = int(
                                chunk.get("prompt_tokens") or 0)
                        folded = transcript.fold(chunk)
                        if folded is None:
                            continue             # replayed: dedup'd
                        toks, text, fin, reason = folded
                        model = chunk.get("model") or model
                        if rec is not None and toks:
                            if rec["t_first"] is None:
                                rec["t_first"] = time.monotonic()
                            rec["out_tokens"] = len(transcript.tokens)
                        if fin and reason == "migrated":
                            # live migration marker: the
                            # session left this replica mid-stream —
                            # the logical stream is NOT finished.
                            # Tokens riding the marker (the export's
                            # drain can fold a not-yet-evented token
                            # into it) were folded into the
                            # transcript above, and the resume offset
                            # starts AT the transcript head — so they
                            # must reach the client NOW or they would
                            # be silently skipped
                            if toks or text:
                                yield failover.sse_chunk(
                                    is_chat, cid, model, created,
                                    text, False, None, toks)
                            transcript.finished = False
                            transcript.reason = None
                            migrated = True
                            break
                        yield failover.sse_chunk(
                            is_chat, cid, model, created, text, fin,
                            reason, toks)
                        if fin:
                            if reason == "deadline":
                                self._count_deadline_shed("engine")
                            if rec is not None:
                                rec["finish"] = reason
                            yield "data: [DONE]\n\n"
                            await self._prefix_publish(fp, body, st)
                            return
                except (GeneratorExit, asyncio.CancelledError):
                    raise            # client gone: nothing to fail over
                except AdmissionRejected:
                    raise
                except TransportError as exc:
                    # a corrupted/stale shipped payload landing on a
                    # HEALTHY replica: not the replica's fault (no
                    # breaker food, no failover budget) — degrade to
                    # the replay continuation
                    self.recorder.record(
                        "kv_resume_failed", replica=rid,
                        request_id=srid, error=repr(exc))
                    cur = failover.continuation_body(body, transcript)
                except Exception as exc:
                    if resumed and failover.is_request_fault(exc):
                        # the import was REJECTED (id collision,
                        # incompatible geometry): same degradation as
                        # a corrupted payload
                        self.recorder.record(
                            "kv_resume_failed", replica=rid,
                            request_id=srid, error=repr(exc))
                        cur = failover.continuation_body(
                            body, transcript)
                    elif not self._should_failover(rid, "stream", exc,
                                                   attempts):
                        raise
                    else:
                        attempts += 1
                        if rec is not None:
                            rec["failovers"] = attempts
                        self.recorder.record(
                            "failover", mode="stream", replica=rid,
                            request_id=srid,
                            tokens_delivered=len(transcript.tokens),
                            attempt=attempts, error=repr(exc))
                        # failover-by-restore fast path:
                        # if the victim can still hand the session
                        # over (pages already spilled, or only the
                        # stream is wedged), resume beats replay —
                        # NOTE: runs before the finally closes the
                        # attempt generator, i.e. before the victim's
                        # server aborts the engine request
                        session = await self._restore_handoff(
                            rid, srid)
                        if session is None:
                            cur = failover.continuation_body(
                                body, transcript)
                finally:
                    st.inflight -= 1
                    if anext_task is not None:
                        # the stalled read abandoned above — cancel
                        # it NOW (after the restore decision): the
                        # replica-side generator unwinds and aborts
                        # its engine request like a real disconnect
                        # (a no-op if the session was just exported:
                        # the request is already finished "migrated")
                        anext_task.cancel()
                        try:
                            await anext_task
                        except (asyncio.CancelledError, Exception):
                            pass
                    if gen is not None:
                        # close the attempt's generator (a stalled one
                        # is abandoned mid-chunk): the replica side
                        # aborts its engine request like a real
                        # disconnect
                        await failover.close_quietly(gen)
                if migrated:
                    # the marker is enqueued inside the victim's
                    # export call, so this relay can observe it a few
                    # scheduler turns before the orchestrator's
                    # `_migrations[srid] = payload` bookkeeping runs —
                    # give that assignment a bounded grace before
                    # declaring the ship lost
                    session = self._migrations.pop(srid, None)
                    for _ in range(100):
                        if session is not None:
                            break
                        await asyncio.sleep(0.01)
                        session = self._migrations.pop(srid, None)
                    if session is None:
                        # the ship was lost mid-migration (severed
                        # export, crashed orchestrator): replay
                        self.recorder.record(
                            "migration_lost", request_id=srid)
                        cur = failover.continuation_body(
                            body, transcript)
        finally:
            self._live_streams.pop(srid, None)
            self._migrations.pop(srid, None)

    # -- fleet KV transport ----------------------------------
    def _ship_span(self, name: str, replica: str, t0: float,
                   request_id: Optional[str] = None,
                   **args: Any) -> None:
        """One KV-transport span into the ingress trace buffer —
        migrations/handoffs show up in GET /fleet/debug/trace beside
        the request lifecycles they interrupt."""
        if not self.enable_tracing:
            return
        self.trace.add(tracing.complete_event(
            name, "kv_transport", tracing.mono_to_epoch(t0),
            time.monotonic() - t0, tid=0,
            args={"replica": replica,
                  **({"request_id": request_id} if request_id
                     else {}),
                  **args}))

    def _pick_prefill(self) -> Optional[_ReplicaState]:
        """Least-loaded healthy ACTIVE prefill-role replica, or None
        (disaggregation silently degrades to mixed prefill)."""
        cands = [st for st in self.replicas.values()
                 if st.status == ACTIVE
                 and st.role == kv_transport.ROLE_PREFILL
                 and st.breaker.state == failover.CLOSED]
        if not cands:
            return None
        return min(cands, key=lambda st: (st.inflight,
                                          st.client.replica_id))

    def _disagg_applies(self, body: Dict[str, Any]) -> bool:
        t = self.transport
        return (t is not None and t.enable_disagg
                and kv_transport.prompt_char_len(body)
                >= t.disagg_prompt_chars
                and self._pick_prefill() is not None)

    async def _prefill_handoff(self, body: Dict[str, Any],
                               is_chat: bool
                               ) -> "Optional[tuple]":
        """Disaggregated prefill: run the long prompt on
        a prefill replica and take the parked session for a decode
        replica to resume. -> ("session", payload) | ("final",
        chunk) when the request finished during prefill | None on
        any failure (the caller falls back to mixed prefill — the
        pre-transport path, always correct)."""
        st = self._pick_prefill()
        if st is None:
            return None
        rid = st.client.replica_id
        pbody = dict(body)
        pbody["_chat"] = is_chat
        st.inflight += 1
        st.requests_total += 1
        t0 = time.monotonic()
        try:
            # bound generously: a cold prefill replica may be
            # compiling — the same reasoning as the stall timeout
            out = await asyncio.wait_for(
                st.client.call("prefill_export", pbody),
                max(self.transport.ship_timeout_s,
                    self.health.stream_stall_timeout_s))
        except (AdmissionRejected, asyncio.CancelledError):
            raise
        except Exception as exc:
            if not failover.is_request_fault(exc):
                self._note_replica_failure(
                    rid, f"prefill:{type(exc).__name__}",
                    hard=not isinstance(exc, asyncio.TimeoutError))
            self.recorder.record("disagg_fallback", replica=rid,
                                 error=repr(exc))
            return None
        finally:
            st.inflight -= 1
        if out and out.get("final"):
            self._ship_span("disagg_prefill_final", rid, t0,
                            str(body.get("_request_id")))
            return ("final", out["final"])
        payload = (out or {}).get("session")
        if not payload:
            self.recorder.record("disagg_fallback", replica=rid,
                                 error="not exportable")
            return None
        tags = {"model": self.model_id}
        self.kvt_metrics["sessions_shipped"].inc(
            1, {**tags, "kind": "disagg"})
        self.kvt_metrics["ship_bytes"].inc(
            int(out.get("bytes") or 0),
            {**tags, "direction": "export"})
        self._ship_span("disagg_prefill", rid, t0,
                        str(body.get("_request_id")),
                        bytes=int(out.get("bytes") or 0),
                        pages=out.get("pages"))
        self.recorder.record(
            "disagg_handoff", replica=rid,
            request_id=str(body.get("_request_id")),
            bytes=out.get("bytes"), pages=out.get("pages"),
            generated=out.get("generated"))
        return ("session", payload)

    async def _restore_handoff(self, victim: str, srid: str
                               ) -> Optional[str]:
        """Failover-by-restore: a pre-shipped payload
        (drain migration raced the failure) or a live export off the
        failing replica — which succeeds exactly when the victim can
        still serve control calls (pages already spilled to its host
        tier, or only the stream plane is wedged). None -> the
        caller replays, token-exact either way."""
        t = self.transport
        if t is None or not t.enable_migration:
            return None
        pend = self._migrations.pop(srid, None)
        if pend is not None:
            return pend
        st = self.replicas.get(victim)
        if st is None:
            return None
        t0 = time.monotonic()
        try:
            out = await asyncio.wait_for(
                st.client.call("export_session",
                               {"request_id": srid,
                                "reason": "failover"}),
                t.ship_timeout_s)
        except Exception:
            return None
        payload = (out or {}).get("session")
        if not payload:
            return None
        tags = {"model": self.model_id}
        self.kvt_metrics["sessions_shipped"].inc(
            1, {**tags, "kind": "restore"})
        self.kvt_metrics["ship_bytes"].inc(
            int(out.get("bytes") or 0), {**tags,
                                         "direction": "export"})
        self._ship_span("failover_restore", victim, t0, srid,
                        bytes=int(out.get("bytes") or 0))
        self.recorder.record("failover_restore", replica=victim,
                             request_id=srid,
                             bytes=out.get("bytes"),
                             pages=out.get("pages"))
        return payload

    async def _migrate_sessions_off(self, rid: str) -> int:
        """Drain migration: export every relay-driven
        stream this replica is serving; each stream's relay sees the
        "migrated" finish marker, claims its payload here, and
        resumes on a ring replica — tokens ship as pages, not
        replays. Best-effort per session: anything that fails to
        export just finishes on the draining replica like before."""
        t = self.transport
        st = self.replicas.get(rid)
        if t is None or not t.enable_migration or st is None:
            return 0
        moved = 0
        for srid, info in list(self._live_streams.items()):
            if info.get("replica") != rid \
                    or srid in self._migrations:
                continue
            t0 = time.monotonic()
            try:
                out = await asyncio.wait_for(
                    st.client.call("export_session",
                                   {"request_id": srid,
                                    "reason": "drain"}),
                    t.ship_timeout_s)
            except Exception as exc:
                self.recorder.record("migration_failed", replica=rid,
                                     request_id=srid,
                                     error=repr(exc))
                continue
            payload = (out or {}).get("session")
            if not payload:
                continue
            self._migrations[srid] = payload
            moved += 1
            tags = {"model": self.model_id}
            self.kvt_metrics["sessions_shipped"].inc(
                1, {**tags, "kind": "migration"})
            self.kvt_metrics["ship_bytes"].inc(
                int(out.get("bytes") or 0),
                {**tags, "direction": "export"})
            self._ship_span("session_migration", rid, t0, srid,
                            bytes=int(out.get("bytes") or 0),
                            pages=out.get("pages"))
            self.recorder.record(
                "session_migrated", replica=rid, request_id=srid,
                bytes=out.get("bytes"), pages=out.get("pages"),
                generated=out.get("generated"))
        return moved

    def _prefix_eligible(self, body: Dict[str, Any]) -> bool:
        t = self.transport
        if t is None or not t.enable_prefix_store \
                or self.prefix_store is None:
            return False
        if body.get("prompt") is None:
            # chat renderings are template-specific; the plain-prompt
            # prefix is the one chain both tokenizer paths share
            return False
        depth = self.router.config.prefix_depth
        return len(str(body["prompt"])[:depth]) >= t.prefix_min_chars

    async def _prefix_seed(self, fp: str, body: Dict[str, Any],
                           st: _ReplicaState) -> None:
        """Seed the routed replica with a published prefix it has not
        prefilled itself — best-effort and once per
        replica per fingerprint."""
        if not self._prefix_eligible(body):
            return
        ent = self.prefix_store.get(fp)
        rid = st.client.replica_id
        if ent is None or rid in ent.seeded:
            return
        t0 = time.monotonic()
        try:
            out = await asyncio.wait_for(
                st.client.call("import_prefix",
                               {"prefix": ent.payload}),
                self.transport.ship_timeout_s)
        except Exception as exc:
            self.recorder.record("prefix_seed_failed", replica=rid,
                                 error=repr(exc))
            return
        ent.seeded.add(rid)
        if (out or {}).get("pages"):
            self.prefix_store.hits += 1
            tags = {"model": self.model_id}
            self.kvt_metrics["prefix_store_hits"].inc(1, tags)
            self.kvt_metrics["ship_bytes"].inc(
                len(ent.payload) * 3 // 4,
                {**tags, "direction": "import"})
            self._ship_span("prefix_seed", rid, t0,
                            pages=out["pages"], fp=fp[:12])
            self.recorder.record("prefix_seeded", replica=rid,
                                 pages=out["pages"], fp=fp[:12])

    async def _prefix_publish(self, fp: str, body: Dict[str, Any],
                              st: _ReplicaState) -> None:
        """Publish a served prefix into the fleet store
        — ATTEMPTED once per fingerprint (success or not: a workload
        of distinct prompts must not pay an export round-trip on
        every response), exported from the replica that just
        (cheaply, cache-hot) served it."""
        if not self._prefix_eligible(body) \
                or fp in self.prefix_store \
                or fp in self._prefix_attempted:
            return
        self._prefix_attempted.add(fp)
        depth = self.router.config.prefix_depth
        text = str(body["prompt"])[:depth]
        rid = st.client.replica_id
        t0 = time.monotonic()
        try:
            out = await asyncio.wait_for(
                st.client.call("export_prefix", {"text": text}),
                self.transport.ship_timeout_s)
        except Exception as exc:
            self.recorder.record("prefix_publish_failed",
                                 replica=rid, error=repr(exc))
            return
        payload = (out or {}).get("prefix")
        if not payload:
            return
        self.prefix_store.put(fp, payload,
                              tokens=int(out.get("tokens") or 0),
                              publisher=rid)
        self.kvt_metrics["ship_bytes"].inc(
            int(out.get("bytes") or 0),
            {"model": self.model_id, "direction": "export"})
        self._ship_span("prefix_publish", rid, t0,
                        tokens=out.get("tokens"), fp=fp[:12])
        self.recorder.record("prefix_published", replica=rid,
                             tokens=out.get("tokens"), fp=fp[:12])

    # -- health state machine ---------------------------------
    def _set_breaker_gauge(self, rid: str) -> None:
        self.metrics["breaker"].set(
            self.replicas[rid].breaker.gauge(),
            {"model": self.model_id, "replica": rid})

    def _should_failover(self, rid: str, mode: str,
                         exc: BaseException, attempts: int) -> bool:
        """The ONE failover policy for unary and stream attempts:
        classify the fault (request-caused faults surface unchanged —
        a retry would fail identically and the replica is fine), feed
        the breaker, check the retry budget, count the metric.
        Returns False when the caller must re-raise."""
        if failover.is_request_fault(exc):
            return False
        # a TIMEOUT (the ingress's own deadline-grace timer) is
        # ambiguous — hung replica vs cold compile vs a tight client
        # deadline — so it counts SOFTLY toward the threshold; a loud
        # failure (severed stream, raised call) is a death signal and
        # trips immediately
        self._note_replica_failure(
            rid, f"{mode}:{type(exc).__name__}",
            hard=not isinstance(exc, asyncio.TimeoutError))
        if attempts >= self.health.max_failovers:
            return False
        self.metrics["failovers"].inc(1, {"model": self.model_id})
        return True

    def _note_replica_failure(self, rid: str, reason: str,
                              hard: bool = True) -> None:
        """A dispatch/stream against this replica failed — a stronger
        death signal than a slow probe, so (by default, and unless
        the caller softens it) it trips the breaker immediately and
        evicts, instead of waiting out probe_failures refresh
        cycles."""
        st = self.replicas.get(rid)
        if st is None:
            return
        st.breaker.record_failure(
            hard=hard and self.health.fail_fast_on_dispatch)
        self._set_breaker_gauge(rid)
        # evict on the open TRANSITION — and also when the breaker
        # was already open but the eviction had been deferred (sole
        # active replica at the time; another may have activated
        # since, making the eviction possible now)
        if st.breaker.state == failover.OPEN:
            self._evict(rid, reason)

    def _evict(self, rid: str, reason: str) -> None:
        """The breaker opened: remove the replica from the router
        ring NOW (in-flight work fails over; new work never routes
        here) and mark it UNHEALTHY so only half-open probes can
        bring it back. Never evicts the LAST active replica — a
        false positive there would turn an incident into a total
        blackout; its open breaker still gates recovery."""
        st = self.replicas[rid]
        if st.status != ACTIVE:
            return                 # draining/standby: not in the ring
        if rid in self._ring_ids() \
                and not [r for r in self._ring_ids() if r != rid]:
            # the SOLE ring replica: activate a standby replacement
            # if one exists — spare healthy capacity must not idle
            # while everything routes to a dead replica. With no
            # standby either, defer: the breaker still gates
            # recovery, but an empty ring would be a total blackout.
            # (An evicted PREFILL replica never empties the ring —
            # disaggregation just falls back to mixed prefill.)
            # The replacement must itself be decode-capable: swapping
            # the last ring replica for a prefill-role standby would
            # leave the ring empty — the exact blackout this branch
            # exists to prevent
            standby = [r for r in self._ids(STANDBY)
                       if self.replicas[r].role
                       != kv_transport.ROLE_PREFILL]
            if not standby:
                self.recorder.record("eviction_deferred", replica=rid,
                                     reason=reason)
                return
            sub = standby[0]
            self.replicas[sub].status = ACTIVE
            self.recorder.record("failover_activate", replica=sub,
                                 replacing=rid)
            self._scale_events.append(
                {"ts": time.time(), "event": "activate",
                 "replica": sub, "reason": f"replacing:{rid}"})
        st.status = UNHEALTHY
        self._sync_ring()
        self.metrics["evictions"].inc(1, {"model": self.model_id})
        self.recorder.record("replica_evicted", replica=rid,
                             reason=reason,
                             trips=st.breaker.trips)
        self._scale_events.append(
            {"ts": time.time(), "event": "evict", "replica": rid,
             "reason": reason})
        # postmortem breadcrumb: best-effort black-box of the evicted
        # replica (it may be dead — the dump call is allowed to
        # fail). The task reference is RETAINED until done: the loop
        # holds tasks weakly, and a GC'd pending dump would silently
        # drop the one artifact the eviction exists to capture.
        try:
            task = asyncio.get_running_loop().create_task(
                self._dump_one(rid, f"evicted:{reason}"))
            self._dump_tasks.add(task)
            task.add_done_callback(self._dump_tasks.discard)
        except RuntimeError:
            pass                   # no running loop (a synchronous caller)

    async def _dump_one(self, rid: str, cause: str) -> None:
        try:
            await asyncio.wait_for(
                self.replicas[rid].client.call(
                    "debug_dump", {"cause": cause}),
                timeout=self.dispatch_timeout_s)
        except Exception:
            pass

    def _readmit(self, rid: str) -> None:
        """The breaker closed (half-open probes passed): back into
        the router ring. The autoscaler trims any surplus on its own
        cadence."""
        st = self.replicas[rid]
        if st.status != UNHEALTHY:
            return
        st.status = ACTIVE
        self._sync_ring()
        self.recorder.record("replica_readmitted", replica=rid,
                             trips=st.breaker.trips)
        self._scale_events.append(
            {"ts": time.time(), "event": "readmit", "replica": rid})

    # -- stats refresh --------------------------------------------------
    async def refresh(self) -> None:
        """Pull fleet_stats from every non-standby replica — the
        probe loop that drives the health state machine: consecutive
        failures/timeouts open the breaker (evict from the ring),
        and once its cooldown passes, half-open probes decide
        re-admission. A successful probe stamps a FRESH snapshot
        (mono_ts), so the router can deprioritize replicas whose
        numbers have gone stale instead of trusting them forever."""
        ids = self._ids(ACTIVE, DRAINING, UNHEALTHY)
        now = time.monotonic()

        async def one(rid: str):
            st = self.replicas[rid]
            if not st.breaker.should_probe(now):
                return          # open, inside its cooldown: leave it
            self._set_breaker_gauge(rid)     # open->half-open visible
            try:
                stats = await asyncio.wait_for(
                    st.client.call("fleet_stats"),
                    timeout=self.probe_timeout_s)
            except Exception as exc:
                st.breaker.record_failure()
                self._set_breaker_gauge(rid)
                if st.breaker.state == failover.OPEN:
                    # covers the transition AND a previously deferred
                    # eviction (last-active then; maybe not anymore)
                    self._evict(rid,
                                f"probe:{type(exc).__name__}")
                return                       # keep the stale snapshot
            closed = st.breaker.record_success()
            self._set_breaker_gauge(rid)
            snap = ReplicaSnapshot.from_stats(stats)
            snap.replica = rid
            st.snapshot = snap
            st.slo_totals = dict(stats.get("slo_totals") or {})
            if closed:
                self._readmit(rid)

        await asyncio.gather(*(one(rid) for rid in ids))
        self._update_perf_gauges()

    def _update_perf_gauges(self) -> None:
        """Aggregate per-replica MFU/MBU into the fleet gauges
       : goodput-weighted over ACTIVE replicas, falling
        back to a plain mean when no tokens flowed in the window."""
        snaps = [st.snapshot for rid, st in self.replicas.items()
                 if st.status == ACTIVE and st.snapshot is not None]
        if not snaps:
            return
        w = sum(s.decode_tps + s.prefill_tps for s in snaps)
        if w > 0:
            mfu = sum(s.mfu * (s.decode_tps + s.prefill_tps)
                      for s in snaps) / w
            mbu = sum(s.mbu * (s.decode_tps + s.prefill_tps)
                      for s in snaps) / w
        else:
            mfu = sum(s.mfu for s in snaps) / len(snaps)
            mbu = sum(s.mbu for s in snaps) / len(snaps)
        tags = {"model": self.model_id}
        self._fleet_mfu_gauge.set(round(mfu, 6), tags)
        self._fleet_mbu_gauge.set(round(mbu, 6), tags)

    # -- autoscaling ----------------------------------------------------
    def _window_metrics(self) -> FleetMetrics:
        """Fleet aggregates over the window since the last call:
        deltas of the cumulative TTFT/queue-wait sums each replica's
        telemetry summary exports, plus live queue depths and
        the admission shed delta. Deltas are tracked PER REPLICA ID,
        not on a fleet sum over the changing ACTIVE/DRAINING set — a
        replica parking to STANDBY must not show up as a negative
        window, and a reactivated one must contribute only its growth
        since last seen, not its lifetime totals."""
        keys = ("ttft_s", "ttft_n", "queue_s", "queue_n")
        d = {k: 0.0 for k in keys}
        waiting = 0
        occ: List[float] = []
        pressure = 0.0
        for rid, st in self.replicas.items():
            if st.slo_totals:
                prev = self._prev_slo.get(rid, {})
                cur = {k: float(st.slo_totals.get(k, 0.0))
                       for k in keys}
                for k in keys:
                    # clamped: an engine restart resets its counters
                    d[k] += max(0.0, cur[k] - prev.get(k, 0.0))
                self._prev_slo[rid] = cur
            if st.snapshot is not None and st.status == ACTIVE:
                # batch lane: queued priority-0 bulk work
                # is harvested idle capacity — the autoscaler must
                # scale on INTERACTIVE depth only, or a deliberately
                # deep batch backlog would page the fleet to max
                waiting += st.snapshot.displaceable_waiting()
                occ.append(st.snapshot.interactive_occupancy())
                # max, not mean: one oversubscribed replica
                # is already spill/restore-taxing its streams even
                # when its siblings sit idle
                pressure = max(pressure, st.snapshot.page_pressure)
        shed = (self.admission.shed_total
                + self.admission.rejected["queue_full"]
                + self.admission.rejected["brownout"])
        shed_delta = shed - self._prev_shed
        self._prev_shed = shed
        return FleetMetrics(
            ttft_ms=(d["ttft_s"] / d["ttft_n"] * 1e3
                     if d["ttft_n"] > 0 else 0.0),
            queue_wait_ms=(d["queue_s"] / d["queue_n"] * 1e3
                           if d["queue_n"] > 0 else 0.0),
            waiting=waiting,
            occupancy=(sum(occ) / len(occ) if occ else 0.0),
            shed_delta=shed_delta,
            slo_page=self.watchdog.paging,
            slo_burn=self.watchdog.max_burn,
            page_pressure=pressure,
            chips_per_slice=self.chips_per_slice())

    # -- SLO burn-rate watchdog -------------------------------
    def _watchdog_totals(self) -> Dict[str, float]:
        """Fleet-summed monotone SLO totals, accumulated per replica
        id with clamped deltas (same reasoning as _window_metrics:
        replica restarts and membership changes must not produce
        negative or replayed burn windows)."""
        for rid, st in self.replicas.items():
            if not st.slo_totals:
                continue
            prev = self._watch_prev.get(rid, {})
            cur = {k: float(st.slo_totals.get(k, 0.0))
                   for k in _WATCH_KEYS}
            for k in _WATCH_KEYS:
                self._watch_accum[k] += max(
                    0.0, cur[k] - prev.get(k, 0.0))
            self._watch_prev[rid] = cur
        return dict(self._watch_accum)

    def _interactive_idle(self) -> bool:
        """No interactive demand anywhere: front door empty AND every
        ACTIVE replica's snapshot shows zero interactive requests
        queued or decoding (batch-lane depth is the trough's own soak
        and does not count). Conservative toward False — a missing
        snapshot is unknown, not idle."""
        if self.admission.inflight > 0 \
                or self.admission._queue_len() > 0:
            return False
        for st in self.replicas.values():
            if st.status != ACTIVE:
                continue
            snap = st.snapshot
            if snap is None:
                return False
            if (snap.active - snap.active_batch) > 0 \
                    or snap.displaceable_waiting() > 0:
                return False
        return True

    def watchdog_tick(self, now: Optional[float] = None) -> None:
        """One watchdog evaluation over the freshly-refreshed replica
        totals, plus the reactions: brownout the front door while
        paging (shed before the SLO is blown) and black-box every
        replica on the page transition (the postmortem wants the
        fleet's state AT the breach, not after the restart)."""
        if not self.watchdog.config.enabled:
            return
        was_paging = self.watchdog.paging
        self.watchdog.observe(self._watchdog_totals(), now,
                              idle=self._interactive_idle())
        paging = self.watchdog.paging
        # KV page pressure: max over active replicas, with
        # fleet spillability deciding the reaction — pressure on a
        # fleet that can spill to its host tiers is a LATENCY tier
        # (requests queue with backpressure and complete), so only a
        # non-spillable pressured fleet sheds at the front door
        pressure = 0.0
        spillable = True
        anomaly_rate = 0.0
        for st in self.replicas.values():
            snap = st.snapshot
            if snap is None or st.status != ACTIVE:
                continue
            if snap.page_pressure > pressure:
                pressure = snap.page_pressure
                spillable = snap.spillable
            anomaly_rate = max(anomaly_rate, snap.anomaly_rate)
        self.watchdog.observe_pressure(pressure)
        # tick-anomaly page precursor: watch-only — the
        # alert precedes SLO burn, it never sheds on its own
        self.watchdog.observe_anomaly(anomaly_rate)
        pressure_shed = (self.watchdog.pressure_state == "high"
                         and not spillable)
        self.admission.set_page_pressure(pressure, spillable)
        if self.admission.set_brownout(paging or pressure_shed):
            self.recorder.record(
                "brownout_on" if (paging or pressure_shed)
                else "brownout_off",
                burn=round(self.watchdog.max_burn, 3),
                page_pressure=round(pressure, 4))
        if paging and not was_paging:
            try:
                self._page_dump_task = \
                    asyncio.get_running_loop().create_task(
                        self.debug_dump_all("slo_page"))
            except RuntimeError:
                pass     # no running loop (a synchronous caller)

    async def debug_dump_all(self, cause: str) -> Dict[str, Any]:
        """Ask every non-standby replica to snapshot a postmortem
        black-box bundle (watchdog page / POST /debug/dump).
        UNHEALTHY replicas included — an evicted-but-alive replica is
        the one most likely implicated in whatever paged; a dead one
        degrades to its error row under the timeout."""
        ids = self._ids(ACTIVE, DRAINING, UNHEALTHY)

        async def one(rid: str):
            try:
                return rid, await asyncio.wait_for(
                    self.replicas[rid].client.call(
                        "debug_dump", {"cause": cause}),
                    timeout=self.dispatch_timeout_s)
            except Exception as e:
                return rid, {"error": repr(e)}

        out = dict(await asyncio.gather(*(one(rid) for rid in ids)))
        self.recorder.record("postmortem_dump", cause=cause,
                             replicas=sorted(out))
        return out

    async def autoscale_tick(self, now: Optional[float] = None) -> int:
        """One control-loop iteration: refresh → watchdog → decide →
        apply. Returns the applied target (also at GET /fleet)."""
        await self.refresh()
        self.watchdog_tick(now)
        active = len(self._ids(ACTIVE))
        target = self.autoscaler.decide(self._window_metrics(),
                                        active, now)
        if target != active:
            self._apply_target(target)
        return target

    def _apply_target(self, target: int) -> None:
        active = self._ids(ACTIVE)
        if target > len(active):
            for rid in self._ids(STANDBY)[:target - len(active)]:
                self.replicas[rid].status = ACTIVE
                self._scale_events.append(
                    {"ts": time.time(), "event": "activate",
                     "replica": rid})
        elif target < len(active):
            # drain the emptiest replicas first: least in-flight work,
            # then least KV occupancy (cheapest caches to lose)
            def cost(rid: str):
                st = self.replicas[rid]
                occ = (st.snapshot.kv_occupancy
                       if st.snapshot is not None else 0.0)
                return (st.inflight, occ)

            chosen: List[str] = []
            for rid in sorted(active, key=cost):
                if len(chosen) >= len(active) - target:
                    break
                # never drain the LAST decode-capable replica: an
                # idle mixed replica must not be sacrificed while
                # prefill-role replicas (which can never serve ring
                # traffic) stay ACTIVE — that would empty the ring
                if rid in self._ring_ids() and not [
                        r for r in self._ring_ids()
                        if r != rid and r not in chosen]:
                    continue
                chosen.append(rid)
            for rid in chosen:
                self._begin_drain(rid)
        self._sync_ring()

    def _begin_drain(self, rid: str) -> None:
        st = self.replicas[rid]
        st.status = DRAINING
        self._scale_events.append(
            {"ts": time.time(), "event": "drain_begin", "replica": rid})
        st.drain_task = asyncio.get_running_loop().create_task(
            self._drain_to_standby(rid, self.drain_timeout_s))

    async def _drain_to_standby(self, rid: str,
                                timeout_s: float = 120.0) -> None:
        """Out of the ring already; wait for the router-side in-flight
        count to hit zero (every stream completed), then for the
        engine itself to run dry (the replica's drain() polls
        has_work(), which counts in-flight pipelined ticks and pending
        folds), then park."""
        st = self.replicas[rid]
        attempt = 0
        while True:
            deadline = time.monotonic() + timeout_s
            # KV transport: ship the replica's live
            # sessions to the survivors FIRST — their relays resume
            # from restored pages instead of replaying tokens, and
            # the in-flight count below drops as each relay moves off
            moved = await self._migrate_sessions_off(rid)
            if moved:
                self._scale_events.append(
                    {"ts": time.time(), "event": "drain_migrate",
                     "replica": rid, "sessions": moved})
            while st.inflight > 0 and time.monotonic() < deadline:
                await asyncio.sleep(0.02)
            drained = True
            try:
                rep = await st.client.call("drain", timeout_s)
                drained = bool((rep or {}).get("drained", True))
            except Exception:
                pass    # best-effort: the replica may not expose drain
            if st.inflight == 0 and drained:
                break
            # wedged: STAY DRAINING — out of the ring and ineligible
            # for reactivation (_apply_target only activates STANDBY)
            # — and retry; parking dirty would hand a replica known
            # unable to finish work back to the router on scale-up
            attempt += 1
            self._scale_events.append(
                {"ts": time.time(), "event": "drain_retry",
                 "replica": rid, "attempt": attempt})
            await asyncio.sleep(min(30.0, 2.0 * attempt))
        st.status = STANDBY
        self._scale_events.append(
            {"ts": time.time(), "event": "drain_done", "replica": rid,
             "clean": attempt == 0})

    # -- background control loop ---------------------------------------
    def start(self) -> None:
        """Start the refresh + autoscale loop on the current event
        loop (idempotent). Separate cadences: stats refresh keeps the
        router's view fresh; autoscale decisions run slower."""
        if self._loop_task is None or self._loop_task.done():
            self._loop_task = asyncio.get_running_loop().create_task(
                self._control_loop())

    async def stop(self) -> None:
        if self.batch is not None:
            await self.batch.stop()
        if self._loop_task is not None:
            self._loop_task.cancel()
            try:
                await self._loop_task
            except (asyncio.CancelledError, Exception):
                pass
            self._loop_task = None

    async def _control_loop(self) -> None:
        last_autoscale = 0.0
        while True:
            try:
                await self.refresh()
                self.watchdog_tick()
                now = time.monotonic()
                if now - last_autoscale >= self.autoscale_period_s:
                    last_autoscale = now
                    active = len(self._ids(ACTIVE))
                    target = self.autoscaler.decide(
                        self._window_metrics(), active)
                    if target != active:
                        self._apply_target(target)
            except asyncio.CancelledError:
                raise
            except Exception:
                import logging
                logging.getLogger(__name__).exception(
                    "fleet control loop iteration failed")
            await asyncio.sleep(self.refresh_period_s)

    # -- observability --------------------------------------------------
    async def metrics_text(self) -> str:
        """ONE valid Prometheus exposition for the whole fleet.

        Two registry topologies:
        - shared registry (in-process replicas / local testing): every
          scrape renders the same process registry; each replica's
          engine tags its own series with its replica id, so the fleet
          scrapes every replica (each refreshes its own gauges) and
          keeps the LAST rendering — by then every replica's gauges
          are fresh in the shared registry.
        - separate registries (real replica actors): each exposition
          is scraped independently and relabeled with replica=<id> so
          identical series from different replicas cannot collide or
          silently sum in the merged document.
        """
        from ...util.metrics import (export_prometheus,
                                     merge_expositions,
                                     relabel_exposition)

        # UNHEALTHY included: an evicted replica's series must not
        # vanish from the merged exposition mid-incident (rate()
        # gaps, absent-series alerts); a dead one just times out
        ids = self._ids(ACTIVE, DRAINING, UNHEALTHY)

        async def one(rid: str):
            st = self.replicas[rid]
            try:
                return (rid, st.client, await asyncio.wait_for(
                    st.client.call("metrics_text"),
                    timeout=self.probe_timeout_s))
            except Exception:
                return None     # a wedged replica can't black out
                                # the whole fleet's scrape

        texts = [t for t in await asyncio.gather(
            *(one(rid) for rid in ids)) if t is not None]
        if not texts:
            return export_prometheus()
        if all(c.shares_registry for _, c, _ in texts):
            return texts[-1][2]
        # separate registries: the ingress's own series (watchdog
        # burn-rate gauges, alert counters) live in THIS process's
        # registry — merge them in unrelabeled (they are fleet-scoped,
        # not per-replica)
        return merge_expositions(
            [relabel_exposition(t, {"replica": rid})
             for rid, _, t in texts] + [export_prometheus()])

    async def status(self) -> Dict[str, Any]:
        """The GET /fleet document: routing inputs per replica,
        router/admission counters, last autoscale decision."""
        reps: Dict[str, Any] = {}
        for rid, st in self.replicas.items():
            snap = st.snapshot
            reps[rid] = {
                "status": st.status,
                "role": st.role,
                "inflight": st.inflight,
                "requests_total": st.requests_total,
                "breaker": st.breaker.stats(),
                **({} if snap is None else {
                    # slice topology: chips this replica's
                    # engine mesh occupies (a tp slice reports tp);
                    # mfu below is already per chip (the engine's
                    # accountant divides by mesh size)
                    "chips": snap.chips,
                    "active": snap.active,
                    "waiting": snap.waiting,
                    # batch lane: the preemptible share
                    "waiting_batch": snap.waiting_batch,
                    "active_batch": snap.active_batch,
                    "kv_occupancy": round(snap.kv_occupancy, 4),
                    "free_pages": snap.free_pages,
                    "prefix_cache_hit_rate": round(
                        snap.cache_hit_rate, 4),
                    "last_tick_age_s": snap.last_tick_age_s,
                    # KV memory hierarchy: host-tier
                    # occupancy + oversubscription per replica
                    "page_pressure": round(snap.page_pressure, 4),
                    "parked_sessions": snap.parked,
                    "kv_offload": snap.spillable,
                    # host-tier byte occupancy —
                    # migration/prefix-store pressure before page
                    # counts saturate
                    "kv_host_bytes_used": snap.kv_host_bytes,
                    # perf accounting: recent utilization
                    # against the replica's hardware envelope
                    "mfu": round(snap.mfu, 6),
                    "mbu": round(snap.mbu, 6),
                    "roof": snap.roof,
                    "decode_tokens_per_s": round(snap.decode_tps, 3),
                    "prefill_tokens_per_s": round(
                        snap.prefill_tps, 3),
                    # tick-anomaly analyzer: recent
                    # anomaly rate + lifetime count per replica
                    "anomaly_rate": round(snap.anomaly_rate, 4),
                    "anomalies_total": snap.anomalies_total,
                    **({"anomaly_last_kind": snap.anomaly_last_kind}
                       if snap.anomaly_last_kind else {}),
                    # snapshot age: how old the routing
                    # inputs above are — stale = probes failing
                    "snapshot_age_s": round(snap.age_s(), 3),
                }),
            }
        return {
            "replicas": reps,
            "router": self.router.stats(),
            "admission": self.admission.stats(),
            "watchdog": {
                "enabled": self.watchdog.config.enabled,
                "paging": self.watchdog.paging,
                "state": dict(self.watchdog.state),
                "burn": self.watchdog.last,
                "alerts_total": self.watchdog.alerts_total,
                "objective": self.watchdog.config.objective,
                # fleet page-pressure monitor
                "page_pressure": round(self.watchdog.last_pressure, 4),
                "pressure_state": self.watchdog.pressure_state,
                # tick-anomaly page precursor
                "anomaly_rate": round(
                    self.watchdog.last_anomaly_rate, 4),
                "anomaly_state": self.watchdog.anomaly_state,
            },
            "tracing": {
                "enabled": self.enable_tracing,
                "ingress_buffer": self.trace.stats(),
            },
            # fleet KV transport
            "transport": {
                "enabled": self.transport is not None,
                **({} if self.transport is None else {
                    "roles": {rid: st.role
                              for rid, st in self.replicas.items()},
                    "disagg": self.transport.enable_disagg,
                    "migration": self.transport.enable_migration,
                    "live_streams": len(self._live_streams),
                    "pending_migrations": len(self._migrations),
                    "prefix_store": (
                        self.prefix_store.stats()
                        if self.prefix_store is not None else None),
                }),
            },
            # preemptible batch lane
            "batch": (self.batch.stats()
                      if self.batch is not None
                      else {"enabled": False}),
            "recorder": self.recorder.stats(),
            # traffic recorder
            "traffic": (self.traffic.stats()
                        if self.enable_traffic_log
                        else {"enabled": False}),
            "health": {
                "probe_failures": self.health.probe_failures,
                "open_cooldown_s": self.health.open_cooldown_s,
                "half_open_probes": self.health.half_open_probes,
                "max_failovers": self.health.max_failovers,
                "unhealthy": self._ids(UNHEALTHY),
            },
            "autoscale": {
                "min_replicas": self.autoscaler.config.min_replicas,
                "max_replicas": self.autoscaler.config.max_replicas,
                "active": len(self._ids(ACTIVE)),
                "draining": len(self._ids(DRAINING)),
                "standby": len(self._ids(STANDBY)),
                "unhealthy": len(self._ids(UNHEALTHY)),
                # slice topology: the fleet scales in
                # whole-slice units — a scale-up provisions
                # chips_per_slice chips, and active_chips is the
                # chip-denominated capacity behind the replica count
                "chips_per_slice": self.chips_per_slice(),
                "active_chips": self.active_chips(),
                "last_decision": self.autoscaler.last_decision,
                "events": list(self._scale_events)[-32:],
            },
        }


__all__ = ["FleetManager", "LocalReplicaClient", "HandleReplicaClient",
           "ACTIVE", "DRAINING", "STANDBY", "UNHEALTHY"]
