"""Fleet admission control: bounded queue, backpressure, tenant weights.

The port's own copy of ``ray_tpu/serve/llm/admission.py``. The engine
admits per replica (KV pages at add_request / slot admission); a fleet
needs one front door, so that overload is an explicit, bounded signal
instead of unbounded queueing inside whichever replica the router
picked:

- at most `max_concurrent` requests are dispatched fleet-wide; excess
  waits in ONE bounded queue (`max_queue`);
- a request that would exceed the queue bound is rejected immediately
  (HTTP 429 + Retry-After at the ingress), and a queued request that
  waits past `queue_wait_slo_s` is shed the same way — so the queue
  wait of EVERY request, admitted or shed, is bounded by the SLO;
- dequeue order is weighted fair across tenants (stride scheduling:
  each tenant advances a virtual-time pass by 1/weight per request),
  so a tenant flooding the queue cannot starve the others — it just
  burns its own share.

Pure asyncio, single event loop, no locks: every mutation happens on
the loop the ingress runs on. All the policy state (heap, stride
passes, brownout bound, shed accounting) lives in loop-free methods —
`submit()` enqueues, `shed_expired()` applies the SLO/deadline timers,
`granted_sync()` drains grants — and `acquire()` is a thin asyncio
waiter over them, so a discrete-event simulation can run this object in
virtual time through the injected `clock`.
"""

from __future__ import annotations

import asyncio
import collections
import dataclasses
import heapq
import itertools
import time
from typing import Any, Callable, Dict, List, Optional


@dataclasses.dataclass
class AdmissionConfig:
    max_concurrent: int = 64       # fleet-wide dispatched requests
    max_queue: int = 128           # bounded front-door queue
    queue_wait_slo_s: float = 2.0  # queued past this -> shed (429)
    retry_after_s: float = 1.0     # floor for the Retry-After hint
    # tenant name -> weight (absent tenants get 1.0); higher weight =
    # larger share of dequeues under contention
    tenant_weights: Dict[str, float] = dataclasses.field(
        default_factory=dict)
    # brownout: while the SLO burn-rate watchdog pages, the
    # queue bound shrinks to this fraction — shed the marginal request
    # at the front door BEFORE it burns more of the error budget
    # inside an already-slow fleet (0 < factor <= 1; 1 disables)
    brownout_queue_factor: float = 0.25


class AdmissionRejected(Exception):
    """Maps to HTTP 429 at the ingress."""

    def __init__(self, reason: str, retry_after_s: float):
        super().__init__(reason)
        self.reason = reason
        self.retry_after_s = retry_after_s


def admission_metrics() -> Dict[str, Any]:
    """Tenant-labeled front-door series: noisy-
    tenant diagnosis — whose queue waits grew, who is being shed —
    without log archaeology. Registered idempotently in the ingress
    process registry. The default tenant exports tenant="" and the
    exposition omits empty labels, so single-tenant scrapes stay
    byte-identical (the same rule as the `replica` label)."""
    from ...llm._internal.telemetry import LATENCY_BOUNDARIES
    from ...util import metrics as metrics_api
    return {
        "queue_wait": metrics_api.Histogram(
            "ray_tpu_llm_fleet_queue_wait_seconds",
            "front-door admission queue wait of ADMITTED requests, "
            "per tenant", boundaries=LATENCY_BOUNDARIES,
            tag_keys=("model", "tenant")),
        "rejected": metrics_api.Counter(
            "ray_tpu_llm_fleet_admission_rejected_total",
            "front-door rejections per tenant and reason "
            "(queue_full | brownout -> 429; queue_wait_slo = SLO "
            "shed -> 429; deadline -> 504)",
            ("model", "tenant", "reason")),
    }


class _Ticket:
    """One queued admission claim. The asyncio `future` exists only
    for async waiters (acquire); synchronous hosts (the fleet
    simulator) read `granted`/`dead` directly — grants they missed
    accumulate in the controller's `granted_sync()` drain."""

    __slots__ = ("tenant", "vtime", "seq", "future", "queued_at",
                 "deadline", "granted", "dead", "sync")

    def __init__(self, tenant: str, vtime: float, seq: int,
                 queued_at: float, deadline: Optional[float] = None,
                 sync: bool = True):
        self.tenant = tenant
        self.vtime = vtime
        self.seq = seq
        self.queued_at = queued_at
        self.deadline = deadline       # absolute clock instant | None
        self.future: Optional[asyncio.Future] = None
        self.granted = False
        self.dead = False
        # sync tickets (no asyncio waiter) report their grants through
        # granted_sync() and their sheds through shed_expired(); async
        # tickets (acquire) run their own future + timer instead
        self.sync = sync

    @property
    def done(self) -> bool:
        return self.granted or self.dead

    def __lt__(self, other: "_Ticket") -> bool:
        return (self.vtime, self.seq) < (other.vtime, other.seq)


class AdmissionController:
    """`await acquire(tenant)` then `release()` around each dispatch —
    or, for clock-driven hosts (the fleet simulator), `submit()` /
    `shed_expired()` / `granted_sync()` / `release()`."""

    def __init__(self, config: Optional[AdmissionConfig] = None,
                 metrics_model_id: Optional[str] = None,
                 clock: Optional[Callable[[], float]] = None):
        self.config = config or AdmissionConfig()
        # injectable clock: every time source in this
        # controller goes through it, so the simulator can drive the
        # REAL policy in virtual time without monkeypatching
        self._clock = clock if clock is not None else time.monotonic
        # tenant-labeled Prometheus series: off
        # unless the owner names a model id — bare unit-test
        # controllers stay registry-silent
        self._metrics = (admission_metrics()
                         if metrics_model_id is not None else None)
        self._mtags = {"model": metrics_model_id or ""}
        self.inflight = 0
        self._heap: List[_Ticket] = []
        self._dead = 0     # shed/cancelled tickets still in the heap
        self._seq = itertools.count()
        # stride-scheduling state: a tenant's next pass; the global
        # vtime floor stops an idle tenant banking credit forever
        self._pass: Dict[str, float] = {}
        self._vtime = 0.0
        # grants made to SYNC tickets (no future to resolve): the
        # clock-driven host collects them here after submit()/release()
        self._granted_sync: List[_Ticket] = []
        # observability (GET /fleet)
        self.admitted = 0
        self.rejected: Dict[str, int] = {"queue_full": 0,
                                         "queue_wait_slo": 0,
                                         "brownout": 0,
                                         "deadline": 0}
        self.shed_total = 0
        # watchdog-driven degraded mode (see set_brownout)
        self.brownout = False
        # KV page pressure, stamped by the fleet's control
        # loop: "pages short but SPILLABLE" keeps the full queue bound
        # — requests wait behind the latency tier instead of being
        # shed — while a pressured fleet that CANNOT spill sheds via
        # brownout (FleetManager gates set_brownout on spillability)
        self.page_pressure = 0.0
        self.spillable = False
        self._recent_waits: collections.deque = collections.deque(
            maxlen=512)

    # -- internals ------------------------------------------------------
    def _weight(self, tenant: str) -> float:
        w = self.config.tenant_weights.get(tenant, 1.0)
        return w if w > 0 else 1.0

    def _effective_max_queue(self) -> int:
        cfg = self.config
        if not self.brownout:
            return cfg.max_queue
        return max(0, int(cfg.max_queue * cfg.brownout_queue_factor))

    def set_page_pressure(self, pressure: float,
                          spillable: bool) -> None:
        """Stamp the fleet's page-pressure observation —
        observability plus the documented queue-vs-shed contract: the
        caller only engages brownout for pressure when `spillable` is
        False (see FleetManager.watchdog_tick)."""
        self.page_pressure = float(pressure)
        self.spillable = bool(spillable)

    def set_brownout(self, on: bool) -> bool:
        """Engage/release brownout (the SLO watchdog's shed signal):
        while on, the queue bound shrinks so overload turns into fast
        429s instead of deep queueing — already-queued requests are
        untouched (they drain or shed under their own SLO timer).
        Returns True when the state actually changed."""
        on = bool(on)
        if on == self.brownout:
            return False
        self.brownout = on
        return True

    @staticmethod
    def _tenant_label(tenant: str) -> str:
        # the default tenant's label is "" (omitted from expositions)
        return "" if tenant in ("", "default") else tenant

    def _count_reject(self, tenant: str, reason: str) -> None:
        self.rejected[reason] += 1
        if self._metrics is not None:
            self._metrics["rejected"].inc(
                1, {**self._mtags, "reason": reason,
                    "tenant": self._tenant_label(tenant)})

    def _queue_len(self) -> int:
        # done tickets still heaped are exactly the shed/cancelled
        # ones (_dead): grants pop their ticket before resolving it
        return len(self._heap) - self._dead

    def _discard(self, ticket: _Ticket) -> None:
        """A queued ticket was shed or cancelled. It stays in the heap
        (removal from the middle is O(n)) but MUST NOT wait for
        _grant_next's capacity-gated pop to reap it — long-lived
        streams can peg inflight at the cap for minutes, during which
        sustained overload would accumulate every ticket ever shed and
        degrade admission to O(dead) per call. Mark, then compact once
        the dead tickets win."""
        if ticket.done:
            return
        ticket.dead = True
        if ticket.future is not None:
            ticket.future.cancel()
        self._dead += 1
        if self._dead > 32 and self._dead * 2 > len(self._heap):
            self._heap = [t for t in self._heap if not t.done]
            heapq.heapify(self._heap)
            self._dead = 0

    def _grant_next(self) -> None:
        while self._heap and self.inflight < self.config.max_concurrent:
            t = heapq.heappop(self._heap)
            if t.done:
                self._dead -= 1
                continue             # shed while queued
            self.inflight += 1
            self._vtime = max(self._vtime, t.vtime)
            t.granted = True
            self._record_admit(self._clock() - t.queued_at, t.tenant)
            if t.future is not None:
                if not t.future.done():
                    t.future.set_result(None)
            elif t.sync:
                self._granted_sync.append(t)

    def _record_admit(self, wait_s: float,
                      tenant: str = "default") -> None:
        self.admitted += 1
        self._recent_waits.append(max(wait_s, 0.0))
        if self._metrics is not None:
            self._metrics["queue_wait"].observe(
                max(wait_s, 0.0),
                {**self._mtags,
                 "tenant": self._tenant_label(tenant)})

    def _prune_pass(self) -> None:
        # entries at or below the global floor are semantically dead —
        # submit()'s max(pass, vtime) picks the floor anyway — and the
        # tenant string is CLIENT-controlled (the OpenAI "user" field),
        # so without eviction one dict entry per distinct end-user id
        # accumulates forever; size-triggered so the rebuild stays off
        # the per-request path
        if len(self._pass) > 1024:
            self._pass = {t: p for t, p in self._pass.items()
                          if p > self._vtime}

    # -- synchronous policy core (async acquire and virtual-time hosts) ----
    def submit(self, tenant: str = "default",
               deadline: Optional[float] = None,
               now: Optional[float] = None,
               sync: bool = True) -> _Ticket:
        """Enqueue one admission claim RIGHT NOW: raises
        AdmissionRejected (deadline already expired, queue full,
        brownout) or returns a ticket — possibly already granted
        (sync tickets' grants ALSO land in granted_sync(), so a
        clock-driven host handles immediate and queued grants through
        one drain). `deadline` is an absolute instant on this
        controller's clock."""
        cfg = self.config
        now = self._clock() if now is None else now
        if deadline is not None and now >= deadline:
            # NOT counted into shed_total: a deadline shed is the
            # client's budget spent, not fleet overload — it must not
            # feed the autoscaler's shed_delta breach signal
            self._count_reject(tenant, "deadline")
            raise AdmissionRejected("deadline", self.retry_after())
        # flush cancelled heap heads / spare capacity first, so the
        # queue-full check below sees the true backlog
        self._grant_next()
        limit = self._effective_max_queue()
        if self.inflight >= cfg.max_concurrent \
                and self._queue_len() >= limit:
            # attribute the shed: under brownout a rejection the full
            # bound would have admitted is a pre-emptive brownout shed
            reason = ("brownout"
                      if limit < cfg.max_queue
                      and self._queue_len() < cfg.max_queue
                      else "queue_full")
            self._count_reject(tenant, reason)
            raise AdmissionRejected(reason, self.retry_after())
        vtime = max(self._pass.get(tenant, 0.0), self._vtime) \
            + 1.0 / self._weight(tenant)
        self._pass[tenant] = vtime
        self._prune_pass()
        ticket = _Ticket(tenant, vtime, next(self._seq),
                         queued_at=now, deadline=deadline, sync=sync)
        heapq.heappush(self._heap, ticket)
        self._grant_next()
        return ticket

    def shed_expired(self, now: Optional[float] = None
                     ) -> List[_Ticket]:
        """Apply the SLO/deadline timers to queued SYNC tickets (the
        async path runs its own asyncio timers): a ticket queued past
        queue_wait_slo_s — or past its own deadline, whichever is
        sooner — is shed, counted exactly like acquire()'s timeout
        path. Returns the tickets shed this call so a clock-driven
        host can fail their sessions. O(queue) per call; hosts call
        it at control-loop cadence, not per request."""
        now = self._clock() if now is None else now
        slo = self.config.queue_wait_slo_s
        shed: List[_Ticket] = []
        for t in self._heap:
            if t.done or not t.sync:
                continue
            by_deadline = t.deadline is not None and now >= t.deadline
            if not by_deadline and now - t.queued_at < slo:
                continue
            # attribute by whichever timer fired FIRST (the async
            # path's semantics): with a coarse host cadence both
            # may have elapsed by now, but a deadline sooner than the
            # SLO instant is the client's budget, not fleet overload
            reason = ("deadline"
                      if by_deadline
                      and t.deadline <= t.queued_at + slo
                      else "queue_wait_slo")
            self._discard(t)
            self._count_reject(t.tenant, reason)
            if reason != "deadline":
                self.shed_total += 1
            shed.append(t)
        return shed

    def granted_sync(self) -> List[_Ticket]:
        """Drain the grants made to sync tickets since the last call
        (in grant order) — the clock-driven host routes each one's
        session now."""
        out, self._granted_sync = self._granted_sync, []
        return out

    # -- public API -----------------------------------------------------
    async def acquire(self, tenant: str = "default",
                      deadline: Optional[float] = None) -> None:
        """Admit or raise AdmissionRejected. Bounded wait: returns
        within queue_wait_slo_s — or within the request's remaining
        deadline, whichever is sooner (an already-expired
        request sheds BEFORE queueing, and a queued one sheds the
        moment waiting any longer could not possibly help; either way
        the fleet does zero work for a request its client has already
        abandoned). `deadline` is absolute on this controller's clock
        (time.monotonic unless injected)."""
        cfg = self.config
        now = self._clock()
        ticket = self.submit(tenant, deadline=deadline, now=now,
                             sync=False)
        if ticket.granted:
            return                      # admitted without waiting
        ticket.future = asyncio.get_running_loop().create_future()
        timeout = cfg.queue_wait_slo_s
        if deadline is not None:
            timeout = min(timeout, max(deadline - now, 0.0))
        try:
            await asyncio.wait_for(
                asyncio.shield(ticket.future), timeout=timeout)
        except asyncio.TimeoutError:
            if ticket.granted:
                # granted in the same loop turn the timer fired:
                # the grant stands
                return
            self._discard(ticket)
            # attribute the shed: the deadline timer firing first
            # means the CLIENT's budget ran out, not the fleet's SLO
            # (and only SLO sheds count into shed_total — the
            # autoscaler's overload signal)
            reason = ("deadline"
                      if deadline is not None
                      and timeout < cfg.queue_wait_slo_s
                      else "queue_wait_slo")
            self._count_reject(ticket.tenant, reason)
            if reason != "deadline":
                self.shed_total += 1
            raise AdmissionRejected(reason,
                                    self.retry_after()) from None
        except asyncio.CancelledError:
            # caller cancelled (client gone) — give the slot back if
            # the grant raced the cancellation
            if ticket.granted:
                self.release()
            else:
                self._discard(ticket)
            raise

    def would_reject(self) -> bool:
        """Preflight: would acquire() reject RIGHT NOW? (The ingress
        checks before committing a 200 SSE stream to the wire.)"""
        self._grant_next()
        return (self.inflight >= self.config.max_concurrent
                and self._queue_len() >= self._effective_max_queue())

    def release(self) -> None:
        """One dispatched request finished; grant the next waiter."""
        self.inflight = max(self.inflight - 1, 0)
        self._grant_next()

    def retry_after(self) -> float:
        """Retry-After hint: the SLO-bounded drain estimate — a full
        queue drains within one SLO window by construction (every
        waiter is granted or shed by then)."""
        cfg = self.config
        if self._queue_len() == 0:
            return cfg.retry_after_s
        return max(cfg.retry_after_s, cfg.queue_wait_slo_s)

    # -- observability --------------------------------------------------
    def queue_wait_p99_s(self) -> float:
        waits = sorted(self._recent_waits)
        if not waits:
            return 0.0
        return waits[min(len(waits) - 1, int(len(waits) * 0.99))]

    def stats(self) -> Dict[str, Any]:
        return {
            "inflight": self.inflight,
            "queued": self._queue_len(),
            "admitted": self.admitted,
            "rejected": dict(self.rejected),
            "shed_total": self.shed_total,
            "queue_wait_p99_s": round(self.queue_wait_p99_s(), 4),
            "max_concurrent": self.config.max_concurrent,
            "max_queue": self.config.max_queue,
            "queue_wait_slo_s": self.config.queue_wait_slo_s,
            "brownout": self.brownout,
            "effective_max_queue": self._effective_max_queue(),
            "page_pressure": round(self.page_pressure, 4),
            "spillable": self.spillable,
        }


__all__ = ["AdmissionConfig", "AdmissionController",
           "AdmissionRejected", "admission_metrics"]
