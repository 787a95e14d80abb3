"""Preemptible batch-inference lane for the serving fleet.

The port's own copy of ``ray_tpu/serve/llm/batch.py``. A fleet
provisioned for interactive p99 idles through its troughs; this lane
harvests them with priority-0 offline work:

- **Submission surface**: a JOB — a list of OpenAI completion/chat
  bodies — is submitted and gets a job id immediately; jobs are
  listed, and each returns status + per-request results. No SSE, no
  client waiting on a socket: bulk inference is fire-and-collect
  (evals, synthetic data, rollout farms).

- **Priority 0, admission-exempt**: batch requests dispatch through
  `FleetManager.dispatch(..., lane="batch")` — they skip the bounded
  front-door queue entirely (its SLO shed/brownout timers exist to
  bound USER-visible waits; a bulk job wants to wait out the rush),
  carry `Request.priority = BATCH_PRIORITY` (0) while the fleet
  stamps interactive traffic `INTERACTIVE_PRIORITY` (1), and so are
  exactly the sequences the engine's spill/restore parks first: an
  interactive burst preempts them token-exact mid-decode and the
  trough restores them, byte-identical to never having yielded.

- **Soak governor**: the pump launches new batch streams only while
  the fleet shows headroom (front-door queue empty-ish, interactive
  engine queues shallow, KV occupancy under the bar, no brownout) and
  keeps at most `max_inflight` in flight — the lane fills idle
  capacity without ever being the thing that creates queueing.

- **Signal exclusion**: the engine excludes lane="batch" requests
  from the SLO sums the burn-rate watchdog differences; fleet_stats
  reports `waiting_batch`/`active_batch`, which FleetManager
  subtracts from the autoscaler's `waiting` overload signal and the
  router treats as displaceable load. A fleet soaking batch work to
  100% occupancy therefore still scales (and alerts) purely on its
  interactive traffic.

Pure host-side asyncio on the ingress loop — no device work.
"""

from __future__ import annotations

import asyncio
import dataclasses
import itertools
import time
from typing import Any, Callable, Dict, List, Optional

# the lane's priority tiers: batch jobs ride the engine's
# lowest tier — kv_offload.pick_victim preempts the LOWEST priority
# first — while the fleet stamps interactive bodies one tier up, so
# victim choice can never invert (engine-direct requests that name no
# priority land between sustained batch floods and fleet interactive
# traffic, which is the conservative order)
BATCH_PRIORITY = 0
INTERACTIVE_PRIORITY = 1

PENDING = "pending"
RUNNING = "running"
DONE = "done"
FAILED = "failed"
CANCELLED = "cancelled"


@dataclasses.dataclass
class BatchLaneConfig:
    """The batch lane's shape (FleetConfig.batch_lane; None = off)."""
    # concurrent batch streams in flight fleet-wide: small relative
    # to max_concurrent — the lane trickles into idle slots, it never
    # competes for the front door (which it bypasses)
    max_inflight: int = 2
    # jobs retained (finished included) before the oldest DONE job is
    # dropped from the listing
    max_jobs: int = 256
    # requests per job (bound the submission body)
    max_requests_per_job: int = 4096
    # -- soak governor: ALL must hold to launch another batch stream --
    # front-door admission queue at most this deep
    idle_queue_max: int = 0
    # fleet-wide INTERACTIVE engine-queue depth at most this
    idle_waiting_max: int = 0
    # mean KV occupancy over active replicas under this
    idle_occupancy_max: float = 0.85
    # pump cadence while work is pending
    poll_period_s: float = 0.02
    # re-dispatches per batch request before it fails (a preempted
    # request does NOT consume these — preemption resumes in-engine;
    # this covers replica loss beyond the relay's own failover)
    max_retries: int = 1


class BatchJob:
    __slots__ = ("job_id", "method", "bodies", "results", "errors",
                 "state", "created_at", "finished_at", "tenant",
                 "completed", "failed", "tokens")

    def __init__(self, job_id: str, method: str,
                 bodies: List[Dict[str, Any]], tenant: str,
                 created_at: float):
        self.job_id = job_id
        self.method = method               # "completions" | "chat"
        self.bodies = bodies
        self.results: List[Optional[Dict[str, Any]]] = \
            [None] * len(bodies)
        self.errors: List[Optional[str]] = [None] * len(bodies)
        self.state = PENDING
        self.created_at = created_at
        self.finished_at: Optional[float] = None
        self.tenant = tenant
        self.completed = 0
        self.failed = 0
        self.tokens = 0                    # completion tokens recovered

    def brief(self) -> Dict[str, Any]:
        return {
            "id": self.job_id, "object": "batch",
            "status": self.state, "method": self.method,
            "total": len(self.bodies),
            "completed": self.completed, "failed": self.failed,
            "completion_tokens": self.tokens,
            "created_at": self.created_at,
            "finished_at": self.finished_at,
            **({"tenant": self.tenant} if self.tenant else {}),
        }

    def detail(self) -> Dict[str, Any]:
        return {
            **self.brief(),
            "results": [
                (r if r is not None
                 else {"error": e} if e is not None else None)
                for r, e in zip(self.results, self.errors)],
        }


class BatchLane:
    """The fleet's bulk-inference pump. Owned by FleetManager; all
    state mutates on the ingress event loop (like the manager)."""

    def __init__(self, fleet: Any,
                 config: Optional[BatchLaneConfig] = None,
                 clock: Optional[Callable[[], float]] = None):
        self.fleet = fleet
        self.config = config or BatchLaneConfig()
        self._clock = clock if clock is not None else time.monotonic
        self.jobs: "Dict[str, BatchJob]" = {}
        self._order: List[str] = []        # submission order
        self._seq = itertools.count(1)
        self._work: "asyncio.Queue[tuple]" = asyncio.Queue()
        self._tasks: set = set()
        self._pump_task: Optional[asyncio.Task] = None
        self.inflight = 0
        # lifetime counters (GET /fleet "batch" block + bench gates)
        self.submitted_requests = 0
        self.completed_requests = 0
        self.failed_requests = 0
        self.recovered_tokens = 0
        self.launch_holds = 0     # governor said "not now" (cadence
        #                           counts, not unique decisions)

    # -- submission surface --------------------------------------------
    def submit(self, body: Dict[str, Any]) -> Dict[str, Any]:
        """POST /v1/batch: {"requests": [<completion/chat body>...],
        "method": "completions"|"chat" (default completions),
        "user": tenant}. Returns the job brief immediately."""
        cfg = self.config
        reqs = body.get("requests")
        if not isinstance(reqs, list) or not reqs:
            raise ValueError("batch body needs a non-empty "
                             "\"requests\" list")
        if len(reqs) > cfg.max_requests_per_job:
            raise ValueError(
                f"batch of {len(reqs)} exceeds "
                f"max_requests_per_job={cfg.max_requests_per_job}")
        method = str(body.get("method") or "completions")
        if method not in ("completions", "chat"):
            raise ValueError(f"unknown batch method {method!r}")
        bodies = []
        for r in reqs:
            if not isinstance(r, dict):
                raise ValueError("each batch request must be an "
                                 "object (an OpenAI body)")
            bodies.append(dict(r))
        job = BatchJob(f"batch-{next(self._seq)}", method, bodies,
                       tenant=str(body.get("user") or ""),
                       created_at=self._clock())
        self.jobs[job.job_id] = job
        self._order.append(job.job_id)
        self._gc_jobs()
        self.submitted_requests += len(bodies)
        for i in range(len(bodies)):
            self._work.put_nowait((job, i, 0))
        self.fleet.recorder.record("batch_submitted",
                                   job_id=job.job_id,
                                   requests=len(bodies),
                                   method=method)
        self.start()
        return job.brief()

    def get(self, job_id: str) -> Optional[Dict[str, Any]]:
        job = self.jobs.get(job_id)
        return None if job is None else job.detail()

    def cancel(self, job_id: str) -> Optional[Dict[str, Any]]:
        """POST /v1/batch/{id}/cancel: stop a job's not-yet-launched
        requests (the pump skips queued work of a CANCELLED job);
        requests already in flight run to completion — they hold
        engine slots the abort path would waste, and their results
        stay in the job. Finished jobs are left as-is. Returns the
        job brief (None = unknown id)."""
        job = self.jobs.get(job_id)
        if job is None:
            return None
        if job.state in (PENDING, RUNNING):
            job.state = CANCELLED
            job.finished_at = self._clock()
            self.fleet.recorder.record(
                "batch_cancelled", job_id=job_id,
                completed=job.completed,
                pending=len(job.bodies) - job.completed
                - job.failed)
        return job.brief()

    def list(self) -> List[Dict[str, Any]]:
        return [self.jobs[j].brief() for j in self._order
                if j in self.jobs]

    def _gc_jobs(self) -> None:
        while len(self._order) > self.config.max_jobs:
            for jid in self._order:
                job = self.jobs.get(jid)
                if job is None or job.state in (DONE, FAILED,
                                                CANCELLED):
                    self._order.remove(jid)
                    self.jobs.pop(jid, None)
                    break
            else:
                return      # everything live: keep them all

    # -- the soak governor ---------------------------------------------
    def headroom(self) -> bool:
        """Launch another batch stream now? Only while the fleet's
        INTERACTIVE planes show slack — the lane soaks troughs, it
        must never be the reason a user request queues."""
        from .fleet import ACTIVE    # deferred: fleet imports us
        cfg = self.config
        adm = self.fleet.admission
        if adm.brownout or adm._queue_len() > cfg.idle_queue_max:
            return False
        waiting = 0
        occ: List[float] = []
        for st in self.fleet.replicas.values():
            snap = st.snapshot
            if snap is None or st.status != ACTIVE:
                continue
            # interactive depth only: queued batch peers are the
            # lane's own backlog, not a reason to stop feeding it
            waiting += snap.displaceable_waiting()
            occ.append(snap.kv_occupancy)
        if waiting > cfg.idle_waiting_max:
            return False
        if occ and sum(occ) / len(occ) > cfg.idle_occupancy_max:
            return False
        return True

    # -- the pump ------------------------------------------------------
    def start(self) -> None:
        if self._pump_task is None or self._pump_task.done():
            self._pump_task = asyncio.get_running_loop().create_task(
                self._pump())

    async def stop(self) -> None:
        if self._pump_task is not None:
            self._pump_task.cancel()
            try:
                await self._pump_task
            except (asyncio.CancelledError, Exception):
                pass
            self._pump_task = None
        for t in list(self._tasks):
            t.cancel()

    async def _pump(self) -> None:
        cfg = self.config
        while True:
            if self._work.empty() and self.inflight == 0:
                # idle: park until the next submit() restarts us
                self._pump_task = None
                return
            if self.inflight < cfg.max_inflight \
                    and not self._work.empty() and self.headroom():
                job, i, attempt = self._work.get_nowait()
                if job.state == CANCELLED:
                    continue
                self.inflight += 1
                if job.state == PENDING:
                    job.state = RUNNING
                t = asyncio.get_running_loop().create_task(
                    self._run_one(job, i, attempt))
                self._tasks.add(t)
                t.add_done_callback(self._tasks.discard)
                continue        # try to fill every slot this turn
            if not self._work.empty() and self.inflight == 0 \
                    and not self.headroom():
                self.launch_holds += 1
            await asyncio.sleep(cfg.poll_period_s)

    async def _run_one(self, job: BatchJob, i: int,
                       attempt: int) -> None:
        body = dict(job.bodies[i])
        try:
            out = await self.fleet.dispatch(job.method, body,
                                            lane="batch")
        except asyncio.CancelledError:
            raise
        except Exception as exc:
            self.inflight -= 1
            if attempt < self.config.max_retries:
                self._work.put_nowait((job, i, attempt + 1))
            else:
                job.errors[i] = repr(exc)
                job.failed += 1
                self.failed_requests += 1
                self.fleet.recorder.record(
                    "batch_request_failed", job_id=job.job_id,
                    index=i, error=repr(exc))
                self._maybe_finish(job)
            return
        self.inflight -= 1
        job.results[i] = out
        job.completed += 1
        self.completed_requests += 1
        toks = int(((out or {}).get("usage") or {})
                   .get("completion_tokens") or 0)
        job.tokens += toks
        self.recovered_tokens += toks
        self._maybe_finish(job)

    def _maybe_finish(self, job: BatchJob) -> None:
        if job.state == CANCELLED:
            return      # in-flight stragglers ran to completion and
            #             their results are kept, but a cancel is
            #             final — it must not resurface as "done"
        if job.completed + job.failed < len(job.bodies):
            return
        job.state = FAILED if job.completed == 0 else DONE
        job.finished_at = self._clock()
        self.fleet.recorder.record(
            "batch_finished", job_id=job.job_id, status=job.state,
            completed=job.completed, failed=job.failed,
            completion_tokens=job.tokens)

    # -- observability -------------------------------------------------
    def stats(self) -> Dict[str, Any]:
        return {
            "jobs": len(self.jobs),
            "pending_requests": self._work.qsize(),
            "inflight": self.inflight,
            "submitted_requests": self.submitted_requests,
            "completed_requests": self.completed_requests,
            "failed_requests": self.failed_requests,
            "recovered_tokens": self.recovered_tokens,
            "launch_holds": self.launch_holds,
            "max_inflight": self.config.max_inflight,
        }


__all__ = ["BatchLane", "BatchLaneConfig", "BatchJob",
           "BATCH_PRIORITY", "INTERACTIVE_PRIORITY"]
