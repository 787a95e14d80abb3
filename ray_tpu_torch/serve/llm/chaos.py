"""Deterministic fault injection for the serving fleet.

The port's own copy of ``ray_tpu/serve/llm/chaos.py``. Every failure
behavior the fleet's health plane promises — eviction on probe
timeouts, token-exact mid-stream failover on a severed stream,
half-open re-admission, deadline sheds under a slow replica — must be
testable on the CPU without killing real processes. This module wraps
any replica client (LocalReplicaClient, HandleReplicaClient, a test
fake) with a seeded, SCHEDULED fault plan:

    schedule = ChaosSchedule(seed=7)
    schedule.sever_stream(after_chunks=3)      # next stream: 3 chunks
                                               # then StreamSevered
    schedule.timeout_probes(count=3)           # next 3 fleet_stats
                                               # probes time out
    client = ChaosReplicaClient(inner, schedule)

Faults fire at exact per-method call indices (`at_call`, 0-based over
MATCHING calls), `count` times — the same schedule replays the same
failure sequence every run. The seeded RNG is for the optional
randomized mode (`random_failures`), used to fuzz the failover plane
without fixing a script.

Injection is pure host-side asyncio: no device work, no engine
involvement.
"""

from __future__ import annotations

import asyncio
import dataclasses
import random
from typing import Any, Dict, List, Optional


class ChaosError(RuntimeError):
    """An injected replica failure (a call that raises)."""


class StreamSevered(ChaosError):
    """Injected mid-stream connection loss (the stream dies after N
    chunks, like a replica crash with tokens still in flight)."""


@dataclasses.dataclass
class FaultSpec:
    """One scheduled fault.

    kind: "call_error" | "stream_sever" | "stream_stall" |
          "probe_timeout" | "slow_call"
    method: replica method to match ("*" = any)
    at_call: fire from the Nth MATCHING call on (0-based, per method)
    after_chunks: stream_sever/stream_stall — chunks delivered first
    delay_s: slow_call — injected latency before the real call
    count: times to fire (-1 = every matching call)
    """
    kind: str
    method: str = "*"
    at_call: int = 0
    after_chunks: int = 0
    delay_s: float = 0.0
    count: int = 1


class ChaosSchedule:
    """A seeded, inspectable fault plan for ONE wrapped replica.
    `fired` logs every injection (method, kind, call index) so tests
    assert the schedule actually executed."""

    def __init__(self, seed: int = 0):
        self.seed = seed
        self.rng = random.Random(seed)
        self.faults: List[FaultSpec] = []
        self.fired: List[Dict[str, Any]] = []
        self._calls: Dict[str, int] = {}
        # randomized mode: per-call probabilities (random_failures)
        self._p_call_error = 0.0
        self._p_sever = 0.0

    # -- the plan, built by chained calls ------------------------------
    def add(self, **kw: Any) -> "ChaosSchedule":
        self.faults.append(FaultSpec(**kw))
        return self

    def sever_stream(self, after_chunks: int, method: str = "*",
                     at_call: int = 0,
                     count: int = 1) -> "ChaosSchedule":
        return self.add(kind="stream_sever", method=method,
                        at_call=at_call, after_chunks=after_chunks,
                        count=count)

    def fail_calls(self, method: str = "*", at_call: int = 0,
                   count: int = 1) -> "ChaosSchedule":
        return self.add(kind="call_error", method=method,
                        at_call=at_call, count=count)

    def stall_stream(self, after_chunks: int, method: str = "*",
                     at_call: int = 0,
                     count: int = 1) -> "ChaosSchedule":
        """The HUNG-replica case: the stream delivers N chunks then
        produces nothing forever (no raise — only the fleet's stall
        watchdog can save the client)."""
        return self.add(kind="stream_stall", method=method,
                        at_call=at_call, after_chunks=after_chunks,
                        count=count)

    def timeout_probes(self, at_call: int = 0,
                       count: int = 1) -> "ChaosSchedule":
        """fleet_stats probes raise TimeoutError — indistinguishable
        from the refresh loop's own wait_for expiry, but instant."""
        return self.add(kind="probe_timeout", method="fleet_stats",
                        at_call=at_call, count=count)

    def slow_calls(self, delay_s: float, method: str = "*",
                   at_call: int = 0,
                   count: int = 1) -> "ChaosSchedule":
        return self.add(kind="slow_call", method=method,
                        at_call=at_call, delay_s=delay_s, count=count)

    def random_failures(self, p_call_error: float = 0.0,
                        p_sever: float = 0.0) -> "ChaosSchedule":
        """Seeded randomized mode (fuzzing): each call/stream fails
        with the given probability, driven by this schedule's RNG —
        the same seed replays the same failure sequence."""
        self._p_call_error = p_call_error
        self._p_sever = p_sever
        return self

    # -- evaluation ----------------------------------------------------
    def take(self, method: str,
             is_stream: bool = False) -> Optional[FaultSpec]:
        """Consume the fault (if any) scheduled for this call. Faults
        only match the call shape they apply to: a `stream_sever`
        waits for a STREAM (a wildcard-method sever must not be eaten
        by the next fleet_stats probe), `probe_timeout` for a unary
        call."""
        n = self._calls.get(method, 0)
        self._calls[method] = n + 1
        for f in self.faults:
            if f.count == 0:
                continue
            if f.kind in ("stream_sever", "stream_stall") \
                    and not is_stream:
                continue
            if f.kind == "probe_timeout" and is_stream:
                continue
            if f.method not in ("*", method):
                continue
            if n < f.at_call:
                continue
            if f.count > 0:
                f.count -= 1
            self.fired.append({"method": method, "kind": f.kind,
                               "call": n})
            return f
        if is_stream and self._p_sever > 0.0 \
                and self.rng.random() < self._p_sever:
            f = FaultSpec(kind="stream_sever", method=method,
                          after_chunks=self.rng.randrange(1, 8))
            self.fired.append({"method": method, "kind": f.kind,
                               "call": n, "random": True})
            return f
        if not is_stream and self._p_call_error > 0.0 \
                and self.rng.random() < self._p_call_error:
            f = FaultSpec(kind="call_error", method=method)
            self.fired.append({"method": method, "kind": f.kind,
                               "call": n, "random": True})
            return f
        return None

    def stats(self) -> Dict[str, Any]:
        return {"seed": self.seed, "fired": list(self.fired),
                "pending": sum(1 for f in self.faults if f.count != 0),
                "calls": dict(self._calls)}


class ChaosReplicaClient:
    """Wrap a replica client with the schedule's faults. Implements
    the exact client interface the FleetManager consumes
    (replica_id / shares_registry / call / stream), so it can wrap
    in-process servers, deployment handles, and test fakes alike."""

    def __init__(self, inner: Any,
                 schedule: Optional[ChaosSchedule] = None,
                 seed: int = 0):
        self.inner = inner
        self.schedule = schedule or ChaosSchedule(seed)
        self.replica_id = inner.replica_id

    @property
    def shares_registry(self) -> bool:
        return bool(getattr(self.inner, "shares_registry", False))

    async def call(self, method: str, *args: Any) -> Any:
        f = self.schedule.take(method)
        if f is not None:
            if f.kind == "probe_timeout":
                raise asyncio.TimeoutError(
                    f"chaos: injected probe timeout on "
                    f"{self.replica_id}")
            if f.kind == "call_error":
                raise ChaosError(
                    f"chaos: injected {method} failure on "
                    f"{self.replica_id}")
            if f.kind == "slow_call":
                await asyncio.sleep(f.delay_s)
        return await self.inner.call(method, *args)

    def stream(self, method: str, body: Dict[str, Any]):
        f = self.schedule.take(method, is_stream=True)
        if f is None:
            return self.inner.stream(method, body)
        if f.kind == "call_error":
            return self._broken(method)
        if f.kind == "stream_sever":
            return self._severed(self.inner.stream(method, body),
                                 f.after_chunks)
        if f.kind == "stream_stall":
            return self._stalled(self.inner.stream(method, body),
                                 f.after_chunks)
        if f.kind == "slow_call":
            return self._delayed(self.inner.stream(method, body),
                                 f.delay_s)
        return self.inner.stream(method, body)

    async def _broken(self, method: str):
        raise ChaosError(
            f"chaos: injected {method} dispatch failure on "
            f"{self.replica_id}")
        yield  # pragma: no cover — makes this an async generator

    async def _severed(self, gen: Any, after_chunks: int):
        """Deliver `after_chunks` chunks, then die like a lost
        connection: the inner stream is CLOSED (so the replica's
        server aborts the engine request and frees its slot, exactly
        as a real disconnect would) and StreamSevered raises into the
        fleet's failover path. Note the replica may already have
        generated tokens past the sever point — those are the
        'in flight, never delivered' tokens the token-exact
        continuation must regenerate."""
        i = 0
        try:
            async for chunk in gen:
                if i >= after_chunks:
                    raise StreamSevered(
                        f"chaos: stream severed after {i} chunks on "
                        f"{self.replica_id}")
                yield chunk
                i += 1
        finally:
            from .failover import close_quietly
            await close_quietly(gen)

    async def _stalled(self, gen: Any, after_chunks: int):
        """Deliver `after_chunks` chunks then HANG — no raise, no
        end-of-stream: the wedged-replica case only a consumer-side
        stall watchdog can detect. Cancellation (the watchdog firing)
        unwinds through the hang and closes the inner stream."""
        i = 0
        try:
            async for chunk in gen:
                if i >= after_chunks:
                    await asyncio.Event().wait()     # hangs until
                yield chunk                          # cancelled
                i += 1
        finally:
            from .failover import close_quietly
            await close_quietly(gen)

    async def _delayed(self, gen: Any, delay_s: float):
        await asyncio.sleep(delay_s)
        async for chunk in gen:
            yield chunk


__all__ = ["ChaosError", "StreamSevered", "FaultSpec",
           "ChaosSchedule", "ChaosReplicaClient"]
