"""Failure-handling plane for the serving fleet.

The port's own copy of ``ray_tpu/serve/llm/failover.py``: the pieces
that make replica loss a routine latency blip instead of a dropped
stream.

- `CircuitBreaker` + `HealthConfig` — the per-replica health state
  machine the FleetManager's refresh loop drives: consecutive probe
  failures/timeouts open the breaker (the replica is EVICTED from the
  router ring immediately), a cooldown later one half-open probe at a
  time decides re-admission, and repeated trips back the cooldown off
  exponentially. Breaker state is exported as a gauge
  (`ray_tpu_llm_breaker_state`: 0 closed / 1 open / 2 half-open).

- `StreamTranscript` + `continuation_body` — token-exact mid-stream
  failover. The fleet consumes each replica's token-structured stream
  (`*_stream_tokens`: token ids + text per chunk, globally indexed),
  folds chunks through the transcript (dedup by token index →
  exactly-once delivery), and on a replica failure re-dispatches the
  ORIGINAL prompt with the already-delivered tokens appended
  (`_continue_tokens`), `max_tokens` decremented and the token index
  offset. The per-request sampling seed (pinned on the body at
  ingress) keys every token's sample by its ABSOLUTE index, so greedy
  AND sampled continuations are token-exact; the prefix cache makes
  the re-prefill cheap.

- fleet failure metrics — `failovers_total`,
  `replica_evictions_total`, `breaker_state`, `deadline_sheds_total`
  (registered idempotently in the ingress process registry, riding
  the fleet /metrics scrape like the watchdog gauges).

Everything here is host-side control-plane Python: no device work.
"""

from __future__ import annotations

import asyncio
import dataclasses
import json
import time
import uuid
from typing import Any, Callable, Dict, List, Optional

from ...llm._internal.engine import derive_seed
from ...llm._internal.server import DEFAULT_MAX_TOKENS  # noqa: F401
from ...util import metrics as metrics_api

# fleet stream method -> the replica's token-structured twin
TOKEN_STREAM_METHODS = {
    "chat_stream": "chat_stream_tokens",
    "completions_stream": "completions_stream_tokens",
}

CLOSED = "closed"
OPEN = "open"
HALF_OPEN = "half_open"
_BREAKER_GAUGE = {CLOSED: 0, OPEN: 1, HALF_OPEN: 2}

# exception types a replica raises for a BAD REQUEST (malformed
# sampling params, unknown LoRA adapter, prompt over max_seq): the
# request caused them deterministically, so they must neither feed
# the breaker (one poisoned body would evict healthy replicas ring
# by ring) nor be retried (the re-dispatch would fail identically).
# Deliberately narrow: a replica-internal KeyError/AttributeError is
# a replica bug and MUST keep feeding the breaker.
REQUEST_FAULT_TYPES = (ValueError, TypeError)


def is_request_fault(exc: BaseException) -> bool:
    return isinstance(exc, REQUEST_FAULT_TYPES)


async def close_quietly(gen: Any, timeout_s: float = 1.0) -> None:
    """Best-effort aclose of a replica-side async generator (the ONE
    close-a-stream idiom — fleet relay and chaos wrappers share it):
    closing tells the replica its client is gone, so it aborts the
    engine request instead of decoding to nobody until the 300 s
    queue timeout. Bounded: a wedged replica must not hang the
    closer."""
    close = getattr(gen, "aclose", None)
    if close is None:
        return
    try:
        await asyncio.wait_for(close(), timeout=timeout_s)
    except Exception:
        pass


@dataclasses.dataclass
class HealthConfig:
    """Failure detection + failover policy (FleetConfig.health)."""
    # consecutive probe failures/timeouts that open the breaker and
    # evict the replica from the router ring
    probe_failures: int = 3
    # open -> half-open cooldown before the first re-admission probe;
    # repeated trips multiply it (bounded), so a flapping replica
    # spends progressively longer out of the ring
    open_cooldown_s: float = 2.0
    cooldown_backoff: float = 2.0
    max_cooldown_s: float = 30.0
    # consecutive half-open probe successes that close the breaker
    # and re-admit the replica
    half_open_probes: int = 2
    # a hard dispatch/stream failure trips the breaker immediately
    # (a severed stream is a stronger death signal than a slow probe)
    fail_fast_on_dispatch: bool = True
    # bounded mid-stream re-dispatches per client stream (and unary
    # retries per request)
    max_failovers: int = 2
    # a live stream that produces NO chunk for this long is a HUNG
    # replica (hangs, not just crashes —
    # a healthy engine emits a token every tick, ms-scale): the relay
    # treats the stall as a failure and fails over. Generous default:
    # it must clear first-token latency under load (queueing +
    # prefill + cold compiles).
    stream_stall_timeout_s: float = 60.0
    # grace past a unary request's deadline before the ingress stops
    # waiting on the replica (a healthy engine sheds at a fold
    # boundary well inside it; the timeout firing means the replica
    # is hung or badly behind). Generous for the same cold-compile
    # reason as the stall timeout — and the resulting TimeoutError
    # feeds the breaker SOFTLY (threshold-counted, never an instant
    # trip): tight client deadlines must not evict healthy replicas.
    unary_deadline_grace_s: float = 10.0


class CircuitBreaker:
    """Per-replica closed → open → half-open state machine.

    The refresh loop drives it: `should_probe()` gates whether
    this cycle probes the replica at all (an OPEN breaker inside its
    cooldown is left alone; past it, the breaker half-opens and admits
    exactly the probes that decide recovery), then `record_success` /
    `record_failure` move the state. Failure paths outside the probe
    loop (dispatch errors, severed streams) feed `record_failure`
    with hard=True."""

    def __init__(self, config: Optional[HealthConfig] = None,
                 clock: Optional[Callable[[], float]] = None):
        self.config = config or HealthConfig()
        # injectable clock: cooldown timing runs on
        # whatever monotone source the caller provides — the fleet
        # simulator's chaos overlays exercise open/half-open/close in
        # virtual time through it
        self._clock = clock if clock is not None else time.monotonic
        self.state = CLOSED
        self.failures = 0            # consecutive
        self.trips = 0               # lifetime opens
        self.opened_at = 0.0
        self._half_ok = 0

    def cooldown_s(self) -> float:
        c = self.config
        return min(c.max_cooldown_s,
                   c.open_cooldown_s
                   * (c.cooldown_backoff ** max(self.trips - 1, 0)))

    def should_probe(self, now: Optional[float] = None) -> bool:
        if self.state != OPEN:
            return True
        now = self._clock() if now is None else now
        if now - self.opened_at >= self.cooldown_s():
            self.state = HALF_OPEN
            self._half_ok = 0
            return True
        return False

    def record_success(self, now: Optional[float] = None) -> bool:
        """One healthy probe. Returns True when it CLOSED the breaker
        (the caller re-admits the replica)."""
        self.failures = 0
        if self.state == CLOSED:
            return False
        # a success can only arrive through a half-open probe; treat a
        # stray OPEN success the same way
        if self.state == OPEN:
            self.state = HALF_OPEN
            self._half_ok = 0
        self._half_ok += 1
        if self._half_ok >= self.config.half_open_probes:
            self.state = CLOSED
            self._half_ok = 0
            return True
        return False

    def record_failure(self, now: Optional[float] = None,
                       hard: bool = False) -> bool:
        """One failed probe/dispatch. Returns True when it OPENED the
        breaker (the caller evicts the replica)."""
        now = self._clock() if now is None else now
        self.failures += 1
        if self.state == HALF_OPEN or (
                self.state == CLOSED
                and (hard or self.failures
                     >= self.config.probe_failures)):
            self.state = OPEN
            self.trips += 1
            self.opened_at = now
            self._half_ok = 0
            return True
        return False

    def gauge(self) -> int:
        return _BREAKER_GAUGE[self.state]

    def stats(self) -> Dict[str, Any]:
        return {"state": self.state, "failures": self.failures,
                "trips": self.trips,
                "cooldown_s": round(self.cooldown_s(), 3)}


class StreamBroken(RuntimeError):
    """A replica's token stream ended without a finish chunk — the
    transport died quietly; the fleet treats it like any failure."""


class StreamStalled(RuntimeError):
    """A replica's token stream produced no chunk within the stall
    timeout — the replica hung (wedged event loop / stuck device
    call); the fleet fails the attempt over."""


class StreamTranscript:
    """The client-visible token transcript of ONE logical stream,
    across however many replica attempts served it. `fold()` dedups
    replica chunks by global token index, so the client sees
    exactly-once delivery: tokens the dead replica generated but never
    shipped are regenerated by the continuation (token-exact, same
    seed), and anything replayed is dropped here."""

    def __init__(self):
        self.tokens: List[int] = []
        self.finished = False
        self.reason: Optional[str] = None

    def fold(self, chunk: Dict[str, Any]):
        """-> (new_tokens, text_delta, finished, reason) | None."""
        n = len(self.tokens)
        i = int(chunk.get("i", n))
        toks = list(chunk.get("toks") or [])
        fin = bool(chunk.get("finished"))
        if i + len(toks) <= n and not fin:
            return None                  # wholly replayed chunk
        if i < n:
            # partial overlap — defensive only: continuations start
            # exactly at the transcript head by construction. The
            # text delta is indivisible, so it is dropped with the
            # replayed tokens.
            toks = toks[n - i:]
            text = ""
        else:
            text = chunk.get("text") or ""
        self.tokens.extend(toks)
        reason = chunk.get("reason")
        if fin:
            self.finished, self.reason = True, reason
        return toks, text, fin, reason


def pin_stream_identity(body: Dict[str, Any]) -> None:
    """Pin everything a continuation must replay exactly, BEFORE the
    first dispatch: an explicit max_tokens (so it can be decremented)
    and the per-request sampling seed (derived from the minted request
    id — the engine would derive the same one, but the continuation
    may land under a different engine request id, so the fleet pins it
    on the body where it survives the hop)."""
    body["max_tokens"] = int(body.get("max_tokens")
                             or DEFAULT_MAX_TOKENS)
    if body.get("seed") is None:
        body["seed"] = derive_seed(
            str(body.get("_request_id") or uuid.uuid4().hex))


def continuation_body(body: Dict[str, Any],
                      transcript: StreamTranscript) -> Dict[str, Any]:
    """The re-dispatch body for a severed stream: original prompt
    (the replica re-encodes it) + delivered tokens appended, token
    indices offset, max_tokens decremented. Seed and deadline ride
    the copied body unchanged."""
    out = dict(body)
    done = len(transcript.tokens)
    out["_continue_tokens"] = list(transcript.tokens)
    out["_token_offset"] = done
    out["max_tokens"] = max(
        int(body.get("max_tokens") or DEFAULT_MAX_TOKENS) - done, 1)
    return out


def sse_chunk(chat: bool, cid: str, model: str, created: int,
              text: str, finished: bool, reason: Optional[str],
              token_ids: List[int]) -> str:
    """One OpenAI-format SSE chunk rendered at the INGRESS (the fleet
    owns the SSE framing so a mid-stream failover keeps one stable
    completion id — no restart is client-visible except latency).
    `token_ids` is a vLLM-style extension: the emitted ids, so
    failover-aware clients (and the chaos gates) can assert
    token-exactness without re-tokenizing text."""
    if chat:
        doc = {
            "id": cid, "object": "chat.completion.chunk",
            "created": created, "model": model,
            "choices": [{
                "index": 0,
                "delta": ({"content": text} if text else {}),
                "finish_reason": reason if finished else None,
                "token_ids": list(token_ids),
            }],
        }
    else:
        doc = {
            "id": cid, "object": "text_completion",
            "created": created, "model": model,
            "choices": [{
                "index": 0, "text": text,
                "finish_reason": reason if finished else None,
                "token_ids": list(token_ids),
            }],
        }
    return f"data: {json.dumps(doc)}\n\n"


def fleet_metrics() -> Dict[str, Any]:
    """The fleet failure-plane metric families, registered
    idempotently in THIS process's registry (the ingress scrape —
    same pattern as the watchdog gauges)."""
    C, G = metrics_api.Counter, metrics_api.Gauge
    return {
        "failovers": C(
            "ray_tpu_llm_failovers_total",
            "requests re-dispatched to another replica after a "
            "failure (mid-stream token-exact continuations + unary "
            "retries)", ("model",)),
        "evictions": C(
            "ray_tpu_llm_replica_evictions_total",
            "replicas evicted from the router ring by the health "
            "state machine", ("model",)),
        "breaker": G(
            "ray_tpu_llm_breaker_state",
            "per-replica circuit breaker state "
            "(0 closed / 1 open / 2 half-open)",
            ("model", "replica")),
        "deadline_sheds": C(
            "ray_tpu_llm_deadline_sheds_total",
            "requests shed (admission) or aborted (engine) past "
            "their client deadline", ("model", "stage")),
    }


__all__ = [
    "HealthConfig", "CircuitBreaker", "CLOSED", "OPEN", "HALF_OPEN",
    "StreamTranscript", "StreamBroken", "continuation_body",
    "pin_stream_identity", "sse_chunk", "fleet_metrics",
    "TOKEN_STREAM_METHODS", "DEFAULT_MAX_TOKENS",
]
