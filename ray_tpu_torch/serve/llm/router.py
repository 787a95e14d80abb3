"""Continuous-batching-aware replica routing for LLM fleets.

The port's own copy of ``ray_tpu/serve/llm/router.py``: the same ring
keys (``hashlib``), snapshot fields and decisions, so the port's router
and the reference place every prefix on the same replica. Replica
choice is:

1. **Prefix affinity**: the request's prompt-prefix fingerprint maps
   onto a consistent-hash ring over the active replicas. Identical
   prefixes land on the same replica, so its hash-consed prompt pages
   (llm/_internal/kv_cache.py) keep getting hit; replica add/remove
   moves only the keys adjacent to the changed vnodes.
2. **Load-based spillover**: when the affinity target is saturated
   (KV-page occupancy or waiting-queue depth past the spill
   thresholds), the walk continues around the ring — the SECOND
   choice for a prefix is also sticky, so a hot prefix warms a
   deterministic small set of replicas instead of spraying everywhere.
3. **Scored fallback**: if every replica is past the spill thresholds
   the least-loaded one wins by score (see `score()`).

The router consumes each replica's stats surface (KV occupancy, queue
depth and prefix-hit gauges via `LLMServerImpl.fleet_stats()`); it
never touches the engine.
"""

from __future__ import annotations

import bisect
import dataclasses
import hashlib
import itertools
import json
import time
from typing import Any, Callable, Dict, List, Optional, Sequence


def _h(key: str) -> int:
    """Stable 64-bit point on the ring (sha1; hash() is salted)."""
    return int.from_bytes(
        hashlib.sha1(key.encode()).digest()[:8], "big")


def prefix_fingerprint(body: Dict[str, Any], depth: int = 256) -> str:
    """Fingerprint of the request's prompt PREFIX (first `depth`
    characters of the canonical prompt text) — requests sharing it
    route to the same replica. Character depth approximates the
    page-aligned token prefix the KV cache actually shares: two
    prompts identical for 256 chars share their leading prompt pages
    for any tokenizer in this repo. Chat requests canonicalize to the
    same role-tagged rendering the server's chat template consumes, so
    a shared system prompt + history is a shared fingerprint even as
    the final user turn varies beyond `depth`."""
    if body.get("prompt") is not None:
        text = str(body["prompt"])
    else:
        text = "\x1e".join(
            f"{m.get('role', '')}\x1f{m.get('content', '')}"
            for m in (body.get("messages") or []))
        if not text:
            text = json.dumps(body, sort_keys=True, default=str)
    return hashlib.sha1(text[:depth].encode()).hexdigest()


class HashRing:
    """Consistent-hash ring with virtual nodes.

    `preferred(key)` returns every live node, deduplicated, in ring
    order starting from the key's hash point — the router's spillover
    walk. Removing a node only remaps keys whose nearest vnode was
    the removed node's (the classic minimal-disruption property; the
    fleet tests assert it)."""

    # walk orderings memoized per key between membership changes: a
    # production fleet routes thousands of requests (and a traffic
    # simulator millions) over repeating prefix
    # fingerprints while the ring stays put, and the walk is the
    # expensive part of a pick. Bounded; cleared on add/remove.
    _CACHE_MAX = 4096

    def __init__(self, vnodes: int = 64):
        self.vnodes = vnodes
        self._points: List[int] = []        # sorted vnode hashes
        self._owner: Dict[int, str] = {}    # vnode hash -> node
        self._nodes: set = set()
        self._walks: Dict[str, List[str]] = {}

    def add(self, node: str) -> None:
        if node in self._nodes:
            return
        self._nodes.add(node)
        self._walks.clear()
        for i in range(self.vnodes):
            p = _h(f"{node}#{i}")
            # vnode collisions across nodes are astronomically rare;
            # keep the first owner so add/remove stays symmetric
            if p in self._owner:
                continue
            self._owner[p] = node
            bisect.insort(self._points, p)

    def remove(self, node: str) -> None:
        if node not in self._nodes:
            return
        self._nodes.discard(node)
        self._walks.clear()
        dead = [p for p, n in self._owner.items() if n == node]
        for p in dead:
            del self._owner[p]
            self._points.pop(bisect.bisect_left(self._points, p))

    def nodes(self) -> List[str]:
        return sorted(self._nodes)

    def __len__(self) -> int:
        return len(self._nodes)

    def preferred(self, key: str) -> List[str]:
        """All nodes in ring-walk order from `key`'s point. The
        returned list is a cache entry — callers read, never mutate."""
        if not self._points:
            return []
        hit = self._walks.get(key)
        if hit is not None:
            return hit
        out: List[str] = []
        seen = set()
        start = bisect.bisect_left(self._points, _h(key))
        n = len(self._points)
        for off in range(n):
            node = self._owner[self._points[(start + off) % n]]
            if node not in seen:
                seen.add(node)
                out.append(node)
                if len(out) == len(self._nodes):
                    break
        if len(self._walks) >= self._CACHE_MAX:
            self._walks.clear()
        self._walks[key] = out
        return out


@dataclasses.dataclass
class ReplicaSnapshot:
    """One replica's routing inputs (from LLMServerImpl.fleet_stats)."""
    replica: str
    active: int = 0                  # requests holding a decode slot
    waiting: int = 0                 # engine admission queue depth
    # slice topology: chips this replica's engine mesh
    # occupies (tp-sharded engines on pod slices report >1) — /fleet
    # rows show it and the fleet's capacity accounting is chip-, not
    # replica-, denominated. Per-chip MFU: the engine's PerfAccountant
    # already divides by mesh size, so `mfu` here is per chip.
    chips: int = 1
    # batch lane: how much of `waiting`/`active` is
    # priority-0 batch-lane work — the autoscaler/watchdog plane
    # subtracts it from its overload signals (a deep queue of
    # preemptible bulk jobs is harvested idle capacity, not overload)
    waiting_batch: int = 0
    active_batch: int = 0
    # fraction of the usable KV pool held by batch-lane slots: the
    # autoscaler's idle check reads occupancy MINUS this (a fleet
    # soaked to 85% with displaceable bulk work must still scale
    # down when interactive traffic leaves)
    kv_occupancy_batch: float = 0.0
    kv_occupancy: float = 0.0        # used / usable KV pages
    free_pages: int = 0
    cache_hit_rate: float = 0.0      # cumulative prefix-cache hit rate
    last_tick_age_s: Optional[float] = None
    # KV memory hierarchy: demand on the device pool
    # ((used + parked host pages) / usable; > 1 = oversubscribed),
    # parked session count, and whether the replica can ABSORB page
    # pressure by spilling (host tier on) — pages short on a spillable
    # replica is a latency tier, not saturation
    page_pressure: float = 0.0
    parked: int = 0
    spillable: bool = False
    # host-tier BYTE occupancy beside the page
    # count — migration / prefix-store byte pressure surfaces in the
    # /fleet rows before page counts saturate
    kv_host_bytes: int = 0
    # per-dispatch perf accounting: the replica's recent
    # MFU/MBU against its hardware envelope, phase goodput, and which
    # roof binds — surfaced in /fleet rows and the fleet gauges
    mfu: float = 0.0
    mbu: float = 0.0
    decode_tps: float = 0.0
    prefill_tps: float = 0.0
    roof: str = ""
    # tick-anomaly analyzer: the replica's recent anomaly
    # rate + lifetime count — surfaced in /fleet rows; the fleet
    # watchdog reads the max rate as a page precursor
    anomaly_rate: float = 0.0
    anomalies_total: int = 0
    anomaly_last_kind: str = ""
    ts: float = dataclasses.field(default_factory=time.time)
    # MONOTONIC stamp of when this snapshot was taken: a
    # replica whose probes keep failing keeps its LAST snapshot, so
    # the router must know how old the numbers it scores are (an NTP
    # step must not fake freshness — hence not `ts`)
    mono_ts: float = dataclasses.field(default_factory=time.monotonic)

    def age_s(self, now: Optional[float] = None) -> float:
        now = time.monotonic() if now is None else now
        return max(now - self.mono_ts, 0.0)

    def displaceable_waiting(self) -> int:
        """Engine queue depth MINUS the batch lane: queued
        priority-0 bulk jobs are displaceable — an interactive
        request routed here jumps them (and preempts their running
        peers) — so every consumer of "how loaded is this replica
        with INTERACTIVE work" (router saturation/score, autoscaler
        window, batch soak governor) reads this ONE definition."""
        return max(self.waiting - self.waiting_batch, 0)

    def interactive_occupancy(self) -> float:
        """KV occupancy minus the batch-lane share: the
        autoscaler's scale-down signal — pages held by displaceable
        bulk work must not keep a fleet pinned at size after its
        interactive traffic leaves."""
        return max(self.kv_occupancy - self.kv_occupancy_batch, 0.0)

    @classmethod
    def from_stats(cls, stats: Dict[str, Any]) -> "ReplicaSnapshot":
        perf = stats.get("perf") or {}
        anom = stats.get("anomaly") or {}
        return cls(
            replica=stats.get("replica", ""),
            active=int(stats.get("active", 0)),
            waiting=int(stats.get("waiting", 0)),
            chips=max(int(stats.get("chips", 1)), 1),
            waiting_batch=int(stats.get("waiting_batch", 0)),
            active_batch=int(stats.get("active_batch", 0)),
            kv_occupancy_batch=float(
                stats.get("kv_occupancy_batch", 0.0)),
            kv_occupancy=float(stats.get("kv_occupancy", 0.0)),
            free_pages=int(stats.get("free_pages", 0)),
            cache_hit_rate=float(stats.get("cache_hit_rate", 0.0)),
            last_tick_age_s=stats.get("last_tick_age_s"),
            page_pressure=float(stats.get("page_pressure", 0.0)),
            parked=int(stats.get("parked_sessions", 0)),
            spillable=bool(stats.get("kv_offload", False)),
            kv_host_bytes=int(stats.get("kv_host_bytes_used", 0)),
            mfu=float(perf.get("mfu", 0.0)),
            mbu=float(perf.get("mbu", 0.0)),
            decode_tps=float(perf.get("decode_tokens_per_s", 0.0)),
            prefill_tps=float(perf.get("prefill_tokens_per_s", 0.0)),
            roof=str(perf.get("roof", "")),
            anomaly_rate=float(anom.get("rate", 0.0)),
            anomalies_total=int(anom.get("total", 0)),
            anomaly_last_kind=str(anom.get("last_kind") or ""))


@dataclasses.dataclass
class RouterConfig:
    # "affinity" is the real policy; "round_robin" exists for the
    # bench A/B (bench_llm --fleet) and as the degenerate baseline
    policy: str = "affinity"
    vnodes: int = 64
    prefix_depth: int = 256
    # spillover thresholds: the affinity target is "saturated" when
    # EITHER trips (pages are the binding constraint; a deep engine
    # queue means admission there would stall regardless of pages)
    spill_occupancy: float = 0.85
    spill_waiting: int = 4
    # score weights for the all-saturated fallback
    w_occupancy: float = 4.0
    w_waiting: float = 1.0
    w_inflight: float = 0.5
    # snapshot staleness: a snapshot older than this is
    # routing on fiction — the replica's probes have been failing for
    # multiple refresh cycles. The affinity walk treats it like a
    # saturated target (spill to the ring successor, whose numbers are
    # real) and the scored fallback penalizes it by w_stale.
    snapshot_stale_s: float = 10.0
    w_stale: float = 4.0


class FleetRouter:
    """Scores replicas by live engine state; sticky on prompt prefix.

    The caller owns the snapshot map (FleetManager refreshes it off
    each replica's fleet_stats) and the in-flight counts (updated at
    dispatch/completion — the only zero-lag load signal)."""

    def __init__(self, config: Optional[RouterConfig] = None,
                 clock: Optional[Callable[[], float]] = None):
        self.config = config or RouterConfig()
        # injectable clock: snapshot-staleness judgments
        # compare against this time source — virtual in the simulator,
        # time.monotonic in a real fleet (matching mono_ts stamps)
        self._clock = clock if clock is not None else time.monotonic
        self.ring = HashRing(vnodes=self.config.vnodes)
        self._rr = itertools.count()
        # routing telemetry (served at GET /fleet)
        self.picks = 0
        self.affinity_hits = 0       # primary target taken
        self.spills = 0              # ring-walk past a saturated node
        self.scored_fallbacks = 0    # every node saturated

    # -- membership (FleetManager: activate/drain) ----------------------
    def set_replicas(self, replica_ids: Sequence[str]) -> None:
        want = set(replica_ids)
        for rid in list(self.ring.nodes()):
            if rid not in want:
                self.ring.remove(rid)
        for rid in want:
            self.ring.add(rid)

    # -- scoring --------------------------------------------------------
    def score(self, snap: ReplicaSnapshot, inflight: int) -> float:
        """Lower is better: occupancy dominates (pages are the binding
        constraint), engine queue depth next, then the router's own
        not-yet-visible in-flight count; a stale snapshot (probes
        failing) adds a flat deprioritization penalty."""
        c = self.config
        return (c.w_occupancy * snap.kv_occupancy
                + c.w_waiting * (snap.displaceable_waiting()
                                 + snap.active * 0.25)
                + c.w_inflight * inflight
                + (c.w_stale
                   if snap.age_s(self._clock()) > c.snapshot_stale_s
                   else 0.0))

    def _saturated(self, snap: ReplicaSnapshot, inflight: int) -> bool:
        # batch-lane depth is displaceable load: a replica
        # soaking bulk work must not repel its affinity traffic as if
        # it were saturated — neither its queued batch requests nor
        # the KV pages its batch slots hold (they spill on demand)
        c = self.config
        return (snap.interactive_occupancy() >= c.spill_occupancy
                or snap.displaceable_waiting() + inflight
                >= c.spill_waiting
                # stale numbers are no basis for an affinity hit:
                # walk on to a replica whose state is known
                or snap.age_s(self._clock()) > c.snapshot_stale_s)

    # -- the pick -------------------------------------------------------
    def pick(self, fingerprint: str,
             snapshots: Dict[str, ReplicaSnapshot],
             inflight: Dict[str, int]) -> Optional[str]:
        """Choose a replica for a request with this prefix
        fingerprint. None only when the ring is empty."""
        return self.pick_ex(fingerprint, snapshots, inflight)[0]

    def pick_ex(self, fingerprint: str,
                snapshots: Dict[str, ReplicaSnapshot],
                inflight: Dict[str, int]
                ) -> "tuple[Optional[str], str]":
        """pick() plus the decision OUTCOME ("affinity" | "spill" |
        "scored" | "round_robin" | "none") — the routing-decision
        trace span's payload, so a merged fleet trace shows
        WHY a request landed where it did, not just where."""
        nodes = self.ring.nodes()
        if not nodes:
            return None, "none"
        self.picks += 1
        if self.config.policy == "round_robin":
            # skip the ring walk entirely: preferred() hashes the key
            # and walks up to vnodes*replicas points for an ordering
            # round-robin would discard
            return nodes[next(self._rr) % len(nodes)], "round_robin"
        order = self.ring.preferred(fingerprint)

        def _snap(rid: str) -> ReplicaSnapshot:
            return snapshots.get(rid) or ReplicaSnapshot(replica=rid)

        for rank, rid in enumerate(order):
            if not self._saturated(_snap(rid), inflight.get(rid, 0)):
                if rank == 0:
                    self.affinity_hits += 1
                    return rid, "affinity"
                self.spills += 1
                return rid, "spill"
        # every replica saturated: degrade gracefully to pure load
        self.scored_fallbacks += 1
        return min(order, key=lambda rid: self.score(
            _snap(rid), inflight.get(rid, 0))), "scored"

    def stats(self) -> Dict[str, Any]:
        return {
            "policy": self.config.policy,
            "replicas": self.ring.nodes(),
            "picks": self.picks,
            "affinity_hits": self.affinity_hits,
            "spills": self.spills,
            "scored_fallbacks": self.scored_fallbacks,
        }


__all__ = ["FleetRouter", "RouterConfig", "ReplicaSnapshot", "HashRing",
           "prefix_fingerprint"]
