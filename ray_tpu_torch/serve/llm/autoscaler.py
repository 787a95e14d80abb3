"""Telemetry-driven fleet autoscaling with drain-before-downscale.

The port's own copy of ``ray_tpu/serve/llm/autoscaler.py``. This
policy scales the ACTIVE replica set between min and max off the
fleet's recent TTFT and queue-wait aggregates (windowed deltas of the
cumulative sums the engine telemetry summary exports — not lifetime
averages, which would never recover after one bad minute) plus the
admission controller's shed counter (a shed request is the strongest
"we are out of capacity" signal the front door produces).

The policy only DECIDES a target size; FleetManager applies it. Scale
down never kills a replica with work in flight: the victim is removed
from the router ring first (no new requests), drains through the
engine's own has_work()/abort semantics, and is only retired once
idle — in-flight streams complete token-exact.

Hysteresis: a breach must persist for upscale_delay_s before adding a
replica, idleness for downscale_delay_s before removing one, so one
bursty tick cannot flap the fleet.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Any, Callable, Dict, Optional


@dataclasses.dataclass
class AutoscaleConfig:
    min_replicas: int = 1
    max_replicas: int = 1
    # scale-up triggers (recent-window aggregates)
    ttft_high_ms: float = 2000.0
    queue_wait_high_ms: float = 500.0
    # scale-down gate: ALL of these must hold
    queue_wait_low_ms: float = 50.0
    occupancy_low: float = 0.30
    # hysteresis
    upscale_delay_s: float = 3.0
    downscale_delay_s: float = 30.0
    # KV memory hierarchy: page pressure is (device pages
    # used + parked host pages) / usable pages — sustained demand past
    # this on the WORST replica means the fleet is oversubscribing its
    # KV (spill/restore churn taxes every affected stream), which the
    # TTFT mean can hide while streams still trickle; scale up
    page_pressure_high: float = 1.25


@dataclasses.dataclass
class FleetMetrics:
    """Windowed fleet aggregates (FleetManager computes the deltas)."""
    ttft_ms: float = 0.0            # recent-window mean TTFT
    queue_wait_ms: float = 0.0      # recent-window mean engine queue wait
    waiting: int = 0                # engine queues, fleet-wide, now
    occupancy: float = 0.0          # mean KV occupancy over active
    shed_delta: int = 0             # admission sheds/rejects this window
    # SLO burn-rate watchdog signal: paging means the fleet
    # is burning its error budget multi-window-confirmed — treated as
    # an instant breach so capacity is added BEFORE the SLO is blown
    slo_page: bool = False
    slo_burn: float = 0.0           # max confirmed burn across SLOs
    # KV page pressure: max over active replicas of
    # (device pages used + parked host pages) / usable pages
    page_pressure: float = 0.0
    # slice topology: chips behind each replica (a
    # tp-sharded engine on mesh_shape=(1, tp) spans tp chips).
    # Scaling is in whole-slice units: the decision below is still
    # denominated in replicas, but each +1/-1 provisions or releases
    # chips_per_slice chips at once.
    chips_per_slice: int = 1


class FleetAutoscaler:
    def __init__(self, config: Optional[AutoscaleConfig] = None,
                 clock: Optional[Callable[[], float]] = None):
        self.config = config or AutoscaleConfig()
        # injectable clock: the hysteresis deltas only need
        # a monotone time source, so the discrete-event simulator can
        # drive decide() in virtual time; real fleets default to
        # time.monotonic (NTP-step immune, like the rest of the plane)
        self._clock = clock if clock is not None else time.monotonic
        self._above_since: Optional[float] = None
        self._below_since: Optional[float] = None
        self.last_decision: Dict[str, Any] = {}

    def _breached(self, m: FleetMetrics, active: int) -> bool:
        c = self.config
        return (m.shed_delta > 0
                or m.slo_page                   # watchdog: pre-emptive
                or m.page_pressure > c.page_pressure_high
                or m.ttft_ms > c.ttft_high_ms
                or m.queue_wait_ms > c.queue_wait_high_ms
                or m.waiting > active)      # >1 queued per replica

    def _idle(self, m: FleetMetrics) -> bool:
        c = self.config
        return (m.shed_delta == 0 and not m.slo_page
                and m.waiting == 0
                and m.page_pressure <= 1.0       # not oversubscribed
                and m.queue_wait_ms < c.queue_wait_low_ms
                and m.occupancy < c.occupancy_low)

    def decide(self, m: FleetMetrics, active: int,
               now: Optional[float] = None) -> int:
        """Target active-replica count, clamped to [min, max]."""
        c = self.config
        now = self._clock() if now is None else now
        target = active
        if self._breached(m, active):
            self._below_since = None
            if self._above_since is None:
                self._above_since = now
            if now - self._above_since >= c.upscale_delay_s:
                target = active + 1
                self._above_since = None
        elif self._idle(m):
            self._above_since = None
            if self._below_since is None:
                self._below_since = now
            if now - self._below_since >= c.downscale_delay_s:
                target = active - 1
                self._below_since = None
        else:
            self._above_since = self._below_since = None
        target = max(c.min_replicas, min(c.max_replicas, target))
        chips = max(int(m.chips_per_slice), 1)
        self.last_decision = {
            "ts": now, "active": active, "target": target,
            # chip-denominated view of the same decision:
            # one slice = chips_per_slice chips, scaled atomically
            "chips_per_slice": chips,
            "active_chips": active * chips,
            "target_chips": target * chips,
            "ttft_ms": round(m.ttft_ms, 3),
            "queue_wait_ms": round(m.queue_wait_ms, 3),
            "waiting": m.waiting,
            "occupancy": round(m.occupancy, 4),
            "shed_delta": m.shed_delta,
            "slo_page": m.slo_page,
            "slo_burn": round(m.slo_burn, 3),
            "page_pressure": round(m.page_pressure, 4),
        }
        return target


__all__ = ["AutoscaleConfig", "FleetAutoscaler", "FleetMetrics"]
